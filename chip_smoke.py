#!/usr/bin/env python3
"""Card checks of the PyTorch port on one NVIDIA GPU, and its kernel table.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with a CUDA card, nvcc and
nvidia-smi. It needs no network and no JAX. It checks on the card what the
CPU tests cannot, and times each hand-written kernel alone (phase 6, the
kernel table). It times no end-to-end work: clips/s, requests/s, latency,
step times and traces of the port's surfaces are the benchmark's
(BENCHMARK.json, python3 -m benchmark.run). Phases, each of which fails
the run (non-zero exit) on any error or mismatch:

 1. device: the card's name and power limit;
 2. build: every CUDA kernel of the two paths below, from the sources in
    the checkout, with nvcc for sm_90a, one nvcc per source, in parallel;
    per instantiation, registers, static shared memory and spills (nvcc
    -Xptxas -v) and the counts of tensor-core instructions in the
    library's SASS (cuobjdump -sass): HGMMA (wgmma: K1's bf16 kernel and
    K2's products) and HMMA (mma.sync; no kernel uses it); the
    launch plans at the main path's shapes. Fails if one of the wgmma
    kernels has no HGMMA, or one the main path launches spills;
 3. kernels: each kernel against its plain PyTorch version on the card,
    in f32 and bf16, at the paths' shapes and at the widths the factories
    use, with the tolerances stated in KERNEL_TOL: the fused block (K1) in
    its serving mode and its training ("save") mode, with the share of d
    bit-equal to the plain version's, and the fused block backward (K2);
    each must also give bit-equal results twice; K1's unfused-rounding
    mode at stage-1/2 widths (K1_UNFUSED_CASES) against the unfused block
    on the card, nearer to it than K1's own rounding; the AdamW kernel
    (csrc/adamw.cu, which replaces no TPU kernel) through the Optimizer
    against the plain loop over 5 updates of convnext_tiny's 184 leaves,
    p, m and v bit-equal after each, every update fused;
 4. serving path: convnext_tiny at full width on B=16 ten-second clips (the
    fixture recording as int16 plus seeded variants), random weights from
    a seed with seeded gamma/bn0 values. The bf16 serving config runs
    forward, forward_scene_embeddings and forward_frame_embeddings, and each
    call must launch the fused block kernel exactly once per block, in its
    unfused-rounding mode at stages 1-2 (6 launches) and its own at 3-4;
    the f32 parity config launches it never and matches the port's own f32
    forward on the CPU; bf16 serving probabilities stay near f32 parity;
    fault 1: row 0 of every layer's output is bit-equal beside zero rows
    and beside other clips (reported beside: the clip at row 5, and at
    B=8);
 5. training path: convnext_tiny at full width in the JAX package's fused
    training recipe (tanh GELU, fused_train_blocks, drop path 0.1, bf16
    compute, mixup 1.0, SpecAugment, AdamW with OneCycle), TRAIN_STEPS
    Trainer.step calls on 32 fixture-derived clips (mixup pairs them into
    B=16). Each step must launch K1 in save mode and K2 exactly once per
    block, at stages 1-2 (6 of the 18) in their unfused-rounding modes and
    never K1's serving one, with a finite loss, and every optimizer update
    must go through the AdamW kernel;
    the trained model's f32 eval forward launches K1 12 times in
    serving mode; one step's gradients with the
    fused blocks against the unfused ones (drop path off), bf16 and f32;
 6. the kernel table (CUDA events after warm-up; a kernel's the median of
    5 runs of 20 calls): each kernel and its plain version at the checked
    shapes beside the least time the card could take; one profiled K1
    call (serving and save mode) and one K2 call at each main-path shape,
    which must show every launch of the plan and none of the kernels the
    Hopper redesigns replaced (K1's every device launch printed, the
    wrapper's weight preparation included, with the kernel's TFLOP/s,
    share of the bf16 peak and the plan's L2 weight bytes); the unfused
    bf16 block's forward (K1's unfused_ms, also at the Kaldi-fbank route's
    stage 3) and autograd's backward of it (K2's unfused_ms), and cuBLAS's
    two products alone (xn . W1^T, tanh GELU, . W2^T in bf16: how far K1's
    products are from the library's), at the main path's shapes, each the
    median of 5 runs with its spread; the AdamW kernel at convnext_tiny's
    184 leaves beside its bound (28 bytes a value) and the plain loop,
    medians of 5 runs of 20 updates, and the host's ms to issue one update
    either way (no PyTorch call computes optax's update: no library_ms);
 7. inference surfaces, on the phase-4 serving model: a safetensors file
    and a native checkpoint directory written by the port load through
    ConvNeXt.from_pretrained with bit-equal outputs; the Evaluator over
    EVAL_CLIPS seeded int16 clips at B=EVAL_BATCH through the port's
    DataLoader over an in-memory dataset with AudioSetDataset's contract
    (the card machine has no h5py; the HDF5 route is held against the JAX
    package by the CPU tests), bit-equal to model.forward on the same
    padded batches, with finite mAP/AUC/d-prime; tag_clip, tag_long_audio
    and embed_long_audio on the fixture; each step must launch K1 18 times
    per forward (phase 3 holds K1 against its plain version at each of
    these batch sizes); the CLIs on their default device: convert and the
    demo;
 8. the tagging service: cli/serve.py's server on a free port with the
    phase-4 model, batch 16, max wait 20 ms. SERVE_CLIENTS client threads
    each send every clip of a pool of SERVE_POOL int16 clips to /tag once
    (SERVE_REQUESTS requests); every answer must equal model.forward of
    that clip in a batch of 16 within SERVICE_TOL, each request must be
    one clip of a batch, and each batch must launch K1 18 times; then the
    same requests to the batcher directly (no HTTP); a 25-s request,
    /embed, /healthz;
 9. the training CLI's loop (cli/train.py::train) on the card over an
    in-memory index and dataset: convnext_tiny in the fused bf16 recipe,
    balanced sampler, mixup 1.0, 32 clips in, B=16, 4 loader threads, an
    evaluation and a checkpoint every 3 steps. 6 steps straight, then 3
    steps and a fresh run resuming at step 3 for 3 more: the sampler
    states bit-equal, the parameters within RESUME_PARAM_LIMIT, each step
    launching K1 in save mode and K2 18 times;
10. data parallelism on the one card: (a) cli/train.py::train under a
    torchrun environment of one process (NCCL, the all-reduces of a group
    of one), 3 steps within RESUME_PARAM_LIMIT of phase 9's first 3; (b)
    two processes on card 0 with the gloo backend, one Trainer step each
    of 32 clips against one process's step (f32 unfused, bf16 fused; the
    bounds in DP_CASES' comment), 18 K1-save and 18 K2 calls a rank a
    step; (c) the Evaluator over two replicas on the one card against one
    replica (SHARDED_EVAL_TOL); (d) cli/serve.py --mesh with the phase-4
    model and phase 8's requests, every answer within SERVICE_TOL, K1 18
    times per replica batch;
11. AOT serving bundles (engine/aot_export.py) of the phase-4 model, int16
    in: forward at buckets 1 and 16, scene and frame at 16, shared weights
    at 16, one dynamic program, and the f32 parity config at 16, each
    exported (size on disk), loaded and held against the live model within
    BUNDLE_TOL (B=16, B=3 padded, B=1, the dynamic program at 2 and 5): 18
    K1 launches per bf16 call, none in f32; the forward bundle in a fresh
    process that cannot import the port's models or checkpoint packages,
    bit-equal; cli/serve.py --bundle with phase 8's requests, each answer
    equal to the bundle's own forward in a batch of 16; then the
    frontend's ct and rfft on the card against the CPU (FRONTEND_DB_TOL);
12. the PANN zoo (models/pann.py, f32 under fp32_precision("highest")): (a)
    all 49 registry models built on the card from their seed, each
    forwarding B=2 10-s clips at its own sample rate (the fixture and a
    seeded clip), outputs finite, shaped and in [0, 1]; (b) one model per
    family (PANN_PARITY), every weight and BN statistic perturbed, against
    the port's CPU forward of the same weights within PANN_PROB_TOL, with
    Cnn14 also run with TF32 on; (c) cli/inference.py audio_tagging and
    sound_event_detection --out-csv on the fixture with a reference-keyed
    checkpoint written here, their top-k equal to model.forward's. No PANN
    forward may launch K1.
13. PANN transfer learning (models/pann.py forward_train, engine/transfer.py,
    data/audiocaps.py and data/flac.py, cli/finetune_audiocaps.py), f32:
    (a) a synthetic AudioCaps root (64 train, 16 val, 16 test 10-s 32 kHz
    FLAC clips from AC_DISTINCT encoded ones, captions and tags CSVs); the
    port builds its FLAC library with the host compiler; every clip decodes
    to its encoder's integers exactly; AudioCaps and BasicCollate give the
    expected lengths and one-hots; (b) the published Cnn14, perturbed,
    forward_train on the card against the port's CPU forward_train (B=4,
    dropout off, the same SpecAugment draws): probabilities within
    PANN_PROB_TOL, logits and every bn_updates entry within
    TRANSFER_REL_TOL of scale; one TransferTrainer.step each side: head
    gradients within TRANSFER_REL_TOL (the TF32 pin holds over the
    backward); (c) one TransferTrainer.step at B=64 in the CLI's recipe, a
    finite loss; (d) cli/finetune_audiocaps.py for one epoch at batch 64
    from a reference-keyed checkpoint: exit 0, base weights bit-equal,
    head and every BN statistic moved, the checkpoint read back. No
    transfer-path call may launch K1 or K2.
14. the rest of the JAX package: (a) the host audio library
    (utils/native.py over csrc/audio_host.cpp) built with the host's
    compiler; the fixture and in-memory PCM 8/16/24/32 and float WAVs
    against scipy's reading (WAV_TOL), a 10-s clip resampled 44.1k and
    48k -> 32k against scipy's f64 (RESAMPLE_TOL); about 240 of
    tests/test_fuzz_decoders.py's mutations of a FLAC and a WAV stream
    (tests/torch_fuzz_util.py) through the FLAC and WAV libraries built
    here: each decodes well formed or raises ValueError; (b) kaldi_fbank
    of FBANK_CLIPS 10-s clips on the card against the host
    (FBANK_LOG_TOL); (c) the Kaldi-fbank evaluation route at full width:
    phase 7's 200 clips through AudioSetDataset(use_kaldi_fbank=True)'s
    own per-clip transform, the DataLoader and the Evaluator at B=64 on
    the phase-4 bf16 model: 18 K1 launches per batch, 12 of them at
    (64,62,14,384) and (64,31,7,768), the first batch bit-equal to
    model.forward, 4 clips of the f32 parity model against the CPU
    (F32_LOGIT_TOL), bf16 against f32 (SERVING_PROB_TOL), and the same
    loader through device_prefetch bit-equal to its host batches; (d)
    crop/pad/pad_or_truncate and the nearest resample on the card
    bit-equal to the CPU, resample_linear within LINEAR_RESAMPLE_TOL; (e)
    count_parameters (28,222,767), count_flops per clip, profile_ops
    listing K1 18 times per forward, a trace file written; (f) with
    AUDIOSET_TPU_COMPILE_CACHE set to a fresh directory, one process builds
    K1 and both host libraries into it and a second builds nothing.
    Packing is not run: the card machine has no h5py.
15. the learning certificates: (a) scripts/train_learn_tpu.py's run on
    the port: convnext_tiny at full width from the port's own init, the
    fused bf16 recipe (tanh GELU, fused_train_blocks, drop path 0.1,
    frontend "high", SpecAugment, mixup 1.0, AdamW, OneCycle at 1.5e-3),
    LEARN_STEPS Trainer.step calls of 32 of the 64 ten-second tone clips
    (16 classes), each step launching K1's save mode and K2 18 times; its
    gates: the loss ratio under LEARN_LOSS_RATIO and train mAP over the 16
    columns above LEARN_MAP through the bf16 serving forward (18 K1
    launches a forward), every optimizer update through the AdamW kernel;
    (b) the same run on the unfused route (no K1 save
    mode, no K2), the same gates, both runs side by side with their largest
    per-step loss gap; (c) scripts/serving_parity_trained_tpu.py's check:
    run (a)'s weights written as safetensors and read by
    ConvNeXt.from_pretrained into the f32 parity config and the bf16
    serving config at frontend "default" and "high", 256 held-out clips
    through the Evaluator: each bf16 config within PARITY_MAP_TOL mAP and
    PARITY_TOP1 top-1 agreement of f32, the f32 held-out mAP above
    HELDOUT_MAP, K1 18 times a bf16 batch and never in f32; (d)
    scripts/transfer_cert_tpu.py's run: Cnn14 head-only TransferTrainer
    at 1e-3, 300 steps of 32 one-second tone clips (8 classes): loss
    ratio, train mAP, frozen weights bit-identical, BN statistics changed,
    head moved, no K1 or K2 launch.

The line before the last is one JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. The whole of standard output also goes to
chiprun_out/chip_smoke.log.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "f62-S-v2swA_200000_210000.wav"
SEED = 0
BATCH = 16

TRAIN_CLIPS = 32  # clips per training step; mixup pairs them into B=16
TRAIN_STEPS = 4

EVAL_CLIPS = 200  # the last of 4 batches is padded from 8 clips to 64
EVAL_BATCH = 64
LONG_BATCH = 32  # tag_long_audio / embed_long_audio pad their windows to it
WORK = ROOT / "build" / "chip_smoke"  # files phases 7-9 write (the checkout's build/)
LOG = ROOT / "chiprun_out" / "chip_smoke.log"  # the run's whole stdout

SERVE_CLIENTS = 8  # client threads
SERVE_POOL = 32  # distinct int16 clips; each client thread sends every one once
SERVE_REQUESTS = SERVE_CLIENTS * SERVE_POOL  # requests a serving route answers
TRAIN_CLI_CLIPS = 64  # the in-memory training set of phase 9
TRAIN_CLI_EVAL = 64  # its in-memory evaluation set (2 batches of 32)

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores (every timed
# kernel runs in bf16), HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

# Kernel vs plain version: the two sum in other orders. f32: 1e-4 of the
# output scale. bf16: an order flip can move a value across a bf16
# rounding boundary (of d, the LN output or the GELU output, or the output
# itself); allowed is 2^-6 of the output scale, four ulps at the largest
# |y|.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# Training gradients, fused vs unfused blocks on the card, relative to each
# gradient's scale max(1, max|g|): the JAX package's own fused-vs-XLA
# training tolerances (tests/test_fused_train_integration.py), bf16 5e-2 and
# f32 3e-4. In f32 the two routes are compared directly. In bf16 at full
# depth one tensor, the stem conv's bias (a sum over ~14k positions of bf16
# cotangents), is about 0.09 of scale away from its f32 gradient on EITHER
# route, so the routes can differ by more than 5e-2 there without either
# being wrong. The bf16 rule is therefore: on every tensor, the fused
# route's distance from the f32 gradients exceeds the unfused route's by at
# most 5e-2 of scale: the fused blocks may add no more than the JAX
# tolerance to what bf16 training already costs.
FUSED_GRAD_TOL = {torch.bfloat16: 5e-2, torch.float32: 3e-4}
# f32 parity config, card vs CPU: logits, the JAX package's parity tolerance.
F32_LOGIT_TOL = 2e-4
# bf16 serving (tanh GELU, bf16 trunk and bf16 DFT) vs f32 parity (erf GELU,
# true f32), probabilities, on random weights.
SERVING_PROB_TOL = 0.05
# The service's answer for a clip vs model.forward of that clip in a batch
# of 16: bit-equal. Every batch runs at B=16, as the reference forward does,
# and no operation of the eval forward depends on a row's neighbours or its
# position at a fixed batch size (fault 1: check_row_independence and
# tests/test_torch_cuda.py hold every layer's output bit-equal; PERF.md
# §6). /embed runs at B=1 and is held against
# forward_scene_embeddings at B=1 with the bf16 kernel rule (KERNEL_TOL of
# the embedding's scale).
SERVICE_TOL = 0.0
# Resumed vs straight training (phase 9): the same batches and draws, but
# ATen's backward kernels that sum with atomics are not bit-deterministic,
# so a gradient may differ in its last bits and, where it is nearly zero,
# in its sign. Adam bounds each step's update of a parameter by lr times
# ADAM_RATIO(t) (|m_hat| / sqrt(v_hat), by Cauchy-Schwarz on the moment
# sums), whatever the gradients; two runs can then drift apart by at most
# twice that, summed over the steps. Weight decay adds wd * lr * the drift,
# under 1e-9 of it here; the limit takes 1% on top.


def adam_ratio(t: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """The most |m_hat| / sqrt(v_hat) can be after t Adam steps."""
    s = sum((b1 * b1 / b2) ** k for k in range(t))
    return (1 - b1) / math.sqrt(1 - b2) * math.sqrt(s) * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)


def resume_param_limit(lr, steps: int) -> float:
    """RESUME_PARAM_LIMIT: 2 * sum over the steps of lr(step) * ADAM_RATIO, + 1%."""
    return 1.01 * 2 * sum(lr(s) * adam_ratio(s + 1) for s in range(steps))

# (name, B, H, W, C, gamma): the main path's two shapes first (tiny,
# 10-s clips, B=16), then the batches the inference surfaces of phase 7
# give K1 (the Evaluator, long audio, one clip), the Kaldi-fbank route's
# stage 3 of phase 14 (994 frames: 62 rows), then widths of other
# factories, an odd width, no gamma.
K1_CASES = [
    ("tiny stage 3", BATCH, 63, 14, 384, True),
    ("tiny stage 4", BATCH, 31, 7, 768, True),
    ("eval stage 3", EVAL_BATCH, 63, 14, 384, True),
    ("eval stage 4", EVAL_BATCH, 31, 7, 768, True),
    ("long stage 3", LONG_BATCH, 63, 14, 384, True),
    ("long stage 4", LONG_BATCH, 31, 7, 768, True),
    ("clip stage 3", 1, 63, 14, 384, True),
    ("clip stage 4", 1, 31, 7, 768, True),
    ("fbank stage 3", EVAL_BATCH, 62, 14, 384, True),
    ("atto stage 3", BATCH, 63, 14, 160, True),
    ("base stage 4", BATCH, 31, 7, 1024, True),
    ("odd width", 4, 13, 14, 100, True),
    ("no gamma", BATCH, 31, 7, 768, False),
]
# K1's unfused-rounding mode (the bf16 serving path's stages 1-2): the main
# path's two shapes, one clip at stage 2 (two hidden ranges and the sum
# kernel), a ragged shape, and the benchmark's batch of 256 (timed only).
# Each is held to the unfused block (_block_apply) on the card.
K1_UNFUSED_CASES = [
    ("tiny stage 1", BATCH, 252, 56, 96, True),
    ("tiny stage 2", BATCH, 126, 28, 192, True),
    ("clip stage 2", 1, 126, 28, 192, True),
    ("odd stage 1", 3, 13, 11, 96, True),
    ("eval256 stage 1", 256, 252, 56, 96, True),
    ("eval256 stage 2", 256, 126, 28, 192, True),
]
K1_UNFUSED_TIMED_ONLY = ("eval256 stage 1", "eval256 stage 2")
# K1 launches per bf16 serving forward: stages 1-2 in the unfused-rounding
# mode, stages 3-4 in K1's own rounding (K1_STAGES_34, also the training
# step's save-mode launches and an f32 serving forward's)
K1_MAIN_PATH = {"tiny stage 1": 3, "tiny stage 2": 3, "tiny stage 3": 9, "tiny stage 4": 3}
K1_UNFUSED_PATH = ("tiny stage 1", "tiny stage 2")
K1_STAGES_34 = {k: n for k, n in K1_MAIN_PATH.items() if k not in K1_UNFUSED_PATH}
# K1 save-mode and K2 calls a step of the fused bf16 training recipe: every
# block, those of stages 1-2 (K1_TRAIN_UNFUSED of them) in the kernels'
# unfused-rounding modes
K1_TRAIN_STEP = sum(K1_MAIN_PATH.values())
K1_TRAIN_UNFUSED = sum(K1_MAIN_PATH[k] for k in K1_UNFUSED_PATH)
# every K1 shape the serving paths (phases 4 and 7) launch
K1_SERVING_CASES = set(K1_MAIN_PATH) | {f"{p} stage {s}" for p in ("eval", "long", "clip")
                                       for s in (3, 4)} | {"fbank stage 3"}
# A rank's trunk batch in phase 10(b): TRAIN_CLIPS clips, paired by mixup,
# split over 2 processes.
DP_RANK_BATCH = TRAIN_CLIPS // 2 // 2
# The training paths' block shapes (K1 save mode and K2): the one-process
# step's, then a rank's of phase 10(b); then atto stage 3 and an odd width
# (K2 only).
K1_SAVE_CASES = [case for case in K1_CASES if case[0] in K1_STAGES_34] + [
    ("rank stage 3", DP_RANK_BATCH, 63, 14, 384, True),
    ("rank stage 4", DP_RANK_BATCH, 31, 7, 768, True),
]
# The bf16 training step's stages 1-2, K1's save mode and K2 in their
# unfused-rounding modes: phase 5's shapes, the benchmark's tiny-train-b64
# batch (timed in phase 6, TRAIN_UNFUSED_PATH blocks a step each), one clip
# at stage 2 (two hidden ranges and K1's sum kernel), a ragged shape.
TRAIN_UNFUSED_CASES = [
    ("tiny stage 1", BATCH, 252, 56, 96),
    ("tiny stage 2", BATCH, 126, 28, 192),
    ("b64 stage 1", 64, 252, 56, 96),
    ("b64 stage 2", 64, 126, 28, 192),
    ("clip stage 2", 1, 126, 28, 192),
    ("odd stage 1", 3, 13, 11, 96),
]
TRAIN_UNFUSED_PATH = {"b64 stage 1": 3, "b64 stage 2": 3}
K2_CASES = [
    ("tiny stage 3", BATCH, 63, 14, 384),
    ("tiny stage 4", BATCH, 31, 7, 768),
    ("rank stage 3", DP_RANK_BATCH, 63, 14, 384),
    ("rank stage 4", DP_RANK_BATCH, 31, 7, 768),
    ("atto stage 3", BATCH, 63, 14, 160),
    ("odd width", 4, 13, 14, 100),
]


def log(*args):
    print(*args, flush=True)


def power_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


REPEATS = 5  # cuda_ms runs of a kernel or the unfused block; the median is kept


def median_ms(fn, iters: int):
    """Median and (min, max) of REPEATS cuda_ms runs of fn: a run where the
    shared host held the launches back moves the spread, not the median."""
    runs = sorted(cuda_ms(fn, iters=iters) for _ in range(REPEATS))
    return runs[len(runs) // 2], (runs[0], runs[-1])


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def _toolkit(tool: str) -> str:
    """A CUDA toolkit program beside nvcc (or on PATH)."""
    from audioset_convnext_inf_torch.ops import _build

    nvcc = _build.find_nvcc()
    cand = Path(nvcc).parent / tool if nvcc else None
    return str(cand) if cand and cand.exists() else (shutil.which(tool) or tool)


def _demangle(names):
    try:
        out = subprocess.run([_toolkit("cu++filt")], input="\n".join(names), capture_output=True,
                             text=True, timeout=120, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def ptxas_report(log_text: str):
    """{mangled kernel: {"regs", "spill", "smem"}} from nvcc -Xptxas -v."""
    rep, cur = {}, None
    for ln in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)'?", ln)
        if m:
            cur = m.group(1)
            rep.setdefault(cur, {"regs": None, "spill": 0, "smem": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            rep[cur]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            rep[cur]["regs"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            rep[cur]["smem"] = int(m.group(1)) if m else 0
    return rep


def mma_counts(lib: Path):
    """{mangled kernel: (HMMA, HGMMA) instruction counts} from cuobjdump
    -sass: mma.sync shows as HMMA, Hopper's warpgroup wgmma as HGMMA."""
    out = subprocess.run([_toolkit("cuobjdump"), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            counts[cur] = [0, 0]
        elif cur is not None:
            op = re.search(r"\b(HGMMA|HMMA)\.", ln)
            if op:
                counts[cur][op.group(1) == "HGMMA"] += 1
    return {k: tuple(v) for k, v in counts.items()}


def kernel_name(demangled: str) -> str:
    """'void <unnamed>::k<(int)64, (bool)0>(...)' -> 'k<64, 0>'."""
    s = re.sub(r"\((?:int|bool|unsigned int)\)", "", demangled)
    s = s.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    s = s.replace("true", "1").replace("false", "0")
    return re.sub(r"^void ", "", s).split("(")[0]


# K2's bf16 launches (ops/fused_block_bwd.py's plan) as kernel_name gives
# them: the same instantiations at every width; in the unfused-rounding mode
# (the training step's stages 1-2) its own prep and chain
K2_MAIN_PATH = ("prep_kernel<0>", "chain_h_kernel<0>", "gemm_kernel<0>", "ln_bwd_kernel",
                "gemm_kernel<1>", "dw_bwd_kernel<__nv_bfloat16>", "sum_parts_kernel")
K2_UNFUSED = ("prep_kernel<1>", "chain_h_kernel<1>")


def k1_kernel_names(plan, save: bool, unfused: bool = False):
    """kernel_name of each launch of a bf16 K1 plan (serving, save or
    unfused-rounding mode)."""
    flags = f"{int(save)}, {int(unfused)}"
    names = [f"{plan.launches[0][0]}<{plan.out_blocks}, {flags}>"]
    return names + [f"{k}<{flags}>" for k, _ in plan.launches[1:]]


def main_path_cases():
    """The K1 cases of the main path's shapes (K1_MAIN_PATH), in its order."""
    cases = {case[0]: case for case in K1_CASES + K1_UNFUSED_CASES}
    return [cases[name] for name in K1_MAIN_PATH]


def main_path_kernels():
    """Names (as kernel_name gives them) of the bf16 instantiations the two
    paths launch at the main-path widths (B = 16; C = 96 and 192 in the
    unfused-rounding modes, 384 and 768 in serving and save mode)."""
    from audioset_convnext_inf_torch.ops import fused_block as FB

    names = set(K2_MAIN_PATH) | set(K2_UNFUSED)
    for name, b, h, w, c, _ in main_path_cases():
        p = FB.launch_plan(c, torch.bfloat16, b * h * w)
        if name in K1_UNFUSED_PATH:
            names |= {n for save in (False, True) for n in k1_kernel_names(p, save, True)}
        else:
            names |= {n for save in (False, True) for n in k1_kernel_names(p, save)}
    return names


# tensor-core kernels, all on wgmma (HGMMA): K1's bf16 kernel and K2's products
HGMMA_KERNELS = ("fused_block_wgmma_kernel", "chain_h_kernel", "gemm_kernel")
# the mma.sync kernel K1's Hopper redesign replaced: no profile may show it
K1_REPLACED = "fused_block_mma_kernel"


def k1_plan_text(p) -> str:
    """A bf16 K1 plan in words."""
    from audioset_convnext_inf_torch.ops import fused_block as FB

    budget = FB.NARROW_CONSUMER_REGS if p.sm_blocks == 2 else FB.CONSUMER_REGS
    return (f"{p.mt}-pixel tiles in {p.tiles // FB.CLUSTER} clusters of {FB.CLUSTER}, "
            f"{p.out_split} output slice(s) of {128 * p.out_blocks} channels, {p.hidden_split} "
            f"hidden range(s) of {p.per} chunks of 128: {p.ctas} blocks of {p.threads} threads, "
            f"{p.sm_blocks} an SM, "
            f"{p.stages}-box ring, {p.smem_bytes} B dynamic smem, {p.acc_regs} + 32 accumulator "
            f"registers a consumer thread (setmaxnreg budget {budget}), "
            f"{p.l2_weight_bytes / 1e6:.1f} MB of weights from L2; launches "
            + ", ".join(f"{k} x{n}" for k, n in p.launches))


def log_main_path_plans():
    """The launch plans at the main-path shapes: pixels per block, blocks
    and the dynamic shared memory each block takes (ptxas reports only the
    static part)."""
    from audioset_convnext_inf_torch.ops import fused_block as FB, fused_block_bwd as FBB

    for name, b, h, w, c, _ in main_path_cases():
        p = FB.launch_plan(c, torch.bfloat16, b * h * w)
        unf = name in K1_UNFUSED_PATH
        q = FBB.launch_plan(c, torch.bfloat16, b, h, w, unf)
        st = q.stencil
        log(f"  plan {name} (C={c}, {b * h * w} pixels): K1"
            f"{' (unfused rounding)' if unf else ''} {k1_plan_text(p)}; K2 chain "
            f"{q.mt} px x 128 hidden units/block, {q.chain_ctas} blocks, {q.chain_smem} B; "
            f"dxn {q.ksplit} reduction range(s), {q.dxn_ctas} blocks; weight-gradient "
            f"products {q.split} pixel ranges, {q.wgrad_ctas} blocks, {q.wgrad_smem} B; "
            f"stencil {st.th}x{st.tw} px x 64 channels, {q.stencil_ctas} blocks, {st.smem} B; "
            f"launches {', '.join(f'{k} x{n}' for k, n in q.launches)}")


def build_kernels(names):
    """Build every kernel library in parallel; print each instantiation's
    registers, static shared memory, spills and HMMA / HGMMA counts. Fails
    if a wgmma kernel (K1's bf16 kernel, K2's products) has no HGMMA, or if
    one the main path launches spills or is missing."""
    from audioset_convnext_inf_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        paths = list(pool.map(_build.build, names))
    log(f"build: {len(names)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    log_main_path_plans()
    main = main_path_kernels()
    bad, seen = [], set()
    for name, path in zip(names, paths):
        report = path.with_suffix(".log")
        rep = ptxas_report(report.read_text() if report.exists() else "")
        mma = mma_counts(path)
        pretty = _demangle(sorted(set(rep) | set(mma)))
        for mangled in sorted(pretty, key=lambda m: kernel_name(pretty[m])):
            kname = kernel_name(pretty[mangled])
            seen.add(kname)
            r = rep.get(mangled, {})
            n_hmma, n_hgmma = mma.get(mangled, (0, 0))
            log(f"  {name}: {kname}: {r.get('regs')} registers, {r.get('smem', 0)} B static smem, "
                f"{r.get('spill', 0)} B spilled, {n_hmma} HMMA, {n_hgmma} HGMMA"
                f"{' (main path)' if kname in main else ''}")
            if kname.startswith(HGMMA_KERNELS) and n_hgmma == 0:
                bad.append(f"{kname} has no HGMMA instruction")
            if kname in main and r.get("spill", 0):
                bad.append(f"{kname} spills {r['spill']} B on the main path")
        _build.load(name)
    bad += [f"{m} is not in the build" for m in sorted(main - seen)]
    if bad:
        raise AssertionError("build report: " + "; ".join(bad))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def k1_inputs(b, h, w, c, with_gamma, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * scale + shift).to(device)

    x = (torch.randn(b, h, w, c, generator=g) * 0.5).to(device=device, dtype=dtype)
    args = [
        rnd(c, 1, 7, 7, scale=0.05), rnd(c, scale=0.05),
        rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.05),
        rnd(4 * c, c, scale=1.0 / math.sqrt(c)), rnd(4 * c, scale=0.05),
        rnd(c, 4 * c, scale=0.5 / math.sqrt(4 * c)), rnd(c, scale=0.05),
        (torch.rand(c, generator=g) * 0.9 + 0.1).to(device) if with_gamma else None,
    ]
    return x, args


def k1_work(b, h, w, c, dtype):
    """(flops, bytes) one launch must do: the stencil and both products; x
    read and out written once, weights read once."""
    npix = b * h * w
    flops = 2 * npix * (49 * c + 8 * c * c)
    esize = torch.finfo(dtype).bits // 8
    nbytes = 2 * npix * c * esize + 8 * c * c * esize + (49 + 9) * c * 4
    return flops, nbytes


def check_k1(device):
    from audioset_convnext_inf_torch.ops.fused_block import fused_block, fused_block_reference

    results = []
    for name, b, h, w, c, with_gamma in K1_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, args = k1_inputs(b, h, w, c, with_gamma, dtype, device, SEED)
            got = fused_block(x, *args)
            again = fused_block(x, *args)
            torch.cuda.synchronize()
            ref = fused_block_reference(x, *args)
            err = (got.float() - ref.float()).abs()
            scale = max(1.0, ref.float().abs().max().item())
            max_abs = err.max().item()
            ok = bool(torch.isfinite(got.float()).all().item()) and max_abs <= KERNEL_TOL[dtype] * scale
            bit_equal = (err == 0).float().mean().item()
            same = torch.equal(got, again)
            log(f"  K1 {name:13s} {str(dtype):15s} B={b} H={h} W={w} C={c}: max_abs_err={max_abs:.3e} "
                f"rel={max_abs / scale:.3e} bit_equal={bit_equal:.4f} tol={KERNEL_TOL[dtype] * scale:.3e} "
                f"two runs bit-equal: {same} {'ok' if ok and same else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fused_block kernel disagrees with its plain version: {name} {dtype}")
            if not same:
                raise AssertionError(f"fused_block is not deterministic: {name} {dtype}")
            results.append({"case": name, "dtype": str(dtype), "max_abs_err": max_abs})
    return results


def check_k1_unfused(device):
    """K1's unfused-rounding mode at K1_UNFUSED_CASES against the unfused
    block on the card (``_block_apply``, ATen's ops, tanh GELU): within
    the kernel tolerance, deterministic, one launch a call counted as
    unfused, the same answer for x in the stem's channels-first layout, and
    a smaller mean gap to the unfused block than K1's own rounding on the
    same data (the rounding points are really the unfused block's)."""
    from audioset_convnext_inf_torch.models.convnext import _block_apply
    from audioset_convnext_inf_torch.ops import fused_block as FB

    dtype, results = torch.bfloat16, []
    for name, b, h, w, c, with_gamma in K1_UNFUSED_CASES:
        if name in K1_UNFUSED_TIMED_ONLY:
            continue
        x, args = k1_inputs(b, h, w, c, with_gamma, dtype, device, SEED)
        blk = unfused_block(c, args, device)
        before = (FB.fused_block.launches, FB.fused_block.unfused_rounding_launches)
        with torch.no_grad():
            got = FB.fused_block(x, *args, unfused_rounding=True)
            again = FB.fused_block(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), *args,
                                   unfused_rounding=True)
            own = FB.fused_block(x, *args)
            ref = _block_apply(x, blk, "xla_approx")
        torch.cuda.synchronize()
        counted = (FB.fused_block.launches - before[0],
                   FB.fused_block.unfused_rounding_launches - before[1])
        err, own_err = (got.float() - ref.float()).abs(), (own.float() - ref.float()).abs()
        scale = max(1.0, ref.float().abs().max().item())
        max_abs = err.max().item()
        same = torch.equal(got, again)
        ok = bool(torch.isfinite(got.float()).all().item()) and max_abs <= KERNEL_TOL[dtype] * scale
        nearer = err.mean().item() < own_err.mean().item()
        log(f"  K1 unfused rounding {name:15s} B={b} H={h} W={w} C={c}: vs _block_apply "
            f"max_abs_err={max_abs:.3e} mean {err.mean().item():.3e} bit_equal="
            f"{(err == 0).float().mean().item():.4f} tol={KERNEL_TOL[dtype] * scale:.3e}; K1's own "
            f"rounding vs _block_apply max {own_err.max().item():.3e} mean "
            f"{own_err.mean().item():.3e} bit_equal={(own_err == 0).float().mean().item():.4f}; "
            f"launches (all, unfused) {counted}; channels-first x bit-equal: {same} "
            f"{'ok' if ok and same and nearer and counted == (3, 2) else 'FAIL'}")
        if not ok or not nearer:
            raise AssertionError(f"K1's unfused-rounding mode disagrees with _block_apply: {name}")
        if not same or counted != (3, 2):
            raise AssertionError(f"K1's unfused-rounding mode at {name}: layouts bit-equal {same}, "
                                 f"launches {counted}")
        results.append({"case": name, "dtype": str(dtype), "max_abs_err": max_abs})
    return results


def time_k1(device):
    """Kernel and plain version in bf16 at every checked shape (K1_CASES in
    K1's own rounding, K1_UNFUSED_CASES in the unfused-rounding mode, whose
    plain version is the unfused block of ops); the main path's shapes make
    the per-forward totals."""
    from audioset_convnext_inf_torch.ops.fused_block import fused_block, fused_block_reference
    from audioset_convnext_inf_torch.ops.nhwc import convnext_block

    per_shape = {}
    unfused = {case[0] for case in K1_UNFUSED_CASES}
    for name, b, h, w, c, with_gamma in K1_CASES + K1_UNFUSED_CASES:
        dtype = torch.bfloat16
        x, args = k1_inputs(b, h, w, c, with_gamma, dtype, device, SEED)
        unf = name in unfused
        counts = (fused_block.launches, fused_block.unfused_rounding_launches)
        with torch.no_grad():
            ms, spread = median_ms(lambda: fused_block(x, *args, unfused_rounding=unf), iters=20)
            plain_ms = cuda_ms((lambda: convnext_block(x, *args)) if unf
                               else (lambda: fused_block_reference(x, *args)), iters=20)
        # timing launches are not the main path's
        fused_block.launches, fused_block.unfused_rounding_launches = counts
        flops, nbytes = k1_work(b, h, w, c, dtype)
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        per_shape[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                               bound_by="operations" if t_ops >= t_bytes else "bytes",
                               gflop=flops / 1e9, mbytes=nbytes / 1e6)
        log(f"  K1 {name:13s}{' (unfused rounding)' if unf else ''} bf16 B={b} H={h} W={w} "
            f"C={c}: kernel {ms:.4f} ms (median of {REPEATS}, "
            f"{spread[0]:.4f}-{spread[1]:.4f}), plain {plain_ms:.4f} ms, "
            f"bound {max(t_ops, t_bytes):.4f} ms ({per_shape[name]['bound_by']}; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB), kernel at {flops / ms / 1e9:.1f} TFLOP/s")
    return per_shape


def k1_save_work(b, h, w, c, dtype):
    """(flops, bytes) of one save-mode launch: K1's, plus d written and s read."""
    flops, nbytes = k1_work(b, h, w, c, dtype)
    return flops, nbytes + b * h * w * c * (torch.finfo(dtype).bits // 8) + 4 * b


def drop_scales(b, device, seed):
    """Per-sample drop-path scales as training draws them at rate 0.3, with
    sample 0 dropped: zeros and 1/keep."""
    g = torch.Generator().manual_seed(seed)
    s = (torch.rand(b, generator=g) < 0.7).float() / 0.7
    s[0] = 0.0
    return s.to(device)


def check_k1_save(device):
    """K1's save mode at the training paths' shapes: y (scaled branch) and d."""
    from audioset_convnext_inf_torch.ops.fused_block import fused_block, fused_block_reference

    results = []
    for name, b, h, w, c, _ in K1_SAVE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, args = k1_inputs(b, h, w, c, True, dtype, device, SEED)
            s = drop_scales(b, device, SEED)
            y, d = fused_block(x, *args, 1e-6, s=s, save_dwconv=True)
            y2, d2 = fused_block(x, *args, 1e-6, s=s, save_dwconv=True)
            torch.cuda.synchronize()
            y_ref, d_ref = fused_block_reference(x, *args, 1e-6, s, True)
            errs = {}
            for key, got, ref in (("y", y, y_ref), ("d", d, d_ref)):
                scale = max(1.0, ref.float().abs().max().item())
                err = (got.float() - ref.float()).abs().max().item()
                if not (bool(torch.isfinite(got.float()).all()) and err <= KERNEL_TOL[dtype] * scale):
                    raise AssertionError(f"fused_block save mode disagrees ({key}): {name} {dtype}")
                errs[key] = err
            same = torch.equal(y, y2) and torch.equal(d, d2)
            d_equal = (d == d_ref).float().mean().item()
            log(f"  K1 save {name:13s} {str(dtype):15s} B={b} H={h} W={w} C={c}: max_abs_err "
                f"y={errs['y']:.3e} d={errs['d']:.3e} (tol {KERNEL_TOL[dtype]} of scale), d bit_equal "
                f"{d_equal:.4f}, two runs bit-equal: {same} {'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"fused_block save mode is not deterministic: {name} {dtype}")
            results.append({"case": name, "dtype": str(dtype), "max_abs_err": max(errs.values())})
    return results


def train_unfused_inputs(b, h, w, c, device, seed):
    """bf16 x, the block's weights, a drop-path draw s and dy (as K2's
    cases take them) for the unfused-rounding training modes."""
    x, args = k1_inputs(b, h, w, c, True, torch.bfloat16, device, seed)
    g = torch.Generator().manual_seed(seed + 1)
    dy = torch.randn(b, h, w, c, generator=g).to(device=device, dtype=torch.bfloat16)
    return x, args, drop_scales(b, device, seed), dy


def _gap(label, got, ref, tol):
    """Max abs gap of got to ref and its share of ref's scale; raises past
    ``tol`` of scale or on a non-finite value."""
    scale = max(1.0, ref.float().abs().max().item())
    err = (got.float() - ref.float()).abs().max().item()
    if not (bool(torch.isfinite(got.float()).all()) and err <= tol * scale):
        raise AssertionError(f"{label}: err {err:.3e}, scale {scale:.3e}")
    return err, err / scale


def check_train_unfused(device):
    """K1's save mode and K2 in their unfused-rounding modes at
    TRAIN_UNFUSED_CASES against their plain versions on the card: y, d and
    z against convnext_block with the drop-path draw (the unfused block's
    ops on the card), K2's dx and nine gradients against
    fused_block_bwd_reference(..., unfused_rounding=True), each within
    KERNEL_TOL of its scale; y with s of ones bit-equal to K1's serving
    unfused-rounding mode; two calls of each bit-equal. Returns (K1 rows,
    K2 rows) of the worst gaps."""
    from audioset_convnext_inf_torch.ops.fused_block import fused_block
    from audioset_convnext_inf_torch.ops.fused_block_bwd import (
        fused_block_bwd, fused_block_bwd_reference)
    from audioset_convnext_inf_torch.ops.nhwc import convnext_block

    dt, tol = torch.bfloat16, KERNEL_TOL[torch.bfloat16]
    k1_rows, k2_rows = [], []
    for name, b, h, w, c in TRAIN_UNFUSED_CASES:
        x, args, s, dy = train_unfused_inputs(b, h, w, c, device, SEED)
        y, dz = fused_block(x, *args, 1e-6, s=s, save_dwconv=True, unfused_rounding=True)
        y2, dz2 = fused_block(x, *args, 1e-6, s=s, save_dwconv=True, unfused_rounding=True)
        y1, _ = fused_block(x, *args, 1e-6, s=torch.ones(b, device=device), save_dwconv=True,
                            unfused_rounding=True)
        serving = fused_block(x, *args, 1e-6, unfused_rounding=True)
        torch.cuda.synchronize()
        y_ref, d_ref, z_ref = convnext_block(x, *args, 1e-6, "tanh", s, saves=True)
        label = f"K1 save, unfused rounding, {name}"
        k1 = {key: _gap(f"{label} ({key})", got, ref, tol)
              for key, got, ref in (("y", y, y_ref), ("d", dz[0], d_ref), ("z", dz[1], z_ref))}
        same = torch.equal(y, y2) and torch.equal(dz, dz2)
        ones = torch.equal(y1, serving)
        log(f"  {label:42s} B={b} H={h} W={w} C={c}: max_abs_err "
            + ", ".join(f"{k} {e:.3e}" for k, (e, _) in k1.items())
            + f" (tol {tol} of scale); s of ones bit-equal to serving: {ones}; two runs "
            f"bit-equal: {same}")
        if not (same and ones):
            raise AssertionError(f"{label}: deterministic {same}, s of ones as serving {ones}")
        k1_rows.append({"case": name, "dtype": str(dt),
                        "max_abs_err": max(e for e, _ in k1.values())})
        wts = (args[0], *args[2:])
        dx, g = fused_block_bwd(x, dz, dy, *wts, s, 1e-6, True)
        dx2, g2 = fused_block_bwd(x, dz, dy, *wts, s, 1e-6, True)
        torch.cuda.synchronize()
        dx_ref, g_ref = fused_block_bwd_reference(x, dz, dy, *wts, s, 1e-6, True)
        label = f"K2, unfused rounding, {name}"
        k2 = {key: _gap(f"{label} ({key})", got, ref, tol)
              for key, got, ref in [("dx", dx, dx_ref)] + [(k, g[k], g_ref[k]) for k in g_ref]}
        worst = max(k2, key=lambda k: k2[k][1])
        same = torch.equal(dx, dx2) and all(torch.equal(g[k], g2[k]) for k in g)
        log(f"  {label:42s} B={b} H={h} W={w} C={c}: max_abs_err "
            f"{max(e for e, _ in k2.values()):.3e}, worst of scale {k2[worst][1]:.3e} ({worst}; "
            f"tol {tol}), two runs bit-equal: {same}")
        if not same:
            raise AssertionError(f"{label} is not deterministic")
        k2_rows.append({"case": name, "dtype": str(dt),
                        "max_abs_err": max(e for e, _ in k2.values())})
        del dz, dz2, g, g2, g_ref
        torch.cuda.empty_cache()
    return k1_rows, k2_rows


def k2_inputs(b, h, w, c, dtype, device, seed):
    """x, d (from the plain save-mode forward), dy, the backward's weights, s."""
    from audioset_convnext_inf_torch.ops.fused_block import fused_block_reference

    x, args = k1_inputs(b, h, w, c, True, dtype, device, seed)
    s = drop_scales(b, device, seed)
    _, d = fused_block_reference(x, *args, 1e-6, s, True)
    g = torch.Generator().manual_seed(seed + 1)
    dy = torch.randn(b, h, w, c, generator=g).to(device=device, dtype=dtype)
    return x, d, dy, (args[0], *args[2:]), s


def k2_work(b, h, w, c, dtype):
    """(flops, bytes) one backward call must do: five products of 2*N*C*4C
    and two 49-tap stencils of 2*N*C*49; x, d, dy read and dx written once,
    W1/W2 read once, the f32 gradients written once."""
    npix = b * h * w
    flops = 2 * npix * (2 * c * 49 + 5 * c * 4 * c)
    esize = torch.finfo(dtype).bits // 8
    nbytes = 4 * npix * c * esize + 8 * c * c * esize + (8 * c * c + 58 * c) * 4 + 4 * b
    return flops, nbytes


def check_k2(device):
    """K2 against its plain version: dx and the nine gradients, each within
    KERNEL_TOL of its own scale; a second call must be bit-equal."""
    from audioset_convnext_inf_torch.ops.fused_block_bwd import (
        fused_block_bwd, fused_block_bwd_reference)

    results = []
    for name, b, h, w, c in K2_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, d, dy, wts, s = k2_inputs(b, h, w, c, dtype, device, SEED)
            dx, g = fused_block_bwd(x, d, dy, *wts, s)
            dx2, g2 = fused_block_bwd(x, d, dy, *wts, s)
            torch.cuda.synchronize()
            dx_ref, g_ref = fused_block_bwd_reference(x, d, dy, *wts, s)
            worst, worst_rel, worst_name = 0.0, 0.0, ""
            for key, got, ref in [("dx", dx, dx_ref)] + [(k, g[k], g_ref[k]) for k in g_ref]:
                scale = max(1.0, ref.float().abs().max().item())
                err = (got.float() - ref.float()).abs().max().item()
                if not (bool(torch.isfinite(got.float()).all()) and err <= KERNEL_TOL[dtype] * scale):
                    raise AssertionError(f"fused_block_bwd disagrees ({key}, err {err:.3e}, scale "
                                         f"{scale:.3e}): {name} {dtype}")
                worst = max(worst, err)
                if err / scale > worst_rel:
                    worst_rel, worst_name = err / scale, key
            same = torch.equal(dx, dx2) and all(torch.equal(g[k], g2[k]) for k in g)
            log(f"  K2 {name:13s} {str(dtype):15s} B={b} H={h} W={w} C={c}: max_abs_err={worst:.3e}, "
                f"worst of scale {worst_rel:.3e} ({worst_name}; tol {KERNEL_TOL[dtype]}), "
                f"two runs bit-equal: {same}")
            if not same:
                raise AssertionError(f"fused_block_bwd is not deterministic: {name} {dtype}")
            results.append({"case": name, "dtype": str(dtype), "max_abs_err": worst})
    return results


def time_kernel(label, fn, plain, counter, flops, nbytes, dtype):
    """Kernel (median of REPEATS runs of 20 calls) and plain version by
    CUDA events; launches made here are put back off the count."""
    before = counter.launches
    ms, spread = median_ms(fn, iters=20)
    plain_ms = cuda_ms(plain, iters=10)
    counter.launches = before
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"  {label}: kernel {ms:.4f} ms (median of {REPEATS}, {spread[0]:.4f}-{spread[1]:.4f}), "
        f"plain {plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), kernel at {flops / ms / 1e9:.1f} TFLOP/s")
    return row


def time_k1_save(device):
    from audioset_convnext_inf_torch.ops.fused_block import fused_block, fused_block_reference

    per_shape = {}
    for name, b, h, w, c, _ in K1_CASES:
        if name not in K1_STAGES_34:
            continue
        dtype = torch.bfloat16
        x, args = k1_inputs(b, h, w, c, True, dtype, device, SEED)
        s = drop_scales(b, device, SEED)
        saves = fused_block.save_launches
        per_shape[name] = time_kernel(
            f"K1 save {name:13s} bf16 B={b} H={h} W={w} C={c}",
            lambda: fused_block(x, *args, 1e-6, s=s, save_dwconv=True),
            lambda: fused_block_reference(x, *args, 1e-6, s, True),
            fused_block, *k1_save_work(b, h, w, c, dtype), dtype)
        fused_block.save_launches = saves
    return per_shape


def profile_launches(fn, label: str, top: int, names=None, times=None):
    """One traced call of fn (after one untraced): device time by kernel
    name, every launch of a kernel's call printed. Returns the device-busy
    ms (union of kernel and copy intervals), or None when the profiler saw
    no device event; the kernel names seen go into the list ``names`` and
    {name: (us, count)} into the dict ``times`` where one is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session right after others can come back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            break
    if not dev:
        log(f"  profile {label}: the profiler saw no device events; kernel breakdown not measured")
        return None
    by_name = {}
    for e in dev:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    if names is not None:
        names.extend(by_name)
    if times is not None:
        times.update(by_name)
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    total = sum(t for t, _ in by_name.values())
    log(f"  profile {label}: device busy {busy / 1e3:.4f} ms, kernel time {total / 1e3:.4f} ms")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"    {t / 1e3:9.4f} ms {100 * t / total:5.1f}% x{n:<4d} {name[:90]}")
    return busy / 1e3


def profile_k1(device):
    """One profiled K1 call at each main-path shape, serving and save mode
    (stages 1-2: the unfused-rounding mode):
    every device launch of the call (the plan's kernels and the wrapper's
    preparation of the weights: the tap transpose and the bf16 casts),
    which must include each kernel of the plan and not the mma.sync kernel
    the Hopper redesign replaced; the plan's kernels' TFLOP/s and share of
    the bf16 peak (by k1_work's operations), and the plan's L2 weight
    bytes."""
    from audioset_convnext_inf_torch.ops import fused_block as FB

    dtype = torch.bfloat16
    for name, b, h, w, c, _ in main_path_cases():
        x, args = k1_inputs(b, h, w, c, True, dtype, device, SEED)
        s = drop_scales(b, device, SEED)
        plan = FB.launch_plan(c, dtype, b * h * w)
        flops, _ = k1_work(b, h, w, c, dtype)
        unf = name in K1_UNFUSED_PATH
        for save in ((False,) if unf else (False, True)):
            label = f"K1 {'save ' if save else 'unfused rounding ' if unf else ''}{name}"
            if save:
                fn = lambda: FB.fused_block(x, *args, 1e-6, s=s, save_dwconv=True)  # noqa: E731
            else:
                fn = lambda: FB.fused_block(x, *args, unfused_rounding=unf)  # noqa: E731
            before = (FB.fused_block.launches, FB.fused_block.save_launches,
                      FB.fused_block.unfused_rounding_launches)
            seen, times = [], {}
            busy = profile_launches(fn, label, top=20, names=seen, times=times)
            (FB.fused_block.launches, FB.fused_block.save_launches,
             FB.fused_block.unfused_rounding_launches) = before
            if busy is None:
                log(f"  {label}: launches not checked, TFLOP/s not measured (no device events)")
                continue
            want = [k.split("<")[0] for k in k1_kernel_names(plan, save, unf)]
            missing = [k for k in want if not any(k in n for n in seen)]
            old = [n for n in seen if K1_REPLACED in n]
            if missing or old:
                raise AssertionError(f"{label} profile: missing {missing}, replaced kernels {old}")
            kern_us = sum(t for n, (t, _) in times.items() if any(k in n for k in want))
            tflops = flops / kern_us / 1e6
            log(f"  {label}: the plan's kernels ({', '.join(want)}) {kern_us / 1e3:.4f} ms of "
                f"{busy:.4f} ms of device busy time, {tflops:.1f} TFLOP/s, "
                f"{100 * tflops * 1e12 / PEAK_FLOPS[dtype]:.1f}% of the bf16 peak; no "
                f"{K1_REPLACED}; plan: {k1_plan_text(plan)}")


def time_products(device):
    """cuBLAS's two products of a block alone at the main path's shapes:
    xn . W1^T, tanh GELU, . W2^T, bf16 torch.matmul (median of REPEATS
    runs of 20): how far K1's products are from the library's. Never a
    route of the port."""
    import torch.nn.functional as F

    out = {}
    for name, b, h, w, c, _ in main_path_cases():
        g = torch.Generator().manual_seed(SEED)
        xn = torch.randn(b * h * w, c, generator=g).to(device, torch.bfloat16)
        w1 = (torch.randn(4 * c, c, generator=g) / math.sqrt(c)).to(device, torch.bfloat16)
        w2 = (torch.randn(c, 4 * c, generator=g) * 0.5 / math.sqrt(4 * c)).to(device, torch.bfloat16)

        def products():
            return F.gelu(xn @ w1.t(), approximate="tanh") @ w2.t()

        out[name], spread = median_ms(products, iters=20)
        flops = 2 * b * h * w * 8 * c * c
        log(f"  cuBLAS products alone {name:13s} (N={b * h * w}, C={c}): {out[name]:.4f} ms "
            f"(median of {REPEATS}, {spread[0]:.4f}-{spread[1]:.4f}), {flops / out[name] / 1e9:.1f} "
            f"TFLOP/s")
    return out


def time_k2(device):
    """K2 and its plain version at each K2 case; at the main path's shapes
    also one profiled call, which must show each launch of the plan
    (ops/fused_block_bwd.py's launch list) and none of the stencil kernels
    the Hopper redesign replaced."""
    from audioset_convnext_inf_torch.ops.fused_block_bwd import (
        CUDA_LAUNCHES, fused_block_bwd, fused_block_bwd_reference, launch_plan)

    per_shape = {}
    for name, b, h, w, c in K2_CASES:
        dtype = torch.bfloat16
        x, d, dy, wts, s = k2_inputs(b, h, w, c, dtype, device, SEED)
        per_shape[name] = time_kernel(
            f"K2 {name:13s} bf16 B={b} H={h} W={w} C={c} ({CUDA_LAUNCHES} CUDA launches per call)",
            lambda: fused_block_bwd(x, d, dy, *wts, s),
            lambda: fused_block_bwd_reference(x, d, dy, *wts, s),
            fused_block_bwd, *k2_work(b, h, w, c, dtype), dtype)
        if name in K1_STAGES_34:  # where one call's time goes, launch by launch
            before, seen = fused_block_bwd.launches, []
            busy = profile_launches(lambda: fused_block_bwd(x, d, dy, *wts, s), f"K2 {name}",
                                    top=CUDA_LAUNCHES + 3, names=seen)
            fused_block_bwd.launches = before
            if busy is None:
                log(f"  K2 {name}: launch names not checked (no device events)")
                continue
            want = [k for k, _ in launch_plan(c, dtype, b, h, w).launches]
            missing = [k for k in want if not any(f"{k}(" in n or f"{k}<" in n for n in seen)]
            old = [n for n in seen if "dw_wgrad_kernel" in n or "dw_dgrad_kernel" in n]
            if missing or old:
                raise AssertionError(f"K2 {name} profile: missing {missing}, old kernels {old}")
            log(f"  K2 {name}: the profile shows the plan's {len(want)} launches "
                f"({', '.join(dict.fromkeys(want))}) and no dw_wgrad_kernel / dw_dgrad_kernel")
    return per_shape


def time_train_unfused(device):
    """K1's save mode and K2 in their unfused-rounding modes at
    TRAIN_UNFUSED_PATH's shapes, each beside its plain version, and the
    unfused bf16 block they replace in training there: its forward with the
    drop-path draw and the graph autograd records, and autograd's backward
    of it (as time_unfused). Returns ({shape: K1 row}, {shape: K2 row},
    {shape: forward ms}, {shape: backward ms})."""
    from audioset_convnext_inf_torch.models.convnext import _block_apply
    from audioset_convnext_inf_torch.ops.fused_block import fused_block
    from audioset_convnext_inf_torch.ops.fused_block_bwd import (
        CUDA_LAUNCHES, fused_block_bwd, fused_block_bwd_reference, launch_plan)
    from audioset_convnext_inf_torch.ops.nhwc import convnext_block

    dt = torch.bfloat16
    k1, k2, fwd, bwd = {}, {}, {}, {}
    for name, b, h, w, c in TRAIN_UNFUSED_CASES:
        if name not in TRAIN_UNFUSED_PATH:
            continue
        x, args, s, dy = train_unfused_inputs(b, h, w, c, device, SEED)
        counts = {(f, k): getattr(f, k) for f in (fused_block, fused_block_bwd) for k in vars(f)
                  if k.endswith("launches")}
        k1[name] = time_kernel(
            f"K1 save, unfused rounding, {name} bf16 B={b} H={h} W={w} C={c}",
            lambda: fused_block(x, *args, 1e-6, s=s, save_dwconv=True, unfused_rounding=True),
            lambda: convnext_block(x, *args, 1e-6, "tanh", s, saves=True),
            fused_block, *k1_save_work(b, h, w, c, dt), dt)
        _, dz = fused_block(x, *args, 1e-6, s=s, save_dwconv=True, unfused_rounding=True)
        wts = (args[0], *args[2:])
        k2[name] = time_kernel(
            f"K2, unfused rounding, {name} bf16 B={b} H={h} W={w} C={c} ({CUDA_LAUNCHES} CUDA "
            f"launches per call)",
            lambda: fused_block_bwd(x, dz, dy, *wts, s, 1e-6, True),
            lambda: fused_block_bwd_reference(x, dz, dy, *wts, s, 1e-6, True),
            fused_block_bwd, *k2_work(b, h, w, c, dt), dt)
        seen = []  # where one K2 call's time goes, launch by launch
        busy = profile_launches(lambda: fused_block_bwd(x, dz, dy, *wts, s, 1e-6, True),
                                f"K2 unfused rounding {name}", top=CUDA_LAUNCHES + 3, names=seen)
        want = [k for k, _ in launch_plan(c, dt, b, h, w, True).launches]
        missing = [k for k in want if not any(f"{k}(" in n or f"{k}<" in n for n in seen)]
        if busy is not None and missing:
            raise AssertionError(f"K2 unfused rounding {name} profile: missing {missing}")
        for (f, k), v in counts.items():  # the launches made here are put back off the counts
            setattr(f, k, v)
        del dz
        blk = unfused_block(c, args, device)
        xg = x.detach().requires_grad_(True)
        inputs = [xg, *blk.parameters()]
        fwd[name], spread = median_ms(lambda: _block_apply(xg, blk, "xla_approx", s), iters=20)
        log(f"  unfused bf16 block {name:13s} B={b} H={h} W={w} C={c}: forward with its "
            f"autograd graph {fwd[name]:.4f} ms (median of {REPEATS}, {spread[0]:.4f}-"
            f"{spread[1]:.4f})")
        y = _block_apply(xg, blk, "xla_approx", s)
        bwd[name], spread = median_ms(
            lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True), iters=20)
        log(f"  autograd backward of the unfused bf16 block {name:13s}: {bwd[name]:.4f} ms "
            f"(median of {REPEATS}, {spread[0]:.4f}-{spread[1]:.4f})")
        log(f"  {name}: K1 save {k1[name]['ms']:.4f} + K2 {k2[name]['ms']:.4f} = "
            f"{k1[name]['ms'] + k2[name]['ms']:.4f} ms vs the unfused block's forward "
            f"{fwd[name]:.4f} + backward {bwd[name]:.4f} = {fwd[name] + bwd[name]:.4f} ms "
            f"({(fwd[name] + bwd[name]) / (k1[name]['ms'] + k2[name]['ms']):.2f}x)")
        del y, xg, inputs
        torch.cuda.empty_cache()
    return k1, k2, fwd, bwd


def unfused_block(c, args, device):
    """The port's plain block (models/convnext.py Block) holding K1's
    weights: what training runs at stages 1-2, and the function K1's
    unfused-rounding mode computes there in serving."""
    from audioset_convnext_inf_torch.models.convnext import Block

    blk = Block(c, 1e-6, 1.0).to(device)
    with torch.no_grad():
        for t, v in zip((blk.dwconv.weight, blk.dwconv.bias, blk.norm.weight, blk.norm.bias,
                         blk.pwconv1.weight, blk.pwconv1.bias, blk.pwconv2.weight,
                         blk.pwconv2.bias, blk.gamma), args):
            t.copy_(v)
    return blk


def time_unfused(device):
    """The unfused bf16 block (_block_apply(..., "xla_approx"): cuDNN
    depthwise conv, LN, two cuBLAS products, GELU, several launches) at the
    main path's shapes: the yardstick for which stages K1 should take, and
    autograd's backward of the same block, with K1's weights and K2's dy
    and drop-path scales (k2_inputs), the yardstick K2 replaces. The
    backward is torch.autograd.grad over one graph (retain_graph), the
    forward outside the timed window. Each is the median of
    REPEATS cuda_ms runs, spread printed. Returns ({shape: forward
    ms}, {shape: backward ms})."""
    from audioset_convnext_inf_torch.models.convnext import _block_apply

    fwd, bwd = {}, {}
    for name, b, h, w, c, _ in main_path_cases() + [k for k in K1_CASES if k[0] == "fbank stage 3"]:
        x, args = k1_inputs(b, h, w, c, True, torch.bfloat16, device, SEED)
        blk = unfused_block(c, args, device)
        with torch.no_grad():
            fwd[name], spread = median_ms(lambda: _block_apply(x, blk, "xla_approx"), iters=20)
        log(f"  unfused bf16 block {name:13s} B={b} H={h} W={w} C={c}: forward {fwd[name]:.4f} ms "
            f"(median of {REPEATS}, {spread[0]:.4f}-{spread[1]:.4f})")
        if name not in K1_STAGES_34:  # stages 1-2 and the Kaldi-fbank route's stage 3: no K2
            continue
        xb, _, dy, _, s = k2_inputs(b, h, w, c, torch.bfloat16, device, SEED)
        xg = xb.detach().requires_grad_(True)
        inputs = [xg, *blk.parameters()]
        y = _block_apply(xg, blk, "xla_approx", s)
        bwd[name], spread = median_ms(
            lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True), iters=20)
        log(f"  autograd backward of the unfused bf16 block {name:13s}: {bwd[name]:.4f} ms "
            f"(median of {REPEATS}, {spread[0]:.4f}-{spread[1]:.4f}; {len(inputs)} "
            f"gradients, the forward outside the window)")
        del y, xg, inputs
    return fwd, bwd


def compare_yardsticks(k1, k1_save, k2, fwd, bwd, products):
    """K1 (both modes) beside the unfused forward and cuBLAS's products
    alone, and K2 beside autograd's backward of the unfused block, at the
    main path's shapes (stages 1-2: the unfused-rounding mode beside the
    unfused forward); K1 beside the unfused forward at the Kaldi-fbank
    route's stage 3."""
    for name in K1_UNFUSED_PATH:
        log(f"  {name}: K1 unfused rounding {k1[name]['ms']:.4f} ms vs unfused forward "
            f"{fwd[name]:.4f} ms ({fwd[name] / k1[name]['ms']:.2f}x) and cuBLAS's products "
            f"alone {products[name]:.4f} ms")
    for name in K1_STAGES_34:
        log(f"  {name}: K1 {k1[name]['ms']:.4f} ms, save {k1_save[name]['ms']:.4f} ms vs unfused "
            f"forward {fwd[name]:.4f} ms ({fwd[name] / k1[name]['ms']:.2f}x, save "
            f"{fwd[name] / k1_save[name]['ms']:.2f}x) and cuBLAS's products alone "
            f"{products[name]:.4f} ms; K2 {k2[name]['ms']:.4f} ms vs autograd backward "
            f"{bwd[name]:.4f} ms ({bwd[name] / k2[name]['ms']:.2f}x)")
    name = "fbank stage 3"
    log(f"  {name}: K1 {k1[name]['ms']:.4f} ms vs unfused forward {fwd[name]:.4f} ms "
        f"({fwd[name] / k1[name]['ms']:.2f}x)")


# the AdamW kernel over convnext_tiny's leaves (phases 3 and 6): it replaces
# no TPU kernel (optax's update, fused by XLA) but the port's per-leaf loop

ADAMW_UPDATES = 5  # updates the kernel and its plain version take side by side


def adamw_leaves(device):
    """The training model's 184 parameters (seeded as phase 5's), one seeded
    gradient set a leaf at scales 1e-12 to 1, and the recipe's config."""
    model = build_train_model(device)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    scales = np.random.RandomState(SEED + 11).randint(-12, 1, size=(ADAMW_UPDATES, len(params)))
    grads = [{n: torch.randn(p.shape, generator=gen, device=device) * 10.0 ** float(e)
              for (n, p), e in zip(params.items(), row)} for row in scales]
    return params, grads, train_config()


def check_adamw(device):
    """The Optimizer (the kernel) against the plain loop on the card over
    ADAMW_UPDATES updates of convnext_tiny's 184 leaves: p, m and v must be
    bit-equal after every update, every update fused."""
    from audioset_convnext_inf_torch.engine.trainer import Optimizer, _wd_mask, onecycle_lr
    from audioset_convnext_inf_torch.ops import adamw as A

    params, grads, cfg = adamw_leaves(device)
    plain = {n: p.clone() for n, p in params.items()}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    names, decay, lr = list(params), _wd_mask(params), onecycle_lr(cfg)
    opt = Optimizer(params, cfg)
    before = A.adamw_update_.launches
    for k in range(ADAMW_UPDATES):
        opt.step(grads[k])
        t = k + 1
        A.adamw_update_reference([plain[n] for n in names], [grads[k][n] for n in names],
                                 [mu[n] for n in names], [nu[n] for n in names],
                                 [decay[n] for n in names], lr(k), cfg.weight_decay,
                                 1 - A.B1 ** t, 1 - A.B2 ** t)
        torch.cuda.synchronize()
        differ = sum(int((a[n] != b[n]).sum()) for a, b in ((params, plain), (opt.mu, mu),
                                                            (opt.nu, nu)) for n in names)
        if differ:
            raise AssertionError(f"AdamW update {k}: {differ} values of p, m, v differ from "
                                 f"the plain loop's")
    launches = A.adamw_update_.launches - before
    log(f"  AdamW kernel vs the plain loop on the card: {len(names)} leaves "
        f"({sum(p.numel() for p in params.values()):,} values, {sum(decay.values())} decaying), "
        f"{ADAMW_UPDATES} updates: p, m, v bit-equal after each; {launches} launches "
        f"({launches // ADAMW_UPDATES} an update), updates fused {opt.fused_updates}, "
        f"loop {opt.loop_updates}")
    if (opt.fused_updates, opt.loop_updates) != (ADAMW_UPDATES, 0) or launches > 3 * ADAMW_UPDATES:
        raise AssertionError(f"AdamW: fused {opt.fused_updates}, loop {opt.loop_updates}, "
                             f"{launches} launches over {ADAMW_UPDATES} updates")
    A.adamw_update_.launches = before


ADAMW_OPS = 16  # f32 operations a value: the moments 7, the step 5, decay 2, p 2
ADAMW_BYTES = 28  # p, g, m, v read and p, m, v written, f32


def queued_ms(fn, iters: int, host_ms: float) -> float:
    """Device ms of fn() over ``iters`` calls queued behind a sleep on the
    stream long enough for the host to issue them all (``host_ms`` a call),
    so that the host's issue time stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * (10.0 + 2.0 * host_ms * iters)))  # at ~2 GHz: 10 ms + twice that
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_adamw(device):
    """At convnext_tiny's 184 leaves: the host's ms to issue one update, the
    card's ms for one (the median of REPEATS runs of 20 updates queued ahead
    of the card, by CUDA events) beside the bound, for the kernel and the
    plain loop, and the plain loop's ms as a step sees it (host-bound: 20
    updates not queued ahead)."""
    from audioset_convnext_inf_torch.engine.trainer import _wd_mask
    from audioset_convnext_inf_torch.ops import adamw as A

    params, grads, _ = adamw_leaves(device)
    names = list(params)
    mask = _wd_mask(params)
    args = ([params[n] for n in names], [grads[0][n] for n in names],
            [torch.zeros_like(params[n]) for n in names],
            [torch.zeros_like(params[n]) for n in names], [mask[n] for n in names],
            1e-4, 0.01, 0.1, 0.001)
    fns = {"kernel": lambda: A.adamw_update_(*args),
           "plain": lambda: A.adamw_update_reference(*args)}
    before = A.adamw_update_.launches
    host, dev = {}, {}
    for label, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host[label] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        runs = sorted(queued_ms(fn, 20, host[label]) for _ in range(REPEATS))
        dev[label] = (runs[REPEATS // 2], runs[0], runs[-1])
    plain_ms, plain_spread = median_ms(fns["plain"], iters=20)
    A.adamw_update_.launches = before
    values = sum(params[n].numel() for n in names)
    bound = ADAMW_BYTES * values / PEAK_BYTES * 1e3
    launches = len(A.launch_plan([params[n].numel() for n in names], args[4]))
    ms = dev["kernel"][0]
    log(f"  AdamW, convnext_tiny's {len(names)} leaves ({values:,} values, {launches} launches): "
        f"kernel {ms:.4f} ms on the card (median of {REPEATS} runs of 20 queued, "
        f"{dev['kernel'][1]:.4f}-{dev['kernel'][2]:.4f}), bound {bound:.4f} ms (bytes: "
        f"{ADAMW_BYTES * values / 1e6:.1f} MB; {ADAMW_OPS * values / 1e9:.2f} GFLOP), "
        f"{bound / ms * 100:.1f}% of it, {ADAMW_BYTES * values / ms / 1e6:.0f} GB/s; plain loop "
        f"{dev['plain'][0]:.4f} ms on the card ({dev['plain'][1]:.4f}-{dev['plain'][2]:.4f}), "
        f"{plain_ms:.4f} ms not queued ({plain_spread[0]:.4f}-{plain_spread[1]:.4f}); host ms "
        f"to issue an update: kernel {host['kernel']:.3f}, plain loop {host['plain']:.3f}; no "
        f"library_ms: no PyTorch call computes optax's update (torch.optim.AdamW's fused and "
        f"foreach routes apply the decay and eps otherwise)")
    return dict(ms=ms, plain_ms=plain_ms, plain_device_ms=dev["plain"][0], bound_ms=bound,
                host_ms=host["kernel"], plain_host_ms=host["plain"])


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def fixture_batch(batch: int, seed: int) -> np.ndarray:
    """(batch, 320000) int16: the fixture recording, then seeded variants
    (circular shifts, gains, a little noise)."""
    with wave.open(str(FIXTURE), "rb") as f:
        pcm = np.frombuffer(f.readframes(f.getnframes()), dtype=np.int16)[:320000]
    rng = np.random.RandomState(seed)
    out = [pcm]
    for _ in range(batch - 1):
        y = np.roll(pcm.astype(np.float32), rng.randint(1, 320000)) * rng.uniform(0.2, 1.0)
        y = y + rng.randn(320000) * 30.0
        out.append(np.clip(np.round(y), -32767, 32767).astype(np.int16))
    return np.stack(out)


@torch.no_grad()
def seed_state(model, seed: int):
    """Seeded gamma (0.1-1) and bn0 values: at init gamma is 1e-6 and every
    block is nearly the identity."""
    g = torch.Generator().manual_seed(seed)
    for stage in model.stages:
        for blk in stage:
            blk.gamma.copy_(torch.rand(blk.gamma.shape, generator=g) * 0.9 + 0.1)
    bn = model.bn0
    n = bn.weight.shape[0]
    bn.weight.copy_(torch.rand(n, generator=g) * 1.5 + 0.5)
    bn.bias.copy_(torch.randn(n, generator=g) * 0.5)
    bn.running_mean.copy_(torch.randn(n, generator=g) * 5.0 - 40.0)
    bn.running_var.copy_(torch.rand(n, generator=g) * 150.0 + 50.0)
    return model


def build_model(device, dtype):
    from audioset_convnext_inf_torch.models import convnext_tiny

    return seed_state(convnext_tiny(seed=SEED, device=device, compute_dtype=dtype), SEED + 1)


def run_main_path(device):
    from audioset_convnext_inf_torch.ops.fused_block import fused_block

    pcm = fixture_batch(BATCH, SEED)
    serve = build_model(device, torch.bfloat16)
    assert serve.cfg.block_impl == "xla_approx" and serve.cfg.frontend.precision == "default"
    expect = sum(K1_MAIN_PATH.values())
    expect_unfused = sum(K1_MAIN_PATH[k] for k in K1_UNFUSED_PATH)
    calls = [("forward", serve.forward), ("forward_scene_embeddings", serve.forward_scene_embeddings),
             ("forward_frame_embeddings", serve.forward_frame_embeddings)]
    outs, launches = {}, 0
    for name, fn in calls:
        fused_block.launches = fused_block.unfused_rounding_launches = 0
        outs[name] = fn(pcm)
        torch.cuda.synchronize()
        n, unf = fused_block.launches, fused_block.unfused_rounding_launches
        log(f"  bf16 serving {name}: fused_block launches {n} (expect {expect}), of them in the "
            f"unfused-rounding mode {unf} (expect {expect_unfused})")
        if n != expect or unf != expect_unfused:
            raise AssertionError(f"{name}: fused_block launched {n} times, {unf} of them unfused, "
                                 f"expected {expect} and {expect_unfused}")
        launches += n
    probs = outs["forward"]["clipwise_output"]
    shapes = {"forward": (probs.shape, (BATCH, 527)),
              "forward_scene_embeddings": (outs["forward_scene_embeddings"].shape, (BATCH, 768)),
              "forward_frame_embeddings": (outs["forward_frame_embeddings"].shape, (BATCH, 768, 31, 7))}
    for name, (got, want) in shapes.items():
        log(f"  bf16 serving {name}: shape {tuple(got)}")
        if tuple(got) != want:
            raise AssertionError(f"{name}: shape {tuple(got)}, expected {want}")
    tensors = [probs, outs["forward"]["clipwise_logits"], outs["forward_scene_embeddings"],
               outs["forward_frame_embeddings"]]
    if not all(bool(torch.isfinite(t.float()).all()) for t in tensors):
        raise AssertionError("bf16 serving outputs are not finite")

    parity = build_model(device, torch.float32)
    assert parity.cfg.block_impl == "xla" and parity.cfg.frontend.precision == "highest"
    fused_block.launches = 0
    ref = parity.forward(pcm)
    torch.cuda.synchronize()
    if fused_block.launches != 0 or fused_block.unfused_rounding_launches != expect_unfused:
        raise AssertionError(f"f32 parity config launched fused_block {fused_block.launches} times")
    cpu = build_model("cpu", torch.float32)
    cpu_ref = cpu.forward(pcm[:2])
    logit_err = (ref["clipwise_logits"][:2].cpu() - cpu_ref["clipwise_logits"]).abs().max().item()
    log(f"  f32 parity: card vs CPU logits (2 clips) max_abs_err={logit_err:.3e} (tol {F32_LOGIT_TOL}); "
        f"logit std {ref['clipwise_logits'].std().item():.3f}")
    if not logit_err <= F32_LOGIT_TOL:
        raise AssertionError("f32 parity config on the card disagrees with the CPU")
    prob_err = (probs - ref["clipwise_output"]).abs().max().item()
    log(f"  bf16 serving vs f32 parity probabilities: max_abs_err={prob_err:.3e} (tol {SERVING_PROB_TOL})")
    if not prob_err <= SERVING_PROB_TOL:
        raise AssertionError("bf16 serving probabilities drift from f32 parity")
    top = probs[0].float().topk(3)
    log(f"  clip 0 top-3 classes (random weights): {top.indices.tolist()}")
    return serve, launches


def row0_layers(model, pcm, row=0):
    """{layer: row ``row`` of its output} of model.forward on the int16
    batch ``pcm``: the frontend's power spectrum and mel product, then every
    layer forward's tap sees (the layer-by-layer view of fault 1, PERF.md)."""
    from audioset_convnext_inf_torch.models import convnext as F
    from audioset_convnext_inf_torch.ops import frontend as FE
    from audioset_convnext_inf_torch.ops.pcm import decode_pcm_if_int16

    rows = {}

    def tap(name, x):
        rows[name] = x[row].float().cpu().clone()

    with torch.inference_mode():
        x = decode_pcm_if_int16(torch.from_numpy(pcm).to(model.device))
        fe = model.frontend
        power = FE.power_spectrogram_conv(x, fe.cfg, fe.dft_weight)
        tap("frontend: power spectrum", power)
        tap("frontend: mel product", FE._matmul(power, fe.mel_weights.t(), fe.cfg.precision))
        F.forward(model, x, model.cfg, fe, model.compute_dtype, tap=tap)
    return rows


def check_row_independence(serve):
    """Fault 1 at full size: row 0 of B=16 holds the fixture clip beside
    zero rows, then beside 15 other clips; row 0 of every layer's output
    must be bit-equal. Reported beside: the clip at row 5, and the first 8
    rows as a batch of 8 (a replica's share in phase 10(c))."""
    pcm = fixture_batch(BATCH, SEED + 51)
    zeros = np.zeros_like(pcm)
    zeros[0] = pcm[0]
    moved = pcm.copy()
    moved[[0, 5]] = pcm[[5, 0]]
    a, b = row0_layers(serve, zeros), row0_layers(serve, pcm)
    parted = next((n for n in a if not torch.equal(a[n], b[n])), None)
    for label, other in (("at row 5", row0_layers(serve, moved, row=5)),
                         ("at B=8", row0_layers(serve, pcm[:8]))):
        where = next((n for n in b if not torch.equal(b[n], other[n])), None)
        pdiff = (torch.sigmoid(other["head"]) - torch.sigmoid(b["head"])).abs().max().item()
        log(f"  fault 1: the clip {label} vs row 0 of B={BATCH}: first layer that parts "
            f"{where}, probabilities max diff {pdiff:.3e}")
    log(f"  fault 1: row 0 beside zeros vs beside other clips, {len(a)} layers: first layer "
        f"that parts {parted}")
    if parted is not None:
        raise AssertionError(f"row 0's answer depends on its neighbours from {parted} on")


# ---------------------------------------------------------------------------
# phase 5: the training path
# ---------------------------------------------------------------------------

def train_batch(clips: int, seed: int):
    """(clips, 320000) int16 fixture-derived PCM and seeded multi-hot targets."""
    pcm = fixture_batch(clips, seed)
    rng = np.random.RandomState(seed + 7)
    target = (rng.rand(clips, 527) < 0.01).astype(np.float32)
    target[np.arange(clips), rng.randint(0, 527, clips)] = 1.0
    return pcm, target


def build_train_model(device, fused: bool = True, drop_path_rate: float = 0.1,
                      frontend_precision: str = "high"):
    """convnext_tiny in the JAX package's fused training recipe
    (cli/train.py with --bf16 --block-impl xla_approx --fused-train-blocks):
    tanh GELU, layer scale 1e-6 then seeded gamma, frontend precision "high"."""
    from audioset_convnext_inf_torch.config import FrontendConfig
    from audioset_convnext_inf_torch.models import convnext_tiny

    model = convnext_tiny(drop_path_rate=drop_path_rate, block_impl="xla_approx",
                          fused_train_blocks=fused,
                          frontend=FrontendConfig(precision=frontend_precision),
                          seed=SEED, device=device)
    if model.count_parameters() != 28_222_767:
        raise AssertionError(f"convnext_tiny has {model.count_parameters()} parameters")
    return seed_state(model, SEED + 1)


def train_config(bf16: bool = True):
    from audioset_convnext_inf_torch.engine.trainer import TrainConfig

    return TrainConfig(bf16_compute=bf16, mixup_alpha=1.0)


def _counts():
    from audioset_convnext_inf_torch.ops.fused_block import fused_block
    from audioset_convnext_inf_torch.ops.fused_block_bwd import fused_block_bwd

    return fused_block.launches, fused_block.save_launches, fused_block_bwd.launches


def _zero_counts():
    from audioset_convnext_inf_torch.ops.fused_block import fused_block
    from audioset_convnext_inf_torch.ops.fused_block_bwd import fused_block_bwd

    fused_block.launches = fused_block.save_launches = fused_block_bwd.launches = 0
    fused_block.unfused_rounding_launches = fused_block.unfused_rounding_save_launches = 0
    fused_block_bwd.unfused_rounding_launches = 0


def _unfused_counts():
    """(K1 serving, K1 save, K2) launches in the unfused-rounding modes."""
    from audioset_convnext_inf_torch.ops.fused_block import fused_block
    from audioset_convnext_inf_torch.ops.fused_block_bwd import fused_block_bwd

    return (fused_block.unfused_rounding_launches, fused_block.unfused_rounding_save_launches,
            fused_block_bwd.unfused_rounding_launches)


def run_training_path(device):
    """TRAIN_STEPS Trainer.step calls; each must launch K1 (save mode) and K2
    once per block, at stages 1-2 in their unfused-rounding modes. Returns
    the launches over the run and those in the unfused-rounding modes."""
    from audioset_convnext_inf_torch.engine.trainer import Trainer
    from audioset_convnext_inf_torch.ops.fused_block import fused_block

    model = build_train_model(device)
    trainer = Trainer(model, train_config())
    pcm, target = train_batch(TRAIN_CLIPS, SEED)
    per_step, unf_step = K1_TRAIN_STEP, (0, K1_TRAIN_UNFUSED, K1_TRAIN_UNFUSED)
    _zero_counts()
    for i in range(TRAIN_STEPS):
        before, unf_before = _counts(), _unfused_counts()
        loss = trainer.step(pcm, target)
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(_counts(), before))
        unf = tuple(a - b for a, b in zip(_unfused_counts(), unf_before))
        log(f"  train step {i}: loss {loss:.6f}; launches K1 {delta[0]} (save mode {delta[1]}), "
            f"K2 {delta[2]} (expect {per_step} each); in the unfused-rounding modes (K1 "
            f"serving, K1 save, K2) {unf} (expect {unf_step})")
        if not math.isfinite(loss):
            raise AssertionError(f"training step {i}: loss is not finite")
        if delta != (per_step, per_step, per_step) or unf != unf_step:
            raise AssertionError(f"training step {i} launched {delta}, expected {per_step} each; "
                                 f"unfused-rounding modes {unf}, expected {unf_step}")
    launches, unfused = _counts(), _unfused_counts()
    check_fused_updates(trainer.optimizer, TRAIN_STEPS, "training path")
    _zero_counts()
    out = model.forward(pcm[:BATCH])
    torch.cuda.synchronize()
    per_f32 = sum(K1_STAGES_34.values())
    log(f"  trained model, eval forward B={BATCH} (f32): launches (K1, K1 save, K2) {_counts()} "
        f"(expect ({per_f32}, 0, 0))")
    if _counts() != (per_f32, 0, 0) or fused_block.unfused_rounding_launches:
        raise AssertionError(f"eval forward after training launched {_counts()}")
    if not bool(torch.isfinite(out["clipwise_output"]).all()):
        raise AssertionError("eval forward after training is not finite")
    return launches, unfused


def _grad_err(got, ref):
    """{tensor: max |got - ref| over its scale max(1, max|ref|)}, the JAX
    package's fused-vs-XLA metric."""
    return {n: (got[n] - ref[n]).abs().max().item() / max(1.0, ref[n].abs().max().item())
            for n in ref}


def check_fused_vs_unfused(device):
    """One training step's gradients, fused stages 3-4 against the plain
    blocks, drop path off, same weights and draws, in bf16 and in f32
    (FUSED_GRAD_TOL says what each is held to)."""
    from audioset_convnext_inf_torch.engine.trainer import Trainer

    pcm, target = train_batch(TRAIN_CLIPS, SEED + 3)
    grads = {}
    for bf16 in (True, False):
        for fused in (True, False):
            model = build_train_model(device, fused=fused, drop_path_rate=0.0)
            trainer = Trainer(model, train_config(bf16))
            loss = trainer.step(pcm, target)
            grads[bf16, fused] = {n: p.grad.float().clone() for n, p in model.named_parameters()}
            log(f"  training step, {'bf16' if bf16 else 'f32'}, {'fused' if fused else 'unfused'} "
                f"blocks: loss {loss:.6f}")
            del model, trainer
            torch.cuda.empty_cache()
    ref = grads[False, False]
    errs = {}
    for label, a, b in (("bf16 fused vs bf16 unfused", grads[True, True], grads[True, False]),
                        ("f32 fused vs f32 unfused", grads[False, True], ref),
                        ("bf16 fused vs f32 unfused", grads[True, True], ref),
                        ("bf16 unfused vs f32 unfused", grads[True, False], ref)):
        errs[label] = _grad_err(a, b)
        top = sorted((v, n) for n, v in errs[label].items())[-3:]
        log(f"  gradients {label}, worst of scale over {len(b)} tensors: "
            + ", ".join(f"{n} {e:.3e}" for e, n in reversed(top)))
    f32_err = max(errs["f32 fused vs f32 unfused"].values())
    added = {n: errs["bf16 fused vs f32 unfused"][n] - errs["bf16 unfused vs f32 unfused"][n]
             for n in ref}
    worst_added = max(added.values())
    log(f"  f32: fused vs unfused {f32_err:.3e} of scale (tol {FUSED_GRAD_TOL[torch.float32]}); "
        f"bf16: error the fused blocks add to the unfused route's, worst {worst_added:.3e} of scale "
        f"({max(added, key=added.get)}; tol {FUSED_GRAD_TOL[torch.bfloat16]})")
    if not f32_err <= FUSED_GRAD_TOL[torch.float32]:
        raise AssertionError("fused and unfused training gradients disagree in f32")
    if not worst_added <= FUSED_GRAD_TOL[torch.bfloat16]:
        raise AssertionError("bf16 fused training gradients are farther from f32 than the unfused")


def check_fused_updates(optimizer, steps: int, label: str):
    """Every update of ``steps`` went through the AdamW kernel."""
    got = (optimizer.fused_updates, optimizer.loop_updates)
    log(f"  {label}: optimizer updates through the AdamW kernel {got[0]}, through the plain "
        f"loop {got[1]} (expect {steps}, 0)")
    if got != (steps, 0):
        raise AssertionError(f"{label}: optimizer updates (fused, loop) {got}, expected "
                             f"({steps}, 0)")


# ---------------------------------------------------------------------------
# phase 7: inference surfaces
# ---------------------------------------------------------------------------

def _k1_count(fn):
    """(fn(), K1 serving launches it made): the count is set to 0 just
    before and read just after."""
    from audioset_convnext_inf_torch.ops.fused_block import fused_block

    fused_block.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, fused_block.launches


def _expect_launches(label, got, want):
    log(f"  {label}: K1 launches {got} (expect {want})")
    if got != want:
        raise AssertionError(f"{label}: K1 launched {got} times, expected {want}")


def check_checkpoint_round_trip(serve, device, pcm):
    """The serving model written as safetensors and as a native directory,
    each loaded by ConvNeXt.from_pretrained: outputs bit-equal to the
    model's. Returns the K1 launches of the loaded models' forwards (the
    reference forward's are not counted)."""
    from audioset_convnext_inf_torch.checkpoint.io import save_checkpoint, save_safetensors
    from audioset_convnext_inf_torch.models import ConvNeXt

    per = sum(K1_MAIN_PATH.values())
    ref = serve.forward(pcm)
    total = 0
    st = WORK / "tiny.safetensors"
    save_safetensors(serve.state_dict(), str(st))
    native = save_checkpoint(str(WORK / "tiny_native"), serve.state_dict(), serve.cfg)
    for label, path in (("safetensors", str(st)), ("native directory", native)):
        loaded = ConvNeXt.from_pretrained(path, compute_dtype=torch.bfloat16, device=device)
        got, n = _k1_count(lambda: loaded.forward(pcm))
        total += n
        _expect_launches(f"from_pretrained({label}) forward B={len(pcm)}", n, per)
        same = all(torch.equal(got[k], ref[k]) for k in ref)
        diff = max((got[k] - ref[k]).abs().max().item() for k in ref)
        log(f"  checkpoint round trip via {label} ({os.path.getsize(st) / 1e6:.1f} MB file): "
            f"outputs bit-equal {same} (max abs diff {diff:.3e})")
        if not same:
            raise AssertionError(f"from_pretrained({label}) does not reproduce the model's outputs")
        del loaded
    return total


def eval_data(seed: int):
    """EVAL_CLIPS int16 fixture-derived clips and seeded multi-hot targets."""
    pcm = fixture_batch(EVAL_CLIPS, seed)
    rng = np.random.RandomState(seed + 11)
    target = (rng.rand(EVAL_CLIPS, 527) < 0.02).astype(np.float32)
    target[np.arange(EVAL_CLIPS), rng.randint(0, 527, EVAL_CLIPS)] = 1.0
    return pcm, target


class MemoryDataset:
    """The AudioSetDataset contract (meta -> {audio_name, waveform, target})
    over arrays in memory: the card machine has no h5py."""

    def __init__(self, pcm, target):
        self.pcm, self.target = pcm, target

    def __getitem__(self, meta):
        i = meta["index_in_hdf5"]
        return {"audio_name": f"clip{i:04d}", "waveform": self.pcm[i], "target": self.target[i]}


def eval_loader(pcm, target, n):
    """The port's DataLoader over the first n clips of MemoryDataset, in
    EvaluateSampler's batches of metas, padded to EVAL_BATCH."""
    from audioset_convnext_inf_torch.data import DataLoader

    metas = [{"index_in_hdf5": i, "target": target[i]} for i in range(n)]
    batches = [metas[i:i + EVAL_BATCH] for i in range(0, n, EVAL_BATCH)]
    return DataLoader(MemoryDataset(pcm, target), batches, num_workers=4,
                      pad_to_batch_size=EVAL_BATCH)


def check_evaluator(serve, device, pcm, target):
    """Evaluator over EVAL_CLIPS clips: K1 launches, probabilities against
    model.forward on the same padded batches, finite metrics. Returns its
    launches (the reference forwards' are not counted)."""
    from audioset_convnext_inf_torch.engine import metrics as M
    from audioset_convnext_inf_torch.engine.evaluator import Evaluator

    ev = Evaluator(serve, device=device)
    batches = -(-EVAL_CLIPS // EVAL_BATCH)
    out, n = _k1_count(lambda: ev.infer_probs(eval_loader(pcm, target, EVAL_CLIPS)))
    _expect_launches(f"Evaluator over {EVAL_CLIPS} clips, B={EVAL_BATCH} ({batches} batches)",
                     n, batches * sum(K1_MAIN_PATH.values()))
    probs = out["clipwise_output"]
    if probs.shape != (EVAL_CLIPS, 527) or not np.array_equal(out["target"], target):
        raise AssertionError(f"Evaluator returned {probs.shape} probabilities or other targets")
    ref = []
    for i in range(0, EVAL_CLIPS, EVAL_BATCH):
        x = pcm[i:i + EVAL_BATCH]
        k = len(x)
        x = np.pad(x, ((0, EVAL_BATCH - k), (0, 0)))
        ref.append(serve.forward(x)["clipwise_output"].cpu().numpy()[:k])
    ref = np.concatenate(ref)
    diff = float(np.abs(probs - ref).max())
    log(f"  Evaluator vs model.forward on the same padded batches: bit-equal "
        f"{np.array_equal(probs, ref)} (max abs diff {diff:.3e})")
    if not np.array_equal(probs, ref):
        raise AssertionError("Evaluator probabilities differ from model.forward's")
    s = M.summarize(M.evaluate_clipwise(probs, target))
    log(f"  metrics (random weights, seeded targets): mAP {s['mAP']:.6f}, AUC {s['mAUC']:.6f}, "
        f"d-prime {s['dprime']:.6f}")
    if not all(math.isfinite(v) for v in s.values()):
        raise AssertionError(f"Evaluator metrics are not finite: {s}")
    return n


def check_tagging(serve):
    """tag_clip, tag_long_audio and embed_long_audio on the fixture."""
    from audioset_convnext_inf_torch.engine import infer as I

    per = sum(K1_MAIN_PATH.values())
    res, n = _k1_count(lambda: I.tag_clip(serve, I.load_clip(str(FIXTURE)), threshold=0.25))
    _expect_launches("tag_clip(load_clip(fixture))", n, per)
    total = n
    log(f"  tag_clip at 0.25 (random weights): {len(res['indexes'])} classes; first indexes "
        f"{res['indexes'][:8].tolist()}, labels {res['labels'][:4]}")
    with wave.open(str(FIXTURE), "rb") as f:
        clip = np.frombuffer(f.readframes(f.getnframes()), dtype=np.int16)
    sig = np.tile(clip, 4)[:35 * 32000]
    out, n = _k1_count(lambda: I.tag_long_audio(serve, sig, hop_samples=5 * 32000,
                                                batch_size=LONG_BATCH))
    _expect_launches(f"tag_long_audio, 35-s int16 signal, 5-s hop, batch {LONG_BATCH}", n, per)
    total += n
    emb, n = _k1_count(lambda: I.embed_long_audio(serve, sig, batch_size=LONG_BATCH))
    _expect_launches("embed_long_audio, same signal (frame and scene calls)", n, 2 * per)
    total += n
    shapes = {"windowwise_output": (out["windowwise_output"].shape, (6, 527)),
              "clipwise_output": (out["clipwise_output"].shape, (527,)),
              "frame_embeddings": (emb["frame_embeddings"].shape, (768, 124, 7)),
              "scene_embedding": (emb["scene_embedding"].shape, (768,))}
    for name, (got, want) in shapes.items():
        log(f"  {name}: shape {tuple(got)}")
        if tuple(got) != want:
            raise AssertionError(f"{name}: shape {tuple(got)}, expected {want}")
    if not all(np.isfinite(a).all() for a in (out["clipwise_output"], emb["frame_embeddings"])):
        raise AssertionError("long-audio outputs are not finite")
    return total


def run_clis():
    """The CLIs' main() with their default device (the card): convert the
    phase-7 safetensors file to a native directory, and the demo on that
    directory and the fixture (f32, as the demo loads it: no K1)."""
    import contextlib
    import io

    from audioset_convnext_inf_torch.cli import convert, demo

    def run(name, main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, n = _k1_count(lambda: main(argv))
        lines = buf.getvalue().splitlines()
        if rc != 0:
            raise AssertionError(f"cli.{name} exited {rc}")
        log(f"  cli.{name}: exit 0, K1 launches {n}; " + " | ".join(
            ln for ln in lines if ln and not ln.startswith((" ", "[")) and not ln[0].isdigit()))
        return n

    native = str(WORK / "cli_native")
    total = run("convert", convert.main, [str(WORK / "tiny.safetensors"), native, "--to", "native"])
    total += run("demo", demo.main, [str(FIXTURE), "--checkpoint", native])
    return total


# ---------------------------------------------------------------------------
# phase 8: the tagging service
# ---------------------------------------------------------------------------

def _post(url, body: bytes, content_type: str):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": content_type},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def _check_top(out, want, label):
    """A /tag answer (top-10 indexes and probabilities) against the
    reference probabilities: the probabilities within SERVICE_TOL and the
    indexes among the reference's top ten up to it. Returns the max diff."""
    idx = np.asarray(out["indexes"])
    diff = float(np.abs(np.asarray(out["probs"]) - want[idx]).max())
    tenth = np.sort(want)[-10]
    if not (diff <= SERVICE_TOL and want[idx].min() >= tenth - SERVICE_TOL):
        raise AssertionError(f"{label}: answer off by {diff:.3e} (tol {SERVICE_TOL}) or not "
                             f"the top ten")
    return diff


def _send_all(call):
    """SERVE_CLIENTS threads, each sending every clip of the pool once,
    from its own first clip on; ``call(i) -> max diff against the
    reference`` checks each answer. Returns (answers, max diff)."""
    diffs, errors = [], []

    def client(t):
        for k in range(SERVE_POOL):
            try:
                diffs.append(call((t + k) % SERVE_POOL))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))
                return

    threads = [threading.Thread(target=client, args=(t,)) for t in range(SERVE_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise AssertionError(f"{len(errors)} client(s) failed: {errors[:3]}")
    return len(diffs), max(diffs)


def _check_batches(label, service, before, answers, diff, replicas: int = 1):
    """After _send_all: every request answered, one clip a request, and K1
    launched 18 times per batch per replica. Returns the K1 launches."""
    after = service.counters()
    batches, clips = after["batches"] - before["batches"], after["clips"] - before["clips"]
    launches = _counts()
    per = sum(K1_MAIN_PATH.values()) * replicas
    log(f"  {label}: {answers} requests from {SERVE_CLIENTS} client threads, 10-s int16 clips, "
        f"batch {BATCH}, max wait 20 ms: {clips} clips in {batches} batches; max diff vs "
        f"forward {diff:.3e} (tol {SERVICE_TOL}); K1 launches {launches[0]} (expect {per} a batch)")
    if answers != SERVE_REQUESTS or clips != answers or launches != (per * batches, 0, 0):
        raise AssertionError(f"{label}: {clips} clips for {answers} of {SERVE_REQUESTS} requests, "
                             f"launches {launches} for {batches} batches (expect {per} K1 per batch)")
    return launches[0]


def run_service(serve):
    """Phase 8. Returns the K1 launches of the service's runs."""
    from audioset_convnext_inf_torch.cli import serve as serve_cli
    from audioset_convnext_inf_torch.engine.infer import sliding_windows

    per = sum(K1_MAIN_PATH.values())
    pool = fixture_batch(SERVE_POOL, SEED + 21)
    ref = np.concatenate([serve.forward(pool[i:i + BATCH])["clipwise_output"].cpu().numpy()
                          for i in range(0, SERVE_POOL, BATCH)])
    server, service = serve_cli.make_server(
        ["--port", "0", "--batch-size", str(BATCH), "--max-wait-ms", "20"], model=serve)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    total = 0
    try:
        def http_tag(i):
            return _check_top(_post(url + "/tag", pool[i].astype("<i2").tobytes(),
                                     "application/pcm-int16"), ref[i], f"/tag clip {i}")

        def batcher_tag(i):
            got = service.tag(pool[i], timeout=120)["clipwise_output"]
            diff = float(np.abs(got - ref[i]).max())
            if not diff <= SERVICE_TOL:
                raise AssertionError(f"batcher clip {i}: off by {diff:.3e}")
            return diff

        for label, call in (("HTTP /tag", http_tag), ("batcher alone", batcher_tag)):
            _zero_counts()
            before = service.counters()
            answers, diff = _send_all(call)
            torch.cuda.synchronize()
            total += _check_batches(label, service, before, answers, diff)

        sig = np.tile(pool[0], 3)[:800000]  # 25 s: 3 windows
        windows, n = sliding_windows(sig)
        want = serve.forward(np.pad(windows, ((0, BATCH - n), (0, 0))))["clipwise_output"]
        want = want.cpu().numpy()[:n].max(axis=0)
        _zero_counts()
        before = service.counters()
        out = _post(url + "/tag", sig.astype("<i2").tobytes(), "application/pcm-int16")
        torch.cuda.synchronize()
        batches = service.counters()["batches"] - before["batches"]
        diff = _check_top(out, want, "25-s /tag")
        log(f"  25-s /tag: num_windows {out['num_windows']}, {batches} batch(es), max diff "
            f"{diff:.3e}, K1 launches {_counts()[0]}")
        if out["num_windows"] != 3 or _counts() != (per * batches, 0, 0):
            raise AssertionError(f"25-s /tag: {out['num_windows']} windows, launches {_counts()}")
        total += _counts()[0]

        emb_ref = serve.forward_scene_embeddings(pool[:1])[0].float().cpu().numpy()
        _zero_counts()
        emb = np.asarray(_post(url + "/embed", pool[0].astype("<i2").tobytes(),
                               "application/pcm-int16")["embedding"])
        torch.cuda.synchronize()
        ediff = float(np.abs(emb - emb_ref).max())
        etol = KERNEL_TOL[torch.bfloat16] * max(1.0, float(np.abs(emb_ref).max()))
        log(f"  /embed: {emb.shape}, max diff vs forward_scene_embeddings (B=1) {ediff:.3e} "
            f"(tol {etol:.3e}), K1 launches {_counts()[0]}")
        if emb.shape != (emb_ref.shape[0],) or not ediff <= etol or _counts() != (per, 0, 0):
            raise AssertionError(f"/embed: shape {emb.shape}, diff {ediff}, launches {_counts()}")
        total += per
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.load(r)
        log(f"  /healthz: {health}")
        if health["status"] != "ok" or health["clips"] != health["requests"]:
            raise AssertionError(f"/healthz: {health}")
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
        thread.join(timeout=30)
    return total


# ---------------------------------------------------------------------------
# phase 9: the training CLI's loop
# ---------------------------------------------------------------------------

def memory_index(target):
    """An index in load_index's layout over MemoryDataset's clips."""
    n = len(target)
    return {"audio_names": np.array([f"clip{i:04d}" for i in range(n)]),
            "hdf5_paths": np.array(["memory"] * n), "indexes_in_hdf5": np.arange(n),
            "targets": target}


class CliRunner:
    """Runs of cli/train.py::train over the in-memory training and
    evaluation sets, in the fused bf16 recipe; each step's loss and launch
    deltas are recorded and checked (K1 save and K2 18 times a step, 6 of
    them in the unfused-rounding modes, and K1 12 times per evaluation batch
    before a step that evaluates)."""

    def __init__(self):
        pcm, self.target = train_batch(TRAIN_CLI_CLIPS, SEED + 31)
        epcm, etarget = eval_data(SEED + 33)
        self.epcm, self.etarget = epcm[:TRAIN_CLI_EVAL], etarget[:TRAIN_CLI_EVAL]
        self.data = MemoryDataset(pcm, self.target)
        self.edata = MemoryDataset(self.epcm, self.etarget)
        self.per = K1_TRAIN_STEP  # training steps
        self.unf_per = (0, K1_TRAIN_UNFUSED, K1_TRAIN_UNFUSED)  # (K1, K1 save, K2) unfused
        self.eval_per = sum(K1_STAGES_34.values())  # f32 evaluation batches
        self.eval_batches = -(-TRAIN_CLI_EVAL // 32)

    @staticmethod
    def flags(ws, early_stop, resume=0):
        return ["--train-indexes", "memory", "--model", "convnext_tiny", "--bf16",
                "--block-impl", "xla_approx", "--fused-train-blocks", "--sampler", "balanced",
                "--mixup-alpha", "1.0", "--batch-size", str(TRAIN_CLIPS // 2),
                "--num-workers", "4", "--eval-interval", "3", "--checkpoint-interval", "3",
                "--eval-batch-size", "32", "--early-stop", str(early_stop),
                "--resume-iteration", str(resume), "--seed", str(SEED), "--workspace", str(ws)]

    def run(self, ws, early_stop, resume=0, on_step_extra=None):
        """One CLI run: per step its loss and launch deltas;
        ``on_step_extra(iteration)`` runs inside each step's callback.
        Returns the steps, the run's launches and those in the
        unfused-rounding modes."""
        from audioset_convnext_inf_torch.cli import train as train_cli

        root = logging.getLogger()
        level, handlers = root.level, list(root.handlers)
        steps = []

        def on_step(it, loss):  # after the step's loss reached the host
            if on_step_extra is not None:
                on_step_extra(it)
            counts = _counts() + _unfused_counts()
            steps.append((it, loss, tuple(a - b for a, b in zip(counts, last))))
            last[:] = counts

        _zero_counts()
        last = list(_counts() + _unfused_counts())
        args = train_cli.parse_args(self.flags(ws, early_stop, resume))
        try:
            train_cli.train(args, memory_index(self.target), {"test": memory_index(self.etarget)},
                            self.data, self.edata, on_step=on_step)
        finally:
            for h in root.handlers[:]:  # the log handlers create_logging added
                if h not in handlers:
                    root.removeHandler(h)
                    h.close()
            root.setLevel(level)
        torch.cuda.synchronize()
        for it, loss, d in steps:
            evals = it > 0 and it % 3 == 0  # the evaluation before this step
            log(f"    step {it}: loss {loss:.6f}, launches (K1, K1 save, K2) {d[:3]}, in the "
                f"unfused-rounding modes {d[3:]}" + (" (evaluation before it)" if evals else ""))
            per = self.per
            want = (per + (self.eval_per * self.eval_batches if evals else 0), per, per)
            if d != want + self.unf_per or not math.isfinite(loss):
                raise AssertionError(f"step {it}: launches {d}, expected {want + self.unf_per}; "
                                     f"loss {loss}")
        return steps, _counts(), _unfused_counts()


def _ckpt_params(ws, it):
    from audioset_convnext_inf_torch.checkpoint import load_checkpoint, state_dict_from_jax_params

    ck = load_checkpoint(str(ws / "checkpoints" / "convnext_tiny" / f"{it}_iterations"))
    if ck["iteration"] != it:
        raise AssertionError(f"checkpoint {it}_iterations holds iteration {ck['iteration']}")
    return ck, state_dict_from_jax_params(ck["params"])


def _param_diffs(pa, pc):
    buffers = ("bn0.running_mean", "bn0.running_var")
    pdiff = max(float(np.abs(pa[k] - pc[k]).max()) for k in pa if k not in buffers)
    bdiff = max(float(np.abs(pa[k] - pc[k]).max()) for k in buffers)
    return pdiff, bdiff


def run_train_cli(runner):
    """Phase 9. Returns (K1 serving, K1 save, K2) launches of the three runs,
    the same in the unfused-rounding modes, and the parameters of the
    3-step run's checkpoint."""
    from audioset_convnext_inf_torch.engine.trainer import TrainConfig, onecycle_lr

    straight, resumed = WORK / "train_straight", WORK / "train_resumed"
    steps_a, counts_a, unf_a = runner.run(straight, 6)
    log(f"  straight run, 6 steps (2 evaluations of {TRAIN_CLI_EVAL} clips, 2 checkpoints)")
    _, counts_b, unf_b = runner.run(resumed, 3)
    _, three = _ckpt_params(resumed, 3)
    steps_c, counts_c, unf_c = runner.run(resumed, 6, resume=3)
    a, pa = _ckpt_params(straight, 6)
    c, pc = _ckpt_params(resumed, 6)
    sa, sc = (_leaves(x["sampler_state"]) for x in (a, c))
    same = len(sa) == len(sc) and all(np.array_equal(x, y) for x, y in zip(sa, sc))
    pdiff, bdiff = _param_diffs(pa, pc)
    limit = resume_param_limit(onecycle_lr(TrainConfig()), 6)
    losses = {it: loss for it, loss, _ in steps_a}
    log(f"  resumed at 3 for 3 steps vs straight: sampler state bit-equal {same}; parameters "
        f"max diff {pdiff:.3e} (limit {limit:.3e}), bn0 running statistics {bdiff:.3e}; losses "
        + ", ".join(f"step {it} {loss:.6f} vs {losses[it]:.6f}" for it, loss, _ in steps_c))
    if not same or not pdiff <= limit:
        raise AssertionError("the resumed run is not the straight run")
    with open(straight / "statistics" / "convnext_tiny" / "statistics.pkl", "rb") as f:
        stats = pickle.load(f)
    maps = [s["mAP"] for s in stats["test"]]
    log(f"  statistics: evaluations at {[s['iteration'] for s in stats['test']]}, mAP {maps}")
    if [s["iteration"] for s in stats["test"]] != [3] or not all(map(math.isfinite, maps)):
        raise AssertionError(f"statistics {stats}")
    counts = [sum(x) for x in zip(counts_a, counts_b, counts_c)]
    unfused = tuple(sum(x) for x in zip(unf_a, unf_b, unf_c))
    return (counts[0] - counts[1], counts[1], counts[2]), unfused, three


# ---------------------------------------------------------------------------
# phase 10: data parallelism on the one card
# ---------------------------------------------------------------------------

DP_WORLD = 2  # processes of the gloo pair, both on card 0
# The pair's one Trainer step (32 clips in, 16 a rank, 8 a rank after
# mixup; each rank is handed its rows, parallel.shard_batch, as the
# training CLI hands them) against one process's step on the same 32
# clips. The gradients are the check that holds the step: the averaged
# .grad each rank's step leaves (its rows' gradients, all-reduced), each
# leaf's error as a share of its norm.
#  - f32, unfused blocks, mixup 1.0, drop path 0.1, SpecAugment, true-f32
#    frontend: every draw is the global batch's, sliced, so only the order
#    of the sums differs (each rank sums its 8 rows; the all-reduce adds the
#    halves). Against the one-process step, with the CPU test's constants
#    (tests/test_torch_parallel.py, the JAX package's for its sharded step):
#    loss and each gradient leaf rtol 1e-5 (DP_GRAD_RTOL), parameters atol
#    1e-5; bn0's running statistics within 1e-5 of their
#    scale max(1, |x|) (f32 sums over 32k frames of values near -40 dB
#    carry relative noise);
#  - bf16, fused blocks (K1 save, K2), drop path 0, the recipe's TF32
#    frontend. The one-process bf16 step is bit-deterministic, but each
#    rank's trunk runs at batch 8 instead of 16, the libraries' bf16
#    kernels round at other points there, and the bf16 backward lifts that
#    to a large share of the sums that cancel most: against the
#    one-process step, median leaf 1.650e-02 and stage 1's first
#    depthwise bias 1.036e-01 (PERF.md §6). That is the size of bf16's
#    own error: against the same step in f32 (true-f32 frontend) the
#    one-process bf16 step's median leaf is 2.999e-02 and the two
#    processes' 3.021e-02 (that bias 1.983e-01 and 2.281e-01). So each leaf
#    is held against f32: the two processes' error within DP_GRAD_FACTOR
#    times the one-process step's own plus DP_GRAD_FLOOR (2^-6, for leaves
#    whose own error is tiny; measured: the nearest leaf at 0.553 of its
#    bound); a gradient that is not averaged, or a rank's rows lost, is off
#    by 1/2 or more on every leaf. Loss rtol 2^-8 (one bf16 ulp; the loss averages 8 x 527
#    terms a rank); bn0's statistics within 1e-3 of their scale (TF32
#    products, 2^-11 relative each, may be summed by another kernel at
#    another batch). The parameters are also held to RESUME_PARAM_LIMIT for
#    one step, an extra check only: Adam moves a parameter by at most lr x
#    ADAM_RATIO in a step, whatever the gradients.
DP_CASES = (
    # label, bf16, fused, drop path, frontend precision
    ("f32, unfused, drop path 0.1", False, False, 0.1, "highest"),
    ("bf16, fused, drop path 0", True, True, 0.0, "high"),
)
DP_LOSS_RTOL = {False: 1e-5, True: 2.0 ** -8}
DP_STAT_RTOL = {False: 1e-5, True: 1e-3}
DP_GRAD_RTOL = 1e-5  # f32: each leaf, against the one-process step
DP_GRAD_FACTOR, DP_GRAD_FLOOR = 2.0, 2.0 ** -6  # bf16: each leaf, against f32
DP_F32_PARAM_TOL = 1e-5
# Evaluator over two replicas (each 32 rows of a batch of 64) against one.
# No op mixes rows or depends on a row's position (fault 1), but each
# replica runs a batch of 32, not 64, and cuBLAS chooses its kernel by the
# row count: at convnext_atto on 1-s clips the f32 sums of the frontend's
# mel product parted by 2.98e-08 between B=8 and B=16 (PERF.md §6;
# the probabilities stayed bit-equal). A part that small can move one bf16
# rounding downstream by one ulp: bound 2^-8 of a probability.
SHARDED_EVAL_TOL = 2.0 ** -8


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_nccl_world_1(runner, three):
    """Phase 10(a): cli/train.py::train under a torchrun environment of one
    process (RANK=0, WORLD_SIZE=1): the NCCL group, the all-reduces of a
    group of one, 3 steps; the parameters within RESUME_PARAM_LIMIT of
    phase 9's first 3 steps. Returns the (K1, K1 save, K2) launches and
    the same in the unfused-rounding modes."""
    from audioset_convnext_inf_torch.engine.trainer import TrainConfig, onecycle_lr

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    groups = []

    def probe(it):
        dist = torch.distributed
        groups.append((dist.get_backend(), dist.get_world_size()) if dist.is_initialized()
                      else None)

    os.environ.update(env)
    try:
        _, counts, unfused = runner.run(WORK / "train_nccl", 3, on_step_extra=probe)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _, params = _ckpt_params(WORK / "train_nccl", 3)
    pdiff, bdiff = _param_diffs(three, params)
    limit = resume_param_limit(onecycle_lr(TrainConfig()), 3)
    log(f"  NCCL at world size 1, 3 steps: process group per step {groups}; parameters vs "
        f"phase 9's first 3 steps: max diff {pdiff:.3e} (limit {limit:.3e}), bn0 running "
        f"statistics {bdiff:.3e}; left the group: {not torch.distributed.is_initialized()}")
    if groups != [("nccl", 1)] * 3 or torch.distributed.is_initialized():
        raise AssertionError(f"the CLI ran in {groups}, expected an NCCL group of one")
    if not pdiff <= limit:
        raise AssertionError("NCCL world-1 training is not phase 9's training")
    return counts, unfused


def dp_worker(rank, world, rendezvous, out, device):
    """Phase 10(b), one process of the gloo pair on ``device``: for each of
    DP_CASES two Trainer steps on this rank's rows of the global batch;
    what it saw goes to ``<out>/rank<r>.pkl`` (the state and the averaged
    gradients after the first step)."""
    from audioset_convnext_inf_torch.engine.trainer import Trainer
    from audioset_convnext_inf_torch.parallel import get_mesh, initialize_distributed, shard_batch

    device = torch.device(device)
    initialize_distributed(f"file://{rendezvous}", world, rank, backend="gloo", device=device)
    mesh = get_mesh([device])
    pcm, target = shard_batch(train_batch(TRAIN_CLIPS, SEED + 41), mesh)
    seen = {}
    for label, bf16, fused, dp, precision in DP_CASES:
        trainer = Trainer(build_train_model(device, fused, dp, precision), train_config(bf16),
                          mesh=mesh)
        steps, state, grads = [], None, None
        for _ in range(2):
            _zero_counts()
            loss = trainer.step(pcm, target)
            steps.append({"loss": loss, "launches": _counts(), "unfused": _unfused_counts()})
            if state is None:
                state = {k: v.detach().float().cpu().numpy()
                         for k, v in trainer.model.state_dict().items()}
                grads = {k: p.grad.float().cpu().numpy()
                         for k, p in trainer.model.named_parameters()}
        seen[label] = {"steps": steps, "state": state, "grads": grads}
        del trainer
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    with open(Path(out) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(seen, f)


def run_dp_pair(device):
    """Phase 10(b): the gloo pair against one process's step. Returns the
    (K1 save, K2) launches of both ranks' steps, then the same in the
    unfused-rounding modes."""
    import torch.multiprocessing as mp

    from audioset_convnext_inf_torch.engine.trainer import Trainer, TrainConfig, onecycle_lr

    pcm, target = train_batch(TRAIN_CLIPS, SEED + 41)

    def one_process(bf16, fused, dp, precision):
        model = build_train_model(device, fused, dp, precision)
        loss = Trainer(model, train_config(bf16)).step(pcm, target)
        state = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
        grads = {k: p.grad.float().cpu().numpy() for k, p in model.named_parameters()}
        del model
        torch.cuda.empty_cache()
        return loss, state, grads

    # each case's one-process step twice (the second: the step's own
    # run-to-run spread), and for bf16 the same route in f32 with a true-f32
    # frontend (the yardstick of bf16's own gradient error)
    refs = {label: (one_process(bf16, fused, dp, precision),
                    one_process(bf16, fused, dp, precision)[2],
                    one_process(False, fused, dp, "highest")[2] if bf16 else None)
            for label, bf16, fused, dp, precision in DP_CASES}
    out = WORK / "dp"
    out.mkdir(parents=True, exist_ok=True)
    card0 = "cuda:0" if device.type == "cuda" else str(device)
    mp.start_processes(dp_worker, args=(DP_WORLD, str(out / "rendezvous"), str(out), card0),
                       nprocs=DP_WORLD, start_method="spawn")
    log(f"  {DP_WORLD} processes on {card0}, backend gloo")
    ranks = []
    for r in range(DP_WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    launches = [0, 0, 0, 0]
    buffers = ("bn0.running_mean", "bn0.running_var")
    for label, bf16, fused, dp, precision in DP_CASES:
        (ref_loss, ref, ref_grads), again, f32 = refs[label]
        a = ranks[0][label]
        same = all(np.array_equal(a["state"][k], x[label]["state"][k])
                   for x in ranks[1:] for k in ref) and \
            all(np.array_equal(a["grads"][k], x[label]["grads"][k])
                for x in ranks[1:] for k in ref_grads)
        gerr = _rel_norms(a["grads"], ref_grads)
        spread = _rel_norms(again, ref_grads)
        if bf16:  # against f32: the two processes' error over its bound from bf16's own
            own, dp_err = _rel_norms(ref_grads, f32), _rel_norms(a["grads"], f32)
            share = {k: dp_err[k] / (DP_GRAD_FACTOR * own[k] + DP_GRAD_FLOOR) for k in own}
            gworst = max(share.values())
        else:
            gworst = max(gerr.values())
        loss = a["steps"][0]["loss"]
        pdiff = max(float(np.abs(a["state"][k] - ref[k]).max()) for k in ref if k not in buffers)
        sdiff = max(float((np.abs(a["state"][k] - ref[k]) / np.maximum(1.0, np.abs(ref[k]))).max())
                    for k in buffers)
        plimit = resume_param_limit(onecycle_lr(TrainConfig()), 1) if bf16 else DP_F32_PARAM_TOL
        lerr = abs(loss - ref_loss) / abs(ref_loss)
        log(f"  {label}: world {DP_WORLD} vs one process: loss {loss:.6f} vs {ref_loss:.6f} "
            f"(rel {lerr:.3e}, tol {DP_LOSS_RTOL[bf16]:.3e}); parameters max diff {pdiff:.3e} "
            f"(tol {plimit:.3e}); bn0 statistics {sdiff:.3e} of scale (tol "
            f"{DP_STAT_RTOL[bf16]:.0e}); ranks bit-equal {same}")
        log(f"    averaged gradients, error norm over the leaf's norm, {len(gerr)} leaves: vs "
            f"the one-process step {_worst(gerr)}; the one-process step run again "
            f"{_worst(spread)}")
        if bf16:
            near = sorted(share, key=share.get, reverse=True)[:3]
            log(f"    vs the f32 step: the one-process bf16 step {_worst(own)}; the two "
                f"processes' {_worst(dp_err)}; nearest their bound {DP_GRAD_FACTOR} x the "
                f"one-process error + {DP_GRAD_FLOOR:.3e}: "
                + ", ".join(f"{k} {dp_err[k]:.3e} vs {own[k]:.3e} ({share[k]:.3f} of the bound)"
                            for k in near))
        else:
            log(f"    worst leaf {gworst:.3e} (tol {DP_GRAD_RTOL:.0e})")
        for r, x in enumerate(ranks):
            for i, st in enumerate(x[label]["steps"]):
                log(f"    rank {r} step {i}: loss {st['loss']:.6f}, launches (K1, K1 save, K2) "
                    f"{st['launches']}, in the unfused-rounding modes {st['unfused']}")
                per = K1_TRAIN_STEP if bf16 else sum(K1_STAGES_34.values())
                want = (per, per, per) if fused else (0, 0, 0)
                unf = K1_TRAIN_UNFUSED if bf16 and fused else 0
                if st["launches"] != want or st["unfused"] != (0, unf, unf) \
                        or not math.isfinite(st["loss"]):
                    raise AssertionError(f"{label} rank {r} step {i}: launches {st['launches']}, "
                                         f"expected {want}; in the unfused-rounding modes "
                                         f"{st['unfused']}, expected (0, {unf}, {unf}); loss "
                                         f"{st['loss']}")
                launches[0] += st["launches"][1]
                launches[1] += st["launches"][2]
                launches[2] += st["unfused"][1]
                launches[3] += st["unfused"][2]
        if not (same and lerr <= DP_LOSS_RTOL[bf16] and pdiff <= plimit
                and sdiff <= DP_STAT_RTOL[bf16]
                and gworst <= (1.0 if bf16 else DP_GRAD_RTOL)):
            raise AssertionError(f"{label}: the data-parallel step is not the one-process step")
    shutil.rmtree(out)
    return tuple(launches)


def _rel_norms(got, ref):
    """{leaf: |got - ref| / |ref|}, Frobenius norms."""
    return {k: float(np.linalg.norm(got[k] - r) / max(float(np.linalg.norm(r)), 1e-30))
            for k, r in ref.items()}


def _worst(errs, top: int = 3) -> str:
    """The ``top`` worst leaves and the median, as text."""
    worst = sorted(errs, key=errs.get, reverse=True)[:top]
    return (", ".join(f"{k} {errs[k]:.3e}" for k in worst)
            + f" (median {float(np.median(list(errs.values()))):.3e})")


def check_sharded_evaluator(serve, device, pcm, target):
    """Phase 10(c): the Evaluator over two replicas on the one card against
    one replica, over phase 7's clips at B=EVAL_BATCH. Each replica runs a
    block of EVAL_BATCH / 2 rows: bit-equal to model.forward of each block,
    and within SHARDED_EVAL_TOL of the one-replica Evaluator. Returns its K1
    launches."""
    from audioset_convnext_inf_torch.engine.evaluator import Evaluator

    half = EVAL_BATCH // 2
    one = Evaluator(serve, device=device).infer_probs(eval_loader(pcm, target, EVAL_CLIPS))
    two = Evaluator(serve, devices=[device, device])
    out, n = _k1_count(lambda: two.infer_probs(eval_loader(pcm, target, EVAL_CLIPS)))
    batches = -(-EVAL_CLIPS // EVAL_BATCH)
    _expect_launches(f"Evaluator over 2 replicas, {EVAL_CLIPS} clips at B={EVAL_BATCH}", n,
                     2 * batches * sum(K1_MAIN_PATH.values()))
    probs = out["clipwise_output"]
    padded = np.pad(pcm[:EVAL_CLIPS], ((0, batches * EVAL_BATCH - EVAL_CLIPS), (0, 0)))
    blocks = np.concatenate([serve.forward(padded[i:i + half])["clipwise_output"].cpu().numpy()
                             for i in range(0, len(padded), half)])[:EVAL_CLIPS]
    diff = float(np.abs(probs - one["clipwise_output"]).max())
    log(f"  2 replicas vs model.forward of each {half}-row block: bit-equal "
        f"{np.array_equal(probs, blocks)}; vs the one-replica Evaluator: max abs diff {diff:.3e} "
        f"(tol {SHARDED_EVAL_TOL})")
    if not np.array_equal(probs, blocks) or not diff <= SHARDED_EVAL_TOL:
        raise AssertionError("the two-replica Evaluator is not the one-replica Evaluator")
    return n


def run_service_mesh(serve):
    """Phase 10(d): cli/serve.py --mesh with the phase-4 model: the batches
    go through ShardedModel over every card; phase 8's HTTP requests, every
    answer within SERVICE_TOL of model.forward of its clip, K1 18 times per
    replica batch. Returns the K1 launches."""
    from audioset_convnext_inf_torch.cli import serve as serve_cli
    from audioset_convnext_inf_torch.engine.service import ShardedModel

    pool = fixture_batch(SERVE_POOL, SEED + 21)
    ref = np.concatenate([serve.forward(pool[i:i + BATCH])["clipwise_output"].cpu().numpy()
                          for i in range(0, SERVE_POOL, BATCH)])
    server, service = serve_cli.make_server(
        ["--port", "0", "--batch-size", str(BATCH), "--max-wait-ms", "20", "--mesh"], model=serve)
    cards = torch.cuda.device_count()
    if not isinstance(service.model, ShardedModel) or \
            len(service.model.replicas.devices) != cards:
        raise AssertionError("serve --mesh did not shard over every card")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        def http_tag(i):
            return _check_top(_post(url + "/tag", pool[i].astype("<i2").tobytes(),
                                     "application/pcm-int16"), ref[i], f"/tag clip {i}")

        _zero_counts()
        before = service.counters()
        answers, diff = _send_all(http_tag)
        torch.cuda.synchronize()
        return _check_batches(f"HTTP /tag, serve --mesh over {cards} card(s)", service, before,
                              answers, diff, replicas=cards)
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
        thread.join(timeout=30)


# ---------------------------------------------------------------------------
# phase 11: AOT serving bundles
# ---------------------------------------------------------------------------

# A bundle's program against the live model on the same card: the same ops
# in the same order with the same launch plans, so bit-equal is expected;
# allowed is the JAX package's export-vs-live tolerance on probabilities.
BUNDLE_TOL = 1e-6
BUNDLE_DIR = WORK / "bundles"
# ct and rfft on the card against the port's CPU frontend, "highest": the
# CPU tests' tolerances against the JAX package (tests/test_torch_frontend.py),
# dB on all bins and on bins above -40 dB.
FRONTEND_DB_TOL = (0.15, 2e-3)


def _bundle_check(label, got, want, launches, expect):
    """Max abs diff of every output of ``got`` against ``want`` (dicts or
    tensors) within BUNDLE_TOL, and K1 launches equal to ``expect``."""
    pairs = ([(got[k], want[k]) for k in sorted(want)] if isinstance(want, dict)
             else [(got, want)])
    diff = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    bits = all(torch.equal(a, b) for a, b in pairs)
    log(f"  bundle {label}: max diff vs live {diff:.3e} (tol {BUNDLE_TOL}; bit-equal {bits}), "
        f"K1 launches {launches} (expect {expect})")
    if not diff <= BUNDLE_TOL or launches != expect:
        raise AssertionError(f"bundle {label}: diff {diff:.3e}, K1 launches {launches}")
    return launches


def _dir_mb(path: Path) -> float:
    return sum(f.stat().st_size for f in path.iterdir()) / 2**20


def export_bundles(serve, parity):
    """The phase's bundles and their sizes. Returns {name: directory}."""
    from audioset_convnext_inf_torch.engine.aot_export import save_bundle

    specs = {
        "forward": (serve, dict(batch_sizes=(1, BATCH), kinds=("forward",))),
        "kinds": (serve, dict(batch_sizes=(BATCH,), kinds=("scene", "frame"))),
        "shared": (serve, dict(batch_sizes=(BATCH,), weights="shared")),
        "dynamic": (serve, dict(batch_sizes=("dynamic",))),
        "f32": (parity, dict(batch_sizes=(BATCH,))),
    }
    dirs = {}
    for name, (model, kw) in specs.items():
        path = BUNDLE_DIR / name
        manifest = save_bundle(model, str(path), pcm=True, **kw)
        log(f"  export {name}: {len(manifest['entries'])} program(s) "
            f"{sorted(manifest['entries'])}, {_dir_mb(path):.1f} MiB on disk, kernel library "
            f"{manifest['kernel_library']}")
        dirs[name] = path
    baked = (BUNDLE_DIR / "forward" / f"forward_b{BATCH}.pt2").stat().st_size / 2**20
    shared = (BUNDLE_DIR / "shared" / f"forward_b{BATCH}.pt2").stat().st_size / 2**20
    params = (BUNDLE_DIR / "shared" / "params.npz").stat().st_size / 2**20
    log(f"  bundle size, one program at B={BATCH}: baked {baked:.1f} MiB; shared {shared:.1f} MiB "
        f"+ params.npz {params:.1f} MiB once")
    return dirs


def check_bundles(serve, parity, dirs):
    """Load each bundle and hold it against the live model. Returns (the
    forward bundle, its K1 launches in all)."""
    from audioset_convnext_inf_torch.engine.aot_export import load_bundle

    per = sum(K1_MAIN_PATH.values())
    pcm = fixture_batch(BATCH, SEED + 61)
    bundles = {name: load_bundle(str(path)) for name, path in dirs.items()}
    # the live model and the bundles must run one K1 library, the package's
    # build, with nothing pinned: else the comparisons below hold the
    # bundles against a live model that runs the bundle's library
    from audioset_convnext_inf_torch.ops import _build

    live_lib = _build.library("fused_block").name
    libs = {name: b.manifest["kernel_library"] for name, b in bundles.items()}
    log(f"  K1 library: live model {live_lib}; bundles {libs}; pinned "
        f"{ {k: v.name for k, v in _build._PINNED.items()} }")
    if _build._PINNED or set(libs.values()) - {live_lib, None}:
        raise AssertionError(f"K1 libraries differ: live {live_lib}, bundles {libs}, "
                             f"pinned {_build._PINNED}")
    total = 0
    padded = np.zeros_like(pcm)
    padded[:3] = pcm[:3]
    live = {"B=16": serve.forward(pcm), "padded": serve.forward(padded),
            "B=1": serve.forward(pcm[:1])}
    cases = [
        ("forward B=16", lambda: bundles["forward"](pcm), live["B=16"], per),
        ("forward B=3 (bucket 16) vs live forward of the same 16 rows",
         lambda: bundles["forward"](pcm[:3]), {k: v[:3] for k, v in live["padded"].items()}, per),
        ("forward B=1 (bucket 1)", lambda: bundles["forward"](pcm[:1]), live["B=1"], per),
        ("scene B=16", lambda: bundles["kinds"](pcm, kind="scene"),
         serve.forward_scene_embeddings(pcm), per),
        ("frame B=16", lambda: bundles["kinds"](pcm, kind="frame"),
         serve.forward_frame_embeddings(pcm), per),
        ("shared weights B=16", lambda: bundles["shared"](pcm), live["B=16"], per),
        ("dynamic B=2", lambda: bundles["dynamic"](pcm[:2]), serve.forward(pcm[:2]), per),
        ("dynamic B=5", lambda: bundles["dynamic"](pcm[:5]), serve.forward(pcm[:5]), per),
        ("f32 parity B=16", lambda: bundles["f32"](pcm), parity.forward(pcm), 0),
    ]
    for label, fn, want, expect in cases:
        out, n = _k1_count(fn)
        total += _bundle_check(label, out, want, n, expect)
    live3 = serve.forward(pcm[:3])["clipwise_output"]
    log(f"  (forward B=3 in bucket 16 vs live forward at B=3: max diff "
        f"{(bundles['forward'](pcm[:3])['clipwise_output'] - live3).abs().max().item():.3e}; "
        f"cuBLAS picks its kernels by row count)")
    # what the bundle's precision setting is for: the f32 program with
    # cuDNN's default (TF32 on)
    program = bundles["f32"]._programs[f"forward:{BATCH}"]
    with torch.inference_mode():
        tf32 = program(torch.from_numpy(pcm).to(serve.device))["clipwise_output"]
    log(f"  f32 parity program without fp32_precision('highest') (cuDNN TF32 {'on' if torch.backends.cudnn.allow_tf32 else 'off'}): max diff "
        f"vs live {(tf32 - parity.forward(pcm)['clipwise_output']).abs().max().item():.3e}")
    return bundles["forward"], total


def check_bundle_subprocess(bundle_dir: Path, want: np.ndarray, pcm: np.ndarray):
    """Load the forward bundle in a fresh process that cannot import the
    port's models or checkpoint packages; its B=16 answer must be bit-equal
    to this process's, with 18 K1 launches."""
    npy = BUNDLE_DIR / "pcm.npy"
    np.save(npy, pcm)
    code = (
        "import sys\n"
        "for name in ('audioset_convnext_inf_torch.models', "
        "'audioset_convnext_inf_torch.checkpoint'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "from audioset_convnext_inf_torch.engine.aot_export import load_bundle\n"
        "from audioset_convnext_inf_torch.ops.fused_block import fused_block\n"
        f"b = load_bundle({str(bundle_dir)!r})\n"
        f"out = b(np.load({str(npy)!r}))['clipwise_output'].float().cpu()\n"
        f"np.save({str(BUNDLE_DIR / 'out.npy')!r}, out.numpy())\n"
        "print(fused_block.launches)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"bundle in a process without model code: {proc.stderr[-3000:]}")
    launches = proc.stdout.split()[-1]
    got = np.load(BUNDLE_DIR / "out.npy")
    diff = float(np.abs(got - want).max())
    log(f"  process without model code: K1 launches {launches}, max diff vs this process "
        f"{diff:.3e}")
    if diff != 0.0 or int(launches) != sum(K1_MAIN_PATH.values()):
        raise AssertionError(f"bundle without model code: diff {diff}, launches {launches}")


def run_serve_bundle(bundle, bundle_dir: Path):
    """cli/serve.py --bundle: phase 8's HTTP requests; each answer must
    equal the bundle's own forward of that clip in a batch of 16, and each
    batch must launch K1 18 times. Returns the launches."""
    from audioset_convnext_inf_torch.cli import serve as serve_cli
    from audioset_convnext_inf_torch.engine.aot_export import BundleModel

    pool = fixture_batch(SERVE_POOL, SEED + 21)
    ref = np.concatenate([bundle(pool[i:i + BATCH])["clipwise_output"].cpu().numpy()
                          for i in range(0, SERVE_POOL, BATCH)])
    server, service = serve_cli.make_server(
        ["--port", "0", "--bundle", str(bundle_dir), "--batch-size", "64", "--max-wait-ms", "20"])
    if not isinstance(service.model, BundleModel) or service.batch_size != BATCH:
        raise AssertionError(f"serve --bundle: model {type(service.model).__name__}, batch "
                             f"{service.batch_size} (the largest bucket is {BATCH})")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        def http_tag(i):
            return _check_top(_post(url + "/tag", pool[i].astype("<i2").tobytes(),
                                     "application/pcm-int16"), ref[i], f"/tag clip {i}")

        _zero_counts()
        before = service.counters()
        answers, diff = _send_all(http_tag)
        torch.cuda.synchronize()
        return _check_batches(f"HTTP /tag, serve --bundle (batch-size 64 asked, clamped to "
                              f"{BATCH})", service, before, answers, diff)
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
        thread.join(timeout=30)


def check_frontend(device):
    """ct and rfft on the card against the port's CPU frontend ("highest",
    FRONTEND_DB_TOL)."""
    from audioset_convnext_inf_torch.config import FrontendConfig
    from audioset_convnext_inf_torch.ops.frontend import LogMelFrontend

    clips = torch.from_numpy(fixture_batch(2, SEED)).float() * (1.0 / 32767.0)
    for impl in ("ct", "rfft"):
        cfg = dataclasses.replace(FrontendConfig(), dft_impl=impl)
        with torch.inference_mode():
            got = LogMelFrontend(cfg, device=device)(clips.to(device)).cpu()
            want = LogMelFrontend(cfg)(clips)
        err = (got - want).abs()
        loud = err[want > -40.0].max().item()
        log(f"  frontend {impl} card vs CPU (highest, 2 clips): max {err.max().item():.3e} dB, "
            f"above -40 dB {loud:.3e} dB (tol {FRONTEND_DB_TOL})")
        if not (err.max().item() <= FRONTEND_DB_TOL[0] and loud <= FRONTEND_DB_TOL[1]):
            raise AssertionError(f"frontend {impl} on the card disagrees with the CPU")


def run_bundle_phase(serve, device):
    """Phase 11. Returns the K1 launches of its bundle paths."""
    BUNDLE_DIR.mkdir(parents=True, exist_ok=True)
    parity = build_model(device, torch.float32)
    dirs = export_bundles(serve, parity)
    forward, launches = check_bundles(serve, parity, dirs)
    pcm = fixture_batch(BATCH, SEED + 61)
    out, n = _k1_count(lambda: forward(pcm))
    want = out["clipwise_output"].float().cpu().numpy()
    launches += n
    check_bundle_subprocess(dirs["forward"], want, pcm)
    launches += run_serve_bundle(forward, dirs["forward"])
    check_frontend(device)
    return launches


# ---------------------------------------------------------------------------
# phase 12: the PANN zoo
# ---------------------------------------------------------------------------

PANN_BATCH = 2  # (a), (b): the fixture and one seeded clip, 10 s each
# (b): one model per family, perturbed, the card against the port's CPU
# forward of the same weights
PANN_PARITY = ["Cnn14", "Cnn14Deformable", "Cnn14_DecisionLevelAtt", "Cnn10Next", "ResNet38",
               "MobileNetV1", "MobileNetV2", "LeeNet24", "DaiNet19", "Res1dNet31",
               "Wavegram_Logmel_Cnn14"]
# card vs CPU, probabilities: the f32 parity bound of phase 4
PANN_PROB_TOL = F32_LOGIT_TOL
PANN_TOP_K = 5


def pann_clips(sample_rate: int, batch: int = PANN_BATCH) -> np.ndarray:
    """(batch, 10 s) f32 at ``sample_rate``: the fixture recording, then
    seeded noise at about -20 dBFS."""
    from audioset_convnext_inf_torch.data.audio_io import read_wav

    wav, _ = read_wav(str(FIXTURE), target_sr=sample_rate)
    rng = np.random.RandomState(SEED + sample_rate)
    n = 10 * sample_rate
    rows = [wav[:n]] + [rng.randn(n) * 0.1 for _ in range(batch - 1)]
    return np.stack(rows).astype(np.float32)


@torch.no_grad()
def perturb_pann(model, seed: int):
    """Seeded values for every weight and BN statistic (so no residual
    branch or deformable offset stays at its init zero): weights +0.02
    N(0, 1), biases 0.05 N(0, 1), norm scales 1 + 0.1 N(0, 1), running
    means 0.1 N(0, 1) and variances U(0.5, 2); bn0 over log-mel dB gets a
    mean of -40 + 5 N(0, 1) and a variance in U(100, 400)."""
    g = torch.Generator().manual_seed(seed)
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        db = name.startswith("bn0.") and not hasattr(model, "conv0")
        noise = torch.randn(t.shape, generator=g)
        if leaf == "running_mean":
            v = noise * 5.0 - 40.0 if db else noise * 0.1
        elif leaf == "running_var":
            u = torch.rand(t.shape, generator=g)
            v = u * 300.0 + 100.0 if db else u * 1.5 + 0.5
        elif leaf == "bias":
            v = t.cpu() + noise * 0.05
        elif t.ndim == 1:
            v = 1.0 + noise * 0.1
        else:
            v = t.cpu() + noise * 0.02
        t.copy_(v)
    return model


def _pann_zoo_forwards(device):
    """(a) Every registry model on the card, B=2 10-s clips at its rate:
    finite, shaped, in [0, 1], and no K1 launch."""
    from audioset_convnext_inf_torch.models import PANN_REGISTRY, create_pann_model

    clips = {}
    for name in sorted(PANN_REGISTRY):
        model = create_pann_model(name, seed=SEED, device=device)
        sr = model.cfg.frontend.sample_rate
        x = clips.setdefault(sr, pann_clips(sr))
        out, n = _k1_count(lambda: model.forward(x))
        probs = out["clipwise_output"]
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        ok = (probs.shape == (PANN_BATCH, 527) and bool(torch.isfinite(probs).all())
              and float(probs.min()) >= 0.0 and float(probs.max()) <= 1.0 and n == 0)
        if "framewise_output" in out:
            ok = ok and out["framewise_output"].shape == (
                PANN_BATCH, model.cfg.frontend.num_frames(x.shape[1]), 527)
        log(f"  (a) {name}: {model.count_parameters()} params, {sr} Hz, outputs {shapes}, "
            f"probs [{float(probs.min()):.4f}, {float(probs.max()):.4f}], K1 launches {n}")
        if not ok:
            raise AssertionError(f"PANN {name}: bad outputs or K1 launched ({n})")
        del model, out
    torch.cuda.empty_cache()
    log(f"  (a) all {len(PANN_REGISTRY)} models built and forwarded on the card")


def _pann_card_vs_cpu(device):
    """(b) One model per family, perturbed, on the card against the port's
    CPU forward of the same weights; Cnn14 also with TF32 on."""
    from audioset_convnext_inf_torch.models.pann import PANN_REGISTRY, build_pann_model
    from audioset_convnext_inf_torch.ops.precision import fp32_precision

    for name in PANN_PARITY:
        cfg = PANN_REGISTRY[name]
        card = perturb_pann(build_pann_model(cfg, seed=SEED, device=device), SEED + 3)
        cpu = build_pann_model(cfg, seed=SEED, device="cpu")
        cpu.load_state_dict(card.state_dict())
        x = pann_clips(cfg.frontend.sample_rate)
        offsets = []
        if cfg.deformable_blocks:
            first = getattr(card, f"conv_block{cfg.deformable_blocks[0]}")
            hook = first.conv1.offset_conv.register_forward_hook(
                lambda m, i, o: offsets.append(o.abs().max().item()))
        got, n = _k1_count(lambda: card.forward(x))
        if cfg.deformable_blocks:
            hook.remove()
        want = cpu.forward(x)
        key = "clipwise_logits" if "clipwise_logits" in want else "segmentwise_output"
        prob = (got["clipwise_output"].cpu() - want["clipwise_output"]).abs().max().item()
        other = (got[key].cpu() - want[key]).abs().max().item()
        line = (f"  (b) {name} card vs CPU, B={PANN_BATCH} 10-s clips: probs max diff "
                f"{prob:.3e} (tol {PANN_PROB_TOL}), {key} {other:.3e}, K1 launches {n}")
        if offsets:
            line += f", deformable offsets max |{offsets[0]:.3f}| (non-zero)"
        if name == "Cnn14":
            with torch.inference_mode(), fp32_precision("high"):
                tf32 = card.compute(torch.from_numpy(x).to(device))
            line += (f"; with TF32 on: probs {(tf32['clipwise_output'].cpu() - want['clipwise_output']).abs().max().item():.3e}, "
                     f"logits {(tf32['clipwise_logits'].cpu() - want['clipwise_logits']).abs().max().item():.3e}")
        log(line)
        if not (prob <= PANN_PROB_TOL and n == 0 and (offsets[0] > 0 if offsets else True)):
            raise AssertionError(f"PANN {name}: the card disagrees with the CPU ({prob:.3e})")
        del card, cpu
    torch.cuda.empty_cache()


def _pann_clis():
    """(c) cli/inference.py on the fixture with its default device (the
    card) and a reference-keyed checkpoint written here: both modes' top-k
    equal model.forward's."""
    import contextlib
    import csv
    import io

    from audioset_convnext_inf_torch.checkpoint.pann_convert import load_pann_state_dict
    from audioset_convnext_inf_torch.cli import inference
    from audioset_convnext_inf_torch.data.audio_io import read_wav
    from audioset_convnext_inf_torch.labels import read_audioset_label_tags
    from audioset_convnext_inf_torch.models import create_pann_model

    source = perturb_pann(create_pann_model("Cnn14", seed=SEED, device="cpu"), SEED + 5)
    sd = dict(source.state_dict())
    sd["spectrogram_extractor.stft.conv_real.weight"] = torch.zeros(513, 1, 1024)
    sd["logmel_extractor.melW"] = torch.zeros(513, 64)
    sd["bn0.num_batches_tracked"] = torch.tensor(100)
    ckpt = WORK / "Cnn14_reference_keys.pth"
    torch.save(sd, ckpt)
    lm = read_audioset_label_tags()
    wav, _ = read_wav(str(FIXTURE), target_sr=32000)
    csv_path = WORK / "sed.csv"
    for mode, name in (("audio_tagging", "Cnn14"),
                       ("sound_event_detection", "Cnn14_DecisionLevelMax")):
        argv = [mode, "--audio-path", str(FIXTURE), "--model-type", name, "--checkpoint",
                str(ckpt), "--top-k", str(PANN_TOP_K)]
        if mode == "sound_event_detection":
            argv += ["--out-csv", str(csv_path)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, n = _k1_count(lambda: inference.main(argv))
        lines = buf.getvalue().splitlines()
        model = load_pann_state_dict(create_pann_model(name), torch.load(ckpt, weights_only=True))
        out = model.forward(wav[None, :])
        if mode == "audio_tagging":
            probs = out["clipwise_output"][0].cpu().numpy()
            top = np.argsort(probs)[::-1][:PANN_TOP_K]
            want = [lm.ix_to_lb[int(i)] for i in top]
            got = [ln.rsplit(": ", 1)[0] for ln in lines]
            printed = np.array([float(ln.rsplit(" ", 1)[1]) for ln in lines])
            if np.abs(printed - probs[top]).max() > 1e-3:  # the 3-decimal print
                raise AssertionError(f"cli.inference printed {printed}, forward {probs[top]}")
        else:
            framewise = out["framewise_output"][0].cpu().numpy()
            top = np.argsort(framewise.max(axis=0))[::-1][:PANN_TOP_K]
            want = [lm.ix_to_lb[int(i)] for i in top]
            with open(csv_path) as f:
                got = [row[2] for row in list(csv.reader(f))[1:]]
        log(f"  (c) cli.inference {mode} --model-type {name} (card, reference-keyed "
            f"checkpoint): exit {rc}, K1 launches {n}; top-{PANN_TOP_K}: {got}")
        if rc != 0 or n or got != want:
            raise AssertionError(f"cli.inference {mode}: {got} != model.forward's {want}")
        del model


def run_pann_phase(device):
    """Phase 12. The PANN path launches no kernel of the port: K1 is
    counted on every forward and must stay at 0."""
    _pann_zoo_forwards(device)
    _pann_card_vs_cpu(device)
    _pann_clis()


# ---------------------------------------------------------------------------
# phase 13: PANN transfer learning and AudioCaps fine-tuning
# ---------------------------------------------------------------------------

AC_CLIPS = {"train": 64, "val": 16, "test": 16}  # the synthetic AudioCaps root
AC_CAPTIONS = {"train": 1, "val": 5, "test": 5}
AC_DISTINCT = 8  # clips encoded (about 3 s each); the others are copies under other names
AC_SAMPLES = 320000  # 10 s at 32 kHz; clips 4-7 are shorter (pad-to-longest batches)
TRANSFER_CHECK_BATCH = 4  # (b): card vs CPU
TRANSFER_BATCH = 64  # (c): the CLI's default batch
# card vs CPU, f32 on both (cuDNN's and oneDNN's convs sum in other
# orders): probabilities by phase 12's bound; logits, BN statistics and
# gradients within TRANSFER_REL_TOL of their largest magnitude
TRANSFER_REL_TOL = 1e-4


def _ac_clip(i: int) -> np.ndarray:
    """Distinct clip i as int16-range integers: the fixture, rolled and
    scaled, plus seeded noise; clips 4-7 cut by 2000 * (i - 3) samples."""
    from scipy.io import wavfile

    _, fix = wavfile.read(str(FIXTURE))
    rng = np.random.RandomState(SEED + 100 + i)
    x = np.roll(fix[:AC_SAMPLES].astype(np.float64), 40000 * i) * (0.3 + 0.1 * i)
    x += rng.randn(AC_SAMPLES) * 300
    n = AC_SAMPLES - (2000 * (i - 3) if i >= 4 else 0)
    return np.clip(np.round(x[:n]), -32767, 32767).astype(np.int64)


def _ac_encode(i: int):
    """Clip i and its FLAC stream, by tests/flac_encoder.py."""
    encoder = _load_test_helper("flac_encoder")
    x = _ac_clip(i)
    return x, encoder.encode_flac(x, 32000, kind="fixed", order=2, blocksize=4096)


def make_audiocaps_root(root: Path):
    """<root>/AUDIOCAPS_32000Hz: CSVs of captions and tags, FLAC under
    audio/<subset>/; clip k of a subset is distinct clip k % 8 (val and
    test use the shorter clips 4-7 only). Returns {(subset, k): ints} and
    {(subset, k): tag indexes}."""
    import multiprocessing

    from audioset_convnext_inf_torch.labels import read_audioset_label_tags

    with multiprocessing.get_context("spawn").Pool(AC_DISTINCT) as pool:
        encoded = pool.map(_ac_encode, range(AC_DISTINCT))
    log(f"  (a) {AC_DISTINCT} distinct 10-s clips FLAC-encoded (tests/flac_encoder.py, "
        f"FIXED order 2) in {AC_DISTINCT} processes")
    ids = read_audioset_label_tags().ids
    rng = np.random.RandomState(SEED + 13)
    data = root / "AUDIOCAPS_32000Hz"
    ints, tags = {}, {}
    for subset, n in AC_CLIPS.items():
        (data / "audio" / subset).mkdir(parents=True)
        caps = ["audiocap_id,youtube_id,start_time,caption\n"]
        tag_rows = ["youtube_id,mids\n"]
        for k in range(n):
            src = k % AC_DISTINCT if subset == "train" else 4 + k % 4
            ytid = f"{subset}{k:04d}"
            caps += [f"{k * 10 + c},{ytid},30,clip {k} caption {c}\n"
                     for c in range(AC_CAPTIONS[subset])]
            tags[(subset, k)] = sorted(rng.choice(527, rng.randint(1, 4), replace=False).tolist())
            tag_rows.append(f"{ytid},{';'.join(ids[t] for t in tags[(subset, k)])}\n")
            (data / "audio" / subset / f"{ytid}_30.flac").write_bytes(encoded[src][1])
            ints[(subset, k)] = encoded[src][0]
        (data / f"{subset}.csv").write_text("".join(caps))
        (data / f"{subset}_tags.csv").write_text("".join(tag_rows))
    return ints, tags


def check_audiocaps(root: Path, ints, tags):
    """(a) The port builds its FLAC library here; every clip of every
    subset decodes to its integers / 32768 exactly; AudioCaps and
    BasicCollate give the expected lengths, captions and one-hots."""
    from audioset_convnext_inf_torch.data import flac
    from audioset_convnext_inf_torch.data.audiocaps import AudioCaps, BasicCollate

    lib = flac.build()
    log(f"  (a) FLAC decoder built with the host C++ compiler: {lib.relative_to(ROOT)}")
    collate = BasicCollate(with_tags=True)
    for subset, n in AC_CLIPS.items():
        ds = AudioCaps(root=str(root), subset=subset, with_tags=True)
        if len(ds) != n or len(ds.at(0, "captions")) != AC_CAPTIONS[subset]:
            raise AssertionError(f"AudioCaps {subset}: {len(ds)} clips, not {n}")
        items = []
        for k in range(n):
            audio = ds.at(k, "audio")
            want = ints[(subset, k)].astype(np.float32) * np.float32(1 / 32768)
            if audio.dtype != np.float32 or not np.array_equal(audio, want):
                raise AssertionError(f"AudioCaps {subset} clip {k} does not decode exactly")
            items.append({"audio": audio, "captions": ds.at(k, "captions"),
                          "tags": ds.at(k, "tags")})
        batch = collate(items)
        longest = max(len(ints[(subset, k)]) for k in range(n))
        onehot = np.zeros((n, 527), np.float32)
        for k in range(n):
            onehot[k, tags[(subset, k)]] = 1.0
        if batch["audio"].shape != (n, longest) or not np.array_equal(batch["tags"], onehot):
            raise AssertionError(f"BasicCollate {subset}: {batch['audio'].shape}")
        log(f"  (a) {subset}: {n} clips, {AC_CAPTIONS[subset]} caption(s) each, collated to "
            f"{batch['audio'].shape} with one-hot tags {batch['tags'].shape}: exact")


def _transfer_cfg(**kw):
    import dataclasses

    from audioset_convnext_inf_torch.models.pann import PANN_REGISTRY

    return dataclasses.replace(PANN_REGISTRY["Cnn14"], **kw)


def _rel_err(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def check_transfer_card_vs_cpu(device, clips):
    """(b) forward_train of the published-width Cnn14 (perturbed weights
    and statistics) on the card against the port's CPU forward_train,
    B=4 10-s clips, dropout off, the same SpecAugment draws; then one
    TransferTrainer.step each side (SpecAugment off too), whose head
    gradients and updated head hold the TF32 pin over the whole step."""
    from audioset_convnext_inf_torch.engine.transfer import TransferTrainer
    from audioset_convnext_inf_torch.models.pann import build_pann_model
    from audioset_convnext_inf_torch.ops.specaugment import draw_stripes

    cfg = _transfer_cfg(block_dropout=0.0, head_dropout=0.0)
    card = perturb_pann(build_pann_model(cfg, seed=SEED, device=device), SEED + 7)
    cpu = build_pann_model(cfg, seed=SEED, device="cpu")
    cpu.load_state_dict(card.state_dict())
    x = clips[:TRANSFER_CHECK_BATCH]
    g = torch.Generator().manual_seed(SEED + 8)
    sa = cfg.spec_augment
    draws = [(draw_stripes(g, len(x), sa.time_drop_width, sa.time_stripes_num),
              draw_stripes(g, len(x), sa.freq_drop_width, sa.freq_stripes_num))] + [None] * 8
    _zero_counts()
    got = card.forward_train(x, None, draws=draws)
    torch.cuda.synchronize()
    launches = _counts()
    want = cpu.forward_train(x, None, draws=draws)
    prob = (got["clipwise_output"].detach().cpu() - want["clipwise_output"]).abs().max().item()
    logit = _rel_err(got["clipwise_logits"], want["clipwise_logits"])
    bn = max(_rel_err(got["bn_updates"][p][s], want["bn_updates"][p][s])
             for p in want["bn_updates"] for s in ("mean", "var"))
    same_paths = set(got["bn_updates"]) == set(want["bn_updates"])
    log(f"  (b) forward_train card vs CPU, Cnn14 B={len(x)} 10-s clips, dropout off, the same "
        f"SpecAugment draws: probs max diff {prob:.3e} (tol {PANN_PROB_TOL}), logits "
        f"{logit:.3e} of scale, {len(want['bn_updates'])} bn_updates (mean, var) "
        f"{bn:.3e} of scale (tol {TRANSFER_REL_TOL}); K1/K1 save/K2 launches {launches}")
    if not (prob <= PANN_PROB_TOL and logit <= TRANSFER_REL_TOL and bn <= TRANSFER_REL_TOL
            and same_paths and launches == (0, 0, 0)):
        raise AssertionError("forward_train: the card disagrees with the CPU")
    del got, want
    # one step each side; SpecAugment off, so neither side draws
    cfg = _transfer_cfg(block_dropout=0.0, head_dropout=0.0, use_spec_augment=False)
    for m in (card, cpu):  # the same weights under the config without SpecAugment
        m.cfg = cfg
    grads = {}
    trainers = {"card": TransferTrainer(card), "cpu": TransferTrainer(cpu)}
    rng = np.random.RandomState(SEED + 9)
    tags = (rng.rand(len(x), 527) < 0.01).astype(np.float32)
    tags[:, 0] = 1.0
    for side, tr in trainers.items():
        step = tr.opt.step
        tr.opt.step = lambda gs, side=side, step=step: (grads.__setitem__(side, gs), step(gs))[1]
        _zero_counts()
        loss = tr.step(x, tags)
        grads[side + " loss"] = loss
        if side == "card":
            launches = _counts()
    gerr = max(_rel_err(a, b) for a, b in zip(grads["card"], grads["cpu"]))
    sd_card, sd_cpu = card.state_dict(), cpu.state_dict()
    head = [k for k in sd_cpu if k.split(".")[0] in ("fc1", "fc_audioset")]
    perr = max((sd_card[k].cpu() - sd_cpu[k]).abs().max().item() for k in head)
    moved = sum(int((sd_card[k].cpu() - sd_cpu[k]).abs().gt(1e-6).sum()) for k in head)
    lr = trainers["cpu"].opt.lr
    log(f"  (b) TransferTrainer.step card vs CPU: loss {grads['card loss']:.6f} vs "
        f"{grads['cpu loss']:.6f}; fc1/fc_audioset gradients {gerr:.3e} of scale (tol "
        f"{TRANSFER_REL_TOL}); updated head max diff {perr:.3e} ({moved} of "
        f"{sum(sd_cpu[k].numel() for k in head)} elements over 1e-6: AMSGrad's first step "
        f"is lr * sign(g), so a gradient at rounding level may step the other way, 2 * lr = "
        f"{2 * lr:.0e}); launches {launches}")
    if not (gerr <= TRANSFER_REL_TOL and perr <= 2 * lr + 1e-6 and launches == (0, 0, 0)
            and abs(grads["card loss"] - grads["cpu loss"]) <= 1e-5):
        raise AssertionError("TransferTrainer.step: the card disagrees with the CPU")
    del trainers, card, cpu
    torch.cuda.empty_cache()


def check_transfer_step(device, clips):
    """(c) One TransferTrainer.step at B=64 on 10-s clips already on the
    card, the CLI's recipe (Cnn14 with its dropout and SpecAugment): a
    finite loss, and no K1 or K2 launch."""
    from audioset_convnext_inf_torch.engine.transfer import TransferTrainer
    from audioset_convnext_inf_torch.models.pann import create_pann_model

    model = perturb_pann(create_pann_model("Cnn14", seed=SEED, device=device), SEED + 11)
    trainer = TransferTrainer(model)
    reps = -(-TRANSFER_BATCH // len(clips))
    audio = torch.from_numpy(np.concatenate([clips] * reps)[:TRANSFER_BATCH]).to(device)
    rng = np.random.RandomState(SEED + 12)
    tags = torch.from_numpy((rng.rand(TRANSFER_BATCH, 527) < 0.01).astype(np.float32)).to(device)
    _zero_counts()
    loss = float(trainer.step_on_device(audio, tags))
    launches = _counts()
    log(f"  (c) TransferTrainer.step Cnn14 B={TRANSFER_BATCH} 10-s clips (dropout, SpecAugment, "
        f"train-mode BN, head-only AMSGrad, f32): loss {loss:.5f}; K1/K1 save/K2 launches "
        f"{launches}")
    if launches != (0, 0, 0) or not math.isfinite(loss):
        raise AssertionError(f"transfer step: launches {launches}, loss {loss}")
    del trainer, model, audio
    torch.cuda.empty_cache()


def run_finetune_cli(root: Path):
    """(d) cli/finetune_audiocaps.py --epochs 1 --batch-size 64 over the
    root, on the card (its default), from a reference-keyed Cnn14
    checkpoint written here."""
    from audioset_convnext_inf_torch.checkpoint import (load_checkpoint, load_pann_state_dict,
                                                        pann_state_dict_from_params)
    from audioset_convnext_inf_torch.cli import finetune_audiocaps
    from audioset_convnext_inf_torch.models.pann import create_pann_model

    source = perturb_pann(create_pann_model("Cnn14", seed=SEED, device="cpu"), SEED + 15)
    sd = {k: v.clone() for k, v in source.state_dict().items()}
    ckpt = WORK / "Cnn14_pretrained.pth"
    torch.save({"model": dict(sd, **{"bn0.num_batches_tracked": torch.tensor(5)})}, ckpt)
    out_dir = WORK / "finetune_out"
    _zero_counts()
    rc = finetune_audiocaps.main(["--root", str(root), "--checkpoint", str(ckpt),
                                  "--epochs", "1", "--batch-size", str(TRANSFER_BATCH),
                                  "--out-dir", str(out_dir)])
    torch.cuda.synchronize()
    launches = _counts()
    (name,) = os.listdir(out_dir)
    state = load_checkpoint(str(out_dir / name))
    got = pann_state_dict_from_params(state["params"], "Cnn14")
    base_equal = all(np.array_equal(got[k], v.numpy()) for k, v in sd.items()
                     if k.split(".")[0] not in ("fc1", "fc_audioset")
                     and not k.endswith(("running_mean", "running_var")))
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    moved = sum(not np.array_equal(got[k], sd[k].numpy()) for k in stats)
    head_moved = all(not np.array_equal(got[k], sd[k].numpy())
                     for k in sd if k.split(".")[0] in ("fc1", "fc_audioset"))
    back = load_pann_state_dict(create_pann_model("Cnn14", device="cpu"), got)
    probs = back.forward(np.zeros((1, 32000), np.float32))["clipwise_output"]
    log(f"  (d) cli.finetune_audiocaps --epochs 1 --batch-size {TRANSFER_BATCH} (card, "
        f"reference-keyed checkpoint): exit {rc}, wrote {name}; base weights bit-equal "
        f"{base_equal}, head moved {head_moved}, BN running statistics moved {moved} of "
        f"{len(stats)}; read back by the port, finite {bool(torch.isfinite(probs).all())}; "
        f"K1/K1 save/K2 launches {launches}")
    if not (rc == 0 and base_equal and head_moved and moved == len(stats)
            and launches == (0, 0, 0) and bool(torch.isfinite(probs).all())):
        raise AssertionError("cli.finetune_audiocaps: see the lines above")


def run_transfer_phase(device):
    """Phase 13. The transfer path launches no kernel of the port: K1 and
    K2 are counted over (b)-(d) and must stay at 0."""
    root = WORK / "audiocaps"
    ints, tags = make_audiocaps_root(root)
    check_audiocaps(root, ints, tags)
    clips = np.stack([ints[("train", k)] for k in range(4)]).astype(np.float32) / 32768
    check_transfer_card_vs_cpu(device, clips)
    check_transfer_step(device, clips)
    run_finetune_cli(root)


# ---------------------------------------------------------------------------
# phase 14: the rest of the JAX package: the host audio plane, the Kaldi
# fbank and its evaluation route, the augmentations, profiling, the cache
# ---------------------------------------------------------------------------

# (a) the host library against its numpy/scipy plain versions: PCM16 and
# float WAVs bit for bit; 8/24/32-bit PCM as the JAX package's own
# tests/test_native.py holds its library (24/32-bit within 1e-7); the
# resampler within 1e-6 of scipy's f64 resample_poly.
WAV_TOL = {(8, 1): 0.0, (16, 1): 0.0, (24, 1): 1e-7, (32, 1): 1e-7, (32, 3): 0.0, (64, 3): 0.0}
RESAMPLE_TOL = 1e-6
# (b) kaldi_fbank on the card against the port on the host, log domain: the
# JAX suite's bound between two f32 FFTs (tests/test_kaldi_fbank.py).
FBANK_LOG_TOL = 2e-3
FBANK_CLIPS = 16
# (d) resample_linear's f64 product on the card against the host's.
LINEAR_RESAMPLE_TOL = 1e-6
TINY_PARAMETERS = 28_222_767  # convnext_tiny, the reference's count


def _wav_bytes(data: np.ndarray, sr: int, bits: int, fmt: int = 1) -> bytes:
    """A mono RIFF/WAVE file of int16 ``data`` at ``bits`` (PCM), or of the
    float values ``data`` (fmt 3)."""
    import struct

    if fmt == 3:
        raw = data.astype(np.float32 if bits == 32 else np.float64).tobytes()
    elif bits == 8:
        raw = ((data.astype(np.int32) >> 8) + 128).astype(np.uint8).tobytes()
    elif bits == 16:
        raw = data.astype(np.int16).tobytes()
    elif bits == 24:
        v = data.astype(np.int32) << 8
        raw = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], 1).astype(np.uint8).tobytes()
    else:
        raw = (data.astype(np.int64) << 16).astype(np.int32).tobytes()
    block = bits // 8
    fmt_body = struct.pack("<HHIIHH", fmt, 1, sr, sr * block, block, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
            + b"data" + struct.pack("<I", len(raw)) + raw)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def check_native_plane():
    """(a) The host audio library (utils/native.py over csrc/audio_host.cpp)
    built with the host's compiler, then against its plain versions."""
    from audioset_convnext_inf_torch.data import audio_io
    from audioset_convnext_inf_torch.utils import host_build, native

    lib = host_build.build("audio_host", [native.SOURCE], native.CXX_FLAGS,
                           "the host audio library", WORK / "host_build", native.LINK_FLAGS)
    log(f"  (a) host library built by {host_build.compiler('the host audio library')} "
        f"{' '.join(native.CXX_FLAGS)}, then {' '.join(native.LINK_FLAGS)} ({lib.name}; "
        f"{native._load().omp_thread_count()} OpenMP threads)")
    raw = FIXTURE.read_bytes()
    got, sr = audio_io.read_wav(str(FIXTURE))
    want, _ = native.decode_wav_bytes_reference(raw)
    if sr != 32000 or got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError("the fixture WAV does not decode bit-equal to scipy's reading")
    log(f"  fixture WAV: {got.shape[0]} samples at {sr} Hz, bit-equal to scipy's reading")
    pcm = fixture_batch(1, SEED)[0][:64000]
    for (bits, fmt), tol in WAV_TOL.items():
        data = pcm / 32768.0 if fmt == 3 else pcm
        buf = _wav_bytes(data, 44100, bits, fmt)
        got, _ = native.decode_wav_bytes(buf)
        want, _ = native.decode_wav_bytes_reference(buf)
        err = float(np.abs(got - want).max())
        label = f"{'float' if fmt == 3 else 'PCM'}{bits}"
        log(f"  in-memory {label} WAV: max abs diff from scipy {err:.3e} (tol {tol}), "
            f"bit-equal {np.array_equal(got, want)}")
        if got.shape != want.shape or not err <= tol:
            raise AssertionError(f"{label} WAV decodes {err} away from scipy's reading")
    for sr in (44100, 48000):
        clip = (np.random.RandomState(sr).randn(10 * sr) * 0.2).astype(np.float32)
        g = math.gcd(sr, 32000)
        got = audio_io.resample_poly(clip, sr, 32000)
        want = native.resample_poly_kaiser_reference(clip, 32000 // g, sr // g)
        err = float(np.abs(got - want).max())
        log(f"  resample a 10-s clip {sr}->32000 Hz: {got.shape[0]} samples, max abs diff from "
            f"scipy (f64) {err:.3e} (tol {RESAMPLE_TOL})")
        if got.shape != want.shape or not err <= RESAMPLE_TOL:
            raise AssertionError(f"resampling {sr}->32000 is {err} away from scipy's")


def _load_test_helper(name: str):
    """tests/<name>.py, loaded by its path (a package named ``tests``
    elsewhere on the path would shadow the checkout's, which has no
    __init__.py): a helper the tests share with this script, which imports
    neither JAX nor a package named tests."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "tests" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_decoder_fuzz():
    """(a) About 240 of tests/test_fuzz_decoders.py's mutations, drawn with
    its seeds by tests/torch_fuzz_util.py, against the FLAC and WAV
    libraries this machine's compiler built with the port's flags: each
    decodes to a well-formed array or raises ValueError; the huge claimed
    total and the zero channel and bit counts raise."""
    from itertools import islice

    from audioset_convnext_inf_torch.data.flac import decode_flac_bytes
    from audioset_convnext_inf_torch.utils import native

    fz = _load_test_helper("torch_fuzz_util")
    flac, wav = fz.valid_flac(), fz.valid_wav()
    families = [
        ("FLAC byte flips", decode_flac_bytes, islice(fz.byte_flips(flac, 400, 0), 40)),
        ("FLAC multi-byte", decode_flac_bytes, islice(fz.multi_byte(flac, 150, 1), 30)),
        ("FLAC truncations", decode_flac_bytes, islice(fz.truncations(flac, 7), 0, None, 20)),
        ("FLAC garbage", decode_flac_bytes, (blob for _, blob in fz.flac_garbage(2))),
        ("WAV byte flips", native.decode_wav_bytes, islice(fz.byte_flips(wav, 400, 3), 40)),
        ("WAV truncations", native.decode_wav_bytes, islice(fz.truncations(wav, 13), 0, None, 10)),
        ("WAV geometry", native.decode_wav_bytes, (b for _, b in fz.wav_absurd_geometry(wav))),
    ]
    fz.well_formed(decode_flac_bytes(flac), len(flac))
    fz.well_formed(native.decode_wav_bytes(wav), len(wav))
    counts = []
    for label, decode, streams in families:
        accepted = rejected = 0
        for buf in streams:
            try:
                out = decode(buf)
            except ValueError:
                rejected += 1
                continue
            fz.well_formed(out, len(buf))
            accepted += 1
        counts.append(f"{label} {accepted}/{accepted + rejected}")
    must_raise = [("huge claimed total", decode_flac_bytes, fz.flac_huge_total(flac))] + [
        (label, native.decode_wav_bytes, buf) for label, buf in fz.wav_absurd_geometry(wav)
        if label.startswith("0 ")]
    for label, decode, buf in must_raise:
        try:
            decode(buf)
        except ValueError:
            continue
        raise AssertionError(f"the {label} mutation decoded; it must raise")
    log(f"  (a) decoder fuzzing, accepted / mutations: {', '.join(counts)}; "
        f"{len(must_raise)} that must raise raised; every other mutation decoded well formed or "
        f"raised ValueError")


def check_kaldi_fbank(device):
    """(b) kaldi_fbank of FBANK_CLIPS 10-s clips on the card against the port
    on the host."""
    from audioset_convnext_inf_torch.ops.kaldi_fbank import kaldi_fbank

    wav = torch.from_numpy(fixture_batch(FBANK_CLIPS, SEED + 14).astype(np.float32) / 32767.0)
    host = kaldi_fbank(wav)
    card_out = kaldi_fbank(wav.to(device))
    err = (card_out.cpu() - host).abs().max().item()
    log(f"  (b) kaldi_fbank {tuple(host.shape)}: card vs host max abs diff {err:.3e} (log domain, "
        f"tol {FBANK_LOG_TOL})")
    if tuple(card_out.shape) != (FBANK_CLIPS, 994, 224) or not err <= FBANK_LOG_TOL:
        raise AssertionError(f"kaldi_fbank on the card is {err} from the host's")


class FbankMemoryDataset:
    """AudioSetDataset in its Kaldi-fbank mode over packed int16 clips in
    memory (the card machine has no h5py): each item is the dataset's own
    per-clip transform (``clip_item``: decode, fbank). ``keep_int16`` is
    asked for, as the evaluation CLI asks for it, and the mode turns it off."""

    def __init__(self, pcm, target):
        from audioset_convnext_inf_torch.data import AudioSetDataset

        self.ds = AudioSetDataset(use_kaldi_fbank=True, keep_int16=True)
        self.pcm, self.target = pcm, target

    def __getitem__(self, meta):
        i = meta["index_in_hdf5"]
        return self.ds.clip_item(f"clip{i:04d}", self.pcm[i], self.target[i])


def fbank_loader(pcm, target, n):
    from audioset_convnext_inf_torch.data import DataLoader

    metas = [{"index_in_hdf5": i} for i in range(n)]
    return DataLoader(FbankMemoryDataset(pcm, target),
                      [metas[i:i + EVAL_BATCH] for i in range(0, n, EVAL_BATCH)],
                      num_workers=4, pad_to_batch_size=EVAL_BATCH)


def _k1_shapes(model, spec):
    """The input shapes K1 sees in a forward of the spectrogram images
    ``spec`` (B, T, M): one per stage-3/4 block."""
    from audioset_convnext_inf_torch.models import convnext as F

    shapes = []
    with torch.inference_mode():
        x = F._frontend_and_bn0(model, model._waveform(spec[..., None]), model.cfg,
                                model.frontend, model.compute_dtype)
        F.forward_features(model, x, model.cfg,
                           tap=lambda k, v: shapes.append(tuple(v.shape)) if "fused" in k else None)
    return shapes


def check_fbank_route(serve, device):
    """(c) The Kaldi-fbank evaluation route at full width: int16 clips ->
    AudioSetDataset(use_kaldi_fbank=True)'s per-clip transform on the host ->
    DataLoader -> Evaluator -> ``serve`` (convnext_tiny bf16 serving).
    Returns the route's K1 launches."""
    from audioset_convnext_inf_torch.data import device_prefetch
    from audioset_convnext_inf_torch.engine.evaluator import Evaluator

    pcm, target = eval_data(SEED + 9)  # phase 7's clips
    ev = Evaluator(serve, device=device)
    batches = -(-EVAL_CLIPS // EVAL_BATCH)
    out, n = _k1_count(lambda: ev.infer_probs(fbank_loader(pcm, target, EVAL_CLIPS)))
    _expect_launches(f"(c) Evaluator over {EVAL_CLIPS} clips' Kaldi fbanks, B={EVAL_BATCH} "
                     f"({batches} batches)", n, batches * sum(K1_MAIN_PATH.values()))
    probs = out["clipwise_output"]
    if probs.shape != (EVAL_CLIPS, 527) or not np.isfinite(probs).all():
        raise AssertionError(f"the fbank route returned {probs.shape} probabilities, or non-finite")
    first = next(iter(fbank_loader(pcm, target, EVAL_BATCH)))
    spec = torch.from_numpy(first["fbank"])
    shapes = _k1_shapes(serve, spec)
    want = [(EVAL_BATCH, 62, 14, 384)] * 9 + [(EVAL_BATCH, 31, 7, 768)] * 3
    log(f"  fbank batch {tuple(spec.shape)}; K1 input shapes: {shapes[0]} x "
        f"{shapes.count(shapes[0])}, {shapes[-1]} x {shapes.count(shapes[-1])}")
    if shapes != want:
        raise AssertionError(f"K1 saw {shapes}, expected {want}")
    ref = serve.forward(spec[..., None])["clipwise_output"].cpu().numpy()
    if not np.array_equal(ref, probs[:EVAL_BATCH]):
        raise AssertionError("the Evaluator's first fbank batch differs from model.forward's")
    parity = build_model(device, torch.float32)
    cpu = build_model("cpu", torch.float32)
    few = spec[:4, ..., None]
    f32 = parity.forward(few)
    logit_err = (f32["clipwise_logits"].cpu() - cpu.forward(few)["clipwise_logits"]).abs().max().item()
    prob_err = float(np.abs(probs[:4] - f32["clipwise_output"].cpu().numpy()).max())
    log(f"  f32 parity, 4 fbank clips: card vs CPU logits max abs diff {logit_err:.3e} "
        f"(tol {F32_LOGIT_TOL}); bf16 serving vs f32 probabilities {prob_err:.3e} "
        f"(tol {SERVING_PROB_TOL})")
    if not logit_err <= F32_LOGIT_TOL:
        raise AssertionError("the f32 parity model on fbank images disagrees with the CPU")
    if not prob_err <= SERVING_PROB_TOL:
        raise AssertionError("bf16 serving on fbank images drifts from f32 parity")
    del parity, cpu
    host = []

    def kept():
        for batch in fbank_loader(pcm, target, EVAL_CLIPS):
            host.append(batch)
            yield batch

    moved = 0
    for i, batch in enumerate(device_prefetch(kept(), device)):
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):
                if v.device.type != device.type or not np.array_equal(v.cpu().numpy(), host[i][k]):
                    raise AssertionError(f"device_prefetch batch {i} '{k}' differs from its host batch")
                moved += 1
    log(f"  device_prefetch over the same loader: {len(host)} batches, {moved} tensors on the "
        f"card (pinned copies on a copy stream), each bit-equal to its host array")
    return n


def check_augment_on_card(device):
    """(d) crop/pad/pad_or_truncate at each alignment and the nearest
    resample, bit-equal; resample_linear within LINEAR_RESAMPLE_TOL."""
    from audioset_convnext_inf_torch.ops import augment as A

    x = torch.from_numpy(fixture_batch(4, SEED + 41).astype(np.float32) / 32767.0)
    xd = x.to(device)
    g = torch.Generator().manual_seed(SEED + 42)
    checks = 0
    for align in A.ALIGNS:
        for target in (250000, 400000):
            start = A.draw_crop_start(g, x.shape[-1], target) if align == "random" else None
            left = A.draw_pad_left(g, x.shape[-1], target) if align == "random" else None
            pairs = [(A.crop(xd, target, align, start=start), A.crop(x, target, align, start=start)),
                     (A.pad(xd, target, align, -0.5, left=left), A.pad(x, target, align, -0.5, left=left)),
                     (A.pad_or_truncate(xd, target), A.pad_or_truncate(x, target))]
            for got, want in pairs:
                if got.device != xd.device or not torch.equal(got.cpu(), want):
                    raise AssertionError(f"crop/pad align={align} target={target}: card != CPU")
                checks += 1
    errs = []
    for rate in (0.9, 1.1, 1.5):
        got, want = A.resample(xd, rate, "nearest"), A.resample(x, rate, "nearest")
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"nearest resample at {rate}: card != CPU")
        got = A.resample_linear(xd, rate, quantize_hz=100)
        want = A.resample_linear(x, rate, quantize_hz=100)
        errs.append((got.cpu() - want).abs().max().item())
        if got.shape != want.shape or not errs[-1] <= LINEAR_RESAMPLE_TOL:
            raise AssertionError(f"resample_linear at {rate}: card {errs[-1]} from the CPU")
    log(f"  (d) crop/pad/pad_or_truncate, 4 alignments x 2 lengths: {checks} results bit-equal "
        f"card vs CPU; nearest resample at 0.9/1.1/1.5 bit-equal; resample_linear "
        f"(quantize_hz=100) max abs diff {', '.join(f'{e:.3e}' for e in errs)} "
        f"(tol {LINEAR_RESAMPLE_TOL})")


def check_profiling(serve):
    """(e) count_parameters, count_flops, profile_ops and trace on ``serve``.
    Returns profile_ops' K1 launches."""
    from audioset_convnext_inf_torch.ops.fused_block import fused_block
    from audioset_convnext_inf_torch.utils import profiling as P

    n = P.count_parameters(serve)
    log(f"  (e) count_parameters(convnext_tiny) = {n:,} (expect {TINY_PARAMETERS:,})")
    if n != TINY_PARAMETERS:
        raise AssertionError(f"count_parameters gave {n}")
    one = fixture_batch(1, SEED)
    flops = P.count_flops(serve.forward, one)
    log(f"  count_flops, bf16 forward B=1: {flops['flops'] / 1e9:.3f} GFLOP per clip; by op "
        + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in sorted(flops["flops_by_op"].items())))
    pcm = fixture_batch(BATCH, SEED)
    fused_block.launches = 0
    rows = P.profile_ops(serve.forward, pcm, iters=3)
    launched = fused_block.launches
    k1 = [r for r in rows if "fused_block" in r["name"]]
    log(f"  profile_ops, bf16 forward B={BATCH}, 3 iterations: {len(rows)} rows; K1: "
        + ", ".join(f"{r['name']} x{r['count_per_iter']}" for r in k1))
    if sum(r["count_per_iter"] for r in k1) != sum(K1_MAIN_PATH.values()):
        raise AssertionError(f"profile_ops does not list K1 {sum(K1_MAIN_PATH.values())} times "
                             f"per forward")
    with P.trace(str(WORK / "trace14")) as d:
        serve.forward(pcm)
    path = Path(d) / "trace.json"
    size = path.stat().st_size if path.exists() else 0
    log(f"  trace: {path.relative_to(ROOT)} {size / 1e6:.1f} MB")
    if not size:
        raise AssertionError("utils.profiling.trace wrote no trace")
    return launched


_CACHE_PROBE = """
import json, sys, time
t0 = time.perf_counter()
from audioset_convnext_inf_torch.utils.cache import enable_compilation_cache
assert enable_compilation_cache()
from audioset_convnext_inf_torch.data import flac
from audioset_convnext_inf_torch.ops import _build
from audioset_convnext_inf_torch.utils import native
paths = [_build.library_path("fused_block"), native.library_path(), flac.library_path()]
existed = [p.exists() for p in paths]
t1 = time.perf_counter()
_build.build("fused_block"); native.build(); flac.build()
print(json.dumps({"existed": existed, "build_s": time.perf_counter() - t1,
                  "total_s": time.perf_counter() - t0, "paths": [str(p) for p in paths]}))
"""


def start_cache_probe(cache_dir: Path):
    env = dict(os.environ, AUDIOSET_TPU_COMPILE_CACHE=str(cache_dir))
    env.pop("AUDIOSET_TPU_NO_COMPILE_CACHE", None)
    return subprocess.Popen([sys.executable, "-c", _CACHE_PROBE], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_cache_probe(proc) -> dict:
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the cache probe failed:\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def check_cache(first, cache_dir: Path):
    """(f) A first process (``first``, started by start_cache_probe) built K1
    and the two host libraries into a fresh AUDIOSET_TPU_COMPILE_CACHE; a
    second loads them without building."""
    a = finish_cache_probe(first)
    b = finish_cache_probe(start_cache_probe(cache_dir))
    log(f"  (f) AUDIOSET_TPU_COMPILE_CACHE={cache_dir.relative_to(ROOT)}: first process "
        f"found {a['existed']}, built in {a['build_s']:.2f} s ({a['total_s']:.2f} s in all); "
        f"second found {b['existed']}, {b['build_s']:.3f} s ({b['total_s']:.2f} s in all)")
    inside = all(Path(p).parent.parent == cache_dir for p in a["paths"])
    if any(a["existed"]) or not all(b["existed"]) or a["paths"] != b["paths"] or not inside:
        raise AssertionError("the compilation cache did not build once and load after")


def run_rest_phase(device):
    """Phase 14. Returns the K1 launches of the fbank route and of profile_ops."""
    WORK.mkdir(parents=True, exist_ok=True)
    cache_dir = WORK / "compile_cache"
    shutil.rmtree(cache_dir, ignore_errors=True)
    check_native_plane()
    check_decoder_fuzz()
    check_kaldi_fbank(device)
    serve = build_model(device, torch.bfloat16)  # the phase-4 model
    launches = check_fbank_route(serve, device)
    torch.cuda.empty_cache()
    probe = start_cache_probe(cache_dir)  # nvcc on the host while the card works
    check_augment_on_card(device)
    launches += check_profiling(serve)
    check_cache(probe, cache_dir)
    log("  packing (data/pack.py, cli/pack_dataset.py) is not run: the card machine has no "
        "h5py; tests/test_torch_pack.py holds it against the JAX package on the CPU")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the learning certificates
# ---------------------------------------------------------------------------

# (a)/(b): scripts/train_learn_tpu.py's run. 16 tone classes at
# 130 * 2^(k/2.1) Hz (the last, about 18.3 kHz, aliases to about 13.7 kHz),
# class k at column 7(k+1), 4 ten-second clips each; 400 steps of 32 clips
# (mixup pairs them into a trunk batch of 16), batches from RandomState(42).
LEARN_CLASSES = 16
LEARN_COLUMNS = [7 * (k + 1) for k in range(LEARN_CLASSES)]
LEARN_STEPS = 400
LEARN_BATCH = 32
# Gates of the JAX certificate (train_learn_tpu.py:128): the mean loss of
# the last 10 steps under LEARN_LOSS_RATIO of the first 10's, and train mAP
# over the 16 columns above LEARN_MAP through the bf16 serving forward.
LEARN_LOSS_RATIO = 0.1
LEARN_MAP = 0.9
# (c): scripts/serving_parity_trained_tpu.py's gates (:223) on 256 held-out
# clips (16 a class, seed 123) in batches of 32, each bf16 serving config
# against the f32 parity config; and scripts/eval_e2e_tpu.py's gate on the
# f32 model's held-out mAP. Held-out mAP and top-1 saturate on this task,
# so the largest probability gap is gated too: PARITY_PROB_GAP is about
# twice the larger of the two readings on the H100 (8.1e-3 at frontend
# "default", 3.4e-3 at "high").
PARITY_CLIPS_PER_CLASS = 16
PARITY_BATCH = 32
PARITY_MAP_TOL = 1e-3
PARITY_TOP1 = 0.999
PARITY_PROB_GAP = 1.6e-2
HELDOUT_MAP = 0.9
# (d): scripts/transfer_cert_tpu.py's run: Cnn14 head-only, 300 steps of 32
# one-second clips; its task and five gates are tests/torch_transfer_cert.py's.
TRANSFER_STEPS = 300
TRANSFER_CERT_BATCH = 32


def tone_clips(per_class: int, seed: int):
    """The certificates' tone clips (train_learn_tpu.py:57-74,
    serving_parity_trained_tpu.py:make_tone_clips): (16 * per_class, 320000)
    f32 and one-hot targets at LEARN_COLUMNS."""
    rng = np.random.RandomState(seed)
    freqs = 130.0 * (2.0 ** (np.arange(LEARN_CLASSES) / 2.1))
    t = np.arange(320000) / 32000
    clips, targets = [], []
    for k in range(LEARN_CLASSES):
        for _ in range(per_class):
            wav = (0.5 + 0.3 * rng.rand()) * np.sin(2 * np.pi * freqs[k] * t + rng.rand() * 2 * np.pi)
            clips.append((wav + 0.05 * rng.randn(320000)).astype(np.float32))
            tg = np.zeros(527, np.float32)
            tg[LEARN_COLUMNS[k]] = 1.0
            targets.append(tg)
    return np.stack(clips), np.stack(targets)


def _map(probs, targets, columns):
    """(mAP over ``columns``, their APs) by engine/metrics.py."""
    from audioset_convnext_inf_torch.engine.metrics import evaluate_clipwise

    ap = evaluate_clipwise(probs, targets)["average_precision"][columns]
    return float(np.mean(ap)), ap


def serving_probs(model, clips, batch: int):
    """model.forward over ``clips`` in batches: (probabilities, K1 launches)."""
    def run():
        return np.concatenate([model.forward(clips[i:i + batch])["clipwise_output"].float().cpu()
                               .numpy() for i in range(0, len(clips), batch)])
    return _k1_count(run)


class LearnRun(NamedTuple):
    """One 400-step run of (a) or (b)."""

    losses: np.ndarray
    launches: tuple  # (K1, K1 save, K2) over the run
    unfused: tuple  # the same in the unfused-rounding modes
    state: dict  # the trained weights
    cfg: object


def learn_run(device, fused: bool, clips, targets, label: str) -> LearnRun:
    """(a) or (b): convnext_tiny at full width from the port's own init
    (layer scale 1e-6), the fused bf16 recipe with fused_train_blocks
    ``fused``, LEARN_STEPS Trainer.step calls. Each step must launch K1's
    save mode and K2 18 times on the fused route and neither on the other."""
    from audioset_convnext_inf_torch.config import FrontendConfig
    from audioset_convnext_inf_torch.engine.trainer import TrainConfig, Trainer
    from audioset_convnext_inf_torch.models import convnext_tiny

    model = convnext_tiny(drop_path_rate=0.1, block_impl="xla_approx", fused_train_blocks=fused,
                          frontend=FrontendConfig(precision="high"), seed=SEED, device=device)
    if model.count_parameters() != TINY_PARAMETERS:
        raise AssertionError(f"convnext_tiny has {model.count_parameters()} parameters")
    trainer = Trainer(model, TrainConfig(max_lr=1.5e-3, total_steps=LEARN_STEPS, mixup_alpha=1.0,
                                         weight_decay=0.01, seed=7, bf16_compute=True))
    per_step = K1_TRAIN_STEP if fused else 0
    unf_step = K1_TRAIN_UNFUSED if fused else 0
    order = np.random.RandomState(42)
    losses = []
    _zero_counts()
    for step in range(LEARN_STEPS):
        idx = order.permutation(len(clips))[:LEARN_BATCH]
        before, unf_before = _counts(), _unfused_counts()
        losses.append(trainer.step_async(clips[idx], targets[idx]))
        delta = tuple(a - b for a, b in zip(_counts(), before))
        unf = tuple(a - b for a, b in zip(_unfused_counts(), unf_before))
        if delta != (per_step, per_step, per_step) or unf != (0, *(2 * (unf_step,))):
            raise AssertionError(f"learning step {step} launched (K1, K1 save, K2) {delta}, "
                                 f"expected {per_step} each; in the unfused-rounding modes "
                                 f"{unf}, expected (0, {unf_step}, {unf_step})")
    launches, unfused = _counts(), _unfused_counts()
    check_fused_updates(trainer.optimizer, LEARN_STEPS, label)
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss at steps {np.where(~np.isfinite(losses))[0][:10]}")
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    _zero_counts()
    return LearnRun(losses, launches, unfused, state, model.cfg)


def learn_gates(label, device, run: LearnRun, clips, targets):
    """The JAX certificate's gates on one run: the loss ratio and train mAP
    through the bf16 serving forward (18 K1 launches a forward). Returns
    (mAP, loss ratio, K1 serving launches)."""
    from audioset_convnext_inf_torch.models import ConvNeXt

    losses = run.losses
    serve = ConvNeXt(dataclasses.replace(run.cfg, drop_path_rate=0.0),
                     compute_dtype=torch.bfloat16, device=device)
    serve.load_state_dict(run.state, strict=True)
    probs, n = serving_probs(serve, clips, PARITY_BATCH)
    forwards = -(-len(clips) // PARITY_BATCH)
    _expect_launches(f"{label}: bf16 serving forward over the {len(clips)} training clips "
                     f"({forwards} forwards)", n, forwards * sum(K1_MAIN_PATH.values()))
    m, ap = _map(probs, targets, LEARN_COLUMNS)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    ratio = last / first
    low = int(np.argmin(ap))
    log(f"  {label}: loss mean of the first 10 steps {first:.6f}, of the last 10 {last:.6f}, "
        f"ratio {ratio:.6f} (gate < {LEARN_LOSS_RATIO}); train mAP over the {LEARN_CLASSES} "
        f"columns {m:.6f} (gate > {LEARN_MAP}), lowest AP {ap[low]:.6f} (class {low}, "
        f"{130.0 * 2.0 ** (low / 2.1):.0f} Hz)")
    if not ratio < LEARN_LOSS_RATIO:
        raise AssertionError(f"{label}: the loss fell only to {ratio:.4f} of its start")
    if not m > LEARN_MAP:
        raise AssertionError(f"{label}: train mAP {m:.4f}, per class {np.round(ap, 4).tolist()}")
    return m, ratio, n


def check_serving_parity(device, path: Path):
    """(c) Run (a)'s weights, read from their safetensors file by
    ConvNeXt.from_pretrained into the f32 parity config and the bf16 serving
    config at frontend "default" and "high", over the held-out clips through
    the Evaluator. Returns the K1 launches."""
    from audioset_convnext_inf_torch.config import ConvNeXtConfig, FrontendConfig
    from audioset_convnext_inf_torch.engine.evaluator import Evaluator
    from audioset_convnext_inf_torch.models import ConvNeXt

    clips, targets = tone_clips(PARITY_CLIPS_PER_CLASS, 123)
    loader = [{"waveform": clips[i:i + PARITY_BATCH], "target": targets[i:i + PARITY_BATCH]}
              for i in range(0, len(clips), PARITY_BATCH)]
    configs = [("f32 parity", torch.float32, None),
               ("bf16 serving, frontend default", torch.bfloat16, None),
               ("bf16 serving, frontend high", torch.bfloat16,
                ConvNeXtConfig(drop_path_rate=0.0, frontend=FrontendConfig(precision="high")))]
    results, launches = {}, 0
    for label, dtype, cfg in configs:
        model = ConvNeXt.from_pretrained(str(path), compute_dtype=dtype, cfg=cfg, device=device)
        ev = Evaluator(model, device=device)
        out, n = _k1_count(lambda: ev.infer_probs(loader))
        want = len(loader) * sum(K1_MAIN_PATH.values()) if dtype == torch.bfloat16 else 0
        _expect_launches(f"(c) {label} ({model.cfg.block_impl}, frontend "
                         f"{model.cfg.frontend.precision}), {len(clips)} clips in "
                         f"{len(loader)} batches", n, want)
        launches += n
        if not np.array_equal(out["target"], targets):
            raise AssertionError(f"{label}: the Evaluator returned other targets")
        results[label] = out["clipwise_output"]
        del model, ev
    ref = results["f32 parity"]
    m_ref, _ = _map(ref, targets, LEARN_COLUMNS)
    log(f"  (c) f32 parity: held-out mAP {m_ref:.6f} (gate > {HELDOUT_MAP})")
    if not m_ref > HELDOUT_MAP:
        raise AssertionError(f"held-out mAP of the f32 model {m_ref:.4f}")
    top1_ref = np.argmax(ref, axis=1)
    top6_ref = np.argsort(-ref, axis=1)[:, :6]
    for label, probs in list(results.items())[1:]:
        m, _ = _map(probs, targets, LEARN_COLUMNS)
        top1 = float(np.mean(np.argmax(probs, axis=1) == top1_ref))
        top6 = float(np.mean([len(set(a) & set(b)) / 6.0
                              for a, b in zip(np.argsort(-probs, axis=1)[:, :6], top6_ref)]))
        gap = float(np.abs(probs - ref).max())
        log(f"  (c) {label}: mAP {m:.6f}, |delta| {abs(m - m_ref):.3e} (gate < {PARITY_MAP_TOL}); "
            f"top-1 agreement {top1:.4f} (gate >= {PARITY_TOP1}); top-6 rank agreement "
            f"{top6:.4f}; largest probability gap {gap:.3e} (gate < {PARITY_PROB_GAP})")
        if not abs(m - m_ref) < PARITY_MAP_TOL:
            raise AssertionError(f"{label}: mAP {m:.6f} vs the f32 parity config's {m_ref:.6f}")
        if not top1 >= PARITY_TOP1:
            raise AssertionError(f"{label}: top-1 agreement {top1:.4f}")
        if not gap < PARITY_PROB_GAP:
            raise AssertionError(f"{label}: a probability {gap:.3e} from the f32 config's")
    return launches


def check_transfer_learns(device):
    """(d) Cnn14 at its published widths, registry dropout and SpecAugment,
    head-only TransferTrainer at 1e-3: the transfer certificate's task and
    five gates (tests/torch_transfer_cert.py, loaded by its path), and no
    K1 or K2 launch."""
    from audioset_convnext_inf_torch.engine.transfer import TransferTrainer
    from audioset_convnext_inf_torch.models import create_pann_model

    tc = _load_test_helper("torch_transfer_cert")
    clips, tags = tc.tone_clips(32000)
    model = create_pann_model("Cnn14", seed=0, device=device)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = TransferTrainer(model, learning_rate=1e-3)
    losses = []
    _zero_counts()
    for idx in tc.batches(len(clips), TRANSFER_STEPS, TRANSFER_CERT_BATCH):
        losses.append(trainer.step_on_device(*trainer.to_device(clips[idx], tags[idx])))
    losses = torch.stack(losses).cpu().numpy()
    probs = model.forward(clips)["clipwise_output"].cpu().numpy()
    torch.cuda.synchronize()
    if _counts() != (0, 0, 0):
        raise AssertionError(f"the transfer run launched (K1, K1 save, K2) {_counts()}")
    got = tc.report(model, start, losses, probs, tags)
    log(f"  (d) Cnn14 head-only, {TRANSFER_STEPS} steps of {TRANSFER_CERT_BATCH} 1-s clips: loss "
        f"mean of the first 8 steps {got.first:.6f}, of the last 8 {got.last:.6f}, "
        f"ratio {got.ratio:.6f} (gate < {tc.LOSS_RATIO}); train mAP over the {tc.CLASSES} "
        f"columns {got.map:.6f} (gate > {tc.MIN_MAP}), lowest AP {got.ap.min():.6f}; "
        f"{got.frozen} frozen parameters bit-identical {got.frozen_ok}; BN statistics changed "
        f"{got.moved_stats} of {got.stats}; fc_audioset moved {got.head_moved}; K1/K2 launches 0")
    if got.failures():
        raise AssertionError("transfer certificate: " + "; ".join(got.failures()))


def run_learning_phase(device):
    """Phase 15. Returns the fused run's K1 save-mode and K2 launches, the
    same in the unfused-rounding modes, and the K1 serving launches of the
    evaluations."""
    WORK.mkdir(parents=True, exist_ok=True)
    clips, targets = tone_clips(4, 0)
    labels = {True: "(a) fused", False: "(b) unfused"}
    runs, summary, serving = {}, {}, 0
    for fused, label in labels.items():
        log(f"  {label}: convnext_tiny, fused_train_blocks={fused}, {LEARN_STEPS} steps of "
            f"{LEARN_BATCH} ten-second clips")
        runs[fused] = learn_run(device, fused, clips, targets, label)
        m, ratio, n = learn_gates(label, device, runs[fused], clips, targets)
        serving += n
        summary[label] = (m, ratio)
        torch.cuda.empty_cache()
    gap = np.abs(runs[True].losses - runs[False].losses)
    log(f"  (a) vs (b): train mAP {summary['(a) fused'][0]:.6f} / {summary['(b) unfused'][0]:.6f}, "
        f"loss ratio {summary['(a) fused'][1]:.6f} / {summary['(b) unfused'][1]:.6f}; largest "
        f"per-step loss gap {gap.max():.6f} (step {int(np.argmax(gap))}), mean {gap.mean():.6f}")
    path = WORK / "learned.safetensors"
    from audioset_convnext_inf_torch.checkpoint.io import save_safetensors

    save_safetensors(runs[True].state, str(path))
    launches, unfused = runs[True].launches, runs[True].unfused
    del runs
    torch.cuda.empty_cache()
    serving += check_serving_parity(device, path)
    torch.cuda.empty_cache()
    check_transfer_learns(device)
    shutil.rmtree(WORK)
    return launches[1:], unfused[1:], serving


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _entry(name, source, replaces, launches, results, per_shape, mode, per_call, unfused=None,
           err_cases=None):
    """One kernel's line: the main path's shapes, summed over the launches
    one call of the path makes (``per_call`` per shape); ``unfused_ms`` is
    the unfused bf16 block's time over the same launches (K1: its forward;
    K2: autograd's backward of it; several PyTorch calls, no library_ms);
    max_abs_err over the bf16 checks at ``err_cases`` (default: the shapes
    of ``per_call``); ``bound_by`` is that of the shape with the largest
    share of the bound."""
    totals = {key: sum(per_call[s] * per_shape[s][key] for s in per_call)
              for key in ("ms", "plain_ms", "bound_ms")}
    unfused_ms = sum(per_call[s] * unfused[s] for s in per_call) if unfused else None
    err = max(r["max_abs_err"] for r in results
              if r["case"] in (err_cases or per_call) and r["dtype"] == str(torch.bfloat16))
    log(f"  {name} ({mode}) per call of its path ({per_call}): kernel {totals['ms']:.3f} ms, "
        f"plain {totals['plain_ms']:.3f} ms, bound {totals['bound_ms']:.3f} ms"
        + (f", unfused block {unfused_ms:.3f} ms" if unfused else ""))
    return {"name": name, "mode": mode, "route": "cuda",
            "source": f"audioset_convnext_inf_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": totals["ms"],
            "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
            "bound_by": per_shape[max(per_call, key=lambda k: per_call[k] *
                                      per_shape[k]["bound_ms"])]["bound_by"], "library_ms": None,
            "unfused_ms": unfused_ms, "cases": len(results), "ok": True}


class Tee:
    """A stdout that also writes to a file."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self) -> None:
        for stream in self.streams:
            stream.flush()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # the whole output also goes to a file, for runs whose console keeps
    # only the end of it
    LOG.parent.mkdir(parents=True, exist_ok=True)
    with open(LOG, "w") as f:
        sys.stdout = Tee(sys.__stdout__, f)
        try:
            return run_phases()
        finally:
            sys.stdout = sys.__stdout__


def run_phases() -> int:
    # the training CLI's metric log uses wandb where it imports, and wandb
    # reports to outside hosts; this run stays on the machine (JSONL)
    os.environ["WANDB_MODE"] = "disabled"
    device = torch.device("cuda")
    start = time.perf_counter()

    def phase(text):  # each phase's header with the seconds since the start
        log(f"{text}  [{time.perf_counter() - start:.1f} s into the run]")

    kind = torch.cuda.get_device_name(0)
    card = power_line()
    phase(f"[1/15] device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi:")
    log(card)

    phase("[2/15] build")
    build_kernels(["fused_block", "fused_block_bwd", "adamw"])

    phase("[3/15] kernels against their plain versions")
    k1_results = check_k1(device) + check_k1_unfused(device)
    k1s_results = check_k1_save(device)
    k2_results = check_k2(device)
    k1u_results, k2u_results = check_train_unfused(device)
    check_adamw(device)

    phase("[4/15] serving path: convnext_tiny, B=16 x 10-s clips")
    serve, launches = run_main_path(device)
    check_row_independence(serve)

    phase(f"[5/15] training path: convnext_tiny, {TRAIN_CLIPS} x 10-s clips per step, "
        f"{TRAIN_STEPS} steps")
    train_launches, train_unf = run_training_path(device)
    check_fused_vs_unfused(device)

    phase(f"[6/15] kernel table: each kernel alone on {card}")
    per_shape = time_k1(device)
    save_shape = time_k1_save(device)
    profile_k1(device)
    k2_shape = time_k2(device)
    unfused, unfused_bwd = time_unfused(device)
    products = time_products(device)
    compare_yardsticks(per_shape, save_shape, k2_shape, unfused, unfused_bwd, products)
    save_unf, k2_unf, train_fwd, train_bwd = time_train_unfused(device)
    time_adamw(device)

    phase("[7/15] inference surfaces: convnext_tiny bf16 serving (the phase-4 model)")
    WORK.mkdir(parents=True, exist_ok=True)
    surface_launches = check_checkpoint_round_trip(serve, device, fixture_batch(BATCH, SEED))
    pcm, target = eval_data(SEED + 9)
    log("  Evaluator route: in-memory dataset with AudioSetDataset's contract (no h5py here; "
        "the HDF5 route, EvaluateSampler + AudioSetDataset, cli.evaluate and "
        "cli.extract_embeddings are held against the JAX package by tests/test_torch_eval.py "
        "and tests/test_torch_infer.py on the CPU)")
    surface_launches += check_evaluator(serve, device, pcm, target) + check_tagging(serve) \
        + run_clis()
    log(f"  inference surfaces: K1 launches {surface_launches} in all")

    phase(f"[8/15] tagging service: cli/serve.py on the phase-4 model, batch {BATCH}")
    service_launches = run_service(serve)
    torch.cuda.empty_cache()

    phase("[9/15] training CLI loop: convnext_tiny, fused bf16 recipe, in-memory data")
    runner = CliRunner()
    cli_launches, cli_unf, three = run_train_cli(runner)

    phase("[10/15] data parallelism on the one card")
    torch.cuda.empty_cache()
    log("  (a) cli/train.py under torchrun's environment, world size 1, NCCL")
    nccl_launches, nccl_unf = run_nccl_world_1(runner, three)
    del three
    log(f"  (b) {DP_WORLD} processes, backend gloo, one Trainer step of {TRAIN_CLIPS} clips")
    torch.cuda.empty_cache()
    pair_launches = run_dp_pair(device)
    log("  (c) the Evaluator over two replicas on the one card")
    sharded_eval_launches = check_sharded_evaluator(serve, device, pcm, target)
    log("  (d) cli/serve.py --mesh")
    mesh_launches = run_service_mesh(serve)

    phase("[11/15] AOT serving bundles: convnext_tiny bf16 serving, int16 in; the frontend's "
          "ct and rfft on the card")
    bundle_launches = run_bundle_phase(serve, device)
    del serve
    torch.cuda.empty_cache()

    phase("[12/15] PANN zoo: 49 models, f32 under fp32_precision(\"highest\"), 10-s clips")
    run_pann_phase(device)

    phase("[13/15] PANN transfer: AudioCaps FLAC root, forward_train, TransferTrainer, "
          "cli/finetune_audiocaps.py; Cnn14 f32, 10-s clips")
    run_transfer_phase(device)

    phase("[14/15] the rest: host audio library, Kaldi fbank and its evaluation route, "
          "augmentations, profiling, compilation cache")
    rest_launches = run_rest_phase(device)
    shutil.rmtree(WORK)

    phase(f"[15/15] learning certificates: convnext_tiny fused and unfused bf16 recipe, "
          f"{LEARN_STEPS} steps; serving parity with the trained weights; Cnn14 transfer")
    learn_launches, learn_unf, learn_serving = run_learning_phase(device)
    phase("done")

    # K1 save-mode and K2 launches of the training phases (5, 9, 10(a-b),
    # 15(a)): all of them, and those at stages 1-2 in the unfused-rounding
    # modes; each kernel-table row counts its own mode's
    n_save, n_bwd = (train_launches[i] + cli_launches[i] + nccl_launches[i]
                     + pair_launches[i - 1] + learn_launches[i - 1] for i in (1, 2))
    n_save_unf, n_bwd_unf = (train_unf[i] + cli_unf[i] + nccl_unf[i] + pair_launches[i + 1]
                             + learn_unf[i - 1] for i in (1, 2))
    log(f"  training phases: K1 save {n_save} launches ({n_save_unf} in the unfused-rounding "
        f"mode), K2 {n_bwd} ({n_bwd_unf})")

    kernels = [
        _entry("fused_block", "fused_block.cu", "audioset_convnext_inf_tpu/ops/pallas_fused_block.py:53",
               launches + surface_launches + service_launches + cli_launches[0]
               + sharded_eval_launches + mesh_launches + bundle_launches + rest_launches
               + learn_serving,
               k1_results, per_shape,
               "serving forward (phases 4, 7, 8, 10(c-d), 11's bundles, 14's Kaldi-fbank route "
               "and profile, 15's evaluations, and phase 9's evaluations in f32)",
               K1_MAIN_PATH, unfused, err_cases=K1_SERVING_CASES),
        _entry("fused_block_save", "fused_block.cu",
               "audioset_convnext_inf_tpu/ops/pallas_fused_block.py:53 (save_d=True)",
               n_save - n_save_unf, k1s_results, save_shape,
               "training forward, stages 3-4 (save mode; phases 5, 9, 10(a-b), 15(a))",
               K1_STAGES_34, unfused),
        _entry("fused_block_bwd", "fused_block_bwd.cu",
               "audioset_convnext_inf_tpu/ops/pallas_fused_block_bwd.py:66",
               n_bwd - n_bwd_unf, k2_results, k2_shape,
               "training backward, stages 3-4 (phases 5, 9, 10(a-b), 15(a))",
               K1_STAGES_34, unfused_bwd),
        _entry("fused_block_save", "fused_block.cu",
               "audioset_convnext_inf_tpu/ops/pallas_fused_block.py:53 (save_d=True), at "
               "_block_apply's rounding points",
               n_save_unf, k1u_results, save_unf,
               "training forward, unfused rounding, stages 1-2 (save mode; phases 5, 9, "
               "10(a-b), 15(a))", TRAIN_UNFUSED_PATH, train_fwd),
        _entry("fused_block_bwd", "fused_block_bwd.cu",
               "audioset_convnext_inf_tpu/ops/pallas_fused_block_bwd.py:66, at _block_apply's "
               "rounding points",
               n_bwd_unf, k2u_results, k2_unf,
               "training backward, unfused rounding, stages 1-2 (phases 5, 9, 10(a-b), "
               "15(a))", TRAIN_UNFUSED_PATH, train_bwd),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
