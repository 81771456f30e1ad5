#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with a CUDA card, nvcc and
nvidia-smi. It needs no network and no JAX. Phases, each of which fails the
run (non-zero exit) on any error or mismatch:

 1. device: the card's name and power limit;
 2. build: every CUDA kernel of the two paths below, from the sources in
    the checkout, with nvcc for sm_90a, one nvcc per source, in parallel;
    per instantiation, registers, static shared memory and spills (nvcc
    -Xptxas -v) and the count of HMMA (tensor-core) instructions in the
    library's SASS (cuobjdump -sass). Fails if a bf16 tensor-core
    instantiation has no HMMA, or one the main path launches spills;
 3. kernels: each kernel against its plain PyTorch version on the card,
    in f32 and bf16, at the paths' shapes and at the widths the factories
    use, with the tolerances stated in KERNEL_TOL: the fused block (K1) in
    its serving mode and its training ("save") mode, and the fused block
    backward (K2), which must also give bit-equal results twice;
 4. serving path: convnext_tiny at full width on B=16 ten-second clips (the
    fixture recording as int16 plus seeded variants), random weights from
    a seed with seeded gamma/bn0 values. The bf16 serving config runs
    forward, forward_scene_embeddings and forward_frame_embeddings, and each
    call must launch the fused block kernel exactly once per stage-3/4 block;
    the f32 parity config launches it never and matches the port's own f32
    forward on the CPU; bf16 serving probabilities stay near f32 parity;
 5. training path: convnext_tiny at full width in the JAX package's fused
    training recipe (tanh GELU, fused_train_blocks, drop path 0.1, bf16
    compute, mixup 1.0, SpecAugment, AdamW with OneCycle), TRAIN_STEPS
    Trainer.step calls on 32 fixture-derived clips (mixup pairs them into
    B=16). Each step must launch K1 in save mode and K2 exactly once per
    stage-3/4 block, with a finite loss; the trained model's eval forward
    launches K1 12 times in serving mode; one step's gradients with the
    fused blocks against the unfused ones (drop path off), bf16 and f32;
 6. times (CUDA events after warm-up): each kernel and its plain version at
    the checked shapes beside the least time the card could take; the
    unfused bf16 block (unfused_ms) at the main path's shapes;
    end-to-end clips/s of the bf16 serving forward at B=16 and B=64 and of
    the training step; one torch.profiler trace of the serving forward and
    one of a training step (device time by kernel, idle share);
 7. inference surfaces, on the phase-4 serving model: a safetensors file
    and a native checkpoint directory written by the port load through
    ConvNeXt.from_pretrained with bit-equal outputs; the Evaluator over
    EVAL_CLIPS seeded int16 clips at B=EVAL_BATCH through the port's
    DataLoader over an in-memory dataset with AudioSetDataset's contract
    (the card machine has no h5py; the HDF5 route is held against the JAX
    package by the CPU tests), bit-equal to model.forward on the same
    padded batches, with finite mAP/AUC/d-prime; tag_clip, tag_long_audio
    and embed_long_audio on the fixture; each step must launch K1 12 times
    per forward (phase 3 holds K1 against its plain version at each of
    these batch sizes); the CLIs on their default device: convert and the
    demo; then the Evaluator's clips/s (median of three runs) beside
    model.forward's at the same batch, and one trace of two Evaluator
    batches.

The line before the last is one JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
WORK = ROOT / "build" / "chip_smoke"  # files phase 7 writes (the checkout's build/)

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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

# (name, B, H, W, C, gamma): the main path's two shapes first (tiny,
# 10-s clips, B=16), then the batches the inference surfaces of phase 7
# give K1 (the Evaluator, long audio, one clip), then widths of other
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
    ("atto stage 3", BATCH, 63, 14, 160, True),
    ("base stage 4", BATCH, 31, 7, 1024, True),
    ("odd width", 4, 13, 14, 100, True),
    ("no gamma", BATCH, 31, 7, 768, False),
]
K1_MAIN_PATH = {"tiny stage 3": 9, "tiny stage 4": 3}  # launches per forward
# every K1 shape the serving paths (phases 4 and 7) launch
K1_SERVING_CASES = set(K1_MAIN_PATH) | {f"{p} stage {s}" for p in ("eval", "long", "clip")
                                       for s in (3, 4)}
# The training path's block shapes (K1 save mode and K2), then atto stage 3
# and an odd width (K2 only).
K2_CASES = [
    ("tiny stage 3", BATCH, 63, 14, 384),
    ("tiny stage 4", BATCH, 31, 7, 768),
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


def hmma_counts(lib: Path):
    """{mangled kernel: number of HMMA instructions} from cuobjdump -sass."""
    out = subprocess.run([_toolkit("cuobjdump"), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and "HMMA" in ln:
            counts[cur] += 1
    return counts


def kernel_name(demangled: str) -> str:
    """'void <unnamed>::k<(int)64, (bool)0>(...)' -> 'k<64, 0>'."""
    s = re.sub(r"\((?:int|bool|unsigned int)\)", "", demangled)
    s = s.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    s = s.replace("true", "1").replace("false", "0")
    return re.sub(r"^void ", "", s).split("(")[0]


def main_path_kernels():
    """Names (as kernel_name gives them) of the bf16 tensor-core
    instantiations the two paths launch at the main-path widths (C = 384
    and 768, B = 16)."""
    from audioset_convnext_inf_torch.ops import fused_block as FB, fused_block_bwd as FBB

    names = {"wgrad_mma_kernel"}
    for name, b, h, w, c, _ in K1_CASES:
        if name in K1_MAIN_PATH:
            p = FB.launch_plan(c, torch.bfloat16, b * h * w)
            q = FBB.launch_plan(c, torch.bfloat16, b * h * w)
            ncls = FB.width_class(p.cp)
            names |= {f"fused_block_mma_kernel<{p.mt}, {ncls}, {mode}>" for mode in (0, 1)}
            names.add(f"chain_mma_kernel<{q.mt}, {ncls}>")
    return names


TC_KERNELS = ("fused_block_mma_kernel", "chain_mma_kernel", "wgrad_mma_kernel")


def log_main_path_plans():
    """The launch plans at the main-path shapes: pixels per block, blocks
    and the dynamic shared memory each block takes (ptxas reports only the
    static part)."""
    from audioset_convnext_inf_torch.ops import fused_block as FB, fused_block_bwd as FBB

    for name, b, h, w, c, _ in K1_CASES:
        if name in K1_MAIN_PATH:
            p = FB.launch_plan(c, torch.bfloat16, b * h * w)
            q = FBB.launch_plan(c, torch.bfloat16, b * h * w)
            log(f"  plan {name} (C={c}, {b * h * w} pixels): K1 {p.mt} px/block, {p.ctas} blocks, "
                f"{p.smem_bytes} B dynamic smem, {p.acc_regs} accumulator registers; K2 chain "
                f"{q.mt} px/block, {q.chain_ctas} blocks, {q.chain_smem} B; products {q.split} "
                f"pixel ranges, {q.wgrad_ctas} blocks, {q.wgrad_smem} B")


def build_kernels(names):
    """Build every kernel library in parallel; print each instantiation's
    registers, static shared memory, spills and HMMA count. Fails if a bf16
    tensor-core instantiation has no HMMA, or one the main path launches
    spills or is missing."""
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
        hmma = hmma_counts(path)
        pretty = _demangle(sorted(set(rep) | set(hmma)))
        for mangled in sorted(pretty, key=lambda m: kernel_name(pretty[m])):
            kname = kernel_name(pretty[mangled])
            seen.add(kname)
            r = rep.get(mangled, {})
            n_hmma = hmma.get(mangled, 0)
            log(f"  {name}: {kname}: {r.get('regs')} registers, {r.get('smem', 0)} B static smem, "
                f"{r.get('spill', 0)} B spilled, {n_hmma} HMMA{' (main path)' if kname in main else ''}")
            if kname.startswith(TC_KERNELS) and n_hmma == 0:
                bad.append(f"{kname} has no HMMA instruction")
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
            torch.cuda.synchronize()
            ref = fused_block_reference(x, *args)
            err = (got.float() - ref.float()).abs()
            scale = max(1.0, ref.float().abs().max().item())
            max_abs = err.max().item()
            ok = bool(torch.isfinite(got.float()).all().item()) and max_abs <= KERNEL_TOL[dtype] * scale
            bit_equal = (err == 0).float().mean().item()
            log(f"  K1 {name:13s} {str(dtype):15s} B={b} H={h} W={w} C={c}: max_abs_err={max_abs:.3e} "
                f"rel={max_abs / scale:.3e} bit_equal={bit_equal:.4f} tol={KERNEL_TOL[dtype] * scale:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fused_block kernel disagrees with its plain version: {name} {dtype}")
            results.append({"case": name, "dtype": str(dtype), "max_abs_err": max_abs})
    return results


def time_k1(device):
    """Kernel and plain version in bf16 at every checked shape; the main
    path's two shapes make the per-forward totals."""
    from audioset_convnext_inf_torch.ops.fused_block import fused_block, fused_block_reference

    per_shape = {}
    for name, b, h, w, c, with_gamma in K1_CASES:
        dtype = torch.bfloat16
        x, args = k1_inputs(b, h, w, c, with_gamma, dtype, device, SEED)
        launches = fused_block.launches
        ms = cuda_ms(lambda: fused_block(x, *args), iters=20)
        plain_ms = cuda_ms(lambda: fused_block_reference(x, *args), iters=20)
        fused_block.launches = launches  # timing launches are not the main path's
        flops, nbytes = k1_work(b, h, w, c, dtype)
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        per_shape[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                               bound_by="operations" if t_ops >= t_bytes else "bytes",
                               gflop=flops / 1e9, mbytes=nbytes / 1e6)
        log(f"  K1 {name:13s} bf16 B={b} H={h} W={w} C={c}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
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
    """K1's save mode at the training path's shapes: y (scaled branch) and d."""
    from audioset_convnext_inf_torch.ops.fused_block import fused_block, fused_block_reference

    results = []
    for name, b, h, w, c, _ in K1_CASES:
        if name not in K1_MAIN_PATH:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            x, args = k1_inputs(b, h, w, c, True, dtype, device, SEED)
            s = drop_scales(b, device, SEED)
            y, d = fused_block(x, *args, 1e-6, s=s, save_dwconv=True)
            torch.cuda.synchronize()
            y_ref, d_ref = fused_block_reference(x, *args, 1e-6, s, True)
            errs = {}
            for key, got, ref in (("y", y, y_ref), ("d", d, d_ref)):
                scale = max(1.0, ref.float().abs().max().item())
                err = (got.float() - ref.float()).abs().max().item()
                if not (bool(torch.isfinite(got.float()).all()) and err <= KERNEL_TOL[dtype] * scale):
                    raise AssertionError(f"fused_block save mode disagrees ({key}): {name} {dtype}")
                errs[key] = err
            log(f"  K1 save {name:13s} {str(dtype):15s} B={b} H={h} W={w} C={c}: max_abs_err "
                f"y={errs['y']:.3e} d={errs['d']:.3e} (tol {KERNEL_TOL[dtype]} of scale) ok")
            results.append({"case": name, "dtype": str(dtype), "max_abs_err": max(errs.values())})
    return results


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
    """Kernel and plain version by CUDA events; launches made here are put
    back off the count."""
    before = counter.launches
    ms = cuda_ms(fn, iters=20)
    plain_ms = cuda_ms(plain, iters=10)
    counter.launches = before
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), kernel at "
        f"{flops / ms / 1e9:.1f} TFLOP/s")
    return row


def time_k1_save(device):
    from audioset_convnext_inf_torch.ops.fused_block import fused_block, fused_block_reference

    per_shape = {}
    for name, b, h, w, c, _ in K1_CASES:
        if name not in K1_MAIN_PATH:
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


def time_k2(device):
    from audioset_convnext_inf_torch.ops.fused_block_bwd import (
        CUDA_LAUNCHES, fused_block_bwd, fused_block_bwd_reference)

    per_shape = {}
    for name, b, h, w, c in K2_CASES:
        dtype = torch.bfloat16
        x, d, dy, wts, s = k2_inputs(b, h, w, c, dtype, device, SEED)
        per_shape[name] = time_kernel(
            f"K2 {name:13s} bf16 B={b} H={h} W={w} C={c} ({CUDA_LAUNCHES} CUDA launches per call)",
            lambda: fused_block_bwd(x, d, dy, *wts, s),
            lambda: fused_block_bwd_reference(x, d, dy, *wts, s),
            fused_block_bwd, *k2_work(b, h, w, c, dtype), dtype)
        if name in K1_MAIN_PATH:  # where one call's time goes, launch by launch
            before = fused_block_bwd.launches
            profile_run(lambda: fused_block_bwd(x, d, dy, *wts, s), f"K2 {name}", top=CUDA_LAUNCHES)
            fused_block_bwd.launches = before
    return per_shape


def unfused_block(c, args, device):
    """The port's plain block (models/convnext.py Block) holding K1's
    weights: what the serving path runs for stages 1-2."""
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
    main path's shapes: the yardstick for which stages K1 should take."""
    from audioset_convnext_inf_torch.models.convnext import _block_apply

    per_shape = {}
    for name, b, h, w, c, _ in K1_CASES:
        if name not in K1_MAIN_PATH:
            continue
        x, args = k1_inputs(b, h, w, c, True, torch.bfloat16, device, SEED)
        blk = unfused_block(c, args, device)
        with torch.no_grad():
            per_shape[name] = cuda_ms(lambda: _block_apply(x, blk, "xla_approx"), iters=20)
        log(f"  unfused bf16 block {name:13s} B={b} H={h} W={w} C={c}: {per_shape[name]:.4f} ms")
    return per_shape


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
    calls = [("forward", serve.forward), ("forward_scene_embeddings", serve.forward_scene_embeddings),
             ("forward_frame_embeddings", serve.forward_frame_embeddings)]
    outs, launches = {}, 0
    for name, fn in calls:
        fused_block.launches = 0
        outs[name] = fn(pcm)
        torch.cuda.synchronize()
        n = fused_block.launches
        log(f"  bf16 serving {name}: fused_block launches {n} (expect {expect})")
        if n != expect:
            raise AssertionError(f"{name}: fused_block launched {n} times, expected {expect}")
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
    if fused_block.launches != 0:
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


def time_end_to_end(model, label: str):
    for batch in (16, 64):
        pcm = fixture_batch(batch, SEED + batch)
        for _ in range(2):
            model.forward(pcm)
        torch.cuda.synchronize()
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            model.forward(pcm)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        log(f"  e2e {label} forward B={batch} (host int16 in, sync out): {dt * 1e3:.2f} ms/batch, "
            f"{batch / dt:.1f} clips/s")


def profile_run(fn, label: str, top: int = 10):
    """One traced call of fn (after one untraced): device time by kernel
    name, and the device's idle share of the traced wall time (union of
    kernel and copy intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log(f"  profile {label}: the profiler saw no device events; kernel breakdown not measured")
        return
    by_name = {}
    for e in dev:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    total = sum(t for t, _ in by_name.values())
    log(f"  profile {label}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}, kernel time {total / 1e3:.2f} ms")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"    {t / 1e3:9.3f} ms {100 * t / total:5.1f}% x{n:<4d} {name[:90]}")


def profile_forward(model, batch: int, top: int = 10):
    pcm = fixture_batch(batch, SEED + batch)
    profile_run(lambda: model.forward(pcm), f"bf16 forward B={batch}", top)


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


def build_train_model(device, fused: bool = True, drop_path_rate: float = 0.1):
    """convnext_tiny in the JAX package's fused training recipe
    (cli/train.py with --bf16 --block-impl xla_approx --fused-train-blocks):
    tanh GELU, layer scale 1e-6 then seeded gamma, frontend precision "high"."""
    from audioset_convnext_inf_torch.config import FrontendConfig
    from audioset_convnext_inf_torch.models import convnext_tiny

    model = convnext_tiny(drop_path_rate=drop_path_rate, block_impl="xla_approx",
                          fused_train_blocks=fused, frontend=FrontendConfig(precision="high"),
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


def run_training_path(device):
    """TRAIN_STEPS Trainer.step calls; each must launch K1 (save mode) and K2
    once per stage-3/4 block. Returns (trainer, batch, launches over the run)."""
    from audioset_convnext_inf_torch.engine.trainer import Trainer

    model = build_train_model(device)
    trainer = Trainer(model, train_config())
    pcm, target = train_batch(TRAIN_CLIPS, SEED)
    per_step = sum(K1_MAIN_PATH.values())
    _zero_counts()
    for i in range(TRAIN_STEPS):
        before = _counts()
        loss = trainer.step(pcm, target)
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(_counts(), before))
        log(f"  train step {i}: loss {loss:.6f}; launches K1 {delta[0]} (save mode {delta[1]}), "
            f"K2 {delta[2]} (expect {per_step} each)")
        if not math.isfinite(loss):
            raise AssertionError(f"training step {i}: loss is not finite")
        if delta != (per_step, per_step, per_step):
            raise AssertionError(f"training step {i} launched {delta}, expected {per_step} each")
    launches = _counts()
    _zero_counts()
    out = model.forward(pcm[:BATCH])
    torch.cuda.synchronize()
    log(f"  trained model, eval forward B={BATCH}: launches (K1, K1 save, K2) {_counts()} "
        f"(expect ({per_step}, 0, 0))")
    if _counts() != (per_step, 0, 0):
        raise AssertionError(f"eval forward after training launched {_counts()}")
    if not bool(torch.isfinite(out["clipwise_output"]).all()):
        raise AssertionError("eval forward after training is not finite")
    return trainer, (pcm, target), launches


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


def time_training(trainer, batch, steps: int = 5):
    """ms per training step (host batch in, synchronised) and clips/s."""
    pcm, target = batch
    trainer.step(pcm, target)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.step_async(pcm, target)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    log(f"  train step bf16, {TRAIN_CLIPS} clips in, B={TRAIN_CLIPS // 2} trunk: {dt * 1e3:.2f} ms/step, "
        f"{TRAIN_CLIPS // 2 / dt:.1f} trunk clips/s ({TRAIN_CLIPS / dt:.1f} input clips/s); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_run(lambda: trainer.step(pcm, target), f"bf16 train step ({TRAIN_CLIPS} clips)", top=14)


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
    model.forward on the same padded batches, finite metrics. Returns the
    Evaluator and its launches (the reference forwards' are not counted)."""
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
    return ev, n


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


def time_evaluator(serve, ev, pcm, target, card):
    """Evaluator clips/s over EVAL_CLIPS clips, loader included (the median
    of three runs), beside model.forward at the same batch; one trace of two
    Evaluator batches."""
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        ev.infer_probs(eval_loader(pcm, target, EVAL_CLIPS))  # returns after its last copy's event
        runs.append(time.perf_counter() - t0)
    dt = sorted(runs)[1]
    slots = -(-EVAL_CLIPS // EVAL_BATCH) * EVAL_BATCH
    x = fixture_batch(EVAL_BATCH, SEED + 5)
    serve.forward(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        serve.forward(x)
    torch.cuda.synchronize()
    fwd = (time.perf_counter() - t0) / 5
    log(f"  Evaluator, {EVAL_CLIPS} clips at B={EVAL_BATCH}, loader included: "
        f"{', '.join(f'{r * 1e3:.1f}' for r in runs)} ms (median {dt * 1e3:.1f}): "
        f"{EVAL_CLIPS / dt:.1f} clips/s ({slots / dt:.1f} padded slots/s); "
        f"model.forward B={EVAL_BATCH}: {fwd * 1e3:.2f} ms/batch, {EVAL_BATCH / fwd:.1f} clips/s "
        f"[{card}]")
    profile_run(lambda: ev.infer_probs(eval_loader(pcm, target, 2 * EVAL_BATCH)),
                f"Evaluator, 2 batches of {EVAL_BATCH}", top=8)


def _entry(name, source, replaces, launches, results, per_shape, mode, per_call, unfused=None,
           err_cases=None):
    """One kernel's line: the main path's shapes, summed over the launches
    one call of the path makes (``per_call`` per shape); ``unfused_ms`` is
    the unfused bf16 block's time over the same launches (several PyTorch
    calls, no library_ms); max_abs_err over the bf16 checks at
    ``err_cases`` (default: the shapes of ``per_call``)."""
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
            "bound_by": per_shape["tiny stage 3"]["bound_by"], "library_ms": None,
            "unfused_ms": unfused_ms, "cases": len(results), "ok": True}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = power_line()
    log(f"[1/7] device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi:")
    log(card)

    log("[2/7] build")
    build_kernels(["fused_block", "fused_block_bwd"])

    log("[3/7] kernels against their plain versions")
    k1_results = check_k1(device)
    k1s_results = check_k1_save(device)
    k2_results = check_k2(device)

    log("[4/7] serving path: convnext_tiny, B=16 x 10-s clips")
    serve, launches = run_main_path(device)

    log(f"[5/7] training path: convnext_tiny, {TRAIN_CLIPS} x 10-s clips per step, "
        f"{TRAIN_STEPS} steps")
    trainer, batch, train_launches = run_training_path(device)
    check_fused_vs_unfused(device)

    log(f"[6/7] times on {card}")
    per_shape = time_k1(device)
    save_shape = time_k1_save(device)
    k2_shape = time_k2(device)
    unfused = time_unfused(device)
    time_end_to_end(serve, "bf16 serving")
    profile_forward(serve, BATCH)
    time_training(trainer, batch)

    log("[7/7] inference surfaces: convnext_tiny bf16 serving (the phase-4 model)")
    WORK.mkdir(parents=True, exist_ok=True)
    surface_launches = check_checkpoint_round_trip(serve, device, fixture_batch(BATCH, SEED))
    pcm, target = eval_data(SEED + 9)
    log("  Evaluator route: in-memory dataset with AudioSetDataset's contract (no h5py here; "
        "the HDF5 route, EvaluateSampler + AudioSetDataset, cli.evaluate and "
        "cli.extract_embeddings are held against the JAX package by tests/test_torch_eval.py "
        "and tests/test_torch_infer.py on the CPU)")
    ev, n = check_evaluator(serve, device, pcm, target)
    surface_launches += n + check_tagging(serve) + run_clis()
    log(f"  inference surfaces: K1 launches {surface_launches} in all")
    time_evaluator(serve, ev, pcm, target, card)
    shutil.rmtree(WORK)

    kernels = [
        _entry("fused_block", "fused_block.cu", "audioset_convnext_inf_tpu/ops/pallas_fused_block.py:53",
               launches + surface_launches, k1_results, per_shape,
               "serving forward (phase 4 and the inference surfaces)", K1_MAIN_PATH, unfused,
               err_cases=K1_SERVING_CASES),
        _entry("fused_block_save", "fused_block.cu",
               "audioset_convnext_inf_tpu/ops/pallas_fused_block.py:53 (save_d=True)",
               train_launches[1], k1s_results, save_shape, "training forward (save mode)",
               K1_MAIN_PATH, unfused),
        _entry("fused_block_bwd", "fused_block_bwd.cu",
               "audioset_convnext_inf_tpu/ops/pallas_fused_block_bwd.py:66",
               train_launches[2], k2_results, k2_shape, "training backward", K1_MAIN_PATH),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
