#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with a CUDA card, nvcc and
nvidia-smi. It needs no network and no JAX. Phases, each of which fails the
run (non-zero exit) on any error or mismatch:

 1. device: the card's name and power limit;
 2. build: every CUDA kernel of the main path, from the sources in the
    checkout, with nvcc for sm_90a;
 3. kernels: each kernel against its plain PyTorch version on the card,
    in f32 and bf16, at the main path's shapes and at the widths the
    factories use, with the tolerances stated in KERNEL_TOL;
 4. main path: convnext_tiny at full width on B=16 ten-second clips (the
    fixture recording as int16 plus seeded variants), random weights from
    a seed with seeded gamma/bn0 values. The bf16 serving config runs
    forward, forward_scene_embeddings and forward_frame_embeddings, and each
    call must launch the fused block kernel exactly once per stage-3/4 block;
    the f32 parity config launches it never and matches the port's own f32
    forward on the CPU; bf16 serving probabilities stay near f32 parity;
 5. times (CUDA events after warm-up): each kernel and its plain version at
    the checked shapes beside the least time the card could take;
    end-to-end clips/s of the bf16 serving forward at B=16 and B=64; one
    torch.profiler trace of that forward (device time by kernel, idle share).

The line before the last is one JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
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
# f32 parity config, card vs CPU: logits, the JAX package's parity tolerance.
F32_LOGIT_TOL = 2e-4
# bf16 serving (tanh GELU, bf16 trunk and bf16 DFT) vs f32 parity (erf GELU,
# true f32), probabilities, on random weights.
SERVING_PROB_TOL = 0.05

# (name, B, H, W, C, gamma): the main path's two shapes first (tiny,
# 10-s clips, B=16), then widths of other factories, an odd width, no gamma.
K1_CASES = [
    ("tiny stage 3", BATCH, 63, 14, 384, True),
    ("tiny stage 4", BATCH, 31, 7, 768, True),
    ("atto stage 3", BATCH, 63, 14, 160, True),
    ("base stage 4", BATCH, 31, 7, 1024, True),
    ("odd width", 4, 13, 14, 100, True),
    ("no gamma", BATCH, 31, 7, 768, False),
]
K1_MAIN_PATH = {"tiny stage 3": 9, "tiny stage 4": 3}  # launches per forward


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

def build_kernels(names):
    from audioset_convnext_inf_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        paths = list(pool.map(_build.build, names))
    log(f"build: {len(names)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    for name, path in zip(names, paths):
        report = path.with_suffix(".log")
        lines = report.read_text().splitlines() if report.exists() else []
        for ln in lines:
            if "registers" in ln or "spill" in ln or "smem" in ln:
                log(f"  {name}: {ln.strip()}")
        _build.load(name)


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
    outs = {}
    for name, fn in calls:
        fused_block.launches = 0
        outs[name] = fn(pcm)
        torch.cuda.synchronize()
        n = fused_block.launches
        log(f"  bf16 serving {name}: fused_block launches {n} (expect {expect})")
        if n != expect:
            raise AssertionError(f"{name}: fused_block launched {n} times, expected {expect}")
    launches = expect
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


def profile_forward(model, batch: int, top: int = 10):
    """One traced forward: device time by kernel name, and the device's idle
    share of the traced wall time (union of kernel and copy intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pcm = fixture_batch(batch, SEED + batch)
    model.forward(pcm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.forward(pcm)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log("  profile: the profiler saw no device events; kernel breakdown not measured")
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
    log(f"  profile bf16 forward B={batch}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}, kernel time {total / 1e3:.2f} ms")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"    {t / 1e3:9.3f} ms {100 * t / total:5.1f}% x{n:<4d} {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = power_line()
    log(f"[1/5] device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi:")
    log(card)

    log("[2/5] build")
    build_kernels(["fused_block"])

    log("[3/5] kernels against their plain versions")
    k1_results = check_k1(device)

    log("[4/5] main path: convnext_tiny, B=16 x 10-s clips")
    serve, launches = run_main_path(device)

    log(f"[5/5] times on {card}")
    per_shape = time_k1(device)
    time_end_to_end(serve, "bf16 serving")
    profile_forward(serve, BATCH)

    totals = {key: sum(K1_MAIN_PATH[s] * per_shape[s][key] for s in K1_MAIN_PATH)
              for key in ("ms", "plain_ms", "bound_ms")}
    main_err = max(r["max_abs_err"] for r in k1_results
                   if r["case"] in K1_MAIN_PATH and r["dtype"] == str(torch.bfloat16))
    log(f"  K1 per bf16 B=16 forward (9 stage-3 + 3 stage-4 launches): kernel {totals['ms']:.3f} ms, "
        f"plain {totals['plain_ms']:.3f} ms, bound {totals['bound_ms']:.3f} ms")
    kernels = [{
        "name": "fused_block", "route": "cuda",
        "source": "audioset_convnext_inf_torch/csrc/fused_block.cu",
        "replaces": "audioset_convnext_inf_tpu/ops/pallas_fused_block.py:53",
        "launches": launches, "max_abs_err": main_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
        "bound_by": per_shape["tiny stage 3"]["bound_by"], "library_ms": None,
        "cases": len(k1_results), "ok": True,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
