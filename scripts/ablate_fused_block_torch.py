#!/usr/bin/env python3
"""Where the port's bf16 fused-block kernels spend their time, by ablation.

    python3 scripts/ablate_fused_block_torch.py [variant ...]

Runs from the root of a checkout on a machine with an NVIDIA card and nvcc.
No tool that reads time inside a kernel (ncu, nsys) is assumed, so this
script builds the kernels again through ``ops/_build.py`` with -D macros
that switch one part off or change the launch plan (the macros are listed
in the note at the top of ``csrc/fused_block.cu``), and times each build
(median of 5 runs of 20 calls, CUDA events) at the main path's shapes
(bf16, B=16: tiny stage 3, C=384, and stage 4, C=768; K1 also in its
unfused-rounding mode at stages 1 and 2, C=96 and 192, at B=16 and 256)
beside the package's own build. A build with a part switched off computes wrong
results by design; a build with another plan is first held to its plain
version within the kernel tolerance of chip_smoke.py. Variants:

  k1/none       K1 as the package builds it (serving and save mode)
  k1/stencil    K1 without its 7x7 stencil's arithmetic (x still staged,
                d left zero)
  k1/mma        K1 without its wgmma instructions (operands kept)
  k1/prefetch   K1's producer loading only the first `stages` weight boxes
                (later boxes reuse whatever the ring holds)
  k1/split2     K1 with the hidden units in two ranges whatever the batch
                (K1_SPLIT=2: another plan, f32 partials and the sum launch)
  k2/none       K2 as the package builds it (no macro changes its plan)

The last line is one JSON object {"card": ..., "ms": {variant: {shape: ms}}}.
"""

from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from audioset_convnext_inf_torch.ops import _build  # noqa: E402
from audioset_convnext_inf_torch.ops import fused_block as FB  # noqa: E402
from audioset_convnext_inf_torch.ops import fused_block_bwd as FBB  # noqa: E402

# variant: (kernel library, -D macros)
VARIANTS = {
    "k1/none": ("fused_block", ()),
    "k1/stencil": ("fused_block", ("ABLATE_STENCIL",)),
    "k1/mma": ("fused_block", ("ABLATE_MMA",)),
    "k1/prefetch": ("fused_block", ("ABLATE_PREFETCH",)),
    "k1/split2": ("fused_block", ("K1_SPLIT=2",)),
    "k2/none": ("fused_block_bwd", ()),
}
PLAN_MACROS = ("K1_SPLIT",)


def k1_plan(c, npix, defines):
    """The plan a K1 build runs: the package's, or K1_SPLIT's hidden ranges."""
    split = [int(d.partition("=")[2]) for d in defines if d.partition("=")[0] == "K1_SPLIT"]
    return FB.launch_plan(c, torch.bfloat16, npix, split=split[0] if split else None)


def check(got, ref, variant, name):
    scale = max(1.0, ref.float().abs().max().item())
    err = (got.float() - ref.float()).abs().max().item()
    if not err <= cs.KERNEL_TOL[torch.bfloat16] * scale:
        raise AssertionError(f"{variant} disagrees with the plain version at {name}: {err:.3e}")


def time_variant(variant: str, device) -> dict:
    kernel, defines = VARIANTS[variant]
    checked = any(d.partition("=")[0] in PLAN_MACROS for d in defines)
    out = {}
    for name, b, h, w, c, _ in cs.K1_CASES[:2]:
        npix = b * h * w
        if kernel == "fused_block":
            x, args = cs.k1_inputs(b, h, w, c, True, torch.bfloat16, device, cs.SEED)
            s = cs.drop_scales(b, device, cs.SEED)
            plan = k1_plan(c, npix, defines)
            serve = lambda: FB._forward_cuda(x, *args, 1e-6, None, False, plan, defines)  # noqa: E731
            save = lambda: FB._forward_cuda(x, *args, 1e-6, s, True, plan, defines)  # noqa: E731
            if checked:
                check(serve(), FB.fused_block_reference(x, *args), variant, name)
            out[name] = cs.median_ms(serve, iters=20)[0]
            out[f"{name} save"] = cs.median_ms(save, iters=20)[0]
        else:
            x, d, dy, wts, s = cs.k2_inputs(b, h, w, c, torch.bfloat16, device, cs.SEED)
            plan = FBB.launch_plan(c, torch.bfloat16, b, h, w)
            fn = lambda: FBB._backward_cuda(x, d, dy, *wts, s, 1e-6, plan, defines)  # noqa: E731
            if checked:
                check(fn()[0], FBB.fused_block_bwd_reference(x, d, dy, *wts, s)[0], variant, name)
            out[name] = cs.median_ms(fn, iters=20)[0]
    if kernel == "fused_block":  # the unfused-rounding mode at stages 1-2
        for name, b, h, w, c, _ in cs.K1_UNFUSED_CASES:
            if name not in ("tiny stage 1", "tiny stage 2") + cs.K1_UNFUSED_TIMED_ONLY:
                continue
            x, args = cs.k1_inputs(b, h, w, c, True, torch.bfloat16, device, cs.SEED)
            plan = k1_plan(c, b * h * w, defines)
            fn = lambda: FB._forward_cuda(x, *args, 1e-6, None, False, plan, defines,  # noqa: E731
                                          unfused=True)
            if checked:
                check(fn(), FB.convnext_block(x, *args), variant, name)
            out[f"{name} unfused"] = cs.median_ms(fn, iters=20)[0]
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("ablate_fused_block_torch: no CUDA device available", file=sys.stderr)
        return 2
    variants = argv or list(VARIANTS)
    card = cs.power_line()
    print(card, flush=True)
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        list(pool.map(lambda v: _build.build(*VARIANTS[v]), variants))
    device = torch.device("cuda")
    counts = (FB.fused_block.launches, FB.fused_block.save_launches,
              FB.fused_block.unfused_rounding_launches, FBB.fused_block_bwd.launches)
    result = {}
    for v in variants:
        result[v] = time_variant(v, device)
        print(f"{v:12s} " + ", ".join(f"{k} {t:.4f} ms" for k, t in result[v].items()), flush=True)
    (FB.fused_block.launches, FB.fused_block.save_launches,
     FB.fused_block.unfused_rounding_launches, FBB.fused_block_bwd.launches) = counts
    print(json.dumps({"card": card, "ms": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
