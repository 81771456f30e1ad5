"""Fused ConvNeXt block backward: the CUDA kernel and its plain version.

``fused_block_bwd`` computes dx and every weight gradient of one block in
training mode,

    y = x + s[b] * gamma * (gelu_tanh(LN(d) . W1^T + b1) . W2^T + b2),
    d = dwconv7x7(x) + b_dw,

from the block input ``x``, the dwconv output ``d`` that the forward's save
mode stored (``ops/fused_block.py``) and the upstream gradient ``dy``, all
NHWC (B, H, W, C). It replaces the JAX package's
``ops/pallas_fused_block_bwd.py::_bwd_kernel``, with its rounding points
(see ``fused_block_bwd_reference``). It is the custom op
``fused_block_bwd`` (as ``ops/fused_block.py``'s two): on a CUDA tensor it
launches ``csrc/fused_block_bwd.cu`` (built at first use by
``ops/_build.py``) or raises; on a CPU tensor it runs
``fused_block_bwd_reference``. The kernel
source says what bounds it on the card and how its launches divide the work
(bf16: seven, the products on Hopper's ``wgmma`` fed by TMA).
``launch_plan`` chooses the launches (the chain's wgmma tiles, the splits of
the dxn and weight-gradient products, the stencil tile, shared memory) and
the workspace sizes from (C, dtype, image shape); the wrapper allocates what
it says and passes it to the kernel, which refuses a plan it cannot run.

The unfused-rounding mode (``unfused_rounding=True``, bf16) differentiates
the forward's unfused-rounding save mode, the unfused block's function
(``ops/nhwc.py::convnext_block``): ``d`` is then the forward's (2, B, H, W,
C) save, d and z, and the block's rounding points are those of
``fused_block_bwd_reference(..., unfused_rounding=True)``.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from audioset_convnext_inf_torch.ops import _build
from audioset_convnext_inf_torch.ops.fused_block import (
    K, MAX_C, OPS, _DTYPE_CODE, _check, _f32, padded_c, tile_weights)
from audioset_convnext_inf_torch.ops.precision import fp32_precision
from audioset_convnext_inf_torch.utils.profiling import span

_C0 = 0.7978845608028654  # sqrt(2/pi)
_C1 = 0.044715
CUDA_LAUNCHES = 7  # kernel launches per bf16 call (see the kernel source)
SMS = 132  # streaming multiprocessors of an H100: the split targets are two blocks each
_BM, _BN, _BK = 128, 128, 64  # wgmma block tile (two warpgroups of 64 rows) and ring depth
PX = 32  # pixels of a prep / LN-backward block (bf16)
_TILE = _BM * _BK * 2  # bytes of a 128 x 64 bf16 tile
CHAIN_SMEM = 3 * 4 * _TILE + 1024  # chain_h_kernel: 3 stages of xn, dz2, W1, W2 tiles + alignment
WGRAD_SMEM = 3 * 2 * _TILE + 1024  # gemm_kernel: 3 stages of A and B tiles + alignment
SLAB = 64  # channels of a stencil block
_ROWS, _COLS, _STENCIL_CAP = 16, 32, 112640  # the stencil tile's limits (110 KiB: 2 blocks an SM)


class StencilTile(NamedTuple):
    th: int     # output rows of a tile
    tw: int     # output columns of a tile
    nth: int    # tiles down an image
    ntw: int    # tiles across an image
    smem: int   # bytes: dd with its 3-pixel halo and x, SLAB channels, and their 49 taps in f32


def _sum_blocks(rows: int, cols: int) -> int:
    """Blocks of the sums' launch (sum_parts_kernel) for one partial: g
    threads a column (a power of two up to 32, at most the rows), each of
    256 threads 4 columns where the rows are at most 8, else 1."""
    g = 1
    while g < 32 and 2 * g <= rows:
        g *= 2
    return -(-cols // ((4 if rows <= 8 else 1) * 256 // g))


def stencil_tile(h: int, w: int, esize: int) -> StencilTile:
    """The depthwise stencils' tile on an h x w image (as the kernel's
    stencil_plan): all of w up to 32 columns, else w in even pieces of at
    most 32; as many rows as the staging of dd and x fits in 110 KiB of
    shared memory, at most 16, h in even pieces."""
    ntw = -(-w // _COLS)
    tw = -(-w // ntw)
    staged = _STENCIL_CAP // (SLAB * esize)
    rows = max(1, min((staged - 6 * (tw + 6)) // (2 * tw + 6), _ROWS, h))
    nth = -(-h // rows)
    th = -(-h // nth)
    staging = ((th + 6) * (tw + 6) + th * tw) * SLAB * esize
    return StencilTile(th, tw, nth, ntw, staging + 4 * K * K * SLAB)


class BwdPlan(NamedTuple):
    mt: int           # pixels per chain block (bf16: a 128-pixel wgmma tile; f32: 16)
    cp: int           # channels as the kernels' tiles see them (bf16: padded to CPAD)
    px: int           # pixels per prep / LN-backward block (bf16; f32: = mt)
    split: int        # pixel ranges of the bf16 weight-gradient products (split-K)
    split_px: int     # pixels per range, a multiple of 64
    ksplit: int       # ranges of the bf16 dxn product's 4C reduction
    stencil: StencilTile
    chain_ctas: int   # thread blocks of the chain launch
    dxn_ctas: int     # thread blocks of the bf16 dxn product
    wgrad_ctas: int   # thread blocks of the weight-gradient launch(es)
    stencil_ctas: int  # thread blocks of the stencil launch
    chain_smem: int   # dynamic shared memory of one chain block
    wgrad_smem: int   # shared memory of one product block (bf16: the dxn product's too)
    ln_smem: int      # dynamic shared memory of one LN-backward block (bf16)
    acc_regs: int     # f32 accumulator registers per thread of the chain
    workspace: Dict[str, int]  # elements: xn, dys, dz2, gact, dh1, dd in dt; the rest f32
    launches: Tuple[Tuple[str, int], ...]  # (kernel, thread blocks) of each launch, in order


def launch_plan(c: int, dtype: torch.dtype, b: int, h: int, w: int,
                unfused_rounding: bool = False) -> BwdPlan:
    """The backward's launches and workspaces for C channels on (b, h, w)
    pixels (``unfused_rounding``: bf16, one more partial sum, dgamma's).
    bf16: the chain as 128-pixel x 128-hidden-unit wgmma tiles;
    dxn = dh1 . W1 as 128 x 128 tiles, its 4C reduction cut into
    ``ksplit`` ranges when the tiles alone are fewer than two a SM; the two
    weight-gradient products as 128 x 128 tiles in one launch, the pixels
    cut into ``split`` ranges for about two blocks a SM. f32: the FMA
    kernels, 16 pixels per chain block, no split. Both: the stencil tile of
    ``stencil_tile``, 64 channels a block."""
    if not 1 <= c <= MAX_C:
        raise ValueError(f"fused_block_bwd supports 1 <= C <= {MAX_C}, got C={c}")
    npix = b * h * w
    if dtype == torch.float32:
        mt = px = 16
        cp, split, split_px, ksplit = c, 1, max(npix, 1), 1
        cs = (c + 3) & ~3
        chain_ctas, dxn_ctas = -(-npix // mt), 0
        chain_smem = 4 * (3 * 16 * cs + 2 * 16 * 64 + 64 * 65 + 4 * 16)
        wgrad_ctas = 2 * (-(-c // 64)) * (-(-4 * c // 64))  # two launches of 64x64 tiles
        wgrad_smem, ln_smem, acc_regs = 2 * 4 * 32 * 64, 0, 4  # two static 32 x 64 f32 tiles
        esize = 4
    elif dtype == torch.bfloat16:
        cp, mt, px = padded_c(c), _BM, PX
        mtiles = -(-npix // _BM)
        chain_ctas = (4 * cp // _BN) * mtiles
        dxn_tiles = mtiles * (cp // _BN)
        ksplit = min(4, max(1, -(-2 * SMS // max(dxn_tiles, 1))))
        dxn_ctas = dxn_tiles * ksplit
        tiles = (cp // _BN) * (4 * cp // _BN)
        want = max(1, round(2 * SMS / tiles))
        per_range = -(-npix // want)
        split_px = max(_BK, -(-per_range // _BK) * _BK)  # whole 64-pixel steps
        split = max(1, -(-npix // split_px))
        wgrad_ctas = 2 * tiles * split
        chain_smem, wgrad_smem, ln_smem = CHAIN_SMEM, WGRAD_SMEM, 4 * PX * cp
        acc_regs = 128  # h1 and dg: two 64 x 128 f32 tiles a warpgroup
        esize = 2
    else:
        raise TypeError(f"fused_block_bwd takes float32 or bfloat16 activations, got {dtype}")
    bf = dtype == torch.bfloat16
    if unfused_rounding and not bf:
        raise TypeError(f"fused_block_bwd: the unfused-rounding mode takes bfloat16 "
                        f"activations, got {dtype}")
    st = stencil_tile(h, w, esize)
    stencil_ctas = b * st.nth * st.ntw * -(-c // SLAB)
    workspace = {
        "xn": npix * cp, "dys": npix * cp, "dz2": npix * cp if bf else 0,
        "gact": npix * 4 * cp, "dh1": npix * 4 * cp, "dd": npix * c,
        "dxn": ksplit * npix * cp if bf else 0, "stats": 2 * npix if bf else 0,
        "part_vec": -(-npix // px) * (4 if bf else 8) * c,
        "part_db1": -(-npix // mt) * 4 * c if bf else 0,
        "part_dww": b * st.nth * st.ntw * K * K * c,
        "part_mm": split * 2 * 4 * cp * cp if bf else 0,
    }
    if unfused_rounding:  # dgamma's block sums
        workspace["part_dg"] = -(-npix // px) * c
    # the fixed-order sums: one launch over every partial, a segment per
    # output (sum dy*s, dlnb, dlns, db_dw, db1, dW_dw, bf16: M | dW1,
    # unfused rounding: dgamma) as (rows, columns)
    vec_rows = workspace["part_vec"] // ((4 if bf else 8) * c)
    segments = [(vec_rows, c)] * 4 + [
        (-(-npix // mt) if bf else vec_rows, 4 * c),
        (workspace["part_dww"] // (K * K * c), K * K * c)] + ([(split, 8 * cp * cp)] if bf else [])
    if unfused_rounding:
        segments.append((vec_rows, c))
    sum_ctas = sum(_sum_blocks(rows, cols) for rows, cols in segments)
    if bf:
        nblk = -(-npix // px)
        launches = (("prep_kernel", nblk), ("chain_h_kernel", chain_ctas),
                    ("gemm_kernel", dxn_ctas), ("ln_bwd_kernel", nblk),
                    ("gemm_kernel", wgrad_ctas), ("dw_bwd_kernel", stencil_ctas),
                    ("sum_parts_kernel", sum_ctas))
    else:
        launches = (("chain_kernel", chain_ctas), ("wgrad_gemm_kernel", wgrad_ctas // 2),
                    ("wgrad_gemm_kernel", wgrad_ctas // 2), ("dw_bwd_kernel", stencil_ctas),
                    ("sum_parts_kernel", sum_ctas))
    return BwdPlan(mt, cp, px, split, split_px, ksplit, st, chain_ctas, dxn_ctas, wgrad_ctas,
                   stencil_ctas, chain_smem, wgrad_smem, ln_smem, acc_regs, workspace, launches)


_WS_DT = ("xn", "dys", "dz2", "gact", "dh1", "dd")  # workspaces in the activation dtype


# the kernel's f32 vector sums, each its own tensor (a custom op's outputs
# may not share storage): (name, length in C); dgamma's in the
# unfused-rounding mode
_VEC = (("sdys", 1), ("dlnb", 1), ("dlns", 1), ("dbdw", 1), ("db1", 4))
_DG = "dg"


def allocate(plan: BwdPlan, c: int, dt: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """Every buffer the kernel writes under ``plan``: the workspaces of
    ``plan.workspace`` (flat views of one allocation per dtype, each
    starting on a 256-byte boundary, as the kernels' 16-byte loads and TMA
    need), and the f32 sums: sum dy*s, dlnb, dlns, db_dw (C each), db1
    (4C), dww (C, 1, 7, 7), m (cp, 4cp) and dw1 (4cp, cp); the
    unfused-rounding mode's dgamma (C). m and dw1 are the two halves of one
    buffer, so that one fixed-order sum writes both."""
    cp = plan.cp
    bufs = {}
    for kind, names in ((dt, _WS_DT), (torch.float32, [k for k in plan.workspace
                                                      if k not in _WS_DT])):
        align = 256 // torch.finfo(kind).bits * 8  # elements of 256 bytes
        sizes = [-(-plan.workspace[k] // align) * align for k in names]
        flat = torch.empty(sum(sizes), dtype=kind, device=device)
        for k, start in zip(names, itertools.accumulate([0] + sizes)):
            bufs[k] = flat[start:start + plan.workspace[k]]
    for k, n in _VEC:
        bufs[k] = torch.empty(n * c, device=device)
    if plan.workspace.get("part_dg"):
        bufs[_DG] = torch.empty(c, device=device)
    mm = torch.empty(2, 4 * cp * cp, device=device)
    bufs.update(dww=torch.empty(c, 1, K, K, device=device), m=mm[0].view(cp, 4 * cp),
                dw1=mm[1].view(4 * cp, cp))
    return bufs

Grads = Dict[str, torch.Tensor]


def _grads(dww: torch.Tensor, sdys: torch.Tensor, dlnb: torch.Tensor, dlns: torch.Tensor,
           dbdw: torch.Tensor, db1: torch.Tensor, m: torch.Tensor, dw1: torch.Tensor,
           w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor, dt: torch.dtype,
           dgamma: Optional[torch.Tensor] = None) -> Grads:
    """The gradients in the port's parameter layouts from the kernel's
    sums: dww (C, 1, 7, 7), sum dy*s, dlnb, dlns, db_dw (C), db1 (4C), m =
    (dy*s)^T . gact (C, 4C), dw1 = dh1^T . xn (4C, C). dW2, db2 and dgamma
    come from m as in the JAX package (outside its kernel); dgamma takes
    W2 rounded to the activation dtype, as the kernel saw it. The
    unfused-rounding mode hands in gamma as the block took it (bf16) and
    its own ``dgamma``, sum dy*s * z."""
    g = gamma.float()
    if dgamma is None:
        dgamma = (m * w2.to(dt)).sum(dim=1) + b2.float() * sdys
    return {
        "dwconv.weight": dww,
        "dwconv.bias": dbdw,
        "norm.weight": dlns,
        "norm.bias": dlnb,
        "pwconv1.weight": dw1,
        "pwconv1.bias": db1,
        "pwconv2.weight": m * g[:, None],
        "pwconv2.bias": g * sdys,
        "gamma": dgamma,
    }


def fused_block_bwd_reference(
    x: torch.Tensor, d: torch.Tensor, dy: torch.Tensor,
    dw_w: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    gamma: torch.Tensor, s: torch.Tensor, eps: float = 1e-6,
    unfused_rounding: bool = False,
) -> Tuple[torch.Tensor, Grads]:
    """Plain PyTorch version of the kernel. ``dt`` is x's dtype; dt(.)
    rounds to it; every sum is f32. Per pixel, over the real C channels:

    1. LN from d: mean, var = max(E[d^2] - mean^2, 0), rstd, xhat =
       (d - mean) * rstd, xn = dt(xhat * ln_w + ln_b).
    2. h1 = xn . dt(W1)^T + b1; th = tanh(c0 * (h1 + c1 * h1^3));
       gact = dt(0.5 * h1 * (1 + th)).
    3. dys32 = dy * s[b], dys = dt(dys32); M += dys^T . gact;
       dz2 = dt(dys32 * gamma); dg = dz2 . dt(W2).
    4. dh1f = dg * gelu'(h1) (the tanh form); db1 += sum dh1f;
       dh1 = dt(dh1f); dW1 += dh1^T . xn; dxn = dh1 . dt(W1).
    5. dlnb += sum dxn, dlns += sum dxn * xhat, sum_dys += sum dys32;
       dxh = dxn * ln_w; ddc = rstd * (dxh - mean(dxh) - xhat *
       mean(dxh * xhat)); db_dw += sum ddc; dd = dt(ddc), rounded before
       both stencils.
    6. dW_dw[tap] += sum x(window tap) * dd; dx = dt(dy + sum over taps of
       the flipped kernel times dd): the residual term is dy, not dy * s.
    7. dW2 = gamma * M, db2 = gamma * sum_dys, dgamma = sum_j dt(W2) * M +
       b2 * sum_dys.

    x, d, dy: (B, H, W, C); dw_w (C, 1, 7, 7); w1 (4C, C); w2 (C, 4C);
    s (B,). Returns (dx in dt, gradients in f32 keyed by parameter name).

    ``unfused_rounding`` (bf16): the backward of the unfused block's
    function, ``convnext_block`` with drop path, as the forward's
    unfused-rounding save mode computed it; d is then (2, B, H, W, C), the
    forward's d and z = dt(gact . dt(W2)^T + b2). The taps, gamma and s
    enter as dt(.) of theirs, as the forward took them (the dx stencil's
    taps, dz2, dW2, db2, dy*s). Steps 1, 3 to 6 as above; in 2, h1 =
    dt(xn . dt(W1)^T + b1), gact = dt(gelu_tanh(h1)) (``F.gelu``), and
    gelu'(h1) at that h1; in 7, dgamma = sum dy*s * z over the pixels, z
    as rounded (dW2 and db2 as above, with dt(gamma)).
    """
    dt = x.dtype
    b, h, w, c = x.shape
    z = None
    if unfused_rounding:
        d, z = d[0], d[1].float()
        dw_w, gamma, s = (t.to(dt) for t in (dw_w, gamma, s))
    with fp32_precision("highest"):
        df = d.float()
        mean = df.sum(-1, keepdim=True) * (1.0 / c)
        mean_sq = (df * df).sum(-1, keepdim=True) * (1.0 / c)
        rstd = torch.rsqrt(torch.clamp(mean_sq - mean * mean, min=0.0) + eps)
        xhat = (df - mean) * rstd
        xn = (xhat * ln_w.float() + ln_b.float()).to(dt).float()
        w1t, w2t = w1.to(dt).float(), w2.to(dt).float()
        h1 = F.linear(xn, w1t, b1.float())
        if unfused_rounding:
            h1 = h1.to(dt).float()
            gact = F.gelu(h1, approximate="tanh").to(dt).float()
        th = torch.tanh(_C0 * (h1 + _C1 * h1 * h1 * h1))
        if not unfused_rounding:
            gact = (0.5 * h1 * (1.0 + th)).to(dt).float()
        dys32 = dy.float() * s.float().reshape(-1, 1, 1, 1)
        dys = dys32.to(dt).float()
        m = dys.reshape(-1, c).t() @ gact.reshape(-1, 4 * c)
        dz2 = (dys32 * gamma.float()).to(dt).float()
        dg = dz2 @ w2t
        gp = 0.5 * (1.0 + th) + 0.5 * h1 * (1.0 - th * th) * _C0 * (1.0 + 3.0 * _C1 * h1 * h1)
        dh1f = dg * gp
        dh1 = dh1f.to(dt).float()
        dw1 = dh1.reshape(-1, 4 * c).t() @ xn.reshape(-1, c)
        dxn = dh1 @ w1t
        dxh = dxn * ln_w.float()
        m1 = dxh.sum(-1, keepdim=True) * (1.0 / c)
        m2 = (dxh * xhat).sum(-1, keepdim=True) * (1.0 / c)
        ddc = rstd * (dxh - m1 - xhat * m2)
        dd = ddc.to(dt).float()
        pix = (0, 1, 2)
        vec = (dys32.sum(pix), dxn.sum(pix), (dxn * xhat).sum(pix), ddc.sum(pix), dh1f.sum(pix))
        xp = F.pad(x.float(), (0, 0, K // 2, K // 2, K // 2, K // 2))
        dww = torch.stack([(xp[:, ky:ky + h, kx:kx + w] * dd).sum(pix)
                           for ky in range(K) for kx in range(K)])
        flipped = dw_w.float().flip(-1, -2)
        dgrad = F.conv2d(dd.permute(0, 3, 1, 2), flipped, padding=K // 2, groups=c)
        dx = (dy.float() + dgrad.permute(0, 2, 3, 1)).to(dt)
        dgamma = (dys32 * z).sum(pix) if unfused_rounding else None
    dww = dww.t().reshape(c, 1, K, K).contiguous()
    return dx, _grads(dww, *vec, m, dw1, w2, b2, gamma, dt, dgamma)


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel library, built with ``defines`` (see fused_block._lib)."""
    lib = _build.load("fused_block_bwd", defines)
    fn = lib.fused_block_backward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 31 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 8 + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        lib.fused_block_bwd_plan_smem.argtypes = [ctypes.c_int] * 4
        lib.fused_block_bwd_plan_smem.restype = ctypes.c_longlong
        lib.fused_block_bwd_wgrad_smem.argtypes = []
        lib.fused_block_bwd_wgrad_smem.restype = ctypes.c_longlong
        lib.fused_block_bwd_ln_smem.argtypes = [ctypes.c_int]
        lib.fused_block_bwd_ln_smem.restype = ctypes.c_longlong
        lib.fused_block_bwd_stencil_smem.argtypes = [ctypes.c_int] * 5
        lib.fused_block_bwd_stencil_smem.restype = ctypes.c_longlong
    return lib


def fused_block_bwd(
    x: torch.Tensor, d: torch.Tensor, dy: torch.Tensor,
    dw_w: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    gamma: torch.Tensor, s: torch.Tensor, eps: float = 1e-6,
    unfused_rounding: bool = False,
) -> Tuple[torch.Tensor, Grads]:
    """dx and the block's weight gradients (see the module docstring),
    through the custom op ``fused_block_bwd``; ``unfused_rounding`` (bf16):
    the backward of the forward's unfused-rounding save mode, whose (2, B,
    H, W, C) save is ``d``. CUDA tensors launch the kernel
    (``fused_block_bwd.launches`` counts each call, which makes
    ``CUDA_LAUNCHES`` launches, and ``.unfused_rounding_launches`` those in
    that mode); CPU tensors run the plain version."""
    if gamma is None or s is None:
        raise ValueError("fused_block_bwd needs gamma (layer scale) and s")
    _check(x, dw_w, None, ln_w, ln_b, w1, b1, w2, b2, gamma, s)
    if unfused_rounding and x.dtype != torch.bfloat16:
        raise TypeError(f"fused_block_bwd: the unfused-rounding mode takes bfloat16 "
                        f"activations, got {x.dtype}")
    d_shape = (2, *x.shape) if unfused_rounding else x.shape
    for name, t, shape in (("d", d, d_shape), ("dy", dy, x.shape)):
        if t.shape != shape or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"fused_block_bwd: {name} must be a contiguous {x.dtype} tensor "
                             f"of shape {tuple(shape)} on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_block_bwd runs on cuda or cpu tensors, got {x.device}")
    flag = (True,) if unfused_rounding else ()  # as in fused_block: only when set
    dx, *grads = _bwd_op(x, d, dy, dw_w, ln_w, ln_b, w1, b1, w2, b2, gamma, s, float(eps), *flag)
    return dx, dict(zip(GRAD_KEYS, grads))


# The kernel as a torch.library custom op (see ops/fused_block.py): the
# gradients come back as a fixed tuple in GRAD_KEYS' order, after dx.
GRAD_KEYS = ("dwconv.weight", "dwconv.bias", "norm.weight", "norm.bias", "pwconv1.weight",
             "pwconv1.bias", "pwconv2.weight", "pwconv2.bias", "gamma")
_SCHEMA = ("(Tensor x, Tensor d, Tensor dy, Tensor dw_w, Tensor ln_w, Tensor ln_b, Tensor w1, "
           "Tensor b1, Tensor w2, Tensor b2, Tensor gamma, Tensor s, float eps, "
           "bool unfused_rounding=False) -> ("
           + ", ".join(["Tensor"] * (1 + len(GRAD_KEYS))) + ")")


@torch.library.custom_op(f"{OPS}::fused_block_bwd", mutates_args=(), device_types="cpu",
                         schema=_SCHEMA)
def _bwd_op(x, d, dy, dw_w, ln_w, ln_b, w1, b1, w2, b2, gamma, s, eps, unfused_rounding=False):
    dx, g = fused_block_bwd_reference(x, d, dy, dw_w, ln_w, ln_b, w1, b1, w2, b2, gamma, s, eps,
                                      unfused_rounding)
    return (dx, *(g[k] for k in GRAD_KEYS))


@_bwd_op.register_kernel("cuda")
def _bwd_cuda(x, d, dy, dw_w, ln_w, ln_b, w1, b1, w2, b2, gamma, s, eps, unfused_rounding=False):
    b, h, w, c = x.shape
    dx, g = _backward_cuda(x, d, dy, dw_w, ln_w, ln_b, w1, b1, w2, b2, gamma, s, eps,
                           launch_plan(c, x.dtype, b, h, w, unfused_rounding),
                           unfused=unfused_rounding)
    return (dx, *(g[k] for k in GRAD_KEYS))


@_bwd_op.register_fake
def _bwd_fake(x, d, dy, dw_w, ln_w, ln_b, w1, b1, w2, b2, gamma, s, eps, unfused_rounding=False):
    c = x.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    shapes = ((c, 1, K, K), (c,), (c,), (c,), (4 * c, c), (4 * c,), (c, 4 * c), (c,), (c,))
    return (torch.empty_like(x), *(torch.empty(sh, **f32) for sh in shapes))


def _backward_cuda(x, d, dy, dw_w, ln_w, ln_b, w1, b1, w2, b2, gamma, s, eps,
                   plan: BwdPlan, defines: Tuple[str, ...] = (),
                   unfused: bool = False) -> Tuple[torch.Tensor, Grads]:
    """One call of the kernel under ``plan`` (checked arguments, CUDA x),
    from the library built with ``defines``; ``unfused``: the backward of
    the unfused block's rounding points (bf16), under a plan made for it."""
    if unfused != ("part_dg" in plan.workspace):
        raise ValueError(f"fused_block_bwd: a plan made with unfused_rounding="
                         f"{not unfused} for a call with unfused_rounding={unfused}")
    lib = _lib(defines)
    b, h, w, c = x.shape
    dt = x.dtype

    def taps(t):  # the unfused block's depthwise taps, gamma and s enter in bf16
        return _f32(t.detach().to(dt) if unfused else t)

    with span("fused_block_bwd.prep"):
        w1c, w2c = tile_weights(w1, w2, dt, plan.cp)
        g = taps(gamma)
        ins = (taps(dw_w), _f32(ln_w), _f32(ln_b), w1c, _f32(b1), w2c, g, taps(s))
        dx = torch.empty_like(x)
        buf = allocate(plan, c, dt, x.device)
    outs = (*(k for k, _ in _VEC), "dww", "m", "xn", "dys", "dz2", "gact", "dh1", "dd", "dxn",
            "stats", "part_vec", "part_db1", "part_dww", "part_mm")
    st = plan.stencil
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_block_backward(
            x.data_ptr(), d.data_ptr(), dy.data_ptr(), *(t.data_ptr() for t in ins),
            dx.data_ptr(), *(buf[k].data_ptr() if buf[k].numel() else None for k in outs),
            b, h, w, c, float(eps), _DTYPE_CODE[dt], stream, plan.mt, plan.cp, plan.px,
            plan.split, plan.split_px, plan.ksplit, st.th, st.tw,
            *((buf[_DG].data_ptr(), buf["part_dg"].data_ptr()) if unfused else (None, None)),
            int(unfused))
    if err != 0:
        raise RuntimeError(f"fused_block_bwd kernel launch failed: cudaError {err}")
    fused_block_bwd.launches += 1
    fused_block_bwd.unfused_rounding_launches += int(unfused)
    m, dw1 = buf["m"][:c, :4 * c], buf["dw1"][:4 * c, :c]
    return dx, _grads(buf["dww"], *(buf[k] for k, _ in _VEC), m, dw1, w2c[:c, :4 * c], b2,
                      g, dt, buf.get(_DG))


fused_block_bwd.launches = 0  # every call (CUDA_LAUNCHES launches each)
fused_block_bwd.unfused_rounding_launches = 0  # the calls in the unfused-rounding mode
