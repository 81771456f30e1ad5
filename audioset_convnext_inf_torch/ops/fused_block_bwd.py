"""Fused ConvNeXt block backward: the CUDA kernel and its plain version.

``fused_block_bwd`` computes dx and every weight gradient of one block in
training mode,

    y = x + s[b] * gamma * (gelu_tanh(LN(d) . W1^T + b1) . W2^T + b2),
    d = dwconv7x7(x) + b_dw,

from the block input ``x``, the dwconv output ``d`` that the forward's save
mode stored (``ops/fused_block.py``) and the upstream gradient ``dy``, all
NHWC (B, H, W, C). It replaces the JAX package's
``ops/pallas_fused_block_bwd.py::_bwd_kernel``, with its rounding points
(see ``fused_block_bwd_reference``). On a CUDA tensor it launches
``csrc/fused_block_bwd.cu`` (built at first use by ``ops/_build.py``) or
raises; on a CPU tensor it runs ``fused_block_bwd_reference``. The kernel
source says what bounds it on the card and how its launches divide the work.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from audioset_convnext_inf_torch.ops import _build
from audioset_convnext_inf_torch.ops.fused_block import K, _DTYPE_CODE, _check
from audioset_convnext_inf_torch.ops.precision import fp32_precision

_C0 = 0.7978845608028654  # sqrt(2/pi)
_C1 = 0.044715
WGRAD_CHUNK = 256  # pixels per partial sum of the depthwise weight gradient
CUDA_LAUNCHES = 7  # kernel launches per call (see the kernel source)

Grads = Dict[str, torch.Tensor]


def _grads(dww: torch.Tensor, vec: torch.Tensor, m: torch.Tensor, dw1: torch.Tensor,
           w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor, dt: torch.dtype) -> Grads:
    """The gradients in the port's parameter layouts from the kernel's sums:
    dww (49, C) tap-major, vec = [sum dy*s | dlnb | dlns | db_dw | db1 (4C)],
    m = (dy*s)^T . gact (C, 4C), dw1 = dh1^T . xn (4C, C). dW2, db2 and
    dgamma come from m as in the JAX package (outside its kernel); dgamma
    takes W2 rounded to the activation dtype, as the kernel saw it."""
    c = dww.shape[1]
    sdys, dlnb, dlns, dbdw, db1 = torch.split(vec, [c, c, c, c, 4 * c])
    g = gamma.float()
    return {
        "dwconv.weight": dww.t().reshape(c, 1, K, K).contiguous(),
        "dwconv.bias": dbdw,
        "norm.weight": dlns,
        "norm.bias": dlnb,
        "pwconv1.weight": dw1,
        "pwconv1.bias": db1,
        "pwconv2.weight": m * g[:, None],
        "pwconv2.bias": g * sdys,
        "gamma": (w2.to(dt).float() * m).sum(dim=1) + b2.float() * sdys,
    }


def fused_block_bwd_reference(
    x: torch.Tensor, d: torch.Tensor, dy: torch.Tensor,
    dw_w: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    gamma: torch.Tensor, s: torch.Tensor, eps: float = 1e-6,
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
    """
    dt = x.dtype
    b, h, w, c = x.shape
    with fp32_precision("highest"):
        df = d.float()
        mean = df.sum(-1, keepdim=True) * (1.0 / c)
        mean_sq = (df * df).sum(-1, keepdim=True) * (1.0 / c)
        rstd = torch.rsqrt(torch.clamp(mean_sq - mean * mean, min=0.0) + eps)
        xhat = (df - mean) * rstd
        xn = (xhat * ln_w.float() + ln_b.float()).to(dt).float()
        w1t, w2t = w1.to(dt).float(), w2.to(dt).float()
        h1 = F.linear(xn, w1t, b1.float())
        th = torch.tanh(_C0 * (h1 + _C1 * h1 * h1 * h1))
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
        vec = torch.cat([dys32.sum(pix), dxn.sum(pix), (dxn * xhat).sum(pix), ddc.sum(pix),
                         dh1f.sum(pix)])
        xp = F.pad(x.float(), (0, 0, K // 2, K // 2, K // 2, K // 2))
        dww = torch.stack([(xp[:, ky:ky + h, kx:kx + w] * dd).sum(pix)
                           for ky in range(K) for kx in range(K)])
        flipped = dw_w.float().flip(-1, -2)
        dgrad = F.conv2d(dd.permute(0, 3, 1, 2), flipped, padding=K // 2, groups=c)
        dx = (dy.float() + dgrad.permute(0, 2, 3, 1)).to(dt)
    return dx, _grads(dww, vec, m, dw1, w2, b2, gamma, dt)


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_block_bwd")
    fn = lib.fused_block_backward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def fused_block_bwd(
    x: torch.Tensor, d: torch.Tensor, dy: torch.Tensor,
    dw_w: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    gamma: torch.Tensor, s: torch.Tensor, eps: float = 1e-6,
) -> Tuple[torch.Tensor, Grads]:
    """dx and the block's weight gradients (see the module docstring).
    CUDA tensors launch the kernel (``fused_block_bwd.launches`` counts each
    call, which makes ``CUDA_LAUNCHES`` launches); CPU tensors run the plain
    version."""
    if gamma is None or s is None:
        raise ValueError("fused_block_bwd needs gamma (layer scale) and s")
    _check(x, dw_w, None, ln_w, ln_b, w1, b1, w2, b2, gamma, s)
    for name, t in (("d", d), ("dy", dy)):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"fused_block_bwd: {name} must be a contiguous {x.dtype} tensor "
                             f"of x's shape {tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        return fused_block_bwd_reference(x, d, dy, dw_w, ln_w, ln_b, w1, b1, w2, b2,
                                         gamma, s, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_bwd runs on cuda or cpu tensors, got {x.device}")
    lib = _lib()
    b, h, w, c = x.shape
    dt = x.dtype
    npix = b * h * w

    def f32(t):
        return t.detach().to(torch.float32).contiguous()

    dww = f32(dw_w).reshape(c, K * K).t().contiguous()  # (49, C), tap-major
    w1c, w2c = w1.detach().to(dt).contiguous(), w2.detach().to(dt).contiguous()
    ins = (dww, f32(ln_w), f32(ln_b), w1c, f32(b1), w2c, f32(gamma), f32(s))
    dx = torch.empty_like(x)
    ws = [x.new_empty(npix * n) for n in (c, c, 4 * c, 4 * c, c)]  # xn, dys, gact, dh1, dd
    part_chain = torch.empty(-(-npix // 16) * 8 * c, device=x.device)
    part_wgrad = torch.empty(-(-npix // WGRAD_CHUNK) * K * K * c, device=x.device)
    vec = torch.empty(8 * c, device=x.device)
    dww_g = torch.empty(K * K, c, device=x.device)
    m = torch.empty(c, 4 * c, device=x.device)
    dw1 = torch.empty(4 * c, c, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_block_backward(
            x.data_ptr(), d.data_ptr(), dy.data_ptr(), *(t.data_ptr() for t in ins),
            dx.data_ptr(), *(t.data_ptr() for t in ws), part_chain.data_ptr(),
            part_wgrad.data_ptr(), vec.data_ptr(), dww_g.data_ptr(), m.data_ptr(),
            dw1.data_ptr(), b, h, w, c, WGRAD_CHUNK, float(eps), _DTYPE_CODE[dt], stream)
    if err != 0:
        raise RuntimeError(f"fused_block_bwd kernel launch failed: cudaError {err}")
    fused_block_bwd.launches += 1
    return dx, _grads(dww_g, vec, m, dw1, w2, b2, gamma, dt)


fused_block_bwd.launches = 0
