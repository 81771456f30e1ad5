"""Modulated deformable convolution v2 as bilinear gather + one product.

The JAX package computes the reference's ``DeformableConv2d``
(pytorch/models.py:202-265, torchvision's ``deform_conv2d``) outside any
Pallas kernel, as gathers and an einsum (its ``ops/deform_conv.py``); this
is the same function in plain PyTorch, in NCHW:

    out(p) = sum_k w_k . x(p + p_k + Dp_k) . m_k

Each kernel tap is a bilinear gather (four corner lookups, zero outside the
map), scaled by its mask, and the taps stacked tap-major go through one
(k*k*C, O) product. Zero offsets and no mask give the regular convolution.
The offset tensor is (B, 2*k*k, H, W) with (dy, dx) interleaved per tap, in
tap-major order: torchvision's layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _bilinear_gather(x: torch.Tensor, y: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Sample x (B, C, H, W) at float coordinates y, xq (B, H', W'), zero
    outside the map: (B, C, H', W')."""
    b, c, h, w = x.shape
    y0 = torch.floor(y)
    x0 = torch.floor(xq)
    wy = y - y0
    wx = xq - x0
    flat = x.reshape(b, c, h * w)

    def corner(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        vals = torch.gather(flat, 2, idx.reshape(b, 1, -1).expand(b, c, -1))
        return vals.reshape(b, c, *yi.shape[1:]) * inb[:, None].to(x.dtype)

    v00 = corner(y0, x0)
    v01 = corner(y0, x0 + 1)
    v10 = corner(y0 + 1, x0)
    v11 = corner(y0 + 1, x0 + 1)
    wy = wy[:, None].to(x.dtype)
    wx = wx[:, None].to(x.dtype)
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


def deform_conv2d(
    x: torch.Tensor,  # (B, C, H, W)
    offset: torch.Tensor,  # (B, 2*kh*kw, H, W): (dy, dx) per tap
    weight: torch.Tensor,  # (O, C, kh, kw)
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,  # (B, kh*kw, H, W)
    padding: Tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """Stride-1 modulated deformable convolution (torchvision's v2
    semantics), (B, O, H, W)."""
    b, c, h, w = x.shape
    out_ch, _, kh, kw = weight.shape
    ph, pw = padding
    rows = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    cols = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    taps = []
    for i in range(kh):
        for j in range(kw):
            t = i * kw + j
            y = rows + (i - ph) + offset[:, 2 * t].float()
            xq = cols + (j - pw) + offset[:, 2 * t + 1].float()
            v = _bilinear_gather(x, y, xq)
            if mask is not None:
                v = v * mask[:, t : t + 1].to(v.dtype)
            taps.append(v)
    stacked = torch.stack(taps, dim=1).reshape(b, kh * kw * c, h * w)  # tap-major
    wmat = weight.permute(0, 2, 3, 1).reshape(out_ch, kh * kw * c).to(stacked.dtype)
    out = torch.matmul(wmat, stacked).reshape(b, out_ch, h, w)
    if bias is not None:
        out = out + bias[:, None, None]
    return out.to(x.dtype)
