"""Trainable fused ConvNeXt block: the forward kernel's save mode and the
fused backward kernel (the custom ops ``fused_block_save`` and
``fused_block_bwd``) as one ``torch.autograd.Function``.

The counterpart of the JAX package's ``fused_block_train`` custom VJP:

    y = x + s * gamma * pwconv2(gelu_tanh(pwconv1(LN(dwconv(x)))))

with a per-sample drop-path scale ``s`` (B,). The forward saves the block
input x and the dwconv output d only; the backward recomputes the LN
statistics and the 4C-wide GELU hidden from d, so no (B, H, W, 4C) tensor
is kept between the passes. With ``unfused_rounding`` (bf16) both kernels
run in their unfused-rounding modes: the block is the unfused block's
function (``ops/nhwc.py::convnext_block``), and the forward saves z beside
d (the product that gamma multiplies, which dgamma reads).
"""

from __future__ import annotations

import torch

from audioset_convnext_inf_torch.ops.fused_block import fused_block
from audioset_convnext_inf_torch.ops.fused_block_bwd import GRAD_KEYS, fused_block_bwd


class FusedBlockTrain(torch.autograd.Function):
    """apply(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, s, eps,
    unfused_rounding) -> y.

    Weights in the reference layouts; gamma is required (the fused route
    needs layer scale). Gradients come back in the parameters' layouts and
    dtypes; ``s``, ``eps`` and ``unfused_rounding`` get none."""

    @staticmethod
    def forward(ctx, x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, s, eps,
                unfused_rounding=False):
        if gamma is None:
            raise ValueError("FusedBlockTrain needs gamma (layer scale)")
        if s is None:  # no drop path on this block; the backward takes s as well
            s = torch.ones(x.shape[0], device=x.device)
        y, d = fused_block(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps,
                           s=s, save_dwconv=True, unfused_rounding=unfused_rounding)
        ctx.save_for_backward(x, d, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, s)
        ctx.eps = eps
        ctx.unfused_rounding = unfused_rounding
        return y

    @staticmethod
    def backward(ctx, dy):
        x, d, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, s = ctx.saved_tensors
        dx, g = fused_block_bwd(x, d, dy.to(x.dtype).contiguous(), dw_w, ln_w, ln_b,
                                w1, b1, w2, b2, gamma, s, ctx.eps, ctx.unfused_rounding)
        params = (dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma)
        return (dx, *(g[k].to(p.dtype) for k, p in zip(GRAD_KEYS, params)), None, None, None)
