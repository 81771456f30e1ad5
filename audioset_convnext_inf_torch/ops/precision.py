"""Per-op float32 precision on the card.

A float32 matmul runs through cuBLAS and a float32 convolution through
cuDNN, and each reads its own TF32 switch; cuDNN's is on by default, so an
f32 convolution left alone runs in TF32. ``fp32_precision`` sets both
switches for the ops inside the ``with`` block and restores them after, so
no setting leaks into the rest of the process.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_TF32 = {"highest": False, "high": True}


@contextlib.contextmanager
def fp32_precision(precision: str) -> Iterator[None]:
    """"highest": true f32 (TF32 off); "high": TF32 for matmul and conv."""
    if precision not in _TF32:
        raise ValueError(f"fp32 precision must be one of {sorted(_TF32)}, got {precision!r}")
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = _TF32[precision]
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = prev


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    with fp32_precision("highest"):
        return torch.mm(a.float(), b.float())


class _MmF32Acc(torch.autograd.Function):
    """Gradient of ``mm_f32acc``: the f32 cotangent rounds to the operand
    dtype, and each operand gradient is the same f32-accumulated product,
    rounded to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = _mm(g, b.t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = _mm(a.t(), g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def mm_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D ``a @ b`` with f32 products and accumulation, returned in f32.

    For bf16 operands this is one bf16 tensor-core product on the card
    (cuBLAS with an f32 output); the CPU has no such op, and there the
    operands are widened first, which computes the same exact products.
    Differentiable: the backward runs the same kind of product.
    """
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MmF32Acc.apply(a, b)
    return _mm(a, b)
