"""Functional building blocks of the PyTorch port.

Activations are NHWC tensors (B, H, W, C), as in the JAX package, and every
function keeps the JAX package's rounding points (its ``models/layers.py``):
statistics and accumulations run in float32 and the result is cast back to
the activation dtype once. Weights stay float32 in the modules and are cast
to the activation dtype where they enter a product. On the card, f32 ops run
with TF32 off (``ops.precision``), so the f32 path is true f32.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from audioset_convnext_inf_torch.ops.precision import fp32_precision, mm_f32acc


def trunc_normal(
    shape: Sequence[int],
    generator: torch.Generator,
    std: float = 0.02,
    mean: float = 0.0,
    a: float = -2.0,
    b: float = 2.0,
) -> torch.Tensor:
    """Truncated normal by the inverse CDF of a truncated uniform (timm's
    ``trunc_normal_`` method; the [a, b] bounds apply to the final values).
    Drawn in f32 on the CPU from ``generator``, so a seed gives the same
    weights whatever device the model lives on."""
    lo = (1.0 + math.erf(((a - mean) / std) / math.sqrt(2.0))) / 2.0
    hi = (1.0 + math.erf(((b - mean) / std) / math.sqrt(2.0))) / 2.0
    u = torch.empty(tuple(shape), dtype=torch.float32)
    u.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    return torch.clamp(torch.erfinv(u) * (std * math.sqrt(2.0)) + mean, a, b)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the trailing axis with single-pass f32 statistics
    (E[x^2] - E[x]^2, clamped at 0); the result is cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    mean_sq = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def batch_norm_apply(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     eps: float = 1e-5, axis: int = -1) -> torch.Tensor:
    """Inference-mode BatchNorm over ``axis`` from running statistics,
    folded to one f32 scale/shift."""
    shape = [1] * x.ndim
    shape[axis] = -1
    inv = torch.rsqrt(running_var.reshape(shape) + eps) * weight.reshape(shape)
    shift = bias.reshape(shape) - running_mean.reshape(shape) * inv
    return (x.float() * inv + shift).to(x.dtype)


@torch.no_grad()
def _update_running(running: torch.Tensor, batch_stat: torch.Tensor, momentum: float) -> None:
    running.copy_((1 - momentum) * running + momentum * batch_stat.detach())


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     eps: float = 1e-5, momentum: float = 0.1, axis: int = -1,
                     all_reduce: Optional[Callable[[List[torch.Tensor]], int]] = None
                     ) -> torch.Tensor:
    """Training-mode BatchNorm over ``axis`` with f32 batch statistics taken
    over every other axis; the result is cast back to x's dtype.

    Updates ``running_mean`` and ``running_var`` IN PLACE (torch's
    convention, where the JAX package returns them): running = (1 -
    momentum) * running + momentum * batch_stat, with the *unbiased* batch
    variance entering the running average.

    ``all_reduce`` (averages a list of tensors over the processes of a
    data-parallel job, in place) makes the statistics those of the global
    batch when ``x`` holds one process's rows, and every process holds as
    many: the global mean is the mean of the processes' per-bin means, then
    the variance the mean of their mean squared deviations from it, both in
    f32, two passes. Every process then normalizes with, and stores, the
    same statistics; in a group of one the arithmetic is the one-process
    arithmetic bit for bit. The statistics take no gradient: x comes from
    the frozen frontend.
    """
    xf = x.float()
    axis = axis % x.ndim
    dims = tuple(i for i in range(x.ndim) if i != axis)
    n = 1
    for i in dims:
        n *= x.shape[i]
    if all_reduce is None:
        mean_k = xf.mean(dim=dims, keepdim=True)
        var_k = torch.square(xf - mean_k).mean(dim=dims, keepdim=True)
    else:
        with torch.no_grad():
            mean_k = xf.mean(dim=dims, keepdim=True)
            n *= all_reduce([mean_k])  # returns the number of processes
            var_k = torch.square(xf - mean_k).mean(dim=dims, keepdim=True)
            all_reduce([var_k])
    unbiased = n / max(n - 1, 1)
    shape = [1] * x.ndim
    shape[axis] = -1
    inv = torch.rsqrt(var_k + eps) * weight.reshape(shape)
    y = xf * inv + (bias.reshape(shape) - mean_k * inv)
    _update_running(running_mean, mean_k.reshape(-1), momentum)
    _update_running(running_var, var_k.reshape(-1) * unbiased, momentum)
    return y.to(x.dtype)


def draw_drop_path(generator: Optional[torch.Generator], batch: int,
                   drop_prob: float) -> Optional[torch.Tensor]:
    """Per-sample stochastic-depth scales (B,) in f32: keep/keep_prob, where
    keep ~ Bernoulli(1 - drop_prob); None where the block drops nothing."""
    if drop_prob == 0.0 or generator is None:
        return None
    keep_prob = 1.0 - drop_prob
    keep = torch.rand(batch, generator=generator) < keep_prob
    return keep.float() / keep_prob


def drop_path(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sample residual drop (reference convnext.py:90-127): the branch
    times its sample's scale from ``draw_drop_path``, taken in x's dtype as
    the JAX package takes its mask. ``scale=None`` is the identity."""
    if scale is None:
        return x
    return x * scale.to(device=x.device, dtype=x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T (+ bias), weight in (out, in) layout. Accumulates in f32,
    adds the f32 bias, then casts to x's dtype once."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        with fp32_precision("highest"):
            y = F.linear(x2, weight, bias)
    else:
        y = mm_f32acc(x2, weight.to(x.dtype).t())
        if bias is not None:
            y = y + bias
    return y.to(x.dtype).reshape(*lead, weight.shape[0])


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: Tuple[int, int] = (1, 1),
    padding: Union[Tuple[int, int], int] = 0,
    groups: int = 1,
    acc_f32: bool = False,
) -> torch.Tensor:
    """NHWC conv with OIHW weights.

    f32 activations convolve in true f32. bf16 activations convolve in bf16
    (f32 accumulation inside cuDNN), round to bf16, then add the f32 bias
    and round again: the JAX package's ``conv2d`` rounding points. With
    ``acc_f32`` the bf16 operands are widened and the sum stays f32 until
    after the bias, one rounding, as the JAX package's patch-GEMM stem and
    fused-layout downsample do.
    """
    dt = x.dtype
    xc = x.permute(0, 3, 1, 2)
    if dt == torch.float32 or acc_f32:
        with fp32_precision("highest"):
            y = F.conv2d(xc.float(), weight.to(dt).float(), None, stride, padding, 1, groups)
    else:
        y = F.conv2d(xc, weight.to(dt), None, stride, padding, 1, groups)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias
    return y.to(dt)
