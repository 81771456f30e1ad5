"""Functional building blocks of the PyTorch port.

Activations are NHWC tensors (B, H, W, C), as in the JAX package, and every
function keeps the JAX package's rounding points (its ``models/layers.py``):
statistics and accumulations run in float32 and the result is cast back to
the activation dtype once. Weights stay float32 in the modules and are cast
to the activation dtype where they enter a product. On the card, f32 ops run
with TF32 off (``ops.precision``), so the f32 path is true f32. The NHWC
layer functions (``layer_norm``, ``linear``, ``conv2d``, ``drop_path``) are
``ops/nhwc.py``'s, re-exported here.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audioset_convnext_inf_torch.ops.nhwc import (  # noqa: F401 (the layer functions)
    conv2d,
    drop_path,
    layer_norm,
    linear,
)


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


@torch.no_grad()
def init_conv_(conv: nn.Module, generator: torch.Generator) -> None:
    """In place: truncated-normal weight (std 0.02), zero bias where there
    is one; the JAX package's ``init_conv`` and ``init_linear``."""
    conv.weight.copy_(trunc_normal(conv.weight.shape, generator))
    if conv.bias is not None:
        conv.bias.zero_()


init_linear_ = init_conv_


@torch.no_grad()
def init_layer_norm_(norm: nn.Module) -> None:
    """In place: weight 1, bias 0 (the JAX package's ``init_layer_norm``)."""
    norm.weight.fill_(1.0)
    norm.bias.zero_()


@torch.no_grad()
def init_batch_norm_(norm: nn.Module) -> None:
    """In place: weight 1, bias 0, running mean 0, running variance 1 (the
    JAX package's ``init_batch_norm``)."""
    init_layer_norm_(norm)
    norm.running_mean.zero_()
    norm.running_var.fill_(1.0)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch's ``nn.GELU()`` default."""
    return F.gelu(x, approximate="none")


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
