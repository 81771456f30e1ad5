"""The port's NHWC layer functions and the unfused ConvNeXt block built
from them.

Activations are NHWC tensors (B, H, W, C), as in the JAX package, and each
function keeps the JAX package's rounding points (its ``models/layers.py``):
statistics and accumulations run in float32 and the result is cast back to
the activation dtype. Weights stay float32 and are cast to the activation
dtype where they enter a product. ``models/layers.py`` re-exports the layer
functions; they live here, beside ``ops/precision.py``, so that the fused
block op (``ops/fused_block.py``), whose unfused-rounding mode runs
``convnext_block`` on the CPU, needs nothing of ``models/``: a serving
bundle loads without it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from audioset_convnext_inf_torch.ops.precision import fp32_precision, mm_f32acc


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


def convnext_block(
    x: torch.Tensor,
    dw_w: torch.Tensor,
    dw_b: torch.Tensor,
    ln_w: torch.Tensor,
    ln_b: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gamma: Optional[torch.Tensor],
    eps: float = 1e-6,
    approximate: str = "tanh",
    drop_scale: Optional[torch.Tensor] = None,
    saves: bool = False,
):
    """One ConvNeXt block (reference convnext.py:58-87) op by op, weights in
    the reference layouts: the JAX package's ``_block_apply``. In bf16 it
    rounds where those ops round: the depthwise sum, then with its bias;
    the LN output; the first product plus its bias, then the GELU; the
    second product plus its bias, then times bf16 gamma; the product with
    the bf16 drop-path scale; the residual sum. ``approximate``: "tanh" or
    "none" (erf) GELU; ``drop_scale`` (B,) the block's drop-path draw.
    ``models/convnext.py::_block_apply`` and the CPU legs of K1's
    unfused-rounding modes run this function. With ``saves`` it returns
    (y, d, z): d, the depthwise output with its bias (what the LN reads),
    and z, the second product with its bias (what gamma multiplies), the
    two tensors the fused backward's unfused-rounding mode reads."""
    shortcut = x
    d = conv2d(x, dw_w, dw_b, padding=(3, 3), groups=x.shape[-1])
    x = layer_norm(d, ln_w, ln_b, eps)
    x = linear(x, w1, b1)
    x = F.gelu(x, approximate=approximate)
    z = linear(x, w2, b2)
    x = z * gamma.to(z.dtype) if gamma is not None else z
    y = shortcut + drop_path(x, drop_scale)
    return (y, d, z) if saves else y
