"""SpecAugment: per-sample time and frequency stripe dropout.

The behaviour of torchlibrosa's ``SpecAugmentation`` (reference
convnext.py:203-210, 308-309): for each sample and stripe, width ~
U{0..drop_width-1}, begin = floor(u * (size - width)) with u ~ U[0, 1), and
``x[..., begin:begin+width, ...]`` is zeroed along the axis. Time stripes
are drawn and applied first, then frequency stripes. Each step splits into
a draw (``draw_stripes``) and an apply (``_drop_stripes``), so a caller can
hand in draws made elsewhere.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from audioset_convnext_inf_torch.config import SpecAugmentConfig

Stripes = Tuple[torch.Tensor, torch.Tensor]  # widths (B, n) int, u (B, n) f32


def draw_stripes(generator: torch.Generator, batch: int, drop_width: int,
                 stripes_num: int) -> Stripes:
    """(widths, u) for ``batch`` samples, on the generator's device."""
    dev = generator.device
    widths = torch.randint(0, drop_width, (batch, stripes_num), generator=generator, device=dev)
    u = torch.rand(batch, stripes_num, generator=generator, device=dev)
    return widths, u


def _drop_stripes(x: torch.Tensor, axis: int, stripes: Stripes) -> torch.Tensor:
    """Zero each sample's stripes along ``axis``."""
    widths, u = (t.to(x.device) for t in stripes)
    b, size = x.shape[0], x.shape[axis]
    begins = torch.floor(u.float() * (size - widths).float()).to(torch.int32)
    pos = torch.arange(size, device=x.device, dtype=torch.int32)[None, None, :]
    in_stripe = (pos >= begins[..., None]) & (pos < (begins + widths)[..., None])
    keep = ~in_stripe.any(dim=1)  # (b, size)
    shape = [1] * x.ndim
    shape[0], shape[axis] = b, size
    return x * keep.reshape(shape).to(x.dtype)


def spec_augment(
    x: torch.Tensor,
    time_axis: int,
    freq_axis: int,
    cfg: SpecAugmentConfig = SpecAugmentConfig(),
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[Stripes, Stripes]] = None,
) -> torch.Tensor:
    """Time, then frequency stripe dropout (training only). ``draws`` =
    (time stripes, frequency stripes); otherwise drawn from ``generator``
    in that order."""
    if draws is None:
        b = x.shape[0]
        draws = (draw_stripes(generator, b, cfg.time_drop_width, cfg.time_stripes_num),
                 draw_stripes(generator, b, cfg.freq_drop_width, cfg.freq_stripes_num))
    x = _drop_stripes(x, time_axis, draws[0])
    return _drop_stripes(x, freq_axis, draws[1])
