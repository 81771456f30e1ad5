"""Waveform augmentations of the training path (reference
pytorch/augmentations.py): random gain, circular roll and speed
perturbation. Each is a draw (``draw_*``, from a ``torch.Generator``) and
an apply, so a caller can hand in draws made elsewhere. Each draw is one
value for the whole batch, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


def draw_gain(generator: torch.Generator, gain_db: int = 7) -> int:
    """Integer gain in dB, uniform on [-gain_db, gain_db)."""
    return int(torch.randint(0, 2 * gain_db, (), generator=generator)) - gain_db


def gain_augment(x: torch.Tensor, gain: int) -> torch.Tensor:
    """"pydub" gain (augmentations.py:336-341): x * 10^(gain/20), the
    amplitude computed in f32 and taken in x's dtype."""
    amp = torch.pow(torch.tensor(10.0), torch.tensor(float(gain)) / 20.0)
    return x * amp.to(device=x.device, dtype=x.dtype)


def draw_roll(generator: torch.Generator, shift_range: int = 50) -> int:
    """Circular shift uniform on [-shift_range, shift_range)."""
    return int(torch.randint(-shift_range, shift_range, (), generator=generator))


def roll_augment(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Circular shift along the trailing (time) axis (augmentations.py:344-351)."""
    return torch.roll(x, shift, dims=-1)


class SpeedDraw(NamedTuple):
    rate: float      # stretch factor, f32 value
    pad_left: int    # zeros before the stretched signal when it is shorter
    crop_start: int  # first stretched sample kept when it is longer
    apply: bool      # whether this batch is perturbed at all


def _stretched_len(length: int, rate: float) -> int:
    return int(torch.ceil(torch.tensor(length, dtype=torch.float32)
                          * torch.tensor(rate, dtype=torch.float32)))


def draw_speed(generator: torch.Generator, length: int,
               rates: Tuple[float, float] = (0.5, 1.5), p: float = 0.5) -> SpeedDraw:
    """rate ~ U(rates); pad offset ~ U{0..missing}; crop start ~
    U{0..diff-1}; applied with probability p (SpeedPerturbation's
    align='random' defaults)."""
    apply = float(torch.rand((), generator=generator)) <= p
    u = torch.rand((), generator=generator)
    rate = float(rates[0] + u * (rates[1] - rates[0]))
    stretched = _stretched_len(length, rate)
    missing, diff = max(length - stretched, 0), max(stretched - length, 0)
    pad_left = int(torch.randint(0, missing + 1, (), generator=generator))
    crop_start = int(torch.randint(0, max(diff, 1), (), generator=generator))
    return SpeedDraw(rate, pad_left, crop_start, apply)


def speed_perturb(x: torch.Tensor, draw: SpeedDraw) -> torch.Tensor:
    """Speed perturbation with a same-length output (augmentations.py:
    278-329): the nearest-neighbour stretch by ``rate``, then pad or crop
    back to the input length at the drawn offset. Output sample i reads
    stretched sample j = i - pad_left + crop_start, zero outside
    [0, ceil(L * rate)); stretched[j] = x[clip(round(j / rate), 0, L - 1)]."""
    if not draw.apply:
        return x
    length = x.shape[-1]
    rate = torch.tensor(draw.rate, dtype=torch.float32, device=x.device)
    j = torch.arange(length, dtype=torch.int32, device=x.device) - draw.pad_left + draw.crop_start
    valid = (j >= 0) & (j < _stretched_len(length, draw.rate))
    src = torch.clamp(torch.round(j.float() / rate).to(torch.int64), 0, length - 1)
    return torch.index_select(x, -1, src) * valid.to(x.dtype)
