"""Waveform augmentations (reference pytorch/augmentations.py), the port's
counterpart of the JAX package's ``ops/augment.py``:

 - ``crop`` / ``pad`` with their four alignments (augmentations.py:16-203),
   and ``pad_or_truncate``;
 - ``resample_nearest_indices`` and ``resample`` (the Resample class,
   :243-275): ``nearest`` gathers round(i / rate); ``linear`` is
   ``resample_linear``, torchaudio's windowed-sinc polyphase resampling
   (``sinc_resample_kernel``'s bank, one product of the framed signal);
 - the training path's random gain, circular roll and speed perturbation
   (:278-351).

Randomness is a draw (``draw_*``, from a ``torch.Generator``) and an apply
that takes the drawn value, so a caller can hand in draws made elsewhere.
Each draw is one value for the whole batch, as in the JAX package. Every op
runs where its input tensor lives.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from audioset_convnext_inf_torch.device import resolve_device

ALIGNS = ("left", "right", "center", "random")


def draw_crop_start(generator: torch.Generator, length: int, target_length: int) -> int:
    """``align="random"``'s crop start, uniform on [0, length - target_length)."""
    diff = length - target_length
    return int(torch.randint(0, diff, (), generator=generator)) if diff > 0 else 0


def draw_pad_left(generator: torch.Generator, length: int, target_length: int) -> int:
    """``align="random"``'s left padding, uniform on [0, target_length - length]."""
    missing = max(target_length - length, 0)
    return int(torch.randint(0, missing + 1, (), generator=generator))


def crop(x: torch.Tensor, target_length: int, align: str = "left",
         start: Optional[int] = None) -> torch.Tensor:
    """Crop the trailing axis to ``target_length`` (x as it is when it is
    not longer). ``align="random"`` takes ``start`` from ``draw_crop_start``."""
    length = x.shape[-1]
    if length <= target_length:
        return x
    diff = length - target_length
    if align == "left":
        start = 0
    elif align == "right":
        start = diff
    elif align == "center":
        start = diff // 2 + diff % 2
    elif align == "random":
        if start is None:
            raise ValueError("align='random' takes the start drawn by draw_crop_start")
        if not 0 <= start < diff:
            raise ValueError(f"crop start {start} outside [0, {diff})")
    else:
        raise ValueError(f"unknown align {align!r}; must be one of {ALIGNS}")
    return x[..., start:start + target_length]


def pad(x: torch.Tensor, target_length: int, align: str = "left", fill_value: float = 0.0,
        left: Optional[int] = None) -> torch.Tensor:
    """Pad the trailing axis to ``target_length`` with ``fill_value`` (x as
    it is when it is not shorter). ``align="random"`` takes ``left`` from
    ``draw_pad_left``."""
    missing = max(target_length - x.shape[-1], 0)
    if missing == 0:
        return x
    if align == "left":
        left = 0
    elif align == "right":
        left = missing
    elif align == "center":
        left = missing // 2 + missing % 2
    elif align == "random":
        if left is None:
            raise ValueError("align='random' takes the left padding drawn by draw_pad_left")
        if not 0 <= left <= missing:
            raise ValueError(f"left padding {left} outside [0, {missing}]")
    else:
        raise ValueError(f"unknown align {align!r}; must be one of {ALIGNS}")
    return torch.nn.functional.pad(x, (left, missing - left), value=fill_value)


def pad_or_truncate(x: torch.Tensor, target_length: int) -> torch.Tensor:
    """Zero-pad the tail or keep the first ``target_length`` samples
    (utilities.py:230-235)."""
    return crop(pad(x, target_length), target_length)


def resample_nearest_indices(length: int, rate, out_length: int, device=None) -> torch.Tensor:
    """round(i / rate) for i < out_length, int32, on ``rate``'s device when
    it is a tensor, else on ``device`` (the card unless given). ``length``
    is the source length the caller clips or masks against, as in the JAX
    package, which leaves it to the caller."""
    if isinstance(rate, torch.Tensor):
        device = rate.device
        rate = rate.to(torch.float32)
    else:
        device = resolve_device(device)
        rate = torch.tensor(rate, dtype=torch.float32, device=device)
    i = torch.arange(out_length, dtype=torch.float32, device=device)
    return torch.round(i / rate).to(torch.int32)


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


def _sinc_resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                          rolloff: float = 0.99) -> Tuple[torch.Tensor, int]:
    # the bank is a host constant, built in numpy as the JAX package builds it
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_freq, new_freq = int(orig_freq) // g, int(new_freq) // g
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t *= np.pi
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels *= window * (base_freq / orig_freq)
    return torch.from_numpy(kernels.astype(np.float32)), width


@lru_cache(maxsize=32)
def sinc_resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                         rolloff: float = 0.99) -> Tuple[torch.Tensor, int]:
    """The polyphase windowed-sinc bank of torchaudio's sinc_interp_hann (the
    backend of the Resample class's "linear" mode, augmentations.py:253-258).
    For gcd-reduced rates, phase p samples the reconstruction at
    t = -p / new_freq from each input frame:

        w(t) = scale * sinc(pi f_c t) * cos(pi f_c t / (2 W))^2,
        f_c = rolloff * min(orig, new), |f_c t| <= W, scale = f_c / orig

    Returns (bank (new_freq, 2 * width + orig_freq) f32 on the CPU, width):
    built in f64 in numpy, stored in f32, and cached per rate pair (callers
    cache only small banks, ``_cacheable_bank``)."""
    return _sinc_resample_kernel(orig_freq, new_freq, lowpass_filter_width, rolloff)


def _cacheable_bank(orig_freq: int, new_freq: int, lowpass_filter_width: int, rolloff: float,
                    max_elems: int = 2_000_000) -> bool:
    """Whether the gcd-reduced bank is small enough (<= ~8 MB of f32) to pin
    in ``sinc_resample_kernel``'s cache: a continuously drawn rate is nearly
    coprime with the source rate, and its bank is GB-sized."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    return new_freq * (2 * width + orig_freq) <= max_elems


def resample_linear(x: torch.Tensor, rate: float, sample_rate: int = 32000,
                    lowpass_filter_width: int = 6, rolloff: float = 0.99,
                    quantize_hz: Optional[int] = None) -> torch.Tensor:
    """The Resample class's "linear" mode (augmentations.py:244-258): from
    ``sample_rate`` to ``int(sample_rate * rate)`` with torchaudio's
    windowed-sinc polyphase filter (width 6, rolloff 0.99), ceil(L * new /
    orig) samples out, along the trailing axis of a 1-D or 2-D tensor. The
    work is one product in f64 on x's device: the padded signal framed at
    stride orig_freq against the (new_freq, taps) bank. ``quantize_hz``
    rounds the target rate to a multiple of it (100: a bank of <= ~2 MB,
    the rate within 0.16%), the setting for random-rate loops; None keeps
    the reference's exact rate."""
    orig_freq = int(sample_rate)
    new_freq = int(sample_rate * rate)
    if quantize_hz:
        new_freq = max(quantize_hz, int(round(new_freq / quantize_hz)) * quantize_hz)
    if new_freq <= 0:
        raise ValueError(f"rate {rate} yields a non-positive target rate")
    g = math.gcd(orig_freq, new_freq)
    orig_freq, new_freq = orig_freq // g, new_freq // g
    if orig_freq == new_freq:
        return x.to(torch.float32)
    make_bank = (sinc_resample_kernel
               if _cacheable_bank(orig_freq, new_freq, lowpass_filter_width, rolloff)
               else _sinc_resample_kernel)  # a big bank is built for this call only
    kernels, width = make_bank(orig_freq, new_freq, lowpass_filter_width, rolloff)
    xb = x.reshape(-1, x.shape[-1]).to(torch.float64)
    length = xb.shape[-1]
    target_length = math.ceil(new_freq * length / orig_freq)
    padded = torch.nn.functional.pad(xb, (width, width + orig_freq))
    frames = padded.unfold(-1, kernels.shape[1], orig_freq)  # (n, frames, taps)
    out = torch.matmul(frames, kernels.to(device=x.device, dtype=torch.float64).t())
    out = out.reshape(xb.shape[0], -1)[:, :target_length].to(torch.float32)
    return out[0] if x.ndim == 1 else out


def resample(x: torch.Tensor, rate: float, interpolation: str = "nearest",
             sample_rate: int = 32000) -> torch.Tensor:
    """Resample.process at a given rate (augmentations.py:243-263):
    ``nearest`` gathers round(i / rate) for i on arange(0, L, 1 / rate);
    ``linear`` is ``resample_linear`` at the exact rate. Drawing the rate
    and the apply probability is the caller's."""
    if interpolation == "nearest":
        length = x.shape[-1]
        pos = torch.arange(0, length, 1.0 / rate, dtype=torch.float64, device=x.device)
        idx = torch.clamp(torch.round(pos).to(torch.int64), max=length - 1)
        return torch.index_select(x, -1, idx)
    if interpolation == "linear":
        return resample_linear(x, rate, sample_rate)
    raise ValueError(f"invalid interpolation {interpolation!r}; must be one of "
                     "('nearest', 'linear')")
