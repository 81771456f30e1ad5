"""Kaldi-compatible log mel-filterbank features, on the input tensor's device.

The port's counterpart of the JAX package's ``ops/kaldi_fbank.py``. The
reference's optional ``use_torchaudio`` mode computes
``torchaudio.compliance.kaldi.fbank(htk_compat=True, sample_frequency=32000,
use_energy=False, window_type='hanning', num_mel_bins=224, dither=0.0,
frame_length=64.0, frame_shift=10.0)`` in the dataset worker
(data_generator.py:75-97) and feeds the model spectrogram images
(convnext.py:176-177, 297-299). This is that fbank from the Kaldi
specification:

 - snip_edges framing (no centring): T = 1 + (N - frame_len) // shift, 994
   frames for a 10-s 32-kHz clip;
 - per-frame DC removal, pre-emphasis 0.97 (the first sample of a frame
   emphasised against itself, Kaldi's edge rule);
 - the symmetric hanning, hamming or povey window (f32 values), the power
   spectrum of an rfft zero-padded to a power of two (``torch.fft.rfft``);
 - the HTK-scale mel bank from 20 Hz to Nyquist, unnormalized, in one
   product (f32, TF32 off);
 - the natural log, clamped at float32's eps.

Framing through the power spectrum runs in f64 and rounds to f32 before
the mel product. Pre-emphasis leaves the lowest mel bins of a clip within
a few eps of the clamp, where an f32 FFT's rounding moves the log by up to
3e-3 (two f32 FFTs, measured on seeded noise); in f64 the card and the host
agree there, and the port stays within 6e-4 of the JAX package's f32 FFT.

The AudioSet dataset computes it on the host, per clip, on CPU tensors
(``data/hdf5_dataset.py``), where the reference and the JAX package do.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from audioset_convnext_inf_torch.ops.precision import fp32_precision

_EPS = 1.1920928955078125e-07  # float32 eps: Kaldi's clamp as torchaudio applies it


def _hz_to_htk_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


@lru_cache(maxsize=8)
def _kaldi_mel_banks(num_bins: int, padded_window: int, sample_rate: int,
                     low_freq: float = 20.0, high_freq: float = 0.0) -> torch.Tensor:
    """Kaldi's MelBanks: triangles in HTK mel space, (num_bins,
    padded_window // 2 + 1) f32 on the CPU. Kaldi leaves out the Nyquist bin
    (it has padded_window / 2 columns); its column here is zero."""
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    num_fft_bins = padded_window // 2
    fft_bin_width = sample_rate / padded_window
    mel_low = _hz_to_htk_mel(low_freq)
    mel_high = _hz_to_htk_mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bins = np.zeros((num_bins, num_fft_bins + 1), np.float64)
    mel = _hz_to_htk_mel(fft_bin_width * np.arange(num_fft_bins))
    for j in range(num_bins):
        left = mel_low + j * mel_delta
        center = mel_low + (j + 1) * mel_delta
        right = mel_low + (j + 2) * mel_delta
        up = (mel - left) / (center - left)
        down = (right - mel) / (right - center)
        bins[j, :num_fft_bins] = np.clip(np.minimum(up, down), 0.0, None)
    return torch.from_numpy(bins.astype(np.float32))


def _window(window_type: str, frame_len: int, device) -> torch.Tensor:
    n = torch.arange(frame_len, dtype=torch.float64, device=device)
    if window_type in ("hanning", "hamming"):
        a, b = (0.5, 0.5) if window_type == "hanning" else (0.54, 0.46)  # np.hanning, np.hamming
        win = a - b * torch.cos(2 * math.pi * n / (frame_len - 1))
    elif window_type == "povey":
        win = (0.5 - 0.5 * torch.cos(2 * math.pi * n / (frame_len - 1))) ** 0.85
    else:
        raise ValueError(f"unsupported window_type {window_type!r}")
    return win.to(torch.float32).to(torch.float64)


def kaldi_fbank(
    waveform: torch.Tensor,
    sample_rate: int = 32000,
    num_mel_bins: int = 224,
    frame_length_ms: float = 64.0,
    frame_shift_ms: float = 10.0,
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
    window_type: str = "hanning",
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> torch.Tensor:
    """(N,) or (B, N) float waveform -> (T, num_mel_bins) or (B, T, bins),
    f32, on the waveform's device."""
    squeeze = waveform.ndim == 1
    x = torch.atleast_2d(waveform.to(torch.float32)).to(torch.float64)
    frame_len = int(sample_rate * frame_length_ms / 1000.0)
    shift = int(sample_rate * frame_shift_ms / 1000.0)
    padded = 1 << (frame_len - 1).bit_length()  # the next power of two

    num_frames = max(0, 1 + (x.shape[-1] - frame_len) // shift)
    if num_frames == 0:  # shorter than one frame: no frames, as the JAX function gives
        frames = x.new_zeros((x.shape[0], 0, frame_len))
    else:
        frames = x.unfold(-1, frame_len, shift)[:, :num_frames]  # (B, T, frame_len)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    frames = frames * _window(window_type, frame_len, x.device)

    if num_frames:
        spec = torch.fft.rfft(frames, n=padded, dim=-1)
        power = (spec.real ** 2 + spec.imag ** 2).to(torch.float32)
    else:  # the FFT libraries refuse an empty batch
        power = frames.new_zeros((x.shape[0], 0, padded // 2 + 1), dtype=torch.float32)
    banks = _kaldi_mel_banks(num_mel_bins, padded, sample_rate, low_freq, high_freq)
    with fp32_precision("highest"):
        mel = torch.matmul(power, banks.to(x.device).t())
    out = torch.log(torch.clamp(mel, min=_EPS))
    return out[0] if squeeze else out
