"""Host-side audio I/O and sample-format utilities.

The port's counterpart of the JAX package's ``data/audio_io.py``. int16 <->
float32 with the reference's scaling (utilities.py:220-227), WAV parsing
and decode, and polyphase resampling (scipy.signal.resample_poly's Kaiser
design, the upfirdn loop in C++) run in the port's host library
(``utils/native.py`` over ``csrc/audio_host.cpp``); the int16 decode
multiplies by the f32 constant ``np.float32(INT16_SCALE)``, bit-identical to
the card's (``ops/pcm.py``). FLAC (``read_flac``, and ``read_audio`` for
either format) decodes through the port's FLAC library (``data/flac.py``).
Nothing falls back to numpy or scipy: a failed build or a stream the
parsers do not support raises.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def float32_to_int16(x: np.ndarray) -> np.ndarray:
    """Clip to [-1, 1], scale by 32767 in f32 and truncate (utilities.py:220-223)."""
    from audioset_convnext_inf_torch.utils import native

    return native.float32_to_int16(np.asarray(x))


def int16_to_float32(x: np.ndarray) -> np.ndarray:
    """x * (1/32767) in f32 (utilities.py:226-227)."""
    from audioset_convnext_inf_torch.utils import native

    return native.int16_to_float32(np.asarray(x))


def pad_or_truncate(x: np.ndarray, audio_length: int) -> np.ndarray:
    """Zero-pad the tail or crop to exactly ``audio_length`` samples
    (utilities.py:230-235)."""
    if len(x) <= audio_length:
        return np.concatenate((x, np.zeros(audio_length - len(x), dtype=x.dtype)))
    return x[:audio_length]


def pad_audio(x: np.ndarray, audio_length: int) -> np.ndarray:
    """Zero-pad to at least ``audio_length`` without cropping
    (utilities.py:238-243)."""
    if len(x) <= audio_length:
        return np.concatenate((x, np.zeros(audio_length - len(x), dtype=x.dtype)))
    return x


def decimate_resample(waveform: np.ndarray, sample_rate: int) -> np.ndarray:
    """Stride decimation 32k -> {32k, 16k, 8k} (data_generator.py:107-123)."""
    if sample_rate == 32000:
        return waveform
    if sample_rate == 16000:
        return waveform[0::2]
    if sample_rate == 8000:
        return waveform[0::4]
    raise ValueError("Incorrect sample rate! (must be 8000/16000/32000)")


def resample_poly(waveform: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling with scipy.signal.resample_poly's Kaiser-windowed
    lowpass along axis 0, the loop in the host library with f64 sums."""
    if orig_sr == target_sr:
        return waveform.astype(np.float32, copy=False)
    from audioset_convnext_inf_torch.utils import native

    g = math.gcd(int(orig_sr), int(target_sr))
    return native.resample_poly_kaiser(waveform, target_sr // g, orig_sr // g)


def normalize_pcm(data: np.ndarray, mono: bool = True) -> np.ndarray:
    """PCM samples of any WAV dtype -> float32 in [-1, 1], optionally mono."""
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if mono and x.ndim > 1:
        x = x.mean(axis=1)
    return x


def read_wav(path: str, target_sr: int | None = None, mono: bool = True) -> Tuple[np.ndarray, int]:
    """A WAV file -> (float32 waveform in [-1, 1], sample rate), optionally
    down-mixed to mono (the channel mean) and resampled to ``target_sr``.
    PCM 8/16/24/32 and IEEE float, WAVE_FORMAT_EXTENSIBLE too; another
    format raises ``ValueError``."""
    from audioset_convnext_inf_torch.utils import native

    with open(path, "rb") as f:
        raw = f.read()
    try:
        x, sr = native.decode_wav_bytes(raw, mono=mono)
    except ValueError as e:
        raise ValueError(f"cannot decode WAV {path!r}: {e}") from e
    if target_sr is not None and sr != target_sr:
        x = resample_poly(x, sr, target_sr)
        sr = target_sr
    return x, sr


def read_flac(path: str, target_sr: int | None = None, mono: bool = True) -> Tuple[np.ndarray, int]:
    """A FLAC file -> (float32 waveform in [-1, 1), sample rate), optionally
    resampled to ``target_sr`` (the JAX package's ``data/audio_io.py:131``).
    The reference reads AudioSet and AudioCaps clips through libsndfile
    (utils/dataset.py:202); here the port's decoder (``data/flac.py``)
    reads them, and raises on a malformed stream."""
    from audioset_convnext_inf_torch.data.flac import decode_flac_bytes

    with open(path, "rb") as f:
        raw = f.read()
    try:
        x, sr = decode_flac_bytes(raw, mono=mono)
    except ValueError as e:
        raise ValueError(f"cannot decode FLAC {path!r}: {e}") from e
    if target_sr is not None and sr != target_sr:
        x = resample_poly(x, sr, target_sr)
        sr = target_sr
    return x, sr


def read_audio(path: str, target_sr: int | None = None, mono: bool = True) -> Tuple[np.ndarray, int]:
    """WAV or FLAC by the file's magic (the JAX package's
    ``data/audio_io.py:157``): ``fLaC`` reads as FLAC, ``RIFF`` as WAV, and
    a file with neither goes by its extension (``.flac`` as FLAC, which then
    raises; anything else as WAV)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC" or (magic != b"RIFF" and path.lower().endswith(".flac")):
        return read_flac(path, target_sr=target_sr, mono=mono)
    return read_wav(path, target_sr=target_sr, mono=mono)
