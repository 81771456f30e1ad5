"""ctypes bindings for the port's host audio data plane (``csrc/audio_host.cpp``).

The port's counterpart of the JAX package's ``utils/native.py``: int16 <->
float32 with the reference's scaling (utilities.py:220-227), the fused
decode + pad/truncate of a batch, stride decimation (data_generator.py:
107-123), RIFF/WAVE parsing and decode, and the upfirdn loop of polyphase
resampling, in C++ with OpenMP. The library is the port's own build
(``utils/host_build.py``: the host compiler, ``-fopenmp``, linked against
``libgomp.so.1``, into ``build/host_libs/``), made at first use under a
file lock. FLAC decodes
through the port's other host library, ``data/flac.py``
(``decode_flac_bytes`` is re-exported here).

Every function runs the library. A failed build raises, and so does a
stream the parser does not support: nothing falls back. The numpy and scipy
versions (``*_reference``) are the plain versions the tests hold the
library against; no caller of the port reaches them.
"""

from __future__ import annotations

import ctypes
import functools
import io
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from audioset_convnext_inf_torch.config import INT16_SCALE
from audioset_convnext_inf_torch.data.flac import decode_flac_bytes  # noqa: F401  (re-export)
from audioset_convnext_inf_torch.utils import host_build

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "audio_host.cpp"
BUILD_DIR: Optional[Path] = None  # None: host_build.BUILD_DIR
# native/Makefile:2's flags: the object compiles with -fopenmp and links
# against the OpenMP runtime by its soname. A GCC install without its own
# libgomp compiles OpenMP code but cannot link through -fopenmp's spec file.
CXX_FLAGS = (*host_build.CXX_FLAGS, "-fopenmp")
LINK_FLAGS = ("-l:libgomp.so.1",)

# The library's `1.0f / 32767.0f` (audio_host.cpp) is this f32 constant:
# the plain versions multiply by it, so both give the same bits.
_INT16_SCALE = np.float32(INT16_SCALE)

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("bits_per_sample", ctypes.c_int32),
        ("format", ctypes.c_int32),
        ("frames", ctypes.c_int64),
        ("data_offset", ctypes.c_int64),
        ("data_bytes", ctypes.c_int64),
    ]


def library_path() -> Path:
    return host_build.library_path("audio_host", [SOURCE], CXX_FLAGS, BUILD_DIR, LINK_FLAGS)


def build() -> Path:
    """Compile ``csrc/audio_host.cpp`` unless its library is built already."""
    return host_build.build("audio_host", [SOURCE], CXX_FLAGS, "the host audio library",
                            BUILD_DIR, LINK_FLAGS)


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i64 = ctypes.c_int64
            lib.int16_to_float32.argtypes = [i16p, f32p, i64]
            lib.float32_to_int16.argtypes = [f32p, i16p, i64]
            lib.decode_batch_int16.argtypes = [i16p, i64, i64, f32p, i64]
            lib.decimate_int16_to_float32.argtypes = [i16p, i64, i64, f32p]
            lib.omp_thread_count.restype = ctypes.c_int
            lib.wav_info.argtypes = [u8p, i64, ctypes.POINTER(_WavInfo)]
            lib.wav_info.restype = ctypes.c_int
            lib.wav_decode.argtypes = [u8p, i64, ctypes.POINTER(_WavInfo), f32p, ctypes.c_int]
            lib.wav_decode.restype = ctypes.c_int
            lib.resample_upfirdn.argtypes = [f32p, i64, f64p, i64, i64, i64, f32p, i64]
            _LIB = lib
        return _LIB


def available() -> bool:
    """Build (if needed) and load the library: True. A failed build raises;
    there is no numpy fallback to be available instead."""
    _load()
    return True


def int16_to_float32(x: np.ndarray) -> np.ndarray:
    """x * (1/32767) in f32 (utilities.py:226-227)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty(x.shape, np.float32)
    lib.int16_to_float32(x.reshape(-1), out.reshape(-1), x.size)
    return out


def float32_to_int16(x: np.ndarray) -> np.ndarray:
    """Clip to [-1, 1], scale by 32767 in f32 and truncate (utilities.py:220-223)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.int16)
    lib.float32_to_int16(x.reshape(-1), out.reshape(-1), x.size)
    return out


def decode_batch_int16(x: np.ndarray, out_len: int) -> np.ndarray:
    """(N, L) int16 -> (N, out_len) float32: the decode and pad/truncate fused."""
    lib = _load()
    x = np.ascontiguousarray(x, np.int16)
    n, src_len = x.shape
    out = np.empty((n, out_len), np.float32)
    lib.decode_batch_int16(x, n, src_len, out, out_len)
    return out


def decimate_int16_to_float32(x: np.ndarray, stride: int) -> np.ndarray:
    """Every ``stride``-th int16 sample, decoded (data_generator.py:107-123)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty((len(x) + stride - 1) // stride, np.float32)
    lib.decimate_int16_to_float32(x, len(x), stride, out)
    return out


def decode_wav_bytes(buf: bytes, mono: bool = True) -> Tuple[np.ndarray, int]:
    """RIFF/WAVE bytes -> (float32 waveform in [-1, 1], sample rate): (frames,)
    with ``mono`` (the channel mean), else (frames, channels). PCM 8/16/24/32
    and IEEE float32/64, WAVE_FORMAT_EXTENSIBLE too. Raises ``ValueError``
    on anything else."""
    lib = _load()
    arr = np.frombuffer(buf, np.uint8)
    info = _WavInfo()
    rc = lib.wav_info(arr, arr.size, ctypes.byref(info))
    if rc != 0:
        raise ValueError(f"not a supported WAV stream (header error {rc})")
    shape = (info.frames,) if mono else (info.frames, info.channels)
    out = np.empty(shape, np.float32)
    rc = lib.wav_decode(arr, arr.size, ctypes.byref(info), out.reshape(-1), 1 if mono else 0)
    if rc != 0:
        raise ValueError(f"truncated WAV stream (decode error {rc})")
    return out, int(info.sample_rate)


def _kaiser_firwin(numtaps: int, cutoff: float, beta: float) -> np.ndarray:
    """scipy.signal.firwin(numtaps, cutoff, window=("kaiser", beta)) in
    numpy: the windowed sinc, normalized to unit DC gain."""
    n = np.arange(numtaps, dtype=np.float64)
    m = n - (numtaps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * m)
    h *= np.kaiser(numtaps, beta)
    return h / h.sum()


@functools.lru_cache(maxsize=16)
def _resample_filter(up: int, down: int) -> np.ndarray:
    max_rate = max(up, down)
    return _kaiser_firwin(2 * 10 * max_rate + 1, 1.0 / max_rate, 5.0) * up


def resample_poly_kaiser(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """scipy.signal.resample_poly(x, up, down) along axis 0 (its default
    Kaiser window, beta 5, half-length 10 * max(up, down)): the filter is
    designed here in f64, the upfirdn loop runs in the library with f64
    sums. A 2-D input is resampled column by column."""
    lib = _load()
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        return np.stack([resample_poly_kaiser(x[:, c], up, down) for c in range(x.shape[1])], 1)
    if x.ndim != 1:
        raise ValueError(f"resample_poly_kaiser takes 1-D or (frames, channels), got {x.shape}")
    x = np.ascontiguousarray(x)
    h = _resample_filter(int(up), int(down))
    ny = -(-x.shape[0] * up // down)
    out = np.empty(ny, np.float32)
    lib.resample_upfirdn(x, x.shape[0], h, h.size, up, down, out, ny)
    return out


# ---------------------------------------------------------------------------
# Plain versions: numpy and scipy, for the tests
# ---------------------------------------------------------------------------


def int16_to_float32_reference(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.int16).astype(np.float32) * _INT16_SCALE


def float32_to_int16_reference(x: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(x, np.float32), -1, 1) * np.float32(32767.0)).astype(np.int16)


def decode_batch_int16_reference(x: np.ndarray, out_len: int) -> np.ndarray:
    dec = int16_to_float32_reference(x)
    if dec.shape[1] >= out_len:
        return np.ascontiguousarray(dec[:, :out_len])
    return np.pad(dec, ((0, 0), (0, out_len - dec.shape[1])))


def decimate_int16_to_float32_reference(x: np.ndarray, stride: int) -> np.ndarray:
    return int16_to_float32_reference(np.asarray(x)[::stride])


def decode_wav_bytes_reference(buf: bytes, mono: bool = True) -> Tuple[np.ndarray, int]:
    """scipy.io.wavfile, scaled as the library scales each sample format."""
    from scipy.io import wavfile

    from audioset_convnext_inf_torch.data.audio_io import normalize_pcm

    sr, data = wavfile.read(io.BytesIO(buf))
    x = normalize_pcm(data, mono=mono)
    return (x[:, None] if x.ndim == 1 and not mono else x), int(sr)


def resample_poly_kaiser_reference(x: np.ndarray, up: int, down: int) -> np.ndarray:
    from scipy import signal

    return signal.resample_poly(np.asarray(x, np.float64), up, down, axis=0).astype(np.float32)
