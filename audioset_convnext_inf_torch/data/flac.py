"""FLAC decoding on the host: the port's own build of ``csrc/flac_decode.cpp``.

The JAX package decodes FLAC through its native library
(``utils/native.py:242-314`` over ``native/flac_decode.cpp``); the port keeps
a copy of that decoder and builds it itself, with the host C++ compiler
(``CXX``, else ``g++`` or ``c++`` on ``PATH``), at first use, into
``build/host_libs/`` at the root of the checkout. The library's name
carries a hash of the source and the flags, as the kernels' do
(``ops/_build.py``). The build runs under an ``fcntl`` lock on a file beside
it and links to a temporary name that ``os.replace`` moves into place, so
processes that start together (pytest workers, loader processes) wait for
one build and never see a half-written library.

A stream that cannot be decoded raises, and so does a missing compiler or a
failed build: there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flac_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_libs"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


class _FlacInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int64),
        ("channels", ctypes.c_int64),
        ("bits", ctypes.c_int64),
        ("frames", ctypes.c_int64),
    ]


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler (CXX, g++, c++): cannot build the FLAC decoder")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"libflac_decode_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/flac_decode.cpp`` unless its library is built already."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
        if out.exists():
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building the FLAC decoder failed:\n{proc.stderr[-4000:]}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i64 = ctypes.c_int64
            lib.flac_info.argtypes = [u8p, i64, ctypes.POINTER(_FlacInfo)]
            lib.flac_info.restype = ctypes.c_int
            lib.flac_decode.argtypes = [u8p, i64, f32p, i64, ctypes.c_int, ctypes.POINTER(i64)]
            lib.flac_decode.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def decode_flac_bytes(buf: bytes, mono: bool = True) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (float32 waveform in [-1, 1), sample rate): (frames,)
    with ``mono`` (the channel mean), else (frames, channels). CONSTANT /
    VERBATIM / FIXED / LPC subframes, Rice methods 0 and 1 with escapes,
    wasted bits, L-S / R-S / M-S stereo, CRC-8 and CRC-16 verified. Raises
    ``ValueError`` on a malformed or unsupported stream, including one whose
    STREAMINFO does not give its total sample count."""
    lib = _load()
    arr = np.frombuffer(buf, np.uint8)
    info = _FlacInfo()
    rc = lib.flac_info(arr, arr.size, ctypes.byref(info))
    if rc != 0:
        raise ValueError(f"not a FLAC stream (header error {rc})")
    if info.frames <= 0:
        raise ValueError("FLAC stream with an unknown total sample count")
    # STREAMINFO's 36-bit total is the stream's own claim: bound it by what
    # the bytes could encode before allocating. The densest legal coding is
    # a CONSTANT subframe per channel, >= ~10 bytes of frame header and CRCs
    # plus >= ~2 bytes per channel for each frame of <= 65536 samples.
    min_frame_bytes = 10 + 2 * max(int(info.channels), 1)
    if info.frames > (arr.size // min_frame_bytes + 1) * 65536:
        raise ValueError(f"FLAC header claims {info.frames} samples, more than "
                         f"{arr.size} bytes can hold")
    shape = (info.frames,) if mono else (info.frames, info.channels)
    out = np.empty(shape, np.float32)
    got = ctypes.c_int64(0)
    rc = lib.flac_decode(arr, arr.size, out.reshape(-1), info.frames, 1 if mono else 0,
                         ctypes.byref(got))
    if rc != 0:
        raise ValueError(f"malformed FLAC stream (decode error {rc})")
    return out[: int(got.value)], int(info.sample_rate)
