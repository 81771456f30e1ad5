"""Mutations of valid FLAC and WAV streams for fuzzing the port's host
decoders: the families and seeds of ``tests/test_fuzz_decoders.py``, drawn
in its order, so that the same mutated bytes reach both packages'
decoders. Imports neither JAX nor a package named ``tests``: the smoke
run loads this file by its path, as it loads ``flac_encoder.py``.
"""

from __future__ import annotations

import importlib.util
import struct
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

Mutation = Tuple[str, bytes]


def _encoder():
    spec = importlib.util.spec_from_file_location(
        "flac_encoder", Path(__file__).resolve().parent / "flac_encoder.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def smooth_int16(n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 320.0
    return np.round(8000 * np.sin(2 * np.pi * t) + 300 * rng.randn(n)).astype(np.int64)


def valid_flac() -> bytes:
    """3000 samples, 16-bit mono, FIXED order-2 subframes, 1024-sample blocks."""
    return _encoder().encode_flac(smooth_int16(3000, seed=7), 32000, bps=16, blocksize=1024,
                                  kind="fixed", order=2)


def valid_wav() -> bytes:
    """2000 samples of 16-bit mono PCM at 32 kHz."""
    sr, n = 32000, 2000
    data = (np.sin(np.arange(n) / 50.0) * 12000).astype(np.int16).tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    return hdr + fmt + b"data" + struct.pack("<I", len(data)) + data


def byte_flips(buf: bytes, count: int, seed: int) -> Iterator[bytes]:
    """One byte XORed with a non-zero value, ``count`` times."""
    rng = np.random.RandomState(seed)
    for _ in range(count):
        mutated = bytearray(buf)
        pos = int(rng.randint(0, len(buf)))
        mutated[pos] ^= int(rng.randint(1, 256))
        yield bytes(mutated)


def multi_byte(buf: bytes, count: int, seed: int) -> Iterator[bytes]:
    """2-15 bytes overwritten with random values, ``count`` times."""
    rng = np.random.RandomState(seed)
    for _ in range(count):
        mutated = bytearray(buf)
        for _ in range(int(rng.randint(2, 16))):
            mutated[int(rng.randint(0, len(mutated)))] = int(rng.randint(0, 256))
        yield bytes(mutated)


def truncations(buf: bytes, step: int) -> Iterator[bytes]:
    """Every cut in the first 64 bytes, then every ``step`` bytes."""
    for cut in list(range(0, min(64, len(buf)))) + list(range(64, len(buf), step)):
        yield buf[:cut]


def flac_garbage(seed: int = 2) -> Iterator[Tuple[int, bytes]]:
    """(size, random bytes) of 8 sizes, then 50 blobs of b"fLaC" + 200
    random bytes (size -1: they keep the magic)."""
    rng = np.random.RandomState(seed)
    for size in (0, 1, 3, 4, 41, 42, 128, 4096):
        yield size, rng.bytes(size)
    for _ in range(50):
        yield -1, b"fLaC" + rng.bytes(200)


def flac_huge_total(buf: bytes) -> bytes:
    """STREAMINFO (bytes 8-41) claiming 2^36 - 1 samples: the low nibble of
    byte 21 and bytes 22-25 set."""
    mutated = bytearray(buf)
    mutated[21] |= 0x0F
    mutated[22] = mutated[23] = mutated[24] = mutated[25] = 0xFF
    return bytes(mutated)


def wav_absurd_geometry(buf: bytes) -> Iterator[Mutation]:
    """0 channels, 0 bits per sample (both must be refused), and a data
    chunk claiming 0xFFFFFFF0 bytes (clamped to the buffer)."""
    for label, off in (("channels", 22), ("bits", 34)):
        mutated = bytearray(buf)
        mutated[off:off + 2] = struct.pack("<H", 0)
        yield f"0 {label}", bytes(mutated)
    mutated = bytearray(buf)
    pos = bytes(mutated).index(b"data")
    mutated[pos + 4:pos + 8] = struct.pack("<I", 0xFFFFFFF0)
    yield "huge data chunk", bytes(mutated)


def well_formed(out, n_bytes: int) -> None:
    """A mono decode's (waveform, sample rate): a 1-D float32 array of no
    more samples than ``n_bytes`` can encode (65536 per 12 bytes, the
    densest legal FLAC frame: the bound both decoders check before they
    allocate), and an int rate."""
    y, sr = out
    assert isinstance(y, np.ndarray) and y.dtype == np.float32 and y.ndim == 1, (type(y), y.dtype)
    assert y.size <= (n_bytes // 12 + 1) * 65536, (y.size, n_bytes)
    assert isinstance(sr, int)
