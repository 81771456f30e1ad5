"""The port's host audio library (``utils/native.py`` over its own build of
``csrc/audio_host.cpp``) against the JAX package's native library
(``native/libaudiohost.so``, which the root conftest builds) and against the
numpy/scipy plain versions.

Tolerances: the int16 paths and WAV decode are bit-equal to the JAX
library, and to the plain versions (24- and 32-bit PCM within 1e-7, as the
JAX package's own ``tests/test_native.py`` holds them, though they come out
bit-equal too). The resampler is within 1e-6 of scipy's f64
``resample_poly`` and of the JAX library: the JAX Makefile adds
``-march=native`` and the port does not, so the two builds may contract
other multiply-adds into FMAs.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from audioset_convnext_inf_tpu.data import audio_io as JIO
from audioset_convnext_inf_tpu.utils import native as JN

from audioset_convnext_inf_torch.data import audio_io, flac
from audioset_convnext_inf_torch.utils import host_build
from audioset_convnext_inf_torch.utils import native as N

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "f62-S-v2swA_200000_210000.wav"


def _wav_bytes(data: np.ndarray, sr: int, bits: int, fmt: int = 1, extensible: bool = False) -> bytes:
    """A RIFF/WAVE file of ``data`` (int16 values; float for fmt 3)."""
    ch = 1 if data.ndim == 1 else data.shape[1]
    flat = data.reshape(-1)
    if fmt == 3:
        raw = flat.astype(np.float32 if bits == 32 else np.float64).tobytes()
    elif bits == 8:
        raw = ((flat.astype(np.int32) >> 8) + 128).astype(np.uint8).tobytes()
    elif bits == 16:
        raw = flat.astype(np.int16).tobytes()
    elif bits == 24:
        raw = b"".join(struct.pack("<i", int(v) << 8)[0:3] for v in flat)
    else:
        raw = (flat.astype(np.int64) << 16).astype(np.int32).tobytes()
    block = ch * bits // 8
    if extensible:
        fmt_body = struct.pack("<HHIIHHHHIH14s", 0xFFFE, ch, sr, sr * block, block, bits, 22,
                               bits, 0, fmt, b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71")
    else:
        fmt_body = struct.pack("<HHIIHH", fmt, ch, sr, sr * block, block, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
            + b"LIST" + struct.pack("<I", 4) + b"INFO"  # a chunk the parsers skip
            + b"data" + struct.pack("<I", len(raw)) + raw)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _pcm(n=2048, seed=0):
    return (np.random.RandomState(seed).randn(n) * 8000).astype(np.int16)


def test_library_is_the_ports_own_build():
    path = N.build()
    assert path == N.library_path() and path.exists()
    assert path.parent == host_build.BUILD_DIR and path.name.startswith("libaudio_host_")
    assert N.build() == path and N.available()
    assert N.decode_flac_bytes is flac.decode_flac_bytes


@pytest.mark.parametrize("n", [7, 4096, 1 << 17])  # the last runs the OpenMP loops
def test_int16_paths_bit_equal(n):
    """int16 <-> float32, the fused batch decode (pad and cut) and the
    decimation: bit-equal to the JAX library and to numpy."""
    assert JN.available()
    rng = np.random.RandomState(n)
    x = (rng.randn(n) * 9000).clip(-32768, 32767).astype(np.int16)
    f = (rng.randn(n) * 0.7).astype(np.float32)
    f[:3] = [-1.5, 1.5, 0.99999]
    for got, jax_lib, plain in (
        (N.int16_to_float32(x), JN.int16_to_float32(x), N.int16_to_float32_reference(x)),
        (N.float32_to_int16(f), JN.float32_to_int16(f), N.float32_to_int16_reference(f)),
    ):
        np.testing.assert_array_equal(got, jax_lib)
        np.testing.assert_array_equal(got, plain)
    batch = np.stack([x[: n // 2 * 2][::2], x[: n // 2 * 2][1::2]])
    for out_len in (batch.shape[1] // 2 + 1, batch.shape[1] + 5):
        got = N.decode_batch_int16(batch, out_len)
        np.testing.assert_array_equal(got, JN.decode_batch_int16(batch, out_len))
        np.testing.assert_array_equal(got, N.decode_batch_int16_reference(batch, out_len))
    for stride in (2, 4):
        got = N.decimate_int16_to_float32(x, stride)
        np.testing.assert_array_equal(got, JN.decimate_int16_to_float32(x, stride))
        np.testing.assert_array_equal(got, N.decimate_int16_to_float32_reference(x, stride))


@pytest.mark.parametrize("bits,fmt,channels,extensible", [
    (8, 1, 1, False), (16, 1, 1, False), (24, 1, 1, False), (32, 1, 1, False),
    (32, 3, 1, False), (64, 3, 1, False), (16, 1, 2, False), (24, 1, 3, False),
    (16, 1, 2, True), (32, 3, 1, True),
])
def test_wav_decode_bit_equal(bits, fmt, channels, extensible):
    """WAV decode, mono and by channel: bit-equal to the JAX library; to
    scipy's reading bit-equal for 8/16-bit PCM and float, within 1e-7 for
    24/32-bit PCM."""
    pcm = _pcm(1500 * channels).reshape(-1, channels).squeeze()
    data = (pcm / 32768.0) if fmt == 3 else pcm
    buf = _wav_bytes(data, 22050, bits, fmt, extensible)
    tol = 1e-7 if fmt == 1 and bits in (24, 32) else 0.0
    for mono in (True, False):
        got, sr = N.decode_wav_bytes(buf, mono=mono)
        want, jsr = JN.decode_wav_bytes(buf, mono=mono)
        assert sr == jsr == 22050 and got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        plain, psr = N.decode_wav_bytes_reference(buf, mono=mono)
        assert psr == sr and plain.shape == got.shape
        np.testing.assert_allclose(got, plain, rtol=0, atol=tol)


def test_wav_decode_raises_on_what_it_cannot_read():
    with pytest.raises(ValueError, match="not a supported WAV"):
        N.decode_wav_bytes(b"not a wav file at all")
    mulaw = bytearray(_wav_bytes(_pcm(64), 8000, 16))
    mulaw[20:22] = struct.pack("<H", 7)  # WAVE_FORMAT_MULAW
    with pytest.raises(ValueError, match="header error"):
        N.decode_wav_bytes(bytes(mulaw))


@pytest.mark.parametrize("up,down", [(1, 2), (2, 3), (160, 441), (441, 160), (320, 441),
                                     (3, 1)])
def test_resampler_within_1e6_of_scipy(up, down):
    x = np.random.RandomState(up + down).randn(12000).astype(np.float32) * 0.5
    got = N.resample_poly_kaiser(x, up, down)
    want = N.resample_poly_kaiser_reference(x, up, down)
    assert got.shape == want.shape == (-(-12000 * up // down),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, JN.resample_poly_kaiser(x, up, down), rtol=0, atol=1e-6)
    st = np.stack([x, -x[::-1]], 1)  # (frames, channels): column by column, axis 0
    np.testing.assert_allclose(N.resample_poly_kaiser(st, up, down),
                               N.resample_poly_kaiser_reference(st, up, down), rtol=0, atol=1e-6)


def test_audio_io_routes_through_the_library(tmp_path):
    """read_wav (the fixture, and a 44.1-kHz stereo file to 32 kHz),
    int16 <-> float32 and resample_poly against the JAX package's
    audio_io on its native route."""
    got, sr = audio_io.read_wav(str(FIXTURE))
    want, jsr = JIO.read_wav(str(FIXTURE))
    assert sr == jsr == 32000
    np.testing.assert_array_equal(got, want)
    st = np.stack([_pcm(44100, 1), _pcm(44100, 2)], 1)
    p = tmp_path / "st.wav"
    p.write_bytes(_wav_bytes(st, 44100, 16))
    for mono in (True, False):
        got, sr = audio_io.read_wav(str(p), target_sr=32000, mono=mono)
        want, _ = JIO.read_wav(str(p), target_sr=32000, mono=mono)
        assert sr == 32000 and got.shape == want.shape == ((32000,) if mono else (32000, 2))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    x = _pcm(5000, 3)
    np.testing.assert_array_equal(audio_io.int16_to_float32(x), JIO.int16_to_float32(x))
    f = audio_io.int16_to_float32(x) * 1.3
    np.testing.assert_array_equal(audio_io.float32_to_int16(f), JIO.float32_to_int16(f))
    np.testing.assert_allclose(audio_io.resample_poly(f, 48000, 32000),
                               JIO.resample_poly(f, 48000, 32000), rtol=0, atol=1e-6)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00WAVE")
    with pytest.raises(ValueError, match="bad.wav"):
        audio_io.read_wav(str(bad))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(N, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        N.int16_to_float32(np.zeros(4, np.int16))
    monkeypatch.setenv("CXX", sys.executable)  # a "compiler" that fails
    monkeypatch.setenv("PATH", os.path.dirname(sys.executable))
    with pytest.raises(RuntimeError, match="building the host audio library failed"):
        N.available()
    assert not list(tmp_path.glob("*.so"))


def test_processes_that_start_together_build_once(tmp_path):
    """Four processes build the library into one fresh directory at once:
    each loads a whole library, and one file is left (the fcntl lock and
    os.replace of ``utils/host_build.py``)."""
    code = (
        "import sys, numpy as np\n"
        "from pathlib import Path\n"
        "from audioset_convnext_inf_torch.utils import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "x = (np.arange(-300, 300) * 100).astype(np.int16)\n"
        "assert np.array_equal(native.int16_to_float32(x), native.int16_to_float32_reference(x))\n"
        "print(native.library_path().name)\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1 and [p.name for p in tmp_path.glob("*.so")] == list(names)
