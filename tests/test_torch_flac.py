"""The port's FLAC decoder (``data/flac.py`` over its own build of
``csrc/flac_decode.cpp``) against the JAX package's native decoder and
against the integers the stream encodes.

The streams come from ``tests/flac_encoder.py`` and cover every subframe
kind and channel mode it writes: CONSTANT, VERBATIM, FIXED orders 0-4 and
LPC subframes; Rice methods 0 and 1, partition orders and escape
partitions; wasted bits; independent, left/side, right/side and mid/side
stereo; 8-, 16- and 24-bit samples; the sample size taken from STREAMINFO;
many frames (multi-byte frame numbers) and a ragged last frame. Each stream
decodes bit-equal to the JAX package's ``native.decode_flac_bytes`` (the
library the root conftest builds before the workers start), and exactly to
the encoder's integers over 2^(bits - 1): FLAC is lossless. Malformed
streams raise.
"""

import numpy as np
import pytest

from audioset_convnext_inf_tpu.data import audio_io as jax_audio_io
from audioset_convnext_inf_tpu.utils import native

from audioset_convnext_inf_torch.data import audio_io, flac
from tests.flac_encoder import encode_flac


@pytest.fixture(scope="module")
def jax_native():
    assert native.available(), "native/libaudiohost.so is not built"
    return native


def _smooth(n, seed=0, amp=8000, channels=1):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 320.0
    cols = [amp * (np.sin(2 * np.pi * (t + c / 7.0)) + 0.04 * rng.randn(n))
            for c in range(channels)]
    x = np.round(np.stack(cols, axis=1)).astype(np.int64)
    return x[:, 0] if channels == 1 else x


# name -> (samples, sample rate, encoder kwargs)
STREAMS = {
    **{f"fixed order {o}": (_smooth(3000), 32000, dict(kind="fixed", order=o, blocksize=1024))
       for o in range(5)},
    "verbatim": (_smooth(3000), 32000, dict(kind="verbatim", blocksize=1024)),
    "constant": (np.full(2048, -1234, np.int64), 16000, dict(kind="constant", blocksize=1024)),
    "lpc order 8, shift 3": (_smooth(2500, 3), 44100, dict(
        kind="lpc", lpc_coefs=[14, -11, 4, -1, 1, 0, 0, 1], lpc_shift=3, lpc_precision=12,
        blocksize=512)),
    "rice method 1, partition order 2": (_smooth(2048, 5), 32000, dict(
        kind="fixed", order=2, po=2, method=1, blocksize=1024)),
    "escape partitions": (_smooth(1024, 7), 32000, dict(
        kind="fixed", order=2, po=2, escape_partitions=(1, 3), blocksize=1024)),
    "wasted bits": (_smooth(2048, 9, amp=2000) * 8, 32000, dict(kind="fixed", order=2,
                                                                blocksize=1024)),
    **{f"stereo {m}": (_smooth(2500, 11, channels=2), 32000, dict(
        kind="fixed", order=2, stereo_mode=m, blocksize=1024))
       for m in ("independent", "left_side", "right_side", "mid_side")},
    "8-bit": (_smooth(2000, 13, amp=100), 8000, dict(bps=8, kind="fixed", order=1,
                                                      blocksize=576)),
    "24-bit": (_smooth(2000, 15) * 200, 48000, dict(bps=24, kind="fixed", order=2,
                                                    blocksize=1152)),
    "sample size from STREAMINFO": (_smooth(2048, 17), 32000, dict(
        kind="fixed", order=2, ss_from_streaminfo=True, blocksize=1024)),
    "many frames, mixed kinds": (_smooth(40 * 192 + 50, 19), 32000, dict(
        blocksize=192, per_frame_kind=lambda i: ("fixed", "verbatim")[i % 2], order=2)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decode_matches_the_jax_decoder_and_the_integers(name, jax_native):
    x, sr, kw = STREAMS[name]
    buf = encode_flac(x, sr, **kw)
    bps = kw.get("bps", 16)
    scale = np.float32(1.0 / (1 << (bps - 1)))
    for mono in (True, False):
        got, got_sr = flac.decode_flac_bytes(buf, mono=mono)
        want, want_sr = jax_native.decode_flac_bytes(buf, mono=mono)
        assert got_sr == want_sr == sr
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        ints = x if x.ndim == 2 else x[:, None]
        if mono:  # the channel mean: the integers' sum, scaled, over the channels
            exact = ints.sum(axis=1).astype(np.float32) * scale * np.float32(1.0 / ints.shape[1])
        else:
            exact = (ints.astype(np.float32) * scale).reshape(got.shape)
        np.testing.assert_array_equal(got, exact)


def _streaminfo_total_zero(buf: bytes) -> bytes:
    """The same stream with STREAMINFO's 36-bit total sample count at 0
    (unknown): bytes 8+10 .. 8+17 hold rate, channels, bits and the total."""
    b = bytearray(buf)
    start = 8 + 13  # the total's low 32 bits; its high 4 share byte 8+13 with bits
    b[start] &= 0xF0
    b[start + 1:start + 5] = b"\0\0\0\0"
    return bytes(b)


def test_malformed_streams_raise():
    buf = encode_flac(_smooth(2048), 32000, kind="fixed", order=2, blocksize=1024)
    cases = {
        "truncated": buf[: len(buf) // 2],
        "garbage": bytes(np.random.RandomState(0).randint(0, 256, 4096, dtype=np.uint8)),
        "no stream": b"fLaC",
        "corrupt frame": buf[:200] + bytes([buf[200] ^ 0xFF]) + buf[201:],
        "unknown total": _streaminfo_total_zero(buf),
    }
    for label, bad in cases.items():
        with pytest.raises(ValueError):
            flac.decode_flac_bytes(bad)
        assert native.decode_flac_bytes(bad) is None, label  # JAX refuses them too


def test_header_claiming_more_than_the_bytes_hold_raises():
    """STREAMINFO's total is the stream's claim: one bounded by what the
    bytes could encode before anything is allocated."""
    buf = bytearray(encode_flac(_smooth(1024), 32000, kind="fixed", order=2, blocksize=1024))
    buf[8 + 13] |= 0x0F  # the total's high 4 bits: 2^32 more samples
    with pytest.raises(ValueError, match="more than"):
        flac.decode_flac_bytes(bytes(buf))


def test_read_audio_dispatches_by_magic(tmp_path, jax_native):
    from scipy.io import wavfile

    x = _smooth(4000, 21)
    (tmp_path / "a.flac").write_bytes(encode_flac(x, 32000, kind="fixed", order=2))
    # a FLAC stream under a .wav name, a WAV under a .flac name
    (tmp_path / "flac_inside.wav").write_bytes((tmp_path / "a.flac").read_bytes())
    wavfile.write(tmp_path / "wav_inside.flac", 32000, x.astype(np.int16))
    (tmp_path / "garbage.flac").write_bytes(b"\x00" * 2048)
    want = x.astype(np.float32) * np.float32(1 / 32768)
    for name in ("a.flac", "flac_inside.wav"):
        got, sr = audio_io.read_audio(str(tmp_path / name))
        ref, _ = jax_audio_io.read_audio(str(tmp_path / name))
        assert sr == 32000
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)
    got, sr = audio_io.read_audio(str(tmp_path / "wav_inside.flac"))
    assert sr == 32000
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="garbage.flac"):
        audio_io.read_audio(str(tmp_path / "garbage.flac"))
    # resampled on the way: 32 kHz -> 16 kHz, beside the JAX package's
    got, sr = audio_io.read_flac(str(tmp_path / "a.flac"), target_sr=16000)
    ref, _ = jax_audio_io.read_flac(str(tmp_path / "a.flac"), target_sr=16000)
    assert sr == 16000 and got.shape == ref.shape == (2000,)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_build_is_cached_by_source_hash():
    path = flac.build()
    assert path == flac.library_path() and path.exists()
    assert path.parent.name == "host_libs" and path.name.startswith("libflac_decode_")
    assert flac.build() == path
