"""Mutation fuzzing of the port's host decoders, beside the JAX package's.

The port decodes untrusted file bytes in-process through its own C++
libraries: FLAC in ``data/flac.py`` over ``csrc/flac_decode.cpp``, WAV in
``utils/native.py`` / ``data/audio_io.py`` over ``csrc/audio_host.cpp``.
Each family of ``tests/test_fuzz_decoders.py`` (byte flips, multi-byte
corruption, truncations, random garbage, a huge claimed total, WAV flips
and truncations, absurd geometry), drawn with its seeds by
``tests/torch_fuzz_util.py``, goes through both packages' decoders. The
contract: every mutation either decodes to a well-formed array or raises
the port's ``ValueError``; never a crash or an unbounded allocation. Where
the JAX library accepts, the port accepts and decodes the same samples at
the same rate; where the JAX library returns None, the port raises.
"""

import numpy as np
import pytest

from audioset_convnext_inf_tpu.utils import native as jax_native

from audioset_convnext_inf_torch.data import audio_io
from audioset_convnext_inf_torch.data.flac import decode_flac_bytes
from audioset_convnext_inf_torch.utils import native

from tests import torch_fuzz_util as fz


@pytest.fixture(scope="module", autouse=True)
def _jax_library():
    """The JAX package's native library is the oracle: it must load."""
    assert jax_native.available(), "the JAX package's native library did not build"


def _port(decode, buf):
    try:
        return decode(buf)
    except ValueError:
        return None


def _agree(buf, port_decode, jax_decode):
    """Both decoders on ``buf``: the same accept / reject, and on accept the
    same samples (bit for bit) and rate, well formed. Returns accepted."""
    want = jax_decode(buf)
    got = _port(port_decode, buf)
    assert (got is None) == (want is None), (len(buf), got is None)
    if got is None:
        return False
    fz.well_formed(got, len(buf))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    return True


def _flac(buf):
    return _agree(buf, decode_flac_bytes, jax_native.decode_flac_bytes)


def _wav(buf):
    ok = _agree(buf, native.decode_wav_bytes, jax_native.decode_wav_bytes)
    if ok:  # a WAV decode never holds more float32 samples than its bytes
        assert native.decode_wav_bytes(buf)[0].nbytes <= len(buf) * 4
    return ok


@pytest.fixture(scope="module")
def flac_stream():
    buf = fz.valid_flac()
    assert _flac(buf)
    return buf


@pytest.fixture(scope="module")
def wav_stream():
    buf = fz.valid_wav()
    assert _wav(buf)
    return buf


@pytest.mark.parametrize("family", ["byte_flips", "multi_byte", "truncations"])
def test_flac_mutations_agree_with_the_jax_decoder(flac_stream, family):
    """400 byte flips (seed 0), 150 multi-byte corruptions (seed 1), and
    truncations at every header byte and every 7th byte: the same accept /
    reject as the JAX decoder and, on accept, its samples. Each family
    holds rejected streams and the byte flips an accepted one too (1 of
    400); every multi-byte corruption and every cut is rejected."""
    streams = {"byte_flips": lambda: fz.byte_flips(flac_stream, 400, 0),
               "multi_byte": lambda: fz.multi_byte(flac_stream, 150, 1),
               "truncations": lambda: fz.truncations(flac_stream, 7)}[family]()
    outcomes = [_flac(buf) for buf in streams]
    assert not all(outcomes)
    if family == "byte_flips":
        assert any(outcomes)


def test_flac_random_garbage_raises(flac_stream):
    """Random blobs of 8 sizes (seed 2): under 42 bytes (no room for a
    STREAMINFO) the port raises; 50 blobs that keep the "fLaC" magic agree
    with the JAX decoder."""
    for size, blob in fz.flac_garbage(2):
        accepted = _flac(blob)
        assert not accepted or size >= 42 or size == -1


def test_flac_huge_claimed_total_raises_before_allocating(flac_stream):
    """A STREAMINFO claiming 2^36 - 1 samples on a 1-kB stream: refused
    before the output is allocated (about 256 GB), by both packages."""
    buf = fz.flac_huge_total(flac_stream)
    assert jax_native.decode_flac_bytes(buf) is None
    with pytest.raises(ValueError, match="more than"):
        decode_flac_bytes(buf)


@pytest.mark.parametrize("family", ["byte_flips", "truncations"])
def test_wav_mutations_agree_with_the_jax_decoder(wav_stream, family):
    """400 byte flips (seed 3) and truncations at every header byte and
    every 13th byte, as the FLAC families."""
    streams = (fz.byte_flips(wav_stream, 400, 3) if family == "byte_flips"
               else fz.truncations(wav_stream, 13))
    outcomes = [_wav(buf) for buf in streams]
    assert not all(outcomes)
    if family == "byte_flips":
        assert any(outcomes)


def test_wav_absurd_geometry(wav_stream):
    """0 channels and 0 bits per sample raise (no division by zero); a data
    chunk claiming 0xFFFFFFF0 bytes is clamped to the buffer, as in the
    JAX package."""
    for label, buf in fz.wav_absurd_geometry(wav_stream):
        accepted = _wav(buf)
        if label.startswith("0 "):
            assert not accepted
            with pytest.raises(ValueError):
                native.decode_wav_bytes(buf)


def test_read_audio_on_garbage_raises_valueerror(tmp_path):
    """Files: a RIFF header with junk behind it, and the FLAC magic over
    zeros, each raise the port's ValueError naming the file."""
    wav = tmp_path / "junk.wav"
    wav.write_bytes(b"RIFFxxxxWAVEjunkjunkjunk")
    with pytest.raises(ValueError, match="junk.wav"):
        audio_io.read_audio(str(wav))
    flac = tmp_path / "junk.flac"
    flac.write_bytes(b"fLaC" + bytes(100))
    with pytest.raises(ValueError, match="junk.flac"):
        audio_io.read_audio(str(flac))
