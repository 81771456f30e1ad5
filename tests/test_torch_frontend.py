"""The port's PCM decode and log-mel frontend against the JAX package's.

Both run in f32 on the CPU; "highest" precision on both sides, so the
differences are summation order only. Tolerances in dB, in the manner of
tests/test_frontend.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy.io import wavfile

from audioset_convnext_inf_tpu.config import FrontendConfig as JaxFrontendConfig
from audioset_convnext_inf_tpu.ops import frontend as JFE
from audioset_convnext_inf_tpu.ops.pcm import decode_pcm_if_int16 as jax_decode

from audioset_convnext_inf_torch.config import FrontendConfig
from audioset_convnext_inf_torch.ops import frontend as FE
from audioset_convnext_inf_torch.ops.pcm import decode_pcm_if_int16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clips(sample_wav_path):
    """The 10-s fixture recording, and the same at -60 dB (near-silent)."""
    _, data = wavfile.read(sample_wav_path)
    wav = data[:320000].astype(np.float32) / np.float32(32767.0)
    return np.stack([wav, wav * np.float32(1e-3)])


def test_int16_decode_bit_identical_to_jax():
    pcm = np.arange(-32768, 32768, dtype=np.int16)
    ours = decode_pcm_if_int16(torch.from_numpy(pcm))
    theirs = np.asarray(jax_decode(jnp.asarray(pcm)))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy().view(np.uint32), theirs.view(np.uint32))
    f = torch.ones(3)
    assert decode_pcm_if_int16(f) is f  # other dtypes pass through


def test_constants_equal_jax():
    np.testing.assert_array_equal(FE.hann_window_periodic(1024), JFE.hann_window_periodic(1024))
    np.testing.assert_array_equal(
        FE.mel_filterbank(32000, 1024, 224, 50.0, 14000.0),
        JFE.mel_filterbank(32000, 1024, 224, 50.0, 14000.0))
    for ours, theirs in zip(FE._dft_bases(1024, 1024), JFE._dft_bases(1024, 1024)):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(FE._dft_bases(512, 400)[0], JFE._dft_bases(512, 400)[0])
    np.testing.assert_array_equal(FE._conv_dft_kernel(1024, 1024, 320),
                                  JFE._conv_dft_kernel(1024, 1024, 320))


@pytest.mark.parametrize("dft_impl", ["conv", "direct", "ct", "rfft"])
@pytest.mark.parametrize("with_affine", [False, True])
def test_log_mel_matches_jax(clips, dft_impl, with_affine):
    """All bins within 0.15 dB (measured 0.086, for "direct" with the bn0
    affine, whose scale reaches 2: f32 cancellation in the fixture's
    near-silent frames dominates; "ct" 0.0084 and "rfft" 0.021 without it);
    bins above -40 dB within 2e-3 dB (measured 7e-4)."""
    rng = np.random.RandomState(5)
    a = rng.uniform(0.5, 2.0, 224).astype(np.float32)
    b = rng.randn(224).astype(np.float32)
    jcfg = JaxFrontendConfig(dft_impl=dft_impl, precision="highest")
    cfg = FrontendConfig(dft_impl=dft_impl, precision="highest")
    theirs = np.asarray(JFE.log_mel_spectrogram(
        jnp.asarray(clips), jcfg,
        affine=(jnp.asarray(a), jnp.asarray(b)) if with_affine else None))
    plain = FE.log_mel_spectrogram(torch.from_numpy(clips), cfg).numpy()
    ours = FE.log_mel_spectrogram(
        torch.from_numpy(clips), cfg,
        affine=(torch.from_numpy(a), torch.from_numpy(b)) if with_affine else None).numpy()
    assert ours.shape == theirs.shape == (2, 1, 1001, 224)
    err = np.abs(ours - theirs)
    assert err.max() <= 0.15, err.max()
    assert err[plain > -40.0].max() <= 2e-3


def test_frontend_module_matches_function(clips):
    cfg = FrontendConfig()
    fe = FE.LogMelFrontend(cfg)
    assert dict(fe.state_dict()) == {}  # constants are non-persistent buffers
    x = torch.from_numpy(clips[:1, :64000])
    assert torch.equal(fe(x), FE.log_mel_spectrogram(x, cfg))


def test_default_precision_against_highest(clips):
    """"default" = single-pass bf16 operands, f32 accumulation. Outside the
    near-silent bins (bins within 20 dB of their frame's loudest) it stays
    within 0.15 dB of "highest" (measured 0.073); quieter bins carry the
    bf16 rounding noise of the loud ones and are not held to a bound."""
    x = torch.from_numpy(clips[:1])
    hi = FE.log_mel_spectrogram(x, FrontendConfig(precision="highest")).numpy()[0, 0]
    de = FE.log_mel_spectrogram(x, FrontendConfig(precision="default")).numpy()[0, 0]
    loud = hi > hi.max(axis=-1, keepdims=True) - 20.0
    assert loud.mean() > 0.05
    assert np.abs(de - hi)[loud].max() <= 0.15
    assert np.abs(de - hi).max() > 0.15  # the bf16 path really ran


@pytest.mark.parametrize("dft_impl", ["ct", "rfft"])
def test_unported_dft_impls_raise(dft_impl):
    """"ct" and "rfft" are ported now: both build and run, in the function
    and in the module; only a name the JAX package does not know raises."""
    cfg = dataclasses.replace(FrontendConfig(), dft_impl=dft_impl)
    x = torch.zeros(1, 32000)
    assert FE.log_mel_spectrogram(x, cfg).shape == (1, 1, 101, 224)
    assert torch.equal(FE.LogMelFrontend(cfg)(x), FE.log_mel_spectrogram(x, cfg))
    bad = dataclasses.replace(FrontendConfig(), dft_impl=dft_impl + "x")
    with pytest.raises(ValueError, match="unknown dft_impl"):
        FE.log_mel_spectrogram(x, bad)
    with pytest.raises(ValueError, match="unknown dft_impl"):
        FE.LogMelFrontend(bad)


def test_ct_constants_equal_jax():
    for n in (1024, 512, 2048, 480, 1023, 6, 2):
        assert FE._ct_factors(n) == JFE._ct_factors(n), n
    for n_fft, win in ((1024, 1024), (512, 400)):
        np.testing.assert_array_equal(FE.ct_bin_to_k(n_fft), JFE.ct_bin_to_k(n_fft))
        ours, theirs = FE._ct_bases(n_fft, win), JFE._ct_bases(n_fft, win)
        assert ours[:2] == theirs[:2]
        for a, b in zip(ours[2:], theirs[2:]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_ct_at_n_fft_512_matches_jax(clips):
    """n_fft 512 (P=16, Q=32) with a 400-sample window: the tolerances of
    test_log_mel_matches_jax (measured 0.033 dB on all bins, 7e-5 above
    -40 dB)."""
    kw = dict(dft_impl="ct", precision="highest", n_fft=512, win_length=400)
    theirs = np.asarray(JFE.log_mel_spectrogram(jnp.asarray(clips), JaxFrontendConfig(**kw)))
    ours = FE.log_mel_spectrogram(torch.from_numpy(clips), FrontendConfig(**kw)).numpy()
    err = np.abs(ours - theirs)
    assert err.max() <= 0.15, err.max()
    assert err[ours > -40.0].max() <= 2e-3


def test_ct_without_factorisation_runs_direct(clips):
    """An odd n_fft has no even factor: "ct" is the "direct" DFT, as in the
    JAX package, bit for bit in the port and within the tolerances of
    test_log_mel_matches_jax of the JAX package's."""
    x = clips[:1, :64000]
    kw = dict(precision="highest", n_fft=1023, win_length=1023)
    ct = FE.log_mel_spectrogram(torch.from_numpy(x), FrontendConfig(dft_impl="ct", **kw))
    direct = FE.log_mel_spectrogram(torch.from_numpy(x), FrontendConfig(dft_impl="direct", **kw))
    assert torch.equal(ct, direct)
    assert torch.equal(FE.LogMelFrontend(FrontendConfig(dft_impl="ct", **kw))(
        torch.from_numpy(x)), ct)
    theirs = np.asarray(JFE.log_mel_spectrogram(jnp.asarray(x),
                                                JaxFrontendConfig(dft_impl="ct", **kw)))
    err = np.abs(ct.numpy() - theirs)
    assert err.max() <= 0.15 and err[ct.numpy() > -40.0].max() <= 2e-3
