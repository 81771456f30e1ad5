"""The port's Kaldi fbank (``ops/kaldi_fbank.py``), the AudioSet dataset's
fbank mode and the Evaluator on fbank batches, against the JAX package's.

Tolerances: the fbank within 2e-3 of the JAX package's in the log domain
(the JAX suite's own bound between two f32 FFTs, tests/test_kaldi_fbank.py)
and of that suite's frozen goldens; the dataset's items the same, names and
targets equal; the Evaluator's probabilities (f32 parity config) within
2e-4 of the JAX Evaluator's, the JAX package's parity tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from audioset_convnext_inf_tpu.config import ConvNeXtConfig as JaxConfig
from audioset_convnext_inf_tpu.data import hdf5_dataset as JDS
from audioset_convnext_inf_tpu.data import loader as JL
from audioset_convnext_inf_tpu.data import samplers as JS
from audioset_convnext_inf_tpu.engine import evaluator as JE
from audioset_convnext_inf_tpu.ops import kaldi_fbank as JK
from audioset_convnext_inf_tpu.parallel.mesh import get_mesh

from audioset_convnext_inf_torch.checkpoint import state_dict_from_jax_params, to_tensors
from audioset_convnext_inf_torch.config import ConvNeXtConfig
from audioset_convnext_inf_torch.data import AudioSetDataset, DataLoader, EvaluateSampler
from audioset_convnext_inf_torch.engine.evaluator import Evaluator
from audioset_convnext_inf_torch.models import ConvNeXt
from audioset_convnext_inf_torch.ops.kaldi_fbank import kaldi_fbank

from tests.make_synth_hdf5 import make_packed_and_index
from tests.test_kaldi_fbank import _GOLDEN, _golden_signals, _kaldi_fbank_direct
from tests.test_torch_checkpoint import _port_init
from tests.test_torch_model import SMALL, _randomize

FBANK_TOL = 2e-3
EVAL_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("window", ["hanning", "hamming", "povey"])
@pytest.mark.parametrize("scale", [0.01, 0.3])
def test_fbank_matches_jax(window, scale):
    """Seeded noise, 2 clips of 1.5 s and one of them alone: within
    FBANK_TOL of the JAX package's in the log domain."""
    x = (np.random.RandomState(int(scale * 100)).randn(2, 48000) * scale).astype(np.float32)
    got = kaldi_fbank(torch.from_numpy(x), window_type=window)
    want = JK.kaldi_fbank(x, window_type=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 144, 224)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FBANK_TOL)
    one = kaldi_fbank(torch.from_numpy(x[1]), window_type=window)
    np.testing.assert_allclose(one.numpy(), want[1], rtol=0, atol=FBANK_TOL)


def test_fbank_shape_floor_and_other_settings():
    x = torch.from_numpy((np.random.RandomState(3).randn(320000) * 0.1).astype(np.float32))
    assert tuple(kaldi_fbank(x).shape) == (994, 224)  # the reference's printed shape
    floor = kaldi_fbank(torch.zeros(32000))
    np.testing.assert_allclose(floor.numpy(), np.log(1.1920928955078125e-07), atol=1e-4)
    y = x[:16000].numpy()
    got = kaldi_fbank(x[:16000], sample_rate=16000, num_mel_bins=64, preemphasis=0.0,
                      remove_dc_offset=False, high_freq=-400.0, frame_length_ms=25.0)
    want = JK.kaldi_fbank(y, sample_rate=16000, num_mel_bins=64, preemphasis=0.0,
                          remove_dc_offset=False, high_freq=-400.0, frame_length_ms=25.0)
    assert tuple(got.shape) == want.shape == (98, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FBANK_TOL)
    with pytest.raises(ValueError, match="window_type"):
        kaldi_fbank(x, window_type="blackman")


@pytest.mark.parametrize("n", [1000, 2047, 2048, 2049])
def test_fbank_shorter_than_one_frame(n):
    """A clip shorter than one 64-ms frame (2048 samples) gives no frames,
    (0, 224), as the JAX function does, 1-D and batched; at 2048 and 2049
    samples one frame, within FBANK_TOL of the JAX package. An unknown
    window type raises at every length, in both."""
    x = (np.random.RandomState(n).randn(2, n) * 0.1).astype(np.float32)
    frames = 1 if n >= 2048 else 0
    got, want = kaldi_fbank(torch.from_numpy(x)), JK.kaldi_fbank(x)
    one, want_one = kaldi_fbank(torch.from_numpy(x[0])), JK.kaldi_fbank(x[0])
    assert tuple(got.shape) == want.shape == (2, frames, 224)
    assert tuple(one.shape) == want_one.shape == (frames, 224)
    assert got.dtype == one.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FBANK_TOL)
    np.testing.assert_allclose(one.numpy(), want_one, rtol=0, atol=FBANK_TOL)
    with pytest.raises(ValueError, match="window_type"):  # the settings are still checked
        JK.kaldi_fbank(x, window_type="blackman")
    with pytest.raises(ValueError, match="window_type"):
        kaldi_fbank(torch.from_numpy(x), window_type="blackman")


@pytest.mark.parametrize("name", ["impulse", "tone", "noise"])
def test_fbank_matches_frozen_goldens(name):
    """The JAX suite's golden signals: its frozen values, and the whole
    fbank against that suite's f64 Kaldi-spec oracle (explicit DFT sums),
    within FBANK_TOL. Against the JAX package itself for the impulse and
    the noise; on the tone (a sinusoid whose upper bins sit within a few
    eps of the log floor) the JAX package's f32 FFT is itself 2.7e-3 from
    the f64 oracle in 10 of 5376 bins, and the port (f64 framing) 1.9e-4."""
    sig = _golden_signals()[name]
    fb = kaldi_fbank(torch.from_numpy(sig)).numpy()
    shape, mean, v00, vll, vmid = _GOLDEN[name]
    assert fb.shape == shape
    np.testing.assert_allclose(fb.mean(), mean, atol=FBANK_TOL)
    np.testing.assert_allclose(fb[0, 0], v00, atol=FBANK_TOL)
    np.testing.assert_allclose(fb[-1, -1], vll, atol=FBANK_TOL)
    np.testing.assert_allclose(fb[shape[0] // 2, 112], vmid, atol=FBANK_TOL)
    np.testing.assert_allclose(fb, _kaldi_fbank_direct(sig.astype(np.float64)), rtol=0,
                               atol=FBANK_TOL)
    if name != "tone":
        np.testing.assert_allclose(fb, JK.kaldi_fbank(sig), rtol=0, atol=FBANK_TOL)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return make_packed_and_index(str(tmp_path_factory.mktemp("h5")), n_clips=11,
                                 clip_samples=32000, seed=5)


@pytest.mark.parametrize("sample_rate", [32000, 16000])
def test_dataset_fbank_mode_matches_jax(pair, sample_rate):
    """Items {'audio_name', 'fbank', 'target'} against the JAX dataset's;
    with keep_int16 the fbank is still taken from float32 samples (the
    int16 shortcut is off in this mode)."""
    packed, _ = pair
    ds = AudioSetDataset(sample_rate=sample_rate, use_kaldi_fbank=True)
    kept = AudioSetDataset(sample_rate=sample_rate, use_kaldi_fbank=True, keep_int16=True)
    jds = JDS.AudioSetDataset(sample_rate=sample_rate, use_kaldi_fbank=True)
    assert not kept.keep_int16
    for i in (0, 7):
        meta = {"hdf5_path": packed, "index_in_hdf5": i}
        got, want, k = ds[meta], jds[meta], kept[meta]
        assert sorted(got) == sorted(want) == ["audio_name", "fbank", "target"]
        assert got["audio_name"] == want["audio_name"]
        np.testing.assert_array_equal(got["target"], want["target"])
        assert got["fbank"].dtype == np.float32 and got["fbank"].shape == want["fbank"].shape
        np.testing.assert_allclose(got["fbank"], want["fbank"], rtol=0, atol=FBANK_TOL)
        np.testing.assert_array_equal(k["fbank"], got["fbank"])
    assert ds[{"hdf5_path": packed, "index_in_hdf5": 0}]["fbank"].shape[0] == (
        94 if sample_rate == 32000 else 1 + (16000 - 1024) // 160)


def _fbank_loader(pkg, index, batch):
    ds_cls, sampler_cls, loader_cls = pkg
    return loader_cls(ds_cls(use_kaldi_fbank=True), sampler_cls(index, batch), num_workers=2,
                      pad_to_batch_size=batch)


def test_evaluator_on_fbank_batches_matches_jax(pair):
    """The Kaldi-fbank evaluation route (HDF5 clip -> host fbank -> Evaluator
    -> a small ConvNeXt, f32 parity config, 1-s clips, B=4 with a padded
    tail): the port's route against the JAX package's, and both Evaluators
    on the same batches, within EVAL_TOL."""
    _, index = pair
    params = _randomize(_port_init(ConvNeXtConfig(**SMALL), 4), np.random.RandomState(23))
    model = ConvNeXt(ConvNeXtConfig(**SMALL), device="cpu")
    model.load_state_dict(to_tensors(state_dict_from_jax_params(params)), strict=True)
    ev = Evaluator(model, device="cpu")
    jev = JE.Evaluator(params, JaxConfig(**SMALL), mesh=get_mesh(jax.devices()[:1]))
    port = (AudioSetDataset, EvaluateSampler, DataLoader)
    batches = list(_fbank_loader(port, index, 4))
    assert [b["valid"] for b in batches] == [4, 4, 3] and batches[0]["fbank"].shape == (4, 94, 224)
    got = ev.infer_probs(batches)
    same = jev.infer_probs(batches)
    want = jev.infer_probs(_fbank_loader((JDS.AudioSetDataset, JS.EvaluateSampler, JL.DataLoader),
                                         index, 4))
    assert got["clipwise_output"].shape == (11, 527)
    np.testing.assert_array_equal(got["target"], want["target"])
    np.testing.assert_allclose(got["clipwise_output"], same["clipwise_output"], rtol=0,
                               atol=EVAL_TOL)
    np.testing.assert_allclose(got["clipwise_output"], want["clipwise_output"], rtol=0,
                               atol=EVAL_TOL)
    assert np.abs(got["clipwise_output"] - 0.5).max() > 0.05  # the weights move the answer
