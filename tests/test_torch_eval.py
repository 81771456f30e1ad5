"""The port's evaluation path against the JAX package's: metrics, the HDF5
data plane (dataset, sampler, loader) and the Evaluator.

The JAX package's host data plane reaches its native library
(``utils/native.py``), whose first use runs ``make``; the tests switch it
off in this process (``native._TRIED``) so that both packages take numpy.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax

from audioset_convnext_inf_tpu.config import ConvNeXtConfig as JaxConfig
from audioset_convnext_inf_tpu.data import hdf5_dataset as JDS
from audioset_convnext_inf_tpu.data import loader as JL
from audioset_convnext_inf_tpu.data import samplers as JS
from audioset_convnext_inf_tpu.engine import evaluator as JE
from audioset_convnext_inf_tpu.engine import metrics as JM
from audioset_convnext_inf_tpu.parallel.mesh import get_mesh
from audioset_convnext_inf_tpu.utils import native

from audioset_convnext_inf_torch.checkpoint import state_dict_from_jax_params, to_tensors
from audioset_convnext_inf_torch.config import ConvNeXtConfig
from audioset_convnext_inf_torch.data import AudioSetDataset, DataLoader, EvaluateSampler
from audioset_convnext_inf_torch.engine import metrics as M
from audioset_convnext_inf_torch.engine.evaluator import Evaluator
from audioset_convnext_inf_torch.models import ConvNeXt

from tests.make_synth_hdf5 import make_packed_and_index
from tests.test_torch_checkpoint import _port_init
from tests.test_torch_model import SMALL, _randomize

N_CLIPS, BATCH = 21, 8  # the last batch holds 5 clips and is padded


@pytest.fixture(autouse=True)
def _numpy_data_plane(monkeypatch):
    monkeypatch.setattr(native, "_TRIED", True)
    monkeypatch.setattr(native, "_LIB", None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return make_packed_and_index(str(tmp_path_factory.mktemp("h5")), n_clips=N_CLIPS,
                                 clip_samples=32000, seed=3)


def _scores(n, c, seed, ties):
    rng = np.random.RandomState(seed)
    target = (rng.rand(n, c) < 0.2).astype(np.float32)
    target[:, 1] = 0.0  # no positives
    target[:, 2] = 1.0  # no negatives
    target[0, 3] = 1.0
    target[1:, 3] = 0.0  # one positive
    scores = rng.rand(n, c).astype(np.float32)
    if ties:
        scores = np.round(scores * 8) / 8  # nine distinct values: ties everywhere
        scores[:, 4] = 0.5  # one tie group holding the whole class
    return scores, target


@pytest.mark.parametrize("n,c,seed,ties", [(200, 12, 0, True), (513, 140, 1, True),
                                           (300, 9, 2, False)])
def test_metrics_match_jax(n, c, seed, ties):
    """AP, AUC and d-prime per class and their summary within 1e-12 of the
    JAX package's (sklearn's), NaN where it gives NaN."""
    scores, target = _scores(n, c, seed, ties)
    got, want = M.evaluate_clipwise(scores, target), JM.evaluate_clipwise(scores, target)
    for key in ("average_precision", "auc", "d_prime"):
        np.testing.assert_array_equal(np.isnan(got[key]), np.isnan(want[key]), err_msg=key)
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12, err_msg=key)
    assert np.isnan(got["average_precision"][1]) and got["average_precision"][2] == 1.0
    assert np.isnan(got["auc"][1]) and np.isnan(got["auc"][2])
    s, w = M.summarize(got), JM.summarize(want)
    assert s.keys() == w.keys()
    for k in s:
        assert abs(s[k] - w[k]) <= 1e-12, k


class _CountingSampler:
    """An EvaluateSampler with resumable state: the count of batches drawn."""

    def __init__(self, sampler):
        self.sampler, self.count = sampler, 0

    def __iter__(self):
        for metas in self.sampler:
            self.count += 1
            yield metas

    def state_dict(self):
        return {"count": self.count}


def _batches(pkg, index, keep_int16, counting):
    ds_cls, sampler_cls, loader_cls = pkg
    sampler = sampler_cls(index, BATCH)
    if counting:
        sampler = _CountingSampler(sampler)
    loader = loader_cls(ds_cls(keep_int16=keep_int16), sampler, num_workers=3,
                        pad_to_batch_size=BATCH)
    return list(loader)


@pytest.mark.parametrize("keep_int16", [False, True])
@pytest.mark.parametrize("counting", [False, True])
def test_loader_batches_match_jax(pair, keep_int16, counting):
    """Same batches in the same order: waveforms bit for bit (int16 kept or
    decoded), targets, names, ``valid`` and the sampler snapshots."""
    _, index = pair
    got = _batches((AudioSetDataset, EvaluateSampler, DataLoader), index, keep_int16, counting)
    want = _batches((JDS.AudioSetDataset, JS.EvaluateSampler, JL.DataLoader), index, keep_int16,
                    counting)
    assert [b["valid"] for b in got] == [8, 8, 5]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert ("sampler_state" in g) == counting
        for k in g:
            if isinstance(g[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k
    assert got[0]["waveform"].dtype == (np.int16 if keep_int16 else np.float32)
    assert got[-1]["waveform"].shape == (BATCH, 32000) and not got[-1]["waveform"][5:].any()


@pytest.mark.parametrize("keep_int16", [False, True])
def test_evaluator_matches_jax(pair, keep_int16):
    """The port's Evaluator on the CPU (f32 parity config) against the JAX
    package's on one device: probabilities within 1e-5, the padded tail
    trimmed, mAP/AUC/d-prime within 1e-6."""
    _, index = pair
    rng = np.random.RandomState(17)
    jcfg = JaxConfig(**SMALL)
    params = _randomize(_port_init(ConvNeXtConfig(**SMALL), 2), rng)
    model = ConvNeXt(ConvNeXtConfig(**SMALL), device="cpu")
    model.load_state_dict(to_tensors(state_dict_from_jax_params(params)), strict=True)
    ev = Evaluator(model, device="cpu")
    jev = JE.Evaluator(params, jcfg, mesh=get_mesh(jax.devices()[:1]))

    def loader(pkg_ds, pkg_s, pkg_l):
        return pkg_l(pkg_ds(keep_int16=keep_int16), pkg_s(index, BATCH), num_workers=2,
                     pad_to_batch_size=BATCH)

    got = ev.infer_probs(loader(AudioSetDataset, EvaluateSampler, DataLoader))
    want = jev.infer_probs(loader(JDS.AudioSetDataset, JS.EvaluateSampler, JL.DataLoader))
    assert got["clipwise_output"].shape == (N_CLIPS, 527)
    np.testing.assert_array_equal(got["target"], want["target"])
    np.testing.assert_allclose(got["clipwise_output"], want["clipwise_output"], atol=1e-5)
    s = M.summarize(M.evaluate_clipwise(got["clipwise_output"], got["target"]))
    w = JM.summarize(JM.evaluate_clipwise(want["clipwise_output"], want["target"]))
    for k in s:
        assert np.isfinite(s[k]) and abs(s[k] - w[k]) <= 1e-6, k
    stats = ev.evaluate(loader(AudioSetDataset, EvaluateSampler, DataLoader))
    assert abs(M.summarize(stats)["mAP"] - s["mAP"]) <= 1e-12


def test_evaluator_takes_fbank_batches_and_new_weights():
    """'fbank' batches run as spectrogram images; ``set_params`` swaps the
    weights in (numpy or tensors)."""
    cfg = ConvNeXtConfig(**SMALL)
    model = ConvNeXt(cfg, device="cpu", seed=1)
    ev = Evaluator(model, device="cpu")
    spec = np.random.RandomState(0).randn(3, 101, 224).astype(np.float32)
    batch = {"fbank": spec, "target": np.zeros((3, 527), np.float32), "valid": 2}
    got = ev.infer_probs([batch])["clipwise_output"]
    want = model.forward(torch.from_numpy(spec[..., None]))["clipwise_output"].numpy()[:2]
    np.testing.assert_array_equal(got, want)
    other = ConvNeXt(cfg, device="cpu", seed=2)
    ev.set_params({k: v.numpy() for k, v in other.state_dict().items()})
    assert torch.equal(model.head_audioset.weight, other.head_audioset.weight)


class _SlowDataset:
    def __getitem__(self, meta):
        time.sleep(0.01)
        return {"waveform": np.zeros(4, np.float32), "target": np.zeros(2, np.float32)}


def test_an_abandoned_iteration_leaves_no_producer_thread():
    """A consumer that takes one batch and walks away: the producer thread
    and its pool stop within a few seconds."""
    before = set(threading.enumerate())
    loader = DataLoader(_SlowDataset(), [[{}] * 2 for _ in range(200)], num_workers=2,
                        prefetch_batches=2)
    it = iter(loader)
    next(it)
    it.close()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        extra = [t for t in threading.enumerate() if t not in before and t.is_alive()]
        if not extra:
            break
        time.sleep(0.05)
    assert not extra, extra
