"""The port's checkpoint-arrival gate, ``scripts/verify_checkpoint_torch.py``,
held against the JAX package's own gate, ``scripts/verify_checkpoint.py``,
on the same convnext_tiny safetensors file that the test writes with seeded
weights (the published checkpoint is not in the repository, so the golden
labels cannot pass here), the same WAV and the same synthetic index HDF5.
Both gates print the same checks with the same verdicts; the golden-index
lists agree up to classes whose probability lies within a stated margin of
the threshold; the evaluation route forwards the same clips in the same
order through the same configuration, and prints the same mAP/AUC within a
stated tolerance. A file with one tensor missing or no file at all fails
cleanly.
"""

import importlib.util
import re
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audioset_convnext_inf_torch.checkpoint.io import save_safetensors
from audioset_convnext_inf_torch.models import convnext_tiny

from tests.make_synth_hdf5 import make_packed_and_index

ROOT = Path(__file__).resolve().parent.parent
WAV = str(ROOT / "tests" / "fixtures" / "f62-S-v2swA_200000_210000.wav")
THRESHOLD = 0.25

# Largest clip probability gap allowed between the two gates. Measured on
# this file: f32 7.6e-7 over the eval clips and 5.4e-7 on the fixture; bf16
# 3.0e-3 (the two packages round bf16 in different orders). A golden-index
# list may differ only in classes whose port probability lies within this
# margin of the threshold (in bf16, two classes, 5.5e-4 and 9.1e-4 from it).
PROB_TOL = {"f32": 1e-5, "bf16": 1e-2}
# Printed eval metrics (4 decimals): f32 equal up to the printed rounding
# (measured equal). bf16 within 0.03 (measured 0.0046 mAP, 0.0110 AUC): on
# random weights one class's probabilities over the clips lie within about
# 1e-3 of one another, as close as the bf16 rounding, so ranks swap; the
# per-clip probabilities carry the sharp comparison.
METRIC_TOL = {"f32": 1.5e-4, "bf16": 0.03}


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _script():
    return _load("verify_checkpoint_torch", "scripts/verify_checkpoint_torch.py")


def _jax_script():
    return _load("verify_checkpoint", "scripts/verify_checkpoint.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """convnext_tiny from the port's init (seed 3) with seeded layer scales,
    and the head's bias at logit(0.25) less the median logit on the
    fixture, so that about half the classes land on each side of the
    golden-index threshold; as a safetensors file; and the model."""
    model = convnext_tiny(drop_path_rate=0.0, seed=3, device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for stage in model.stages:
            for blk in stage:
                blk.gamma.copy_(torch.rand(blk.gamma.shape, generator=g) * 0.9 + 0.1)
        model.head_audioset.bias.fill_(-1.1)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.safetensors"
    save_safetensors(model.state_dict(), str(path))
    return str(path), model


def _fixture_wav():
    _, data = wavfile.read(WAV)
    return (data / 32768.0).astype(np.float32)[None, :320000]


def _tone_index(directory, n_clips=8):
    """A synthetic packed HDF5 and its index (``make_packed_and_index``),
    its clips replaced by tones of rising pitch and loudness, so that the
    clips differ more than white noise does."""
    packed, index = make_packed_and_index(str(directory), n_clips=n_clips,
                                          clip_samples=32000, seed=1)
    rng = np.random.RandomState(2)
    t = np.arange(32000) / 32000.0
    waves = [(0.05 + 0.9 * i / (n_clips - 1)) * np.sin(2 * np.pi * 110.0 * 2 ** (i * 7 / 12) * t)
             + 0.02 * rng.randn(32000) for i in range(n_clips)]
    with h5py.File(packed, "a") as hf:
        hf["waveform"][...] = np.clip(np.stack(waves) * 32767, -32768, 32767).astype(np.int16)
    return index


def _run(argv, capsys):
    rc = _script().main(argv)
    return rc, capsys.readouterr().out


def _line(out, name):
    return next(line for line in out.splitlines() if line.startswith("[") and f"] {name}" in line)


def _verdicts(out):
    """[(PASS|FAIL, check name)] in the order the gate printed them."""
    return re.findall(r"^\[(PASS|FAIL)\] (.*?)(?::|$)", out, re.M)


def _indexes(out, tag):
    got = re.match(r".*?: \[(.*?)\]", _line(out, f"golden demo indexes ({tag})")).group(1)
    return [int(i) for i in got.split(",") if i.strip()]


def _metrics(out):
    got = re.search(r"^eval: mAP=(\S+) mAUC=(\S+) d'=(\S+)$", out, re.M)
    assert got, out
    return [float(v) for v in got.groups()]


def _run_both(argv, capsys, monkeypatch):
    """Run the port's gate (on the CPU) and the JAX package's gate with the
    same arguments. Returns {"port"|"jax": (exit code, stdout, evals)}, where
    evals lists, for each evaluation, the dtype name, block_impl and
    frontend precision it ran with and what ``infer_probs`` returned."""
    from audioset_convnext_inf_torch.engine.evaluator import Evaluator as PortEvaluator
    from audioset_convnext_inf_tpu.engine.evaluator import Evaluator as JaxEvaluator

    evals = {"port": [], "jax": []}

    def record(key, cls, describe):
        infer = cls.infer_probs

        def wrapped(self, loader):
            out = infer(self, loader)
            evals[key].append(describe(self) + (out,))
            return out
        monkeypatch.setattr(cls, "infer_probs", wrapped)

    record("port", PortEvaluator, lambda e: (str(e.model.compute_dtype).split(".")[-1],
                                            e.model.cfg.block_impl,
                                            e.model.cfg.frontend.precision))
    record("jax", JaxEvaluator, lambda e: (np.dtype(e.compute_dtype).name, e.cfg.block_impl,
                                          e.cfg.frontend.precision))
    runs = {}
    for key, main, extra in (("port", _script().main, ["--device", "cpu"]),
                             ("jax", _jax_script().main, [])):
        rc = main(argv + extra)
        runs[key] = (rc, capsys.readouterr().out, evals[key])
    return runs


def _port_probs(model, tag):
    """The port's probabilities on the fixture, in the model the gate runs
    the golden check with: f32, or with --bf16 the bf16 serving model."""
    from audioset_convnext_inf_torch.models import ConvNeXt

    if tag == "bf16":
        serve = ConvNeXt(model.cfg, compute_dtype=torch.bfloat16, device="cpu")
        serve.load_state_dict(model.state_dict(), strict=True)
        model = serve
    return model.forward(_fixture_wav())["clipwise_output"][0].float().numpy()


def _assert_gates_agree(runs, model, tags):
    """The same exit code and verdicts; each golden-index list equal to
    what the port's model puts above the threshold and, up to classes
    within PROB_TOL of it, to the JAX gate's list."""
    (rc, out, _), (jrc, jout, _) = runs["port"], runs["jax"]
    assert rc == jrc
    assert _verdicts(out) == _verdicts(jout), (out, jout)
    for tag in tags:
        probs = _port_probs(model, tag)
        printed = _indexes(out, tag)
        assert printed == np.where(probs > THRESHOLD)[0].tolist()
        apart = sorted(set(printed) ^ set(_indexes(jout, tag)))
        assert np.all(np.abs(probs[apart] - THRESHOLD) <= PROB_TOL[tag]), (tag, apart)


def test_counts_and_shapes_pass_and_golden_labels_fail(checkpoint, capsys, monkeypatch):
    """Exit 1: every structural check passes, the golden demo indexes fail
    (random weights), and the FAIL line lists exactly the indexes whose
    probability ``model.forward`` puts above 0.25 on the fixture. The JAX
    gate on the same file prints the same verdicts and indexes."""
    path, model = checkpoint
    runs = _run_both([path, "--wav", WAV], capsys, monkeypatch)
    rc, out, _ = runs["port"]
    assert rc == 1
    for name in ("param count", "logits shape (f32)", "scene embedding shape",
                 "frame embedding shape"):
        assert _line(out, name).startswith("[PASS]"), out
    assert "28,222,767" in _line(out, "param count")
    assert _line(out, "golden demo indexes (f32)").startswith("[FAIL]")
    assert _indexes(out, "f32") != [0, 137, 138, 139, 151, 506]
    assert 100 < len(_indexes(out, "f32")) < 427  # the threshold splits the classes
    assert out.rstrip().endswith("FAILED: ['golden demo indexes (f32)']")
    _assert_gates_agree(runs, model, ["f32"])


def test_a_missing_tensor_fails_cleanly(checkpoint, tmp_path, capsys):
    """A file without head_audioset.bias: the strict load refuses it, the
    script prints one FAIL line and exits 1, without a traceback."""
    from audioset_convnext_inf_torch.checkpoint.io import read_safetensors

    path, _ = checkpoint
    sd = read_safetensors(path)
    del sd["head_audioset.bias"]
    short = str(tmp_path / "short.safetensors")
    save_safetensors(sd, short)
    rc, out = _run([short, "--device", "cpu"], capsys)
    assert rc == 1
    line = _line(out, "load checkpoint")
    assert line.startswith("[FAIL]") and "head_audioset.bias" in line, out
    rc, out = _run([str(tmp_path / "absent.pth"), "--device", "cpu"], capsys)
    assert rc == 1 and _line(out, "load checkpoint").startswith("[FAIL]")


def _check_eval_route(checkpoint, directory, capsys, monkeypatch, precision):
    """--eval-indexes over 8 one-second tone clips of a synthetic packed
    HDF5 at batch 4 through both gates, with --bf16 when ``precision`` is
    "bf16": the port evaluates in the JAX gate's configuration (dtype,
    block_impl, frontend precision), forwards the same clips in the same
    order to probabilities within PROB_TOL of the JAX gate's with the same
    targets, and prints mAP and AUC within METRIC_TOL of the JAX figures;
    the verdicts and golden-index lists agree as in the f32-only run."""
    path, model = checkpoint
    index = _tone_index(directory)
    argv = [path, "--wav", WAV, "--eval-indexes", index, "--batch-size", "4"]
    tags = ["f32"] + (["bf16"] if precision == "bf16" else [])
    runs = _run_both(argv + (["--bf16"] if precision == "bf16" else []), capsys, monkeypatch)
    rc, out, evals = runs["port"]
    _, jout, jevals = runs["jax"]
    assert rc == 1
    assert _line(out, f"logits shape ({tags[-1]})").startswith("[PASS]")
    _assert_gates_agree(runs, model, tags)
    assert len(evals) == len(jevals) == 1
    *how, got = evals[0]
    *jhow, want = jevals[0]
    assert how == jhow == [{"f32": "float32", "bf16": "bfloat16"}[precision],
                           "xla" if precision == "f32" else "xla_approx", "highest"]
    assert got["clipwise_output"].shape == (8, 527)
    np.testing.assert_array_equal(got["target"], want["target"])
    np.testing.assert_allclose(got["clipwise_output"], np.asarray(want["clipwise_output"], np.float32),
                               rtol=0, atol=PROB_TOL[precision])
    m_ap, m_auc, _ = _metrics(out)
    j_ap, j_auc, _ = _metrics(jout)
    assert abs(m_ap - j_ap) <= METRIC_TOL[precision] and abs(m_auc - j_auc) <= METRIC_TOL[precision]
    assert f"published mAP: {m_ap:.4f} vs 0.471" in _line(out, "published mAP")


def test_eval_indexes_route(checkpoint, tmp_path, capsys, monkeypatch):
    """The evaluation route with --bf16: the bf16 golden check and a bf16
    evaluation with tanh-GELU blocks, both held against the JAX gate."""
    _check_eval_route(checkpoint, tmp_path, capsys, monkeypatch, "bf16")


def test_eval_indexes_route_f32(checkpoint, tmp_path, capsys, monkeypatch):
    """The evaluation route in f32, held against the JAX gate."""
    _check_eval_route(checkpoint, tmp_path, capsys, monkeypatch, "f32")
