"""The port's legacy inference CLI (cli/inference.py) on the fixture
recording, on the CPU.

The checkpoint is one the test writes: a perturbed Cnn14 (whose keys are
also Cnn14_DecisionLevelMax's) under the reference's key names, with the
frontend's and BN's extra entries (``spectrogram_extractor.*``,
``logmel_extractor.*``, ``num_batches_tracked``) that the loader skips.
Both modes print the top-k of the port's own ``PannModel.forward`` on the
same clip; audio tagging also prints the tags the JAX package's CLI prints
for the same file and checkpoint (labels in the same order, probabilities
within the 3-decimal print).
"""

import csv
import os

import numpy as np
import pytest
import torch

from audioset_convnext_inf_torch.checkpoint.pann_convert import load_pann_state_dict
from audioset_convnext_inf_torch.cli import inference
from audioset_convnext_inf_torch.data.audio_io import read_wav
from audioset_convnext_inf_torch.labels import read_audioset_label_tags
from audioset_convnext_inf_torch.models import create_pann_model
from tests.torch_pann_util import perturb_

TOP_K = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    model = create_pann_model("Cnn14", seed=3, device="cpu")
    perturb_(model, np.random.RandomState(5))
    sd = dict(model.state_dict())
    sd["spectrogram_extractor.stft.conv_real.weight"] = torch.zeros(513, 1, 1024)
    sd["logmel_extractor.melW"] = torch.zeros(513, 64)
    for k in list(sd):
        if k.endswith(".running_mean"):
            sd[k[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(100)
    path = tmp_path_factory.mktemp("pann") / "Cnn14_random.pth"
    torch.save(sd, path)
    return str(path)


def _forward(name, checkpoint, wav_path):
    model = create_pann_model(name, device="cpu")
    load_pann_state_dict(model, torch.load(checkpoint, weights_only=True))
    wav, _ = read_wav(wav_path, target_sr=model.cfg.frontend.sample_rate)
    return model.forward(wav[None, :])


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln and not ln.startswith("WARN")]


def _tags(lines):
    """'label: 0.123' -> [(label, 0.123)]."""
    return [(ln.rsplit(": ", 1)[0], float(ln.rsplit(" ", 1)[1])) for ln in lines]


def test_audio_tagging_prints_the_forward_top_k(checkpoint, sample_wav_path, capsys):
    argv = ["audio_tagging", "--audio-path", sample_wav_path, "--checkpoint", checkpoint,
            "--top-k", str(TOP_K), "--device", "cpu"]
    assert inference.main(argv) == 0
    tags = _tags(_lines(capsys))
    probs = _forward("Cnn14", checkpoint, sample_wav_path)["clipwise_output"][0].numpy()
    order = np.argsort(probs)[::-1][:TOP_K]
    lm = read_audioset_label_tags()
    assert [t[0] for t in tags] == [lm.ix_to_lb[int(i)] for i in order]
    assert [t[1] for t in tags] == [float(f"{probs[i]:.3f}") for i in order]
    assert len({t[1] for t in tags}) > 1  # the weights spread the answer


def test_audio_tagging_matches_the_jax_cli(checkpoint, sample_wav_path, capsys, monkeypatch):
    from audioset_convnext_inf_tpu.cli import inference as jax_inference

    monkeypatch.setenv("AUDIOSET_TPU_NO_COMPILE_CACHE", "1")  # nothing written outside
    common = ["audio_tagging", "--audio-path", sample_wav_path, "--checkpoint", checkpoint,
              "--top-k", str(TOP_K)]
    assert inference.main(common + ["--device", "cpu"]) == 0
    ours = _tags(_lines(capsys))
    assert jax_inference.main(common) == 0
    theirs = _tags(_lines(capsys))
    assert [t[0] for t in ours] == [t[0] for t in theirs]
    assert np.max(np.abs(np.subtract([t[1] for t in ours], [t[1] for t in theirs]))) <= 1e-3


def test_sound_event_detection_csv_and_plot(checkpoint, sample_wav_path, tmp_path, capsys):
    out_csv, fig = tmp_path / "events.csv", tmp_path / "sed.png"
    argv = ["sound_event_detection", "--audio-path", sample_wav_path,
            "--model-type", "Cnn14_DecisionLevelMax", "--checkpoint", checkpoint,
            "--top-k", str(TOP_K), "--out-csv", str(out_csv), "--plot", str(fig),
            "--device", "cpu"]
    assert inference.main(argv) == 0
    lines = _lines(capsys)
    framewise = _forward("Cnn14_DecisionLevelMax", checkpoint,
                         sample_wav_path)["framewise_output"][0].numpy()
    assert lines[0] == f"framewise output: {framewise.shape}" and framewise.shape == (1001, 527)
    top = np.argsort(framewise.max(axis=0))[::-1][:TOP_K]
    lm = read_audioset_label_tags()
    assert [ln.split(": max frame prob")[0] for ln in lines[1:TOP_K + 1]] == [
        lm.ix_to_lb[int(i)] for i in top]
    with open(out_csv) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["frame", "class_index", "label", "prob"] and len(rows) == TOP_K + 1
    for row, ix in zip(rows[1:], top):
        fr = int(framewise[:, ix].argmax())
        assert (int(row[0]), int(row[1]), row[2]) == (fr, int(ix), lm.ix_to_lb[int(ix)])
        assert abs(float(row[3]) - framewise[fr, ix]) <= 1e-6
    assert os.path.getsize(fig) > 10000


def test_sed_needs_a_decision_level_model(sample_wav_path):
    with pytest.raises(SystemExit, match="no framewise output"):
        inference.main(["sound_event_detection", "--audio-path", sample_wav_path,
                        "--model-type", "DaiNet19", "--device", "cpu"])


def test_a_checkpoint_under_model_loads(sample_wav_path, tmp_path, capsys):
    """``{"model": state_dict}`` (the reference's training checkpoints) loads
    as the bare state dict does."""
    model = create_pann_model("DaiNet19", seed=1, device="cpu")
    perturb_(model, np.random.RandomState(2))
    bare, wrapped = tmp_path / "bare.pth", tmp_path / "wrapped.pth"
    torch.save(model.state_dict(), bare)
    torch.save({"model": model.state_dict(), "iteration": 7}, wrapped)
    printed = []
    for path in (bare, wrapped):
        assert inference.main(["audio_tagging", "--audio-path", sample_wav_path,
                               "--model-type", "DaiNet19", "--checkpoint", str(path),
                               "--device", "cpu"]) == 0
        printed.append(_lines(capsys))
    assert printed[0] == printed[1] and len(printed[0]) == 10
