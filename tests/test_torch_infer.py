"""The port's inference surfaces against the JAX package's: sliding
windows, long-audio tagging and embeddings, clip tagging, embedding
extraction to HDF5, and the demo, evaluate and extract-embeddings CLIs.

Both packages get the same carried weights (a small f32 config) and the
same numpy inputs. The JAX package's audio reading reaches its native
library (``utils/native.py``), whose first use runs ``make``; the tests
switch it off in this process (``native._TRIED``) so both take scipy.
"""

import logging
import os
import re

import h5py
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

import audioset_convnext_inf_tpu.models as jax_models
from audioset_convnext_inf_tpu.checkpoint.io import save_safetensors as jax_save_safetensors
from audioset_convnext_inf_tpu.cli import demo as jax_demo
from audioset_convnext_inf_tpu.config import ConvNeXtConfig as JaxConfig
from audioset_convnext_inf_tpu.engine import infer as JI
from audioset_convnext_inf_tpu.models import api as jax_api
from audioset_convnext_inf_tpu.utils import native

import audioset_convnext_inf_torch.models as port_models
from audioset_convnext_inf_torch.checkpoint import state_dict_from_jax_params, to_tensors
from audioset_convnext_inf_torch.checkpoint.io import save_safetensors
from audioset_convnext_inf_torch.cli import demo, evaluate, extract_embeddings
from audioset_convnext_inf_torch.config import ConvNeXtConfig
from audioset_convnext_inf_torch.engine import infer as I
from audioset_convnext_inf_torch.models import ConvNeXt

from tests.make_synth_hdf5 import make_packed_and_index
from tests.test_torch_checkpoint import _port_init
from tests.test_torch_model import SMALL, _randomize


@pytest.fixture(autouse=True)
def _numpy_data_plane(monkeypatch):
    monkeypatch.setattr(native, "_TRIED", True)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("AUDIOSET_TPU_NO_COMPILE_CACHE", "1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX model and the port's, f32 parity config, on the same weights."""
    jcfg = JaxConfig(**SMALL)
    params = _randomize(_port_init(ConvNeXtConfig(**SMALL), 3), np.random.RandomState(23))
    jm = jax_api.ConvNeXt(jcfg, jax.tree_util.tree_map(jnp.asarray, params))
    pm = ConvNeXt(ConvNeXtConfig(**SMALL), device="cpu")
    pm.load_state_dict(to_tensors(state_dict_from_jax_params(params)), strict=True)
    return jm, pm


def _long_signal(sample_wav_path, seconds):
    _, data = wavfile.read(sample_wav_path)
    reps = -(-seconds * 32000 // len(data))
    x = np.tile(data, reps)[: seconds * 32000].astype(np.float32) / 32767.0
    x += np.random.RandomState(5).randn(len(x)).astype(np.float32) * 1e-3
    return x


@pytest.mark.parametrize("n,window,hop", [(25, 10, None), (25, 10, 3), (10, 10, None),
                                          (3, 10, None), (31, 10, 7)])
@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.float64])
def test_sliding_windows_match_jax(n, window, hop, dtype):
    x = (np.random.RandomState(n).randn(n * 100) * 1000).astype(dtype)
    got, k = I.sliding_windows(x, window * 100, hop and hop * 100)
    want, kj = JI.sliding_windows(x, window * 100, hop and hop * 100)
    assert k == kj and got.dtype == want.dtype and got.shape == want.shape
    assert got.dtype == (np.int16 if dtype == np.int16 else np.float32)
    np.testing.assert_array_equal(got, want)


def test_long_audio_matches_jax(models, sample_wav_path):
    """A 25-s signal: tagging with a 5-s hop (4 windows, batches of 3, the
    last padded), f32; embeddings (3 windows, batches of 2) from int16.
    Probabilities within 1e-5, embeddings within 2e-4; the stitched frame
    embeddings are (C, 31*W, 7)."""
    jm, pm = models
    x = _long_signal(sample_wav_path, 25)
    got = I.tag_long_audio(pm, x, hop_samples=5 * 32000, batch_size=3)
    want = JI.tag_long_audio(jm, x, hop_samples=5 * 32000, batch_size=3)
    assert got["windowwise_output"].shape == (4, 527) and got["clipwise_output"].shape == (527,)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5, err_msg=k)
    mean = I.tag_long_audio(pm, x, hop_samples=5 * 32000, batch_size=3, reduce="mean")
    np.testing.assert_allclose(mean["clipwise_output"], got["windowwise_output"].mean(0), atol=1e-7)

    pcm = (x * 32767.0).astype(np.int16)
    got = I.embed_long_audio(pm, pcm, batch_size=2)
    want = JI.embed_long_audio(jm, pcm, batch_size=2)
    assert got["frame_embeddings"].shape == (256, 31 * 3, 7)
    assert got["windowwise_scene"].shape == (3, 256) and got["scene_embedding"].shape == (256,)
    for k in got:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=2e-4, err_msg=k)


def test_tag_clip_matches_jax(models, sample_wav_path):
    jm, pm = models
    clip = I.load_clip(sample_wav_path)
    np.testing.assert_array_equal(clip, JI.load_clip(sample_wav_path))
    assert clip.shape == (1, 320000) and clip.dtype == np.float32
    got, want = I.tag_clip(pm, clip, threshold=0.5), JI.tag_clip(jm, clip, threshold=0.5)
    assert len(got["indexes"]) > 0
    np.testing.assert_array_equal(got["indexes"], want["indexes"])
    assert got["labels"] == want["labels"]
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5)
    np.testing.assert_allclose(got["logits"], want["logits"], atol=2e-4)


def _write_wavs(directory, sample_wav_path):
    """One 44.1 kHz mono, one stereo 32 kHz, one broken file."""
    _, data = wavfile.read(sample_wav_path)
    rng = np.random.RandomState(9)
    paths = [os.path.join(directory, n) for n in ("a44k.wav", "b_stereo.wav", "c_broken.wav")]
    wavfile.write(paths[0], 44100, (rng.randn(44100 * 3) * 3000).astype(np.int16))
    wavfile.write(paths[1], 32000, np.stack([data[:96000], data[96000:192000]], axis=1))
    with open(paths[2], "wb") as f:
        f.write(b"RIFF\x00\x01\x00\x00WAVEnot really a wave file")
    return paths


@pytest.mark.parametrize("kind", ["logits", "scene"])
def test_extract_embeddings_to_hdf5_matches_jax(models, tmp_path, sample_wav_path, kind, caplog):
    jm, pm = models
    paths = _write_wavs(str(tmp_path), sample_wav_path)
    out, jout = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    with caplog.at_level(logging.WARNING):
        assert I.extract_embeddings_to_hdf5(pm, paths, out, kind=kind) == 2
    assert "c_broken.wav" in caplog.text
    assert JI.extract_embeddings_to_hdf5(jm, paths, jout, kind=kind) == 2
    with h5py.File(out, "r") as got, h5py.File(jout, "r") as want:
        assert sorted(got) == sorted(want) == ["a44k", "b_stereo"]
        for k in got:
            assert got[k].shape == ((527,) if kind == "logits" else (256,))
            np.testing.assert_allclose(got[k][()], want[k][()], atol=2e-4, err_msg=k)


@pytest.fixture
def small_factories(models, monkeypatch):
    """Both demos' random-weight model (``convnext_tiny``) becomes the small
    carried pair, so that their whole output can be compared."""
    jm, pm = models
    monkeypatch.setattr(jax_models, "convnext_tiny", lambda **kw: jm)
    monkeypatch.setattr(port_models, "convnext_tiny", lambda **kw: pm)
    return jm, pm


@pytest.mark.parametrize("extra", [[], ["--threshold", "0.6"],
                                   ["--long-audio", "--window-hop-seconds", "5"]])
def test_demo_prints_what_the_jax_demo_prints(small_factories, sample_wav_path, tmp_path,
                                              capsys, extra):
    audio = sample_wav_path
    if "--long-audio" in extra:
        audio = str(tmp_path / "long.wav")
        wavfile.write(audio, 32000, (_long_signal(sample_wav_path, 17) * 32767).astype(np.int16))
    assert jax_demo.main([audio] + extra) == 0
    want = capsys.readouterr().out.splitlines()
    assert demo.main([audio, "--device", "cpu"] + extra) == 0
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert any(re.fullmatch(r"  +\d+  .+  p=0\.\d{3}", ln) for ln in got)
    if not extra:
        assert got[-1] == "Frame-level embeddings, shape: (1, 256, 31, 7)"


def test_evaluate_cli(tmp_path, capsys):
    """The evaluate CLI on a convnext_tiny safetensors checkpoint (random
    weights) and a synthetic HDF5 pair: the JAX CLI's printed lines."""
    _, index = make_packed_and_index(str(tmp_path / "h5"), n_clips=10, clip_samples=32000, seed=4)
    ck = str(tmp_path / "tiny.safetensors")
    save_safetensors(port_models.convnext_tiny(device="cpu").state_dict(), ck)
    assert evaluate.main(["--checkpoint", ck, "--eval-indexes", index, "--bal-indexes", index,
                          "--batch-size", "4", "--num-workers", "2", "--keep-int16",
                          "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# params: 28222767"
    line = r"{}: mAP: (\d\.\d{{6}}), AUC: (\d\.\d{{6}}), d-prime: (-?\d+\.\d{{6}})  \(\d+\.\ds\)"
    assert re.fullmatch(line.format("Balanced train"), lines[1]), lines[1]
    assert re.fullmatch(line.format("Eval"), lines[2]), lines[2]
    assert lines[1].split("  (")[0].split(": ", 1)[1] == lines[2].split("  (")[0].split(": ", 1)[1]


def test_extract_embeddings_cli(small_factories, tmp_path, sample_wav_path, capsys):
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    _write_wavs(str(wav_dir), sample_wav_path)
    out = str(tmp_path / "emb.h5")
    assert extract_embeddings.main([str(wav_dir), "--out", out, "--kind", "scene",
                                    "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["WARNING: no checkpoint given - using random weights",
                     f"wrote 2/3 vectors to {out}"]
    with h5py.File(out, "r") as hf:
        assert sorted(hf) == ["a44k", "b_stereo"] and hf["a44k"].shape == (256,)


@pytest.mark.slow
def test_demo_output_equals_jax_at_tiny_width(tmp_path, sample_wav_path, capsys):
    """Both demos on one convnext_tiny safetensors file (seeded non-trivial
    weights, f32 parity config): the same lines, label for label."""
    jcfg = JaxConfig(drop_path_rate=0.0, after_stem_dim=(252, 56))
    params = _randomize(_port_init(ConvNeXtConfig(drop_path_rate=0.0), 4), np.random.RandomState(31))
    ck = str(tmp_path / "tiny.safetensors")
    jax_save_safetensors(params, jcfg, ck)
    assert jax_demo.main([sample_wav_path, "--checkpoint", ck]) == 0
    want = capsys.readouterr().out.splitlines()
    assert demo.main([sample_wav_path, "--checkpoint", ck, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert "Frame-level embeddings, shape: (1, 768, 31, 7)" in got
