"""Small host utilities of the port against the JAX package's:
``data/loader.py::device_prefetch`` (on the CPU here; the card's copy
stream runs in chip_smoke.py phase 14), ``parallel/mesh.py::
pad_batch_to_multiple``, ``utils/logging_utils.py``'s ``get_filename`` and
``get_sub_filepaths``, and ``__version__``. Each is exact: arrays bit-equal,
lists and strings equal."""

import os

import numpy as np
import pytest
import torch

import audioset_convnext_inf_tpu as J
from audioset_convnext_inf_tpu.data import loader as JL
from audioset_convnext_inf_tpu.parallel import mesh as JM
from audioset_convnext_inf_tpu.utils import logging_utils as JU

import audioset_convnext_inf_torch as T
from audioset_convnext_inf_torch.data import DataLoader, device_prefetch
from audioset_convnext_inf_torch.parallel.mesh import pad_batch_to_multiple
from audioset_convnext_inf_torch.utils import get_filename, get_sub_filepaths


def _batches(n=5, b=3):
    rng = np.random.RandomState(0)
    return [{"waveform": (rng.randn(b, 40) * 3000).astype(np.int16),
             "target": rng.rand(b, 5).astype(np.float32),
             "mask": rng.rand(b) < 0.5,
             "audio_name": np.array([f"c{i}_{j}" for j in range(b)]),
             "valid": b - (i == n - 1)} for i in range(n)]


@pytest.mark.parametrize("size", [1, 2, 4])
def test_device_prefetch_on_the_cpu(size):
    """Every batch, in order: numeric arrays as tensors on the device, bit
    for bit; bool masks, names and counts as they were (the JAX package's
    contract)."""
    host = _batches()
    got = list(device_prefetch(iter(host), "cpu", size=size))
    want = list(JL.device_prefetch(iter(host), size=size))
    assert len(got) == len(want) == len(host)
    for g, w, h in zip(got, want, host):
        assert sorted(g) == sorted(h)
        for k in ("waveform", "target"):
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), h[k])
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        assert g["mask"] is h["mask"] and g["audio_name"] is h["audio_name"]
        assert g["valid"] == h["valid"] == w["valid"]


def test_device_prefetch_over_the_loader():
    class DS:
        def __getitem__(self, meta):
            i = meta["i"]
            return {"waveform": np.full(6, i, np.float32), "target": np.eye(4)[i % 4]}

    loader = DataLoader(DS(), [[{"i": i} for i in range(j, j + 3)] for j in range(0, 9, 3)],
                        num_workers=2, pad_to_batch_size=4)
    out = list(device_prefetch(loader, torch.device("cpu")))
    assert [b["valid"] for b in out] == [3, 3, 3]
    assert out[2]["waveform"][:, 0].tolist() == [6.0, 7.0, 8.0, 0.0]


@pytest.mark.parametrize("multiple", [1, 4, 8])
def test_pad_batch_to_multiple_matches_jax(multiple):
    batch = _batches(1, 5)[0]
    got, n = pad_batch_to_multiple(batch, multiple)
    want, jn = JM.pad_batch_to_multiple(batch, multiple)
    assert n == jn == 5 and sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]
    assert got["waveform"].shape[0] == -(-5 // multiple) * multiple
    assert pad_batch_to_multiple({"valid": 3}, 4) == ({"valid": 3}, None)


def test_file_helpers_and_version(tmp_path):
    (tmp_path / "a" / "b").mkdir(parents=True)
    for p in ("x.wav", "a/y.flac", "a/b/z.tar.gz"):
        (tmp_path / p).write_text("")
    os.symlink(tmp_path / "a" / "y.flac", tmp_path / "link.h5")
    assert get_sub_filepaths(str(tmp_path)) == JU.get_sub_filepaths(str(tmp_path))
    assert len(get_sub_filepaths(str(tmp_path))) == 4
    for p in ("x.wav", "a/b/z.tar.gz", "link.h5", "a/"):
        assert get_filename(str(tmp_path / p)) == JU.get_filename(str(tmp_path / p)), p
    assert get_filename(str(tmp_path / "link.h5")) == "y"
    assert T.__version__ == J.__version__ == "0.1.0"
