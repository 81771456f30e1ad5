"""The port's fine-tuning CLI (``cli/finetune_audiocaps.py``) end to end on
the CPU: a root of 1-s FLAC clips (train, val, test), a reference-keyed
``.pth`` of a published-width Cnn14 written here, one epoch. It returns 0
and writes one checkpoint per epoch, named by the val mAP; the checkpoint
holds the ``.pth``'s base weights bit for bit, a moved head, and BN
running statistics moved by the train-mode base."""

import os

import numpy as np
import pytest
import torch

from audioset_convnext_inf_tpu.checkpoint.io import load_checkpoint as jax_load_checkpoint

from audioset_convnext_inf_torch.checkpoint import load_checkpoint, pann_state_dict_from_params
from audioset_convnext_inf_torch.cli import finetune_audiocaps
from audioset_convnext_inf_torch.models.pann import PANN_REGISTRY, create_pann_model
from tests.flac_encoder import encode_flac


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """3 train, 2 val, 2 test clips of 1 s at 32 kHz; two tags each."""
    root = tmp_path_factory.mktemp("ft_root")
    data = root / "AUDIOCAPS_32000Hz"
    rng = np.random.RandomState(0)
    mids = ["/m/09x0r", "/m/05zppz", "/m/02zsn", "/m/0ytgt"]
    for subset, n in (("train", 3), ("val", 2), ("test", 2)):
        (data / "audio" / subset).mkdir(parents=True)
        caps = ["audiocap_id,youtube_id,start_time,caption\n"]
        tags = ["youtube_id,mids\n"]
        for i in range(n):
            ytid = f"{subset}{i:03d}"
            caps.append(f"{i},{ytid},30,a sound {i}\n")
            tags.append(f"{ytid},{mids[i % 4]};{mids[(i + 1) % 4]}\n")
            pcm = (rng.randn(32000 - 500 * i) * 3000).clip(-32000, 32000).astype(np.int64)
            (data / "audio" / subset / f"{ytid}_30.flac").write_bytes(
                encode_flac(pcm, 32000, kind="verbatim", blocksize=4096))
        (data / f"{subset}.csv").write_text("".join(caps))
        (data / f"{subset}_tags.csv").write_text("".join(tags))
    return root


def test_one_epoch_on_the_cpu(root, tmp_path):
    ref = create_pann_model("Cnn14", seed=3, device="cpu")
    sd = {k: v.clone() for k, v in ref.state_dict().items()}
    sd["bn0.num_batches_tracked"] = torch.tensor(7)  # a reference entry the loader drops
    ckpt = tmp_path / "Cnn14.pth"
    torch.save({"model": sd}, ckpt)
    del ref
    out_dir = tmp_path / "out"
    rc = finetune_audiocaps.main(["--root", str(root), "--checkpoint", str(ckpt),
                                  "--epochs", "1", "--batch-size", "2",
                                  "--eval-batch-size", "2", "--lr", "1e-3",
                                  "--out-dir", str(out_dir), "--device", "cpu"])
    assert rc == 0
    (name,) = os.listdir(out_dir)
    assert name.startswith("model_epoch_0001_mAP_")
    assert 0.0 < float(name.rsplit("_", 1)[1]) <= 1.0
    state = load_checkpoint(str(out_dir / name))
    assert state["iteration"] == 1
    got = pann_state_dict_from_params(state["params"], PANN_REGISTRY["Cnn14"])
    assert set(got) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for k, v in got.items():
        start = sd[k].numpy()
        if k.startswith(("fc1.", "fc_audioset.")):
            assert not np.array_equal(v, start), k  # the head moved
        elif k.endswith(("running_mean", "running_var")):
            assert not np.array_equal(v, start), k  # the base's BN statistics adapted
        else:
            np.testing.assert_array_equal(v, start, err_msg=k)  # the frozen base
    # the JAX package reads the same directory
    jax_state = jax_load_checkpoint(str(out_dir / name))
    np.testing.assert_array_equal(np.asarray(jax_state["params"]["fc1"]["w"]),
                                  got["fc1.weight"].T)


def test_needs_the_card_or_an_explicit_cpu(root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune_audiocaps.main(["--root", str(root), "--epochs", "1"])
