"""Every one of the 49 registry names in the port, and the checkpoint route.

- Each name builds and forwards in the port (CPU, a 1-s clip at its sample
  rate), with the shapes and ranges tests/test_pann.py asserts of the JAX
  package's zoo.
- Each name's state dict, through the JAX package's converter
  (``pann_state_dict_to_params``), is exactly the tree of
  ``jax.eval_shape`` of the JAX family's init: the same leaves, the same
  shapes. Neither side computes weights here: the port's init is skipped
  and the converter's final ``jnp.asarray`` records each leaf's shape and
  dtype, so its paths, names and layout transposes run as they are, on
  shapes alone.
- ``pann_state_dict_from_params`` inverts the converter on narrow variants
  of every family, value for value; ``load_pann_state_dict`` skips the
  frontend's entries and ranks ``cnn_next``'s uneven block labels.
"""

import types

import jax
import numpy as np
import pytest
import torch

from audioset_convnext_inf_tpu.checkpoint import pann_convert as jax_pann_convert
from audioset_convnext_inf_tpu.models import pann as JP

from audioset_convnext_inf_torch.checkpoint import pann_state_dict_from_params
from audioset_convnext_inf_torch.checkpoint.pann_convert import load_pann_state_dict
from audioset_convnext_inf_torch.models import PANN_REGISTRY, create_pann_model
from audioset_convnext_inf_torch.models import pann as PM
from audioset_convnext_inf_torch.models import pann_layers as P
from tests.torch_pann_util import jax_config, model_, state_dict

NAMES = sorted(PANN_REGISTRY)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_registry_is_the_jax_registry():
    assert len(NAMES) == 49 and NAMES == sorted(JP.PANN_REGISTRY)
    for name in NAMES:
        assert jax_config(PANN_REGISTRY[name]) == JP.PANN_REGISTRY[name], name
    import audioset_convnext_inf_torch as port

    assert port.PANN_REGISTRY is PANN_REGISTRY and port.PannModel is PM.PannModel
    assert port.create_pann_model is create_pann_model


@pytest.mark.parametrize("name", NAMES)
def test_zoo_model_forward(name):
    model = create_pann_model(name, seed=0, device="cpu")
    sr = model.cfg.frontend.sample_rate
    x = (np.random.RandomState(1234).randn(1, sr) * 0.1).astype(np.float32)
    out = model.forward(x)
    assert out["clipwise_output"].shape == (1, 527), name
    probs = out["clipwise_output"].numpy()
    assert np.isfinite(probs).all() and (probs >= 0).all() and (probs <= 1).all(), name
    if "DecisionLevel" in name:
        assert out["framewise_output"].shape == (1, model.cfg.frontend.num_frames(sr), 527)
        assert out["segmentwise_output"].shape[2] == 527
    else:
        assert out["embedding"].shape == (1, model.fc_audioset.in_features)
        assert torch.isfinite(out["clipwise_logits"]).all()


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: (tuple(x.shape), np.dtype(x.dtype)), tree)


@pytest.mark.parametrize("name", NAMES)
def test_zoo_state_dict_is_the_jax_init_tree(name, monkeypatch):
    monkeypatch.setattr(P, "init_params_", lambda model, generator: None)
    monkeypatch.setattr(jax_pann_convert, "jnp", types.SimpleNamespace(
        asarray=lambda v: jax.ShapeDtypeStruct(np.shape(v), np.asarray(v).dtype)))
    model = create_pann_model(name, device="cpu")
    tree = jax_pann_convert.pann_state_dict_to_params(model.state_dict(), name)
    cfg = JP.PANN_REGISTRY[name]
    init, _ = JP._FAMILIES[cfg.family]
    want = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    assert _shapes(tree) == _shapes(want)
    # the JAX package counts every leaf but the BN statistics; the port
    # counts its parameters (the statistics are buffers)
    n = sum(int(np.prod(leaf.shape)) for path, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]
            if path[-1].key not in ("mean", "var"))
    assert model.count_parameters() == n


def _cfg(name, **kw):
    return PM.PannConfig(name=name, **kw)


# one narrow variant per family (full width where the code fixes it)
ROUND_TRIP = {
    "cnn": _cfg("c", family="cnn", channels=(4, 8, 8, 8, 12, 16), block="seppw",
                deformable_blocks=(5, 6)),
    "cnn conv5x5": _cfg("c5", family="cnn", channels=(4, 8, 8, 12), block="conv5x5",
                        deformable_blocks=(4,)),
    "sed att": _cfg("s", family="sed", channels=(4, 8, 8, 8, 12, 16), sed_head="att"),
    "cnn_next": _cfg("n", family="cnn_next",
                     next_blocks=((64, 64, 3, "conv"), (64, 128, 3, "avg"), (128, 128, 3, "no"))),
    "cnn_next group1": _cfg("g", family="cnn_next", next_group1=True, use_fc1=False,
                            next_stem=False, next_blocks=((1, 8, 3, "conv"), (8, 16, 3, "conv"))),
    "leenet": _cfg("l", family="leenet", lee_double=True, lee_channels=(4, 8, 8, 16)),
    "dainet": PANN_REGISTRY["DaiNet19"],
    "res1dnet": _cfg("r", family="res1dnet", res1d_layers=(2, 1, 1, 1, 1, 1, 1)),
    "resnet": _cfg("rb", family="resnet", resnet_layers=(2, 1, 1, 1)),
    "resnet bottleneck": _cfg("rn", family="resnet", resnet_block="bottleneck",
                              resnet_layers=(1, 1, 1, 1)),
    "mobilenet_v1": PANN_REGISTRY["MobileNetV1"],
    "mobilenet_v2": PANN_REGISTRY["MobileNetV2"],
    "wavegram": PANN_REGISTRY["Wavegram_Logmel_Cnn14"],
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIP))
def test_from_params_inverts_the_jax_converter(case):
    cfg = ROUND_TRIP[case]
    # the init's random weights, and every norm, bias and statistic perturbed
    model = model_(cfg, seed=len(case), weights=False)
    sd = state_dict(model)
    back = pann_state_dict_from_params(
        jax_pann_convert.pann_state_dict_to_params(sd, jax_config(cfg)), cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k
    fresh = PM.build_pann_model(cfg, seed=99, device="cpu")
    load_pann_state_dict(fresh, back)
    for k, v in fresh.state_dict().items():
        assert np.array_equal(v.numpy(), sd[k]), k


def test_load_skips_the_frontend_and_is_strict():
    cfg = ROUND_TRIP["sed att"]
    model = model_(cfg, seed=1)
    sd = {k: torch.from_numpy(v) for k, v in state_dict(model).items()}
    extra = {"spectrogram_extractor.stft.conv_real.weight": torch.zeros(513, 1, 1024),
             "logmel_extractor.melW": torch.zeros(513, 64),
             "spec_augmenter.freq_dropper.x": torch.zeros(1),
             "bn0.num_batches_tracked": torch.tensor(7),
             "conv_block1.bn1.num_batches_tracked": torch.tensor(7)}
    fresh = PM.build_pann_model(cfg, seed=2, device="cpu")
    load_pann_state_dict(fresh, {**sd, **extra})
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())
    with pytest.raises(RuntimeError, match="Missing key"):
        load_pann_state_dict(fresh, {k: v for k, v in sd.items() if k != "fc1.bias"})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_pann_state_dict(fresh, {**sd, "fc2.weight": torch.zeros(1)})


def test_cnn_next_block_labels_are_ranked():
    """The reference labels Cnn10Next's blocks conv_block11, 12, 21, ...
    (models.py:1363-1372); they load in their sorted order, as the JAX
    converter ranks them."""
    cfg = ROUND_TRIP["cnn_next"]
    model = model_(cfg, seed=3)
    labels = {1: 11, 2: 12, 3: 21}
    sd = {}
    for k, v in state_dict(model).items():
        if k.startswith("conv_block"):
            i, rest = k[len("conv_block"):].split(".", 1)
            k = f"conv_block{labels[int(i)]}.{rest}"
        sd[k] = v
    fresh = PM.build_pann_model(cfg, seed=4, device="cpu")
    load_pann_state_dict(fresh, sd)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    want = jax_pann_convert.pann_state_dict_to_params(sd, jax_config(cfg))
    got = pann_state_dict_from_params(want, cfg)
    assert set(got) == set(model.state_dict())
