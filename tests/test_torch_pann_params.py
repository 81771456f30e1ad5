"""The port's ``pann_state_dict_to_params`` (its copy of the JAX package's
``checkpoint/pann_convert.py:175``) for every one of the 49 registry models:
from the JAX package's parameter tree (its init's shapes by
``jax.eval_shape``, filled with distinct values, so no op-by-op init runs)
through the port's ``pann_state_dict_from_params`` and back, the same tree
bit for bit, lists and all; and the JAX package's converter makes the same
tree of the same state dict. ``bn_path`` names each BatchNorm of the
port's model by a path of that tree."""

import itertools

import jax
import numpy as np
import pytest

from audioset_convnext_inf_tpu.checkpoint.pann_convert import (
    pann_state_dict_to_params as jax_to_params,
)
from audioset_convnext_inf_tpu.models import pann as JP

from audioset_convnext_inf_torch.checkpoint import pann_convert as C
from audioset_convnext_inf_torch.models import pann as PM
from tests.torch_pann_util import jax_config


def _filled(tree):
    """Each leaf of an eval_shape tree as a ramp of f32 values, each leaf's
    from its own offset."""
    offsets = itertools.count()

    def fill(s):
        v = np.arange(int(np.prod(s.shape)), dtype=np.float32)
        v += next(offsets)
        return v.reshape(s.shape)

    return jax.tree_util.tree_map(fill, tree)


def _same(a, b, path="."):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{path}{k}.")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}{i}.")
    else:
        b = np.asarray(b)
        assert a.shape == b.shape and b.dtype == np.float32 and np.array_equal(a, b), path


def _get(tree, path):
    for p in path.split("."):
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree


@pytest.mark.parametrize("name", sorted(PM.PANN_REGISTRY))
def test_to_params_inverts_from_params(name):
    cfg = PM.PANN_REGISTRY[name]
    jcfg = jax_config(cfg)
    init, _ = JP._FAMILIES[cfg.family]
    tree = _filled(jax.eval_shape(lambda k: init(k, jcfg), jax.random.PRNGKey(0)))
    sd = C.pann_state_dict_from_params(tree, cfg)
    back = C.pann_state_dict_to_params(sd, cfg)
    _same(tree, back)
    _same(back, jax_to_params(sd, jcfg))
    # each BN's path, as bn_path names it from its module name, is a BN of the tree
    for key in sd:
        if key.endswith(".running_mean"):
            path = C.bn_path(cfg, key[: -len(".running_mean")])
            assert set(_get(back, path)) == {"scale", "bias", "mean", "var"}, key
