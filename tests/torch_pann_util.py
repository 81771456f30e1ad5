"""Shared helpers of the PANN zoo's port tests: perturbed weights drawn by
the port's init and carried into the JAX package's layout by its own
converter (``pann_state_dict_to_params``, the reference for the key
names), configs mirrored across the two packages, and the JAX package's
training forward with the random draws it made."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from audioset_convnext_inf_tpu.checkpoint.pann_convert import pann_state_dict_to_params
from audioset_convnext_inf_tpu.config import FrontendConfig as JaxFrontendConfig
from audioset_convnext_inf_tpu.config import SpecAugmentConfig as JaxSpecAugmentConfig
from audioset_convnext_inf_tpu.models import pann as JP
from audioset_convnext_inf_tpu.models import pann_layers as JPL

from audioset_convnext_inf_torch.models import pann_layers as P
from audioset_convnext_inf_torch.models.pann import build_pann_model

# f32 on the CPU on both sides; the sums run in other orders
PROB_TOL = 1e-4  # probabilities, embeddings, framewise output, block outputs
LOGIT_TOL = 3e-4  # the JAX package's own Cnn14 oracle bound (tests/test_pann.py)


@torch.no_grad()
def perturb_(module: torch.nn.Module, rng: np.random.RandomState, offset_std: float = 0.0,
             weights: bool = True):
    """Seeded values for every parameter and BN statistic, so that no
    branch hides behind an init zero (residual BN scales, deformable
    offset and modulator convs): weights +0.02 N(0, 1) (the deformable
    offset convs +``offset_std`` N(0, 1) where given), biases 0.05 N(0, 1),
    norm scales 1 + 0.1 N(0, 1), running means 0.1 N(0, 1), running
    variances U(0.5, 2). bn0 of a log-mel model normalizes its dB input.
    ``weights=False`` keeps the conv and linear weights of the init."""
    gen = np.random.default_rng(rng.randint(2 ** 31))

    def normal(shape):
        return gen.standard_normal(shape, dtype=np.float32)

    for name, t in module.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(t.shape)
        db = name.startswith("bn0.") and not hasattr(module, "conv0")  # over log-mel dB
        if leaf == "running_mean":
            v = normal(shape) * 5.0 - 40.0 if db else normal(shape) * 0.1
        elif leaf == "running_var":
            v = gen.uniform(100.0, 400.0, shape) if db else gen.uniform(0.5, 2.0, shape)
        elif leaf == "bias":
            v = t.numpy() + normal(shape) * 0.05
        elif t.ndim == 1:
            v = 1.0 + normal(shape) * 0.1
        elif "offset_conv" in name and offset_std:
            v = normal(shape) * offset_std
        elif weights:
            v = t.numpy() + normal(shape) * 0.02
        else:
            continue
        t.copy_(torch.from_numpy(np.asarray(v, np.float32)))


def state_dict(module: torch.nn.Module, prefix: str = ""):
    return {prefix + k: v.numpy().copy() for k, v in module.state_dict().items()}


def jax_params(module: torch.nn.Module, prefix: str, family: str, *path):
    """The JAX subtree of ``module``'s weights: its state dict under
    ``prefix`` through the JAX converter for ``family``, at ``path``."""
    tree = pann_state_dict_to_params(state_dict(module, prefix),
                                     JP.PannConfig(name="t", family=family))
    for p in path:
        tree = tree[p]
    return tree


def jax_frontend(cfg) -> JaxFrontendConfig:
    return JaxFrontendConfig(**dataclasses.asdict(cfg))


def jax_config(cfg) -> "JP.PannConfig":
    """The JAX package's PannConfig with the port config's fields."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["frontend"] = jax_frontend(cfg.frontend)
    kw["spec_augment"] = JaxSpecAugmentConfig(**dataclasses.asdict(cfg.spec_augment))
    return JP.PannConfig(**kw)


def jax_forward(model, waveform: np.ndarray, compute_dtype=None):
    """The JAX package's forward of ``model``'s weights, on the same
    waveform: its family's apply, jitted, with its own LogMelFrontend
    (``JP.PannModel``)."""
    cfg = jax_config(model.cfg)
    params = pann_state_dict_to_params(state_dict(model), cfg)
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    out = JP.PannModel(cfg, params, **kw).forward(waveform)
    return {k: np.asarray(v) for k, v in out.items()}


def model_(cfg, seed, offset_std=0.0, weights=True):
    """The port's model of ``cfg`` from its init (seed), perturbed."""
    model = build_pann_model(cfg, seed=seed, device="cpu")
    perturb_(model, np.random.RandomState(seed + 17), offset_std, weights)
    return model


def waveform_(batch, samples, seed):
    """A seeded (batch, samples) f32 waveform at about -20 dBFS."""
    return (np.random.RandomState(seed).randn(batch, samples) * 0.1).astype(np.float32)


def compare_(got, want):
    """Every output of the JAX forward, within its tolerance."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, w in want.items():
        tol = LOGIT_TOL if key == "clipwise_logits" else PROB_TOL
        close(got[key], w, tol, key)


def nchw(x):
    """JAX NHWC / NWC -> the port's NCHW / NCL (numpy)."""
    x = np.asarray(x)
    return np.moveaxis(x, -1, 1)


def built(cls, *args, seed=0, rng=None, **kw):
    """A block from the port's init, then perturbed."""
    mod = cls(*args, **kw)
    P.init_params_(mod, torch.Generator().manual_seed(seed))
    if rng is not None:
        perturb_(mod, rng)
    return mod.eval()


def close(got, want, tol=PROB_TOL, label=""):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                 for a in (got, want))
    assert got.shape == want.shape, (label, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol, f"{label}: max abs diff {err:.3e} > {tol:.0e}"
    return err


# The training forward (tests/test_torch_pann_train*.py), f32 on the CPU.
# BN in training normalizes by batch statistics, and over the few elements
# a channel holds deep in a net (B <= 4, maps of a few bins) it amplifies
# the f32 summation-order differences of the convolutions from layer to
# layer (measured here: about 1e-7 after the first BN, up to 4e-5 on the
# probabilities of the wavegram with dropout); the clips are long enough
# to keep the deepest maps at several bins.
TRAIN_PROB_TOL = 5e-5  # probabilities, absolute
# logits, segmentwise and framewise outputs, embeddings: of their largest magnitude
TRAIN_OUT_TOL = 1e-4
TRAIN_BN_TOL = 3e-5  # every bn_updates mean and variance: of its largest magnitude


def _stripes(key, b, width, n):
    """The stripes JAX's ``_drop_stripes`` draws from ``key``."""
    wkey, bkey = jax.random.split(key)
    widths = jax.random.randint(wkey, (b, n), 0, width)
    u = jax.random.uniform(bkey, (b, n))
    return torch.from_numpy(np.array(widths, np.int64)), torch.from_numpy(np.array(u))


def jax_forward_train(model, wave, seed, mixup_lambda=None):
    """The JAX package's forward_train of ``model``'s weights and config
    (op by op), and the draws it made, in its KeyStream's order: its
    ``dropout`` and ``spec_augment`` are wrapped to record each mask and
    stripe set as they draw it from its key."""
    cfg = jax_config(model.cfg)
    jm = JP.PannModel(cfg, pann_state_dict_to_params(state_dict(model), cfg))
    draws = []
    dropout, spec_augment = JPL.dropout, JP.spec_augment

    def rec_dropout(x, rate, key):
        draws.append(None if rate == 0.0 else
                     torch.from_numpy(np.array(jax.random.bernoulli(key, 1.0 - rate, x.shape))))
        return dropout(x, rate, key)

    def rec_spec_augment(key, x, time_axis, freq_axis, cfg):
        tkey, fkey = jax.random.split(key)
        b = x.shape[0]
        draws.append((_stripes(tkey, b, cfg.time_drop_width, cfg.time_stripes_num),
                      _stripes(fkey, b, cfg.freq_drop_width, cfg.freq_stripes_num)))
        return spec_augment(key, x, time_axis, freq_axis, cfg)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JPL, "dropout", rec_dropout)
        mp.setattr(JP, "spec_augment", rec_spec_augment)
        lam = None if mixup_lambda is None else jax.numpy.asarray(mixup_lambda)
        out = jm.forward_train(jax.numpy.asarray(wave), jax.random.PRNGKey(seed), lam)
    finally:
        mp.undo()
    bn = {path: {k: np.asarray(v) for k, v in stats.items()}
          for path, stats in out.pop("bn_updates").items()}
    return {k: np.asarray(v) for k, v in out.items()}, bn, draws


def _rel(got, want, tol, label):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{label}: max abs diff {err:.3e} > {tol:.0e} x {scale:.3e}"


def compare_train(got, want, want_bn):
    """Every output and ``bn_updates`` entry of the JAX training forward,
    within the TRAIN_ tolerances, on the same dotted paths."""
    bn = got.pop("bn_updates")
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, w in want.items():
        if key == "clipwise_output":
            err = float(np.abs(got[key].detach().numpy() - w).max())
            assert err <= TRAIN_PROB_TOL, f"{key}: {err:.3e}"
        else:
            _rel(got[key], w, TRAIN_OUT_TOL, key)
    assert set(bn) == set(want_bn), sorted(set(bn) ^ set(want_bn))
    for path, stats in want_bn.items():
        assert set(bn[path]) == set(stats), path
        for leaf in ("mean", "var"):
            _rel(bn[path][leaf], stats[leaf], TRAIN_BN_TOL, f"{path}.{leaf}")


