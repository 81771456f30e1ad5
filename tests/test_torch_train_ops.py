"""The port's training-path ops against the JAX package's, with the JAX
draws injected.

JAX PRNG streams cannot be reproduced in torch, so each stochastic op of
the port is a draw and an apply: here the JAX package's own draws (made
from the same key the JAX op splits) go into the port's apply, and the
outputs must match exactly. Deterministic ops match within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioset_convnext_inf_tpu.config import SpecAugmentConfig as JaxSpecAugmentConfig
from audioset_convnext_inf_tpu.engine import losses as JLoss
from audioset_convnext_inf_tpu.models import layers as JL
from audioset_convnext_inf_tpu.ops import augment as JA
from audioset_convnext_inf_tpu.ops import mixup as JM
from audioset_convnext_inf_tpu.ops import specaugment as JS

from audioset_convnext_inf_torch.config import SpecAugmentConfig
from audioset_convnext_inf_torch.engine import losses as Loss
from audioset_convnext_inf_torch.models import layers as L
from audioset_convnext_inf_torch.ops import augment as A
from audioset_convnext_inf_torch.ops import mixup as M
from audioset_convnext_inf_torch.ops import specaugment as S


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by
    side, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    """A fresh seeded stream per test, whatever ran before in the worker."""
    return np.random.RandomState(1234)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_jax(rng, dtype):
    """bn0 in training: batch statistics over (B, T) per mel bin; the
    running variance takes the unbiased variance; momentum 0.1. Inputs are
    centred: the two frameworks sum the batch in other orders, and 1e-6
    absolute holds at this scale, not at log-mel offsets of -20 to -40."""
    x = (rng.randn(4, 30, 16) * 3.0).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 2.0, 16), "bias": rng.randn(16) * 0.5,
         "mean": rng.randn(16) * 5.0, "var": rng.uniform(1.0, 50.0, 16)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref, new = JL.batch_norm_train(jnp.asarray(x).astype(jdt), jax.tree_util.tree_map(jnp.asarray, p),
                                   eps=1e-5, axis=2)
    xt = _t(x).to(getattr(torch, dtype))
    rm, rv = _t(p["mean"]).clone(), _t(p["var"]).clone()
    got = L.batch_norm_train(xt, _t(p["scale"]), _t(p["bias"]), rm, rv, eps=1e-5, axis=2)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=1e-6,
                               rtol=1e-6 if dtype == "float32" else 2.0 ** -8)
    np.testing.assert_allclose(rm.numpy(), np.asarray(new["mean"]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(rv.numpy(), np.asarray(new["var"]), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drop_path_matches_jax(rng, dtype):
    x = rng.randn(8, 3, 4, 5).astype(np.float32)
    key, prob = jax.random.PRNGKey(3), 0.3
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = JL.drop_path(jnp.asarray(x).astype(jdt), key, prob)
    keep = np.asarray(jax.random.bernoulli(key, 1 - prob, (8, 1, 1, 1))).reshape(-1)
    assert 0 < keep.sum() < 8
    scale = _t(keep.astype(np.float32)) / (1 - prob)
    got = L.drop_path(_t(x).to(getattr(torch, dtype)), scale)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    assert L.drop_path(_t(x), None) is not None and L.draw_drop_path(None, 8, prob) is None


def test_draw_drop_path_keeps_at_the_rate():
    g = torch.Generator().manual_seed(0)
    s = torch.stack([L.draw_drop_path(g, 16, 0.25) for _ in range(200)])
    assert set(np.unique(s.numpy()).tolist()) == {0.0, np.float32(1 / 0.75)}
    assert abs(float((s > 0).float().mean()) - 0.75) < 0.03


def _jax_stripe_draws(key, b, width, n):
    wkey, bkey = jax.random.split(key)
    widths = jax.random.randint(wkey, (b, n), 0, width)
    u = jax.random.uniform(bkey, (b, n))
    return _t(widths), _t(u)


def test_spec_augment_matches_jax(rng):
    """Time stripes, then frequency stripes; width ~ U{0..w-1}, begin =
    floor(u * (size - width))."""
    x = rng.randn(6, 100, 64, 1).astype(np.float32)
    jcfg = JaxSpecAugmentConfig(time_drop_width=20, time_stripes_num=2, freq_drop_width=10,
                                freq_stripes_num=2)
    cfg = SpecAugmentConfig(time_drop_width=20, time_stripes_num=2, freq_drop_width=10,
                            freq_stripes_num=2)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(JS.spec_augment(key, jnp.asarray(x), 1, 2, jcfg))
    tkey, fkey = jax.random.split(key)
    draws = (_jax_stripe_draws(tkey, 6, 20, 2), _jax_stripe_draws(fkey, 6, 10, 2))
    got = S.spec_augment(_t(x), 1, 2, cfg, draws=draws).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (ref == 0).mean() > 0.05  # stripes were dropped
    # the port's own draws: same shapes, same value ranges
    g = torch.Generator().manual_seed(0)
    out = S.spec_augment(_t(x), 1, 2, cfg, generator=g)
    assert out.shape == x.shape and 0.0 < float((out == 0).float().mean()) < 0.6


def test_mixup_matches_jax(rng):
    x = rng.randn(8, 5, 3).astype(np.float32)
    lam = JM.get_mixup_lambda(jax.random.PRNGKey(2), 8, 1.0)
    ref = np.asarray(JM.do_mixup(jnp.asarray(x), lam))
    pairs = M.mixup_pairs(_t(np.asarray(lam)[0::2]))
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(lam))
    np.testing.assert_array_equal(M.do_mixup(_t(x), pairs).numpy(), ref)
    own = M.get_mixup_lambda(torch.Generator().manual_seed(0), 8, 1.0)
    assert own.shape == (8,) and torch.allclose(own[0::2] + own[1::2], torch.ones(4))
    assert bool(((own >= 0) & (own <= 1)).all())


def test_gain_and_roll_match_jax(rng):
    x = rng.randn(3, 400).astype(np.float32)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        gain = int(jax.random.randint(key, (), 0, 14)) - 7
        np.testing.assert_array_equal(A.gain_augment(_t(x), gain).numpy(),
                                      np.asarray(JA.gain_augment(key, jnp.asarray(x), 7)))
        shift = int(jax.random.randint(key, (), -50, 50))
        np.testing.assert_array_equal(A.roll_augment(_t(x), shift).numpy(),
                                      np.asarray(JA.roll_augment(key, jnp.asarray(x), 50)))
    g = torch.Generator().manual_seed(0)
    gains = {A.draw_gain(g, 7) for _ in range(300)}
    assert gains == set(range(-7, 7))
    shifts = [A.draw_roll(g, 50) for _ in range(300)]
    assert min(shifts) >= -50 and max(shifts) < 50


def _jax_speed_draw(key, length, rates=(0.5, 1.5), p=0.5):
    """The draws JA.speed_perturb makes from ``key``, as the port's SpeedDraw."""
    pkey, rkey, akey = jax.random.split(key, 3)
    rate = jax.random.uniform(rkey, (), minval=rates[0], maxval=rates[1])
    stretched = int(jnp.ceil(length * rate))
    missing, diff = max(length - stretched, 0), max(stretched - length, 0)
    kpad, kcrop = jax.random.split(akey)
    pad_left = int(jax.random.randint(kpad, (), 0, missing + 1))
    crop_start = int(jax.random.randint(kcrop, (), 0, max(diff, 1)))
    apply = bool(jax.random.uniform(pkey, ()) <= p)
    return A.SpeedDraw(float(rate), pad_left, crop_start, apply)


def test_speed_perturb_matches_jax(rng):
    x = rng.randn(2, 1000).astype(np.float32)
    seen = set()
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        draw = _jax_speed_draw(key, 1000)
        seen.add((draw.apply, draw.rate > 1.0))
        ref = np.asarray(JA.speed_perturb(key, jnp.asarray(x)))
        np.testing.assert_array_equal(A.speed_perturb(_t(x), draw).numpy(), ref)
    assert seen == {(False, False), (False, True), (True, False), (True, True)}
    own = A.draw_speed(torch.Generator().manual_seed(0), 1000)
    assert 0.5 <= own.rate < 1.5 and A.speed_perturb(_t(x), own).shape == x.shape


@pytest.mark.parametrize("loss_type", ["clip_bce", "f1micro", "f1macro", "set_acc"])
def test_losses_match_jax(rng, loss_type):
    logits = (rng.randn(6, 527) * 3).astype(np.float32)
    target = (rng.rand(6, 527) > 0.9).astype(np.float32)
    probs = 1.0 / (1.0 + np.exp(-logits))
    out = {"clipwise_logits": logits, "clipwise_output": probs}
    ref = float(JLoss.get_loss_func(loss_type)({k: jnp.asarray(v) for k, v in out.items()},
                                               {"target": jnp.asarray(target)}))
    got = float(Loss.get_loss_func(loss_type)({k: _t(v) for k, v in out.items()},
                                             {"target": _t(target)}))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        Loss.get_loss_func("nope")
