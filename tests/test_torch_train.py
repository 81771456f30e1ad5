"""The port's training path against the JAX package's: the trunk in
training mode (fused and unfused routes), the train step, the optimizer
and its schedules, and the training loop.

The JAX package makes the parameters; they get seeded non-trivial values
(init sets gamma = 1e-6, which would make every block nearly the identity)
and are carried into the port with ``state_dict_from_jax_params``. The same
inputs, made with numpy, go into both; the JAX package's random draws are
injected into the port where a test needs them.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from audioset_convnext_inf_tpu.config import AugmentConfig as JaxAugmentConfig
from audioset_convnext_inf_tpu.config import ConvNeXtConfig as JaxConfig
from audioset_convnext_inf_tpu.engine import trainer as JT
from audioset_convnext_inf_tpu.models import convnext as JF
from audioset_convnext_inf_tpu.parallel.mesh import get_mesh

from audioset_convnext_inf_torch.checkpoint import state_dict_from_jax_params, to_tensors
from audioset_convnext_inf_torch.config import AugmentConfig, ConvNeXtConfig, INT16_SCALE
from audioset_convnext_inf_torch.engine import trainer as T
from audioset_convnext_inf_torch.models import ConvNeXt
from audioset_convnext_inf_torch.models import convnext as F
from audioset_convnext_inf_torch.ops import fused_block_bwd as FBB

TRUNK = dict(depths=(1, 1, 2, 1), dims=(32, 64, 128, 256), block_impl="xla_approx")
SMALL = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), block_impl="xla_approx")


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


def _randomize(params, rng):
    """Seeded values of order 0.1-1 for gamma, norms and biases."""
    out = jax.tree_util.tree_map(np.asarray, params)

    def visit(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "gamma":
                    node[k] = rng.uniform(0.1, 1.0, v.shape)
                elif k in ("b", "bias"):
                    node[k] = rng.randn(*v.shape) * 0.05
                elif k == "scale":
                    node[k] = 1.0 + rng.randn(*v.shape) * 0.1
                else:
                    visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)

    for key in ("stem", "downsample", "stages", "final_norm", "head"):
        visit(out[key])
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


def _jax_params(cfg, seed=0):
    # jitted: op-by-op init of the many weight draws takes seconds
    init = jax.jit(JF.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    return _randomize(init, np.random.RandomState(seed))


def _port_model(params, cfg):
    model = ConvNeXt(cfg, device="cpu")
    model.load_state_dict(to_tensors(state_dict_from_jax_params(params, cfg)), strict=True)
    return model


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _grads_match(model, jax_grads, tol, skip=("bn0.", "head_audioset.")):
    ref = state_dict_from_jax_params(jax_grads)
    n = 0
    for name, p in model.named_parameters():
        if name.startswith(skip):
            continue
        assert p.grad is not None, name
        assert _rel_err(p.grad.numpy(), ref[name]) < tol, (name, _rel_err(p.grad.numpy(), ref[name]))
        n += 1
    return n


@pytest.fixture(scope="module")
def trunk_case():
    """The JAX package's fused-training integration case: B=16 (T=240,
    M=56), drop path 0.3, the XLA training trunk's value and gradients, and
    its per-block drop-path draws as the port's scales."""
    rng = np.random.RandomState(0)
    jcfg = JaxConfig(**TRUNK, drop_path_rate=0.3, fused_train_blocks=False)
    params = _jax_params(jcfg)
    x = rng.randn(16, 240, 56, 1).astype(np.float32) * 0.5
    r = rng.randn(16, 256).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def loss(params, x, r):
        return jnp.sum(JF.forward_features(x, params, jcfg, train_key=key) * r)

    val, (g_params, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(r))
    rates = np.linspace(0.0, 0.3, sum(jcfg.depths))
    scales = []
    for k, rate in zip(jax.random.split(key, sum(jcfg.depths)), rates):
        if rate == 0.0:
            scales.append(None)
            continue
        keep = np.asarray(jax.random.bernoulli(k, 1.0 - rate, (16, 1, 1, 1)), np.float32)
        scales.append(torch.from_numpy(keep.reshape(-1)) / (1.0 - float(rate)))
    return params, x, r, scales, float(val), g_params, np.asarray(g_x)


@pytest.mark.parametrize("fused", [True, False])
def test_train_trunk_matches_jax(trunk_case, fused, monkeypatch):
    """forward_features in training mode, f32, with JAX's drop-path draws:
    value within 2e-3 and parameter and input gradients within 3e-4 of
    scale (the JAX package's fused-vs-XLA tolerances). The fused route runs
    every stage-3/4 block through FusedBlockTrain; the unfused route none."""
    params, x, r, scales, val, g_params, g_x = trunk_case
    cfg = ConvNeXtConfig(**TRUNK, drop_path_rate=0.3, fused_train_blocks=fused)
    model = _port_model(params, cfg)
    model.train()
    calls = []
    plain = FBB.fused_block_bwd_reference
    monkeypatch.setattr(FBB, "fused_block_bwd_reference",
                        lambda x, *a: calls.append(tuple(x.shape)) or plain(x, *a))
    xt = torch.from_numpy(x).requires_grad_()
    emb = F.forward_features(model, xt, cfg, drop_path_scales=scales)
    out = (emb * torch.from_numpy(r)).sum()
    out.backward()
    assert calls == ([(16, 7, 1, 256), (16, 15, 3, 128), (16, 15, 3, 128)] if fused else [])
    assert abs(out.item() - val) < 2e-3 * max(1.0, abs(val))
    assert _grads_match(model, g_params, 3e-4) == 63
    assert _rel_err(xt.grad.numpy(), g_x) < 3e-4


def test_train_trunk_remat_blocks_is_the_same_computation(trunk_case):
    """remat_blocks recomputes the plain blocks in the backward: the same
    value and bit-equal gradients."""
    params, x, r, scales, _, _, _ = trunk_case
    results = []
    for remat in (False, True):
        cfg = ConvNeXtConfig(**dict(TRUNK, block_impl="xla"), drop_path_rate=0.3,
                             remat_blocks=remat)
        model = _port_model(params, cfg)
        model.train()
        emb = F.forward_features(model, torch.from_numpy(x), cfg, drop_path_scales=scales)
        (emb * torch.from_numpy(r)).sum().backward()
        results.append([p.grad.clone() for p in model.stages.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*results))


def _batch(rng, b=4, n=32000):
    wav = (rng.randn(b, n) * 0.1).astype(np.float32)
    target = np.zeros((b, 527), np.float32)
    target[np.arange(b), rng.randint(0, 527, b)] = 1.0
    return wav, target


def test_train_step_matches_jax(rng):
    """One train step, SpecAugment, mixup and drop path off, f32, through
    the port's fused route (FusedBlockTrain on stages 3-4) against the JAX
    package's make_train_step on a one-device mesh (XLA blocks): loss, every
    gradient and bn0's new running statistics. bn0's weight and bias take
    the optimizer's update."""
    aug = dict(use_spec_augment=False)
    jcfg = JaxConfig(**SMALL, augment=JaxAugmentConfig(**aug))
    cfg = ConvNeXtConfig(**SMALL, augment=AugmentConfig(**aug), fused_train_blocks=True)
    params = _jax_params(jcfg, seed=1)
    wav, target = _batch(rng)
    tcfg = dict(max_lr=1e-3, total_steps=100, seed=0)
    # the JAX step with SGD at learning rate 1: its update is minus the
    # gradient, so one compiled step gives the loss, the gradients and bn0
    sgd = optax.sgd(1.0)
    step = JT.make_train_step(jcfg, JT.TrainConfig(**tcfg), sgd, mesh=get_mesh(jax.devices()[:1]))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    new, _, jloss = step(jp, sgd.init(jp), jnp.asarray(wav), jnp.asarray(target), 0,
                         jax.random.PRNGKey(0))
    jgrads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), jp, new)

    model = _port_model(params, cfg)
    bn_w0 = model.bn0.weight.detach().clone()
    tr = T.Trainer(model, T.TrainConfig(**tcfg))
    got = tr.step(wav, target)
    assert not model.training  # the step leaves the mode as it found it
    np.testing.assert_allclose(got, float(jloss), rtol=1e-5)
    assert _grads_match(model, jgrads, 3e-4, skip=()) == 58
    new = new["bn0"]
    np.testing.assert_allclose(model.bn0.running_mean.numpy(), np.asarray(new["mean"]), rtol=1e-5)
    np.testing.assert_allclose(model.bn0.running_var.numpy(), np.asarray(new["var"]), rtol=1e-5)
    assert not torch.equal(model.bn0.weight.detach(), bn_w0)
    assert tr.step_index == 1


OPTIMIZERS = {
    "adamw": dict(),
    "adam": dict(optimizer="adam"),
    "adamw_wd_schedule": dict(use_wd_schedule=True, wd_constant_cooldown=False),
    "adamw_accumulate_2": dict(accumulation_steps=2),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax_given_the_same_gradients(rng, name):
    """Both optimizers take the same gradients for 8 calls; the parameters
    match within 1e-6 after each (a rank-2 tensor decays, rank-1 ones not)."""
    kw = dict(max_lr=1e-2, total_steps=10, weight_decay=0.1, **OPTIMIZERS[name])
    init = {"w": rng.randn(5, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    tx = JT.make_optimizer(jparams, JT.TrainConfig(**kw))
    state = tx.init(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = T.make_optimizer(params, T.TrainConfig(**kw))
    for step in range(8):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied = opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        assert applied == (kw.get("accumulation_steps", 1) == 1 or step % 2 == 1)
        for k in init:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), atol=1e-6,
                                       err_msg=f"{name} step {step} {k}")
    assert not np.allclose(params["w"].numpy(), init["w"])


@pytest.mark.parametrize("name", ["adamw", "adamw_accumulate_2"])
def test_the_cpu_optimizer_takes_the_plain_route_and_matches_optax(rng, name):
    """On CPU tensors every update runs the plain version (``loop_updates``
    counts it, no kernel launches) and lands where optax's does."""
    from audioset_convnext_inf_torch.ops import adamw

    kw = dict(max_lr=1e-2, total_steps=10, weight_decay=0.1, **OPTIMIZERS[name])
    init = {"w": rng.randn(3, 7).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    tx = JT.make_optimizer(jparams, JT.TrainConfig(**kw))
    state = tx.init(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = T.Optimizer(params, T.TrainConfig(**kw))
    launches = adamw.adamw_update_.launches
    applied = 0
    for _ in range(6):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied += opt.step({k: torch.from_numpy(v) for k, v in g.items()})
    assert (opt.loop_updates, opt.fused_updates) == (applied, 0) and applied == opt.count
    assert adamw.adamw_update_.launches == launches
    for k in init:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), atol=1e-6)


def test_optimizer_state_round_trip(rng):
    params = {"w": torch.from_numpy(rng.randn(3, 2).astype(np.float32))}
    cfg = T.TrainConfig(accumulation_steps=2)
    a = T.Optimizer(params, cfg)
    for _ in range(3):
        a.step({"w": torch.ones(3, 2)})
    b = T.Optimizer({"w": params["w"].clone()}, cfg)
    b.load_state_dict(a.state_dict())
    assert (b.count, b.mini_step) == (1, 1)
    assert torch.equal(b.mu["w"], a.mu["w"]) and torch.equal(b.acc["w"], a.acc["w"])


def test_schedules_match_optax():
    """OneCycle at every step of a short span and past its end, against
    optax.cosine_onecycle_schedule; both weight-decay schedules against the
    JAX package's."""
    cfg = T.TrainConfig(max_lr=3e-3, total_steps=50)
    jcfg = JT.TrainConfig(max_lr=3e-3, total_steps=50)
    ours, ref = T.onecycle_lr(cfg), optax.cosine_onecycle_schedule(
        transition_steps=50, peak_value=3e-3, pct_start=0.3, div_factor=25.0,
        final_div_factor=1e4)
    for step in range(60):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-5, atol=1e-12)
    assert ours(15) == pytest.approx(3e-3) and ours(0) == pytest.approx(3e-3 / 25)
    for constant in (True, False):
        kw = dict(weight_decay=0.02, total_steps=50, wd_constant_cooldown=constant)
        ours, ref = T.wd_schedule(T.TrainConfig(**kw)), JT.wd_schedule(JT.TrainConfig(**kw))
        for step in range(60):
            np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-5, atol=1e-12)
    assert T._wd_mask({"a": torch.zeros(2, 2), "b": torch.zeros(2)}) == {"a": True, "b": False}
    assert jcfg.max_lr == cfg.max_lr


def _small_model(seed=0, **kw):
    cfg = ConvNeXtConfig(**SMALL, fused_train_blocks=True, drop_path_rate=0.1, **kw)
    return _port_model(_jax_params(JaxConfig(**SMALL), seed=seed), cfg)


def test_int16_ingest_is_bit_identical(rng):
    """int16 PCM decoded on the device trains to bit-equal parameters with
    f32 ingest of the same decode (x * 1/32767), mixup and all."""
    pcm = (rng.randn(4, 32000) * 8000).astype(np.int16)
    target = np.zeros((4, 527), np.float32)
    target[np.arange(4), rng.randint(0, 527, 4)] = 1.0
    tcfg = T.TrainConfig(max_lr=1e-3, total_steps=10, seed=0, mixup_alpha=1.0)
    results = []
    for wav in (pcm, pcm.astype(np.float32) * np.float32(INT16_SCALE)):
        tr = T.Trainer(_small_model(), tcfg)
        for _ in range(2):
            tr.step(wav, target)
        results.append({k: v.clone() for k, v in tr.model.state_dict().items()})
    assert all(torch.equal(results[0][k], results[1][k]) for k in results[0])


def test_loss_falls_over_8_steps(rng):
    """The whole recipe (SpecAugment, mixup, drop path, fused stages 3-4)
    on one batch: the loss falls and stays finite."""
    wav, target = _batch(rng, b=8)
    tr = T.Trainer(_small_model(), T.TrainConfig(max_lr=1e-3, total_steps=100, mixup_alpha=1.0))
    losses = [tr.step(wav, target) for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_train_loop_callbacks_and_retries(rng, caplog):
    """Trainer.train from an in-memory iterable: checkpoints at the
    interval, the sampler snapshot of the last consumed batch, early stop;
    a batch that fails every retry writes an emergency checkpoint and
    raises; a non-finite loss is logged and training goes on."""
    wav, target = _batch(rng, b=2)
    batches = [{"waveform": wav, "target": target, "sampler_state": i} for i in range(6)]
    tr = T.Trainer(_small_model(), T.TrainConfig(max_lr=1e-3, total_steps=100))
    saved, seen = [], []
    tr.train(iter(batches), checkpoint_fn=lambda t, it: saved.append(it), checkpoint_interval=2,
             eval_fn=lambda m, it: seen.append(it), eval_interval=3, early_stop=5,
             log_interval=2)
    assert tr.step_index == 5 and saved == [2, 4] and seen == [3]
    assert tr.last_sampler_state == 4

    bad = [{"waveform": wav[:, :10], "target": target}]  # too short for the frontend
    saved.clear()
    with pytest.raises(Exception):
        tr.train(iter(bad), checkpoint_fn=lambda t, it: saved.append(it), max_step_retries=1)
    assert saved == [5] and tr.step_index == 5

    nan = [{"waveform": np.full_like(wav, np.nan), "target": target}]
    tr.train(iter(nan), log_interval=1)
    assert "non-finite loss" in caplog.text and tr.step_index == 6


def test_restore_adopts_a_checkpoint(rng):
    wav, target = _batch(rng, b=2)
    tcfg = T.TrainConfig(max_lr=1e-3, total_steps=100, seed=3)
    a = T.Trainer(_small_model(), tcfg)
    a.step(wav, target)
    sd = {k: v.clone() for k, v in a.model.state_dict().items()}
    opt = {k: (dict((n, t.clone()) for n, t in v.items()) if isinstance(v, dict) else v)
           for k, v in a.optimizer.state_dict().items()}
    a.step(wav, target)
    b = T.Trainer(_small_model(seed=5), tcfg)
    b.restore(sd, opt, 1)
    b.step(wav, target)
    assert all(torch.equal(a.model.state_dict()[k], b.model.state_dict()[k]) for k in sd)


def test_fused_route_gate():
    """Training takes the fused route only with fused_train_blocks, the tanh
    GELU, layer scale and no remat."""
    base = dict(SMALL, fused_train_blocks=True)
    model = ConvNeXt(ConvNeXtConfig(**base), device="cpu")
    assert not F.fused_train_route(model, model.cfg)  # eval mode
    model.train()
    for kw, want in ((dict(), True), (dict(block_impl="xla"), False),
                     (dict(layer_scale_init_value=0.0), False), (dict(remat_blocks=True), False),
                     (dict(fused_train_blocks=False), False)):
        assert F.fused_train_route(model, dataclasses.replace(model.cfg, **kw)) == want, kw
