"""The port's transfer trainer (``engine/transfer.py``) against the JAX
package's, and the PANN checkpoint layout it writes.

 - ``head_only_labels`` / ``merge_bn_stats``: what trains, what merges;
 - the AMSGrad rule against ``optax.amsgrad`` over 20 steps of gradients
   that shrink 10x a step, within 1e-6 (and ``torch.optim.Adam(amsgrad=
   True)``, which is not that rule, parting from it);
 - three ``TransferTrainer`` steps of a narrow Cnn14 (the Cnn14 config with
   a narrow channel ladder, dropout 0 and SpecAugment off on both sides) on
   1-s clips against the JAX ``TransferTrainer``: losses within 1e-5, fc1
   and fc_audioset within 1e-5 of their largest magnitude, every other
   weight bit-equal to its start, the BN running statistics within 1e-5 of
   their largest magnitude; ``evaluate``'s mAP within 1e-6 of the JAX
   trainer's;
 - a checkpoint of the port's ``save_checkpoint`` read by the JAX package's
   ``load_checkpoint``, whose JAX forward equals the port's within 1e-5.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from audioset_convnext_inf_tpu.checkpoint.io import load_checkpoint as jax_load_checkpoint
from audioset_convnext_inf_tpu.checkpoint.pann_convert import pann_state_dict_to_params
from audioset_convnext_inf_tpu.engine import transfer as JT
from audioset_convnext_inf_tpu.models import pann as JP

from audioset_convnext_inf_torch.checkpoint import load_checkpoint, save_checkpoint
from audioset_convnext_inf_torch.engine import transfer as T
from audioset_convnext_inf_torch.models import pann as PM
from tests.torch_pann_util import jax_config, model_, state_dict, waveform_

N6 = (8, 8, 16, 16, 24, 32)
CFG = dataclasses.replace(PM.PANN_REGISTRY["Cnn14"], channels=N6, block_dropout=0.0,
                          head_dropout=0.0, use_spec_augment=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tags(batch, seed):
    rng = np.random.RandomState(seed)
    tags = (rng.rand(batch, 527) < 0.02).astype(np.float32)
    tags[:, 0] = [1, 0] * (batch // 2)
    return tags


def test_head_only_labels():
    model = PM.create_pann_model("Cnn10", device="cpu")
    labels = T.head_only_labels(model)
    assert set(labels) == {n for n, _ in model.named_parameters()}
    assert {n for n, v in labels.items() if v == "train"} == {
        "fc1.weight", "fc1.bias", "fc_audioset.weight", "fc_audioset.bias"}
    only = T.head_only_labels(model, ("fc_audioset",))
    assert sorted(n for n, v in only.items() if v == "train") == [
        "fc_audioset.bias", "fc_audioset.weight"]


def test_merge_bn_stats_writes_mean_and_var_only():
    model = model_(CFG, seed=1)
    out = model.forward_train(waveform_(2, 16000, 2), None)
    updates = out["bn_updates"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    # scale and bias in the updates are not written, even where they differ
    updates["bn0"] = dict(updates["bn0"], scale=torch.zeros(64), bias=torch.ones(64))
    T.merge_bn_stats(model, updates)
    sd = model.state_dict()
    for path, stats in updates.items():
        prefix = "bn0" if path == "bn0" else path
        assert torch.equal(sd[f"{prefix}.running_mean"], stats["mean"])
        assert torch.equal(sd[f"{prefix}.running_var"], stats["var"])
    for k, v in sd.items():
        if not k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, before[k]), k
        else:
            assert not torch.equal(v, before[k]), k


def test_amsgrad_is_optax_amsgrad():
    """20 steps of gradients that shrink 10x a step: optax keeps the maximum
    of the bias-corrected second moment; torch's Adam(amsgrad=True) keeps
    the raw maximum and corrects it at the current step."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [(rng.randn(5, 7) * 10.0 ** -k).astype(np.float32) for k in range(20)]
    tx = optax.amsgrad(1e-2, b1=0.9, b2=0.999, eps=1e-8)
    p_jax, state = jax.numpy.asarray(p0), None
    state = tx.init(p_jax)
    p = torch.from_numpy(p0.copy())
    opt = T.AMSGrad([p], 1e-2)
    q = torch.from_numpy(p0.copy()).requires_grad_(True)
    adam = torch.optim.Adam([q], lr=1e-2, betas=(0.9, 0.999), eps=1e-8, amsgrad=True)
    for g in grads:
        upd, state = tx.update(jax.numpy.asarray(g), state, p_jax)
        p_jax = optax.apply_updates(p_jax, upd)
        opt.step([torch.from_numpy(g)])
        q.grad = torch.from_numpy(g)
        adam.step()
        np.testing.assert_allclose(p.numpy(), np.asarray(p_jax), rtol=0, atol=1e-6)
    np.testing.assert_allclose(opt.nu_max[0].numpy(), np.asarray(state[0].nu_max), rtol=1e-6)
    assert opt.count == int(state[0].count) == 20
    assert float(np.abs(q.detach().numpy() - np.asarray(p_jax)).max()) > 1e-3


@pytest.fixture(scope="module")
def trained():
    """Three steps of each trainer from the same weights, on the same
    batches of 1-s clips, then each trainer's evaluate over two batches."""
    model = model_(CFG, seed=11)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    jcfg = jax_config(CFG)
    jmodel = JP.PannModel(jcfg, pann_state_dict_to_params(state_dict(model), jcfg))
    port, ref = T.TransferTrainer(model, learning_rate=1e-3), JT.TransferTrainer(
        jmodel, learning_rate=1e-3)
    batches = [(waveform_(2, 32000, 20 + i), _tags(2, 30 + i)) for i in range(3)]
    losses = [(port.step(a, t), ref.step(a, t)) for a, t in batches]
    loader = [{"audio": waveform_(4, 32000, 40 + i), "tags": _tags(4, 50 + i)} for i in range(2)]
    maps = (port.evaluate(loader), ref.evaluate(loader))
    return model, start, jmodel, losses, maps


def test_three_steps_match_the_jax_trainer(trained):
    model, start, jmodel, losses, _ = trained
    for got, want in losses:
        assert abs(got - want) <= 1e-5, (got, want)
    want_sd = {k: np.asarray(v) for k, v in PM_state(jmodel).items()}
    sd = model.state_dict()
    moved = 0
    for k, v in sd.items():
        w = want_sd[k]
        if k.split(".")[0] in ("fc1", "fc_audioset"):
            err = float(np.abs(v.numpy() - w).max())
            assert err <= 1e-5 * float(np.abs(w).max()), (k, err)
            moved += not torch.equal(v, start[k])
        elif k.endswith(("running_mean", "running_var")):
            err = float(np.abs(v.numpy() - w).max())
            assert err <= 1e-5 * float(np.abs(w).max()), (k, err)
            assert not torch.equal(v, start[k]), k  # the base's BN statistics adapt
        else:  # the frozen base: bit-equal to its start, on both sides
            assert torch.equal(v, start[k]), k
            np.testing.assert_array_equal(w, start[k].numpy())
    assert moved == 4


def PM_state(jmodel):
    """The JAX trainer's params as the port's reference-keyed state dict."""
    from audioset_convnext_inf_torch.checkpoint import pann_state_dict_from_params

    return pann_state_dict_from_params(jax.tree_util.tree_map(np.asarray, jmodel.params), CFG)


def test_evaluate_map_matches_the_jax_trainer(trained):
    got, want = trained[4]
    assert np.isfinite(got) and abs(got - want) <= 1e-6, (got, want)


def test_checkpoint_read_by_the_jax_package(trained, tmp_path):
    """save_checkpoint of a PANN model writes the JAX pytree that the JAX
    package's load_checkpoint reads (no config.json); its forward is the
    port's."""
    model = trained[0]
    path = save_checkpoint(str(tmp_path / "model_epoch_0001_mAP_0.5000"), model.state_dict(),
                           cfg=model.cfg, iteration=1)
    state = jax_load_checkpoint(path)
    assert state["iteration"] == 1 and "config" not in state
    jcfg = jax_config(CFG)
    wave = waveform_(2, 32000, 60)
    want = JP.PannModel(jcfg, state["params"]).forward(wave)
    got = model.forward(wave)
    for key in ("clipwise_output", "clipwise_logits", "embedding"):
        err = float(np.abs(got[key].numpy() - np.asarray(want[key])).max())
        assert err <= 1e-5, (key, err)
    # and the port reads it back
    back = load_checkpoint(path)
    from audioset_convnext_inf_torch.checkpoint import pann_state_dict_from_params

    sd = pann_state_dict_from_params(back["params"], CFG)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(sd[k], v.numpy())


def test_fit_selects_on_val_and_logs_test():
    model = model_(CFG, seed=71)
    trainer = T.TransferTrainer(model, learning_rate=1e-3)
    batch = {"audio": waveform_(2, 16000, 72), "tags": _tags(2, 73)}
    other = {"audio": waveform_(2, 16000, 74), "tags": _tags(2, 75)}
    seen = []
    history = trainer.fit(lambda: [batch], lambda: [batch], lambda: [other], epochs=2,
                          checkpoint_fn=lambda e, m: seen.append((e, m)))
    assert len(history) == 2 and [e for e, _ in seen] == [1, 2]
    assert history == [m for _, m in seen]
    assert history[-1] == trainer.evaluate([batch])  # the val mAP, not the test's
