"""Learning certificates of the port on the CPU: the training recipe and
the transfer trainer learn, and a trajectory stays on the JAX package's.

 - ``test_recipe_overfits_synthetic_tones``: the JAX package's
   ``tests/test_trainer.py::test_recipe_overfits_synthetic_tones`` with the
   port's ``Trainer`` (its data, model, recipe, seeds and gates), on the
   unfused route and on the fused one, where stages 3-4 run the plain
   versions of K1's save mode and K2 through ``FusedBlockTrain``;
 - ``test_trajectory_matches_jax``: 20 steps of the same batches through
   both packages' trainers from the same weights, with the draws off;
 - ``test_transfer_head_learns``: head-only transfer of a narrow Cnn14 on
   the tone task of ``scripts/transfer_cert_tpu.py``, with its five gates.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audioset_convnext_inf_tpu.config import AugmentConfig as JaxAugmentConfig
from audioset_convnext_inf_tpu.config import ConvNeXtConfig as JaxConfig
from audioset_convnext_inf_tpu.config import FrontendConfig as JaxFrontendConfig
from audioset_convnext_inf_tpu.engine import trainer as JT
from audioset_convnext_inf_tpu.parallel.mesh import get_mesh

from audioset_convnext_inf_torch.checkpoint import state_dict_from_jax_params, to_tensors
from audioset_convnext_inf_torch.config import (AugmentConfig, ConvNeXtConfig, FrontendConfig,
                                                SpecAugmentConfig)
from audioset_convnext_inf_torch.engine import trainer as T
from audioset_convnext_inf_torch.engine.metrics import evaluate_clipwise
from audioset_convnext_inf_torch.engine.transfer import TransferTrainer
from audioset_convnext_inf_torch.models import ConvNeXt
from audioset_convnext_inf_torch.models import pann as PM
from audioset_convnext_inf_torch.ops import fused_block as FB
from audioset_convnext_inf_torch.ops import fused_block_bwd as FBB

from tests import torch_transfer_cert as tc

from tests.test_torch_train import _jax_params

# The JAX test's tone task: 8 tones x 4 clips of 0.5 s at 32 kHz.
SR, N = 32000, 16000
FREQS = [250.0, 500.0, 1000.0, 1600.0, 2500.0, 4000.0, 6300.0, 9000.0]
CLASS_IDX = [13 * (k + 1) for k in range(8)]
SMALL = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128))
FRONTEND = dict(n_fft=256, win_length=256, hop_length=160, n_mels=64, fmin=50.0, fmax=14000.0)
RECIPE = dict(max_lr=2e-3, total_steps=300, weight_decay=0.01, seed=7)

# Trajectory, port vs JAX, f32, draws off, 20 steps: each loss within
# LOSS_RTOL of the JAX loss (one step agrees within 1e-5,
# tests/test_torch_train.py; these 20 steps part by up to 5.3e-6 on a
# CPU). Parameters: see _adam_limit; bn0's running statistics, which
# no optimizer bounds, within BUFFER_RTOL of their scale.
TRAJECTORY_STEPS = 20
LOSS_RTOL = 5e-5
BUFFER_RTOL = 1e-4
# The Adam bound holds whatever the two runs' gradients are, so it says
# only that both runs are Adam runs. The test also holds each tensor's
# drift between the runs (L2) to DRIFT_SHARE of the distance the JAX run
# moved it (measured on a CPU: at most 0.0114, bn0's weight).
DRIFT_SHARE = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone_clips():
    """The JAX test's 32 clips (its RandomState(0) draws, in its order) and
    one-hot targets at CLASS_IDX."""
    rng = np.random.RandomState(0)
    t = np.arange(N) / SR
    clips, targets = [], []
    for k in range(8):
        for _ in range(4):
            wav = (0.5 + 0.3 * rng.rand()) * np.sin(2 * np.pi * FREQS[k] * t + rng.rand() * 2 * np.pi)
            clips.append((wav + 0.05 * rng.randn(N)).astype(np.float32))
            tg = np.zeros(527, np.float32)
            tg[CLASS_IDX[k]] = 1.0
            targets.append(tg)
    return np.stack(clips), np.stack(targets)


def _batches(steps):
    order = np.random.RandomState(42)
    return [order.permutation(32)[:16] for _ in range(steps)]


@pytest.mark.parametrize("route", ["unfused", "fused"])
def test_recipe_overfits_synthetic_tones(route, monkeypatch):
    """The whole recipe (mixup with paired targets, SpecAugment, drop path
    0.1, AdamW weight-decay groups, OneCycle, bn0 batch statistics) from the
    port's own init overfits the 32 tone clips: the mean loss of the last 10
    steps under 0.1 of the first 10's, and train mAP over the 8 class
    columns above 0.85 (the JAX test's gates; its docstring: the loss still
    collapses when only the AP is broken). The fused route runs both
    stage-3/4 blocks of every step through the plain versions of K1's save
    mode and K2."""
    fused = route == "fused"
    cfg = ConvNeXtConfig(
        name="overfit_test", **SMALL, drop_path_rate=0.1,
        frontend=FrontendConfig(**FRONTEND),
        augment=AugmentConfig(use_spec_augment=True, spec_augment=SpecAugmentConfig(
            time_drop_width=8, time_stripes_num=2, freq_drop_width=8, freq_stripes_num=2)),
        **(dict(block_impl="xla_approx", fused_train_blocks=True) if fused else {}))
    calls = {"save": 0, "bwd": 0}
    plain_fwd, plain_bwd = FB.fused_block_reference, FBB.fused_block_bwd_reference

    def fwd(*args, **kw):
        calls["save"] += int(len(args) > 12 and bool(args[12]))
        return plain_fwd(*args, **kw)

    def bwd(*args, **kw):
        calls["bwd"] += 1
        return plain_bwd(*args, **kw)

    monkeypatch.setattr(FB, "fused_block_reference", fwd)
    monkeypatch.setattr(FBB, "fused_block_bwd_reference", bwd)

    clips, targets = _tone_clips()
    steps = RECIPE["total_steps"]
    model = ConvNeXt(cfg, device="cpu")
    tr = T.Trainer(model, T.TrainConfig(**RECIPE, mixup_alpha=1.0))
    losses = [tr.step(clips[idx], targets[idx]) for idx in _batches(steps)]
    assert calls == ({"save": 2 * steps, "bwd": 2 * steps} if fused else {"save": 0, "bwd": 0})
    assert np.isfinite(losses).all()
    ratio = np.mean(losses[-10:]) / np.mean(losses[:10])
    assert ratio < 0.1, f"loss ratio {ratio:.4f}"

    ap = evaluate_clipwise(model.forward(clips)["clipwise_output"].numpy(),
                           targets)["average_precision"][CLASS_IDX]
    assert float(np.mean(ap)) > 0.85, f"train mAP {np.mean(ap):.3f}, per-class {ap}"


def _adam_ratio(t: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """The most |m_hat| / sqrt(v_hat) can be after t Adam steps (Cauchy-
    Schwarz on the moment sums), whatever the gradients."""
    s = sum((b1 * b1 / b2) ** k for k in range(t))
    return (1 - b1) / math.sqrt(1 - b2) * math.sqrt(s) * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)


def _adam_limit(train_cfg, steps: int) -> float:
    """How far two AdamW runs from the same weights can part in one
    element: each step moves an element by at most lr(s) * _adam_ratio plus
    lr(s) * wd * |p|; the two runs' moves differ by at most twice the first
    term (the second differs by lr * wd times the drift itself, under 1e-4
    of it over these steps). The limit takes 1% on top, as chip_smoke.py's
    resume_param_limit does."""
    lr = T.onecycle_lr(train_cfg)
    return 1.01 * 2 * sum(lr(s) * _adam_ratio(s + 1) for s in range(steps))


def test_trajectory_matches_jax():
    """The same 20 batches of tone clips through the port's Trainer and the
    JAX package's Trainer (one device) from the same seeded weights, f32,
    SpecAugment, mixup and drop path off (the JAX and port draws differ):
    each step's loss within LOSS_RTOL; after the last step every parameter
    element within the Adam bound of _adam_limit, each parameter tensor's
    drift within DRIFT_SHARE of the distance it travelled, and bn0's
    running statistics within BUFFER_RTOL."""
    aug = dict(use_spec_augment=False)
    jcfg = JaxConfig(name="trajectory", **SMALL, frontend=JaxFrontendConfig(**FRONTEND),
                     augment=JaxAugmentConfig(**aug))
    cfg = ConvNeXtConfig(name="trajectory", **SMALL, frontend=FrontendConfig(**FRONTEND),
                         augment=AugmentConfig(**aug))
    params = _jax_params(jcfg, seed=0)
    jtr = JT.Trainer(jcfg, JT.TrainConfig(**RECIPE), jax.tree_util.tree_map(jnp.asarray, params),
                     mesh=get_mesh(jax.devices()[:1]))
    model = ConvNeXt(cfg, device="cpu")
    model.load_state_dict(to_tensors(state_dict_from_jax_params(params, cfg)), strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    tcfg = T.TrainConfig(**RECIPE)
    tr = T.Trainer(model, tcfg)

    clips, targets = _tone_clips()
    for step, idx in enumerate(_batches(TRAJECTORY_STEPS)):
        got, want = tr.step(clips[idx], targets[idx]), jtr.step(clips[idx], targets[idx])
        assert abs(got - want) <= LOSS_RTOL * abs(want), (step, got, want)

    ref = to_tensors(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jtr.state.params), cfg))
    limit = _adam_limit(tcfg, TRAJECTORY_STEPS)
    params_seen = 0
    for name, p in model.named_parameters():
        drift, travel = p.detach() - ref[name], ref[name] - start[name]
        assert drift.abs().max().item() <= limit, (name, drift.abs().max().item(), limit)
        assert drift.norm().item() <= DRIFT_SHARE * travel.norm().item(), (
            name, drift.norm().item(), travel.norm().item())
        params_seen += 1
    assert params_seen == len(ref) - 2  # every parameter; the two buffers below
    for name in ("bn0.running_mean", "bn0.running_var"):
        got, want = model.state_dict()[name], ref[name]
        err = (got - want).abs().max().item() / want.abs().max().item()
        assert err <= BUFFER_RTOL, (name, err)
        assert not torch.equal(want, start[name])


# The transfer twin: scripts/transfer_cert_tpu.py's task and gates on a
# narrow Cnn14 (tests/test_torch_transfer.py's N6 channel ladder and
# dropout-free, SpecAugment-free config) whose head keeps the published
# fc1 width, 2048. TRANSFER_STEPS: see test_transfer_head_learns.
N6 = (8, 8, 16, 16, 24, 32)
TRANSFER_CFG = dataclasses.replace(PM.PANN_REGISTRY["Cnn14"], channels=N6, fc1_out=2048,
                                   block_dropout=0.0, head_dropout=0.0, use_spec_augment=False)
TRANSFER_STEPS, TRANSFER_BATCH, TRANSFER_SAMPLES = 150, 32, 16000


def test_transfer_head_learns():
    """Head-only transfer (fc1 and fc_audioset train, AMSGrad at 1e-3, the
    frozen base's BN statistics merge) on the transfer certificate's 8
    tones at 220(k+1) Hz, 16 clips each (0.5 s here), its RandomState(0)
    clips and RandomState(1) batches of 32, for TRANSFER_STEPS steps. Its
    five gates (``tests/torch_transfer_cert.py``): the mean loss of the last 8 steps under 0.25 of the first
    8's; train mAP over the 8 columns above 0.9 by ``model.forward``; every
    parameter outside fc1 and fc_audioset bit-identical to its start; at
    least one BN running statistic changed; fc_audioset moved.

    150 steps: this config passed 0.95 mAP by step 100 and 0.99 by step
    200 when it was sized, so 150 clears the gate with room and keeps the
    test near 15 s on one thread."""
    clips, tags = tc.tone_clips(TRANSFER_SAMPLES, SR)
    model = PM.build_pann_model(TRANSFER_CFG, seed=0, device="cpu")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = TransferTrainer(model, learning_rate=1e-3)
    losses = [trainer.step(clips[idx], tags[idx])
              for idx in tc.batches(len(clips), TRANSFER_STEPS, TRANSFER_BATCH)]
    got = tc.report(model, start, losses, model.forward(clips)["clipwise_output"].numpy(), tags)
    assert not got.failures(), got.failures()
