"""The benchmark's plain reference against the port, at a tiny size on the
CPU, in float32: eval probabilities, and three training steps of the
recipe with the draws the reference works out again. (The test imports
both; the reference imports nothing of the port.)"""

import copy

import numpy as np
import pytest
import torch

from benchmark import clips, program
from benchmark.drivers import train as train_driver
from benchmark.reference import convnext as ref
from benchmark.reference.weights import make_state_dict, param_table
from benchmark.tests.tiny import tiny_config


def f32(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["program"].update(compute_dtype="float32", frontend_precision="highest")
    return cfg


def test_state_dict_matches_the_ports_keys_and_shapes():
    cfg = tiny_config("convnext_tiny-bf16-serve")
    sd = make_state_dict(cfg["model"], 3, "cpu")
    model = program.build_model(cfg, sd, "cpu")
    theirs = model.state_dict()
    assert list(sd) == [k for k, _, _ in param_table(cfg["model"])]
    assert set(sd) == set(theirs)
    assert all(sd[k].shape == theirs[k].shape for k in sd)


def test_published_width_parameter_count():
    import json

    from benchmark.spec import HERE

    with open(HERE / "configs" / "convnext_tiny-bf16-serve.json") as f:
        m = json.load(f)["model"]
    n = sum(int(np.prod(s)) for k, s, _ in param_table(m) if not k.startswith("bn0.running"))
    assert n == m["parameters"] == 28222767


def test_eval_probabilities_match_the_port():
    cfg = f32(tiny_config("convnext_tiny-bf16-serve"))
    sd = make_state_dict(cfg["model"], 11, "cpu")
    model = program.build_model(cfg, sd, "cpu")
    pcm = clips.pool(11, 3, 32000)
    got = model.forward(pcm)["clipwise_output"].numpy()
    want = ref.probabilities(sd, torch.from_numpy(pcm), cfg["model"]).numpy()
    assert np.abs(got - want).max() < 2e-5


def test_three_training_steps_match_the_port():
    from audioset_convnext_inf_torch.engine.trainer import Trainer

    cfg = f32(tiny_config("convnext_tiny-bf16-train"))
    sd = make_state_dict(cfg["model"], 12, "cpu")
    model = program.build_model(cfg, sd, "cpu")
    tseed = 2**40 + 17
    trainer = Trainer(model, program.train_config(cfg, tseed))
    pcm = clips.pool(12, 24, 32000)
    target = clips.targets(12, 24, cfg["model"]["num_classes"])
    batches = [(pcm[k * 8:(k + 1) * 8], target[k * 8:(k + 1) * 8]) for k in range(3)]
    p0 = {k: v.detach().clone() for k, v in trainer.optimizer.params.items()}
    losses = []
    for k, b in enumerate(batches):
        losses.append(float(trainer.step_async(*b)))
        if k == 0:
            g1 = {n: m / (1 - train_driver.B1) for n, m in trainer.optimizer.mu.items()}
    p3 = {k: v.detach().clone() for k, v in trainer.optimizer.params.items()}

    class Ctx:
        cell = type("C", (), {"config": cfg, "traffic": {}})
        device = torch.device("cpu")

    want = train_driver.reference_steps(Ctx, sd, batches, tseed)
    assert losses == pytest.approx(want["losses"], abs=2e-5)
    checks = train_driver.compare(losses, g1, p0, p3, want)
    assert checks["grad_gap"] < 1e-3 and checks["update_gap"] < 1e-3, checks
    for k in want["params"]:
        assert torch.allclose(p3[k], want["params"][k], atol=1e-5), k


def test_reference_steps_in_blocks_match_the_whole_batch():
    from benchmark.reference.draws import step_draws

    cfg = tiny_config("convnext_tiny-bf16-train")
    m, t = cfg["model"], cfg["train"]
    sd = make_state_dict(m, 5, "cpu")
    pcm = torch.from_numpy(clips.pool(5, 16, 32000))
    y = torch.from_numpy(clips.targets(5, 16, m["num_classes"]))
    batches = [(pcm[:8], y[:8]), (pcm[8:], y[8:])]
    draws = [step_draws(9, k, 8, m, t["mixup_alpha"], ranks=2) for k in range(2)]
    whole = ref.train_steps(sd, batches, draws, m, t)
    blocks = ref.train_steps(sd, batches, draws, m, t, block=2)
    assert blocks["losses"] == pytest.approx(whole["losses"], abs=1e-6)
    for k in whole["params"]:
        assert torch.allclose(blocks["params"][k], whole["params"][k], atol=1e-6), k
