"""The port's spans (``utils/profiling.py::span``) on the CPU.

With no profiler running a span is one shared null context and never
reaches the profiler; under ``torch.profiler`` each is a ``cpu_op`` event
of its name in the Chrome trace: the model's frontend and four stages in
order, a training step's phases inside its ``train.step`` (which carries
the step index), the Evaluator's waits and launches (each launch holding
the model's spans), and no profiler op in a ``torch.export`` program.
"""

import json

import numpy as np
import pytest
import torch

from audioset_convnext_inf_torch import parallel
from audioset_convnext_inf_torch.config import ConvNeXtConfig
from audioset_convnext_inf_torch.engine.aot_export import export_serving
from audioset_convnext_inf_torch.engine.evaluator import Evaluator
from audioset_convnext_inf_torch.engine.trainer import Trainer, TrainConfig
from audioset_convnext_inf_torch.models import ConvNeXt
from audioset_convnext_inf_torch.parallel.mesh import get_mesh
from audioset_convnext_inf_torch.utils import profiling as P

SMALL = dict(depths=(1, 1, 2, 1), dims=(32, 64, 128, 256), drop_path_rate=0.0)
TRAIN = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), block_impl="xla_approx",
             fused_train_blocks=True, drop_path_rate=0.1)
N = 16000
MODEL_SPANS = ["model.frontend", "model.stage1", "model.stage2", "model.stage3", "model.stage4"]
PHASES = ["train.h2d", "train.forward", "train.backward", "train.optimizer"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcm(b, seed=0):
    return (np.random.RandomState(seed).randn(b, N) * 3000).astype(np.int16)


def _target(b, classes=527, seed=1):
    return (np.random.RandomState(seed).rand(b, classes) < 0.05).astype(np.float32)


def _trainer(mesh=None):
    model = ConvNeXt(ConvNeXtConfig(**TRAIN), device="cpu", seed=3)
    return Trainer(model, TrainConfig(max_lr=1e-3, total_steps=10, mixup_alpha=1.0),
                   mesh=mesh)


def _spans(fn, tmp_path):
    """Run ``fn`` under the profiler, recording inputs (as the benchmark's
    tracer does: a span's ``args`` are among them): the trace's ``cpu_op``
    events of the port's spans, in order of their start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
             and e["name"].split(".")[0] in ("train", "eval", "model", "fused_block",
                                             "fused_block_bwd")]
    return sorted(spans, key=lambda e: e["ts"])


def _end(e):
    return e["ts"] + e["dur"]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and _end(inner) <= _end(outer)


def test_without_a_profiler_span_never_reaches_it(monkeypatch):
    """No profiler: one shared null context, checked before anything else;
    a forward and a training step give what they gave before."""
    model = ConvNeXt(ConvNeXtConfig(**SMALL), device="cpu")
    want = model.forward(_pcm(2))["clipwise_output"]
    loss_want = _trainer().step(_pcm(4), _target(4))

    def refuse(*args, **kwargs):
        raise AssertionError("a span reached the profiler with none running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert P.span("a") is P.span("b", {"step": 1})
    assert torch.equal(model.forward(_pcm(2))["clipwise_output"], want)
    trainer = _trainer()
    assert float(trainer.step_async(_pcm(4), _target(4))) == loss_want
    assert trainer.step_index == 1


def test_forward_holds_the_frontend_then_four_stages(tmp_path):
    model = ConvNeXt(ConvNeXtConfig(**SMALL), device="cpu")
    spans = _spans(lambda: model.forward(_pcm(2)), tmp_path)
    assert [s["name"] for s in spans] == MODEL_SPANS
    assert all(_end(a) <= b["ts"] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("group", [False, True], ids=["one process", "group of one"])
def test_a_training_step_holds_its_phases_in_order(tmp_path, group):
    """One ``train.step`` with the step index; inside it the H2D copies,
    the forward (the model's spans within it), the backward, with a process
    group the all-reduce, and the optimizer, in that order."""
    if group:
        assert parallel.initialize_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0,
                                               device="cpu")
    try:
        trainer = _trainer(get_mesh(["cpu"]) if group else None)
        trainer.step(_pcm(4), _target(4))
        spans = _spans(lambda: trainer.step_async(_pcm(4, 5), _target(4, seed=6)), tmp_path)
    finally:
        if group:
            torch.distributed.destroy_process_group()
    roots = [s for s in spans if s["name"] == "train.step"]
    assert len(roots) == 1 and roots[0]["args"]["step"] == 1
    phases = [s for s in spans if s["name"].startswith("train.") and s is not roots[0]]
    want = PHASES[:3] + ["train.allreduce"] * group + PHASES[3:]
    assert [s["name"] for s in phases] == want
    assert all(_inside(s, roots[0]) for s in phases)
    assert all(_end(a) <= b["ts"] for a, b in zip(phases, phases[1:]))
    forward = phases[1]
    model = [s for s in spans if s["name"].startswith("model.")]
    assert [s["name"] for s in model] == MODEL_SPANS
    assert all(_inside(s, forward) for s in model)


def test_the_evaluator_waits_and_launches_each_batch(tmp_path):
    """Three batches: three ``eval.launch`` spans, each holding the model's
    spans and carrying its batch index, each after an ``eval.wait_batch``;
    a fourth wait finds the loader done."""
    model = ConvNeXt(ConvNeXtConfig(**SMALL), device="cpu")
    loader = [{"waveform": _pcm(2, seed=k), "target": _target(2, seed=k)} for k in range(3)]
    evaluator = Evaluator(model, device="cpu")
    out = {}
    spans = _spans(lambda: out.update(evaluator.infer_probs(loader)), tmp_path)
    assert out["clipwise_output"].shape == (6, 527)
    top = [s for s in spans if s["name"].startswith("eval.")]
    assert [s["name"] for s in top] == ["eval.wait_batch", "eval.launch"] * 3 + [
        "eval.wait_batch"]
    launches = top[1::2][:3]
    assert [s["args"]["batch"] for s in launches] == [0, 1, 2]
    for launch in launches:
        inner = [s["name"] for s in spans if s["name"].startswith("model.")
                 and _inside(s, launch)]
        assert inner == MODEL_SPANS


def test_an_export_made_while_profiling_holds_no_profiler_op():
    model = ConvNeXt(ConvNeXtConfig(**SMALL), device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        program = export_serving(model, 2, num_samples=N)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t]
    wav = torch.from_numpy((np.random.RandomState(2).randn(2, N) * 0.1).astype(np.float32))
    torch.testing.assert_close(program.module()(wav)["clipwise_output"],
                               model.forward(wav)["clipwise_output"])
