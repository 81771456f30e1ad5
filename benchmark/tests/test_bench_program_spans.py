"""The readers of the program's spans (``benchmark/program_spans.py`` and
the per-layer metrics over it) on a synthetic Chrome trace whose device
intervals, spans, threads and correlation ids are known, so each reading
has an exact value; and ``Trace``'s own readings, the same with and
without the program's spans in the document.

The document, in microseconds: the window is 0-1000 on thread 1. Two
training steps run on thread 1 inside the benchmark's spans, their phases
in order; thread 2 (autograd's) holds a backward prep span; a span that
leaves the window and one after it count for nothing. The card is busy
over 120-140 (the H2D copy), 160-260, 310-350, 420-450, 640-690 and
980-1000 (a kernel running on past the window's end, clipped).
"""

import pytest

from benchmark import program_spans as ps
from benchmark import spec
from benchmark.trace import Trace

STEP1 = [("train.h2d", 110, 150), ("train.forward", 150, 300), ("train.backward", 300, 400),
         ("train.optimizer", 400, 490)]
STEP2 = [("train.h2d", 600, 620), ("train.forward", 620, 700), ("train.backward", 700, 800),
         ("train.optimizer", 800, 890)]
# (correlation, launch call's thread and time, device start and end, category)
LAUNCHES = [(1, 1, 115, 120, 140, "gpu_memcpy"), (2, 1, 155, 160, 260, "kernel"),
            (3, 2, 325, 310, 350, "kernel"), (4, 1, 410, 420, 450, "kernel"),
            (5, 1, 630, 640, 690, "kernel"), (6, 1, 885, 980, 1020, "kernel")]


def _x(name, cat, tid, a, b, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": float(a),
            "dur": float(b - a), "args": args}


def _doc(program: bool) -> dict:
    ev = [_x("bench.window", "user_annotation", 1, 0, 1000),
          _x("bench.train.step_async", "user_annotation", 1, 95, 505),
          _x("bench.train.step_async", "user_annotation", 1, 595, 905),
          _x("aten::mul", "cpu_op", 1, 405, 415, **{"Input Dims": [[4, 4]]})]
    for corr, tid, t, a, b, cat in LAUNCHES:
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", tid, t, t + 2, correlation=corr))
        ev.append(_x(f"dev{corr}", cat, 7, a, b, correlation=corr))
    if program:
        ev += [_x("train.step", "cpu_op", 1, 100, 500, step=3),
               _x("train.step", "cpu_op", 1, 600, 900, step=4)]
        ev += [_x(n, "cpu_op", 1, a, b) for n, a, b in STEP1 + STEP2]
        ev += [_x("fused_block.prep", "cpu_op", 1, 200, 210),
               _x("fused_block.prep", "cpu_op", 1, 640, 646),
               _x("fused_block_bwd.prep", "cpu_op", 2, 320, 330),
               _x("eval.wait_batch", "cpu_op", 1, 950, 1050),  # leaves the window
               _x("train.step", "cpu_op", 1, 1100, 1200)]  # after it
    return {"traceEvents": ev}


@pytest.fixture
def tr():
    return Trace(_doc(True))


class Run:
    def __init__(self, trace):
        self.trace = trace


def _read(metric, trace):
    return spec.reader(metric).read(Run(trace))


def test_spans_wholly_inside_the_window_are_read(tr):
    assert [s["args"]["step"] for s in ps.program_spans(tr, ["train.step"])] == [3, 4]
    assert ps.program_spans(tr, ["eval.wait_batch"]) == []


def test_host_seconds_under_spans(tr):
    assert ps.span_host_s(tr, ["train.step"]) == pytest.approx(700e-6)
    assert ps.span_host_s(tr, ["train.h2d"]) == pytest.approx(60e-6)
    # the forward's prep spans on thread 1 and the backward's on thread 2
    assert ps.span_host_s(tr, ["fused_block.prep", "fused_block_bwd.prep"]) == pytest.approx(
        26e-6)
    assert _read("train.step_host_ms", tr) == pytest.approx(0.35)
    assert _read("train.h2d_ms", tr) == pytest.approx(0.03)
    assert _read("train.optimizer_host_ms", tr) == pytest.approx(0.09)
    assert _read("train.block_prep_ms", tr) == pytest.approx(0.013)


def test_device_ms_by_the_launching_thread(tr):
    """Step 4's last kernel runs on past the window: only step 3 counts."""
    per_step = {p: ps.device_ms_per_root(tr, [f"train.{p}"], "train.step")
                for p in ("h2d", "forward", "backward", "optimizer")}
    # the backward's kernel was launched on thread 2, where no step is open
    assert per_step == pytest.approx({"h2d": 0.02, "forward": 0.1, "backward": 0.0,
                                      "optimizer": 0.03})
    assert ps.device_ms_per_root(tr, ["train.step"], "train.step") == pytest.approx(0.15)


def test_idle_seconds_by_phase(tr):
    idle = {p: ps.idle_under(tr, [f"train.{p}"])
            for p in ("h2d", "forward", "backward", "optimizer")}
    assert idle == pytest.approx({"h2d": 40e-6, "forward": 80e-6, "backward": 160e-6,
                                  "optimizer": 150e-6})
    assert sum(idle.values()) <= tr.window_s() - tr.busy_s()
    assert tr.window_s() - tr.busy_s() == pytest.approx(740e-6)
    # the prep span of thread 2 is not on the thread that runs the steps
    assert ps.idle_under(tr, ["fused_block_bwd.prep"]) == 0.0
    for p, v in idle.items():
        assert _read(f"idle.train.{p}", tr) == pytest.approx(100 * v / 1e-3)
    assert _read("idle.train.allreduce", tr) == 0.0


def test_eval_readers_divide_by_the_batches_run_inside_the_window():
    """Batch 0's work all runs in the window; batch 1's stage-1 kernel runs
    on past its end, so batch 1 counts for none of the device readers."""
    doc = {"traceEvents": [
        _x("bench.window", "user_annotation", 1, 0, 1000),
        _x("eval.wait_batch", "cpu_op", 1, 10, 30), _x("eval.wait_batch", "cpu_op", 1, 500, 540),
        _x("eval.launch", "cpu_op", 1, 30, 400, batch=0),
        _x("eval.launch", "cpu_op", 1, 540, 900, batch=1),
        _x("model.frontend", "cpu_op", 1, 40, 60), _x("model.stage1", "cpu_op", 1, 60, 100),
        _x("model.stage2", "cpu_op", 1, 100, 150), _x("model.stage3", "cpu_op", 1, 150, 200),
        _x("model.stage4", "cpu_op", 1, 200, 250), _x("model.stage1", "cpu_op", 1, 560, 600)]}
    for corr, t, a, b, name in ((1, 45, 50, 80, "fft"), (2, 70, 80, 180, "conv"),
                                (3, 120, 180, 240, "conv"), (4, 160, 240, 300, "k1"),
                                (5, 300, 300, 320, "head"), (6, 570, 900, 1100, "conv")):
        doc["traceEvents"] += [_x("cudaLaunchKernel", "cuda_runtime", 1, t, t + 1,
                                  correlation=corr),
                               _x(name, "kernel", 7, a, b, correlation=corr)]
    tr = Trace(doc)
    assert _read("eval.wait_batch_ms", tr) == pytest.approx(0.03)
    assert _read("eval.frontend_device_ms", tr) == pytest.approx(0.03)
    assert _read("eval.stages12_device_ms", tr) == pytest.approx(0.16)
    assert _read("eval.stages34_device_ms", tr) == pytest.approx(0.06)
    # the whole of batch 0, its head's kernel too: the stages leave 0.02 ms
    assert ps.device_ms_per_root(tr, ["eval.launch"], "eval.launch") == pytest.approx(0.27)


def test_a_trace_without_program_spans_reads_nothing():
    tr = Trace(_doc(False))
    for metric in ("train.step_host_ms", "train.h2d_ms", "train.optimizer_host_ms",
                   "train.block_prep_ms", "idle.train.h2d", "idle.train.forward",
                   "idle.train.backward", "idle.train.optimizer", "idle.train.allreduce",
                   "eval.wait_batch_ms", "eval.frontend_device_ms", "eval.stages12_device_ms",
                   "eval.stages34_device_ms"):
        assert _read(metric, tr) is None, metric
        assert _read(metric, None) is None, metric


def test_the_trace_reads_the_same_with_program_spans():
    """``Trace``'s readings where the program's spans sit inside the
    benchmark's, as in the training cells: unchanged by them."""
    with_spans, without = Trace(_doc(True)), Trace(_doc(False))
    assert with_spans.busy_s() == without.busy_s()
    assert with_spans.window_s() == without.window_s()
    assert with_spans.device_ops() == without.device_ops()
    assert with_spans.idle_gaps() == without.idle_gaps()
    assert with_spans.spans == without.spans
    for t in (110, 300, 450, 650, 890):
        assert with_spans.host_doing(t) == without.host_doing(t) == "bench.train.step_async"
    assert with_spans.under_op("aten::mul") == without.under_op("aten::mul") == [
        ([[4, 4]], pytest.approx(30e-6))]


def test_every_new_metric_is_declared():
    bench = spec.load()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in ("train.step_host_ms", "train.h2d_ms", "train.optimizer_host_ms",
                 "train.block_prep_ms", "idle.train.allreduce", "eval.wait_batch_ms",
                 "eval.frontend_device_ms", "eval.stages12_device_ms",
                 "eval.stages34_device_ms"):
        assert name in declared
    assert declared["idle.train.allreduce"]["workloads"] == ["tiny-train-ddp4"]
    assert spec.problems(bench) == []
