"""Runs of the tiny cells on the CPU with the harness's look for a card
skipped: a sound run comes out correct, and each fault a cell can have,
planted underneath the timed path, comes out not correct. Also the last
line's format."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import tiny_cell

EVAL = dict(batch=4, pool_clips=12, check_clips=6, check_block=3, trace_after=1,
            trace_batches=2)
SERVE = dict(samples=320000, rate=15.0, pool_clips=4, check_answers=6, warm_requests=2,
             clients=2, threads=4, trace_after=0.3, trace_seconds=0.3,
             serve_args=["--batch-size", "4", "--max-wait-ms", "20", "--top-k", "10",
                         "--dtype", "bfloat16"])
TRAIN = dict(clips_in=8, batches=4, trace_after=1, trace_steps=1)


def execute(tmp_path, cell, seconds=1.0, trace=False, **faults):
    return run.execute(cell, 2**31 + 101, seconds, trace, device="cpu", faults=faults,
                       workdir=tmp_path)


def test_eval_sound_and_an_altered_answer(tmp_path, capsys):
    cell = tiny_cell("tiny-eval-b256", **EVAL)
    ok = execute(tmp_path, cell, trace=True)
    assert ok["correct"] and ok["failed"] == 0 and ok["attempted"] > 0
    assert list(ok) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                        "checks"]
    assert set(ok["metrics"]) >= {"eval.loader_wait_share", "mfu.eval"}
    run.emit(ok)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == ok
    assert err.strip().splitlines()[-1].startswith("check prob_gap ")

    def alter(probs):
        probs = probs.copy()
        probs[:, 3] = 1.0 - probs[:, 3]
        return probs

    bad = execute(tmp_path, cell, eval_answers=alter)
    assert not bad["correct"]
    assert bad["checks"]["prob_gap"]["value"] > bad["checks"]["prob_gap"]["limit"]


def test_serve_sound_and_an_altered_answer(tmp_path):
    cell = tiny_cell("tiny-serve-poisson", **SERVE)
    ok = execute(tmp_path, cell)
    assert ok["correct"] and ok["attempted"] == 15
    assert set(ok["metrics"]) == {"serve_p95_ms", "setup_s"}

    # every answer's classes reversed, so that the seeded sample holds one
    def alter_all(indexes, probs):
        return [i[::-1] for i in indexes], [p[::-1] for p in probs]

    bad = execute(tmp_path, cell, serve_answers=alter_all)
    assert not bad["correct"]
    assert bad["checks"]["top_rank_gap"]["value"] > bad["checks"]["top_rank_gap"]["limit"]


def test_train_sound_a_step_that_changes_nothing_and_half_a_batch(tmp_path):
    cell = tiny_cell("tiny-train-b64", **TRAIN)
    ok = execute(tmp_path, cell)
    assert ok["correct"] and ok["attempted"] > 0 and ok["failed"] == 0

    still = execute(tmp_path, cell, optimizer_step=lambda grads: True)
    assert not still["correct"]
    assert still["checks"]["update_gap"]["value"] == pytest.approx(1.0)

    def half_loss(out, tgt):
        x = out["clipwise_logits"].float()
        z = tgt["target"].float()
        h = x.shape[0] // 2
        x, z = x[:h], z[:h]
        return (torch.relu(x) - x * z + torch.log1p(torch.exp(-torch.abs(x)))).mean()

    half = execute(tmp_path, cell, loss_fn=half_loss)
    assert not half["correct"]
    assert half["checks"]["grad_gap"]["value"] > half["checks"]["grad_gap"]["limit"]


def test_the_control_fails_where_the_program_passes(tmp_path):
    """The reference in float8 in the program's place reads at least three
    times what the bf16 program reads, on one of each cell's numbers."""
    from benchmark import spec

    for name, traffic in (("tiny-eval-b256", EVAL), ("tiny-serve-poisson", SERVE),
                          ("tiny-train-b64", TRAIN)):
        cell = tiny_cell(name, **traffic)
        prog = execute(tmp_path, cell)["checks"]
        ctx = run.Context(cell, 2**31 + 101, 0, False, "cpu", 0.0, tmp_path)
        ctl = spec.driver(cell.traffic["driver"]).control(ctx, torch.float8_e4m3fn)
        ratios = [ctl[k] / max(prog[k]["value"], 1e-12) for k in prog]
        assert max(ratios) >= 3.0, (name, prog, ctl)
        assert np.isfinite(ratios).all()


def test_ddp_sound_and_the_exchange_left_out(tmp_path):
    """Four processes over gloo on the CPU: the ranks' copies agree
    exactly and follow the reference on the global batch; with the
    exchange between them left out, they part."""
    cell = tiny_cell("tiny-train-ddp4", clips_in=16, batches=4, check_block=8, trace_after=1,
                     trace_steps=1)
    ok = execute(tmp_path, cell)
    assert ok["correct"] and ok["device"]["count"] == 4
    assert ok["checks"]["rank_param_gap"]["value"] == 0.0
    bad = execute(tmp_path, cell, no_exchange=True)
    assert not bad["correct"]
    assert bad["checks"]["rank_param_gap"]["value"] > 0.0


def _window_rank(rank, world, port, seconds, pause, out):
    import torch.distributed as dist

    from benchmark.drivers.train import _Window

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    window = _Window(seconds, dist.new_group(backend="gloo"))
    steps, t = 0, time.perf_counter()
    while window.go():
        time.sleep(pause[rank])
        steps += 1
    out.put((rank, steps, time.perf_counter() - t))
    dist.destroy_process_group()


def test_ranks_issue_the_same_steps_with_hosts_of_different_speeds():
    """The training window's stop flag on four gloo processes whose steps
    take 2 to 30 ms of host time: every rank issues the same steps, and the
    window runs past its end by at most about two of the slowest steps."""
    import torch.multiprocessing as mp

    from benchmark.drivers.train import _free_port

    seconds, pause = 0.6, [0.03, 0.002, 0.01, 0.002]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_window_rank, args=(r, 4, port, seconds, pause, out))
             for r in range(4)]
    for p in procs:
        p.start()
    got = sorted(out.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs)
    steps = {s for _, s, _ in got}
    assert len(steps) == 1 and steps.pop() >= seconds / 0.03 - 1, got
    assert max(w for _, _, w in got) < seconds + 2 * 0.03 + 0.2, got
