"""Training: the port's ``Trainer.step_async`` on seeded int16 clips and
multi-hot targets, the batches made ahead in host memory; on one card, or
data-parallel over the cell's cards, one process each.

Traffic parameters: ``clips_in`` (clips a global step brings, paired by
mixup into half as many; a rank takes its contiguous block), ``batches``
(distinct batches in host memory, cycled; the first ``check_steps`` are
the checked steps' and all differ), ``samples``, ``check_block`` (clips of
a block of the reference's steps), ``trace_after`` and ``trace_steps``
(the steps a traced run profiles).

Set-up builds one trainer per rank and drives it from the seed through
its first ``check_steps`` steps, through the window's own call and feed;
those steps build and warm every kernel. The same trainer then runs the
window: steps are issued until ``--seconds`` have passed, and the window
closes when the card has finished them. On several cards every rank has
to issue the same steps: each rank's flag (still inside the window) is
all-reduced on the host without waiting and read one step later, so no
host waits on another inside the window unless it falls a whole step
behind, and the window runs one step past its end.
``train_clips_per_s`` counts the trunk's clips (after mixup) of every
step, summed over the cards, over the whole window.

On several cards the run's own process starts one process per card
(NCCL over ``tcp://127.0.0.1``), joins them, and prints the result; it
never touches a card itself. Each rank looks at its own ``sys.modules``
once its window has closed, and the run prints no result if any found
JAX or the JAX package there.

The check, once the window has closed and the program is freed (rank 0):
the reference follows the checked steps on the global batch from the same
weights, clips, targets and draws (``benchmark/reference/draws.py``), and
these numbers compare them: each step's loss; the first step's gradient
as the optimizer got it (its first moment after one step over 1 - b1), by
the worst leaf; and the parameters' change over the checked steps, by the
worst leaf. A leaf's gap is the gap between the two norms over the larger
of the reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and are left out of the change. On several cards
also ``rank_param_gap``: the widest difference between two ranks' copies
of any parameter after the checked steps, which must be 0.
"""

from __future__ import annotations

import socket
import sys
import time
import types
from typing import Dict

import numpy as np
import torch

from benchmark import clips, program
from benchmark.reference import convnext as ref
from benchmark.reference.draws import step_draws
from benchmark.reference.weights import make_state_dict
from benchmark.trace import span

B1 = 0.9  # AdamW's first-moment decay: the first moment after one step is (1 - B1) g
# seconds the run waits for a rank's outcome: the whole of a rank's run, as
# long as a checkout's first run, which builds the kernels, may take
RANK_WAIT_S = 1200


def _host(t: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().cpu().clone() for k, v in t.items()}


def run(ctx) -> dict:
    if ctx.cell.chips == 1:
        return rank_run(ctx, 0, 1)
    return _spawn(ctx)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(ctx) -> dict:
    """One process per card; rank 0's outcome with the others' folded in."""
    import torch.multiprocessing as mp

    from benchmark.run import JaxLoaded

    world = ctx.cell.chips
    mpc = mp.get_context("spawn")
    results = mpc.Queue()
    args = (world, _free_port(), ctx.cell, ctx.seed, ctx.seconds, ctx.trace, ctx.t0,
            str(ctx.workdir), str(ctx.device.type), dict(ctx.faults), results)
    procs = [mpc.Process(target=_rank_entry, args=(r,) + args) for r in range(world)]
    for p in procs:
        p.start()
    outs = {}
    try:
        while len(outs) < world:
            r, out = results.get(timeout=RANK_WAIT_S)
            if isinstance(out, BaseException):
                raise RuntimeError(f"rank {r} failed") from out
            outs[r] = out
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    found = sorted({n for o in outs.values() for n in o["jax_modules"]})
    if found:
        raise JaxLoaded(found)
    main = outs[0]
    ctx.counters.update(main.pop("counters"))
    ctx.counters["train.allreduce_ms"] = float(np.mean([o["allreduce_ms"] for o in outs.values()]))
    ctx.tracer.trace = main.pop("trace", None)
    main["memory_peak_bytes"] = max(o["memory_peak_bytes"] for o in outs.values())
    if all("busy_s" in o for o in outs.values()):
        main["busy_s"] = float(np.mean([o["busy_s"] for o in outs.values()]))
        main["window_s"] = float(np.mean([o["window_s"] for o in outs.values()]))
    main["failed"] = sum(o["failed"] for o in outs.values())
    return main


def _rank_entry(rank, world, port, cell, seed, seconds, trace, t0, workdir, device_type,
                faults, results):
    from benchmark.run import Context, jax_modules

    try:
        import torch.distributed as dist

        if faults.get("plant_jax") == rank:  # a planted fault: the port loaded JAX here
            sys.modules["jax"] = types.ModuleType("jax")
        cuda = device_type == "cuda"
        if cuda:
            torch.cuda.set_device(rank)
        dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
        ctx = Context(cell, seed, seconds, trace, dev, t0, workdir)
        ctx.faults.update(faults)
        out = rank_run(ctx, rank, world)
        out["jax_modules"] = jax_modules()
        if ctx.tracer.trace is None:
            ctx.tracer.finish()
        if rank == 0:
            out["trace"] = ctx.tracer.trace
            out["counters"] = ctx.counters
            out["device_kind"] = torch.cuda.get_device_name(dev) if cuda else "cpu"
        if ctx.tracer.trace is not None:
            out["busy_s"], out["window_s"] = ctx.tracer.trace.busy_s(), ctx.tracer.trace.window_s()
        results.put((rank, out))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 - handed to the parent, which raises
        results.put((rank, RuntimeError(repr(e))))
        raise


def rank_run(ctx, rank: int, world: int) -> dict:
    from audioset_convnext_inf_torch.engine.trainer import Trainer

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    mcfg, dev = cfg["model"], ctx.device
    n_in, nb, checked = tr["clips_in"], tr["batches"], tr["check_steps"]
    rows = slice(rank * n_in // world, (rank + 1) * n_in // world)
    sd = make_state_dict(mcfg, clips.torch_seed(ctx.seed, "weights"), dev)
    ctx.mark("weights")
    model = program.build_model(cfg, sd, dev)
    tseed = clips.torch_seed(ctx.seed, "train-draws")
    tcfg = program.train_config(cfg, tseed)
    mesh, ctl = None, None
    if world > 1:
        import torch.distributed as dist

        from audioset_convnext_inf_torch.parallel.mesh import get_mesh

        mesh = get_mesh(None if ctx.cuda else ["cpu"])
        ctl = dist.new_group(backend="gloo")
        if ctx.faults.get("no_exchange"):  # a planted fault: the ranks never exchange
            import audioset_convnext_inf_torch.engine.trainer as trainer_mod

            trainer_mod.all_reduce_ = lambda tensors, mesh, mean=False: mesh.world_size
    extra = {"loss_fn": ctx.faults["loss_fn"]} if "loss_fn" in ctx.faults else {}
    trainer = Trainer(model, tcfg, mesh=mesh, **extra)
    if "optimizer_step" in ctx.faults:
        trainer.optimizer.step = ctx.faults["optimizer_step"]
    ctx.mark("model")
    pcm = clips.pool(ctx.seed, nb * n_in, tr["samples"], dev)
    target = clips.targets(ctx.seed, nb * n_in, mcfg["num_classes"])
    batches = [(pcm[k * n_in:(k + 1) * n_in], target[k * n_in:(k + 1) * n_in])
               for k in range(nb)]
    mine = [(np.ascontiguousarray(p[rows]), np.ascontiguousarray(y[rows])) for p, y in batches]
    if rank > 0:
        del pcm, target, batches
    ctx.mark("clips")

    # the checked steps, which also build and warm every kernel
    names = list(trainer.optimizer.params)
    p0 = _host(trainer.optimizer.params) if rank == 0 else None
    losses = []
    for k in range(checked):
        losses.append(float(trainer.step_async(*mine[k])))
        if k == 0 and rank == 0:
            g1 = {n: m / (1 - B1) for n, m in _host(trainer.optimizer.mu).items()}
    p3 = _host(trainer.optimizer.params) if rank == 0 else None
    rank_gap = _rank_param_gap(trainer.optimizer.params) if world > 1 else None
    ctx.sync()
    trainer.collectives.ms()  # the collectives of the checked steps are set-up's
    ctx.mark("checked steps")
    ctx.reset_peak()

    step_losses, issue = [], []
    k = checked
    window = _Window(ctx.seconds, ctl)
    t_start = time.perf_counter()
    while window.go():
        i = k - checked
        if i == tr["trace_after"]:
            ctx.tracer.start()
        if i == tr["trace_after"] + tr["trace_steps"]:
            ctx.tracer.stop()
        t = time.perf_counter()
        with span("bench.train.step_async"):
            step_losses.append(trainer.step_async(*mine[k % nb]))
        issue.append(time.perf_counter() - t)
        k += 1
    ctx.sync()
    ctx.tracer.stop()
    t_end = time.perf_counter()
    peak = ctx.memory_peak()
    steps = k - checked
    allreduce = trainer.collectives.ms() / max(steps, 1)
    finite = torch.isfinite(torch.stack(step_losses)).cpu() if steps else torch.zeros(0)
    trunk_clips = n_in // 2 if tcfg.mixup_alpha > 0 else n_in
    out = {"attempted": steps, "failed": int((~finite).sum()), "memory_peak_bytes": peak,
           "allreduce_ms": allreduce, "devices": world}
    ctx.counters.update({"train.steps": steps, "train.issue_s": float(sum(issue)),
                         "train.window_s": t_end - t_start, "train.trunk_clips": trunk_clips,
                         "train.input_clips": n_in})
    del trainer, model, step_losses
    if ctx.cuda:
        torch.cuda.empty_cache()
    if rank > 0:
        return out
    checks = compare(losses, g1, p0, p3, reference_steps(ctx, sd, batches[:checked], tseed,
                                                         ranks=world))
    if world > 1:
        checks["rank_param_gap"] = rank_gap
    out.update({"end_to_end": {"train_clips_per_s": steps * trunk_clips / (t_end - t_start),
                               "setup_s": t_start - ctx.t0},
                "checks": checks, "complete": set(names) == set(g1)})
    return out


class _Window:
    """Whether to issue another step: while the window lasts, on rank 0's
    deadline. On several ranks, only while every rank was inside the window
    a step ago: each call all-reduces this rank's flag on the host without
    waiting and reads the flag of the call before, which the other ranks
    posted a step ago, so all issue the same steps."""

    def __init__(self, seconds: float, ctl):
        deadline = torch.tensor([time.monotonic() + seconds], dtype=torch.float64)
        if ctl is not None:
            import torch.distributed as dist

            dist.broadcast(deadline, src=0, group=ctl)
        self.deadline, self.ctl = float(deadline), ctl
        self.pending = self._post() if ctl is not None else None

    def _post(self):
        import torch.distributed as dist

        flag = torch.tensor([int(time.monotonic() < self.deadline)], dtype=torch.int32)
        return flag, dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.ctl, async_op=True)

    def go(self) -> bool:
        if self.ctl is None:
            return time.monotonic() < self.deadline
        (flag, work), self.pending = self.pending, self._post()
        work.wait()
        if not flag:
            self.pending[1].wait()  # every rank posted it: none is left open
            return False
        return True


@torch.no_grad()
def _rank_param_gap(params: Dict[str, torch.Tensor]) -> float:
    """The widest difference between two ranks' copies of any parameter."""
    import torch.distributed as dist

    flat = torch.cat([p.detach().float().reshape(-1) for p in params.values()])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return float((hi - lo).max())


def reference_steps(ctx, sd, batches, tseed: int, quant=None, loss_rows=None,
                    ranks: int = 1, local: int = 0) -> dict:
    """The reference's steps on ``batches`` from ``sd`` with the recipe's
    draws (the global batch; ``ranks`` as the program ran it). ``local``
    > 0 keeps only the first ``local`` clips of each batch and their draws:
    rank 0's steps had the ranks never exchanged (a planted fault)."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    mcfg, t = cfg["model"], cfg["train"]
    fused = cfg["program"]["fused_train_blocks"] and ranks > 1
    draws = [step_draws(tseed, k, len(b[0]), mcfg, t["mixup_alpha"], ranks if fused else 1)
             for k, b in enumerate(batches)]
    if local:
        batches = [(p[:local], y[:local]) for p, y in batches]
        draws = [{"lam": d["lam"][:local], "time": tuple(t[:local] for t in d["time"]),
                  "freq": tuple(t[:local] for t in d["freq"]),
                  "drop": [None if s is None else s[:local // 2] for s in d["drop"]]}
                 for d in draws]
    dev_batches = [(torch.from_numpy(p).to(ctx.device), torch.from_numpy(y).to(ctx.device))
                   for p, y in batches]
    out = ref.train_steps(sd, dev_batches, draws, mcfg, t, quant=quant, loss_rows=loss_rows,
                          block=tr.get("check_block"))
    return {"losses": out["losses"], "grads1": _host(out["grads1"]),
            "params": _host(out["params"])}


def _leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keep) -> float:
    norms = {k: float(want[k].norm()) for k in keep}
    median = float(np.median(list(norms.values())))
    return max(abs(float(got[k].norm()) - norms[k]) / max(norms[k], median, 1e-30)
               for k in keep)


def compare(losses, g1, p0, p3, want: dict) -> dict:
    """{loss_gap, grad_gap, update_gap} of the program's checked steps
    against the reference's."""
    keys = list(want["grads1"])
    gnorm = {k: float(want["grads1"][k].norm()) for k in keys}
    median = float(np.median(list(gnorm.values())))
    moved = [k for k in keys if gnorm[k] >= 1e-3 * median]
    d_got = {k: p3[k] - p0[k] for k in keys}
    d_want = {k: want["params"][k] - p0[k] for k in keys}
    return {"loss_gap": max(abs(a - b) for a, b in zip(losses, want["losses"])),
            "grad_gap": _leaf_gaps(g1, want["grads1"], keys),
            "update_gap": _leaf_gaps(d_got, d_want, moved)}


def control(ctx, quant) -> dict:
    """The reference in ``quant`` in the program's place, on the checked
    steps of this seed: the same numbers; and under ``half_batch`` the same
    of the float32 reference with a planted fault, half of each batch left
    out of the loss and the mean taken over the rest; on several cards also
    ``no_exchange``, rank 0's steps with the exchange between cards left out."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    mcfg, dev, n_in = cfg["model"], ctx.device, tr["clips_in"]
    ranks = ctx.cell.chips
    sd = make_state_dict(mcfg, clips.torch_seed(ctx.seed, "weights"), dev)
    tseed = clips.torch_seed(ctx.seed, "train-draws")
    pcm = clips.pool(ctx.seed, tr["batches"] * n_in, tr["samples"], dev)
    target = clips.targets(ctx.seed, tr["batches"] * n_in, mcfg["num_classes"])
    batches = [(pcm[k * n_in:(k + 1) * n_in], target[k * n_in:(k + 1) * n_in])
               for k in range(tr["check_steps"])]
    want = reference_steps(ctx, sd, batches, tseed, ranks=ranks)
    p0 = _host({k: v for k, v in sd.items() if k in want["grads1"]})
    out = {}
    faults = [("control", {"quant": quant}), ("half_batch", {"loss_rows": slice(0, n_in // 4)})]
    if ranks > 1:
        faults.append(("no_exchange", {"local": n_in // ranks}))
    for name, kw in faults:
        got = reference_steps(ctx, sd, batches, tseed, ranks=ranks, **kw)
        out[name] = compare(got["losses"], got["grads1"], p0, got["params"], want)
    return {**out.pop("control"), **out}
