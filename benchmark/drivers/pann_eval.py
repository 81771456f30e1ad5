"""Offline evaluation of a PANN: the port's ``Evaluator.infer_probs`` over
its ``DataLoader``, fed from a pool of seeded int16 clips in host memory.

The same traffic, window, counters and check as ``drivers/eval.py``
(whose dataset, batch order and check sample it takes), with the model a
PANN built by ``benchmark/program_pann.py`` and the reference
``benchmark/reference/pann.py`` on ``benchmark/reference/pann_weights.py``'s
weights. On the card the loader stacks each batch into pinned memory in
its worker threads (``DataLoader(pin_memory=True)``), as
``cli/evaluate.py`` does there. ``eval_clips_per_s`` counts the clips answered over the whole
window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import clips, program_pann
from benchmark.drivers.eval import MemoryDataset, _sample, cycle_batches
from benchmark.reference import pann as ref
from benchmark.reference.pann_weights import make_state_dict
from benchmark.trace import span


def run(ctx) -> dict:
    from audioset_convnext_inf_torch.data.loader import DataLoader
    from audioset_convnext_inf_torch.engine.evaluator import Evaluator

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    mcfg, dev = cfg["model"], ctx.device
    batch, n = tr["batch"], tr["pool_clips"]
    sd = make_state_dict(mcfg, clips.torch_seed(ctx.seed, "weights"), dev)
    ctx.mark("weights")
    model = program_pann.build_model(cfg, sd, dev)
    ctx.mark("model")
    pcm = clips.pool(ctx.seed, n, tr["samples"], dev)
    target = clips.targets(ctx.seed, n, mcfg["num_classes"])
    data = MemoryDataset(pcm, target)
    evaluator = Evaluator(model, device=dev)
    ctx.mark("clips")

    def loader(batches):
        return DataLoader(data, batches, num_workers=tr["loader_workers"],
                          pad_to_batch_size=batch, pin_memory=ctx.cuda)

    # warm-up: the cell's one shape, through the same path, over enough
    # batches to fill the loader's workers and queue, so that every pinned
    # buffer of the steady state is allocated before the window
    warm = 2 * tr["loader_workers"] + 4
    evaluator.infer_probs(loader([b for _, b in zip(range(warm),
                                                    cycle_batches(ctx.seed, n, batch))]))
    ctx.sync()
    ctx.mark("warm-up")
    ctx.reset_peak()

    names, waits = [], []
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds

    def timed(it):
        src = iter(it)
        k = 0
        try:
            while time.perf_counter() < deadline:
                if k == tr["trace_after"]:
                    ctx.tracer.start()
                if k == tr["trace_after"] + tr["trace_batches"]:
                    ctx.tracer.stop()
                t = time.perf_counter()
                with span("bench.eval.next"):
                    b = next(src)
                waits.append(time.perf_counter() - t)
                names.append(b["audio_name"][:b["valid"]])
                k += 1
                with span("bench.eval.infer"):
                    yield b
        finally:
            src.close()
            ctx.tracer.stop()

    out = evaluator.infer_probs(timed(loader(cycle_batches(ctx.seed, n, batch))))
    t_end = time.perf_counter()
    probs = out["clipwise_output"]
    rows = np.concatenate(names).astype(np.int64)
    window = t_end - t_start
    peak = ctx.memory_peak()
    ctx.counters.update({"eval.batches": len(waits), "eval.clips": int(len(rows)),
                         "eval.loader_wait_s": float(sum(waits)), "eval.window_s": window})
    fault = ctx.faults.get("eval_answers")
    if fault is not None:
        probs = fault(probs)

    # the check: a seeded sample of the window's answers against the reference
    del evaluator, model, data
    if ctx.cuda:
        torch.cuda.empty_cache()
    pick = _sample(ctx.seed, len(rows), tr["check_clips"])
    want = _reference(sd, pcm, rows[pick], mcfg, tr, dev)
    gap = float(np.abs(np.asarray(probs[pick], np.float32) - want).max())
    return {"end_to_end": {"eval_clips_per_s": len(rows) / window,
                           "setup_s": t_start - ctx.t0},
            "attempted": int(len(rows)), "failed": int(abs(len(probs) - len(rows))),
            "checks": {"prob_gap": gap}, "memory_peak_bytes": peak}


def _reference(sd, pcm, clip_ids, mcfg, tr, dev, quant=None) -> np.ndarray:
    x = torch.from_numpy(pcm[clip_ids]).to(dev)
    return ref.probabilities(sd, x, mcfg, quant=quant, block_rows=tr["check_block"]).cpu().numpy()


def control(ctx, quant) -> dict:
    """The reference in ``quant`` in the program's place, on the clips a run
    of this seed checks (drawn from a pass over the pool): {check: value}."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    mcfg, dev, n = cfg["model"], ctx.device, tr["pool_clips"]
    sd = make_state_dict(mcfg, clips.torch_seed(ctx.seed, "weights"), dev)
    pcm = clips.pool(ctx.seed, n, tr["samples"], dev)
    ids = np.asarray([m["index_in_hdf5"] for m in next(cycle_batches(ctx.seed, n, n))])
    ids = ids[_sample(ctx.seed, n, tr["check_clips"])]
    want = _reference(sd, pcm, ids, mcfg, tr, dev)
    got = _reference(sd, pcm, ids, mcfg, tr, dev, quant=quant)
    return {"prob_gap": float(np.abs(got - want).max())}
