"""Online tagging: ``POST /tag`` on the port's HTTP service
(``cli/serve.py::make_server`` with its default flags, port 0) under an
open-loop Poisson schedule sent by client processes of their own.

Traffic parameters: ``rate`` (requests a second, fixed from the knee
sweep), ``clients`` (processes) and ``threads`` (senders in each),
``pool_clips`` (distinct 10-s clips the requests send, as 16-bit mono
32-kHz WAV), ``timeout`` (seconds a request may take; a failure counts
at it), ``check_answers`` (answers of the window the reference checks,
drawn from the seed), ``trace_after`` and ``trace_seconds`` (the part of
the window a traced run profiles), ``serve_args`` (the CLI's flags).

The window holds every request due in [0, seconds); it closes when the
last of them is answered or has failed. ``serve_p95_ms`` is the 95th
percentile of their latencies, each from its due time.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from benchmark import clips, program, schedule
from benchmark.reference import convnext as ref
from benchmark.reference.weights import make_state_dict


class Server:
    """The port's HTTP service on this process, serving from a thread."""

    def __init__(self, model, serve_args):
        from audioset_convnext_inf_torch.cli.serve import make_server

        self.server, self.service = make_server(["--host", "127.0.0.1", "--port", "0",
                                                 *serve_args], model=model)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.service.stop()
        self.thread.join(timeout=30)


def start_clients(ctx, sched: schedule.Schedule, pool_path: str, port: int, tag: str):
    """The client processes, ready and waiting for ``go``; request i goes to
    client i mod clients."""
    tr = ctx.cell.traffic
    procs = []
    for c in range(tr["clients"]):
        ids = range(c, len(sched.due), tr["clients"])
        spec = {"host": "127.0.0.1", "port": port, "pool": pool_path,
                "threads": tr["threads"], "timeout": tr["timeout"],
                "out": str(ctx.workdir / f"serve-{os.getpid()}-{tag}-{c}.json"),
                "requests": [[int(i), float(sched.due[i]), int(sched.clips[i])] for i in ids]}
        path = ctx.workdir / f"serve-{os.getpid()}-{tag}-{c}.spec.json"
        path.write_text(json.dumps(spec))
        p = subprocess.Popen([sys.executable, "-m", "benchmark.serve_client", str(path)],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                             cwd=str(ctx.repo))
        procs.append((p, spec["out"], path))
    for p, _, _ in procs:
        if p.stdout.readline().strip() != "ready":
            raise RuntimeError("a serve client failed to start")
    return procs


def window(ctx, server: Server, sched: schedule.Schedule, pool_path: str, tag: str,
           trace: bool = False) -> dict:
    """Send ``sched`` and collect every answer: per request (in schedule
    order) due, sent, received (monotonic), status, indexes, probs; plus
    the service's counters over the window."""
    tr = ctx.cell.traffic
    procs = start_clients(ctx, sched, pool_path, server.port, tag)
    before = server.service.counters()
    t0 = time.monotonic() + 0.2
    for p, _, _ in procs:
        p.stdin.write(f"go {t0!r}\n")
        p.stdin.flush()
    t_start = time.perf_counter() + 0.2
    if trace:
        time.sleep(max(0.0, t0 + tr["trace_after"] - time.monotonic()))
        ctx.tracer.start()
        time.sleep(tr["trace_seconds"])
        ctx.tracer.stop()
    res = []
    for p, out, path in procs:
        p.wait()
        with open(out) as f:
            res += json.load(f)
        os.remove(out)
        os.remove(path)
    t_end = time.monotonic()
    after = server.service.counters()
    res.sort(key=lambda r: r[0])
    counters = {k: after.get(k, 0) - before.get(k, 0)
                for k in ("requests", "batches", "clips", "rejected")}
    sent = np.array([r[1] for r in res]) - t0
    recv = np.array([r[2] for r in res]) - t0
    status = np.array([r[3] for r in res])
    return {"t_start": t_start, "window_s": t_end - t0, "due": sched.due, "sent": sent,
            "received": recv, "status": status, "indexes": [r[4] for r in res],
            "probs": [r[5] for r in res], "counters": counters}


def summarise(w: dict, timeout: float) -> dict:
    ok = w["status"] == 200
    lat = schedule.latencies(w["due"], w["received"], ok, timeout)
    late = w["sent"] - w["due"]
    n = len(w["due"])
    last_due = float(w["due"][-1]) if n else 0.0
    return {"requests": n, "answered": int(ok.sum()), "failed": int(n - ok.sum()),
            "refused": int((w["status"] == 429).sum()), "p50_ms": 1e3 * float(np.median(lat)),
            "p95_ms": 1e3 * schedule.p95(lat), "late_p50_ms": 1e3 * float(np.median(late)),
            "late_max_ms": 1e3 * float(late.max()),
            "completed_per_s": float(ok.sum()) / max(float(w["received"][ok].max()), 1e-9)
            if ok.any() else 0.0, "offered_per_s": n / max(last_due, 1e-9) if n > 1 else 0.0,
            **{f"service.{k}": v for k, v in w["counters"].items()}}


def setup(ctx):
    """Weights, the model and the started (warmed) service, the clip pool
    saved for the clients."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    mcfg, dev = cfg["model"], ctx.device
    sd = make_state_dict(mcfg, clips.torch_seed(ctx.seed, "weights"), dev)
    ctx.mark("weights")
    model = program.build_model(cfg, sd, dev)
    ctx.mark("model")
    pcm = clips.pool(ctx.seed, tr["pool_clips"], tr["samples"], dev)
    pool_path = str(ctx.workdir / f"serve-{os.getpid()}-pool.npy")
    np.save(pool_path, pcm)
    ctx.mark("clips")
    server = Server(model, tr["serve_args"])
    ctx.mark("service")
    warm_http(server.port, pcm, tr["warm_requests"], tr["timeout"])
    ctx.mark("http warm-up")
    return sd, model, pcm, pool_path, server


def warm_http(port: int, pcm: np.ndarray, n: int, timeout: float) -> None:
    """``n`` requests through the whole served path before the window, all
    at once: the handler's first-use imports and the batcher's full batch
    happen in set-up, not in the window."""
    from concurrent.futures import ThreadPoolExecutor

    from benchmark.serve_client import post, wav_bytes

    bodies = [wav_bytes(pcm[i % len(pcm)]) for i in range(n)]
    with ThreadPoolExecutor(n) as pool:
        codes = list(pool.map(lambda b: post("127.0.0.1", port, b, timeout)[0], bodies))
    if any(c != 200 for c in codes):
        raise RuntimeError(f"the service failed its warm-up requests: {codes}")


def run(ctx) -> dict:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    mcfg, dev = cfg["model"], ctx.device
    sd, model, pcm, pool_path, server = setup(ctx)
    try:
        sched = schedule.poisson(ctx.seed, tr["rate"], ctx.seconds, tr["pool_clips"])
        ctx.reset_peak()
        w = window(ctx, server, sched, pool_path, "run", trace=ctx.trace)
        peak = ctx.memory_peak()
    finally:
        server.close()
        os.remove(pool_path)
    s = summarise(w, tr["timeout"])
    ctx.counters.update(s)
    fault = ctx.faults.get("serve_answers")
    if fault is not None:
        w["indexes"], w["probs"] = fault(w["indexes"], w["probs"])
    del model, server
    if ctx.cuda:
        torch.cuda.empty_cache()
    ok = np.flatnonzero(w["status"] == 200)
    pick = np.sort(clips.rng(ctx.seed, "serve-check").choice(
        ok, size=min(tr["check_answers"], len(ok)), replace=False)) if len(ok) else ok
    ids = sched.clips[pick]
    want = _reference(sd, pcm, ids, mcfg, dev)
    checks = _compare([w["indexes"][i] for i in pick], [w["probs"][i] for i in pick], want,
                      tr["top_k"])
    return {"end_to_end": {"serve_p95_ms": s["p95_ms"], "setup_s": w["t_start"] - ctx.t0},
            "attempted": s["requests"], "failed": s["failed"], "checks": checks,
            "memory_peak_bytes": peak, "complete": len(pick) > 0}


def _reference(sd, pcm, ids, mcfg, dev, quant=None) -> np.ndarray:
    """Reference probabilities (len(ids), classes) of the clips ``ids``."""
    uniq, inv = np.unique(ids, return_inverse=True)
    x = torch.from_numpy(pcm[uniq]).to(dev)
    probs = ref.probabilities(sd, x, mcfg, quant=quant).cpu().numpy()
    return probs[inv]


def _compare(indexes, probs, want: np.ndarray, top_k: int) -> dict:
    """``top_prob_gap``: widest gap between an answered probability and the
    reference's for that class. ``top_rank_gap``: widest amount by which
    the reference's k-th best probability exceeds its probability of the
    answer's k-th class (0 when the answer lists the reference's top k in
    order). An answer of the wrong length reads 1 on both."""
    prob_gap = rank_gap = 0.0
    for idx, p, w in zip(indexes, probs, want):
        if len(idx) != top_k or len(p) != top_k:
            return {"top_prob_gap": 1.0, "top_rank_gap": 1.0}
        idx = np.asarray(idx, np.int64)
        best = np.sort(w)[::-1][:top_k]
        prob_gap = max(prob_gap, float(np.abs(np.asarray(p) - w[idx]).max()))
        rank_gap = max(rank_gap, float((best - w[idx]).max()))
    return {"top_prob_gap": prob_gap, "top_rank_gap": rank_gap}


def control(ctx, quant) -> dict:
    """The reference in ``quant`` in the program's place: its top-k answers
    for the clips a run of this seed would check."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    mcfg, dev, n = cfg["model"], ctx.device, tr["pool_clips"]
    sd = make_state_dict(mcfg, clips.torch_seed(ctx.seed, "weights"), dev)
    pcm = clips.pool(ctx.seed, n, tr["samples"], dev)
    ids = clips.rng(ctx.seed, "serve-check").choice(n, size=min(tr["check_answers"], n),
                                                    replace=False)
    want = _reference(sd, pcm, ids, mcfg, dev)
    low = _reference(sd, pcm, ids, mcfg, dev, quant=quant)
    top = np.argsort(-low, axis=1)[:, :tr["top_k"]]
    return _compare(list(top), [row[t] for row, t in zip(low, top)], want, tr["top_k"])
