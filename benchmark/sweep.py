"""Knee sweep of a serve cell: one service, one open-loop window per
offered rate, in increasing order.

    python3 -m benchmark.sweep --workload tiny-serve-poisson --seed 7 --seconds 10 \\
        --rates 100 200 300

For each rate, one line: offered and completed requests a second, p50 and
p95 latency from the due time, the p95 of the first and of the last fifth
of the requests (a growing backlog shows as the second above the first),
refusals, failures, the generator's lateness and the mean batch fill. The
knee is the highest rate whose completed rate keeps up with the offered
one, with no refusal and no growing backlog; the cell's rate is fixed at
0.8 times it, by hand, in its traffic file. The benchmark's runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from benchmark import schedule, spec
from benchmark.drivers import serve
from benchmark.run import REPO, Context


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: the sweep runs on the card", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load(), args.workload)
    tr = cell.traffic
    ctx = Context(cell, args.seed, args.seconds, False, "cuda", time.perf_counter(),
                  REPO / "build")
    _, _, _, pool_path, server = serve.setup(ctx)
    try:
        for i, rate in enumerate(sorted(args.rates)):
            sched = schedule.poisson(args.seed + i, rate, args.seconds, tr["pool_clips"])
            w = serve.window(ctx, server, sched, pool_path, f"sweep{i}")
            s = serve.summarise(w, tr["timeout"])
            ok = w["status"] == 200
            lat = schedule.latencies(w["due"], w["received"], ok, tr["timeout"])
            fifth = max(1, len(lat) // 5)
            s.update(rate=rate, p95_first_ms=1e3 * schedule.p95(lat[:fifth]),
                     p95_last_ms=1e3 * schedule.p95(lat[-fifth:]),
                     fill=s["service.clips"] / max(s["service.batches"], 1))
            print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                              for k, v in s.items()}), flush=True)
    finally:
        server.close()
        os.remove(pool_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
