"""Readings of a cell's control: the plain reference computed in a lower
precision, put in the program's place, on the inputs a run of each seed
checks, at the cell's own sizes.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 [--quant float8_e4m3fn]

Prints one JSON line per seed with each compared number; the limits in
``benchmark/limits/<cell>.json`` are set between the program's readings
(its runs' ``checks``) and these. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import spec
from benchmark.run import Context, REPO

QUANTS = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--quant", default=None, help="default: the configuration's control")
    args = p.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    if not torch.cuda.is_available():
        print("error: the control is read on the card", file=sys.stderr)
        return 2
    quant = QUANTS[args.quant or cell.config["control"]]
    drv = spec.driver(cell.traffic["driver"])
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = Context(cell, seed, 0.0, False, "cuda", t, REPO / "build")
        out = drv.control(ctx, quant)
        print(json.dumps({"workload": cell.name, "seed": seed, "quant": str(quant),
                          "readings": out, "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
