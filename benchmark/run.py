"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Loads ``BENCHMARK.json``, finds the cell, its
configuration, its traffic mix and its limits by name, and hands them to
the mix's driver (``benchmark/drivers/<driver>.py``), which sets up the
program, warms up every shape the cell uses, measures for ``--seconds``,
and checks what the timed path produced against the plain reference.
With ``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` a short steady part of the window is profiled and the result
carries the per-layer metrics, each read by its own reader
(``benchmark/layer_metrics/<metric>.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit
(also the last lines of standard error). Without a CUDA device, or with
fewer than the cell asks for, it exits with code 2 and prints no result;
if JAX or the JAX package was loaded in this process or in a process that
ran a rank's window, with code 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # process start, as near as Python gets

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audioset_convnext_inf_tpu")


def _pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = REPO / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))


_pin_caches()

import torch  # noqa: E402

from benchmark import spec  # noqa: E402
from benchmark.trace import Tracer  # noqa: E402


class Context:
    """What a driver gets: the cell, the run's arguments, the device, the
    tracer, and places for counters and for lines printed before the result."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
                 t0: float, workdir: Path):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.t0 = t0
        self.workdir = workdir = Path(workdir)
        self.repo = REPO
        self.tracer = Tracer(trace, str(workdir / f"trace-{os.getpid()}.json"))
        self.counters: Dict[str, float] = {}
        self.faults: Dict[str, object] = {}  # tests plant faults here

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def log(self, msg: str) -> None:
        print(msg, flush=True)

    def mark(self, what: str) -> None:
        """Log the seconds since process start at a step of set-up."""
        self.log(f"setup {what} {time.perf_counter() - self.t0:.3f} s")

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def memory_peak(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0


class RunData:
    """What a per-layer reader gets: ``read(run)`` returns a number or None."""

    def __init__(self, ctx: Context, outcome: dict):
        self.cell = ctx.cell
        self.config, self.traffic, self.chips = ctx.cell.config, ctx.cell.traffic, ctx.cell.chips
        self.end_to_end = outcome["end_to_end"]
        self.counters = ctx.counters
        self.trace = ctx.tracer.trace


def power_limit() -> str:
    """``name, power.limit`` of each card, from nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return "; ".join(out.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def jax_modules() -> List[str]:
    return sorted(n for n, m in list(sys.modules.items())
                  if m is not None and n.split(".")[0] in FORBIDDEN)


class JaxLoaded(RuntimeError):
    """A process that ran the window found JAX or the JAX package in its
    ``sys.modules``: the names it found."""

    def __init__(self, names: List[str]):
        super().__init__(", ".join(names))
        self.names = list(names)


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
            t0: Optional[float] = None, faults: Optional[dict] = None,
            workdir: Optional[Path] = None) -> dict:
    """One run of ``cell``: the result object the last line prints."""
    workdir = Path(workdir or os.environ.get("TMPDIR") or REPO / "build")
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = Context(cell, seed, seconds, trace, device, T0 if t0 is None else t0, workdir)
    ctx.faults.update(faults or {})
    ctx.mark("imports")
    outcome = spec.driver(cell.traffic["driver"]).run(ctx)
    ctx.tracer.finish()
    limits = cell.limits["checks"]
    checks = {}
    for name, value in outcome["checks"].items():
        if name in limits:
            checks[name] = {"value": value, "limit": limits[name]["limit"]}
        else:  # read, but not compared: the limits file says why
            ctx.counters[f"uncompared.{name}"] = value
    correct = (bool(checks) and set(checks) == set(limits)
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values())
               and outcome["failed"] == 0 and outcome.get("complete", True))
    e2e = outcome["end_to_end"]
    if trace:
        run = RunData(ctx, outcome)
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if ctx.cuda else ctx.device.type,
           "kind": outcome.get("device_kind") or (torch.cuda.get_device_name(ctx.device) if ctx.cuda
                                                    else ctx.device.type),
           "count": outcome.get("devices", 1),
           "memory_peak_bytes": outcome["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": int(outcome["attempted"]),
              "failed": int(outcome["failed"]), "metrics": metrics, "device": dev}
    tr = ctx.tracer.trace
    if trace and tr is not None:
        dev["busy_s"] = outcome.get("busy_s", tr.busy_s())
        dev["window_s"] = outcome.get("window_s", tr.window_s())
        result["breakdown"] = {"device_ops": [[n[:160], v] for n, v in tr.device_ops()],
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    for k, v in sorted(ctx.counters.items()):
        ctx.log(f"counter {k} {v}")
    for k, v in sorted(e2e.items()):
        ctx.log(f"measured {k} {v}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {cell.name} needs {cell.chips} CUDA device(s); found {have}",
              file=sys.stderr)
        return 2
    print(f"card {power_limit()}", flush=True)
    try:
        result = execute(cell, args.seed, args.seconds, bool(args.trace))
        found = jax_modules()
    except JaxLoaded as e:
        found = sorted(set(e.names) | set(jax_modules()))
    if found:
        print(f"error: JAX modules were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
