"""``BENCHMARK.json`` and the data files it names, found by name.

 - a configuration ``<config>``: ``benchmark/configs/<config>.json``;
 - a traffic mix ``<traffic>``: ``benchmark/traffic/<traffic>.json``, whose
   ``driver`` names the general generator that reads it,
   ``benchmark/drivers/<driver>.py``;
 - a cell's correctness limits: ``benchmark/limits/<cell>.json``;
 - a per-layer metric ``<metric>``: its reader,
   ``benchmark/layer_metrics/<metric>.py``, with ``read(run)``.

Adding a cell, a mix, a configuration or a metric adds files and entries;
no existing file changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, NamedTuple

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {  # the keys an entry of each section may have
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


class Cell(NamedTuple):
    name: str
    chips: int
    why: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load(root: Path = REPO) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_dir(root: Path) -> Path:
    return Path(root) / "benchmark"


def metrics_for(bench: dict, cell: str, kind: str) -> List[dict]:
    """The end-to-end or per-layer metrics that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def cell(bench: dict, name: str, root: Path = REPO) -> Cell:
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    b = bench_dir(root)
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(name, int(w["chips"]), w["why"], _json(Path(root) / cfg["file"]),
                _json(b / "traffic" / f"{w['traffic']}.json"),
                _json(b / "limits" / f"{name}.json"),
                metrics_for(bench, name, "end_to_end"), metrics_for(bench, name, "per_layer"))


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(metric: str, root: Path = REPO):
    """The module that reads per-layer ``metric`` (loaded by path: metric
    names hold dots)."""
    path = bench_dir(root) / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(bench: dict, root: Path = REPO) -> List[str]:
    """What is wrong with ``bench`` and the files it names (empty: none)."""
    out: List[str] = []
    b = bench_dir(root)

    def name_ok(what: str, v) -> None:
        if not isinstance(v, str) or not NAME.match(v):
            out.append(f"{what} {v!r} is not a valid name")

    configs: Dict[str, dict] = {}
    for c in bench.get("configs", []):
        name_ok("config", c.get("name"))
        configs[c["name"]] = c
        for k in c.get("reduced", []):
            name_ok("reduced key", k)
        if not (Path(root) / c["file"]).is_file():
            out.append(f"config file {c['file']} is missing")
    metrics = bench.get("end_to_end", []) + bench.get("per_layer", [])
    for m in metrics:
        name_ok("metric", m.get("name"))
        if not isinstance(m.get("unit"), str) or not UNIT.match(m["unit"]):
            out.append(f"unit {m.get('unit')!r} of {m.get('name')} is not valid")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"better of {m.get('name')} must be lower or higher")
    for m in bench.get("per_layer", []):
        if not (b / "layer_metrics" / f"{m['name']}.py").is_file():
            out.append(f"per-layer metric {m['name']} has no reader")
    e2e = {m["name"] for m in bench.get("end_to_end", [])}
    for m in bench.get("per_layer", []):
        if m.get("moves") not in e2e:
            out.append(f"{m['name']} moves {m.get('moves')!r}, not an end-to-end metric")
    cells = set()
    for w in bench.get("workloads", []):
        name_ok("workload", w.get("name"))
        name_ok("traffic", w.get("traffic"))
        cells.add(w["name"])
        if w.get("config") not in configs:
            out.append(f"{w['name']} names an unknown config {w.get('config')!r}")
        if w.get("chips") not in (1, 4):
            out.append(f"{w['name']} asks for {w.get('chips')} chips")
        tfile = b / "traffic" / f"{w['traffic']}.json"
        if not tfile.is_file():
            out.append(f"traffic file {tfile.name} is missing")
        elif not (b / "drivers" / f"{_json(tfile).get('driver')}.py").is_file():
            out.append(f"traffic {w['traffic']} names no driver module")
        if not (b / "limits" / f"{w['name']}.json").is_file():
            out.append(f"{w['name']} has no limits file")
    for m in metrics:
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"{m['name']} lists an unknown workload {c!r}")
    names = [m["name"] for m in metrics]
    if len(set(names)) != len(names):
        out.append("two metrics share a name")
    for section, keys in KEYS.items():
        for e in bench.get(section, []):
            if set(e) - keys:
                out.append(f"{e.get('name')} has keys {sorted(set(e) - keys)} "
                           f"not allowed in {section}")
            for k in ("why", "layer", "source"):
                v = e.get(k, "x")
                if not 1 <= len(v) <= 200 or "\n" in v or "\t" in v:
                    out.append(f"{e.get('name')}: its {k} is not one line of 1-200 characters")
    return out
