"""Import isolation: nothing the benchmark runs imports JAX or the JAX
package, and the reference imports nothing of the program. Top-level
module names are compared whole (the part before the first dot): the
port's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark.spec import HERE, REPO

JAX = ("jax", "jaxlib", "flax", "audioset_convnext_inf_tpu")
PORT = "audioset_convnext_inf_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(folder: Path):
    return [p for p in folder.rglob("*.py") if "tests" not in p.relative_to(HERE).parts]


def test_no_source_of_the_benchmark_names_jax_or_the_jax_package():
    for path in _sources(HERE):
        for name in _imports(path):
            assert name.split(".")[0] not in JAX, f"{path} imports {name}"


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(HERE / "reference"):
        for name in _imports(path):
            assert name.split(".")[0] != PORT, f"{path} imports {name}"


def _run_blocked(code: str, blocked) -> subprocess.CompletedProcess:
    prelude = "import sys\n" + "".join(f"sys.modules[{b!r}] = None\n" for b in blocked)
    return subprocess.run([sys.executable, "-c", prelude + code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)


def test_every_module_of_the_run_loads_with_jax_blocked():
    code = """
import importlib, pkgutil
import benchmark, benchmark.drivers
from benchmark import spec
for m in ["benchmark.run", "benchmark.control", "benchmark.sweep", "benchmark.serve_client",
          "benchmark.program", "benchmark.reference.convnext", "benchmark.reference.draws",
          "benchmark.reference.weights"]:
    importlib.import_module(m)
for info in pkgutil.iter_modules(benchmark.drivers.__path__):
    importlib.import_module("benchmark.drivers." + info.name)
bench = spec.load()
for m in bench["per_layer"]:
    spec.reader(m["name"])
import audioset_convnext_inf_torch.engine.trainer, audioset_convnext_inf_torch.engine.evaluator
import audioset_convnext_inf_torch.cli.serve, audioset_convnext_inf_torch.data.loader
bad = sorted(n for n, m in sys.modules.items() if m is not None and n.split(".")[0] in %r)
print("LOADED", bad)
""" % (JAX,)
    out = _run_blocked(code, JAX)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_the_reference_loads_with_the_program_blocked():
    code = """
import benchmark.reference.convnext, benchmark.reference.draws, benchmark.reference.weights
print("LOADED", sorted(n for n, m in sys.modules.items() if m is not None and n.split(".")[0] == %r))
""" % (PORT,)
    out = _run_blocked(code, (PORT,))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_the_run_refuses_without_a_card_and_prints_no_result():
    code = """
import torch
torch.cuda.is_available = lambda: False
from benchmark import run
raise SystemExit(run.main(["--workload", "tiny-eval-b256", "--seed", "1", "--seconds", "1"]))
"""
    out = _run_blocked(code, JAX)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_a_rank_that_loaded_jax_stops_the_result(tmp_path):
    """Four gloo processes on the CPU, through ``main`` with its look for a
    card answered yes: one rank, not rank 0, finds a module named ``jax`` in
    its own ``sys.modules`` after its window, and the run exits with code 3
    and prints no result, naming the module; unplanted, the same run prints one."""
    code = """
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 4
from benchmark import run, spec
from benchmark.tests.tiny import tiny_cell
spec.cell = lambda bench, name: tiny_cell(name, clips_in=16, batches=4, check_block=8,
                                          trace_after=1, trace_steps=1)
run.power_limit = lambda: "none"
real = run.execute
run.execute = lambda cell, seed, seconds, trace: real(
    cell, seed, seconds, trace, device="cpu", faults=%r, workdir=%r)
raise SystemExit(run.main(["--workload", "tiny-train-ddp4", "--seed", "2147483749",
                           "--seconds", "1"]))
"""
    for faults, rc in (({}, 0), ({"plant_jax": 1}, 3)):
        out = _run_blocked(code % (faults, str(tmp_path)), JAX)
        assert out.returncode == rc, out.stderr[-3000:]
        results = [line for line in out.stdout.splitlines() if line.startswith("{")]
        if rc:
            assert results == []
            assert "JAX modules were loaded: jax" in out.stderr
        else:
            assert json.loads(results[-1])["device"]["count"] == 4
