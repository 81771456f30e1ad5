"""Discovery by name: a cell, a traffic mix, a configuration, limits and a
per-layer metric are found from the files a later change adds, with no
existing file edited; and every name and unit keeps to the allowed
characters."""

import json
import shutil

import pytest

from benchmark import spec


def test_benchmark_json_is_valid():
    bench = spec.load()
    assert spec.problems(bench) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    assert all(spec.NAME.match(n) for n in names)
    assert all(spec.UNIT.match(m["unit"]) and len(m["unit"]) <= 16
               for m in bench["end_to_end"] + bench["per_layer"])
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer


def test_a_new_cell_config_mix_and_metric_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    b = root / "benchmark"

    cfg = json.loads((b / "configs" / "convnext_tiny-bf16-serve.json").read_text())
    cfg["name"] = "convnext_tiny-f32-serve"
    cfg["program"]["compute_dtype"] = "float32"
    (b / "configs" / "convnext_tiny-f32-serve.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "eval-b256.json").read_text())
    mix["batch"] = 64
    (b / "traffic" / "eval-b64.json").write_text(json.dumps(mix))
    (b / "limits" / "tiny-f32-eval-b64.json").write_text(
        json.dumps({"checks": {"prob_gap": {"limit": 0.001}}}))
    (b / "layer_metrics" / "eval.batches.py").write_text(
        "def read(run):\n    return run.counters.get('eval.batches')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "convnext_tiny-f32-serve", "source": "x",
                             "file": "benchmark/configs/convnext_tiny-f32-serve.json",
                             "reduced": [], "why": "f32"})
    bench["workloads"].append({"name": "tiny-f32-eval-b64", "config": "convnext_tiny-f32-serve",
                               "traffic": "eval-b64", "chips": 1, "why": "f32 at 64"})
    bench["end_to_end"][0].setdefault("workloads", []).append("tiny-f32-eval-b64")
    bench["per_layer"].append({"name": "eval.batches", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "eval_clips_per_s", "workloads": ["tiny-f32-eval-b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    assert spec.problems(bench, root) == []
    cell = spec.cell(bench, "tiny-f32-eval-b64", root)
    assert cell.config["program"]["compute_dtype"] == "float32"
    assert cell.traffic["batch"] == 64 and cell.limits["checks"]["prob_gap"]["limit"] == 0.001
    assert [m["name"] for m in cell.per_layer] == ["eval.batches"]
    reader = spec.reader("eval.batches", root)
    assert reader.read(type("Run", (), {"counters": {"eval.batches": 3}})) == 3
    edited = [p for p, data in before.items()
              if p.name != "BENCHMARK.json" and p.read_bytes() != data]
    assert edited == []


@pytest.mark.parametrize("bad", ["has space", "a,b", "a/b", "", "x" * 65, "µs"])
def test_bad_names_are_refused(bad):
    bench = spec.load()
    bench = json.loads(json.dumps(bench))
    bench["workloads"][0]["name"] = bad
    assert any("not a valid name" in p for p in spec.problems(bench))


def test_bad_units_are_refused():
    bench = json.loads(json.dumps(spec.load()))
    bench["end_to_end"][0]["unit"] = "clips per second"
    assert any("unit" in p for p in spec.problems(bench))


def test_unknown_keys_and_long_text_are_refused():
    bench = json.loads(json.dumps(spec.load()))
    bench["per_layer"][0]["why"] = "a why on a metric"
    bench["workloads"][0]["why"] = "x" * 201
    found = spec.problems(bench)
    assert any("not allowed in per_layer" in p for p in found)
    assert any("1-200 characters" in p for p in found)
