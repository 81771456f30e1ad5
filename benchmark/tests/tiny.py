"""Tiny cells for the benchmark's CPU tests: the shipped configurations and
traffic mixes cut to a size the CPU runs in seconds (a narrow, shallow
trunk, 64 mel bins, 1-s clips, small batches). A tiny trunk's bf16 runs
read other gaps than the full-width one, so the tiny cells carry limits of
their own, set like the shipped ones between the program's readings and
the float8 control's at this size. The serve mix and the 4-card mix have
no cell in ``BENCHMARK.json`` (PERF.md says why); their drivers are tested
all the same, with the end-to-end metric each reports."""

from __future__ import annotations

import json

from benchmark import spec

# cell: (configuration, traffic mix, chips, {compared number: limit}, end-to-end metric)
CELLS = {
    "tiny-eval-b256": ("convnext_tiny-bf16-serve", "eval-b256", 1, {"prob_gap": 0.01},
                       "eval_clips_per_s"),
    "tiny-serve-poisson": ("convnext_tiny-bf16-serve", "serve-poisson", 1,
                           {"top_prob_gap": 0.01, "top_rank_gap": 0.01}, "serve_p95_ms"),
    "tiny-train-b64": ("convnext_tiny-bf16-train", "train-b64", 1,
                       {"grad_gap": 0.03, "update_gap": 0.03}, "train_clips_per_s"),
    "tiny-train-ddp4": ("convnext_tiny-bf16-train", "train-ddp4", 4,
                        {"grad_gap": 0.03, "update_gap": 0.03, "rank_param_gap": 0.0},
                        "train_clips_per_s"),
}


def _json(path):
    with open(path) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    cfg = _json(spec.HERE / "configs" / f"{name}.json")
    m = cfg["model"]
    m.update(depths=[1, 1, 2, 1], dims=[16, 32, 64, 128], num_classes=40)
    m["frontend"].update(n_mels=64, fmax=8000.0)
    m["spec_augment"].update(time_drop_width=8, freq_drop_width=8)
    return cfg


def tiny_cell(workload: str, **traffic) -> spec.Cell:
    config, mix, chips, limits, metric = CELLS[workload]
    tr = _json(spec.HERE / "traffic" / f"{mix}.json")
    tr.update({"samples": 32000, **traffic})
    bench = spec.load()
    if workload in {w["name"] for w in bench["workloads"]}:
        e2e = spec.metrics_for(bench, workload, "end_to_end")
        per_layer = spec.metrics_for(bench, workload, "per_layer")
    else:
        e2e = [{"name": metric, "unit": "-"}, {"name": "setup_s", "unit": "s"}]
        per_layer = []
    return spec.Cell(workload, chips, "tiny", tiny_config(config), tr,
                     {"checks": {k: {"limit": v} for k, v in limits.items()}}, e2e, per_layer)
