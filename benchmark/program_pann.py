"""The program under test for a PANN configuration, built from its file.

With ``program.py``, the only module of the benchmark that imports the
PyTorch port, and it does so inside its functions. A configuration's
``model`` holds the published shapes (shared with the reference) and
``program`` the port's settings (compute dtype, frontend precision and
DFT).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict

import torch

from benchmark.program import DTYPES


def build_model(cfg: dict, state_dict: Dict[str, torch.Tensor], device):
    """The port's zoo model of the configuration's name, its frontend as
    stated, with the benchmark's weights."""
    from audioset_convnext_inf_torch.models.pann import PANN_REGISTRY, build_pann_model

    m, p = cfg["model"], cfg["program"]
    pcfg = PANN_REGISTRY[m["name"]]
    fe = m["frontend"]
    frontend = replace(pcfg.frontend, sample_rate=fe["sample_rate"], n_fft=fe["n_fft"],
                       win_length=fe["win_length"], hop_length=fe["hop_length"],
                       n_mels=fe["n_mels"], fmin=fe["fmin"], fmax=fe["fmax"], amin=fe["amin"],
                       ref=fe["ref"], precision=p["frontend_precision"], dft_impl=p["dft_impl"])
    model = build_pann_model(replace(pcfg, frontend=frontend, classes_num=m["num_classes"]),
                             device=device, compute_dtype=DTYPES[p["compute_dtype"]])
    model.load_state_dict(state_dict, strict=True)
    return model
