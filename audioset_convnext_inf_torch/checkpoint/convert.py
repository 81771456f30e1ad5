"""Carry the JAX package's parameter pytree into the port's state dict.

``state_dict_from_jax_params`` is the port's own copy of the JAX package's
``checkpoint/convert.py::jax_params_to_torch_state_dict``, in numpy only: it
takes the pytree (nested dicts/lists of arrays; anything ``np.asarray``
accepts) and returns the reference-keyed state dict that
``model.load_state_dict(..., strict=True)`` loads:

    bn0.{scale,bias,mean,var}  -> bn0.{weight,bias,running_mean,running_var}
    stem.conv (HWIO)           -> downsample_layers.0.0 (OIHW)
    stem.norm                  -> downsample_layers.0.1
    downsample[i-1].norm/conv  -> downsample_layers.i.0 / .1   (i in 1..3)
    stages[i][j].dwconv        -> stages.i.j.dwconv   ((7,7,1,C) -> (C,1,7,7))
    stages[i][j].pwconv{1,2}   -> stages.i.j.pwconv{1,2}  ((in,out) -> (out,in))
    stages[i][j].norm, gamma   -> stages.i.j.norm, gamma
    final_norm                 -> norm
    head                       -> head_audioset   (Linear transpose)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from audioset_convnext_inf_torch.config import ConvNeXtConfig

Params = Dict[str, Any]


def state_dict_from_jax_params(params: Params, cfg: Optional[ConvNeXtConfig] = None
                               ) -> Dict[str, np.ndarray]:
    """JAX parameter pytree -> reference-keyed numpy state dict. ``cfg`` is
    accepted for the JAX function's signature; the pytree carries the shapes."""
    out: Dict[str, np.ndarray] = {}

    def put_conv(prefix: str, p):
        out[prefix + ".weight"] = np.transpose(np.asarray(p["w"]), (3, 2, 0, 1))
        out[prefix + ".bias"] = np.asarray(p["b"])

    def put_ln(prefix: str, p):
        out[prefix + ".weight"] = np.asarray(p["scale"])
        out[prefix + ".bias"] = np.asarray(p["bias"])

    def put_lin(prefix: str, p):
        out[prefix + ".weight"] = np.ascontiguousarray(np.asarray(p["w"]).T)
        out[prefix + ".bias"] = np.asarray(p["b"])

    out["bn0.weight"] = np.asarray(params["bn0"]["scale"])
    out["bn0.bias"] = np.asarray(params["bn0"]["bias"])
    out["bn0.running_mean"] = np.asarray(params["bn0"]["mean"])
    out["bn0.running_var"] = np.asarray(params["bn0"]["var"])
    put_conv("downsample_layers.0.0", params["stem"]["conv"])
    put_ln("downsample_layers.0.1", params["stem"]["norm"])
    for i in range(1, 4):
        put_ln(f"downsample_layers.{i}.0", params["downsample"][i - 1]["norm"])
        put_conv(f"downsample_layers.{i}.1", params["downsample"][i - 1]["conv"])
    for i, stage in enumerate(params["stages"]):
        for j, block in enumerate(stage):
            p = f"stages.{i}.{j}"
            put_conv(f"{p}.dwconv", block["dwconv"])
            put_ln(f"{p}.norm", block["norm"])
            put_lin(f"{p}.pwconv1", block["pwconv1"])
            put_lin(f"{p}.pwconv2", block["pwconv2"])
            if "gamma" in block:
                out[f"{p}.gamma"] = np.asarray(block["gamma"])
    put_ln("norm", params["final_norm"])
    put_lin("head_audioset", params["head"])
    return out


def to_tensors(state_dict: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """numpy state dict -> tensors, ready for ``load_state_dict``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state_dict.items()}
