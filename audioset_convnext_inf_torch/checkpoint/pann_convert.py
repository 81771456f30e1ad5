"""Checkpoints of the PANN zoo: reference state dicts in, JAX parameters across.

The zoo's modules (``models/pann.py``) hold their parameters under the
reference's state-dict names, so a reference checkpoint (the published
``Cnn14_mAP=0.431.pth`` and the rest) loads with ``load_pann_state_dict``,
which drops what the port computes itself (the frontend's extractor and
SpecAugment entries, BN's ``num_batches_tracked``) and, for ``cnn_next``,
renames the reference's uneven block labels (``conv_block11``,
``conv_block12``, ``conv_block21``, ...) to ``conv_block1..n`` in their
sorted order, as the JAX package's converter ranks them.

``pann_state_dict_from_params`` is the inverse of the JAX package's
``checkpoint/pann_convert.py::pann_state_dict_to_params``: the JAX
package's parameter pytree (nested dicts and lists of arrays) to the
reference-keyed numpy state dict, undoing its layouts:

 - conv2d ``w`` HWIO (kH, kW, I, O) -> ``weight`` (O, I, kH, kW)
 - conv1d ``w`` WIO (K, I, O)       -> ``weight`` (O, I, K)
 - linear ``w`` (I, O)              -> ``weight`` (O, I)
 - BN ``scale/bias/mean/var``       -> ``weight/bias/running_mean/running_var``
 - LN ``scale/bias``                -> ``weight/bias``
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Tuple, Union

import numpy as np
import torch

from audioset_convnext_inf_torch.models.pann import PANN_REGISTRY, PannConfig, mbv2_block_meta

Params = Dict[str, Any]

SKIP = ("spectrogram_extractor.", "logmel_extractor.", "spec_augmenter.",
        "num_batches_tracked")
_LEAF = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}
_DEFORM = {"offset": "offset_conv", "modulator": "modulator_conv", "regular": "regular_conv"}


def _rank_next_labels(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """cnn_next: ``conv_block<label>.`` -> ``conv_block<rank + 1>.``; the
    numeric labels sort in forward order (models.py:1363-1372, 1791-1800)."""
    labels = sorted({int(m.group(1)) for k in state_dict
                     if (m := re.match(r"conv_block(\d+)\.", k))})
    rank = {lbl: i + 1 for i, lbl in enumerate(labels)}
    return {re.sub(r"^conv_block(\d+)\.", lambda m: f"conv_block{rank[int(m.group(1))]}.", k): v
            for k, v in state_dict.items()}


def load_pann_state_dict(model: torch.nn.Module, state_dict: Dict[str, Any]) -> torch.nn.Module:
    """Load a reference-keyed state dict (tensors or numpy arrays) into a
    zoo model, strictly: every key of the model, nothing else."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
          for k, v in state_dict.items() if not any(s in k for s in SKIP)}
    if model.cfg.family == "cnn_next":
        sd = _rank_next_labels(sd)
    model.load_state_dict(sd, strict=True)
    return model


def _leaves(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _module_path(cfg: PannConfig, parts: List) -> List:
    """The JAX pytree path of a module -> its reference module path (the
    inverse of the JAX converter's ``_rewrite_path``)."""
    fam = cfg.family
    head = parts[0]
    if fam in ("leenet", "dainet") and head == "blocks":
        return [f"conv_block{parts[1] + 1}"] + parts[2:]
    if fam in ("resnet", "res1dnet") and head == "resnet":
        stage, block, rest = parts[2], parts[3], parts[4:]
        if rest[0] == "downsample":
            # [conv, bn] at stage 0; [pool, conv, bn] after it
            rest = ["downsample", {"conv": 0, "bn": 1}[rest[1]] + (stage > 0)]
        return ["resnet", f"layer{stage + 1}", block] + rest
    # MobileNets: the reference's Sequential indices (pools and activations
    # hold places but no keys)
    if fam.startswith("mobilenet") and head == "conv_bn":
        return ["features", 0, {"conv": 0, "bn": 2}[parts[1]]]
    if fam == "mobilenet_v1" and head == "blocks":
        return ["features", parts[1] + 1, {"dw": 0, "bn1": 2, "pw": 4, "bn2": 5}[parts[2]]]
    if fam == "mobilenet_v2" and head == "blocks":
        if mbv2_block_meta()[parts[1]][0] == 1:
            index = {"dw": 0, "bn_dw": 2, "project": 4, "bn_project": 5}
        else:
            index = {"expand": 0, "bn_expand": 1, "dw": 3, "bn_dw": 5, "project": 7,
                     "bn_project": 8}
        return ["features", parts[1] + 1, "conv", index[parts[2]]]
    if fam == "mobilenet_v2" and head in ("conv_1x1", "bn_1x1"):
        return ["features", len(mbv2_block_meta()) + 1, {"conv_1x1": 0, "bn_1x1": 1}[head]]
    if fam == "cnn_next":
        if head == "stem":
            return ["stem", {"conv": 0, "norm": 1}[parts[1]]]
        if head == "blocks":
            rest = parts[2:]
            if rest[0] == "downsample":
                rest = ["downsample_layer", {"norm": 0, "conv": 1}[rest[1]]]
            return [f"conv_block{parts[1] + 1}"] + rest
    return [_DEFORM.get(p, p) for p in parts]


def _layout(leaf: str, v: np.ndarray) -> np.ndarray:
    if leaf != "w":
        return v
    if v.ndim == 4:
        return np.ascontiguousarray(np.transpose(v, (3, 2, 0, 1)))
    if v.ndim == 3:
        return np.ascontiguousarray(np.transpose(v, (2, 1, 0)))
    return np.ascontiguousarray(v.T)


def pann_state_dict_from_params(params: Params, cfg: Union[str, PannConfig]
                                ) -> Dict[str, np.ndarray]:
    """The JAX package's PANN parameters (arrays of any kind) -> the port's
    reference-keyed numpy state dict."""
    cfg = PANN_REGISTRY[cfg] if isinstance(cfg, str) else cfg
    out: Dict[str, np.ndarray] = {}
    for path, value in _leaves(params):
        *module, leaf = path
        key = ".".join(str(p) for p in _module_path(cfg, list(module)) + [_LEAF[leaf]])
        out[key] = _layout(leaf, np.asarray(value))
    return out
