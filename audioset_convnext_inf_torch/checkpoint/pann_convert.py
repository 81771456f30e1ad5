"""Checkpoints of the PANN zoo: reference state dicts in, JAX parameters across.

The zoo's modules (``models/pann.py``) hold their parameters under the
reference's state-dict names, so a reference checkpoint (the published
``Cnn14_mAP=0.431.pth`` and the rest) loads with ``load_pann_state_dict``,
which drops what the port computes itself (the frontend's extractor and
SpecAugment entries, BN's ``num_batches_tracked``) and, for ``cnn_next``,
renames the reference's uneven block labels (``conv_block11``,
``conv_block12``, ``conv_block21``, ...) to ``conv_block1..n`` in their
sorted order, as the JAX package's converter ranks them.

``pann_state_dict_to_params`` is the port's copy of the JAX package's
``checkpoint/pann_convert.py:175``: a reference-keyed state dict to the JAX
package's parameter pytree (nested dicts and lists of numpy arrays), which
``checkpoint/io.py::save_checkpoint`` writes for a PANN model so that the
JAX package's ``load_checkpoint`` reads it; ``bn_path`` names a BatchNorm
module by its dotted path in that pytree, the key of a training forward's
``bn_updates``. ``pann_state_dict_from_params`` is its inverse, undoing the
layouts:

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


# ---------------------------------------------------------------------------
# Reference state dict -> the JAX package's pytree (its pann_convert.py:175)
# ---------------------------------------------------------------------------

_BN_MAP = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
_DEFORM_MAP = {v: k for k, v in _DEFORM.items()}


def _transform(key: str, v: np.ndarray, is_bn: bool) -> Tuple[str, np.ndarray]:
    """A reference leaf (suffix, array) -> (the pytree's leaf name, its layout)."""
    leaf = key.rsplit(".", 1)[-1]
    if is_bn:
        return _BN_MAP[leaf], v
    if leaf == "weight":
        if v.ndim == 4:
            return "w", np.transpose(v, (2, 3, 1, 0))
        if v.ndim == 3:
            return "w", np.transpose(v, (2, 1, 0))
        if v.ndim == 2:
            return "w", np.ascontiguousarray(v.T)
        return "w", v
    if leaf == "bias":
        return "b", v
    return leaf, v


def _set(tree: Params, path: List, leaf: str, value: np.ndarray) -> None:
    """tree[path...][leaf] = value, making dicts, and lists where the next
    key is an index."""
    node = tree
    for i, p in enumerate(path):
        next_is_int = i + 1 < len(path) and isinstance(path[i + 1], int)
        if isinstance(p, int):
            while len(node) <= p:
                node.append([] if next_is_int else {})
            node = node[p]
        else:
            node = node.setdefault(p, [] if next_is_int else {})
    node[leaf] = np.asarray(value)


def _resnet_path(parts: List[str]) -> List:
    """resnet.layerL.B.xxx -> resnet.stages.(L-1).B.xxx; the downsample
    Sequential is [conv, bn] at stage 0 and [pool, conv, bn] after it."""
    stage = int(re.match(r"layer(\d+)$", parts[1]).group(1)) - 1
    block = int(parts[2])
    rest = parts[3:]
    if rest and rest[0] == "downsample":
        idx = int(rest[1])
        name = {0: "conv", 1: "bn"}[idx] if stage == 0 else {1: "conv", 2: "bn"}[idx]
        return ["resnet", "stages", stage, block, "downsample", name]
    return ["resnet", "stages", stage, block] + rest


def _rewrite_path(cfg: PannConfig, key: str, block_rank=None) -> List:
    """A reference key's module path -> the pytree path (str and int parts);
    the inverse of ``_module_path``."""
    parts = key.split(".")[:-1]
    fam = cfg.family
    if fam in ("leenet", "dainet"):
        m = re.match(r"conv_block(\d+)$", parts[0])
        return ["blocks", int(m.group(1)) - 1] + parts[1:] if m else parts
    if fam in ("res1dnet", "resnet"):
        return _resnet_path(parts) if parts[0] == "resnet" else parts
    if fam == "mobilenet_v1" and parts[0] == "features":
        fi, li = int(parts[1]), int(parts[2])
        if fi == 0:
            return ["conv_bn", {0: "conv", 2: "bn"}[li]]
        return ["blocks", fi - 1, {0: "dw", 2: "bn1", 4: "pw", 5: "bn2"}[li]]
    if fam == "mobilenet_v2" and parts[0] == "features":
        fi = int(parts[1])
        meta = mbv2_block_meta()
        if fi == 0:
            return ["conv_bn", {0: "conv", 2: "bn"}[int(parts[2])]]
        if fi == len(meta) + 1:  # the trailing 1x1 conv and BN
            return [{0: "conv_1x1", 1: "bn_1x1"}[int(parts[-1])]]
        li = int(parts[3])
        if meta[fi - 1][0] == 1:  # expand ratio 1: [dw, pool, bn, relu6, pw, bn]
            name = {0: "dw", 2: "bn_dw", 4: "project", 5: "bn_project"}[li]
        else:
            name = {0: "expand", 1: "bn_expand", 3: "dw", 5: "bn_dw", 7: "project",
                    8: "bn_project"}[li]
        return ["blocks", fi - 1, name]
    if fam == "cnn_next":
        if parts[0] == "stem":
            return ["stem", {"0": "conv", "1": "norm"}[parts[1]]]
        m = re.match(r"conv_block(\d+)$", parts[0])
        if m:
            rest = parts[1:]
            if rest and rest[0] == "downsample_layer":
                rest = ["downsample", {"0": "norm", "1": "conv"}[rest[1]]]
            # the reference's uneven labels (conv_block11, 12, 21, ...) sort
            # in forward order
            label = int(m.group(1))
            return ["blocks", block_rank[label] if block_rank else label - 1] + rest
        return parts
    # cnn / sed / wavegram: one to one, but for the deformable conv's names
    return [_DEFORM_MAP.get(p, p) for p in parts]


def bn_path(cfg: PannConfig, module_name: str) -> str:
    """The dotted pytree path of the BatchNorm module ``module_name`` (a
    key of the training forward's ``bn_updates``)."""
    return ".".join(str(p) for p in _rewrite_path(cfg, module_name + ".weight"))


def pann_state_dict_to_params(state_dict: Dict[str, Any], cfg: Union[str, PannConfig]) -> Params:
    """A reference-keyed state dict (tensors or arrays) -> the JAX
    package's PANN parameter pytree, in numpy."""
    cfg = PANN_REGISTRY[cfg] if isinstance(cfg, str) else cfg
    bn_prefixes = {k[: -len(".running_mean")] for k in state_dict if k.endswith(".running_mean")}
    block_rank = None
    if cfg.family == "cnn_next":
        labels = sorted({int(m.group(1)) for k in state_dict
                         if (m := re.match(r"conv_block(\d+)\.", k))})
        block_rank = {lbl: i for i, lbl in enumerate(labels)}
    params: Params = {}
    for key, raw in state_dict.items():
        if any(s in key for s in SKIP):
            continue
        v = raw.detach().cpu().numpy() if isinstance(raw, torch.Tensor) else np.asarray(raw)
        is_bn = key.rsplit(".", 1)[0] in bn_prefixes
        leaf, value = _transform(key, v, is_bn)
        path = _rewrite_path(cfg, key, block_rank)
        # cnn_next's LayerNorms take scale/bias leaves
        if cfg.family == "cnn_next" and path and path[-1] == "norm" and not is_bn:
            leaf = _BN_MAP[key.rsplit(".", 1)[-1]]
        _set(params, [int(p) if isinstance(p, str) and p.isdigit() else p for p in path],
             leaf, value)
    return params
