"""Reference state dicts and the JAX package's parameter pytree.

The port's modules hold the reference's key names, so a reference state
dict loads into them as it is; what this module adds is the checking and
the carry to and from the JAX package's pytree layout, in numpy only:

 - ``load_reference_state_dict``: the counterpart of the JAX package's
   ``checkpoint/convert.py::torch_state_dict_to_params``. It validates a
   reference state dict (the mel matrix, missing and leftover keys, shapes)
   and returns exactly the keys the port's model holds;
 - ``load_imagenet_backbone``: the non-strict ImageNet backbone copy;
 - ``state_dict_from_jax_params``: the port's own copy of the JAX package's
   ``jax_params_to_torch_state_dict`` (pytree -> reference keys), and
   ``jax_params_from_state_dict``, its inverse, with which the port writes
   native checkpoints that the JAX package reads.

The key map:

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

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from audioset_convnext_inf_torch.config import ConvNeXtConfig
from audioset_convnext_inf_torch.ops.frontend import mel_filterbank

Params = Dict[str, Any]

# Frontend constants of the reference model (STFT bases, the mel matrix,
# SpecAugment and speed-perturbation state): the port's frontend computes
# them, so a checkpoint's copies are dropped (the mel matrix is checked first).
_SKIPPED_PREFIXES = (
    "spectrogram_extractor.",
    "logmel_extractor.",
    "spec_augmenter.",
    "speed_perturb.",
)


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
    out = {}
    for k, v in state_dict.items():
        a = np.ascontiguousarray(v)
        # arrays unpickled from a native checkpoint are read-only
        out[k] = torch.from_numpy(a if a.flags.writeable else a.copy())
    return out


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def reference_shapes(cfg: ConvNeXtConfig) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of every tensor the port's model holds for ``cfg``, in
    its state-dict order."""
    dims, m = cfg.dims, cfg.frontend.n_mels
    (kh, kw), _, _ = cfg.stem_geometry()
    for k in ("weight", "bias", "running_mean", "running_var"):
        yield f"bn0.{k}", (m,)
    yield "downsample_layers.0.0.weight", (dims[0], cfg.in_chans, kh, kw)
    yield "downsample_layers.0.0.bias", (dims[0],)
    yield "downsample_layers.0.1.weight", (dims[0],)
    yield "downsample_layers.0.1.bias", (dims[0],)
    for i in range(1, 4):
        yield f"downsample_layers.{i}.0.weight", (dims[i - 1],)
        yield f"downsample_layers.{i}.0.bias", (dims[i - 1],)
        yield f"downsample_layers.{i}.1.weight", (dims[i], dims[i - 1], 2, 2)
        yield f"downsample_layers.{i}.1.bias", (dims[i],)
    for i, depth in enumerate(cfg.depths):
        d = dims[i]
        for j in range(depth):
            p = f"stages.{i}.{j}"
            yield f"{p}.dwconv.weight", (d, 1, 7, 7)
            yield f"{p}.dwconv.bias", (d,)
            yield f"{p}.norm.weight", (d,)
            yield f"{p}.norm.bias", (d,)
            yield f"{p}.pwconv1.weight", (4 * d, d)
            yield f"{p}.pwconv1.bias", (4 * d,)
            yield f"{p}.pwconv2.weight", (d, 4 * d)
            yield f"{p}.pwconv2.bias", (d,)
            if cfg.layer_scale_init_value > 0:
                yield f"{p}.gamma", (d,)
    yield "norm.weight", (dims[-1],)
    yield "norm.bias", (dims[-1],)
    yield "head_audioset.weight", (cfg.num_classes, dims[-1])
    yield "head_audioset.bias", (cfg.num_classes,)


def load_reference_state_dict(state_dict: Dict[str, Any], cfg: ConvNeXtConfig,
                              strict: bool = True) -> Dict[str, np.ndarray]:
    """Validate a reference-model state dict for ``cfg``; returns exactly the
    keys the port's model holds, as numpy arrays.

    The JAX package's ``torch_state_dict_to_params`` rules: values may be
    tensors or numpy arrays; ``num_batches_tracked`` is dropped;
    ``logmel_extractor.melW`` must match the config's mel filterbank; a
    missing key raises ``KeyError``; with ``strict``, a key that is neither
    used nor a frontend constant raises ``ValueError``; shapes must match.
    ``gamma`` is optional: a block saved without layer scale gets ones,
    which multiply its branch exactly as no layer scale does.
    """
    sd = {k: _to_numpy(v) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    if "logmel_extractor.melW" in sd:
        _validate_mel_weights(sd["logmel_extractor.melW"], cfg)
    out: Dict[str, np.ndarray] = {}
    for key, shape in reference_shapes(cfg):
        if key in sd:
            out[key] = sd[key]
        elif key.endswith(".gamma"):
            out[key] = np.ones(shape, np.float32)
        else:
            raise KeyError(f"checkpoint is missing expected key {key!r}")
    if strict:
        leftover = [k for k in sd if k not in out and not k.startswith(_SKIPPED_PREFIXES)]
        if leftover:
            raise ValueError(f"unconsumed checkpoint keys: {sorted(leftover)[:10]} ...")
    for key, shape in reference_shapes(cfg):
        if tuple(out[key].shape) != shape:
            raise ValueError(f"shape mismatch at {key}: got {tuple(out[key].shape)}, want {shape}")
    return out


def _validate_mel_weights(melW: np.ndarray, cfg: ConvNeXtConfig) -> None:
    """The checkpoint's mel matrix against the port's own filterbank.

    torchlibrosa stores melW as (n_fft//2+1, n_mels). A checkpoint trained
    with other sr/n_fft/n_mels/fmin/fmax than ``cfg.frontend`` must not load
    silently: the trunk would see differently scaled log-mel features.
    """
    f = cfg.frontend
    ours = mel_filterbank(f.sample_rate, f.n_fft, f.n_mels, f.fmin, f.fmax).T
    if melW.shape != ours.shape:
        raise ValueError(
            f"checkpoint logmel_extractor.melW has shape {melW.shape}, but the "
            f"config's frontend ({f.n_fft=}, {f.n_mels=}) implies {ours.shape}; "
            "the checkpoint was trained with different STFT/mel parameters"
        )
    err = float(np.abs(melW.astype(np.float64) - ours.astype(np.float64)).max())
    if err > 1e-4:
        raise ValueError(
            f"checkpoint logmel_extractor.melW deviates from the analytic mel "
            f"filterbank for this config (max abs diff {err:.3e}); sr/fmin/fmax/"
            "n_mels of the checkpoint do not match cfg.frontend"
        )


# The parts an ImageNet ConvNeXt shares with the audio one: the three
# downsamples, the stage blocks and the final norm. The stem (3-channel 4x4
# there), bn0 and the head keep their audio values.
_BACKBONE_PREFIXES = ("downsample_layers.1.", "downsample_layers.2.", "downsample_layers.3.",
                      "stages.", "norm.")


def load_imagenet_backbone(state_dict: Dict[str, Any], cfg: ConvNeXtConfig,
                           init: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Non-strict ImageNet ConvNeXt init (reference convnext.py:663-672).

    The counterpart of the JAX package's ``load_imagenet_backbone``: start
    from ``init`` (the fresh audio model's state dict) and copy every
    backbone tensor of ``state_dict`` (bare or ``{"model": ...}``) whose
    shape matches; everything else is skipped silently, as the reference's
    ``strict=False``. ``cfg`` is accepted for the JAX function's signature.
    """
    if "model" in state_dict and isinstance(state_dict["model"], dict):
        state_dict = state_dict["model"]
    out = {k: _to_numpy(v).copy() for k, v in init.items()}
    for key, cur in out.items():
        src = state_dict.get(key)
        if key.startswith(_BACKBONE_PREFIXES) and src is not None:
            src = _to_numpy(src)
            if src.shape == cur.shape:
                out[key] = src.astype(cur.dtype)
    return out


def jax_params_from_state_dict(state_dict: Dict[str, Any]) -> Params:
    """Reference-keyed state dict -> the JAX package's parameter pytree
    layout, in numpy (the inverse of ``state_dict_from_jax_params``)."""
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}

    def conv(prefix: str):  # OIHW -> HWIO
        return {"w": np.ascontiguousarray(np.transpose(sd[prefix + ".weight"], (2, 3, 1, 0))),
                "b": sd[prefix + ".bias"]}

    def ln(prefix: str):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    def lin(prefix: str):  # (out, in) -> (in, out)
        return {"w": np.ascontiguousarray(sd[prefix + ".weight"].T), "b": sd[prefix + ".bias"]}

    stages = []
    i = 0
    while f"stages.{i}.0.dwconv.weight" in sd:
        blocks, j = [], 0
        while f"stages.{i}.{j}.dwconv.weight" in sd:
            p = f"stages.{i}.{j}"
            blk = {"dwconv": conv(f"{p}.dwconv"), "norm": ln(f"{p}.norm"),
                   "pwconv1": lin(f"{p}.pwconv1"), "pwconv2": lin(f"{p}.pwconv2")}
            if f"{p}.gamma" in sd:
                blk["gamma"] = sd[f"{p}.gamma"]
            blocks.append(blk)
            j += 1
        stages.append(blocks)
        i += 1
    return {
        "bn0": {"scale": sd["bn0.weight"], "bias": sd["bn0.bias"],
                "mean": sd["bn0.running_mean"], "var": sd["bn0.running_var"]},
        "stem": {"conv": conv("downsample_layers.0.0"), "norm": ln("downsample_layers.0.1")},
        "downsample": [{"norm": ln(f"downsample_layers.{i}.0"),
                        "conv": conv(f"downsample_layers.{i}.1")} for i in range(1, 4)],
        "stages": stages,
        "final_norm": ln("norm"),
        "head": lin("head_audioset"),
    }
