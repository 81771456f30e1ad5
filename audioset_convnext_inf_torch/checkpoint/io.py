"""Checkpoint I/O: reference-format files and native checkpoint directories.

The port's counterpart of the JAX package's ``checkpoint/io.py``:

 - :func:`load_pretrained` resolves a local path, an https URL (downloaded
   once into a cache) or a HuggingFace model id, as the reference does
   (convnext.py:404-511), and reads ``.safetensors`` (a flat reference state
   dict), ``.pth`` (a bare state dict or ``{"model": state_dict}``) or a
   native checkpoint directory;
 - :func:`read_safetensors` / :func:`save_safetensors` are the port's own
   numpy reader and writer of the safetensors format, so it needs no
   ``safetensors`` package;
 - :func:`save_checkpoint` / :func:`load_checkpoint` write and read the
   native format: ``state.pkl``, a pickle of numpy arrays in the JAX
   package's parameter layout, plus ``config.json``. Each package reads what
   the other writes. Reading admits only numpy's array types and plain
   builtins; any other class in the pickle (the JAX trainer's optimizer
   state is optax objects) becomes an inert stand-in, so reading imports
   neither optax nor JAX and runs no code a pickle names;
 - :func:`optimizer_state_from_optax` turns the JAX trainer's optax state,
   as read here, into the port's ``Optimizer`` state, so a training run the
   JAX package checkpointed resumes in the port. The port writes its own
   optimizer state (plain numpy under reference keys), which the JAX
   package reads but cannot resume from.
"""

from __future__ import annotations

import builtins
import json
import os
import pickle
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from audioset_convnext_inf_torch.checkpoint.convert import (
    _to_numpy,
    jax_params_from_state_dict,
    load_reference_state_dict,
    state_dict_from_jax_params,
)
from audioset_convnext_inf_torch.config import (
    ConvNeXtConfig,
    config_to_json,
    convnext_config_from_json,
)

# ---------------------------------------------------------------------------
# safetensors: an 8-byte little-endian header length, a JSON header
# {name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
# {str: str}} (offsets relative to the end of the header), then the raw
# little-endian bytes of each tensor, back to back.
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"), "I32": np.dtype("<i4"), "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"), "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a safetensors file as a numpy array."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path!r} is not a safetensors file: {len(raw)} bytes")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path!r}: header of {n} bytes runs past the end of the file")
    header = json.loads(raw[8:8 + n].decode("utf-8"))
    base, size = 8 + n, len(raw) - 8 - n
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        shape = tuple(int(d) for d in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path!r}: tensor {name!r} has unsupported dtype {info['dtype']!r}")
        if not (0 <= begin <= end <= size) or end - begin != count * dtype.itemsize:
            raise ValueError(f"{path!r}: tensor {name!r} has offsets {begin}..{end}, which do not "
                             f"hold {shape} of {info['dtype']} inside {size} data bytes")
        arr = np.frombuffer(raw, dtype, count, base + begin).reshape(shape)
        out[name] = arr.astype(dtype.newbyteorder("="), copy=True)
    return out


def save_safetensors(tensors: Dict[str, Any], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write tensors (numpy arrays or torch tensors), e.g. a reference-keyed
    ``model.state_dict()``, as a safetensors file, the format of the
    reference's published checkpoints: tensors in name order, the header
    padded with spaces to a multiple of 8."""
    arrays = {k: np.require(_to_numpy(v), requirements="C") for k, v in tensors.items()}
    header: Dict[str, Any] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset, blobs = 0, []
    for name in sorted(arrays):
        a = arrays[name]
        dtype = a.dtype.newbyteorder("<") if a.dtype.itemsize > 1 else a.dtype
        if dtype not in _ST_NAMES:
            raise ValueError(f"tensor {name!r}: dtype {a.dtype} has no safetensors name")
        blob = a.astype(dtype, copy=False).tobytes()
        header[name] = {"dtype": _ST_NAMES[dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-(8 + len(head)) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Reference-format loading
# ---------------------------------------------------------------------------


def _load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model" in blob and isinstance(blob["model"], dict):
        blob = blob["model"]
    return {k: _to_numpy(v) for k, v in blob.items()}


def _resolve_checkpoint_path(path_or_id: str) -> str:
    """local path -> itself; https -> a download into the cache; else a
    HuggingFace hub id (reference convnext.py:412-493)."""
    if os.path.exists(path_or_id):
        return path_or_id
    # A HuggingFace id is "namespace/name" (optionally "@revision"): exactly
    # one slash, no checkpoint extension, not an explicit filesystem path.
    # Anything else holding a separator or ending in a checkpoint extension
    # is a missing local path: fail fast rather than asking the hub for it.
    looks_like_hf_id = (
        path_or_id.count("/") == 1
        and not path_or_id.endswith((".pth", ".safetensors"))
        and not path_or_id.startswith((".", "/", "~"))
    )
    if not path_or_id.startswith(("http://", "https://")) and not looks_like_hf_id and (
        os.sep in path_or_id or path_or_id.endswith((".pth", ".safetensors"))
    ):
        raise FileNotFoundError(
            f"checkpoint path {path_or_id!r} does not exist (pass an existing "
            "file/directory, an https URL, or a HuggingFace model id)"
        )
    if path_or_id.startswith(("http://", "https://")):
        import urllib.request

        cache = os.path.join(
            os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
            "audioset_convnext_inf_torch",
            "checkpoints",
        )
        os.makedirs(cache, exist_ok=True)
        dst = os.path.join(cache, os.path.basename(path_or_id).replace("?download=1", ""))
        if not os.path.exists(dst):
            # a temporary name and an atomic rename: an interrupted transfer
            # must not leave a truncated file that every later call trusts
            tmp = dst + ".part"
            urllib.request.urlretrieve(path_or_id, tmp)
            os.replace(tmp, dst)
        return dst
    from huggingface_hub import hf_hub_download

    model_id, _, revision = path_or_id.partition("@")
    return hf_hub_download(model_id, "model.safetensors", repo_type="model",
                           revision=revision or None, library_name="audioset-convnext-torch")


def load_pretrained(path_or_id: str, cfg: ConvNeXtConfig) -> Dict[str, np.ndarray]:
    """A checkpoint as the validated reference-keyed state dict of ``cfg``'s model."""
    path = _resolve_checkpoint_path(path_or_id)
    if os.path.isdir(path):
        sd = state_dict_from_jax_params(load_checkpoint(path)["params"])
    elif path.endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        sd = _load_torch_state_dict(path)
    return load_reference_state_dict(sd, cfg)


# ---------------------------------------------------------------------------
# Native checkpoints
# ---------------------------------------------------------------------------

_SAFE_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset", "int", "list",
    "range", "set", "slice", "str", "tuple",
})
# what numpy arrays, scalars and dtypes pickle through
_NUMPY_NAMES = frozenset({"dtype", "ndarray", "_reconstruct", "scalar", "_frombuffer"})


class _Inert(tuple):
    """What a class of another package unpickles to: its constructor
    arguments as a tuple (and a dict state as attributes); no code of its own."""

    _pickled_as = ""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls, args)


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "builtins":
            if name in _SAFE_BUILTINS:
                return getattr(builtins, name)
            raise pickle.UnpicklingError(f"checkpoint pickle names builtins.{name}")
        if module.split(".")[0] == "numpy" and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        return type(name, (_Inert,), {"_pickled_as": f"{module}.{name}"})


def _host(tree):
    """Tensors in a tree of dicts and lists as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return _to_numpy(tree) if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(
    directory: str,
    state_dict: Dict[str, Any],
    cfg: Optional[ConvNeXtConfig] = None,
    opt_state: Optional[Dict[str, Any]] = None,
    sampler_state: Any = None,
    iteration: Optional[int] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a native checkpoint directory that the JAX package's
    ``load_checkpoint`` reads: the parameters in its pytree layout, and
    ``opt_state``, the port's ``Optimizer.state_dict()`` (count, mini_step,
    and the mu/nu/acc tensors under reference keys), as numpy. Returns the
    directory."""
    os.makedirs(directory, exist_ok=True)
    state = {
        "params": jax_params_from_state_dict(state_dict),
        "opt_state": _host(opt_state),
        "bn_stats": None,
        "sampler_state": sampler_state,
        "iteration": iteration,
        "extra": extra or {},
    }
    tmp = os.path.join(directory, "state.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, os.path.join(directory, "state.pkl"))
    if cfg is not None:
        with open(os.path.join(directory, "config.json"), "w") as f:
            f.write(config_to_json(cfg))
    return directory


def load_checkpoint(directory: str) -> Dict[str, Any]:
    """A native checkpoint directory (written by either package): the
    pickled state with ``params`` as numpy in the JAX pytree layout, and
    ``config`` from ``config.json`` when present."""
    with open(os.path.join(directory, "state.pkl"), "rb") as f:
        state = _CheckpointUnpickler(f).load()
    cfg_path = os.path.join(directory, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            state["config"] = convnext_config_from_json(f.read())
    return state


# ---------------------------------------------------------------------------
# The JAX trainer's optax state -> the port's Optimizer state
# ---------------------------------------------------------------------------

# optax moved classes between modules across versions; they are matched by
# class name. inject_hyperparams' state was renamed in optax 0.2.
_INJECT_STATES = ("InjectHyperparamsState", "InjectStatefulHyperparamsState")
# The port keeps bn0's running statistics as buffers, not parameters; in the
# JAX package they are parameters that the loss never reaches.
_BN0_STATS = ("bn0.running_mean", "bn0.running_var")


def _class_name(node) -> str:
    """The class an optax state node was pickled as ('' for plain containers)."""
    if isinstance(node, _Inert):
        return type(node)._pickled_as.rsplit(".", 1)[-1]
    return type(node).__name__ if hasattr(node, "_fields") else ""


def _structure(node) -> str:
    """The nesting of state classes, for error messages: 'A(B, (C, D))'."""
    if isinstance(node, tuple):
        inner = ", ".join(_structure(x) for x in node if isinstance(x, tuple))
        name = _class_name(node)
        return f"{name}({inner})" if name else f"({inner})"
    return ""


def _moments(tree, what: str) -> Dict[str, np.ndarray]:
    """A JAX-layout parameter tree of moments as a reference-keyed dict of
    the port's parameters; bn0's running statistics must have none."""
    sd = state_dict_from_jax_params(tree)
    for key in _BN0_STATS:
        v = sd.pop(key)
        if np.any(v != 0):
            raise ValueError(f"the optax state's {what} of {key} is not zero (max |.| "
                             f"{float(np.abs(v).max()):.3e}): it was not written by the "
                             "JAX package's trainer")
    return sd


def optimizer_state_from_optax(opt_state) -> Dict[str, Any]:
    """The JAX trainer's optax state (``engine/trainer.py::make_optimizer``),
    as ``load_checkpoint`` reads it, as the port's ``Optimizer.state_dict()``:
    ``{"count", "mini_step", "mu", "nu", "acc", "structure"}``, numpy arrays
    under reference keys.

    Accepted structures: ``optax.adamw`` (ScaleByAdamState, the masked
    weight-decay state, ScaleByScheduleState), ``optax.adam``,
    ``optax.inject_hyperparams(adamw)`` (the weight-decay schedule), and
    ``optax.MultiSteps`` around any of them (gradient accumulation). The
    counts of the parts must agree. ``structure`` names what was found, as
    ``Trainer.restore`` checks it against its own configuration. Anything
    else raises ``ValueError`` naming the classes found."""
    found = _structure(opt_state) or type(opt_state).__name__

    def refuse(why: str):
        raise ValueError(f"not an optimizer state of the JAX package's trainer ({why}); "
                         f"found {found}")

    node, mini_step, acc, wrap = opt_state, 0, None, "{}"
    counts = {}
    if _class_name(node) == "MultiStepsState":
        if len(node) < 4:
            refuse("MultiStepsState with fewer than 4 fields")
        mini_step, counts["MultiSteps gradient_step"] = int(np.asarray(node[0])), node[1]
        node, acc, wrap = node[2], node[3], "optax.MultiSteps({})"
    inject = _class_name(node) in _INJECT_STATES
    if inject:
        counts["inject_hyperparams count"] = node[0]
        node = node[-1]
    if not (type(node) is tuple and node and _class_name(node[0]) == "ScaleByAdamState"):
        refuse("no ScaleByAdamState at the head of the optimizer chain")
    tail = [_class_name(x) for x in node[1:]]
    if tail[:1] == ["MaskedState"] and [_class_name(x) for x in node[1]] != ["EmptyState"]:
        refuse("the weight-decay mask holds a state")
    if inject and tail == ["MaskedState", "EmptyState"]:
        kind = "optax.inject_hyperparams(adamw)"
    elif not inject and tail == ["MaskedState", "ScaleByScheduleState"]:
        kind = "optax.adamw"
    elif not inject and tail == ["ScaleByScheduleState"]:
        kind = "optax.adam"
    else:
        refuse(f"chain {['ScaleByAdamState'] + tail}")
    if not inject:
        counts["ScaleByScheduleState count"] = node[-1][0]
    adam = node[0]
    count = int(np.asarray(adam[0]))
    for what, c in counts.items():
        if int(np.asarray(c)) != count:
            refuse(f"{what} {int(np.asarray(c))} != ScaleByAdamState count {count}")
    return {
        "count": count,
        "mini_step": mini_step,
        "mu": _moments(adam[1], "mu"),
        "nu": _moments(adam[2], "nu"),
        "acc": _moments(acc, "accumulated gradient") if acc is not None else None,
        "structure": wrap.format(kind),
    }
