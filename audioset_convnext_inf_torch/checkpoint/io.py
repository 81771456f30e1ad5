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
   JAX package checkpointed resumes in the port; :func:`optimizer_state_to_optax`
   is its inverse, and :func:`save_checkpoint` writes the optimizer state
   that way, so the JAX trainer resumes a run the port checkpointed. The
   pickle names optax's classes by optax's public top-level names
   (``optax.ScaleByAdamState``, ...), which the unpickler resolves wherever
   a version of optax keeps them, and writing imports no optax.
"""

from __future__ import annotations

import builtins
import collections
import json
import os
import pickle
import re
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


class _OptaxPickler(pickle._Pickler):
    """The pure-Python pickler, which writes the optax stand-ins' classes
    under optax's names; every other global as pickle does. Use it with
    protocol 4: at 5, Python 3.12.3's pure-Python pickler memoizes the
    ``tobytes()`` of each numpy in-band buffer, and two equal zero- or
    one-byte results are one cached object, which fails its memo check
    (later 3.12 releases check first)."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "_optax_module", None)
        if module is None:
            return super().save_global(obj, name)
        self.save(module)
        self.save(obj.__name__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


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
    ``load_checkpoint`` reads and its ``Trainer.restore`` resumes: the
    parameters in its pytree layout, and ``opt_state``, the port's
    ``Optimizer.state_dict()``, as the optax state of its structure
    (:func:`optimizer_state_to_optax`). Returns the directory."""
    os.makedirs(directory, exist_ok=True)
    state = {
        "params": jax_params_from_state_dict(state_dict),
        "opt_state": None if opt_state is None else optimizer_state_to_optax(opt_state),
        "bn_stats": None,
        "sampler_state": sampler_state,
        "iteration": iteration,
        "extra": extra or {},
    }
    tmp = os.path.join(directory, "state.pkl.tmp")
    with open(tmp, "wb") as f:
        _OptaxPickler(f, protocol=4).dump(state)
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


def _optax_class(name: str, fields: str, module: str = "optax"):
    """A stand-in for an optax state class: a namedtuple of optax's fields
    that pickles under ``module.name``."""
    cls = collections.namedtuple(name, fields)
    cls._optax_module = module
    return cls


# optax's fields, in its order (tests/test_torch_checkpoint.py holds them
# against the installed optax). inject_hyperparams builds the stateful
# state since optax 0.2; its schedule state has no top-level name.
_ScaleByAdamState = _optax_class("ScaleByAdamState", "count mu nu")
_ScaleByScheduleState = _optax_class("ScaleByScheduleState", "count")
_MaskedState = _optax_class("MaskedState", "inner_state")
_EmptyState = _optax_class("EmptyState", "")
_MultiStepsState = _optax_class("MultiStepsState",
                                "mini_step gradient_step inner_opt_state acc_grads skip_state")
_InjectState = _optax_class("InjectStatefulHyperparamsState",
                            "count hyperparams hyperparams_states inner_state")
_WrappedScheduleState = _optax_class("WrappedScheduleState", "count", "optax.schedules._inject")
_KINDS = ("optax.adamw", "optax.adam", "optax.inject_hyperparams(adamw)")


def _moment_tree(moments: Dict[str, Any]):
    """Reference-keyed moments as the JAX parameter tree, with the zero
    moments of bn0's running statistics that the JAX trainer's state holds."""
    sd = {k: _to_numpy(v) for k, v in moments.items()}
    zeros = np.zeros_like(sd["bn0.weight"])
    return jax_params_from_state_dict(dict(sd, **{k: zeros for k in _BN0_STATS}))


def optimizer_state_to_optax(state: Dict[str, Any]):
    """The port's ``Optimizer.state_dict()`` as the optax state that the JAX
    package's ``make_optimizer`` builds for its ``structure``: the inverse
    of :func:`optimizer_state_from_optax`, for the same structures. The
    state tuples are stand-ins that pickle under optax's names; arrays are
    numpy."""
    structure = state.get("structure")
    multi = re.fullmatch(r"optax\.MultiSteps\((.*)\)", structure or "")
    kind = multi.group(1) if multi else structure
    if kind not in _KINDS:
        raise ValueError(f"no optax layout for the optimizer structure {structure!r}; "
                         f"known: {list(_KINDS)} and optax.MultiSteps around each")
    count = np.asarray(state["count"], np.int32)
    adam = _ScaleByAdamState(count, _moment_tree(state["mu"]), _moment_tree(state["nu"]))
    if kind == "optax.adamw":
        node = (adam, _MaskedState(_EmptyState()), _ScaleByScheduleState(count))
    elif kind == "optax.adam":
        node = (adam, _ScaleByScheduleState(count))
    else:
        hp = {k: np.asarray(v, np.float32) for k, v in state["hyperparams"].items()}
        node = _InjectState(count, dict(hp, eps_root=np.asarray(0.0, np.float32)),
                            {k: _WrappedScheduleState(count) for k in hp},
                            (adam, _MaskedState(_EmptyState()), _EmptyState()))
    if multi:
        node = _MultiStepsState(np.asarray(state["mini_step"], np.int32), count, node,
                                _moment_tree(state["acc"]), ())
    return node


def optimizer_state_from_optax(opt_state) -> Dict[str, Any]:
    """The JAX trainer's optax state (``engine/trainer.py::make_optimizer``),
    as ``load_checkpoint`` reads it, as the port's ``Optimizer.state_dict()``:
    ``{"count", "mini_step", "mu", "nu", "acc", "structure", "hyperparams"}``,
    numpy arrays under reference keys; ``hyperparams`` holds the learning
    rate and weight decay of the last update for inject_hyperparams, else
    None.

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
    hyperparams = None
    if inject:
        counts["inject_hyperparams count"] = node[0]
        hyperparams = {k: np.asarray(node[1][k], np.float32)
                       for k in ("learning_rate", "weight_decay")}
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
        "hyperparams": hyperparams,
    }
