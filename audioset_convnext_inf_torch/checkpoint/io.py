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
   neither optax nor JAX and runs no code a pickle names.
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


def save_checkpoint(
    directory: str,
    state_dict: Dict[str, Any],
    cfg: Optional[ConvNeXtConfig] = None,
    sampler_state: Any = None,
    iteration: Optional[int] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a native checkpoint directory that the JAX package's
    ``load_checkpoint`` reads: the parameters in its pytree layout, no
    optimizer state. Returns the directory."""
    os.makedirs(directory, exist_ok=True)
    state = {
        "params": jax_params_from_state_dict(state_dict),
        "opt_state": None,
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
