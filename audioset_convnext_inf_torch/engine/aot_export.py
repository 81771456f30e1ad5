"""Ahead-of-time serving export: ``torch.export`` programs in a bundle.

The port's counterpart of the JAX package's ``engine/aot_export.py``. Each
serving program (frontend with the bn0 fold, ConvNeXt trunk with the fused
block kernel as the custom op ``audioset_convnext_inf_torch::fused_block``,
head) is traced once by ``torch.export`` with the weights inside and saved
with ``torch.export.save``. A server loads the bundle and calls it with no
model code: ``load_bundle`` imports torch, numpy, ``config``, ``device``
and the kernel op's registration (``ops/fused_block.py``), never
``models/`` or ``checkpoint/``.

Programs are per (kind, batch): a bundle holds one fixed-shape program per
batch bucket (and, on request, one whose batch is symbolic), and the loader
pads each call up to the smallest bucket that fits.

What a program does not carry, the bundle does:
 - The device. Branches on the device (the CPU or CUDA route of a product,
   ``ops/precision.py``) are settled while tracing, so a bundle serves only
   on the device type it was exported on; ``load_bundle`` refuses another.
 - The f32 precision. TF32 is process state that the graph does not
   record, and cuDNN's switch is on by default; every program runs under
   ``fp32_precision(FP32_PRECISION)`` ("highest": true f32), which is what
   the live serving configs set around each f32 op.
 - The kernel. On the card, a bundle whose programs call K1 holds a copy of
   the K1 library they were exported with; ``load_bundle`` runs the op from
   it where the package's own build differs (``ops/_build.py::use_library``),
   and a missing or broken copy raises.

Layout of a bundle directory::

    manifest.json                  # shapes, dtypes, device, precision, entries
    forward_b1.pt2                 # torch.export.save, one per (kind, batch)
    forward_b16.pt2
    params.npz                     # weights="shared" only
    libfused_block_<hash>.so       # on the card, when a program calls K1
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from audioset_convnext_inf_torch.config import CLIP_SAMPLES, INT16_SCALE
from audioset_convnext_inf_torch.device import resolve_device
from audioset_convnext_inf_torch.ops import _build
from audioset_convnext_inf_torch.ops import fused_block as _k1  # registers the K1 op
from audioset_convnext_inf_torch.ops.precision import fp32_precision

FORMAT = "audioset_convnext_inf_torch.aot_bundle.v1"
KINDS = ("forward", "scene", "frame")
FP32_PRECISION = "highest"
_MANIFEST = "manifest.json"
_K1_OP = getattr(torch.ops, _k1.OPS).fused_block.default

Batch = Union[int, str]  # a bucket, or "dynamic"


class _Serving(nn.Module):
    """One serving program: waveform (B, N) f32, or int16 PCM decoded on
    the device (``pcm``), -> the outputs of ``kind``. The model is a
    submodule, so its weights are the program's."""

    def __init__(self, model: nn.Module, kind: str, pcm: bool):
        super().__init__()
        from audioset_convnext_inf_torch.models import convnext as F
        from audioset_convnext_inf_torch.ops.pcm import decode_pcm_if_int16

        fns = {"forward": F.forward, "scene": F.forward_scene_embeddings,
               "frame": F.forward_frame_embeddings}
        if kind not in fns:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        if model.training:
            raise ValueError("export a model in eval mode")
        self.model, self.pcm = model, pcm
        self._fn, self._decode = fns[kind], decode_pcm_if_int16

    def forward(self, waveform: torch.Tensor):
        m = self.model
        return self._fn(m, self._decode(waveform), m.cfg, m.frontend, m.compute_dtype)


class _SharedServing(nn.Module):
    """``_Serving`` whose weights come in as ``params`` (the state dict's
    keys): the serving module is held outside the module tree, so the
    program owns no weights, only the frontend's constants."""

    def __init__(self, model: nn.Module, kind: str, pcm: bool):
        super().__init__()
        self.__dict__["serving"] = _Serving(model, kind, pcm)

    def forward(self, params: Dict[str, torch.Tensor], waveform: torch.Tensor):
        named = {f"model.{k}": v for k, v in params.items()}
        return torch.func.functional_call(self.serving, named, (waveform,))


def params_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The weights a shared-weights program takes: the state dict (the
    reference keys, bn0's running statistics included), f32, detached."""
    return {k: v.detach().float() for k, v in model.state_dict().items()}


def _example(model: nn.Module, batch_size: Batch, pcm: bool, num_samples: int):
    """(example waveform, its dynamic-shape spec). ``torch.export``
    specialises batch sizes 0 and 1, so a dynamic program is traced at 2;
    it serves any batch from 1 up."""
    dynamic = batch_size == "dynamic"
    b = 2 if dynamic else int(batch_size)
    wav = torch.zeros(b, num_samples, dtype=torch.int16 if pcm else torch.float32,
                      device=model.device)
    return wav, ({0: torch.export.Dim("batch", min=1)} if dynamic else None)


def export_serving(
    model: nn.Module,
    batch_size: Batch,
    *,
    kind: str = "forward",
    pcm: bool = False,
    num_samples: int = CLIP_SAMPLES,
) -> torch.export.ExportedProgram:
    """Export one serving program of ``model`` (a ``models.ConvNeXt`` in
    eval mode) with its weights inside.

    ``batch_size`` is an int (a fixed-shape program, the serving default)
    or ``"dynamic"``: one program for any batch. Unlike the JAX package's,
    the dynamic program keeps the fused block kernel, which takes any pixel
    count (ops/fused_block.py), so it is the live forward at every batch.
    ``pcm=True`` exports the int16-PCM entry point (decoded on the device,
    half the bytes in). The program is traced on the model's device and
    serves only on that device type: build or move the model where it will
    serve.
    """
    wav, dyn = _example(model, batch_size, pcm, num_samples)
    with torch.no_grad():
        return torch.export.export(_Serving(model, kind, pcm), (wav,),
                                   dynamic_shapes=None if dyn is None else (dyn,), strict=False)


def export_serving_shared(
    model: nn.Module,
    batch_size: Batch,
    *,
    kind: str = "forward",
    pcm: bool = False,
    num_samples: int = CLIP_SAMPLES,
) -> torch.export.ExportedProgram:
    """Like :func:`export_serving`, but the program takes ``(params,
    waveform)`` with ``params`` as :func:`params_of` gives them, so a bundle
    of many buckets stores the weights once (params.npz)."""
    wav, dyn = _example(model, batch_size, pcm, num_samples)
    params = params_of(model)
    with torch.no_grad():
        return torch.export.export(
            _SharedServing(model, kind, pcm), (params, wav),
            dynamic_shapes=None if dyn is None else ({k: None for k in params}, dyn),
            strict=False)


def calls_k1(program) -> int:
    """How many fused block (K1) nodes the graph of ``program`` (an
    ExportedProgram, or a loaded bundle's module) holds."""
    return sum(node.target is _K1_OP for node in program.graph.nodes)


def save_bundle(
    model: nn.Module,
    path: str,
    *,
    batch_sizes: Sequence[Batch] = (1, 16, 32, 128),
    kinds: Sequence[str] = ("forward",),
    pcm: bool = False,
    num_samples: int = CLIP_SAMPLES,
    weights: str = "baked",
) -> Dict[str, Any]:
    """Export a serving bundle (one program per (kind, batch)) to ``path``
    and return its manifest.

    ``weights``: "baked" (default) puts the weights in every program;
    "shared" stores them once in params.npz, beside small parameterised
    programs (the choice for many buckets or kinds).
    """
    if weights not in ("baked", "shared"):
        raise ValueError(f"weights must be 'baked' or 'shared', got {weights!r}")
    dev = torch.device(model.device)
    os.makedirs(path, exist_ok=True)
    dynamic = "dynamic" in batch_sizes
    fixed = sorted(set(int(b) for b in batch_sizes if b != "dynamic"))
    export_one = export_serving if weights == "baked" else export_serving_shared
    entries, k1_nodes = {}, 0
    for kind in kinds:
        for b in fixed + (["dynamic"] if dynamic else []):
            program = export_one(model, b, kind=kind, pcm=pcm, num_samples=num_samples)
            k1_nodes += calls_k1(program)
            program.example_inputs = None  # a (B, N) waveform, and the weights when shared
            fname = f"{kind}_b{b}.pt2"
            torch.export.save(program, os.path.join(path, fname))
            entries[f"{kind}:{b}"] = fname
    if weights == "shared":
        np.savez(os.path.join(path, "params.npz"),
                 **{k: v.cpu().numpy() for k, v in params_of(model).items()})
    library = None
    if dev.type == "cuda" and k1_nodes:
        src = _build.library("fused_block")
        library = src.name
        shutil.copyfile(src, os.path.join(path, library))
    manifest = {
        "format": FORMAT,
        "model": getattr(model.cfg, "name", "convnext"),
        "input_dtype": "int16" if pcm else "float32",
        "num_samples": int(num_samples),
        "batch_sizes": fixed,
        "dynamic": dynamic,
        "kinds": list(kinds),
        "weights": weights,
        "device": dev.type,
        "compute_dtype": str(model.compute_dtype).replace("torch.", ""),
        "fp32_precision": FP32_PRECISION,
        "kernel_library": library,
        "param_count": int(sum(p.numel() for p in model.parameters())),
        "torch_version": torch.__version__,
        "entries": entries,
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
        f.write("\n")
    return manifest


def _map(fn: Callable, out):
    return {k: fn(v) for k, v in out.items()} if isinstance(out, dict) else fn(out)


class ServingBundle:
    """A loaded bundle: pads each batch to the smallest exported bucket
    that fits, runs the program under the bundle's f32 precision, and
    slices the pad away. Outputs are tensors on the bundle's device."""

    def __init__(self, manifest: Dict[str, Any], programs: Dict[str, Callable],
                 device: torch.device, params: Optional[Dict[str, torch.Tensor]] = None):
        self.manifest = manifest
        self.device = device
        self._programs = programs
        self._params = params  # weights="shared" only
        self._buckets = sorted(manifest["batch_sizes"])
        self._dynamic = bool(manifest.get("dynamic", False))
        self._dtype = torch.int16 if manifest["input_dtype"] == "int16" else torch.float32
        self._num_samples = int(manifest["num_samples"])

    def bucket_for(self, n: int) -> Batch:
        """The smallest fixed bucket that fits ``n``; ``"dynamic"`` when only
        the dynamic program can serve it."""
        for b in self._buckets:
            if b >= n:
                return b
        if self._dynamic:
            return "dynamic"
        raise ValueError(f"batch {n} exceeds the largest exported bucket {self._buckets[-1]}")

    def __call__(self, waveform, kind: str = "forward"):
        wav = torch.as_tensor(waveform)
        if wav.ndim != 2 or wav.shape[1] != self._num_samples:
            raise ValueError(f"expected (B, {self._num_samples}) input, got {tuple(wav.shape)}")
        if wav.dtype != self._dtype:
            raise ValueError(f"bundle expects {self.manifest['input_dtype']} input, "
                             f"got {wav.dtype}")
        n = wav.shape[0]
        b = self.bucket_for(n)
        program = self._programs.get(f"{kind}:{b}")
        if program is None:
            raise ValueError(f"bundle has no {kind!r} programs (kinds: {self.manifest['kinds']})")
        wav = wav.to(self.device)
        if b != "dynamic" and b != n:
            wav = torch.cat([wav, wav.new_zeros(b - n, self._num_samples)])
        with torch.inference_mode(), fp32_precision(self.manifest["fp32_precision"]):
            out = program(wav) if self._params is None else program(self._params, wav)
        return _map(lambda t: t[:n], out)


class BundleModel:
    """A :class:`ServingBundle` behind the live model's serving surface
    (``forward``, ``forward_scene_embeddings``, ``device``), so
    ``engine/service.py`` and ``cli/serve.py`` serve from a bundle with no
    model code. Inputs (numpy arrays or tensors) convert to the bundle's
    wire dtype: float audio is quantised to int16 PCM for a pcm bundle
    (round(x * 32767), clipped: 0.5/32767 per sample at most), and int16
    decodes as x * INT16_SCALE for a float bundle."""

    def __init__(self, bundle: ServingBundle):
        self.bundle = bundle
        self.device = bundle.device

    @property
    def max_batch(self) -> Optional[int]:
        """The largest fixed bucket; None when a dynamic program serves any
        batch."""
        return None if self.bundle._dynamic else self.bundle._buckets[-1]

    def _adapt(self, waveform) -> torch.Tensor:
        wav = torch.as_tensor(waveform)
        if self.bundle._dtype == torch.int16 and wav.dtype != torch.int16:
            wav = torch.clamp(torch.round(wav.double() * 32767.0), -32768, 32767).to(torch.int16)
        elif self.bundle._dtype != torch.int16 and wav.dtype == torch.int16:
            wav = wav.to(torch.float32) * INT16_SCALE
        return wav

    def forward(self, waveform):
        return self.bundle(self._adapt(waveform))

    def forward_scene_embeddings(self, waveform):
        return self.bundle(self._adapt(waveform), kind="scene")


def load_bundle(path: str, device=None) -> ServingBundle:
    """Load a bundle to serve on ``device``: the card unless the caller
    names another (``device="cpu"`` asks for the CPU; with no card and no
    device, this raises). A bundle exported for another device type raises.
    On the card, K1 runs from the package's own build of its library where
    that is the bundle's (the same file name: the same sources and flags),
    else from the bundle's copy (``ops/_build.py::use_library``)."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"not an AOT serving bundle of this package: {path}")
    device = resolve_device(device)
    if device.type != manifest["device"]:
        raise ValueError(f"the bundle at {path} was exported for {manifest['device']}; it does "
                         f"not serve on {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the bundle at {path} serves on the card, and there is none")
    if manifest.get("kernel_library"):
        _build.use_library("fused_block", os.path.join(path, manifest["kernel_library"]))
        _k1._lib()  # a broken library raises here, not at the first request
    programs = {key: torch.export.load(os.path.join(path, fname)).module()
                for key, fname in manifest["entries"].items()}
    params = None
    if manifest.get("weights") == "shared":
        with np.load(os.path.join(path, "params.npz")) as flat:
            params = {k: torch.from_numpy(flat[k]).to(device) for k in flat.files}
    return ServingBundle(manifest, programs, device, params=params)
