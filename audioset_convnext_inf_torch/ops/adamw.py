"""The Adam / AdamW update of every parameter tensor: the CUDA kernel and
its plain version.

``adamw_update_`` updates the parameters and both moments in place with
optax's arithmetic (``optax.adamw`` / ``optax.adam``: b1 0.9, b2 0.999,
eps 1e-8 outside the square root):

    m = (1 - b1) g + b1 m
    v = (1 - b2) g^2 + b2 v
    u = (m / bc1) / (sqrt(v / bc2) + eps)  (+ wd p where the leaf decays)
    p = p + u (-lr)

On CUDA tensors it launches ``csrc/adamw.cu`` (built at first use by
``ops/_build.py``), which updates all leaves in one launch or a few,
rounding where ATen rounds each op of the plain version on the card, so
that both give the same bits; on CPU tensors it runs
``adamw_update_reference``, that plain version, one leaf at a time. The
kernel source says what bounds it on the card and what its design does
about it. ``launch_plan`` cuts the leaves into launches and chunks from
their sizes alone; the kernel refuses a table that does not follow it.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Sequence, Tuple

import torch

from audioset_convnext_inf_torch.ops import _build

B1, B2, EPS = 0.9, 0.999, 1e-8

# The kernel's layout, as csrc/adamw.cu sets it (the card tests check both agree).
CHUNK = 2048  # values a block updates: 256 threads x 2 float4 each
MAX_LEAVES = 96  # leaves a launch's table holds
PARAM_LIMIT = 4096  # bytes of kernel parameters any toolkit takes
MAX_VALUES = 2 ** 31 - 1  # values of one leaf (the table counts them in int32)


def param_bytes(max_leaves: int = MAX_LEAVES) -> int:
    """Bytes of one launch's kernel parameters: the leaf table (p, g, m, v
    pointers, values and first block of each leaf, the grid's size, a flags
    byte each, the leaf count; padded to its pointers' 8 bytes) and the nine
    f32 scalars of the step."""
    table = 4 * 8 * max_leaves + 4 * max_leaves + 4 * (max_leaves + 1) + max_leaves
    table = -(-table // 4) * 4 + 4
    return -(-table // 8) * 8 + 9 * 4


class Launch(NamedTuple):
    first: int                 # the launch's first leaf, an index into the caller's list
    start: Tuple[int, ...]     # each leaf's first block, then the grid's size
    sizes: Tuple[int, ...]     # values of each leaf
    decay: Tuple[bool, ...]    # whether each leaf takes weight decay


def launch_plan(sizes: Sequence[int], decay: Sequence[bool]) -> Tuple[Launch, ...]:
    """The launches that update leaves of ``sizes`` values: as few as hold
    MAX_LEAVES leaves each, the leaves in their order and spread evenly
    over them; a leaf of n values takes ceil(n / CHUNK) blocks, each of
    which updates CHUNK of them (the last one what is left)."""
    sizes, decay = tuple(int(n) for n in sizes), tuple(bool(d) for d in decay)
    if len(sizes) != len(decay):
        raise ValueError(f"adamw: {len(sizes)} leaves but {len(decay)} decay flags")
    for n in sizes:
        if not 0 <= n <= MAX_VALUES:
            raise ValueError(f"adamw: a leaf of {n} values (the kernel takes 0 to {MAX_VALUES})")
    groups = -(-len(sizes) // MAX_LEAVES)
    bounds = [len(sizes) * i // groups for i in range(groups + 1)]
    plan = []
    for lo, hi in zip(bounds, bounds[1:]):
        start = [0]
        for n in sizes[lo:hi]:
            start.append(start[-1] + -(-n // CHUNK))
        plan.append(Launch(lo, tuple(start), sizes[lo:hi], decay[lo:hi]))
    return tuple(plan)


def block_values(launch: Launch, block: int) -> Tuple[int, int, int]:
    """(leaf of the launch, first value, number of values) that block
    ``block`` updates: the kernel's own search, the last leaf whose first
    block is ``block`` or before."""
    lo, hi = 0, len(launch.sizes)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if launch.start[mid] <= block:
            lo = mid
        else:
            hi = mid
    first = (block - launch.start[lo]) * CHUNK
    return lo, first, min(CHUNK, launch.sizes[lo] - first)


@torch.no_grad()
def adamw_update_reference(params, grads, mu, nu, decay, lr: float, wd: float, bc1: float,
                           bc2: float) -> None:
    """The plain version: the update, one leaf at a time, in ATen ops."""
    for p, g, m, v, d in zip(params, grads, mu, nu, decay):
        m.copy_((1 - B1) * g + B1 * m)
        v.copy_((1 - B2) * (g * g) + B2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        if d:
            u = u + wd * p
        p.add_(u * -lr)


def load_library() -> ctypes.CDLL:
    """Build (unless built) and load the kernel's library: what a caller
    does at set-up, so that no update waits for nvcc."""
    lib = _build.load("adamw")
    fn = lib.adamw_update
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_float] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for name in ("adamw_chunk", "adamw_max_leaves"):
            getattr(lib, name).restype = ctypes.c_int
        lib.adamw_param_bytes.restype = ctypes.c_longlong
    return lib


class _Arrays(NamedTuple):
    leaves: slice
    n: ctypes.Array
    start: ctypes.Array
    decay: ctypes.Array


@lru_cache(maxsize=16)
def _plan_arrays(sizes: Tuple[int, ...], decay: Tuple[bool, ...]) -> Tuple[_Arrays, ...]:
    """The plan's tables as the C entry point takes them."""
    return tuple(
        _Arrays(slice(la.first, la.first + len(la.sizes)),
                (ctypes.c_int * len(la.sizes))(*la.sizes), (ctypes.c_int * len(la.start))(*la.start),
                (ctypes.c_ubyte * len(la.decay))(*la.decay))
        for la in launch_plan(sizes, decay))


def _refuse(i: int, t: torch.Tensor, dev: torch.device, n: int):
    if t.device != dev:
        raise ValueError(f"adamw: tensors on {t.device} and {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"adamw: leaf {i} holds a {t.dtype} tensor; the kernel takes float32")
    if not t.is_contiguous():
        raise ValueError(f"adamw: leaf {i} holds a non-contiguous tensor")
    raise ValueError(f"adamw: leaf {i} holds tensors of {n} and {t.numel()} values")


@torch.no_grad()
def adamw_update_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                  mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                  decay: Sequence[bool], lr: float, wd: float, bc1: float, bc2: float) -> int:
    """One update of every leaf, in place: ``params``, ``mu`` and ``nu``
    take the new values; ``decay`` says which leaves take ``wd``; ``bc1``
    and ``bc2`` are the bias corrections 1 - b^t. All tensors lie on one
    device. CUDA tensors (f32, contiguous; anything else raises) launch the
    kernel (``adamw_update_.launches`` counts each launch); CPU tensors run
    the plain version. Returns the number of launches (0 on the CPU)."""
    leaves = len(params)
    if not len(grads) == len(mu) == len(nu) == len(decay) == leaves:
        raise ValueError(f"adamw: {leaves} parameters, {len(grads)} gradients, {len(mu)} and "
                         f"{len(nu)} moments, {len(decay)} decay flags")
    if not leaves:
        return 0
    dev = params[0].device
    if dev.type == "cpu":
        for t in (*params, *grads, *mu, *nu):
            if t.device != dev:
                raise ValueError(f"adamw: tensors on {t.device} and {dev}")
        adamw_update_reference(params, grads, mu, nu, decay, lr, wd, bc1, bc2)
        return 0
    if dev.type != "cuda":
        raise ValueError(f"adamw runs on cuda or cpu tensors, got {dev}")
    ptrs, sizes, f32 = [], [], torch.float32
    for i, leaf in enumerate(zip(params, grads, mu, nu)):
        n = leaf[0].numel()
        for t in leaf:
            if t.device != dev or t.dtype is not f32 or not t.is_contiguous() or t.numel() != n:
                _refuse(i, t, dev, n)
            ptrs.append(t.data_ptr())
        sizes.append(n)
    arrays = _plan_arrays(tuple(sizes), tuple(bool(d) for d in decay))
    lib = load_library()
    # ATen's scalars: the double rounded to f32; a division by a CPU scalar is
    # a product with its reciprocal, taken in double and then rounded
    scalars = (1 - B1, B1, 1 - B2, B2, 1 / bc1, 1 / bc2, EPS, wd, -lr)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for a in arrays:
            sel = ptrs[4 * a.leaves.start:4 * a.leaves.stop]
            err = lib.adamw_update((ctypes.c_ulonglong * len(sel))(*sel), a.n, a.start,
                                   a.decay, len(a.n), *scalars, stream)
            if err != 0:
                raise RuntimeError(f"adamw kernel launch failed: cudaError {err}")
            adamw_update_.launches += 1
    return len(arrays)


adamw_update_.launches = 0  # every launch
