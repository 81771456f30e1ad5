"""Meshes, batch shards, collectives and model replicas of the PyTorch port.

The counterpart of the JAX package's ``parallel/mesh.py`` (the reference's
DDP/NCCL plumbing, main.py:641, 992-997). A :class:`Mesh` is the devices
this process drives plus the process group it belongs to: one card per
process for training (each rank holds a contiguous block of the global
batch's rows; the gradients are averaged by an all-reduce), or several
devices of one process for evaluation and serving (:class:`Replicas`: each
device runs a whole model on its block of rows; no collectives, since each
clip is answered on its own).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: what this process drives. ``group``: its process group
    (None: a lone process), with this process's ``rank`` in a world of
    ``world_size``."""

    devices: Tuple[torch.device, ...]
    group: Any = None
    rank: int = 0
    world_size: int = 1

    @property
    def size(self) -> int:
        """Shards of a global batch: devices times processes."""
        return len(self.devices) * self.world_size


def get_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of this process: ``devices`` as given, else this process's
    card when it is in a process group (one card per process), else every
    card of the machine. Never the CPU unasked: without a card, pass
    ``devices=["cpu"]``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=['cpu'] to use the CPU")
        devices = ([torch.cuda.current_device()] if dist.is_initialized()
                   else range(torch.cuda.device_count()))
        devices = [torch.device("cuda", i) for i in devices]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if not dist.is_initialized():
        return Mesh(devices)
    return Mesh(devices, dist.group.WORLD, dist.get_rank(), dist.get_world_size())


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """The rows of a global batch of ``n`` that this process holds: its
    contiguous block of n / world_size."""
    if n % mesh.world_size:
        raise ValueError(f"a global batch of {n} does not split over {mesh.world_size} processes")
    k = n // mesh.world_size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(batch, mesh: Mesh):
    """This process's rows of every array (numpy or tensor, rank >= 1) of a
    global batch (an array, or a dict or tuple of them; other entries
    pass): what a data-parallel train step takes."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(shard_batch(v, mesh) for v in batch)
    if getattr(batch, "ndim", 0) >= 1 and getattr(batch, "dtype", None) != object:
        return batch[batch_sharding(mesh, batch.shape[0])]
    return batch


@torch.no_grad()
def pad_batch_to_multiple(batch_np: Dict[str, Any], multiple: int) -> Tuple[Dict[str, Any], Any]:
    """Zero-pad the leading axis of every numeric array of a host batch to a
    multiple of ``multiple`` (the mesh's size), so that it splits evenly.
    Returns (the padded batch, the leading length of its first array
    before padding, or None without one); other entries are kept as they are."""
    import numpy as np

    n, out = None, {}
    for k, v in batch_np.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.dtype != object:
            if n is None:
                n = v.shape[0]
            pad = (-v.shape[0]) % multiple
            if pad:
                v = np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))
        out[k] = v
    return out, n


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, in place,
    so that every rank starts from the same weights. Without a process
    group there is nothing to do."""
    if mesh.group is not None:
        for t in module.state_dict(keep_vars=True).values():
            dist.broadcast(t.data, src=0, group=mesh.group)
    return module


def all_reduce_(tensors: Sequence[torch.Tensor], mesh: Mesh, mean: bool = False) -> int:
    """Sum (or average) ``tensors`` over the mesh's processes, in place, as
    one flat buffer in the given order: one collective whatever the count,
    and the same summation order on every rank. Runs even in a group of
    one, where it changes nothing. Returns the number of processes."""
    if mesh.group is None or not tensors:
        return mesh.world_size
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    if mean:
        flat /= mesh.world_size
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return mesh.world_size


class Launch:
    """A batch launched on the replicas: the trimmed outputs in host memory
    (a tensor, or a dict of them), and the events after each device's
    input copy (``copied``) and output copy (``done``); None on the CPU."""

    def __init__(self, host, copied: List, done: List):
        self.host, self.copied, self.done = host, copied, done

    def wait(self):
        """The outputs, once every device's copy back has completed."""
        for e in self.done:
            e.synchronize()
        return self.host


class Replicas:
    """One model's replicas on several devices of this process.

    ``launch(x)`` pads the batch's rows to a multiple of the device count,
    splits them into contiguous blocks, runs block i through replica i,
    gathers the outputs in host memory and trims the padding. On the card
    each device has a copy stream and a compute stream: block i crosses on
    the copy stream (an event after it, in ``Launch.copied``), the compute
    stream waits on that event, runs the replica, and copies its outputs
    into pinned host memory (an event after it, in ``Launch.done``): the
    host waits on those events only. Elsewhere ``launch`` is synchronous.

    A device named twice gets the model itself twice: the replica on the
    model's own device is the model, and others are copies
    (:meth:`sync` copies the model's weights to them again)."""

    def __init__(self, model, devices: Sequence):
        self.model = model
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("Replicas need at least one device")
        self.cuda = self.devices[0].type == "cuda"
        if any((d.type == "cuda") != self.cuda for d in self.devices):
            raise ValueError(f"replicas on the card and the CPU at once: {self.devices}")
        home = torch.device(model.device)
        copies: Dict[torch.device, Any] = {}
        self.replicas = []
        for d in self.devices:
            if _same_device(d, home):
                self.replicas.append(model)
                continue
            if d not in copies:
                replica = copy.deepcopy(model).to(d)
                replica.device = d
                copies[d] = replica
            self.replicas.append(copies[d])
        if self.cuda:
            self.copy_streams = [torch.cuda.Stream(d) for d in self.devices]
            self.streams = [torch.cuda.Stream(d) for d in self.devices]

    @torch.no_grad()
    def sync(self) -> None:
        """Copy the model's parameters and buffers to the other replicas."""
        state = self.model.state_dict()
        for r in {id(r): r for r in self.replicas if r is not self.model}.values():
            r.load_state_dict(state)

    def launch(self, x, method: str = "forward") -> Launch:
        """Run ``replica.<method>`` on each device's block of the rows of
        ``x`` (a numpy array or a host tensor; on the card, pass a pinned
        tensor to skip one copy, and keep it unchanged until the events in
        ``copied`` have completed)."""
        x = torch.as_tensor(x)
        n, k = x.shape[0], len(self.devices)
        pad = (-n) % k
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        rows = x.shape[0] // k
        if not self.cuda:
            outs = [getattr(r, method)(x[i * rows:(i + 1) * rows])
                    for i, r in enumerate(self.replicas)]
            return Launch(_trim(_gather(outs), n), [], [])
        if not x.is_pinned():
            x = x.pin_memory()
        copied, done, host = [], [], None
        for i, (d, r) in enumerate(zip(self.devices, self.replicas)):
            with torch.cuda.stream(self.copy_streams[i]):
                xi = x[i * rows:(i + 1) * rows].to(d, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.copy_streams[i])
            copied.append(ev)
            stream = self.streams[i]
            with torch.cuda.stream(stream):
                stream.wait_event(ev)
                xi.record_stream(stream)  # allocated on the copy stream
                out = getattr(r, method)(xi)
                if host is None:
                    host = _map(lambda t: torch.empty((x.shape[0],) + tuple(t.shape[1:]),
                                                      dtype=t.dtype, pin_memory=True), out)
                _zip_map(lambda h, t: h[i * rows:(i + 1) * rows].copy_(t, non_blocking=True),
                         host, out)
                ev = torch.cuda.Event()
                ev.record(stream)
            done.append(ev)
        return Launch(_trim(host, n), copied, done)

    def __call__(self, x, method: str = "forward"):
        return self.launch(x, method).wait()


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    index = lambda d: torch.cuda.current_device() if d.index is None else d.index  # noqa: E731
    return index(a) == index(b)


def _map(fn, out):
    return {k: fn(v) for k, v in out.items()} if isinstance(out, dict) else fn(out)


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            fn(a[k], b[k])
    else:
        fn(a, b)


def _gather(outs):
    if isinstance(outs[0], dict):
        return {k: torch.cat([torch.as_tensor(o[k]) for o in outs]) for k in outs[0]}
    return torch.cat([torch.as_tensor(o) for o in outs])


def _trim(out, n: int):
    return _map(lambda t: t[:n], out)
