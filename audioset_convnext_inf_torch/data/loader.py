"""Prefetching data loader.

The port's counterpart of the JAX package's ``data/loader.py``. The
reference leans on torch's ``DataLoader`` with 10 worker processes
(evaluate_convnext_on_audioset.py:71-85); h5py releases the GIL during
reads, so a thread pool gets the same I/O overlap without pickling batches
across processes. Batches are assembled ahead of consumption, in order, in
a bounded queue, so host I/O overlaps the card's compute (the Evaluator's
replicas copy each batch to the card on their own streams);
:func:`device_prefetch` keeps batches in flight to a device for other
consumers.

With ``pad_to_batch_size`` the last partial batch is zero-padded to the
full batch size and its real length reported as ``batch["valid"]``. With
``pin_memory`` each numeric per-clip field (waveform, target, fbank) is
stacked by the worker thread straight into a CPU torch tensor in pinned
host memory (where a CUDA device is available), so that the consumer's
copy to the card starts at once and its own thread copies nothing (the
Evaluator on the card at B=256: one 164-MB copy a batch off its thread).
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from audioset_convnext_inf_torch.data.hdf5_dataset import collate


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_sampler: Iterable,
        num_workers: int = 8,
        prefetch_batches: int = 4,
        collate_fn: Callable = collate,
        pad_to_batch_size: Optional[int] = None,
        pin_memory: bool = False,
    ):
        """``dataset`` is anything with ``__getitem__(meta) -> dict``;
        ``batch_sampler`` yields lists of metas."""
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = prefetch_batches
        self.collate_fn = collate_fn
        self.pad_to_batch_size = pad_to_batch_size
        self.pin_memory = pin_memory

    def _load_batch(self, batch_meta) -> dict:
        items = [self.dataset[meta] for meta in batch_meta]
        for item, meta in zip(items, batch_meta):
            if "target" in meta and "target" not in item:
                item["target"] = meta["target"]
        n = len(items)
        pinned = {}
        if self.pin_memory:
            rows = max(n, self.pad_to_batch_size or 0)
            pinned = {k: _stack_pinned([item.pop(k) for item in items], rows)
                      for k in list(items[0]) if _numeric(items[0][k])}
        batch = self.collate_fn(items)
        batch.update(pinned)
        if self.pad_to_batch_size and n < self.pad_to_batch_size:
            pad = self.pad_to_batch_size - n
            for k, v in batch.items():
                if k in pinned:
                    continue
                if isinstance(v, np.ndarray) and v.dtype != object and v.ndim >= 1:
                    batch[k] = np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))
                else:
                    batch[k] = np.concatenate([v, np.array([v[-1]] * pad, dtype=v.dtype)])
        batch["valid"] = n
        return batch

    def __iter__(self) -> Iterator[dict]:
        sentinel = object()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Put with periodic stop checks; True if delivered. A consumer
            that walks away stops draining, and a blocking put on the full
            queue would leak this thread, its pool and its file handles."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # The sampler runs ahead of consumption, so its live state does
            # not belong to the batch the consumer holds: snapshot it right
            # after each draw and ship it with the batch.
            can_snapshot = hasattr(self.batch_sampler, "state_dict")

            def finish(fut, state):
                batch = fut.result()
                if can_snapshot:
                    batch["sampler_state"] = state
                return batch

            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending = collections.deque()
                    for batch_meta in self.batch_sampler:
                        if stop.is_set():
                            return
                        state = self.batch_sampler.state_dict() if can_snapshot else None
                        pending.append((pool.submit(self._load_batch, batch_meta), state))
                        # a bounded in-flight window that keeps batch order
                        while len(pending) >= self.num_workers:
                            if not put_or_stop(finish(*pending.popleft())):
                                return
                    for fut_state in pending:
                        if not put_or_stop(finish(*fut_state)):
                            return
            except Exception as e:  # hand worker errors to the consumer
                put_or_stop(e)
            finally:
                if stop.is_set():  # consumer gone; do not block on a full queue
                    try:
                        q.put_nowait(sentinel)
                    except queue.Full:
                        pass
                else:
                    q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while True:  # drain so the producer can exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def _numeric(v) -> bool:
    return isinstance(v, np.ndarray) and v.dtype != object and np.issubdtype(v.dtype, np.number)


def _stack_pinned(arrays, rows: int):
    """(rows, *shape) CPU tensor holding ``arrays`` (equal shapes) stacked,
    zeros below them; in pinned memory where a CUDA device is available
    (as torch's own loader, which pins nothing without one)."""
    import torch

    out = torch.empty((rows,) + arrays[0].shape, pin_memory=torch.cuda.is_available(),
                      dtype=torch.from_numpy(np.empty(0, arrays[0].dtype)).dtype)
    view = out.numpy()
    np.stack(arrays, out=view[:len(arrays)])
    view[len(arrays):] = 0
    return out


def device_prefetch(iterator: Iterable, device, size: int = 2) -> Iterator[dict]:
    """Keep ``size`` batches in flight to ``device`` (double buffering).

    On the card each numeric array of a batch is copied into pinned host
    memory and from there, ``non_blocking``, onto the card on a copy stream;
    one event per batch follows its copies. A batch is handed out once the
    consumer's current stream waits on that event, and its tensors are
    marked as used on that stream, so the copy of the next batches overlaps
    the consumer's work. On another device the arrays become tensors there.
    Other entries (names, counts, bool masks) pass through as they are."""
    import torch

    device = torch.device(device)
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def to_device(batch):
        if copy_stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) if _numeric(v) else v
                    for k, v in batch.items()}, None
        out = {}
        with torch.cuda.stream(copy_stream):
            for k, v in batch.items():
                if _numeric(v):
                    host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    v = host.to(device, non_blocking=True)
                out[k] = v
            event = torch.cuda.Event()
            event.record(copy_stream)
        return out, event

    def hand_out(item):
        out, event = item
        if event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for v in out.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(stream)
        return out

    buf: "collections.deque" = collections.deque()
    for batch in iterator:
        buf.append(to_device(batch))
        if len(buf) >= size:
            yield hand_out(buf.popleft())
    while buf:
        yield hand_out(buf.popleft())
