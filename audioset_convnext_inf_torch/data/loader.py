"""Prefetching data loader and host-to-card double buffering.

The port's counterpart of the JAX package's ``data/loader.py``. The
reference leans on torch's ``DataLoader`` with 10 worker processes
(evaluate_convnext_on_audioset.py:71-85); h5py releases the GIL during
reads, so a thread pool gets the same I/O overlap without pickling batches
across processes. Batches are assembled ahead of consumption, in order, in
a bounded queue, and :func:`device_prefetch` keeps ``size`` batches in
flight to the card on a side stream so host I/O and copies overlap the
card's compute.

With ``pad_to_batch_size`` the last partial batch is zero-padded to the
full batch size and its real length reported as ``batch["valid"]``.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

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
    ):
        """``dataset`` is anything with ``__getitem__(meta) -> dict``;
        ``batch_sampler`` yields lists of metas."""
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = prefetch_batches
        self.collate_fn = collate_fn
        self.pad_to_batch_size = pad_to_batch_size

    def _load_batch(self, batch_meta) -> dict:
        items = [self.dataset[meta] for meta in batch_meta]
        for item, meta in zip(items, batch_meta):
            if "target" in meta and "target" not in item:
                item["target"] = meta["target"]
        batch = self.collate_fn(items)
        n = len(items)
        if self.pad_to_batch_size and n < self.pad_to_batch_size:
            pad = self.pad_to_batch_size - n
            for k, v in batch.items():
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


def _is_numeric(v) -> bool:
    return isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.number)


def device_prefetch(iterator: Iterable, device, size: int = 2) -> Iterator[dict]:
    """Keep ``size`` batches in flight to ``device`` (double buffering).

    Numeric numpy entries become tensors on ``device``; others pass through.
    On the card each batch is copied into freshly pinned host memory and
    sent with a non-blocking copy on a side stream; the consumer's stream
    waits on that batch's copy event before the batch is handed out. The
    pinned buffers are never refilled: each batch pins new ones from
    PyTorch's caching host allocator, which itself keeps a block out of
    reuse until the event recorded for its copy has completed.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def to_device(batch):
        if not cuda:
            return {k: torch.from_numpy(v) if _is_numeric(v) else v for k, v in batch.items()}, None
        out = {}
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                out[k] = (torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
                          if _is_numeric(v) else v)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def hand_out(item):
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(consumer)  # allocated on the side stream
        return batch

    buf: "collections.deque" = collections.deque()
    it = iter(iterator)
    for batch in it:
        buf.append(to_device(batch))
        if len(buf) >= size:
            break
    for batch in it:
        item = buf.popleft()
        buf.append(to_device(batch))
        yield hand_out(item)
    while buf:
        yield hand_out(buf.popleft())
