"""Dynamic-batching inference service.

The port's counterpart of the JAX package's ``engine/service.py``: callers
submit single clips from any thread; one batcher thread coalesces them into
fixed-shape batches (the tail zero-padded), so the card always runs one
shape, and results fan back out through futures. A batch closes when
``batch_size`` requests wait or ``max_wait_ms`` has passed since its first,
whichever comes first. Long audio becomes extra rows upstream
(``engine/infer.py::sliding_windows``).

On the card (a model whose ``device`` is CUDA), every batch goes through
``parallel.Replicas``: the model's own device, or each device of a
:class:`ShardedModel` (a contiguous block of the batch's rows on each):

 - Pinned slabs. Each wire dtype (float32, int16) has a ring of
   ``SLABS_PER_DTYPE`` pinned host slabs (batch_size, clip_samples). A batch
   is assembled in a slab, and each device copies its rows to itself by a
   non-blocking copy on its copy stream, with an event recorded after it;
   that device's compute stream waits on that event. The copies read the
   slab after the call that issued them has returned, so **a slab is
   rewritten only after every device's copy event has completed**
   (``_next_slab``).
 - Results that do not wait for the next batch. Right after batch N's
   forward on a device, the copies of its ``clipwise_output`` and
   ``clipwise_logits`` rows into pinned host buffers are enqueued on the
   same stream, and an event is recorded; resolving batch N waits on those
   events only. A ``.cpu()`` issued after batch N+1 was launched would also
   wait for N+1 (one stream runs in order).
 - So the batcher keeps one batch in flight: it launches batch N, then fans
   out batch N-1's results while the card computes N.
 - Model calls from other threads. The batcher holds ``model_lock`` while it
   enqueues a forward; any other thread that calls the model (the HTTP
   service's ``/embed``) takes the same lock. This serialises only the
   host-side enqueue: the kernels' launch counters (plain Python attributes)
   and the kernel libraries' first-use set-up see one thread at a time,
   while the card may run the two threads' streams side by side. Each call's
   temporaries belong to the stream that allocated them, and the weights are
   only read.

Elsewhere (the CPU, or a model without a ``device``) ``forward`` is
synchronous: it gets the numpy slab and may return numpy arrays or tensors.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from audioset_convnext_inf_torch.config import CLIP_SAMPLES, INT16_SCALE
from audioset_convnext_inf_torch.parallel.mesh import Replicas, get_mesh

SLABS_PER_DTYPE = 2
_OUTPUTS = ("clipwise_output", "clipwise_logits")
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int16): torch.int16}


class ServiceOverloaded(RuntimeError):
    """The request queue is full (``max_queued``); shed load upstream."""


class ServiceStopped(RuntimeError):
    """The service was stopped before this request could be served."""


class ShardedModel:
    """A model served over its replicas on several devices of this process
    (the JAX package's ``ShardedModel`` over a mesh): each batch is padded
    to a multiple of the device count, split into contiguous blocks of
    rows, run on each device, gathered and trimmed (``parallel.Replicas``).
    No collectives: each clip is answered on its own. It keeps the live
    model's contract for :class:`InferenceService` and the HTTP service:
    ``forward`` and ``forward_scene_embeddings`` (outputs in host memory),
    ``device`` (the first device) and ``cfg``. ``devices`` defaults to every
    card of the machine. Any batch size works, and the fused block kernel
    runs at any per-device batch."""

    def __init__(self, model, devices=None):
        self.replicas = Replicas(model, get_mesh(devices).devices)
        self.model, self.cfg = model, model.cfg
        self.device = self.replicas.devices[0]

    def forward(self, waveform) -> Dict[str, torch.Tensor]:
        return self.replicas(waveform, "forward")

    def forward_scene_embeddings(self, waveform) -> torch.Tensor:
        return self.replicas(waveform, "forward_scene_embeddings")


class _Slab:
    """One batch of host memory (pinned for the card) and the events after
    the last copies that read it (one per device)."""

    def __init__(self, shape, dtype: np.dtype, pinned: bool):
        self.host = torch.zeros(shape, dtype=_TORCH_DTYPES[np.dtype(dtype)], pin_memory=pinned)
        self.array = self.host.numpy()
        self.copied: List[torch.cuda.Event] = []


class InferenceService:
    def __init__(
        self,
        model,
        batch_size: int = 32,
        max_wait_ms: float = 20.0,
        clip_samples: int = CLIP_SAMPLES,
        pcm_int16: bool = False,
        max_queued: Optional[int] = None,
    ):
        """``max_queued`` bounds the request queue (backpressure): when
        full, ``submit`` raises :class:`ServiceOverloaded` (callers map it
        to HTTP 429). Default: 32 batches' worth."""
        self.model = model
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        self.clip_samples = clip_samples
        self.pcm_int16 = pcm_int16
        self.max_queued = 32 * batch_size if max_queued is None else max_queued
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.max_queued)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False
        # client threads (requests, rejected) and the worker (batches, clips)
        # both update the counters
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "clips": 0}
        self.model_lock = threading.Lock()
        device = getattr(model, "device", None)
        self.device = torch.device(device) if device is not None else None
        self._cuda = self.device is not None and self.device.type == "cuda"
        if self._cuda:
            self._replicas = (model.replicas if isinstance(model, ShardedModel)
                              else Replicas(model, [self.device]))
        self._slabs: Dict[np.dtype, deque] = {}  # wire dtype -> ring of _Slab

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "InferenceService":
        if not self._started:
            self._warmup()
            self._thread.start()
            self._started = True
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._started:
            self._thread.join(timeout=10)
        # fail the requests that were queued but never dispatched: their
        # futures would otherwise stay pending until the callers time out
        while True:
            try:
                _, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                try:
                    fut.set_exception(ServiceStopped("service stopped"))
                except Exception:  # lost a race with submit(): already done
                    pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _warmup(self) -> None:
        """One forward per wire dtype at ``batch_size`` through the batch
        path: the kernels build, the pinned slabs and buffers are allocated,
        and the libraries' handles settle before the first request."""
        for dtype in (np.float32, np.int16) if self.pcm_int16 else (np.float32,):
            slab = self._next_slab(np.dtype(dtype))
            slab.array[:] = 0
            self._fetch(self._launch(slab))

    # -- API -----------------------------------------------------------------
    def submit(self, waveform: np.ndarray) -> Future:
        """Queue one clip (any length; padded or cropped to clip_samples).
        Returns a Future resolving to {'clipwise_output', 'clipwise_logits'}.

        With ``pcm_int16=True``, int16 PCM stays int16 through the batcher
        and decodes on the card (half the host-to-card bytes of float32).
        Without it, int16 becomes float32 here (x * INT16_SCALE): that batch
        shape was never warmed. Anything else becomes float32.

        float32 input is queued without a copy (the batcher copies it into
        a slab within ``max_wait_ms``); callers must not change a submitted
        array before its future resolves."""
        wav = np.asarray(waveform)
        if wav.dtype == np.int16 and not self.pcm_int16:
            wav = wav.astype(np.float32) * np.float32(INT16_SCALE)
        elif wav.dtype != np.int16 and wav.dtype != np.float32:
            wav = wav.astype(np.float32)
        wav = wav.reshape(-1)
        if len(wav) < self.clip_samples:
            wav = np.pad(wav, (0, self.clip_samples - len(wav)))
        else:
            wav = wav[: self.clip_samples]
        if self._stop.is_set():
            raise ServiceStopped("service stopped")
        fut: Future = Future()
        try:
            self._queue.put_nowait((wav, fut))
        except queue.Full:
            with self._stats_lock:
                self.stats["rejected"] = self.stats.get("rejected", 0) + 1
            raise ServiceOverloaded(
                f"request queue full ({self.max_queued} clips queued)"
            ) from None
        if self._stop.is_set():
            # raced with stop(): the worker may have exited and the drain
            # missed this entry; fail it here (the first setter wins)
            try:
                fut.set_exception(ServiceStopped("service stopped"))
            except Exception:
                pass
            raise ServiceStopped("service stopped")
        with self._stats_lock:
            self.stats["requests"] += 1
        return fut

    def tag(self, waveform: np.ndarray, timeout: Optional[float] = 60.0) -> Dict[str, np.ndarray]:
        return self.submit(waveform).result(timeout=timeout)

    def counters(self) -> Dict[str, int]:
        """A consistent copy of ``stats``."""
        with self._stats_lock:
            return dict(self.stats)

    # -- batcher --------------------------------------------------------------
    def _worker(self) -> None:
        # batch N in flight on the card while batch N-1's results fan out
        pending: deque = deque()
        while not self._stop.is_set():
            try:
                # with results waiting, poll briefly: an idle queue must not
                # hold batch N's futures until batch N+1 arrives
                first = self._queue.get(timeout=0.002 if pending else 0.1)
            except queue.Empty:
                if pending:
                    self._resolve(*pending.popleft())
                continue
            batch: List = [first]
            deadline = time.perf_counter() + self.max_wait_ms / 1000.0
            while len(batch) < self.batch_size:
                try:  # take whatever is queued already, without waiting
                    batch.append(self._queue.get_nowait())
                    continue
                except queue.Empty:
                    pass
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            out = self._dispatch(batch)
            if out is not None:
                pending.append((out, batch))
            while len(pending) > 1:
                self._resolve(*pending.popleft())
        while pending:  # drain on stop
            self._resolve(*pending.popleft())

    def _next_slab(self, dtype: np.dtype) -> _Slab:
        """The ring's next slab for ``dtype``, once the copy that last read
        it has completed."""
        ring = self._slabs.get(dtype)
        if ring is None:
            ring = self._slabs[dtype] = deque(
                _Slab((self.batch_size, self.clip_samples), dtype, self._cuda)
                for _ in range(SLABS_PER_DTYPE))
        slab = ring[0]
        ring.rotate(-1)
        for event in slab.copied:
            event.synchronize()  # the invariant: no rewrite before every copy is done
        return slab

    def _dispatch(self, batch: List):
        """Assemble one batch in a slab and launch it; returns what
        ``_fetch`` takes, or None if the launch failed (its futures fail)."""
        n = len(batch)
        dtype = np.dtype(np.int16 if all(b[0].dtype == np.int16 for b in batch) else np.float32)
        slab = self._next_slab(dtype)
        wavs = slab.array
        for i, (w, _) in enumerate(batch):
            wavs[i] = w
            if w.dtype == np.int16 and dtype == np.float32:  # a mixed batch
                wavs[i] *= np.float32(INT16_SCALE)
        if n < self.batch_size:  # fixed shape: one program, one launch plan
            wavs[n:] = 0
        try:
            return self._launch(slab)
        except Exception as e:  # the launch failed: fail this batch, keep serving
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["clips"] += n
            return None

    def _launch(self, slab: _Slab):
        """Enqueue slab -> card(s), the forward and the outputs' copies back;
        returns ({output: host array or tensor}, the events after the
        copies back)."""
        if not self._cuda:
            with self.model_lock:
                out = self.model.forward(slab.array)
            return {k: out[k] for k in _OUTPUTS}, []
        with self.model_lock:
            launch = self._replicas.launch(slab.host)
        slab.copied = launch.copied
        return {k: launch.host[k] for k in _OUTPUTS}, launch.done

    @staticmethod
    def _fetch(launched) -> Dict[str, np.ndarray]:
        """Wait for one launch's output copies (that launch only)."""
        host, done = launched
        for event in done:
            event.synchronize()
        return {k: np.asarray(v) for k, v in host.items()}

    def _resolve(self, launched, batch: List) -> None:
        """Fulfil one finished batch's futures (counted first, so a caller
        holding its result sees its batch in ``counters()``)."""
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["clips"] += len(batch)
        try:
            out = self._fetch(launched)
            probs, logits = out["clipwise_output"], out["clipwise_logits"]
            for i, (_, fut) in enumerate(batch):
                fut.set_result({"clipwise_output": probs[i].copy(),
                                "clipwise_logits": logits[i].copy()})
        except Exception as e:  # a device error surfaces at the fetch
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
