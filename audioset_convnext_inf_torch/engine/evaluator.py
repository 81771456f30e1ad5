"""Batched evaluation on one card.

The port's counterpart of the JAX package's ``engine/evaluator.py``
(reference pytorch_utils.forward:63-137 and Evaluator:12-60). Where the
reference ping-pongs H2D -> forward -> D2H per batch, here:

 - batches cross to the card ahead of use (``data.loader.device_prefetch``:
   pinned memory, a side stream); int16 PCM crosses as int16 and decodes
   on the card, as ``models/api.py`` does;
 - results come back one batch behind: the (B, 527) probabilities of batch
   i are copied to pinned host memory under an event while batch i+1 runs;
 - the padded tail of the last batch is trimmed by ``batch["valid"]``;
 - metrics are computed on the host (``engine/metrics.py``).

One card; the JAX package's multi-device branch waits for the port's data
parallel slice (ROADMAP.md).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterable

import numpy as np
import torch

from audioset_convnext_inf_torch.data.loader import device_prefetch
from audioset_convnext_inf_torch.engine import metrics as M
from audioset_convnext_inf_torch.models.api import resolve_device


class Evaluator:
    """``Evaluator(model).evaluate(loader)`` -> per-class statistics
    (reference evaluate.py:22-60). ``model`` is the port's ``ConvNeXt``; it
    must live on ``device`` (the card unless ``device="cpu"`` is given)."""

    def __init__(self, model, device=None):
        self.device = resolve_device(device)
        have = torch.device(model.device)
        if have.type != self.device.type or None not in (have.index, self.device.index) and (
                have.index != self.device.index):
            raise ValueError(f"the model lives on {have}, the evaluator on {self.device}")
        self.model = model

    def set_params(self, state_dict: Dict[str, Any]) -> None:
        """Load fresh weights (a reference-keyed state dict of tensors or
        numpy arrays), e.g. for an evaluation during training."""
        self.model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()},
                                   strict=True)

    def infer_probs(self, loader: Iterable) -> Dict[str, np.ndarray]:
        """Forward every batch; returns {'clipwise_output', 'target'} (N, C).

        Batches carrying 'fbank' are fed as (B, T, M, 1) spectrogram images;
        others by their 'waveform' (int16 stays int16).
        """
        cuda = self.device.type == "cuda"
        probs_chunks, target_chunks = [], []
        in_flight: "collections.deque" = collections.deque()

        def inputs():
            for batch in loader:
                if "fbank" in batch:
                    x = np.asarray(batch["fbank"], np.float32)[..., None]
                else:
                    x = batch["waveform"]
                    if x.dtype != np.int16:  # int16 decodes on the card
                        x = x.astype(np.float32)
                n = batch.get("valid", x.shape[0])
                if "target" in batch:
                    target_chunks.append(np.asarray(batch["target"])[:n])
                yield {"x": x, "valid": n}

        def drain_one():
            host, event, n = in_flight.popleft()
            if event is not None:
                event.synchronize()
            probs_chunks.append(host.numpy()[:n])

        for batch in device_prefetch(inputs(), self.device, size=2):
            probs = self.model.forward(batch["x"])["clipwise_output"]
            # a fresh pinned buffer per batch, never refilled: no copy can
            # land in a buffer that is still being read
            host = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=cuda)
            host.copy_(probs, non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
            in_flight.append((host, event, batch["valid"]))
            if len(in_flight) >= 2:
                drain_one()
        while in_flight:
            drain_one()
        out = {"clipwise_output": np.concatenate(probs_chunks)}
        if target_chunks:
            out["target"] = np.concatenate(target_chunks)
        return out

    def evaluate(self, loader: Iterable) -> Dict[str, np.ndarray]:
        out = self.infer_probs(loader)
        return M.evaluate_clipwise(out["clipwise_output"], out["target"])
