"""Batched evaluation on one card or over several devices of one process.

The port's counterpart of the JAX package's ``engine/evaluator.py``
(reference pytorch_utils.forward:63-137 and Evaluator:12-60). Where the
reference ping-pongs H2D -> forward -> D2H per batch, here each batch goes
through ``parallel.Replicas`` (one replica per device, the whole model on
each, no collectives: each clip is answered on its own):

 - the batch is padded to a multiple of the device count and split into
   contiguous blocks; on the card each block crosses on a copy stream
   (int16 PCM stays int16 and decodes on the card, as the models do)
   while the previous batch computes;
 - results come back one batch behind: the (B, 527) probabilities of batch
   i are copied to pinned host memory under one event per device while
   batch i+1 runs;
 - the padding rows and the padded tail of the last batch are trimmed;
 - metrics are computed on the host (``engine/metrics.py``).
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from audioset_convnext_inf_torch.engine import metrics as M
from audioset_convnext_inf_torch.models.api import resolve_device
from audioset_convnext_inf_torch.parallel.mesh import Replicas
from audioset_convnext_inf_torch.utils.profiling import span


class Evaluator:
    """``Evaluator(model).evaluate(loader)`` -> per-class statistics
    (reference evaluate.py:22-60). ``model`` is any model of the port with a
    ``.device`` and a ``forward`` that returns a dict holding
    ``clipwise_output`` (the ``ConvNeXt``, a ``PannModel``); it must live on
    ``device`` (the card unless ``device="cpu"`` is given).
    ``devices`` (several devices of this process, e.g. every card of the
    host, or one named twice) shards each batch over replicas of the model;
    the model's device must be among them."""

    def __init__(self, model, device=None, devices: Optional[Sequence] = None):
        self.device = resolve_device(device if devices is None else devices[0])
        have = torch.device(model.device)
        if have.type != self.device.type or None not in (have.index, self.device.index) and (
                have.index != self.device.index):
            raise ValueError(f"the model lives on {have}, the evaluator on {self.device}")
        self.model = model
        self.replicas = Replicas(model, [self.device] if devices is None else devices)

    def set_params(self, state_dict: Dict[str, Any]) -> None:
        """Load fresh weights (a reference-keyed state dict of tensors or
        numpy arrays), e.g. for an evaluation during training."""
        self.model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()},
                                   strict=True)
        self.replicas.sync()

    def infer_probs(self, loader: Iterable) -> Dict[str, np.ndarray]:
        """Forward every batch; returns {'clipwise_output', 'target'} (N, C).

        Batches carrying 'fbank' are fed as (B, T, M, 1) spectrogram images;
        others by their 'waveform' (int16 stays int16). Fields may be numpy
        arrays or CPU tensors; a pinned tensor (``DataLoader(pin_memory=
        True)``) crosses to the card without a copy on this thread.
        """
        probs_chunks, target_chunks = [], []
        in_flight: "collections.deque" = collections.deque()

        # the kept rows are copied out of the batch's buffers: a view would
        # keep each batch's pinned buffer from the host allocator's reuse,
        # and the window would pin fresh memory for every batch
        def drain_one():
            launch, n = in_flight.popleft()
            probs_chunks.append(np.array(launch.wait()["clipwise_output"][:n]))

        batches = iter(loader)
        for k in itertools.count():
            with span("eval.wait_batch"):
                batch = next(batches, None)
            if batch is None:
                break
            if "fbank" in batch:
                x = torch.as_tensor(batch["fbank"], dtype=torch.float32)[..., None]
            else:
                x = torch.as_tensor(batch["waveform"])
                if x.dtype != torch.int16:  # int16 decodes on the card
                    x = x.float()
            n = batch.get("valid", x.shape[0])
            if "target" in batch:
                target_chunks.append(np.array(batch["target"][:n]))
            with span("eval.launch", {"batch": k}):
                in_flight.append((self.replicas.launch(x), n))
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
