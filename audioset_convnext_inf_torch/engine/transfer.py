"""Transfer learning: fine-tune a pretrained zoo model on a new tag task.

The port's counterpart of the JAX package's ``engine/transfer.py``, which
rebuilds the reference's finetune_audiocaps.py ``Transfer_Cnn`` (:74-128)
and its training loop (:166-226): a pretrained Cnn14 base, everything
frozen but ``fc1`` and ``fc_audioset``, AMSGrad at 1e-4, BCE loss,
per-epoch val/test mAP.

The base is frozen by ``requires_grad_(False)``, so autograd stops at the
head. It stays in train mode, as the reference's does
(finetune_audiocaps.py:186 ``model.train()``): each step runs
``forward_train``, whose batch-statistic BN returns new running statistics
that are merged into the buffers after the optimizer's update, as the JAX
trainer merges them (its :90-96), so eval forwards normalize with statistics
of the transfer data. The forward, the backward and the update all run under
``fp32_precision("highest")``: a backward outside the pin would run cuDNN's
convolutions in TF32.

The update is optax's ``amsgrad`` written out, not ``torch.optim.Adam(
amsgrad=True)``: optax keeps ``nu_max = max(nu_max, nu_hat)`` over the
*bias-corrected* second moment and steps ``mu_hat / (sqrt(nu_max) + eps)``,
while torch keeps the maximum of the raw second moment and bias-corrects
that maximum at the current step; the two part as soon as the gradients
shrink, since ``1 / (1 - b2^t)`` shrinks with t.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audioset_convnext_inf_torch.engine.metrics import evaluate_clipwise
from audioset_convnext_inf_torch.models import pann_layers as P
from audioset_convnext_inf_torch.models.pann import PannModel
from audioset_convnext_inf_torch.ops.precision import fp32_precision


def head_only_labels(model: PannModel,
                     trainable_keys: Tuple[str, ...] = ("fc1", "fc_audioset")) -> Dict[str, str]:
    """'train' or 'freeze' for each parameter, by its reference name: the
    parameters of the top-level modules named in ``trainable_keys`` train."""
    return {name: "train" if name.split(".", 1)[0] in trainable_keys else "freeze"
            for name, _ in model.named_parameters()}


@torch.no_grad()
def merge_bn_stats(model: PannModel, bn_updates: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Copy each BN's new running mean and variance (those two only) from a
    training forward's ``bn_updates`` into its buffers, by dotted path."""
    by_path = {mod.path: mod for mod in model.modules() if isinstance(mod, P.BatchNorm)}
    for path, stats in bn_updates.items():
        bn = by_path[path]
        bn.running_mean.copy_(stats["mean"])
        bn.running_var.copy_(stats["var"])


class AMSGrad:
    """optax's ``amsgrad`` (``scale_by_amsgrad`` then the learning rate),
    its state in f32: mu and nu the moving first and second moments,
    ``nu_max`` the running maximum of the bias-corrected nu."""

    def __init__(self, params: List[torch.Tensor], learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.nu_max = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.count += 1
        f32 = torch.float32
        bc1 = 1.0 - torch.tensor(self.b1, dtype=f32) ** self.count
        bc2 = 1.0 - torch.tensor(self.b2, dtype=f32) ** self.count
        for p, g, mu, nu, nu_max in zip(self.params, grads, self.mu, self.nu, self.nu_max):
            g = g.to(f32)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            torch.maximum(nu_max, nu / bc2.to(nu.device), out=nu_max)
            update = (mu / bc1.to(mu.device)) / (torch.sqrt(nu_max) + self.eps)
            p.copy_(p + update * -self.lr)


class TransferTrainer:
    """Head-only fine-tuning of a zoo model (the JAX package's
    ``TransferTrainer``): ``step`` on a batch of clips and multi-hot tags,
    ``evaluate`` to mAP, ``fit`` over epochs. Draws (dropout, SpecAugment)
    come from a generator on the model's device, seeded by ``seed``."""

    def __init__(self, model: PannModel, learning_rate: float = 1e-4,
                 trainable_keys: Tuple[str, ...] = ("fc1", "fc_audioset"), seed: int = 0):
        self.model = model
        labels = head_only_labels(model, trainable_keys)
        params = []
        for name, p in model.named_parameters():
            p.requires_grad_(labels[name] == "train")
            if labels[name] == "train":
                params.append(p)
        self.params = params
        self.opt = AMSGrad(params, learning_rate)
        self.generator = torch.Generator(device=model.device).manual_seed(seed)

    def to_device(self, audio, tags) -> Tuple[torch.Tensor, torch.Tensor]:
        """A batch's host arrays as f32 tensors on the model's device."""
        dev = self.model.device
        return (torch.as_tensor(np.asarray(audio, np.float32)).to(dev),
                torch.as_tensor(np.asarray(tags, np.float32)).to(dev))

    def step_on_device(self, audio: torch.Tensor, tags: torch.Tensor) -> torch.Tensor:
        """forward_train, BCE, the head's gradients, the AMSGrad update, then
        the BN merge, all in true f32; returns the loss (a device scalar)."""
        with fp32_precision("highest"):
            out = self.model.forward_train(audio, self.generator)
            loss = F.binary_cross_entropy_with_logits(out["clipwise_logits"], tags)
            grads = torch.autograd.grad(loss, self.params)
            self.opt.step(list(grads))
            merge_bn_stats(self.model, out["bn_updates"])
        return loss.detach()

    def step(self, audio, tags) -> float:
        return float(self.step_on_device(*self.to_device(audio, tags)))

    def evaluate(self, loader: Iterable) -> float:
        """Mean AP over a loader of {'audio', 'tags'} batches (eval forward)."""
        outs, tags = [], []
        for batch in loader:
            out = self.model.forward(np.asarray(batch["audio"], np.float32))
            outs.append(out["clipwise_output"].cpu().numpy())
            tags.append(np.asarray(batch["tags"]))
        stats = evaluate_clipwise(np.concatenate(outs), np.concatenate(tags))
        return float(np.nanmean(stats["average_precision"]))

    def fit(
        self,
        train_loader_fn: Callable[[], Iterable],
        val_loader_fn: Optional[Callable[[], Iterable]] = None,
        test_loader_fn: Optional[Callable[[], Iterable]] = None,
        epochs: int = 19,
        log_interval: int = 100,
        checkpoint_fn: Optional[Callable[[int, float], None]] = None,
    ) -> List[float]:
        """Epochs of training; after each, val and test mAP. The history and
        ``checkpoint_fn`` take the val mAP (model selection must not key on
        the test set; test mAP is only logged), else the test's."""
        history = []
        for epoch in range(1, epochs + 1):
            for it, batch in enumerate(train_loader_fn()):
                loss = self.step(batch["audio"], batch["tags"])
                if it % log_interval == 0:
                    logging.info("epoch %d it %d loss %.5f", epoch, it, loss)
            epoch_maps = {}
            for tag, fn in (("val", val_loader_fn), ("test", test_loader_fn)):
                if fn is None:
                    continue
                epoch_maps[tag] = self.evaluate(fn())
                logging.info("%s - epoch %d - mAP: %.4f", tag, epoch, epoch_maps[tag])
            mAP = epoch_maps.get("val", epoch_maps.get("test", float("nan")))
            history.append(mAP)
            if checkpoint_fn is not None:
                checkpoint_fn(epoch, mAP)
        return history
