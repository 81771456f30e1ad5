"""Training engine of the PyTorch port, on one card or data-parallel.

The JAX package's ``engine/trainer.py`` (the reference DDP loop,
main.py:117-923):

 - AdamW with the reference's weight-decay grouping (no decay for rank-1
   tensors: biases, norm scales, gamma; pytorch_utils.custom_weight_decay),
   OneCycle LR over 75k steps (main.py:659-660), or Adam; the optional
   weight-decay schedule (main.py:664-712). The arithmetic is optax's
   (``optax.adamw``, ``optax.cosine_onecycle_schedule``), written out, so a
   step given the same gradients gives the same parameters;
 - gradient accumulation with ``optax.MultiSteps`` semantics: the running
   mean of the micro-step gradients, one update every k micro-steps;
 - mixup (paired 2B batch), SpecAugment and drop path from one
   ``torch.Generator`` per step, seeded from (seed, step); bn0's running
   statistics update in place during the forward;
 - data parallelism over a process group (``Trainer(..., mesh=...)``, one
   card per process): every rank takes its contiguous block of the global
   batch's rows; draws that depend on the batch are made for the global
   batch and sliced, bn0's statistics are the global batch's, and the
   gradients and the loss are averaged by one all-reduce of one flat buffer
   before the optimizer step, so every rank applies the same update. On the
   fused route each rank draws its own drop path (the JAX package's
   ``fold_in`` by device index); on the unfused route the global draws are
   sliced, and the step equals the one-process step on the global batch.
"""

from __future__ import annotations

import collections
import logging
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from audioset_convnext_inf_torch.checkpoint.io import optimizer_state_from_optax
from audioset_convnext_inf_torch.engine.losses import clip_bce
from audioset_convnext_inf_torch.models import convnext as F
from audioset_convnext_inf_torch.ops import adamw
from audioset_convnext_inf_torch.ops.mixup import do_mixup, get_mixup_lambda
from audioset_convnext_inf_torch.ops.pcm import decode_pcm_if_int16
from audioset_convnext_inf_torch.ops.precision import fp32_precision
from audioset_convnext_inf_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    batch_sharding,
    replicate,
)
from audioset_convnext_inf_torch.utils.profiling import span

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"  # "adam" | "adamw" (main.py:645-658)
    max_lr: float = 4e-4
    total_steps: int = 75000  # OneCycleLR span (main.py:659-660)
    pct_start: float = 0.3
    div_factor: float = 25.0
    final_div_factor: float = 1e4
    weight_decay: float = 0.01
    # Optional WD schedule (reference main.py:664-712): cooldown phase
    # (constant or cosine from wd to wd/5) for the first 30% of steps, then
    # linear warmup to 2*wd.
    use_wd_schedule: bool = False
    wd_constant_cooldown: bool = True
    wd_cooldown_frac: float = 0.3
    accumulation_steps: int = 1
    mixup_alpha: float = 0.0  # 0 disables; the reference uses 1.0 when on
    seed: int = 1234
    bf16_compute: bool = False


def _wd_mask(params: Params) -> Dict[str, bool]:
    """True = apply weight decay: every tensor of rank > 1."""
    return {name: p.ndim > 1 for name, p in params.items()}


def onecycle_lr(cfg: TrainConfig) -> Schedule:
    """Cosine one-cycle, ``optax.cosine_onecycle_schedule``: from
    max_lr/div_factor up to max_lr over the first pct_start of the steps,
    then down to that start value / final_div_factor, cosine both ways."""
    v0 = cfg.max_lr / cfg.div_factor
    v1 = v0 * cfg.div_factor
    v2 = v1 * (1.0 / (cfg.div_factor * cfg.final_div_factor))
    b1, b2 = int(cfg.pct_start * cfg.total_steps), int(cfg.total_steps)

    def cosine(start: float, end: float, pct: float) -> float:
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)

    def sched(step: int) -> float:
        if step < b1:
            return cosine(v0, v1, step / b1)
        if step < b2:
            return cosine(v1, v2, (step - b1) / (b2 - b1))
        return v2

    return sched


def wd_schedule(cfg: TrainConfig) -> Schedule:
    """Cooldown (constant, or cosine wd -> wd/5) then linear warmup to 2*wd
    over total_steps (reference wd_scheduler, main.py:667-708)."""
    base, final, minv = cfg.weight_decay, 2 * cfg.weight_decay, cfg.weight_decay / 5
    cooldown = int(cfg.wd_cooldown_frac * cfg.total_steps)

    def sched(step: int) -> float:
        if step < cooldown:
            if cfg.wd_constant_cooldown:
                return base
            return minv + 0.5 * (base - minv) * (1 + math.cos(math.pi * step / max(cooldown, 1)))
        start = base if cfg.wd_constant_cooldown else minv
        frac = (step - cooldown) / max(cfg.total_steps - cooldown - 1, 1)
        return start + (final - start) * min(max(frac, 0.0), 1.0)

    return sched


class Optimizer:
    """Adam or AdamW (b1 0.9, b2 0.999, eps 1e-8) over named parameters,
    updated in place, with optax's arithmetic: moments (1 - b) * g + b * m,
    bias-corrected, u = m_hat / (sqrt(v_hat) + eps), plus wd * p where the
    mask says so, times -lr. The schedules read the number of updates made
    so far. With ``accumulation_steps`` k > 1 it is ``optax.MultiSteps``:
    each call folds the gradients into a running mean, and every k-th call
    applies one update with that mean.

    The update is ``ops/adamw.py::adamw_update_``: on the card one kernel
    over every leaf (its library loaded here, at construction), on the CPU
    the plain per-leaf version, with the same bits. ``fused_updates`` and
    ``loop_updates`` count the updates each route made."""

    B1, B2, EPS = adamw.B1, adamw.B2, adamw.EPS

    def __init__(self, params: Params, cfg: TrainConfig):
        if cfg.optimizer not in ("adam", "adamw"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.params = dict(params)
        self.cfg = cfg
        self.lr = onecycle_lr(cfg)
        self.wd = wd_schedule(cfg) if cfg.use_wd_schedule else (lambda step: cfg.weight_decay)
        self.decay = _wd_mask(self.params) if cfg.optimizer == "adamw" else {}
        self.count = 0  # updates applied
        self.mini_step = 0
        zeros = lambda: {n: torch.zeros_like(p) for n, p in self.params.items()}  # noqa: E731
        self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if cfg.accumulation_steps > 1 else None
        self.fused_updates = 0  # updates made by the kernel
        self.loop_updates = 0  # updates made by the plain version
        if any(p.is_cuda for p in self.params.values()):
            adamw.load_library()

    @torch.no_grad()
    def step(self, grads: Params) -> bool:
        """Take one micro-step's gradients; returns whether the parameters
        were updated."""
        k = self.cfg.accumulation_steps
        if k > 1:
            for n, g in grads.items():
                self.acc[n].add_((g - self.acc[n]) / (self.mini_step + 1))
            if self.mini_step < k - 1:
                self.mini_step += 1
                return False
            self.mini_step = 0
            grads = self.acc
        lr, wd = self.lr(self.count), self.wd(self.count)
        n_upd = self.count + 1
        bc1, bc2 = 1 - self.B1 ** n_upd, 1 - self.B2 ** n_upd
        names = list(self.params)
        launches = adamw.adamw_update_(
            [self.params[n] for n in names], [grads[n] for n in names],
            [self.mu[n] for n in names], [self.nu[n] for n in names],
            [bool(self.decay.get(n)) for n in names], lr, wd, bc1, bc2)
        if launches:
            self.fused_updates += 1
        else:
            self.loop_updates += 1
        self.count = n_upd
        if self.acc is not None:
            for a in self.acc.values():
                a.zero_()
        return True

    def state_dict(self) -> Dict[str, Any]:
        """count, mini_step, the moments (and accumulated gradients) under
        reference keys, and what the optax form of the state needs:
        ``structure`` (``optax_structure``) and, for the weight-decay
        schedule, ``hyperparams``, the learning rate and weight decay of the
        last update, as optax's inject_hyperparams keeps them."""
        hyperparams = None
        if self.cfg.optimizer == "adamw" and self.cfg.use_wd_schedule:
            last = max(self.count - 1, 0)
            hyperparams = {"learning_rate": np.float32(self.lr(last)),
                           "weight_decay": np.float32(self.wd(last))}
        return {"count": self.count, "mini_step": self.mini_step, "mu": self.mu, "nu": self.nu,
                "acc": self.acc, "structure": optax_structure(self.cfg),
                "hyperparams": hyperparams}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Adopt a ``state_dict()`` whose tensors may be numpy arrays (as a
        native checkpoint holds them) or tensors on any device."""
        if (self.acc is None) != (state.get("acc") is None):
            raise ValueError(f"the optimizer state {'lacks' if state.get('acc') is None else 'has'}"
                             f" accumulated gradients, but accumulation_steps is "
                             f"{self.cfg.accumulation_steps}")
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for name in ("mu", "nu", "acc"):
            mine = getattr(self, name)
            if mine is not None:
                for n, t in mine.items():
                    v = state[name][n]
                    t.copy_(v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v)))


def make_optimizer(params: Params, cfg: TrainConfig) -> Optimizer:
    return Optimizer(params, cfg)


def optax_structure(cfg: TrainConfig) -> str:
    """The optax structure the JAX package's ``make_optimizer`` builds for
    ``cfg``, as ``checkpoint.optimizer_state_from_optax`` names it."""
    if cfg.optimizer == "adam":
        kind = "optax.adam"
    else:
        kind = "optax.inject_hyperparams(adamw)" if cfg.use_wd_schedule else "optax.adamw"
    return f"optax.MultiSteps({kind})" if cfg.accumulation_steps > 1 else kind


def _step_generator(seed: int, step: int) -> torch.Generator:
    """The step's own random stream: a function of (seed, step) only, so a
    resumed run draws what the uninterrupted one drew."""
    return torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))


def _rank_generator(seed: int, step: int, rank: int) -> torch.Generator:
    """A rank's own stream for the step (the fused route's drop path)."""
    words = np.random.SeedSequence([seed & 0xFFFFFFFF, step & 0xFFFFFFFF, rank]).generate_state(2)
    return torch.Generator().manual_seed((int(words[0]) << 31) ^ int(words[1]))


class CollectiveTimer:
    """Time spent in the step's collectives since the last :meth:`ms`: CUDA
    events around them on the card, the host clock elsewhere; ``calls``
    counts the collectives timed since construction. Event pairs
    are folded into a running sum once they complete, and at most
    ``MAX_PENDING`` stay unread (the oldest is waited for beyond that), so
    a run that never reads the timer holds a bounded number of events."""

    MAX_PENDING = 64

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pending = collections.deque()  # (start, end) CUDA event pairs
        self.total_ms = 0.0
        self.calls = 0

    def __call__(self, fn):
        def timed(tensors):
            self.calls += 1
            if not self.cuda:
                t0 = time.perf_counter()
                out = fn(tensors)
                self.total_ms += 1e3 * (time.perf_counter() - t0)
                return out
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(tensors)
            end.record()
            self.pending.append((start, end))
            self._fold(wait=len(self.pending) > self.MAX_PENDING)
            return out
        return timed

    def _fold(self, wait: bool = False) -> None:
        while self.pending:
            start, end = self.pending[0]
            if wait:
                end.synchronize()
                wait = len(self.pending) - 1 > self.MAX_PENDING
            elif not end.query():
                return
            self.total_ms += start.elapsed_time(end)
            self.pending.popleft()

    def ms(self) -> float:
        """The ms of the collectives since the last call (waits for them)."""
        for _, end in self.pending:
            end.synchronize()
        self._fold()
        total, self.total_ms = self.total_ms, 0.0
        return total


def make_train_step(model, train_cfg: TrainConfig, optimizer: Optimizer,
                    loss_fn: Callable = clip_bce, mesh: Optional[Mesh] = None,
                    timer: Optional[CollectiveTimer] = None):
    """The train step for a ``models.ConvNeXt``:

        step(waveform, target, step_idx) -> loss (a device scalar, no sync)

    ``waveform`` is int16 PCM (decoded on the device) or f32, on the
    model's device. With mixup the incoming batch is 2B and the trunk's B.
    The backward runs with TF32 off, so f32 gradients are true f32; the
    parameters' ``.grad`` hold the step's gradients afterwards.

    With a ``mesh`` in a process group, the batch is this rank's rows of
    the global batch (``parallel.shard_batch``), which is world_size times
    as large; with mixup the global batch must be a multiple of
    2 x world_size, so that mixup's pairs stay on one rank. The returned
    loss is the global batch's mean, and ``.grad`` holds the averaged
    gradients. ``timer`` wraps the collectives."""
    compute_dtype = torch.bfloat16 if train_cfg.bf16_compute else torch.float32
    params = optimizer.params
    group = mesh is not None and mesh.group is not None
    wrap = timer if timer is not None else (lambda fn: fn)
    reduce_mean = wrap(lambda ts: all_reduce_(ts, mesh, mean=True))

    def train_step(waveform: torch.Tensor, target: torch.Tensor, step_idx: int) -> torch.Tensor:
        gen = _step_generator(train_cfg.seed, step_idx)
        was_training = model.training
        model.train()
        try:
            with span("train.forward"):
                waveform = decode_pcm_if_int16(waveform)
                n, rows, shard = waveform.shape[0], slice(None), None  # the global batch, ours
                if group:
                    n *= mesh.world_size
                    if train_cfg.mixup_alpha > 0 and n % (2 * mesh.world_size):
                        raise ValueError(f"mixup pairs adjacent clips: a global batch of {n} "
                                         f"clips does not split into pairs over "
                                         f"{mesh.world_size} processes")
                    rows = batch_sharding(mesh, n)
                    fused = F.fused_train_route(model, model.cfg) and mesh.world_size > 1
                    shard = F.Shard(rows, n, reduce_mean,
                                    _rank_generator(train_cfg.seed, step_idx, mesh.rank)
                                    if fused else None)
                mixup_lambda = None
                if train_cfg.mixup_alpha > 0:
                    mixup_lambda = get_mixup_lambda(gen, n, train_cfg.mixup_alpha)[rows]
                    mixup_lambda = mixup_lambda.to(waveform.device)
                    target = do_mixup(target, mixup_lambda)
                for p in params.values():
                    p.grad = None
                out = F.forward_train(model, waveform, model.cfg, model.frontend, gen,
                                      mixup_lambda, compute_dtype, shard=shard)
                loss = loss_fn(out, {"target": target})
            with span("train.backward"), fp32_precision("highest"):
                loss.backward()
        finally:
            model.train(was_training)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        loss = loss.detach()
        if group:  # one flat buffer, the parameters' order, the loss last
            with span("train.allreduce"):
                loss = loss.reshape(1).clone()
                reduce_mean(list(grads.values()) + [loss])
                loss = loss[0]
        with span("train.optimizer"):
            optimizer.step(grads)
        return loss

    return train_step


class Trainer:
    """The loop: steps, periodic eval and checkpoint callbacks, resume.

    ``mesh`` (``parallel.get_mesh()`` in a process group): data-parallel
    training, one card per process, the model's. The parameters are
    broadcast from rank 0 here and in :meth:`restore`. Without a process
    group the step is the one-process step, with no collective."""

    def __init__(self, model, train_cfg: TrainConfig, loss_fn: Callable = clip_bce,
                 mesh: Optional[Mesh] = None):
        self.model = model
        self.train_cfg = train_cfg
        self.device = next(model.parameters()).device
        self.mesh = mesh
        if mesh is not None:
            if len(mesh.devices) != 1 or mesh.devices[0].type != self.device.type:
                raise ValueError(f"a data-parallel trainer drives one device per process, the "
                                 f"model's ({self.device}); the mesh has {mesh.devices}")
            replicate(model, mesh)
        self.optimizer = make_optimizer(dict(model.named_parameters()), train_cfg)
        self.step_index = 0
        self.collectives = CollectiveTimer(self.device)
        self._step_fn = make_train_step(model, train_cfg, self.optimizer, loss_fn, mesh,
                                        self.collectives)
        # sampler snapshot of the last consumed batch (what a checkpoint
        # saves for an exact resume; the loader runs ahead of the trainer)
        self.last_sampler_state = None

    def restore(self, state_dict: Params, opt_state: Any, step: int) -> None:
        """Adopt a checkpoint: model weights (reference keys, strict), the
        optimizer's state and the step counter. ``opt_state`` is the port's
        ``Optimizer.state_dict()`` (tensors or numpy; older port checkpoints
        hold it so), or an optax state as ``checkpoint.load_checkpoint``
        reads it (what either package writes): that is converted
        (``checkpoint.optimizer_state_from_optax``). Either must be the
        structure the JAX package builds for this trainer's config."""
        if not isinstance(opt_state, dict):
            opt_state = optimizer_state_from_optax(opt_state)
        want = optax_structure(self.train_cfg)
        if opt_state.get("structure", want) != want:
            raise ValueError(f"the checkpoint holds an {opt_state['structure']} state; "
                             f"this training config builds {want}")
        self.model.load_state_dict(state_dict, strict=True)
        if self.mesh is not None:
            replicate(self.model, self.mesh)
        self.optimizer.load_state_dict(opt_state)
        self.step_index = int(step)

    def step_async(self, waveform, target) -> torch.Tensor:
        """Run one step; return the loss as a device scalar (no sync).
        int16 PCM crosses to the device as int16 and decodes there. In a
        process group the batch is this rank's rows of the global batch."""
        with span("train.step", {"step": self.step_index}):
            wav = torch.as_tensor(np.asarray(waveform))
            if wav.dtype != torch.int16:
                wav = wav.to(torch.float32)
            tgt = torch.as_tensor(np.asarray(target, np.float32))
            with span("train.h2d"):
                wav = wav.to(self.device, non_blocking=True)
                tgt = tgt.to(self.device, non_blocking=True)
            loss = self._step_fn(wav, tgt, self.step_index)
        self.step_index += 1
        return loss

    def step(self, waveform, target) -> float:
        return float(self.step_async(waveform, target))

    def train(
        self,
        train_loader: Iterable,
        eval_fn: Optional[Callable[[Any, int], None]] = None,
        eval_interval: int = 5000,
        checkpoint_fn: Optional[Callable[["Trainer", int], None]] = None,
        checkpoint_interval: int = 5000,
        early_stop: Optional[int] = None,
        log_interval: int = 100,
        on_step: Optional[Callable[[int, float], None]] = None,
        max_step_retries: int = 2,
    ) -> None:
        """Run the loop over batches ({"waveform", "target"[, "sampler_state"]}).

        - An error while a step is issued (bad shapes, out of memory) retries
          the same batch up to ``max_step_retries`` times, then tries an
          emergency checkpoint of the state before the step and re-raises.
        - A device-side error surfaces at the next sync point (every
          ``log_interval`` steps, or ``on_step``'s host float); by then later
          steps ran on top of it, so the loop logs that recovery is from the
          last interval checkpoint and re-raises.
        - A non-finite loss is logged and training goes on, as in the
          reference.
        ``on_step`` receives a host float, which syncs the device every step.
        In a process group each batch holds this rank's rows of the global
        batch, and each log line also gives the ms spent in collectives
        since the last one.
        """
        t0 = time.time()
        loss = None

        def sync_loss(loss, it: int) -> float:
            try:
                return float(loss)
            except Exception:
                logging.exception(
                    "deferred device error surfaced at iter %d; live state is "
                    "unrecoverable - resume from the last interval checkpoint", it)
                raise

        for batch in train_loader:
            it = self.step_index
            if eval_interval and it % eval_interval == 0 and eval_fn is not None and it > 0:
                eval_fn(self.model, it)
            if checkpoint_interval and it % checkpoint_interval == 0 \
                    and checkpoint_fn is not None and it > 0:
                checkpoint_fn(self, it)
            for attempt in range(max_step_retries + 1):
                try:
                    loss = self.step_async(batch["waveform"], batch["target"])
                    break
                except Exception:
                    if attempt >= max_step_retries:
                        logging.exception("train step failed to dispatch at iter %d; "
                                          "writing emergency checkpoint", it)
                        if checkpoint_fn is not None:
                            try:
                                checkpoint_fn(self, it)
                            except Exception:
                                logging.exception(
                                    "emergency checkpoint failed at iter %d; resume from "
                                    "the last interval checkpoint", it)
                        raise
                    logging.exception("train step error at iter %d, retrying", it)
            self.last_sampler_state = batch.get("sampler_state")
            if on_step is not None:
                on_step(it, sync_loss(loss, it))
            if it % log_interval == 0:
                lossf = sync_loss(loss, it)
                if not np.isfinite(lossf):
                    logging.warning("non-finite loss %.4f at iter %d", lossf, it)
                if self.mesh is not None and self.mesh.group is not None:
                    logging.info("iteration %d loss %.4f (%.2f s, collectives %.1f ms)", it,
                                 lossf, time.time() - t0, self.collectives.ms())
                else:
                    logging.info("iteration %d loss %.4f (%.2f s)", it, lossf, time.time() - t0)
                t0 = time.time()
            if early_stop is not None and self.step_index >= early_stop:
                break
        if loss is not None:
            lossf = sync_loss(loss, self.step_index - 1)
            if not np.isfinite(lossf):
                logging.warning("non-finite loss %.4f at final iter %d", lossf,
                                self.step_index - 1)
