"""The transfer certificate of ``scripts/transfer_cert_tpu.py:32-104`` for
the port: its tone task, its batch order and its five gates, shared by the
CPU twin (``tests/test_torch_learn.py::test_transfer_head_learns``) and the
smoke run's phase 15(d). Imports neither JAX nor a package named ``tests``:
the smoke run loads this file by its path, as it loads ``torch_fuzz_util.py``.
"""

import dataclasses
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

CLASSES = 8  # tones at 220(k+1) Hz, target column k
CLIPS_PER_CLASS = 16
LOSS_RATIO = 0.25  # the last 8 losses' mean under this share of the first 8's
MIN_MAP = 0.9  # train mAP over the CLASSES columns, by model.forward
HEAD = ("fc1.", "fc_audioset.")  # what a head-only transfer trains


def tone_clips(samples: int, sample_rate: int = 32000):
    """(CLASSES * CLIPS_PER_CLASS, samples) f32 clips, drawn from
    RandomState(0) (amplitude 0.4-0.6, random phase, 3% noise), and their
    one-hot (N, 527) targets."""
    rng = np.random.RandomState(0)
    t = np.arange(samples) / sample_rate
    clips, tags = [], []
    for k in range(CLASSES):
        for _ in range(CLIPS_PER_CLASS):
            wav = (0.4 + 0.2 * rng.rand()) * np.sin(2 * np.pi * 220.0 * (k + 1) * t + rng.rand() * 6)
            clips.append((wav + 0.03 * rng.randn(samples)).astype(np.float32))
            tg = np.zeros(527, np.float32)
            tg[k] = 1.0
            tags.append(tg)
    return np.stack(clips), np.stack(tags)


def batches(n_clips: int, steps: int, batch: int) -> Iterator[np.ndarray]:
    """Each step's clip indexes: RandomState(1) permutations, cut to ``batch``."""
    order = np.random.RandomState(1)
    for _ in range(steps):
        yield order.permutation(n_clips)[:batch]


@dataclasses.dataclass
class Report:
    """What the five gates read from one head-only transfer run."""

    first: float  # mean loss of the first 8 steps
    last: float  # of the last 8
    finite: bool
    map: float
    ap: np.ndarray  # per class
    frozen: int  # parameters outside HEAD
    frozen_ok: bool  # all of them bit-identical to their start
    stats: int  # BN running statistics
    moved_stats: int  # of them, changed
    head_moved: bool  # fc_audioset.weight changed

    @property
    def ratio(self) -> float:
        return self.last / self.first

    def failures(self) -> List[str]:
        """The gates this run missed, each as one line; empty when it passed."""
        out = []
        if not (self.finite and self.last < LOSS_RATIO * self.first):
            out.append(f"loss {self.first:.4f} -> {self.last:.4f} (finite {self.finite}), "
                       f"gate under {LOSS_RATIO} of the start")
        if not self.map > MIN_MAP:
            out.append(f"train mAP {self.map:.4f}, per class {np.round(self.ap, 4).tolist()}")
        if not (self.frozen and self.frozen_ok):
            out.append(f"{self.frozen} frozen parameters, bit-identical {self.frozen_ok}")
        if not self.moved_stats:
            out.append(f"none of {self.stats} BN running statistics changed")
        if not self.head_moved:
            out.append("fc_audioset did not move")
        return out


def report(model, start: Dict[str, torch.Tensor], losses: Sequence[float], probs: np.ndarray,
           tags: np.ndarray) -> Report:
    """The gates' readings: ``start`` is the model's state dict before the
    run, ``probs`` its ``forward`` over the training clips after it."""
    from audioset_convnext_inf_torch.engine.metrics import evaluate_clipwise

    losses = np.asarray(losses, np.float64)
    ap = evaluate_clipwise(probs, tags)["average_precision"][:CLASSES]
    end = model.state_dict()
    frozen = [n for n, _ in model.named_parameters() if not n.startswith(HEAD)]
    stats = [n for n in end if n.endswith(("running_mean", "running_var"))]
    return Report(first=float(np.mean(losses[:8])), last=float(np.mean(losses[-8:])),
                  finite=bool(np.isfinite(losses).all()), map=float(np.mean(ap)), ap=ap,
                  frozen=len(frozen), frozen_ok=all(torch.equal(end[n], start[n]) for n in frozen),
                  stats=len(stats), moved_stats=sum(not torch.equal(end[n], start[n]) for n in stats),
                  head_moved=not torch.equal(end["fc_audioset.weight"], start["fc_audioset.weight"]))
