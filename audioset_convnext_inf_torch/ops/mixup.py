"""Mixup for multi-label audio tagging.

The reference's paired-batch convention (pytorch_utils.py:20-36,
utilities.py:251-270): a batch of 2B clips mixes pairwise, even index with
odd index, into B clips with lambda ~ Beta(alpha, alpha); the targets mix
the same way.
"""

from __future__ import annotations

import numpy as np
import torch


def get_mixup_lambda(generator: torch.Generator, batch_size: int, alpha: float) -> torch.Tensor:
    """(batch_size,) f32 lambdas in pairs (lam, 1 - lam), lam ~ Beta(alpha,
    alpha). The Beta draws come from a numpy stream seeded from
    ``generator`` (torch has no seeded Beta sampler)."""
    seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
    lam = np.random.default_rng(seed).beta(alpha, alpha, batch_size // 2).astype(np.float32)
    return mixup_pairs(torch.from_numpy(lam))


def mixup_pairs(lam: torch.Tensor) -> torch.Tensor:
    """(B,) draws -> (2B,) lambdas (lam_0, 1 - lam_0, lam_1, 1 - lam_1, ...)."""
    return torch.stack([lam, 1.0 - lam], dim=1).reshape(-1)


def do_mixup(x: torch.Tensor, mixup_lambda: torch.Tensor) -> torch.Tensor:
    """(2B, ...) -> (B, ...): x[0::2] * lam[0::2] + x[1::2] * lam[1::2], in x's dtype."""
    lam = mixup_lambda.to(device=x.device, dtype=x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    return x[0::2] * lam[0::2] + x[1::2] * lam[1::2]
