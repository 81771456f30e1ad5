"""The training recipe's random draws, worked out again from (seed, step).

The program draws each step's mixup weights, SpecAugment stripes and
drop-path scales from one CPU ``torch.Generator`` seeded with
``(seed << 32) | step``, in this order: one ``randint`` that seeds a NumPy
Beta(alpha, alpha) draw of the mixup weights; time stripes (widths, then
positions) and frequency stripes for the 2B clips; then, for each block
with a drop-path rate above 0 (rates ``linspace(0, drop_path_rate,
blocks)``), B uniforms, kept where below 1 - rate and scaled by
1 / (1 - rate). Data-parallel ranks on the fused route draw the drop path
of their rows from a stream of their own instead. This module follows the
same recipe so that the reference sees the draws the program saw, without
taking them from the program.
"""

from __future__ import annotations

import numpy as np
import torch


def step_generator(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))


def step_draws(seed: int, step: int, clips: int, mcfg: dict, alpha: float,
               ranks: int = 1) -> dict:
    """The draws of one step on ``clips`` (2B) clips: ``lam`` (2B,),
    ``time`` and ``freq`` (widths, u) of shape (2B, stripes), ``drop`` a
    list with a (B,) scale or None per block. With ``ranks`` data-parallel
    processes on the fused route, each rank draws the drop path of its own
    contiguous rows from its own stream (``rank_generator``)."""
    gen = step_generator(seed, step)
    lam_seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
    lam = np.random.default_rng(lam_seed).beta(alpha, alpha, clips // 2).astype(np.float32)
    lam = torch.from_numpy(lam)
    lam = torch.stack([lam, 1.0 - lam], dim=1).reshape(-1)
    sa = mcfg["spec_augment"]
    stripes = []
    for width, count in ((sa["time_drop_width"], sa["time_stripes_num"]),
                         (sa["freq_drop_width"], sa["freq_stripes_num"])):
        widths = torch.randint(0, width, (clips, count), generator=gen)
        u = torch.rand(clips, count, generator=gen)
        stripes.append((widths, u))
    if ranks == 1:
        drop = drop_scales(gen, clips // 2, mcfg)
    else:  # each rank's own stream for its rows
        per = [drop_scales(rank_generator(seed, step, r), clips // 2 // ranks, mcfg)
               for r in range(ranks)]
        drop = [None if d[0] is None else torch.cat(d) for d in zip(*per)]
    return {"lam": lam, "time": stripes[0], "freq": stripes[1], "drop": drop}


def drop_scales(gen: torch.Generator, rows: int, mcfg: dict) -> list:
    """One (rows,) drop-path scale per block, None where the rate is 0."""
    drop = []
    for rate in np.linspace(0.0, mcfg["drop_path_rate"], sum(mcfg["depths"])):
        rate = float(rate)
        if rate == 0.0:
            drop.append(None)
            continue
        keep = torch.rand(rows, generator=gen) < 1.0 - rate
        drop.append(keep.float() / (1.0 - rate))
    return drop


def rank_generator(seed: int, step: int, rank: int) -> torch.Generator:
    """A data-parallel rank's own stream for the step, from (seed, step, rank)."""
    words = np.random.SeedSequence([seed & 0xFFFFFFFF, step & 0xFFFFFFFF, rank]).generate_state(2)
    return torch.Generator().manual_seed((int(words[0]) << 31) ^ int(words[1]))
