"""Seeded audio: pools of distinct int16 clips and multi-hot targets.

Every clip is 10 s of 32-kHz mono int16: white noise shaped by a two-tap
filter (a tilt of the spectrum that varies from clip to clip) under a
loudness envelope of 100-ms segments spanning 40 dB, so the frontend and
the trunk see loud and quiet stretches. A pool is drawn in a few large
calls on the device and copied to host memory once; the same seed on the
same kind of device gives the same clips.
"""

from __future__ import annotations

import numpy as np
import torch

SEGMENT = 3200  # 100 ms


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for each named use of a run's seed."""
    words = [ord(ch) for ch in stream]
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64] + words))


def torch_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for a torch generator, one per named use of a run's seed."""
    return int(rng(seed, stream).integers(0, 2**63 - 1))


def pool(seed: int, n: int, samples: int, device="cpu", stream: str = "clips") -> np.ndarray:
    """(n, samples) int16 clips in host memory."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, stream))
    seg = -(-samples // SEGMENT)
    z = torch.randn(n, samples + 1, generator=g, device=device)
    a = torch.rand(n, 1, generator=g, device=device) * 1.8 - 0.9
    gain_db = torch.rand(n, seg, generator=g, device=device) * 40.0 - 40.0
    level = (3000.0 * torch.pow(10.0, gain_db / 20.0)).repeat_interleave(SEGMENT, dim=1)
    y = (z[:, 1:] + a * z[:, :-1]) * level[:, :samples]
    out = y.clamp_(-32767, 32767).round_().to(torch.int16).cpu().numpy()
    del z, y, level
    return out


def targets(seed: int, n: int, classes: int, stream: str = "targets") -> np.ndarray:
    """(n, classes) float32 multi-hot labels, 1 to 3 positives per clip."""
    g = rng(seed, stream)
    out = np.zeros((n, classes), np.float32)
    for i in range(n):
        out[i, g.choice(classes, size=int(g.integers(1, 4)), replace=False)] = 1.0
    return out

