"""Open-loop arrival schedules and the latency arithmetic of the serve cells.

NumPy and the standard library only: client processes import it without
torch.

A Poisson schedule at ``rate`` over ``seconds`` has n = round(rate *
seconds) requests. Its gaps are the exponential distribution's quantiles
at (i + 1/2) / n, in an order drawn from the seed, scaled so that the
schedule spans the window: every seed offers the same set of gaps, so
seeds differ in the order of arrivals and not in the load. Request i
sends clip ``clips[i]`` of the pool (a seeded permutation, cycled).

Latency is timed from each request's due time on the schedule to the
client's receipt of its answer, so a stall also delays the requests due
behind it; a request that failed, was refused or timed out counts at the
timeout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Schedule(NamedTuple):
    due: np.ndarray    # (n,) seconds after the window opens, increasing
    clips: np.ndarray  # (n,) pool index each request sends


def _rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64] + [ord(c) for c in stream]))


def poisson(seed: int, rate: float, seconds: float, pool: int) -> Schedule:
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    g = _rng(seed, "arrivals")
    gaps = g.permutation(gaps)
    due = np.cumsum(gaps) - gaps[0]  # the first request is due when the window opens
    due *= seconds * (n - 1) / n / max(due[-1], 1e-12) if n > 1 else 0.0
    reps = -(-n // pool)
    order = np.concatenate([g.permutation(pool) for _ in range(reps)])[:n]
    return Schedule(due, order)


def latencies(due: np.ndarray, received: np.ndarray, ok: np.ndarray,
              timeout: float) -> np.ndarray:
    """Seconds from due time to receipt; failures count at ``timeout``."""
    lat = np.where(ok, received - due, timeout)
    return np.minimum(lat, timeout)


def p95(values: np.ndarray) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))
