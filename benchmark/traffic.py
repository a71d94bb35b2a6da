"""The traffic generator: per-request caps and arrival schedules drawn from
a mix's parameters and the run's seed.

The cap distribution and the serving settings are frozen copies of
clipcap_tpu_torch/tools/serving_latency_curve.py (`request_caps`, its
PREFIX_LEN, MAX_NEW, EOS, STOP, top-p 0.8 and penalty 1.2), which follow
bench.py's `_bench_serving`. Every seed serves the same multiset of caps
in another order, so a seed changes the order of the work and not its
amount.
"""

from __future__ import annotations

import numpy as np


def base_caps(n: int, mean: float, std: float, lo: int, hi: int) -> np.ndarray:
    """The curve's natural-EOS caption lengths clip(round(N(mean, std)), lo,
    hi) from numpy's default_rng(0): the same n caps for every seed."""
    rng = np.random.default_rng(0)
    return np.clip(np.round(rng.normal(mean, std, n)), lo, hi).astype(np.int64)


def seeded_caps(mix: dict, seed: int) -> np.ndarray:
    """The mix's caps, permuted by the seed."""
    c = mix["caps"]
    caps = base_caps(c["pool"], c["mean"], c["std"], c["min"], c["max"])
    return np.random.default_rng(seed).permutation(caps)


def poisson_arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Arrival offsets in seconds over [0, seconds): round(rate * seconds)
    exponential gaps drawn once from default_rng(0), scaled to fill the
    window, in an order drawn from the seed. Every seed gets the same gaps,
    so the same count and the same bursts, at other times."""
    n = int(round(rate * seconds))
    gaps = np.random.default_rng(0).exponential(1.0, n + 1)
    gaps = gaps / gaps.sum() * seconds
    gaps = np.random.default_rng([seed, 1]).permutation(gaps)
    return np.cumsum(gaps)[:-1]
