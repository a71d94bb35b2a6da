"""Multi-stage ranking cascades: a copy of clipcap_tpu/rank/cascade.py
(host-side numpy over any scorer).

- two_stage_rank: a ViT-L/14 shortlist (top-k) re-ranked by a second model
  (reference sampling.py:436-479, blip_coco_val_sample_sweep.py:45-88
  RankingModel.rank: stage1 top-5, stage2 argmax);
- threshold_cascade: the 4-filter synthetic-caption cascade of
  multi_filter.py:158-191: each stage keeps the captions scoring above its
  threshold, falling back to the top 10% (at least one) when none pass.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import numpy as np

Scorer = Callable[[Sequence[str]], List[float]]


def two_stage_rank(
    captions: Sequence[str],
    stage1: Scorer,
    stage2: Scorer,
    shortlist: int = 5,
    top_n: int = 3,
) -> List[Tuple[str, float]]:
    """stage1 over all candidates -> top `shortlist` -> stage2 re-rank ->
    best `top_n` as (caption, stage2_score), best first."""
    if not captions:
        return []
    s1 = np.asarray(stage1(captions))
    short_idx = np.argsort(s1)[-shortlist:][::-1]
    short = [captions[i] for i in short_idx]
    s2 = np.asarray(stage2(short))
    order = np.argsort(s2)[::-1][:top_n]
    return [(short[i], float(s2[i])) for i in order]


def threshold_cascade(
    captions: Sequence[str],
    stages: Sequence[Tuple[Scorer, float]],
    fallback_fraction: float = 0.1,
) -> List[str]:
    """Sequential threshold filters with top-fraction fallback.

    For each (scorer, threshold): keep captions with score > threshold; if
    none pass, keep the top `fallback_fraction` (>= 1) by score — the
    multi_filter.py:158-191 behavior.
    """
    remaining = list(captions)
    for scorer, threshold in stages:
        if not remaining:
            break
        scores = np.asarray(scorer(remaining))
        keep = [c for c, s in zip(remaining, scores) if s > threshold]
        if not keep:
            n = max(1, math.ceil(len(remaining) * fallback_fraction))
            top = np.argsort(scores)[-n:][::-1]
            keep = [remaining[i] for i in top]
        remaining = keep
    return remaining
