# Copied unchanged from clipcap_tpu/eval/cider.py (standard library only): the port keeps its own copy.
"""CIDEr-D, pycocoevalcap conventions (n=1..4, sigma=6).

Self-contained implementation of the Cider scorer the reference uses via
pycocoevalcap (reference evaluate_model.py:38, utils/scoring.py:14):
tf-idf n-gram vectors with corpus document frequency over the reference
sets, candidate-count clipping in the numerator, the Gaussian length
penalty exp(-(lh-lr)^2 / (2 sigma^2)), a x10 scale, and the mean over
n-gram orders.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

N_MAX = 4
SIGMA = 6.0


def _ngram_counts(tokens: List[str]) -> List[Counter]:
    return [
        Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))
        for n in range(1, N_MAX + 1)
    ]


def cider_d(
    gts: Dict[object, List[str]],
    res: Dict[object, List[str]],
) -> Tuple[float, List[float]]:
    """gts/res: {image_id: [tokenized caption strings]} (res: 1 per image).
    Returns (corpus mean score, per-image scores in gts key order)."""
    assert gts.keys() == res.keys()
    img_ids = list(gts.keys())

    # document frequency over reference sets
    doc_freq = defaultdict(float)
    ref_counts = {}
    for img_id in img_ids:
        counts = [_ngram_counts(r.split()) for r in gts[img_id]]
        ref_counts[img_id] = counts
        seen = set()
        for c in counts:
            for n in range(N_MAX):
                seen.update(c[n].keys())
        for ng in seen:
            doc_freq[ng] += 1

    log_n_images = math.log(max(len(img_ids), 1e-12))

    def vec_and_norm(counts: List[Counter]):
        vec = [dict() for _ in range(N_MAX)]
        norm = [0.0] * N_MAX
        length = 0
        for n in range(N_MAX):
            for ng, tf in counts[n].items():
                idf = log_n_images - math.log(max(1.0, doc_freq[ng]))
                v = tf * idf
                vec[n][ng] = v
                norm[n] += v * v
                if n == 0:
                    length += tf
            norm[n] = math.sqrt(norm[n])
        return vec, norm, length

    scores = []
    for img_id in img_ids:
        hyp_counts = _ngram_counts(res[img_id][0].split())
        v_hyp, n_hyp, len_hyp = vec_and_norm(hyp_counts)

        score_n = [0.0] * N_MAX
        for counts in ref_counts[img_id]:
            v_ref, n_ref, len_ref = vec_and_norm(counts)
            delta = float(len_hyp - len_ref)
            for n in range(N_MAX):
                s = 0.0
                for ng, v in v_hyp[n].items():
                    # CIDEr-D: clip the candidate tf-idf to the reference's
                    s += min(v, v_ref[n].get(ng, 0.0)) * v_ref[n].get(ng, 0.0)
                if n_hyp[n] > 0 and n_ref[n] > 0:
                    s /= n_hyp[n] * n_ref[n]
                s *= math.exp(-(delta**2) / (2 * SIGMA**2))
                score_n[n] += s

        m = len(ref_counts[img_id])
        img_score = sum(10.0 * s / m for s in score_n) / N_MAX
        scores.append(img_score)

    corpus = sum(scores) / max(len(scores), 1)
    return corpus, scores
