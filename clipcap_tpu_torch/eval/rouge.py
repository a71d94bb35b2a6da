# Copied unchanged from clipcap_tpu/eval/rouge.py (standard library only): the port keeps its own copy.
"""ROUGE-L, pycocoevalcap conventions (beta = 1.2, max over references).

Used by the full scoring suite (reference utils/scoring.py:13).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

BETA = 1.2


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def _f_lcs(hyp: List[str], ref: List[str]) -> float:
    lcs = _lcs_len(hyp, ref)
    if lcs == 0:
        return 0.0
    prec = lcs / len(hyp)
    rec = lcs / len(ref)
    return ((1 + BETA**2) * prec * rec) / (rec + BETA**2 * prec)


def rouge_l(
    gts: Dict[object, List[str]], res: Dict[object, List[str]]
) -> Tuple[float, List[float]]:
    assert gts.keys() == res.keys()
    scores = []
    for img_id in gts:
        hyp = res[img_id][0].split()
        scores.append(max(_f_lcs(hyp, r.split()) for r in gts[img_id]))
    return sum(scores) / max(len(scores), 1), scores
