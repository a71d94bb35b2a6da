# Copied unchanged from clipcap_tpu/eval/meteor.py (standard library only): the port keeps its own copy.
"""METEOR (exact + Porter-stem + synonym matching stages).

The reference scores METEOR through pycocoevalcap's Java meteor-1.5 jar
(reference utils/scoring.py:12). This is a JVM-free Python implementation
of the METEOR algorithm with the standard en parameters
(alpha=0.85, beta=0.2, gamma=0.6 — the meteor-1.5 defaults) and the
exact / stem / synonym matching stages with meteor-1.5's en module
weights (1.0 / 0.6 / 0.8).

The synonym stage matches meteor-1.5's WordNet synonymy through
eval/synonyms.py: full WordNet when nltk's corpus is installed, a
vendored caption-domain synonym table otherwise (DOCUMENTED + QUANTIFIED
DEVIATION: offline, synonym pairs outside the vendored table score as
non-matches. Measured bound: one missed pair on a 9-word caption lowers
that caption's METEOR by 0.1087 (= one alignment slot falling from the
0.8-weight synonym stage to unmatched); corpus-level impact scales with
the fraction of captions whose alignment hinges on an out-of-table pair.
tests/test_eval_metrics.py::test_meteor_offline_synonym_deviation_is_bounded
freezes the bound at 0.11 per missed pair; scores move monotonically with
match quality either way).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .synonyms import SynonymTable, default_table

ALPHA, BETA, GAMMA = 0.85, 0.2, 0.6
W_EXACT, W_STEM, W_SYN = 1.0, 0.6, 0.8  # meteor-1.5 en module weights

try:
    from nltk.stem.porter import PorterStemmer

    _STEMMER: Optional[PorterStemmer] = PorterStemmer()
except Exception:  # pragma: no cover - nltk is in the image
    _STEMMER = None


def _stem(w: str) -> str:
    return _STEMMER.stem(w) if _STEMMER is not None else w


def _align(
    hyp: List[str], ref: List[str], syn: SynonymTable
) -> Tuple[float, int, int]:
    """Greedy staged alignment (exact, then stem, then synonym).

    Returns (weighted_matches, n_matches, chunks). Content/function-word
    weighting is omitted (uniform word weight), matching meteor's behavior
    with an empty function-word list.
    """
    m_hyp = [-1] * len(hyp)
    w_hyp = [0.0] * len(hyp)
    used_ref = [False] * len(ref)

    def run_stage(match, weight):
        for i, hw in enumerate(hyp):
            if m_hyp[i] >= 0:
                continue
            for j, rw in enumerate(ref):
                if not used_ref[j] and match(hw, rw):
                    m_hyp[i] = j
                    w_hyp[i] = weight
                    used_ref[j] = True
                    break

    run_stage(lambda a, b: a == b, W_EXACT)
    run_stage(lambda a, b: _stem(a) == _stem(b), W_STEM)
    run_stage(syn.are_synonyms, W_SYN)

    n_matches = sum(1 for j in m_hyp if j >= 0)
    weighted = sum(w_hyp)
    # chunks: maximal runs of adjacent matches aligned to adjacent ref pos
    chunks = 0
    prev_j = None
    for j in m_hyp:
        if j < 0:
            prev_j = None
            continue
        if prev_j is None or j != prev_j + 1:
            chunks += 1
        prev_j = j
    return weighted, n_matches, chunks


def _sentence_meteor(hyp: List[str], ref: List[str], syn: SynonymTable) -> float:
    if not hyp or not ref:
        return 0.0
    weighted, matches, chunks = _align(hyp, ref, syn)
    if matches == 0:
        return 0.0
    precision = weighted / len(hyp)
    recall = weighted / len(ref)
    fmean = precision * recall / (ALPHA * precision + (1 - ALPHA) * recall)
    frag = chunks / matches
    penalty = GAMMA * (frag**BETA)
    return (1 - penalty) * fmean


def meteor(
    gts: Dict[object, List[str]],
    res: Dict[object, List[str]],
    synonym_table: Optional[SynonymTable] = None,
) -> Tuple[float, List[float]]:
    """Max over references per image; corpus score = mean of image scores."""
    assert gts.keys() == res.keys()
    syn = synonym_table if synonym_table is not None else default_table()
    scores = []
    for img_id in gts:
        hyp = res[img_id][0].split()
        scores.append(max(_sentence_meteor(hyp, r.split(), syn) for r in gts[img_id]))
    return sum(scores) / max(len(scores), 1), scores
