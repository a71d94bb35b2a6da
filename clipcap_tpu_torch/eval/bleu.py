# Copied unchanged from clipcap_tpu/eval/bleu.py (standard library only): the port keeps its own copy.
"""Corpus BLEU 1-4, pycocoevalcap conventions.

Self-contained implementation of the BLEU scorer the reference uses via
pycocoevalcap (reference evaluate_model.py:34, utils/scoring.py:11):
clipped n-gram precision accumulated over the corpus, the "closest"
effective reference length, the exp(1 - 1/ratio) brevity penalty, and the
same tiny/small smoothing constants, so scores are numerically comparable
with the reference pipeline's.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

TINY = 1e-15
SMALL = 1e-9


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu(
    gts: Dict[object, List[str]],
    res: Dict[object, List[str]],
    n_max: int = 4,
) -> Tuple[List[float], List[List[float]]]:
    """gts/res: {image_id: [tokenized caption strings]}; res has 1 per image.

    Returns (corpus [Bleu_1..Bleu_n], per-image scores list-of-lists).
    Per-image scores follow pycocoevalcap: computed with the corpus-level
    running statistics frozen per image ("ratio" uses the image's own
    lengths, precision uses the image's own counts).
    """
    assert gts.keys() == res.keys()
    total_correct = [0] * n_max
    total_guess = [0] * n_max
    total_hyp_len = 0
    total_ref_len = 0
    per_image: List[List[float]] = [[] for _ in range(n_max)]

    img_ids = list(gts.keys())
    for img_id in img_ids:
        hyp = res[img_id][0].split()
        refs = [r.split() for r in gts[img_id]]
        hyp_len = len(hyp)
        # closest reference length (ties -> shorter, per bleu_scorer.py)
        ref_len = min((abs(len(r) - hyp_len), len(r)) for r in refs)[1]
        total_hyp_len += hyp_len
        total_ref_len += ref_len

        correct_k = []
        guess_k = []
        for k in range(1, n_max + 1):
            hyp_counts = _ngrams(hyp, k)
            max_ref = Counter()
            for r in refs:
                for ng, c in _ngrams(r, k).items():
                    max_ref[ng] = max(max_ref[ng], c)
            correct = sum(min(c, max_ref[ng]) for ng, c in hyp_counts.items())
            guess = max(0, hyp_len - k + 1)
            correct_k.append(correct)
            guess_k.append(guess)
            total_correct[k - 1] += correct
            total_guess[k - 1] += guess

        # per-image bleu with its own stats
        ratio = hyp_len / (ref_len + TINY)
        img_bleu = 1.0
        for k in range(n_max):
            img_bleu *= (correct_k[k] + TINY) / (guess_k[k] + SMALL)
            val = img_bleu ** (1.0 / (k + 1))
            if 0 < ratio < 1:
                val *= pow(2.718281828459045, 1 - 1 / ratio)
            elif ratio <= 0:  # empty hypothesis
                val = 0.0
            per_image[k].append(val)

    ratio = total_hyp_len / (total_ref_len + TINY)
    corpus = []
    running = 1.0
    for k in range(n_max):
        running *= (total_correct[k] + TINY) / (total_guess[k] + SMALL)
        val = running ** (1.0 / (k + 1))
        if 0 < ratio < 1:
            val *= pow(2.718281828459045, 1 - 1 / ratio)
        elif ratio <= 0:
            val = 0.0
        corpus.append(val)
    return corpus, per_image
