# Copied unchanged from clipcap_tpu/eval/scoring.py (standard library only): the port keeps its own copy.
"""generate_scores — the reference's scoring entry points.

Two variants, mirroring the reference exactly:
- generate_scores (evaluate_model.py:27-63): PTB tokenize -> Bleu 1-4 +
  CIDEr, returning (corpus dict, per-image dict);
- generate_scores_full (utils/scoring.py:4-40): additionally METEOR,
  ROUGE_L and SPICE (the latter via eval/spice.py's Python approximation
  of the Java scene-graph pipeline — see its documented deviation).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .bleu import bleu
from .cider import cider_d
from .meteor import meteor
from .ptb_tokenizer import ptb_tokenize
from .rouge import rouge_l


def _run(gts, res, scorers) -> Tuple[Dict, Dict]:
    gts_tok = ptb_tokenize(gts)
    res_tok = ptb_tokenize(res)

    output: Dict[str, float] = {}
    img_output: Dict[object, Dict[str, float]] = {}
    img_ids = list(gts_tok.keys())

    for scorer, names in scorers:
        score, per_image = scorer(gts_tok, res_tok)
        if not isinstance(names, list):
            names, score, per_image = [names], [score], [per_image]
        for sc, scs, name in zip(score, per_image, names):
            output[name] = sc
            for img_id, s in zip(img_ids, scs):
                img_output.setdefault(img_id, {})[name] = s
    return output, img_output


def generate_scores(gts: Dict, res: Dict) -> Tuple[Dict, Dict]:
    """Bleu_1-4 + CIDEr (reference evaluate_model.py:27-63).

    gts/res: {image_id: [{"caption": str}, ...]} (res: one caption each).
    """
    scorers = [
        (lambda g, r: bleu(g, r), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
        (lambda g, r: cider_d(g, r), "CIDEr"),
    ]
    return _run(gts, res, scorers)


def generate_scores_full(gts: Dict, res: Dict, include_spice: bool = True) -> Tuple[Dict, Dict]:
    """Bleu + METEOR + ROUGE_L + CIDEr + SPICE (reference utils/scoring.py:4-40).

    SPICE is scored by eval/spice.py — a Python approximation of the
    reference's Java pipeline (rule-based tuple extraction in place of
    the Stanford-CoreNLP scene-graph parser, same F1-over-tuples scoring
    model with synonym matching; eval/spice.py's docstring states the
    deviation). Pass include_spice=False to skip it.
    """
    from .spice import spice

    scorers = [
        (lambda g, r: bleu(g, r), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
        (lambda g, r: meteor(g, r), "METEOR"),
        (lambda g, r: rouge_l(g, r), "ROUGE_L"),
        (lambda g, r: cider_d(g, r), "CIDEr"),
    ]
    if include_spice:
        scorers.append((lambda g, r: spice(g, r), "SPICE"))
    return _run(gts, res, scorers)
