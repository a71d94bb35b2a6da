# Copied unchanged from clipcap_tpu/eval/ptb_tokenizer.py (standard library only): the port keeps its own copy.
"""PTB-style caption tokenization, pure Python.

The reference scores through pycocoevalcap's PTBTokenizer, which shells
out to the Stanford PTBTokenizer *Java jar* with -preserveLines -lowerCase
and then drops a fixed punctuation list (reference utils/scoring.py:1-7,
evaluate_model.py:28-31). This module reimplements that pipeline in
Python so scoring needs no JVM:

1. Penn-Treebank word tokenization (contraction splitting: don't ->
   do n't, cannot -> can not, 'll/'re/'ve/n't/'s splits; quote conversion
   to ``/''; punctuation separation; ellipsis "...").
2. lowercasing,
3. removal of pycocoevalcap's PUNCTUATIONS list.

For the alphanumeric caption text that survives step 3, this matches the
jar's output on standard COCO-style captions.
"""

from __future__ import annotations

import re
from typing import Dict, List

# pycocoevalcap/tokenizer/ptbtokenizer.py PUNCTUATIONS
PUNCTUATIONS = [
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
]
_PUNCT_SET = set(PUNCTUATIONS)

_CONTRACTIONS2 = [
    (re.compile(r"\b(can)(not)\b", re.I), r"\1 \2"),
    (re.compile(r"\b(d)('ye)\b", re.I), r"\1 \2"),
    (re.compile(r"\b(gim)(me)\b", re.I), r"\1 \2"),
    (re.compile(r"\b(gon)(na)\b", re.I), r"\1 \2"),
    (re.compile(r"\b(got)(ta)\b", re.I), r"\1 \2"),
    (re.compile(r"\b(lem)(me)\b", re.I), r"\1 \2"),
    (re.compile(r"\b(wan)(na)\b", re.I), r"\1 \2"),
]


def _ptb_word_tokenize(text: str) -> List[str]:
    """Penn-Treebank tokenization (the sed-script lineage)."""
    # directional quotes
    text = re.sub(r"^\"", "`` ", text)
    text = re.sub(r'([ (\[{<])"', r"\1 `` ", text)
    text = re.sub(r"\.\.\.", " ... ", text)
    text = re.sub(r"[;@#$%&]", r" \g<0> ", text)
    # final period (sentence end), keeps abbreviations' internal dots
    text = re.sub(r"([^\.])(\.)([\]\)}>\"']*)\s*$", r"\1 \2\3 ", text)
    text = re.sub(r"[?!]", r" \g<0> ", text)
    text = re.sub(r"[,]", r" \g<0> ", text)
    text = re.sub(r"[\]\[\(\)\{\}<>]", r" \g<0> ", text)
    text = re.sub(r"--", " -- ", text)
    text = re.sub(r'"', " '' ", text)
    text = re.sub(r"([^'])' ", r"\1 ' ", text + " ")
    # standard contraction splits
    text = re.sub(r"'([sSmMdD]) ", r" '\1 ", text)
    text = re.sub(r"('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) ", r" \1 ", text)
    for pat, repl in _CONTRACTIONS2:
        text = pat.sub(repl, text)
    return text.split()


def ptb_tokenize_caption(caption: str) -> str:
    toks = [t.lower() for t in _ptb_word_tokenize(caption.strip())]
    return " ".join(t for t in toks if t not in _PUNCT_SET)


def ptb_tokenize(captions: Dict) -> Dict[object, List[str]]:
    """pycocoevalcap PTBTokenizer.tokenize interface:
    {image_id: [{"caption": str}, ...]} -> {image_id: [tokenized_str, ...]}."""
    return {
        img_id: [ptb_tokenize_caption(c["caption"]) for c in caps]
        for img_id, caps in captions.items()
    }
