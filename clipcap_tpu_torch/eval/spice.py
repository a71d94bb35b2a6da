# Copied unchanged from clipcap_tpu/eval/spice.py (standard library only): the port keeps its own copy.
"""SPICE-approx: semantic propositional caption scoring without Java.

The reference scores SPICE through pycocoevalcap's Java pipeline
(reference utils/scoring.py:1,15): Stanford-CoreNLP dependency parses are
rewritten into scene graphs (objects, attributes, relations) and the
candidate/reference graphs are F1-scored with WordNet synonym matching
(Anderson et al. 2016). Neither the CoreNLP parser nor the WordNet corpus
exists in this environment, so this module implements the same SCORING
MODEL over tuples produced by a rule-based chunker:

- tuple extraction: a closed-class lexicon (determiners, prepositions,
  copulas, auxiliaries, conjunctions, pronouns) plus a caption-domain
  verb list with -s/-ing/-ed morphology segments each caption into noun
  phrases and connectives. NP head = last token of the run; non-determiner
  tokens before the head become attribute tuples; "NP verb NP",
  "NP [be] prep NP" and "NP verb prep NP" patterns become relation
  tuples; "NP be ADJ" becomes an attribute.
- matching: two tuples match when every element matches exactly, by
  Porter stem, or through the synonym table (eval/synonyms.py — the same
  table METEOR's synonym stage uses; full WordNet drops in when nltk's
  corpus is installed).
- score: per image, F1 between the candidate tuple set and the UNION of
  the reference tuple sets (the SPICE paper's definition); corpus score
  is the mean of image F1s.

DOCUMENTED DEVIATION vs Java SPICE: extraction is pattern-based, not a
dependency parse — long-range attachments (relative clauses, conjunction
scope, PP-attachment ambiguity) can produce different tuples than
CoreNLP. On the simple declarative sentences that dominate COCO-style
captions (det-adj-noun phrases joined by verbs/prepositions) the patterns
recover the same tuples; tests/test_eval_metrics.py pins extraction on a
fixture set plus the scoring-model invariants (perfect match = 1.0,
disjoint = 0.0, monotone in matched tuples). Treat absolute values as a
SPICE approximation; deltas between models scored with the same extractor
are the meaningful quantity.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .synonyms import SynonymTable, default_table

try:
    from nltk.stem.porter import PorterStemmer

    _STEMMER: Optional[PorterStemmer] = PorterStemmer()
except Exception:  # pragma: no cover - nltk is in the image
    _STEMMER = None

DETS = {"a", "an", "the", "this", "that", "these", "those", "some", "any",
        "each", "every", "no", "its", "his", "her", "their", "my", "your",
        "our", "another", "other", "both", "few", "many", "several", "all",
        "two", "three", "four", "five", "six", "seven", "eight", "nine",
        "ten", "couple", "group"}
PREPS = {"in", "on", "at", "with", "near", "under", "over", "behind",
         "beside", "by", "of", "for", "to", "from", "across", "against",
         "along", "around", "above", "below", "during", "inside", "outside",
         "onto", "upon", "between", "through", "beneath", "towards",
         "toward", "atop", "amid", "among", "off", "down", "up", "into",
         "next"}
COPULAS = {"is", "are", "was", "were", "be", "being", "been", "looks",
           "appears", "seems"}
AUX = {"has", "have", "had", "do", "does", "did", "can", "could", "will",
       "would", "may", "might", "shall", "should", "must"}
CONJ = {"and", "or", "but", "while", "as", "that", "which", "who", "where"}
PRONOUNS = {"it", "he", "she", "they", "them", "him", "i", "we", "you",
            "there", "something", "someone"}
PUNCT = {".", ",", ";", ":", "!", "?", "'", '"', "``", "''", "-"}

# caption-domain verbs (base forms); morphology adds -s/-ing/-ed variants
_VERB_BASES = {
    "ride", "sit", "stand", "hold", "walk", "play", "eat", "jump", "run",
    "fly", "look", "wear", "drive", "sleep", "catch", "throw", "surf",
    "ski", "park", "hang", "lay", "lie", "wait", "watch", "talk", "smile",
    "swing", "feed", "cut", "cover", "carry", "pull", "push", "climb",
    "swim", "read", "write", "cook", "serve", "pose", "perform", "lean",
    "rest", "graze", "gather", "race", "travel", "move", "cross", "face",
    "use", "make", "take", "give", "get", "go", "come", "reach", "point",
    "open", "close", "fill", "top", "decorate", "attach", "display",
    "show", "contain", "include", "feature", "overlook",
}
# -ing forms that are really nouns in captions
_ING_NOUNS = {"building", "painting", "ceiling", "clothing", "living",
              "dining", "lightning", "morning", "evening", "wedding"}


def _verb_forms() -> Set[str]:
    forms = set()
    for v in _VERB_BASES:
        forms.add(v)
        forms.add(v + "s")
        forms.add(v + "es")
        if v.endswith("e"):
            forms.add(v[:-1] + "ing")
            forms.add(v + "d")
        else:
            forms.add(v + "ing")
            forms.add(v + v[-1] + "ing")  # sit -> sitting
            forms.add(v + "ed")
            forms.add(v + v[-1] + "ed")
    return forms - _ING_NOUNS


_VERBS = _verb_forms()


def _is_verb(w: str) -> bool:
    if w in _VERBS:
        return True
    return w.endswith("ing") and w not in _ING_NOUNS and len(w) > 5


def _stem(w: str) -> str:
    return _STEMMER.stem(w) if _STEMMER is not None else w


Tuple3 = Tuple[str, ...]


def extract_tuples(caption: str) -> FrozenSet[Tuple3]:
    """Scene-graph tuples of a (PTB-tokenized, lowercased) caption:
    ('obj',), ('obj', 'attr'), ('obj1', 'rel', 'obj2')."""
    words = [w for w in caption.lower().split() if w not in PUNCT]

    # segment into NPs and connectives
    segs: List[Tuple[str, object]] = []  # ("np", [tokens]) | ("verb"/"prep"/"cop", word)
    cur: List[str] = []

    def flush():
        nonlocal cur
        if cur:
            segs.append(("np", cur))
            cur = []

    for idx, w in enumerate(words):
        # noun/verb ambiguity for BASE forms ("the park" vs "dogs play"):
        # read as a noun right after a determiner, or sentence-finally
        # inside a determined NP ("relaxing in a big park")
        noun_reading = bool(cur) and (
            cur[-1] in DETS
            or (idx == len(words) - 1 and any(t in DETS for t in cur))
        )
        if w in PREPS:
            flush()
            segs.append(("prep", w))
        elif w in COPULAS:
            flush()
            segs.append(("cop", w))
        elif _is_verb(w) and not (w in _VERB_BASES and noun_reading):
            flush()
            segs.append(("verb", w))
        elif w in CONJ:
            flush()
            segs.append(("conj", w))
        elif w in AUX or w in PRONOUNS:
            flush()
        else:
            cur.append(w)
    flush()

    def np_parts(tokens: Sequence[str]) -> Tuple[Optional[str], List[str]]:
        content = [t for t in tokens if t not in DETS]
        if not content:
            return None, []
        return content[-1], content[:-1]

    def head_of(idx: int) -> Optional[str]:
        if 0 <= idx < len(segs) and segs[idx][0] == "np":
            return np_parts(segs[idx][1])[0]
        return None

    # predicate-adjective NPs ("the car is red"): a single-content-word NP
    # right after a copula with nothing attaching behind it describes the
    # subject — emit (subject, word) instead of a spurious object ('red',)
    pred_adj: Dict[int, str] = {}  # seg index -> subject head
    for i, (kind, val) in enumerate(segs):
        if (kind == "np" and i >= 2 and segs[i - 1][0] == "cop"
                and segs[i - 2][0] == "np" and i == len(segs) - 1
                and len([t for t in val if t not in DETS]) == 1):
            subj = head_of(i - 2)
            if subj:
                pred_adj[i] = subj

    tuples: Set[Tuple3] = set()
    for i, (kind, val) in enumerate(segs):
        if kind != "np":
            continue
        head, attrs = np_parts(val)
        if head is None:
            continue
        if i in pred_adj:
            tuples.add((pred_adj[i], head))
            continue
        tuples.add((head,))
        for a in attrs:
            tuples.add((head, a))

    # relation patterns over the segment sequence
    i = 0
    while i < len(segs):
        kind, val = segs[i]
        if kind == "np":
            h1 = head_of(i)
            j = i + 1
            if j < len(segs) and segs[j][0] == "cop":
                j += 1  # progressive / predicate: "is sitting", "is on"
            # NP [cop] verb [prep] NP   /   NP [cop] verb (intransitive)
            if j < len(segs) and segs[j][0] == "verb" and h1:
                verb = segs[j][1]
                if j + 1 < len(segs) and segs[j + 1][0] == "np":
                    h2 = head_of(j + 1)
                    if h2:
                        tuples.add((h1, verb, h2))
                elif (j + 2 < len(segs) and segs[j + 1][0] == "prep"
                      and segs[j + 2][0] == "np"):
                    h2 = head_of(j + 2)
                    if h2:
                        tuples.add((h1, f"{verb} {segs[j + 1][1]}", h2))
                else:
                    tuples.add((h1, verb))  # verb as attribute-like state
            # NP [cop] prep NP
            elif (h1 and j < len(segs) and segs[j][0] == "prep"
                    and j + 1 < len(segs) and segs[j + 1][0] == "np"):
                h2 = head_of(j + 1)
                if h2:
                    tuples.add((h1, segs[j][1], h2))
        i += 1

    return frozenset(tuples)


def _elems_match(a: str, b: str, syn: SynonymTable) -> bool:
    return a == b or _stem(a) == _stem(b) or syn.are_synonyms(a, b)


def _tuples_match(a: Tuple3, b: Tuple3, syn: SynonymTable) -> bool:
    return len(a) == len(b) and all(_elems_match(x, y, syn) for x, y in zip(a, b))


def _f1(cand: FrozenSet[Tuple3], refs: FrozenSet[Tuple3], syn: SynonymTable) -> float:
    if not cand or not refs:
        return 0.0
    matched_c = sum(1 for c in cand if any(_tuples_match(c, r, syn) for r in refs))
    matched_r = sum(1 for r in refs if any(_tuples_match(r, c, syn) for c in cand))
    p = matched_c / len(cand)
    r = matched_r / len(refs)
    if p + r == 0:
        return 0.0
    return 2 * p * r / (p + r)


def spice(
    gts: Dict[object, List[str]],
    res: Dict[object, List[str]],
    synonym_table: Optional[SynonymTable] = None,
) -> Tuple[float, List[float]]:
    """SPICE-approx corpus score + per-image scores.

    gts/res: {image_id: [caption, ...]} (res: one caption per image), the
    same post-PTB-tokenization layout the other eval/ scorers take."""
    assert gts.keys() == res.keys()
    syn = synonym_table if synonym_table is not None else default_table()
    scores = []
    for img_id in gts:
        cand = extract_tuples(res[img_id][0])
        ref_union: Set[Tuple3] = set()
        for ref in gts[img_id]:
            ref_union |= extract_tuples(ref)
        scores.append(_f1(cand, frozenset(ref_union), syn))
    return sum(scores) / max(len(scores), 1), scores
