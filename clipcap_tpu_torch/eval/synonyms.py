# Copied unchanged from clipcap_tpu/eval/synonyms.py (standard library only): the port keeps its own copy.
"""Synonym table for METEOR's synonym matching stage.

The reference scores METEOR via pycocoevalcap's meteor-1.5 jar, whose
synonym stage matches words sharing a WordNet synset
(reference utils/scoring.py:12). WordNet's data files are not available
in this offline environment, so the stage is backed by a swappable
synonym table:

- `default_table()` — a vendored caption-domain table (the vocabulary that
  actually occurs in COCO-style captions: people, animals, vehicles,
  rooms, actions, attributes). Groups are transitive-closure sets, like
  WordNet synsets restricted to their caption-frequent members.
- `from_nltk_wordnet()` — builds the full table from nltk's WordNet corpus
  when it is installed (`nltk.download("wordnet")`), giving exact
  meteor-1.5 synonymy. Falls back to None when the corpus is absent.

METEOR (eval/meteor.py) asks only `are_synonyms(a, b)`.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, Optional, Set, Tuple

# Caption-domain synonym groups. Each tuple is one synset-like group; a
# word may appear in several groups (as in WordNet). Curated from the most
# frequent COCO caption vocabulary.
_CAPTION_SYNSETS: Tuple[Tuple[str, ...], ...] = (
    # people
    ("man", "guy", "gentleman", "male", "dude"),
    ("woman", "lady", "female", "gal"),
    ("child", "kid", "youngster", "toddler"),
    ("boy", "lad"),
    ("girl", "lass"),
    ("person", "individual", "human", "someone", "somebody"),
    ("people", "persons", "crowd", "folks"),
    ("baby", "infant", "newborn"),
    ("teenager", "teen", "adolescent", "youth"),
    # animals
    ("dog", "puppy", "canine", "pup", "pooch"),
    ("cat", "kitten", "feline", "kitty"),
    ("bird", "fowl"),
    ("horse", "pony", "equine", "steed"),
    ("cow", "cattle", "bovine"),
    ("sheep", "lamb"),
    ("rabbit", "bunny", "hare"),
    ("pig", "hog", "swine"),
    # vehicles
    ("car", "automobile", "auto", "vehicle", "sedan"),
    ("bicycle", "bike", "cycle"),
    ("motorcycle", "motorbike"),
    ("bus", "coach"),
    ("truck", "lorry"),
    ("airplane", "plane", "aircraft", "jet", "aeroplane"),
    ("boat", "ship", "vessel", "watercraft"),
    ("train", "locomotive", "railcar"),
    ("taxi", "cab", "taxicab"),
    # places / rooms / scenery
    ("house", "home", "residence", "dwelling"),
    ("building", "structure", "edifice"),
    ("street", "road", "roadway", "avenue"),
    ("sidewalk", "pavement", "walkway", "footpath"),
    ("kitchen", "cookery"),
    ("bathroom", "restroom", "washroom", "lavatory", "toilet"),
    ("store", "shop", "market", "boutique"),
    ("beach", "seashore", "shore", "seaside", "coast"),
    ("ocean", "sea"),
    ("mountain", "mount", "peak"),
    ("forest", "woods", "woodland"),
    ("field", "meadow", "pasture"),
    ("yard", "lawn", "garden"),
    ("city", "town", "metropolis"),
    ("park", "commons"),
    ("hill", "slope", "hillside"),
    ("river", "stream", "creek"),
    ("lake", "pond"),
    # objects
    ("picture", "photo", "photograph", "image", "snapshot", "pic"),
    ("television", "tv", "telly"),
    ("sofa", "couch", "settee"),
    ("table", "desk"),
    ("cup", "mug"),
    ("plate", "dish"),
    ("bag", "sack", "pouch"),
    ("purse", "handbag"),
    ("phone", "telephone", "cellphone", "smartphone", "mobile"),
    ("computer", "laptop", "pc"),
    ("sign", "signboard", "placard"),
    ("hat", "cap"),
    ("glasses", "spectacles", "eyeglasses"),
    ("clothes", "clothing", "attire", "garments", "apparel"),
    ("shirt", "top", "tee"),
    ("pants", "trousers", "slacks"),
    ("shoes", "footwear", "sneakers"),
    ("jacket", "coat"),
    ("umbrella", "parasol"),
    ("luggage", "baggage", "suitcase"),
    ("rock", "stone", "boulder"),
    ("trash", "garbage", "rubbish", "refuse", "waste"),
    ("gift", "present"),
    ("ball", "sphere", "orb"),
    ("bottle", "flask"),
    ("container", "bin", "receptacle"),
    ("blanket", "cover", "quilt", "comforter"),
    ("pillow", "cushion"),
    ("rug", "carpet", "mat"),
    ("curtain", "drape", "drapery"),
    ("lamp", "light", "lantern"),
    ("mirror", "looking-glass"),
    ("clock", "timepiece"),
    ("toy", "plaything"),
    ("doughnut", "donut"),
    ("sandwich", "sub", "hoagie"),
    ("fries", "chips"),
    ("soda", "pop", "soft-drink"),
    ("meal", "food", "dinner", "supper"),
    ("breakfast", "brunch"),
    ("dessert", "sweet", "pudding"),
    ("cake", "gateau"),
    ("candy", "sweets", "confection"),
    # actions (verb families; stems differ so stemming alone misses these)
    ("run", "sprint", "jog", "dash"),
    ("walk", "stroll", "amble", "saunter"),
    ("jump", "leap", "hop", "bound"),
    ("look", "gaze", "stare", "glance", "watch"),
    ("talk", "speak", "chat", "converse"),
    ("eat", "dine", "consume", "devour"),
    ("drink", "sip", "imbibe"),
    ("hold", "grasp", "grip", "clutch"),
    ("carry", "tote", "haul"),
    ("throw", "toss", "hurl", "fling"),
    ("catch", "grab", "snag"),
    ("ride", "mount"),
    ("sit", "perch"),
    ("stand", "pose"),
    ("sleep", "nap", "doze", "slumber", "rest"),
    ("smile", "grin", "beam"),
    ("laugh", "chuckle", "giggle"),
    ("cook", "prepare", "fix"),
    ("cut", "slice", "chop", "carve"),
    ("play", "frolic", "romp"),
    ("fly", "soar", "glide"),
    ("swim", "wade", "paddle"),
    ("fall", "tumble", "drop", "plunge"),
    ("push", "shove"),
    ("pull", "tug", "drag", "tow"),
    ("climb", "ascend", "scale"),
    ("begin", "start", "commence"),
    ("end", "finish", "conclude"),
    ("show", "display", "exhibit", "present"),
    ("wear", "don", "sport"),
    ("surf", "boogie-board"),
    ("ski", "snowboard"),
    ("drive", "steer", "pilot"),
    ("wave", "gesture", "signal"),
    # attributes
    ("big", "large", "huge", "enormous", "giant", "massive"),
    ("small", "little", "tiny", "miniature", "mini"),
    ("happy", "glad", "joyful", "cheerful", "pleased"),
    ("sad", "unhappy", "gloomy", "sorrowful"),
    ("fast", "quick", "rapid", "speedy", "swift"),
    ("slow", "sluggish", "leisurely"),
    ("pretty", "beautiful", "lovely", "attractive", "gorgeous"),
    ("ugly", "hideous", "unsightly"),
    ("old", "elderly", "aged", "ancient", "vintage"),
    ("new", "modern", "recent", "fresh"),
    ("young", "youthful", "juvenile"),
    ("dirty", "filthy", "grimy", "soiled"),
    ("clean", "spotless", "tidy", "neat"),
    ("wet", "soaked", "damp", "moist"),
    ("dry", "arid", "parched"),
    ("cold", "chilly", "frigid", "freezing"),
    ("hot", "warm", "scorching"),
    ("bright", "vivid", "brilliant", "luminous"),
    ("dark", "dim", "shadowy", "murky"),
    ("colorful", "vibrant", "multicolored"),
    ("crowded", "busy", "packed", "congested"),
    ("empty", "vacant", "bare", "deserted"),
    ("tall", "high", "towering", "lofty"),
    ("short", "low", "squat"),
    ("near", "close", "nearby", "adjacent"),
    ("far", "distant", "remote", "faraway"),
    ("many", "numerous", "several", "multiple"),
    ("smiling", "grinning", "beaming"),
)


class SynonymTable:
    """Word -> set-of-group-ids; two words are synonyms iff they share a
    group (the WordNet 'share a synset' relation)."""

    def __init__(self, groups: Iterable[Iterable[str]]):
        self._groups_of: Dict[str, FrozenSet[int]] = {}
        acc: Dict[str, Set[int]] = {}
        for gid, group in enumerate(groups):
            for w in group:
                acc.setdefault(w.lower(), set()).add(gid)
        self._groups_of = {w: frozenset(g) for w, g in acc.items()}

    def __contains__(self, word: str) -> bool:
        return word.lower() in self._groups_of

    def __len__(self) -> int:
        return len(self._groups_of)

    def are_synonyms(self, a: str, b: str) -> bool:
        if a == b:
            return True
        ga = self._groups_of.get(a.lower())
        if ga is None:
            return False
        gb = self._groups_of.get(b.lower())
        return bool(gb) and not ga.isdisjoint(gb)


_DEFAULT: Optional[SynonymTable] = None


def default_table() -> SynonymTable:
    """The active table: full WordNet when nltk's corpus is installed,
    the vendored caption-domain table otherwise."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = from_nltk_wordnet() or SynonymTable(_CAPTION_SYNSETS)
    return _DEFAULT


def from_nltk_wordnet() -> Optional[SynonymTable]:
    """Full WordNet synonymy via nltk, when the corpus data is present."""
    try:
        from nltk.corpus import wordnet as wn

        groups = []
        for syn in wn.all_synsets():
            lemmas = [l.name().replace("_", " ") for l in syn.lemmas()]
            if len(lemmas) > 1:
                groups.append(lemmas)
        return SynonymTable(groups)
    except Exception:
        return None
