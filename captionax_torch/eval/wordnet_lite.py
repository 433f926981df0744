"""Curated synonym table standing in for WordNet in METEOR's stage 3.

The reference's METEOR (HF `datasets` metric wrapping nltk
``meteor_score``, the reference's utils.py:261-263) runs a
WordNet-synonym match stage after exact and stem matching.  Where no
WordNet corpus is installed, captionax provides:

- this curated table of synonym groups for caption-domain vocabulary —
  an APPROXIMATION of WordNet coverage (hand-curated common-English
  synonym groups, biased toward words frequent in the FlickrStyle /
  Conceptual Captions corpora), used only when explicitly passed to
  ``meteor_score(..., synonyms=...)``;
- automatic use of the real nltk WordNet corpus when a user installs it
  (captionax_torch.eval.meteor._get_wordnet), which takes precedence.

The measured effect of the missing stage is recorded in BASELINE.md
(benchmarks/meteor_wordnet_delta.py).

The port's own copy of ``captionax/eval/wordnet_lite.py`` (pure Python; importing
anything of captionax runs its package init, which imports JAX).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, Set

_GROUPS: Iterable[Set[str]] = [
    # people
    {"child", "kid", "youngster", "tyke"},
    {"man", "gentleman"},
    {"woman", "lady"},
    {"boy", "lad"},
    {"girl", "lass"},
    {"person", "individual", "someone", "somebody"},
    {"people", "folks"},
    {"baby", "infant", "babe"},
    {"friend", "pal", "buddy", "companion"},
    {"crowd", "throng"},
    # animals
    {"dog", "canine", "pooch"},
    {"cat", "feline", "kitty"},
    {"puppy", "pup"},
    {"horse", "steed"},
    {"bird", "fowl"},
    {"bunny", "rabbit", "hare"},
    # actions
    {"run", "sprint", "dash"},
    {"runs", "sprints", "dashes"},
    {"running", "sprinting", "dashing"},
    {"jump", "leap", "bound", "spring"},
    {"jumps", "leaps", "bounds", "springs"},
    {"jumping", "leaping", "bounding"},
    {"walk", "stroll"},
    {"walks", "strolls"},
    {"walking", "strolling"},
    {"look", "watch", "gaze"},
    {"looks", "watches", "gazes"},
    {"looking", "watching", "gazing"},
    {"speak", "talk"},
    {"speaks", "talks"},
    {"speaking", "talking"},
    {"begin", "start", "commence"},
    {"begins", "starts", "commences"},
    {"grab", "seize", "grasp"},
    {"throw", "toss", "hurl"},
    {"throws", "tosses", "hurls"},
    {"throwing", "tossing", "hurling"},
    {"catch", "snatch"},
    {"climb", "ascend", "mount"},
    {"climbs", "ascends", "mounts"},
    {"climbing", "ascending", "mounting"},
    {"fall", "tumble", "drop"},
    {"falls", "tumbles", "drops"},
    {"falling", "tumbling", "dropping"},
    {"hold", "clutch", "grip"},
    {"holds", "clutches", "grips"},
    {"holding", "clutching", "gripping"},
    {"smile", "grin"},
    {"smiles", "grins"},
    {"smiling", "grinning"},
    {"sit", "perch"},
    {"sits", "perches"},
    {"sitting", "perching"},
    {"spin", "whirl", "twirl"},
    {"shout", "yell", "holler"},
    {"carry", "tote"},
    {"carries", "totes"},
    {"carrying", "toting"},
    # attributes
    {"big", "large"},
    {"small", "little"},
    {"quick", "fast", "speedy", "rapid"},
    {"quickly", "fast", "rapidly"},
    {"happy", "glad", "joyful", "cheerful"},
    {"sad", "unhappy", "sorrowful"},
    {"pretty", "lovely"},
    {"beautiful", "gorgeous", "stunning"},
    {"smart", "intelligent", "clever", "bright"},
    {"silly", "foolish", "goofy"},
    {"funny", "amusing", "comical", "humorous"},
    {"tiny", "minute", "wee"},
    {"huge", "enormous", "immense", "vast", "gigantic"},
    {"old", "aged", "elderly"},
    {"young", "youthful"},
    {"cold", "chilly", "frigid"},
    {"hot", "scorching"},
    {"wet", "soaked", "drenched"},
    {"dirty", "filthy", "grimy"},
    {"loving", "affectionate", "tender"},
    {"brave", "courageous", "fearless"},
    {"scared", "afraid", "frightened", "terrified"},
    {"angry", "mad", "furious"},
    {"tired", "weary", "exhausted"},
    # things & places
    {"picture", "photo", "photograph", "image"},
    {"street", "road"},
    {"sidewalk", "pavement"},
    {"car", "auto", "automobile"},
    {"bike", "bicycle", "cycle"},
    {"sofa", "couch"},
    {"house", "home", "dwelling"},
    {"shop", "store"},
    {"rock", "stone"},
    {"sea", "ocean"},
    {"woods", "forest"},
    {"hill", "mound"},
    {"trail", "path", "track"},
    {"garbage", "trash", "rubbish"},
    {"cap", "hat"},
    {"jacket", "coat"},
    {"pants", "trousers"},
    {"shirt", "top"},
    {"ball", "globe", "sphere"},
    {"gift", "present"},
    {"meal", "repast"},
    {"supper", "dinner"},
    {"steps", "stairs", "stairway", "staircase"},
    {"kids", "children", "youngsters"},
    {"dogs", "canines"},
    {"pictures", "photos", "photographs", "images"},
    {"streets", "roads"},
    {"rocks", "stones"},
    {"mist", "fog", "haze"},
    {"evening", "eve"},
    {"middle", "center", "midst"},
    {"edge", "rim", "brink"},
    {"top", "summit", "peak"},
    {"ground", "earth", "soil"},
    {"grass", "lawn", "turf"},
    {"water", "h2o"},
    {"game", "match", "contest"},
    {"group", "bunch", "cluster"},
    {"couple", "pair", "duo"},
]


def build_table() -> Dict[str, FrozenSet[str]]:
    table: Dict[str, Set[str]] = {}
    for group in _GROUPS:
        for w in group:
            table.setdefault(w, set()).update(group)
    return {w: frozenset(s) for w, s in table.items()}


LITE_SYNONYMS = build_table()


def lite_syns(word: str) -> FrozenSet[str]:
    """synonyms-of(word) including the word itself."""
    return LITE_SYNONYMS.get(word, frozenset((word,)))
