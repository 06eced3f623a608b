"""Grapheme-to-phoneme conversion for free-text inference.

The reference uses ``g2p_en.G2p`` at inference time (``inference.py:75,84-98``),
which needs network-downloaded NLTK data. Here g2p is a pluggable backend:

- if ``g2p_en`` is importable it is used verbatim;
- otherwise a built-in lexicon backend serves words it knows and falls back to
  simple English letter-to-sound rules for OOV words (g2p_en handles OOV with
  a neural LTS model; the rule LTS keeps free-text synthesis functional
  hermetically, at lower pronunciation quality).

``preprocess_text`` mirrors the reference's inference-time pipeline:
clean -> strip punctuation -> g2p -> map " "/","/"." to pau (``inference.py:84-98``).
"""

import os
from typing import List, Optional

from fastspeech2_tpu_torch.text.cleaners import english_cleaners, punctuation_removers

_G2P_BACKEND = None


# ordered greedy letter-to-sound rules: digraphs/trigraphs first, then single
# letters. Emitted symbols stay inside the 68-symbol vocabulary after the CMU
# stress remap (text/__init__.py).
_LTS_MULTI = [
    ("tion", "SH AH0 N"), ("sion", "ZH AH0 N"), ("igh", "AY1"),
    ("ough", "AO1"), ("augh", "AO1"), ("dge", "JH"), ("tch", "CH"),
    ("ch", "CH"), ("sh", "SH"), ("th", "TH"), ("ph", "F"), ("wh", "W"),
    ("ck", "K"), ("ng", "NG"), ("qu", "K W"), ("ee", "IY1"), ("oo", "UW1"),
    ("ea", "IY1"), ("ou", "AW1"), ("ow", "OW1"), ("ai", "EY1"),
    ("ay", "EY1"), ("oa", "OW1"), ("oi", "OY1"), ("oy", "OY1"),
    ("au", "AO1"), ("aw", "AO1"), ("ar", "AA1 R"), ("er", "ER0"),
    ("ir", "ER1"), ("or", "AO1 R"), ("ur", "ER1"), ("oe", "OW1"),
]
_LTS_SINGLE = {
    "a": "AE1", "b": "B", "c": "K", "d": "D", "e": "EH1", "f": "F",
    "g": "G", "h": "HH", "i": "IH1", "j": "JH", "k": "K", "l": "L",
    "m": "M", "n": "N", "o": "AA1", "p": "P", "q": "K", "r": "R", "s": "S",
    "t": "T", "u": "AH1", "v": "V", "w": "W", "x": "K S", "y": "IY0",
    "z": "Z",
}


def letter_to_sound(word: str) -> List[str]:
    """Greedy rule-based English LTS for lexicon misses. Deliberately simple:
    functional pronunciation, not g2p_en quality. Measured PER vs the bundled
    lexicon's pronunciations when serving held-out words:
    scripts/measure_g2p.py (PARITY.md 'Hermetic G2P quality')."""
    w = "".join(ch for ch in word.lower() if ch.isalpha())
    if not w:
        return []
    # silent initial clusters: knife/knew -> N, write -> R, gnome -> N
    if w.startswith("kn") or w.startswith("gn"):
        w = w[1:]
    elif w.startswith("wr"):
        w = w[1:]
    # magic e ("make", "time", "ice"): drop the silent final e and lengthen
    # the vowel before the closing consonant -- not for "the"-like words
    # where the letter before the consonant is not a vowel
    long_vowel = {"a": "EY1", "e": "IY1", "i": "AY1", "o": "OW1", "u": "UW1"}
    magic = -1
    soft_final = False  # final c/g had a following (now dropped) silent e
    if (len(w) > 2 and w.endswith("e") and w[-2] not in "aeiou"
            and w[-3] in "aeiou"):
        magic = len(w) - 3
        w = w[:-1]
        soft_final = True
    elif len(w) > 3 and w.endswith("e") and w[-2] not in "aeiou":
        w = w[:-1]
        soft_final = True
    phones: List[str] = []
    i = 0
    while i < len(w):
        if i == magic:
            phones.append(long_vowel[w[i]])
            i += 1
            continue
        # doubled consonant letters sound once (scissors, happen)
        if (i > 0 and w[i] == w[i - 1] and w[i] not in "aeiou"
                and w[i] != magic):
            i += 1
            continue
        # soft c/g: c before e/i/y -> S (ice, city); final -ge -> JH (age)
        if w[i] == "c" and (i + 1 < len(w) and w[i + 1] in "eiy"
                            or (i == len(w) - 1 and soft_final)):
            phones.append("S")
            i += 1
            continue
        if w[i] == "g" and i == len(w) - 1 and soft_final:
            phones.append("JH")
            i += 1
            continue
        for pat, ph in _LTS_MULTI:
            if w.startswith(pat, i):
                phones.extend(ph.split())
                i += len(pat)
                break
        else:
            ph = _LTS_SINGLE.get(w[i])
            if ph:
                phones.extend(ph.split())
            i += 1
    return phones


# final-phone classes driving English suffix voicing (stress digits stripped)
_SIBILANT = {"S", "Z", "SH", "ZH", "CH", "JH"}
_VOICELESS = {"P", "T", "K", "F", "TH", "S", "SH", "CH"}

# The serving pipeline strips apostrophes BEFORE g2p (punctuation_removers
# mirrors reference cleaners.py:22), so contractions arrive bare: "don't" ->
# "dont". Map unambiguous bare forms back to their apostrophized spelling so
# the lexicon/clitic machinery serves them. Bare forms that collide with real
# words ("ill", "well", "wed", "hell", "shell", "id", "were") are excluded;
# "its"/"lets"/"theres" keep identical phones either way.
_BARE_CONTRACTIONS = {
    c.replace("'", ""): c for c in (
        "i'm", "i've", "you're", "you've", "you'll", "you'd", "we've",
        "they're", "they've", "they'll", "they'd", "he's", "she's", "it's",
        "that's", "what's", "who's", "where's", "here's", "there's", "let's",
        "don't", "doesn't", "didn't", "isn't", "aren't", "wasn't", "weren't",
        "won't", "can't", "couldn't", "wouldn't", "shouldn't", "hasn't",
        "haven't", "hadn't", "mustn't", "ain't",
    )
}


def _base_phone(phones: List[str]) -> str:
    return phones[-1].rstrip("012") if phones else ""


def _plural_suffix(phones: List[str]) -> List[str]:
    last = _base_phone(phones)
    if last in _SIBILANT:
        return ["IH0", "Z"]
    return ["S"] if last in _VOICELESS else ["Z"]


def _past_suffix(phones: List[str]) -> List[str]:
    last = _base_phone(phones)
    if last in ("T", "D"):
        return ["IH0", "D"]
    return ["T"] if last in _VOICELESS else ["D"]


class LexiconG2p:
    """Bundled-lexicon lookup + morphological derivation + rule LTS for misses.

    The base lexicon ships in-repo (``text/data/lexicon.txt``, CMUdict format,
    ~1.5k curated base forms); inflected forms -- possessives, plurals,
    3rd-person -s, -ed, -ing, -ly, -er/-est, -ness, -ful -- are derived from
    base entries with standard English voicing rules, so effective coverage is
    several times the entry count. Only then does the greedy letter-to-sound
    fallback fire (tracked in ``lts_count`` so coverage is measurable).
    Serving deployments wanting neural-OOV quality install ``g2p_en``
    (used automatically when importable) or pass a full CMUdict file.
    """

    #: the in-repo lexicon, loaded unless the caller supplies their own
    DEFAULT_LEXICON = os.path.join(os.path.dirname(__file__), "data",
                                   "lexicon.txt")

    def __init__(self, lexicon_path: Optional[str] = None):
        self.lexicon: dict = {}
        self.lts_count = 0  # words that fell through to letter_to_sound
        for path in filter(None, [self.DEFAULT_LEXICON, lexicon_path]):
            if not os.path.exists(path):
                if path == lexicon_path:
                    # a caller-supplied lexicon must not silently degrade
                    # to bundle+LTS pronunciations
                    raise FileNotFoundError(f"lexicon not found: {path}")
                continue  # bundled default may be absent in odd installs
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    parts = line.strip().split()
                    if len(parts) >= 2 and not parts[0].startswith(";"):
                        # later files (caller-supplied) override the bundle
                        self.lexicon[parts[0].lower()] = " ".join(parts[1:])
        # serving strips apostrophes before g2p: alias apostrophized entries
        # ("don't") under their bare spelling ("dont") unless taken
        for k, v in list(self.lexicon.items()):
            if "'" in k:
                self.lexicon.setdefault(k.replace("'", ""), v)

    def _base(self, key: str) -> Optional[List[str]]:
        p = self.lexicon.get(key)
        return p.split() if p else None

    def lookup(self, key: str) -> Optional[List[str]]:
        """Phones for a word via lexicon entry or morphological derivation;
        None if only letter-to-sound could serve it."""
        hit = self._base(key)
        if hit:
            return hit
        # apostrophe-stripped contraction ("dont" <- cleaned "don't")
        apos = _BARE_CONTRACTIONS.get(key)
        if apos:
            hit = self.lookup(apos)
            if hit:
                return hit
        # possessive / contraction clitics
        if key.endswith("s'"):
            # plural possessive: the stem's plural already ends in S/Z;
            # the clitic adds no phone ("boys'" == "boys")
            return self.lookup(key[:-1])
        if key.endswith("'s"):
            base = self.lookup(key[:-2])
            if base:
                return base + _plural_suffix(base)
        if "'" in key:
            for clitic, phones in (("n't", ["AH0", "N", "T"]),
                                   ("'ll", ["AH0", "L"]), ("'re", ["ER0"]),
                                   ("'ve", ["AH0", "V"]), ("'d", ["D"]),
                                   ("'m", ["M"])):
                if key.endswith(clitic):
                    base = self.lookup(key[: -len(clitic)])
                    if base:
                        return base + phones
            return None
        # inflectional suffixes, derived from base entries
        if key.endswith("ies") and len(key) > 4:
            base = self._base(key[:-3] + "y")
            if base:
                return base[:-1] + ["IY0", "Z"]  # -y -> -ies
        if key.endswith("es") and len(key) > 3:
            base = self._base(key[:-2])
            if base and _base_phone(base) in _SIBILANT:
                return base + ["IH0", "Z"]
        if key.endswith("s") and not key.endswith("ss") and len(key) > 2:
            base = self._base(key[:-1])
            if base:
                return base + _plural_suffix(base)
        if key.endswith("ied") and len(key) > 4:
            base = self._base(key[:-3] + "y")
            if base:
                return base[:-1] + ["IY0", "D"]
        if key.endswith("ed") and len(key) > 3:
            base = (self._base(key[:-2]) or self._base(key[:-1])  # want+ed / compose+d
                    or (self._base(key[:-3]) if len(key) > 4
                        and key[-3] == key[-4] else None))  # stopp-ed
            if base:
                return base + _past_suffix(base)
        if key.endswith("ing") and len(key) > 4:
            base = (self._base(key[:-3]) or self._base(key[:-3] + "e")
                    or (self._base(key[:-4]) if len(key) > 5
                        and key[-4] == key[-5] else None))
            if base:
                return base + ["IH0", "NG"]
        for suffix, phones in (("ly", ["L", "IY0"]), ("ness", ["N", "AH0", "S"]),
                               ("ful", ["F", "AH0", "L"]),
                               ("ment", ["M", "AH0", "N", "T"])):
            if key.endswith(suffix) and len(key) > len(suffix) + 1:
                base = self._base(key[: -len(suffix)])
                if base:
                    return base + phones
        if key.endswith("er") and len(key) > 3:
            base = (self._base(key[:-2]) or self._base(key[:-1])
                    or (self._base(key[:-3]) if len(key) > 4
                        and key[-3] == key[-4] else None))  # bigg-er
            if base:
                return base + ["ER0"]
        if key.endswith("est") and len(key) > 4:
            base = (self._base(key[:-3]) or self._base(key[:-2])
                    or (self._base(key[:-4]) if len(key) > 5
                        and key[-4] == key[-5] else None))  # bigg-est
            if base:
                return base + ["IH0", "S", "T"]  # CMUdict: biggest -> ... IH0 S T
        return None

    def __call__(self, text: str) -> List[str]:
        phones: List[str] = []
        for word in text.split():
            if word in (",", "."):
                phones.append(word)
                continue
            key = word.lower().strip(",.!?;:")
            if not key:
                continue
            hit = self.lookup(key)
            if hit is not None:
                phones.extend(hit)
            else:
                self.lts_count += 1
                phones.extend(letter_to_sound(key))
            if word.endswith((",", ".")):
                phones.append(word[-1])
        return phones


def get_g2p(lexicon_path: Optional[str] = None):
    """Return a callable text -> list-of-phoneme-tokens."""
    global _G2P_BACKEND
    if _G2P_BACKEND is not None and lexicon_path is None:
        return _G2P_BACKEND
    try:
        from g2p_en import G2p  # type: ignore

        _G2P_BACKEND = G2p()
    except Exception:
        _G2P_BACKEND = LexiconG2p(lexicon_path)
    return _G2P_BACKEND


def preprocess_text(text: str, g2p=None) -> str:
    """Free text -> space-joined phoneme string (reference inference.py:84-98)."""
    g2p = g2p or get_g2p()
    cleaned = punctuation_removers(english_cleaners(text))
    phonemes = g2p(cleaned)
    phonemes = ["" if p == " " else p for p in phonemes]
    phonemes = ["pau" if p in (",", ".") else p for p in phonemes]
    return " ".join(p for p in phonemes if p)


def process_paragraph(para: str) -> List[str]:
    """Split a paragraph into sentences on '.' (reference inference.py:101-108)."""
    return para.split(".")
