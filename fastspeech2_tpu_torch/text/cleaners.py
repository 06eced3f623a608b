"""Text cleaners (reference ``dataset/texts/cleaners.py``).

Same pipeline semantics -- ascii transliteration, lowercasing, number and
abbreviation expansion, whitespace collapse, punctuation stripping -- without the
``unidecode`` dependency (replaced by a unicodedata NFKD fold, which is identical
for the Latin-accented characters that occur in LJSpeech).
"""

import re
import unicodedata

from fastspeech2_tpu_torch.text.numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

# characters stripped by punctuation_removers (reference cleaners.py:22)
punctuations = """+-!()[]{};:'"\\<>/?@#^&*_~"""

_abbreviations = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), expansion)
    for abbr, expansion in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]


def convert_to_ascii(text: str) -> str:
    """Transliterate to ASCII (unidecode replacement via NFKD compatibility fold)."""
    decomposed = unicodedata.normalize("NFKD", text)
    return decomposed.encode("ascii", "ignore").decode("ascii")


def lowercase(text: str) -> str:
    return text.lower()


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    """ascii -> lower -> numbers -> abbreviations -> collapse whitespace
    (reference cleaners.py:87-94)."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


def punctuation_removers(text: str) -> str:
    return "".join(ch for ch in text if ch not in punctuations)


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
}


def clean_text(text: str, cleaner_names) -> str:
    for name in cleaner_names:
        if name not in CLEANERS:
            raise ValueError(f"Unknown cleaner: {name}")
        text = CLEANERS[name](text)
    return text
