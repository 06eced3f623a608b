"""Text frontend of the port: phoneme and grapheme tokenization.

The port's own copy of ``fastspeech2_tpu/text`` (same surface, same
behaviour; the two packages share no module):

- ``phonemes_to_sequence``: CMU-stress remap, then id lookup
- ``sequence_to_phonemes``: the inverse mapping
- ``text_to_sequence``: grapheme path via the char dict
- ``clean_text`` and ``valid_symbols`` re-exported

G2P (text -> phonemes at inference) lives in
:mod:`fastspeech2_tpu_torch.text.g2p`.
"""

from typing import List, Sequence, Union

from fastspeech2_tpu_torch.text.cleaners import clean_text  # noqa: F401
from fastspeech2_tpu_torch.text.symbols import (  # noqa: F401
    CMU_REMAPPING,
    EOS_CHAR,
    NUM_PHONEMES,
    PHONEME_PAD_ID,
    char_to_id,
    id_to_char,
    id_to_phoneme,
    phoneme_to_id,
    valid_symbols,
)


def convert_phoneme_cmu(phoneme: str) -> str:
    """Collapse secondary stress / rare stress variants."""
    return CMU_REMAPPING.get(phoneme, phoneme)


def phonemes_to_sequence(phonemes: Union[str, Sequence[str]]) -> List[int]:
    """Phoneme tokens -> id list. Accepts a space-joined string or a token list."""
    tokens = phonemes.split() if isinstance(phonemes, str) else list(phonemes)
    remapped = [convert_phoneme_cmu(t) for t in tokens]
    try:
        return [phoneme_to_id[t] for t in remapped]
    except KeyError as e:
        raise ValueError(f"Unknown phoneme {e.args[0]!r} in input {tokens!r}") from None


def sequence_to_phonemes(sequence: Sequence[int], sep: str = " ") -> str:
    return sep.join(id_to_phoneme[int(i)] for i in sequence)


def text_to_sequence(text: Union[str, Sequence[str]], cleaner_names, eos: bool) -> List[int]:
    """Grapheme path: clean, then per-char id lookup via the uppercase char
    dict. Unknown chars raise."""
    if not isinstance(text, str):
        text = " ".join(text)
    if eos:
        text = text + EOS_CHAR
    cleaned = clean_text(text, cleaner_names)
    try:
        return [char_to_id[c.upper()] for c in cleaned]
    except KeyError as e:
        raise ValueError(f"Unknown character {e.args[0]!r} in cleaned text {cleaned!r}") from None


def sequence_to_text(sequence: Sequence[int]) -> str:
    return "".join(id_to_char.get(int(i), "") for i in sequence)
