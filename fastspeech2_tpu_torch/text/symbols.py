"""Symbol inventories of the text frontend.

The port's own copy of ``fastspeech2_tpu/text/symbols.py`` (the JAX package's
vocabulary, which matches the reference's exactly):

- ``valid_symbols``: the 68-entry ARPAbet-with-collapsed-stress vocabulary.
  Token id == list index; id 0 ("AA") doubles as the padding id (the
  encoder embedding's padding_idx).
- ``CMU_REMAPPING``: stress-collapse map applied before lookup.
- character symbols of the grapheme path (``text_to_sequence``).
"""

# 68 phonemes; id = index; id 0 is also the pad id.
valid_symbols = [
    "AA", "AA1", "AE", "AE0", "AE1", "AH", "AH0", "AH1", "AO", "AO1",
    "AW", "AW0", "AW1", "AY", "AY0", "AY1", "B", "CH", "D", "DH",
    "EH", "EH0", "EH1", "ER", "EY", "EY0", "EY1", "F", "G", "HH",
    "IH", "IH0", "IH1", "IY", "IY0", "IY1", "JH", "K", "L", "M",
    "N", "NG", "OW", "OW0", "OW1", "OY", "OY0", "OY1", "P", "R",
    "S", "SH", "T", "TH", "UH", "UH0", "UH1", "UW", "UW0", "UW1",
    "V", "W", "Y", "Z", "ZH", "pau", "sil", "spn",
]

PHONEME_PAD_ID = 0  # reference uses padding_idx=0 (== "AA")

# Stress-collapse remapping applied to raw CMU/g2p output before id lookup.
CMU_REMAPPING = {
    "AA0": "AA1", "AA2": "AA1",
    "AE2": "AE1",
    "AH2": "AH1",
    "AO0": "AO1", "AO2": "AO1",
    "AW2": "AW1",
    "AY2": "AY1",
    "EH2": "EH1",
    "ER0": "EH1", "ER1": "EH1", "ER2": "EH1",
    "EY2": "EY1",
    "IH2": "IH1",
    "IY2": "IY1",
    "OW2": "OW1",
    "OY2": "OY1",
    "UH2": "UH1",
    "UW2": "UW1",
}

phoneme_to_id = {s: i for i, s in enumerate(valid_symbols)}
id_to_phoneme = {i: s for i, s in enumerate(valid_symbols)}

# ---------------------------------------------------------------------------
# Grapheme (character) path
# ---------------------------------------------------------------------------

_pad = "_"
_eos = "~"
_punctuation = "!'(),.:;? "
_special = "-"
_letters = "abcdefghijklmnopqrstuvwxyz"

# character inventory used by text_to_sequence's keep-filter
# (reference dataset/texts/symbols.py:21)
char_symbols = [_pad] + list(_special) + list(_punctuation) + list(_letters) + [_eos]

EOS_CHAR = _eos
PAD_CHAR = _pad

# char -> id table used by the grapheme tokenizer (reference dataset/texts/dict_.py)
char_to_id = {
    "<unk>": 1,
    "!": 2, "'": 3, ",": 4, ".": 5, " ": 6, "?": 7,
    "A": 8, "B": 9, "C": 10, "D": 11, "E": 12, "F": 13, "G": 14, "H": 15,
    "I": 16, "J": 17, "K": 18, "L": 19, "M": 20, "N": 21, "O": 22, "P": 23,
    "Q": 24, "R": 25, "S": 26, "T": 27, "U": 28, "V": 29, "W": 30, "X": 31,
    "Y": 32, "Z": 33, "~": 34,
}
id_to_char = {v: k for k, v in char_to_id.items()}

NUM_PHONEMES = len(valid_symbols)  # 68 == model input vocab (train_fastspeech.py:35)
