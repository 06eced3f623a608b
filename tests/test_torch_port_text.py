"""The port's text frontend against the JAX package's on a fixed list: the
two packages share no module, so the port's copies of the cleaners, the
number expansion, the lexicon G2P and the tokenizers must give the same
strings and ids."""

import pytest

from fastspeech2_tpu import text as jtext
from fastspeech2_tpu.text import cleaners as jcleaners
from fastspeech2_tpu.text import g2p as jg2p
from fastspeech2_tpu.text import numbers as jnumbers
from fastspeech2_tpu_torch import text as ttext
from fastspeech2_tpu_torch.text import cleaners as tcleaners
from fastspeech2_tpu_torch.text import g2p as tg2p
from fastspeech2_tpu_torch.text import numbers as tnumbers
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

SENTENCES = [
    "Hello world.",
    "Dr. Smith paid $12.50 for 3 books in 1999, didn't he?",
    "Mr. and Mrs. Jones live at 221 Baker St., don't they?",
    "It's the boys' game; they're winning 2nd place!",
    "She sells 1,000 sea-shells by the sea shore.",
    "The zyxwvut flibbertigibbet quuxes xylophonically.",  # out of lexicon
    "I'll take the 10:30 train, we've got £5 and 100%.",
    "WHAT?! no... really: yes",
    "",
    "...!?",
]


@pytest.mark.parametrize("i", range(len(SENTENCES)))
def test_preprocess_text_matches(i):
    s = SENTENCES[i]
    want = jg2p.preprocess_text(s, g2p=jg2p.LexiconG2p())
    got = tg2p.preprocess_text(s, g2p=tg2p.LexiconG2p())
    assert got == want
    if want:
        assert ttext.phonemes_to_sequence(got) == jtext.phonemes_to_sequence(want)


def test_cleaners_and_numbers_match():
    for s in SENTENCES:
        assert tcleaners.english_cleaners(s) == jcleaners.english_cleaners(s)
        assert (tcleaners.punctuation_removers(tcleaners.english_cleaners(s))
                == jcleaners.punctuation_removers(jcleaners.english_cleaners(s)))
        assert tnumbers.normalize_numbers(s) == jnumbers.normalize_numbers(s)
        assert (ttext.clean_text(s, ["english_cleaners"])
                == jtext.clean_text(s, ["english_cleaners"]))
    for n in ("0", "7", "13", "42", "100", "1905", "2000", "2024", "12,345",
              "$1", "$2.05", "1st", "22nd", "3.14"):
        assert tnumbers.normalize_numbers(n) == jnumbers.normalize_numbers(n), n


def test_paragraph_and_tokenizers_match():
    para = "Hello world. Good morning there. The stream keeps going."
    assert tg2p.process_paragraph(para) == jg2p.process_paragraph(para)
    ph = "HH AH0 L OW1 W ER1 L D pau AA2 sil"
    ids = ttext.phonemes_to_sequence(ph)
    assert ids == jtext.phonemes_to_sequence(ph)
    assert ttext.sequence_to_phonemes(ids) == jtext.sequence_to_phonemes(ids)
    assert (ttext.text_to_sequence("Hi, there!", ["english_cleaners"], eos=True)
            == jtext.text_to_sequence("Hi, there!", ["english_cleaners"], eos=True))
    assert ttext.valid_symbols == jtext.valid_symbols
    assert ttext.CMU_REMAPPING == jtext.CMU_REMAPPING
    with pytest.raises(ValueError, match="Unknown phoneme"):
        ttext.phonemes_to_sequence("HH QQ9")


def test_lexicon_and_letter_to_sound_match():
    tl, jl = tg2p.LexiconG2p(), jg2p.LexiconG2p()
    assert tl.lexicon == jl.lexicon and len(tl.lexicon) > 1000
    for w in ("dont", "boys'", "cat's", "stopped", "running", "happily", "biggest",
              "flibbertigibbet", "knight", "write", "ice", "age"):
        assert tl.lookup(w) == jl.lookup(w), w
        assert tg2p.letter_to_sound(w) == jg2p.letter_to_sound(w), w
    with pytest.raises(FileNotFoundError):
        tg2p.LexiconG2p("/nonexistent/lexicon.txt")
