"""Feature-store dataset: phonemes + precomputed mel/energy/pitch .npy files.
The port's own copy of ``fastspeech2_tpu/data/dataset.py`` (numpy only).

Replicates the reference ``TTSDataset`` semantics (``dataset/dataloader.py:38-85``):

- phoneme (or grapheme) tokenization per ``use_phonemes``;
- mel loaded as (n_mels, T) and transposed to (T, n_mels);
- energy/pitch passed through the outlier filter, including its quirk
  (outliers are overwritten with max-after-zeroing; see ``remove_outlier``);
- durations truncated to the token count, the LAST duration absorbing any
  frame-count mismatch so that sum(durations) == mel frames (asserted).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from fastspeech2_tpu_torch.data.filelist import FilelistEntry, parse_filelist
from fastspeech2_tpu_torch.text import phonemes_to_sequence, text_to_sequence


def is_outlier(x, p25, p75) -> bool:
    """1.5-IQR rule (reference utils/util.py:26-31)."""
    lower = p25 - 1.5 * (p75 - p25)
    upper = p75 + 1.5 * (p75 - p25)
    return x <= lower or x >= upper


def remove_outlier(x: np.ndarray) -> np.ndarray:
    """IQR outlier filter with the reference's exact quirk
    (utils/util.py:34-49): outliers are first zeroed, then overwritten with the
    max of the zeroed array (the second write wins); original zeros stay zero.
    """
    x = np.array(x)  # copy; the reference mutates in place
    p25 = np.percentile(x, 25)
    p75 = np.percentile(x, 75)
    zero_idxs = np.where(x == 0.0)[0]
    outliers = np.array([is_outlier(v, p25, p75) for v in x], dtype=bool)
    x[outliers] = 0.0
    x[outliers] = np.max(x)
    x[zero_idxs] = 0.0
    return x


@dataclass
class Utterance:
    utt_id: str
    tokens: np.ndarray     # (T,) int32
    mel: np.ndarray        # (L, n_mels) float32
    durations: np.ndarray  # (T,) int32, sum == L
    energy: np.ndarray     # (L,) float32
    pitch: np.ndarray      # (L,) float32


class TTSDataset:
    """Random-access dataset over a filelist + feature directory."""

    def __init__(
        self,
        data_dir: str,
        filelist_path: str,
        use_phonemes: bool = True,
        cleaner_names: Sequence[str] = ("english_cleaners",),
        eos: bool = False,
    ):
        self.data_dir = data_dir
        self.entries: List[FilelistEntry] = parse_filelist(filelist_path)
        self.use_phonemes = use_phonemes
        self.cleaner_names = list(cleaner_names)
        self.eos = eos

    def __len__(self) -> int:
        return len(self.entries)

    def _feature(self, kind: str, utt_id: str) -> np.ndarray:
        return np.load(os.path.join(self.data_dir, kind, f"{utt_id}.npy"))

    def __getitem__(self, index: int) -> Utterance:
        e = self.entries[index]
        if self.use_phonemes:
            tokens = np.asarray(phonemes_to_sequence(e.phonemes), np.int32)
        else:
            tokens = np.asarray(
                text_to_sequence(e.phonemes, self.cleaner_names, self.eos), np.int32)
        mel = self._feature("mels", e.utt_id)          # (n_mels, L)
        energy = remove_outlier(self._feature("energy", e.utt_id)).astype(np.float32)
        pitch = remove_outlier(self._feature("pitch", e.utt_id)).astype(np.float32)

        L = mel.shape[1]
        durations = np.asarray(e.durations[: len(tokens)], np.int64)
        # last duration absorbs the frame-count mismatch (dataloader.py:63-65)
        durations[-1] = durations[-1] + (L - durations.sum())
        assert durations.sum() == L, f"duration/frame mismatch for {e.utt_id}"
        return Utterance(
            utt_id=e.utt_id,
            tokens=tokens,
            mel=mel.T.astype(np.float32),
            durations=durations.astype(np.int32),
            energy=energy[:L],
            pitch=pitch[:L].astype(np.float32),
        )

    def token_lengths(self) -> np.ndarray:
        """EXACT token counts per utterance (cached; tokenization only, no
        feature IO) -- correct for the grapheme path too, where cleaners
        change the symbol count relative to the raw field length."""
        if not hasattr(self, "_token_lengths"):
            if self.use_phonemes:
                tl = [len(phonemes_to_sequence(e.phonemes))
                      for e in self.entries]
            else:
                tl = [len(text_to_sequence(e.phonemes, self.cleaner_names,
                                           self.eos))
                      for e in self.entries]
            self._token_lengths = np.asarray(tl)
        return self._token_lengths

    def frame_lengths(self) -> np.ndarray:
        """Mel frame counts per utterance (cached). Reads only the npy
        headers (mmap), not the feature data."""
        if not hasattr(self, "_frame_lengths"):
            self._frame_lengths = np.asarray([
                np.load(os.path.join(self.data_dir, "mels",
                                     f"{e.utt_id}.npy"),
                        mmap_mode="r").shape[1]
                for e in self.entries])
        return self._frame_lengths


def write_fake_feature_store(
    root: str, n_utts: int = 8, n_mels: int = 80, seed: int = 0,
    min_tokens: int = 6, max_tokens: int = 16, graphemes: bool = False,
    min_dur: int = 1, max_dur: int = 7,
) -> str:
    """Generate a tiny synthetic dataset (filelist + mels/energy/pitch .npy)
    for hermetic tests and benchmarks. Returns the filelist path.

    graphemes=True writes plain lowercase letters into the text field (one
    duration per character, the ``use_phonemes=False`` contract the reference
    inherits from its filelists, dataset/dataloader.py:50-53) instead of
    ARPAbet symbols. Durations are uniform in [min_dur, max_dur] frames per
    token; the defaults give the JAX package's draws for the same seed."""
    from fastspeech2_tpu_torch.text.symbols import valid_symbols

    g = np.random.default_rng(seed)
    for sub in ("mels", "energy", "pitch"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    lines = []
    if graphemes:
        usable = list("abcdefghijklmnopqrstuvwxyz")
    else:
        usable = [s for s in valid_symbols if s not in ("sil", "spn")]
    for i in range(n_utts):
        utt = f"FAKE-{i:04d}"
        T = int(g.integers(min_tokens, max_tokens + 1))
        phonemes = list(g.choice(usable, T))
        durs = g.integers(min_dur, max_dur + 1, T)
        L = int(durs.sum())
        mel = g.normal(-5.0, 2.0, (n_mels, L)).astype(np.float32)
        energy = g.uniform(0.02, 100.0, L).astype(np.float32)
        pitch = np.where(g.uniform(size=L) < 0.2, 0.0,
                         g.uniform(71.0, 600.0, L)).astype(np.float32)
        np.save(os.path.join(root, "mels", f"{utt}.npy"), mel)
        np.save(os.path.join(root, "energy", f"{utt}.npy"), energy)
        np.save(os.path.join(root, "pitch", f"{utt}.npy"), pitch)
        starts = np.concatenate([[0], np.cumsum(durs)[:-1]])
        text_field = "".join(phonemes) if graphemes else " ".join(phonemes)
        lines.append("|".join([
            "fake text", " ".join(map(str, starts)), " ".join(map(str, durs)),
            text_field, f"{utt}.wav",
        ]))
    filelist = os.path.join(root, "filelist.txt")
    with open(filelist, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return filelist
