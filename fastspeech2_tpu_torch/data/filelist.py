"""Filelist parsing: the 5-field '|'-separated MFA-alignment format.

Row format (the reference's ``dataset/dataloader.py:47-53``). The port's own
copy of ``fastspeech2_tpu/data/filelist.py``:

    raw_text | frame_start_positions | durations | phonemes | wav_name

Only fields 2 (durations), 3 (phonemes) and 4 (wav id) feed training; field 1
is vestigial start positions, field 0 the raw text.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class FilelistEntry:
    utt_id: str          # wav filename without extension
    raw_text: str
    start_positions: List[int]
    durations: List[int]
    phonemes: List[str]


def parse_filelist_line(line: str) -> FilelistEntry:
    fields = line.rstrip("\n").split("|")
    if len(fields) != 5:
        raise ValueError(f"expected 5 '|'-separated fields, got {len(fields)}: {line!r}")
    raw_text, starts, durs, phonemes, wav_name = fields
    return FilelistEntry(
        utt_id=wav_name.split(".")[0],
        raw_text=raw_text.strip(),
        start_positions=[int(v) for v in starts.split()],
        durations=[int(v) for v in durs.split()],
        phonemes=phonemes.split(),
    )


def parse_filelist(path: str) -> List[FilelistEntry]:
    entries = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                entries.append(parse_filelist_line(line))
    return entries
