"""CMU Pronouncing Dictionary file wrapper (reference ``dataset/texts/cmudict.py``,
unused by the main paths there but part of the public surface).

Parses the standard cmudict format (``WORD  PH1 PH2 ...``; alternates as
``WORD(1)``); lookups are case-insensitive and return the list of
pronunciations or None.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

_ALT_RE = re.compile(r"\([0-9]+\)$")

VALID_SYMBOLS = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0", "AH1",
    "AH2", "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2", "AY", "AY0",
    "AY1", "AY2", "B", "CH", "D", "DH", "EH", "EH0", "EH1", "EH2", "ER", "ER0",
    "ER1", "ER2", "EY", "EY0", "EY1", "EY2", "F", "G", "HH", "IH", "IH0",
    "IH1", "IH2", "IY", "IY0", "IY1", "IY2", "JH", "K", "L", "M", "N", "NG",
    "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1", "OY2", "P", "R", "S", "SH",
    "T", "TH", "UH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2", "V", "W",
    "Y", "Z", "ZH",
]
_VALID = set(VALID_SYMBOLS)


class CMUDict:
    def __init__(self, path_or_lines, keep_ambiguous: bool = True):
        if isinstance(path_or_lines, str):
            with open(path_or_lines, encoding="latin-1") as f:
                entries = self._parse(f)
        else:
            entries = self._parse(path_or_lines)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries: Dict[str, List[str]] = entries

    @staticmethod
    def _parse(lines) -> Dict[str, List[str]]:
        entries: Dict[str, List[str]] = {}
        for line in lines:
            if not line or line.startswith(";;;"):
                continue
            parts = line.split("  ")
            if len(parts) != 2:
                continue
            word = _ALT_RE.sub("", parts[0])
            phones = parts[1].strip().split(" ")
            if all(p in _VALID for p in phones):
                entries.setdefault(word.upper(), []).append(" ".join(phones))
        return entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        return self._entries.get(word.upper())
