"""LJSpeech metadata.csv reader (reference ``dataset/ljspeech.py:4-41``); the
port's own copy of ``fastspeech2_tpu/data/ljspeech.py``.

Rows are ``id|raw_text|normalized_text``; returns (ids, texts) aligned lists.
"""

from __future__ import annotations

import csv
import os
from typing import List, Tuple


def read_metadata(ljspeech_root: str) -> Tuple[List[str], List[str]]:
    path = os.path.join(ljspeech_root, "metadata.csv")
    ids, texts = [], []
    with open(path, encoding="utf-8", newline="") as f:
        for row in csv.reader(f, delimiter="|", quoting=csv.QUOTE_NONE):
            if len(row) >= 3:
                ids.append(row[0])
                texts.append(row[2])
            elif len(row) == 2:
                ids.append(row[0])
                texts.append(row[1])
    return ids, texts
