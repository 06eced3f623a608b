"""Terminal display helpers: progress bar, in-place stream, table, ETA.

Capability parity with the reference's ``utils/display.py`` (progbar/stream/
simple_table/time_since); independent implementation.
"""

from __future__ import annotations

import sys
import time
from typing import Iterable, Sequence, Tuple


def progbar(i: int, n: int, size: int = 16) -> str:
    """A ``|####    | 25/100`` style bar string for step i of n."""
    done = int(size * i / max(n, 1))
    return f"|{'#' * done}{' ' * (size - done)}| {i}/{n}"


def stream(message: str) -> None:
    """Rewrite the current terminal line (progress updates without scroll)."""
    sys.stdout.write(f"\r{message}")
    sys.stdout.flush()


def simple_table(rows: Iterable[Tuple[str, object]], pad: int = 2) -> str:
    """Two-row boxed table from (header, value) pairs, e.g. run settings."""
    items = [(str(k), str(v)) for k, v in rows]
    widths = [max(len(k), len(v)) + pad for k, v in items]
    sep = "+" + "+".join("-" * w for w in widths) + "+"
    head = "|" + "|".join(k.center(w) for (k, _), w in zip(items, widths)) + "|"
    vals = "|" + "|".join(v.center(w) for (_, v), w in zip(items, widths)) + "|"
    return "\n".join([sep, head, sep, vals, sep])


def time_since(started: float) -> str:
    """Compact elapsed-time string ('3m 12s' / '1h 4m') since time.time()."""
    s = int(time.time() - started)
    if s < 60:
        return f"{s}s"
    if s < 3600:
        return f"{s // 60}m {s % 60}s"
    return f"{s // 3600}h {(s % 3600) // 60}m"
