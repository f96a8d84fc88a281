"""The check of an alignment's strings, in NumPy.

An alignment of ``s1`` (text) against ``s2`` (query) is two strings of equal
length over the ``.bdna`` letters and the gap ``-``.  It is sound when no
column holds two gaps, each string with its gaps taken out spells ``s1`` and
``s2`` (global) or a stretch of each (local), and its columns scored under
the scheme give the optimum.  The scheme's arithmetic is the caller's: each
reference module scores the columns by its own ``value``, so a scheme with
affine gaps or a matrix scores them as it must.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

#: the ``.bdna`` format's letters by code: 0 is the gap, 1..4 are A, T, G, C
LETTERS = "-ATGC"
GAP = ord("-")


def _codes(aligned: str) -> np.ndarray:
    """Codes of an aligned string; -1 for a letter outside ``LETTERS``."""
    lut = np.full(256, -1, dtype=np.int8)
    lut[np.frombuffer(LETTERS.encode(), np.uint8)] = np.arange(len(LETTERS), dtype=np.int8)
    return lut[np.frombuffer(aligned.encode("latin-1", "replace"), np.uint8)]


def _contains(seq: np.ndarray, part: np.ndarray) -> bool:
    return part.tobytes() in seq.astype(np.int8).tobytes()


def fault(s1: np.ndarray, s2: np.ndarray, a1: str, a2: str, *, local: bool,
          value: Callable[[np.ndarray, np.ndarray], int], optimum: int) -> Optional[str]:
    """None if ``(a1, a2)`` is an alignment of ``s1`` against ``s2`` (whole,
    or stretches of them when ``local``) whose columns score ``optimum`` by
    ``value(c1, c2)``, the columns' codes with 0 for a gap, else what is
    wrong with it."""
    if len(a1) != len(a2):
        return f"strings of {len(a1)} and {len(a2)} columns"
    c1, c2 = _codes(a1), _codes(a2)
    if (c1 < 0).any() or (c2 < 0).any():
        return "a letter outside the alphabet"
    gap1, gap2 = c1 == 0, c2 == 0
    if (gap1 & gap2).any():
        return "a column of two gaps"
    r1, r2 = c1[~gap1], c2[~gap2]
    if local:
        if not (_contains(s1, r1) and _contains(s2, r2)):
            return "a string that is no stretch of its sequence"
    elif not (np.array_equal(r1, s1) and np.array_equal(r2, s2)):
        return "a string that does not spell its sequence"
    got = value(c1, c2)
    if got != optimum:
        return f"its columns score {got}, the optimum is {optimum}"
    return None
