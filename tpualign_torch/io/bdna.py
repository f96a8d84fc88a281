"""``.bdna`` sequence IO of the port: the counterpart of
``tpualign/io/bdna.py``, with the same validation and the same bytes for a
seed (``tests/test_torch_cli.py`` holds the two to each other).

File format (reference ``README.md:8``, base table ``src/common/helper.cpp:28``):
raw bytes, one base per byte, no header or terminator; code 0 = gap ``-``,
1..4 = ``A``, ``T``, ``G``, ``C``.  :func:`read_bdna` reads the whole file in
one call, validates the code range and hands back a NumPy ``int8`` array.

Also provides encode/decode to ASCII and a deterministic random-pair
generator (the reference's ``bdna/`` corpus is random, species-free
sequences).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

#: Symbol alphabet, indexed by code.  Codes 0..4 are the ``.bdna`` bytes
#: (``helper.cpp:28``); codes 5..15 extend the table with IUPAC-flavored
#: letters so wide-alphabet (K <= 16 substitution-matrix) alignments render
#: — ``.bdna`` files themselves still only admit codes 0..4.
BASES = "-ATGCRYSWKMBDHVN"
_CODE_OF = {c: i for i, c in enumerate(BASES)}


def read_bdna(path: str | os.PathLike, *, validate: bool = True) -> np.ndarray:
    """Read a ``.bdna`` file into an ``int8`` NumPy array of base codes."""
    with open(path, "rb") as f:
        raw = f.read()
    seq = np.frombuffer(bytearray(raw), dtype=np.int8)
    if validate and seq.size and (seq.min() < 0 or seq.max() > 4):
        bad = int(np.abs(seq.view(np.uint8)).max())
        raise ValueError(f"{path}: byte value {bad} outside .bdna code range 0..4")
    return seq


def write_bdna(path: str | os.PathLike, seq: np.ndarray) -> None:
    """Write an ``int8`` base-code array as a ``.bdna`` file."""
    seq = np.asarray(seq, dtype=np.int8)
    if seq.ndim != 1:
        raise ValueError(f"sequence must be 1-D, got shape {seq.shape}")
    if seq.size and (seq.min() < 0 or seq.max() > 4):
        raise ValueError("sequence contains codes outside 0..4")
    with open(path, "wb") as f:
        f.write(seq.tobytes())


def decode(seq: np.ndarray) -> str:
    """Base codes -> ASCII string (``-ATGC``), as ``printSequence`` does."""
    lut = np.frombuffer(BASES.encode(), dtype=np.uint8)
    return lut[np.asarray(seq, dtype=np.int64)].tobytes().decode()


def encode(text: str) -> np.ndarray:
    """ASCII ``-ATGC`` string -> int8 base codes."""
    try:
        return np.array([_CODE_OF[c] for c in text.upper()], dtype=np.int8)
    except KeyError as e:
        raise ValueError(f"character {e.args[0]!r} not in alphabet {BASES!r}") from None


def random_pair(
    len1: int, len2: int, *, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic random base pair (codes 1..4, uniform), like the reference corpus.

    The reference's ``bdna/`` files are "randomly generated, and don't represent
    the DNA of actual living creatures" (``README.md:8``); sizes were chosen so the
    int32 DP table hits a target footprint.  ``pair_lengths_for_gb`` reproduces
    that naming convention.
    """
    rng = np.random.default_rng(seed)
    s1 = rng.integers(1, 5, size=len1, dtype=np.int8)
    s2 = rng.integers(1, 5, size=len2, dtype=np.int8)
    return s1, s2


def pair_lengths_for_gb(gb: float, *, skew: float = 1.0) -> Tuple[int, int]:
    """Sequence lengths whose int32 DP table ``(l1+1)(l2+1)*4B`` is ~``gb`` GB."""
    cells = gb * (1 << 30) / 4.0
    l1 = int(round((cells / skew) ** 0.5 * skew))
    l2 = int(round(cells / max(l1, 1)))
    return max(l1 - 1, 1), max(l2 - 1, 1)


def table_gb(len1: int, len2: int) -> float:
    """int32 DP-table footprint in GB for a pair (the reference's naming metric)."""
    return (len1 + 1) * (len2 + 1) * 4 / (1 << 30)
