"""Substitution-matrix builders for :class:`tpualign_torch.config.ScoringConfig`:
a copy of ``tpualign/matrices.py`` (the port imports nothing of the JAX
package; ``tests/test_torch_api.py`` holds the two to each other).

The reference scores every base pair with two compiled-in constants
(``needleman-wunsch.hpp:11-13``); real aligners weight substitutions — DNA
transition/transversion asymmetry, IUPAC wildcards, log-odds tables.  These
helpers build the hashable square tuple the config expects, indexed directly
by ``.bdna`` symbol code (0 = gap byte, 1..4 = A, T, G, C — ``helper.cpp:28``).

Matrix orientation: ``matrix[a][b]`` scores s1-code ``a`` against s2-code
``b`` (all builders here are symmetric).
"""

from __future__ import annotations

from typing import Sequence, Tuple

#: .bdna code points (``tpualign/io/bdna.py`` BASES = "-ATGC")
A, T, G, C = 1, 2, 3, 4

#: purine/purine and pyrimidine/pyrimidine substitutions (transitions):
#: A<->G and T<->C under the .bdna code order
_TRANSITIONS = frozenset({(A, G), (G, A), (T, C), (C, T)})


def from_rows(rows: Sequence[Sequence[int]]) -> Tuple[tuple, ...]:
    """Freeze any square int table into the config's tuple form."""
    out = tuple(tuple(int(v) for v in r) for r in rows)
    if not out or any(len(r) != len(out) for r in out):
        raise ValueError("matrix must be square and non-empty")
    return out


def dna(
    match: int = 1,
    transition: int = 0,
    transversion: int = -1,
    gap_vs_base: int | None = None,
) -> Tuple[tuple, ...]:
    """5x5 DNA matrix distinguishing transitions from transversions.

    ``gap_vs_base`` scores a literal gap byte (code 0) against any base —
    defaults to the transversion score (corpus sequences contain no gap
    bytes, so the row is normally unused).
    """
    if gap_vs_base is None:
        gap_vs_base = transversion
    m = [[gap_vs_base] * 5 for _ in range(5)]
    for a in (A, T, G, C):
        for b in (A, T, G, C):
            if a == b:
                m[a][b] = match
            elif (a, b) in _TRANSITIONS:
                m[a][b] = transition
            else:
                m[a][b] = transversion
    m[0][0] = match  # gap byte vs itself
    return from_rows(m)


def uniform(match: int = 1, mismatch: int = 0, size: int = 5) -> Tuple[tuple, ...]:
    """Matrix equivalent of plain match/mismatch scoring (for testing the
    matrix engines against the pair-scored ones)."""
    return from_rows(
        [[match if a == b else mismatch for b in range(size)]
         for a in range(size)]
    )


def iupac(match: int = 1, mismatch: int = -1) -> Tuple[tuple, ...]:
    """16-code IUPAC-style ambiguity matrix over 4-bit base-set codes.

    Code ``b`` (0..15) is read as the SET of bases it may stand for
    (bit 0 = A, 1 = C, 2 = G, 3 = T; e.g. 0b0101 = R = A/G, 0b1111 = N).
    Two codes score ``match`` when their sets intersect — the standard
    ambiguity-aware convention — else ``mismatch``; code 0 (the empty
    set) never matches anything.  Note this encoding is a superset
    alphabet, not the 5-code ``.bdna`` one: re-encode sequences to the
    bitmask codes before scoring with it.
    """
    return from_rows(
        [[match if (a & b) else mismatch for b in range(16)]
         for a in range(16)]
    )


def parse(spec: str) -> Tuple[tuple, ...]:
    """CLI matrix parser.

    Accepts ``dna:match,transition,transversion`` (builds :func:`dna`),
    ``iupac:match,mismatch`` (builds the 16-code :func:`iupac`), or an
    explicit row list ``r00,r01,../r10,r11,..`` with ``/`` separating
    rows.
    """
    if spec.startswith("dna:"):
        vals = [int(v) for v in spec[4:].split(",")]
        if len(vals) != 3:
            raise ValueError("dna: spec needs match,transition,transversion")
        return dna(*vals)
    if spec.startswith("iupac:"):
        vals = [int(v) for v in spec[6:].split(",")]
        if len(vals) != 2:
            raise ValueError("iupac: spec needs match,mismatch")
        return iupac(*vals)
    rows = [[int(v) for v in row.split(",")] for row in spec.split("/")]
    return from_rows(rows)
