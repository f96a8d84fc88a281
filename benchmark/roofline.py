"""The least time the card could take for a call's work: the roofline's
counts and peaks.

A copy of the arithmetic of ``chip_smoke.py`` (``HBM_BYTES_S``, ``OPS_S``,
``bound``, ``band_ops``, its ``words_bound``), kept here so that the
yardstick does not move with the program.  The counts follow from the
problem's shape and its scheme, never from a launch's geometry, so they read
the same work whatever kernel does it:

- the bit-parallel family, global linear schemes affinely equal to
  ``(1, 0, -g)`` with ``g`` in 1..7: ~25 64-bit operations a word of 64 rows
  and a column at ``g = 1`` (50 at 3 or 4 planes), each two 32-bit ones, on
  the orientation that needs fewer words; bytes: the text, the match planes
  of the 5 codes and the final planes;
- every other scheme: the cell recurrence, ``H = max(diag + s, max(up,
  left) + g)`` with linear gaps, 4 operations a cell, and with affine gaps
  (E, F and H) 9, the local floor 1 more; bytes: both sequences and the
  score (28 bytes a pair of a batch: offsets, lengths and the score).

A scheme is a configuration file's keys (``mode``, ``match``,
``mismatch``, ``gap``, ``gap_open``, ``matrix``).

Peaks of one NVIDIA H100 SXM from its data sheet: 3.35 TB/s of HBM, and
67 T operations a second, the float32 rate outside the tensor cores, taken
as the rate of 32-bit integer work, for which no rate is published.  The
peaks assume the card's full power limit of 700 W.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

HBM_BYTES_S = 3.35e12
OPS_S = 67e12
WORD = 64
MATCH_PLANES = 5
MAX_G = 7


def bound(nbytes: float, ops: float) -> Tuple[float, str]:
    """``(seconds, bound_by)``: the larger of the bytes' time at the HBM
    rate and the operations' time at the card's rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_S, ops / OPS_S
    return (by_bytes, "bytes") if by_bytes > by_ops else (by_ops, "operations")


def _affine(config: dict) -> bool:
    return config.get("gap_open") is not None


def band_ops(config: dict, cells: int) -> int:
    """Integer operations of the cell recurrence over ``cells`` cells."""
    return ((9 if _affine(config) else 4) + (1 if config["mode"] == "local" else 0)) * cells


def family_g(config: dict) -> Optional[int]:
    """``g`` if the scheme is global, linear, without a matrix and affinely
    equal to ``(1, 0, -g)``, ``1 <= g <= 7``, else None."""
    if config["mode"] != "global" or _affine(config) or config.get("matrix") is not None:
        return None
    mult = config["match"] - config["mismatch"]
    num = config["mismatch"] - 2 * config["gap"]
    if mult <= 0 or num <= 0 or num % (2 * mult):
        return None
    g = num // (2 * mult)
    return g if 1 <= g <= MAX_G else None


def words_bound(m: int, n: int, g: int) -> Tuple[float, str]:
    """The bit-parallel family's bound for an ``m``-column text against an
    ``n``-row query on its cheaper orientation."""
    planes = (2 * g + 1).bit_length()
    per_word = (25 if g == 1 else 50) * 2
    return min(bound(cols + (MATCH_PLANES + planes) * -(-rows // WORD) * 8,
                     cols * -(-rows // WORD) * per_word)
               for cols, rows in ((m, n), (n, m)))


def call_bound(config: dict, shapes: Iterable[Tuple[int, int]]) -> float:
    """Seconds: the least time of one call's pairs ``(m, n)`` under
    ``config``'s scheme, one after another."""
    shapes = list(shapes)
    g = family_g(config)
    if g is not None:
        return sum(words_bound(m, n, g)[0] for m, n in shapes)
    cells = sum(m * n for m, n in shapes)
    nbytes = sum(m + n for m, n in shapes) + (4 if len(shapes) == 1 else 28 * len(shapes))
    return bound(nbytes, band_ops(config, cells))[0]
