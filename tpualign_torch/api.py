"""Top-level API of the port: the counterpart of ``tpualign/api.py``'s
``resolve_impl``, ``align_score`` and ``align``.

The bit-parallel (1, 0, -g) family, g = 1..7, runs on the bit-parallel
engine; ``impl="oracle"`` scores with the NumPy row scan for any linear-gap
config, and ``align`` walks the full table for any linear-gap config up to
``FULL_TABLE_CELL_LIMIT`` cells.  Every other config raises
NotImplementedError naming the ROADMAP item that ports it; nothing runs
quietly on another engine or device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .config import EngineConfig, ScoringConfig
from .ops import bitpal, hirschberg, oracle

#: ``align`` walks the exact full table up to this many DP cells (as
#: ``tpualign.api.FULL_TABLE_CELL_LIMIT``), and bisects above it
FULL_TABLE_CELL_LIMIT = 16 * 1024 * 1024


def _unported(scoring: ScoringConfig) -> str:
    if scoring.is_affine:
        what = "affine (Gotoh) gaps"
    elif scoring.is_local:
        what = "local (Smith-Waterman) scoring"
    elif scoring.has_matrix:
        what = "substitution-matrix scoring"
    elif scoring.is_ends_free:
        what = f"{scoring.mode.name.lower()} (ends-free) scoring"
    else:
        what = "linear-gap scoring outside the (1, 0, -g) family"
    return (f"{what} is not ported yet: ROADMAP queue 1 item 8 "
            "(general-scoring score, kernel K6)")


def _unported_align(scoring: ScoringConfig) -> str:
    if scoring.is_affine:
        return ("alignment under affine (Gotoh) gaps past the full table is "
                "not ported yet: ROADMAP queue 1 item 10 (affine alignment)")
    if scoring.is_local:
        what = "local (Smith-Waterman) alignment"
    elif scoring.has_matrix or scoring.is_ends_free:
        what = "matrix or ends-free alignment"
    else:
        what = "linear-gap alignment outside the (1, 0, -g) family"
    return (f"{what} past the full table is not ported yet: ROADMAP queue 1 "
            "item 9 (general-scoring alignment, kernel K7)")


def resolve_impl(engine: EngineConfig, scoring: ScoringConfig) -> str:
    """The engine for ``engine.impl`` and ``scoring``: ``oracle`` when asked
    for, else ``bitpal``, which the port runs for the (1, 0, -g) family,
    g = 1..7; any other config raises NotImplementedError (its engine is
    not ported)."""
    if engine.impl == "oracle":
        return "oracle"
    if bitpal.family(scoring) is None:
        raise NotImplementedError(_unported(scoring))
    return "bitpal"


def align_score(
    s1: np.ndarray,
    s2: np.ndarray,
    scoring: ScoringConfig = ScoringConfig(),
    engine: EngineConfig = EngineConfig(),
) -> int:
    """Alignment score of ``s1`` vs ``s2`` (``.bdna`` codes), with the
    semantics of ``tpualign.align_score``.  Runs on ``engine.device``."""
    if resolve_impl(engine, scoring) == "oracle":
        return oracle.score(s1, s2, scoring)
    return bitpal.score(s1, s2, scoring, device=engine.device)


def align(
    s1: np.ndarray,
    s2: np.ndarray,
    scoring: ScoringConfig = ScoringConfig(),
    engine: EngineConfig = EngineConfig(),
) -> Tuple[int, str, str]:
    """Score plus aligned strings (gap ``-``) of ``s1`` (text, columns)
    against ``s2`` (query, rows), with the semantics of ``tpualign.align``.

    Up to ``FULL_TABLE_CELL_LIMIT`` cells: the exact full-table traceback
    (:func:`tpualign_torch.ops.oracle.traceback`), any linear-gap config,
    on the host.  Above it, a (1, 0, -g) family config runs the bit-parallel
    Hirschberg split (:func:`tpualign_torch.ops.hirschberg.align`) on
    ``engine.device``; its alignment is optimal, with a tie order that may
    differ from the oracle's.  Other configs raise NotImplementedError
    naming their ROADMAP item, and a query past the one-block fill's rows
    raises ValueError."""
    s1 = np.asarray(s1, dtype=np.int8)
    s2 = np.asarray(s2, dtype=np.int8)
    if (s1.size + 1) * (s2.size + 1) <= FULL_TABLE_CELL_LIMIT:
        return oracle.traceback(s1, s2, scoring)
    if engine.impl == "oracle":
        raise NotImplementedError(
            "the oracle walks at most FULL_TABLE_CELL_LIMIT cells; the "
            "checkpointed portable traceback is not ported yet: ROADMAP "
            "queue 1 item 12 (portable engines)"
        )
    if bitpal.family(scoring) is None:
        raise NotImplementedError(_unported_align(scoring))
    return hirschberg.align(s1, s2, scoring, device=engine.device)
