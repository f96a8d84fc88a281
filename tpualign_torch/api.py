"""Top-level API of the port: the counterpart of ``tpualign/api.py``'s score
path (``resolve_impl`` and ``align_score``).

Only the bit-parallel g = 1 family runs on the bit-parallel engine so far;
``impl="oracle"`` runs the NumPy row scan for any linear-gap config.  Every
other config raises NotImplementedError naming the ROADMAP item that ports
it; nothing runs quietly on another engine or device.
"""

from __future__ import annotations

import numpy as np

from .config import EngineConfig, ScoringConfig
from .ops import bitpal, oracle


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
        fam = bitpal.family(scoring)
        if fam is not None:
            return (f"the (1, 0, -{fam[1]}) family is not ported yet: ROADMAP "
                    "queue 1 item 6 (kernel K2)")
        what = "linear-gap scoring outside the (1, 0, -g) family"
    return (f"{what} is not ported yet: ROADMAP queue 1 item 8 "
            "(general-scoring score, kernel K6)")


def resolve_impl(engine: EngineConfig, scoring: ScoringConfig) -> str:
    """The engine for ``engine.impl`` and ``scoring``: ``oracle`` when asked
    for, else ``bitpal``, which the port runs for the g = 1 family only; any
    other config raises NotImplementedError (its engine is not ported)."""
    if engine.impl == "oracle":
        return "oracle"
    fam = bitpal.family(scoring)
    if fam is None or fam[1] != 1:
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
