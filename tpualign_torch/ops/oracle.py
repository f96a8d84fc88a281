"""Plain NumPy score, the port's oracle: a row scan of the DP table under
linear gaps, in every mode (global, local, semiglobal, infix) and with a
substitution matrix.  The same semantics as ``tpualign.ops.oracle.score``
(``tests/test_torch_api.py`` holds the two to each other), independent of
the bit-parallel engine it checks.

``s1`` runs across the columns and ``s2`` down the rows.  With linear gap
``g`` the in-row left dependency unrolls to
``H[i][j] = j*g + cummax_{k<=j}(T[k] - k*g)``, a ``np.maximum.accumulate``.
"""

from __future__ import annotations

import numpy as np

from ..config import ScoringConfig


def _sub_row(s1: np.ndarray, base: int, cfg: ScoringConfig) -> np.ndarray:
    if cfg.matrix is not None:
        mat = np.asarray(cfg.matrix, dtype=np.int64)
        if (s1.size and (s1.min() < 0 or s1.max() >= mat.shape[0])) or not (
            0 <= base < mat.shape[0]
        ):
            raise ValueError("sequence codes outside the matrix alphabet")
        return mat[s1, base]
    return np.where(s1 == base, np.int64(cfg.match), np.int64(cfg.mismatch))


def score(s1, s2, cfg: ScoringConfig = ScoringConfig()) -> int:
    """Alignment score in O(len(s1)) memory.  Affine gaps raise
    NotImplementedError (not ported yet)."""
    if cfg.is_affine:
        raise NotImplementedError(
            "the oracle's affine (Gotoh) score is not ported yet: ROADMAP "
            "queue 1 item 12 (portable engines)"
        )
    s1 = np.asarray(s1, dtype=np.int64)
    s2 = np.asarray(s2, dtype=np.int64)
    g = np.int64(cfg.gap)
    local = cfg.is_local
    zero_col = local or cfg.free_start_s2  # H(i, 0) = 0
    zero_row = local or cfg.free_start_s1  # H(0, j) = 0
    jg = np.arange(s1.size + 1, dtype=np.int64) * g
    H = np.zeros_like(jg) if zero_row else jg.copy()
    best = np.int64(0)
    best_col = H[-1]  # running max over the last column
    T = np.empty_like(jg)
    for base in s2:
        T[0] = 0 if zero_col else H[0] + g
        np.maximum(H[:-1] + _sub_row(s1, int(base), cfg), H[1:] + g, out=T[1:])
        if local:
            np.maximum(T, 0, out=T)
        H = np.maximum.accumulate(T - jg) + jg
        if local:
            best = max(best, H.max())
        best_col = max(best_col, H[-1])
    if local:
        return int(best)
    if cfg.free_end_s1:
        row_best = H.max()
        return int(max(row_best, best_col) if cfg.free_end_s2 else row_best)
    return int(H[-1])
