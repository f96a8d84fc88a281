"""Plain NumPy score and traceback, the port's oracle: a row scan of the
DP table under linear gaps, in every mode (global, local, semiglobal,
infix) and with a substitution matrix, and the full-table traceback with
the reference's diag > up > left tie order.  The same semantics as
``tpualign.ops.oracle`` (``tests/test_torch_api.py`` and
``tests/test_torch_traceback.py`` hold the two to each other), independent
of the bit-parallel engine it checks.

``s1`` runs across the columns and ``s2`` down the rows.  With linear gap
``g`` the in-row left dependency unrolls to
``H[i][j] = j*g + cummax_{k<=j}(T[k] - k*g)``, a ``np.maximum.accumulate``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..config import ScoringConfig

#: one character per ``.bdna`` code (``tpualign/io/bdna.py``'s BASES): code 0
#: is the gap byte ``-``, 1..4 are ``ATGC``, 5..15 the IUPAC ambiguity codes
BASES = "-ATGCRYSWKMBDHVN"

_AFFINE = ("the oracle's affine (Gotoh) {} is not ported yet: ROADMAP queue 1 "
           "item 12 (portable engines)")


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
        raise NotImplementedError(_AFFINE.format("score"))
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


def score_table(s1, s2, cfg: ScoringConfig = ScoringConfig()) -> np.ndarray:
    """Full ``(N+1, M+1)`` int32 DP table, linear gaps (the port of
    ``tpualign.ops.oracle.score_table``).  O(N*M) memory: small inputs only.
    Affine gaps raise NotImplementedError (not ported yet)."""
    if cfg.is_affine:
        raise NotImplementedError(_AFFINE.format("table"))
    s1 = np.asarray(s1, dtype=np.int64)
    s2 = np.asarray(s2, dtype=np.int64)
    M, N = s1.size, s2.size
    g = np.int64(cfg.gap)
    local = cfg.is_local
    zero_col = local or cfg.free_start_s2  # H(i, 0) = 0
    zero_row = local or cfg.free_start_s1  # H(0, j) = 0
    H = np.zeros((N + 1, M + 1), dtype=np.int64)
    jg = np.arange(M + 1, dtype=np.int64) * g
    if not zero_row:
        H[0, :] = jg
    if not zero_col:
        H[:, 0] = np.arange(N + 1, dtype=np.int64) * g
    for i in range(1, N + 1):
        sub = _sub_row(s1, int(s2[i - 1]), cfg)
        T = np.empty(M + 1, dtype=np.int64)
        T[0] = 0 if zero_col else H[i - 1, 0] + g
        np.maximum(H[i - 1, :-1] + sub, H[i - 1, 1:] + g, out=T[1:])
        if local:
            np.maximum(T, 0, out=T)
        # resolve the in-row left dependency with a running max
        H[i] = np.maximum.accumulate(T - jg) + jg
    return H.astype(np.int32)


def traceback(s1, s2, cfg: ScoringConfig = ScoringConfig()) -> Tuple[int, str, str]:
    """Score plus aligned strings (gap char ``-``), from the full table; the
    port of ``tpualign.ops.oracle.traceback`` for linear gaps.

    Tie order diag > up > left mirrors the branchless max of the reference
    (a later candidate replaces only on a strictly greater value).  For
    Smith-Waterman the path starts at the maximum cell (row-major first
    occurrence) and stops at the first zero cell.  Ends-free modes
    (semiglobal/infix) start at the maximum boundary cell, last row first,
    then last column, first occurrence, and stop when a free start is
    reached; like SW, the returned strings cover only the aligned core.
    Affine gaps raise NotImplementedError (not ported yet).
    """
    if cfg.is_affine:
        raise NotImplementedError(_AFFINE.format("traceback"))
    s1 = np.asarray(s1, dtype=np.int64)
    s2 = np.asarray(s2, dtype=np.int64)
    H = score_table(s1, s2, cfg).astype(np.int64)
    local = cfg.is_local
    if local:
        i, j = np.unravel_index(int(np.argmax(H)), H.shape)
    elif cfg.is_ends_free:
        i, j = _ends_free_start(H, cfg)
    else:
        i, j = s2.size, s1.size
    sc = int(H[i, j])
    a1: List[str] = []
    a2: List[str] = []
    g = cfg.gap
    while i > 0 or j > 0:
        if local and H[i, j] == 0:
            break
        if (cfg.free_start_s1 and i == 0) or (cfg.free_start_s2 and j == 0):
            break
        diag_ok = i > 0 and j > 0
        if diag_ok:
            subs = int(cfg.sub_score(int(s1[j - 1]), int(s2[i - 1])))
        if diag_ok and H[i, j] == H[i - 1, j - 1] + subs:
            a1.append(BASES[s1[j - 1]])
            a2.append(BASES[s2[i - 1]])
            i, j = i - 1, j - 1
        elif i > 0 and H[i, j] == H[i - 1, j] + g:
            a1.append("-")
            a2.append(BASES[s2[i - 1]])
            i -= 1
        elif j > 0 and H[i, j] == H[i, j - 1] + g:
            a1.append(BASES[s1[j - 1]])
            a2.append("-")
            j -= 1
        else:  # pragma: no cover - would indicate a broken table
            raise AssertionError(f"no predecessor at ({i},{j})")
    return sc, "".join(reversed(a1)), "".join(reversed(a2))


def _ends_free_start(H: np.ndarray, cfg: ScoringConfig) -> Tuple[int, int]:
    """Best boundary cell for semiglobal/infix walks: scan the last row
    (if the s1 end is free), then the last column (if the s2 end is free);
    first occurrence of the maximum wins."""
    N, M = H.shape[0] - 1, H.shape[1] - 1
    best = None
    if cfg.free_end_s1:
        j = int(np.argmax(H[N, :]))
        best = (int(H[N, j]), N, j)
    if cfg.free_end_s2:
        i = int(np.argmax(H[:, M]))
        cand = (int(H[i, M]), i, M)
        if best is None or cand[0] > best[0]:
            best = cand
    if best is None:  # pragma: no cover - modes guarantee a free end
        best = (int(H[N, M]), N, M)
    return best[1], best[2]


def alignment_score(a1: str, a2: str, cfg: ScoringConfig = ScoringConfig()) -> int:
    """Re-score an aligned pair: the property check that a traceback is
    valid.  Affine configs charge ``gap_open`` once per maximal gap run plus
    ``gap_extend`` per gap column; linear configs charge ``gap`` per
    column."""
    if len(a1) != len(a2):
        raise ValueError("aligned strings differ in length")
    sc = 0
    in_gap1 = in_gap2 = False
    for x, y in zip(a1, a2):
        if x == "-" or y == "-":
            if cfg.is_affine:
                opening = (x == "-" and not in_gap1) or (y == "-" and not in_gap2)
                sc += (cfg.gap_open if opening else 0) + cfg.gap_extend
            else:
                sc += cfg.gap
        elif cfg.matrix is not None:
            sc += cfg.sub_score(BASES.index(x), BASES.index(y))
        elif x == y:
            sc += cfg.match
        else:
            sc += cfg.mismatch
        in_gap1, in_gap2 = x == "-", y == "-"
    return sc
