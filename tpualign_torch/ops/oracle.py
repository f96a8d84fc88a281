"""Plain NumPy score and traceback, the port's oracle: a row scan of the
DP table under linear and affine (Gotoh) gaps, in every mode (global,
local, semiglobal, infix) and with a substitution matrix, and the
full-table traceback (the affine one over three tables) with the
reference's diag > up > left tie order.  The same semantics as
``tpualign.ops.oracle`` (``tests/test_torch_api.py`` and
``tests/test_torch_traceback.py`` hold the two to each other), independent
of the bit-parallel engine it checks.

``s1`` runs across the columns and ``s2`` down the rows.  With linear gap
``g`` the in-row left dependency unrolls to
``H[i][j] = j*g + cummax_{k<=j}(T[k] - k*g)``, a ``np.maximum.accumulate``;
the affine row resolves its in-row gap the same way (:func:`_affine_row`).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..config import ScoringConfig

#: one character per ``.bdna`` code (``tpualign/io/bdna.py``'s BASES): code 0
#: is the gap byte ``-``, 1..4 are ``ATGC``, 5..15 the IUPAC ambiguity codes
BASES = "-ATGCRYSWKMBDHVN"

#: -inf stand-in for the affine gap matrices, far from int64 limits
NEG = -(np.int64(1) << np.int64(62))


def _sub_row(s1: np.ndarray, base: int, cfg: ScoringConfig) -> np.ndarray:
    if cfg.matrix is not None:
        mat = np.asarray(cfg.matrix, dtype=np.int64)
        if (s1.size and (s1.min() < 0 or s1.max() >= mat.shape[0])) or not (
            0 <= base < mat.shape[0]
        ):
            raise ValueError("sequence codes outside the matrix alphabet")
        return mat[s1, base]
    return np.where(s1 == base, np.int64(cfg.match), np.int64(cfg.mismatch))


def _affine_row(H, F, sub, i, jext, open_, ext, local, zero_col=False):
    """One Gotoh row: returns (H_new, F_new) given the previous row.

    ``F`` (vertical gap) is elementwise; the in-row ``E`` (horizontal gap)
    dependency unrolls -- with ``open <= 0`` a gap reopened from a
    gap-ended cell never beats extending, so
    ``E[j] = open + j*ext + cummax_{k<j}(T[k] - k*ext)`` over the gap-free
    candidates ``T`` alone.  The port of ``tpualign.ops.oracle._affine_row``.
    """
    M = H.size - 1
    Fn = np.maximum(H + open_, F) + ext
    T = np.empty(M + 1, dtype=np.int64)
    T[0] = 0 if (local or zero_col) else open_ + i * ext
    np.maximum(H[:-1] + sub, Fn[1:], out=T[1:])
    if local:
        np.maximum(T, 0, out=T)
    C = np.maximum.accumulate(T - jext)
    E = np.concatenate(([NEG], C[:-1])) + open_ + jext
    return np.maximum(T, E), Fn


def _affine_top(M: int, cfg: ScoringConfig, zero_row: bool):
    """Row 0 of an affine table, ``(H, F, jext)``: H(0, j) = open + j*ext
    (0 at j = 0, or everywhere under a free start) and F(0, :) = -inf."""
    open_, ext = np.int64(cfg.gap_open), np.int64(cfg.gap_extend)
    jext = np.arange(M + 1, dtype=np.int64) * ext
    H = np.zeros(M + 1, dtype=np.int64)
    if not zero_row:
        H[1:] = open_ + jext[1:]
    return H, np.full(M + 1, NEG, dtype=np.int64), jext


def score(s1, s2, cfg: ScoringConfig = ScoringConfig()) -> int:
    """Alignment score in O(len(s1)) memory, linear or affine gaps."""
    s1 = np.asarray(s1, dtype=np.int64)
    s2 = np.asarray(s2, dtype=np.int64)
    g = np.int64(cfg.gap)
    local = cfg.is_local
    zero_col = local or cfg.free_start_s2  # H(i, 0) = 0
    zero_row = local or cfg.free_start_s1  # H(0, j) = 0
    if cfg.is_affine:
        H, F, jext = _affine_top(s1.size, cfg, zero_row)
        best = np.int64(0)
        best_col = H[-1]  # running max over the last column (ends-free)
        for i in range(1, s2.size + 1):
            sub = _sub_row(s1, int(s2[i - 1]), cfg)
            H, F = _affine_row(H, F, sub, i, jext, cfg.gap_open,
                               cfg.gap_extend, local, zero_col=zero_col)
            if local:
                best = max(best, H.max())
            best_col = max(best_col, H[-1])
        return _extract(H, best, best_col, cfg)
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
    return _extract(H, best, best_col, cfg)


def _extract(H, best, best_col, cfg: ScoringConfig) -> int:
    """The score from the last row ``H``, the running max ``best`` (local)
    and the last column's max ``best_col`` (ends-free)."""
    if cfg.is_local:
        return int(best)
    if cfg.free_end_s1:
        row_best = H.max()
        return int(max(row_best, best_col) if cfg.free_end_s2 else row_best)
    return int(H[-1])


def score_table(s1, s2, cfg: ScoringConfig = ScoringConfig()) -> np.ndarray:
    """Full ``(N+1, M+1)`` int32 DP table (H), linear or affine gaps (the
    port of ``tpualign.ops.oracle.score_table``).  O(N*M) memory: small
    inputs only."""
    if cfg.is_affine:
        return affine_tables(s1, s2, cfg)[0].astype(np.int32)
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


def affine_tables(s1, s2, cfg: ScoringConfig, tb=None):
    """The exact ``(N+1, M+1)`` int64 Gotoh tables ``(H, E, F)`` of an
    affine ``cfg`` (E a horizontal gap, F a vertical one), with the top-edge
    open ``tb`` (default ``cfg.gap_open``; Myers-Miller waives it with 0):
    F(0, j) = H(0, j) + tb and H(i, 0) = tb + i*ext, so that a vertical gap
    from the top edge opens at ``tb``.  ``tb`` lies in ``[gap_open, 0]``.

    E comes from the cummax identity of :func:`_affine_row` and equals the
    sequential recurrence ``E[i][j] = max(H[i][j-1] + open, E[i][j-1]) +
    ext`` cell for cell (``open <= 0``), so a walk's predecessor tests see
    the values ``tpualign.ops.oracle._traceback_affine`` fills cell by cell.
    Row 0's E is that recurrence along row 0 (local: -inf), column 0's E is
    -inf."""
    s1 = np.asarray(s1, dtype=np.int64)
    s2 = np.asarray(s2, dtype=np.int64)
    M, N = s1.size, s2.size
    local = cfg.is_local
    zero_col = local or cfg.free_start_s2
    open_, ext = np.int64(cfg.gap_open), np.int64(cfg.gap_extend)
    tb = open_ if tb is None else np.int64(tb)
    H = np.zeros((N + 1, M + 1), dtype=np.int64)
    E = np.full((N + 1, M + 1), NEG, dtype=np.int64)
    F = np.full((N + 1, M + 1), NEG, dtype=np.int64)
    H[0], _, jext = _affine_top(M, cfg, local or cfg.free_start_s1)
    F[0] = H[0] + tb
    T = np.empty(M + 1, dtype=np.int64)
    for i in range(1, N + 1):
        F[i] = np.maximum(H[i - 1] + open_, F[i - 1]) + ext
        T[0] = 0 if zero_col else tb + i * ext
        np.maximum(H[i - 1, :-1] + _sub_row(s1, int(s2[i - 1]), cfg), F[i, 1:], out=T[1:])
        if local:
            np.maximum(T, 0, out=T)
        E[i, 1:] = np.maximum.accumulate(T - jext)[:-1] + open_ + jext[1:]
        H[i] = np.maximum(T, E[i])
    if not local:
        E[0, 1:] = np.maximum.accumulate(H[0] - jext)[:-1] + open_ + jext[1:]
    return H, E, F


def _traceback_affine(s1, s2, cfg: ScoringConfig) -> Tuple[int, str, str]:
    """Gotoh three-state walk over :func:`affine_tables`, the port of
    ``tpualign.ops.oracle._traceback_affine``: diag > up (F) > left (E),
    and inside a gap state closing (an H predecessor) beats extending."""
    H, E, F = affine_tables(s1, s2, cfg)
    local = cfg.is_local
    i, j = _start(H, cfg)
    sc = int(H[i, j])
    open_ext = cfg.gap_open + cfg.gap_extend
    a1: List[str] = []
    a2: List[str] = []
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            if local and H[i, j] == 0:
                break
            if (cfg.free_start_s1 and i == 0) or (cfg.free_start_s2 and j == 0):
                break
            diag_ok = i > 0 and j > 0
            if diag_ok and H[i, j] == H[i - 1, j - 1] + cfg.sub_score(int(s1[j - 1]),
                                                                      int(s2[i - 1])):
                a1.append(BASES[s1[j - 1]])
                a2.append(BASES[s2[i - 1]])
                i, j = i - 1, j - 1
            elif i > 0 and H[i, j] == F[i, j]:
                state = "F"
            elif j > 0 and H[i, j] == E[i, j]:
                state = "E"
            else:  # pragma: no cover - would indicate a broken table
                raise AssertionError(f"no predecessor at H({i},{j})")
        elif state == "F":
            a1.append("-")
            a2.append(BASES[s2[i - 1]])
            close = F[i, j] == H[i - 1, j] + open_ext
            i -= 1
            state = "H" if close else "F"
        else:  # E
            a1.append(BASES[s1[j - 1]])
            a2.append("-")
            close = E[i, j] == H[i, j - 1] + open_ext
            j -= 1
            state = "H" if close else "E"
    return sc, "".join(reversed(a1)), "".join(reversed(a2))


def _start(H: np.ndarray, cfg: ScoringConfig) -> Tuple[int, int]:
    """The walk's start cell: local, the row-major first maximum; ends-free,
    :func:`_ends_free_start`; global, the bottom-right cell."""
    if cfg.is_local:
        i, j = np.unravel_index(int(np.argmax(H)), H.shape)
        return int(i), int(j)
    if cfg.is_ends_free:
        return _ends_free_start(H, cfg)
    return H.shape[0] - 1, H.shape[1] - 1


def traceback(s1, s2, cfg: ScoringConfig = ScoringConfig()) -> Tuple[int, str, str]:
    """Score plus aligned strings (gap char ``-``), from the full table; the
    port of ``tpualign.ops.oracle.traceback``, linear and affine gaps.

    Tie order diag > up > left mirrors the branchless max of the reference
    (a later candidate replaces only on a strictly greater value); under
    affine gaps up and left are the F and E states (:func:`_traceback_affine`).
    For Smith-Waterman the path starts at the maximum cell (row-major first
    occurrence) and stops at the first zero cell.  Ends-free modes
    (semiglobal/infix) start at the maximum boundary cell, last row first,
    then last column, first occurrence, and stop when a free start is
    reached; like SW, the returned strings cover only the aligned core.
    """
    s1 = np.asarray(s1, dtype=np.int64)
    s2 = np.asarray(s2, dtype=np.int64)
    if cfg.is_affine:
        return _traceback_affine(s1, s2, cfg)
    H = score_table(s1, s2, cfg).astype(np.int64)
    local = cfg.is_local
    i, j = _start(H, cfg)
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
