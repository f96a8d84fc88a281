"""Alignment of any pair through a block-checkpointed traceback: a row scan
on the device that keeps a sparse grid of checkpoints, and a block-by-block
walk on the host; the port of ``tpualign/ops/traceback.py``, the last
resort of ``align`` and its ``impl="oracle"``/``"xla"`` route past the full
table.

1. **Forward (device):** one row scan over the DP table
   (:func:`tpualign_torch.ops.xla.rows_scan`: ``tpualign``'s forward pass
   is an XLA ``lax.scan``, not a Pallas kernel, so the port's is plain
   PyTorch on the device) keeps every ``k``-th row, every row's values at
   every ``k``-th column (the edges of a k x k block grid) and, for local
   scoring, the row-major-first best cell.  O(N*M/k) memory.
2. **Backtrack (host, NumPy):** from the end cell (bottom-right, or the
   best cell), each visited block is refilled exactly from its top row and
   left column and walked with the reference's tie order (diag > up >
   left, ``serial.cpp:29-30``); O((N+M)/k) blocks, O((N+M)*k) cells.

Every refilled cell equals the full table's, so the strings are the
oracle's (:func:`tpualign_torch.ops.oracle.traceback`), string for string.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import ScoringConfig, ensure_pair_modes
from . import xla
from .bitpal import _device
from .oracle import BASES
from .oracle import traceback as full_traceback


def default_k(m: int, n: int) -> int:
    """``tpualign.ops.traceback.align_checkpointed``'s default stride: 512
    up to 4e9 cells, else about 64 MB of int32 checkpoints a side; a power
    of two, at least 64."""
    k = max(64, int((2 * m * n) / (64e6 / 4)) if m * n > 4e9 else 512)
    return 1 << (k - 1).bit_length()


def _refill_block(s1_seg: np.ndarray, s2_seg: np.ndarray, top: np.ndarray,
                  left: np.ndarray, cfg: ScoringConfig) -> np.ndarray:
    """Exact (h+1, w+1) sub-table from its top row (with the corner) and
    the column left of it, below the corner."""
    h, w = s2_seg.size, s1_seg.size
    H = np.empty((h + 1, w + 1), dtype=np.int64)
    H[0, :] = top
    H[1:, 0] = left
    jg = np.arange(w + 1, dtype=np.int64) * cfg.gap
    local = cfg.is_local
    s1_64 = s1_seg.astype(np.int64)
    T = np.empty(w + 1, dtype=np.int64)
    for i in range(1, h + 1):
        sub = np.where(s1_64 == s2_seg[i - 1], cfg.match, cfg.mismatch)
        T[0] = H[i, 0]
        np.maximum(H[i - 1, :-1] + sub, H[i - 1, 1:] + cfg.gap, out=T[1:])
        if local:
            np.maximum(T[1:], 0, out=T[1:])
        H[i] = np.maximum.accumulate(T - jg) + jg
    return H


def _walk_block(H: np.ndarray, s1_seg: np.ndarray, s2_seg: np.ndarray, li: int, lj: int,
                cfg: ScoringConfig, a1: List[str], a2: List[str]) -> Tuple[int, int, bool]:
    """Trace from local cell (li, lj) until leaving the block (or
    finishing).  Returns the local coordinates of the boundary cell
    reached and whether the walk ended (origin or local zero); appends the
    moves in reverse order."""
    g = cfg.gap
    local = cfg.is_local
    while li > 0 and lj > 0:
        if local and H[li, lj] == 0:
            return li, lj, True
        sub = cfg.match if s1_seg[lj - 1] == s2_seg[li - 1] else cfg.mismatch
        if H[li, lj] == H[li - 1, lj - 1] + sub:
            a1.append(BASES[s1_seg[lj - 1]])
            a2.append(BASES[s2_seg[li - 1]])
            li -= 1
            lj -= 1
        elif H[li, lj] == H[li - 1, lj] + g:
            a1.append("-")
            a2.append(BASES[s2_seg[li - 1]])
            li -= 1
        elif H[li, lj] == H[li, lj - 1] + g:
            a1.append(BASES[s1_seg[lj - 1]])
            a2.append("-")
            lj -= 1
        else:  # pragma: no cover
            raise AssertionError("no predecessor found: corrupt checkpoints")
        if local and H[li, lj] == 0:
            return li, lj, True
    return li, lj, False


def align_checkpointed(s1, s2, scoring: ScoringConfig = ScoringConfig(), *,
                       k: Optional[int] = None, device,
                       stats: Optional[dict] = None) -> Tuple[int, str, str]:
    """Score plus aligned strings of ``s1`` (columns) against ``s2``
    (rows), any size, the forward pass on ``device`` (``"cuda"`` or
    ``"cpu"``); the counterpart of
    ``tpualign.ops.traceback.align_checkpointed``, with its envelope
    (ValueError for matrix, ends-free and affine configs) and its default
    stride (:func:`default_k`).  String for string the oracle's.

    ``stats``, when given, gets ``k``, ``forward_s`` (the row scan, host
    clock, ending in a synchronize), ``copy_s`` (the checkpoints' copy to
    the host), ``blocks`` (blocks refilled) and ``walk_s``."""
    ensure_pair_modes(scoring, "traceback")
    if scoring.is_affine:
        raise ValueError(
            "affine gaps are outside the checkpointed traceback's envelope; "
            "small problems align via the oracle (see api.align)")
    s1 = np.asarray(s1, dtype=np.int8)
    s2 = np.asarray(s2, dtype=np.int8)
    M, N = int(s1.size), int(s2.size)
    if M == 0 or N == 0:
        if scoring.is_local:
            return 0, "", ""
        return full_traceback(s1, s2, scoring)
    if k is None:
        k = default_k(M, N)
    local = scoring.is_local
    dev = _device(device)

    t0 = time.perf_counter()
    scan = xla.rows_scan(torch.from_numpy(s1).to(dev), torch.from_numpy(s2).to(dev),
                         scoring, zero_row=local, zero_col=local,
                         capture_rows=range(k, N, k), want_cell=local, col_stride=k)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    forward_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    h0 = (np.zeros(M + 1, np.int64) if local
          else np.arange(M + 1, dtype=np.int64) * scoring.gap)
    row_ckpts = (np.concatenate([h0[None], scan.caps.cpu().numpy()])
                 if scan.caps is not None else h0[None])
    col_ckpts = scan.cols.cpu().numpy()
    cell = None if scan.cell is None else [int(x) for x in scan.cell.cpu()]
    copy_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    if local:
        score, i, j = cell
        if score <= 0:
            score, i, j = 0, 0, 0
    else:
        # H[N][M] comes from the refill of the block that holds it
        i, j = N, M
        score = None

    a1: List[str] = []
    a2: List[str] = []
    blocks = 0
    done = score == 0
    while not done and (i > 0 or j > 0):
        if i == 0 or j == 0:
            if local:
                break
            # ride the boundary straight to the origin
            while j > 0:
                a1.append(BASES[s1[j - 1]])
                a2.append("-")
                j -= 1
            while i > 0:
                a1.append("-")
                a2.append(BASES[s2[i - 1]])
                i -= 1
            break
        bi = (i - 1) // k
        bj = (j - 1) // k
        r0, r1 = bi * k, min((bi + 1) * k, N)
        c0, c1 = bj * k, min((bj + 1) * k, M)
        top = row_ckpts[bi, c0: c1 + 1]
        left = col_ckpts[r0: r1, bj]
        H = _refill_block(s1[c0:c1], s2[r0:r1], top, left, scoring)
        blocks += 1
        if score is None:
            score = int(H[i - r0, j - c0])
        li, lj, done = _walk_block(H, s1[c0:c1], s2[r0:r1], i - r0, j - c0, scoring, a1, a2)
        i, j = r0 + li, c0 + lj

    if stats is not None:
        stats.update(k=k, forward_s=forward_s, copy_s=copy_s, blocks=blocks,
                     walk_s=time.perf_counter() - t0)
    return int(score), "".join(reversed(a1)), "".join(reversed(a2))
