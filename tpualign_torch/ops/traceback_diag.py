"""Alignment with the reference's tie order at any size the diagonal axis
takes: the checkpointed diagonal fill on the device and a band-by-band
walk on the host; the port of ``tpualign/ops/traceback_diag.py``.

1. **Forward (device):** the checkpointed fill
   (:func:`tpualign_torch.ops.pallas_diag.forward_checkpoints`, K9's port
   ``csrc/diag_ckpt.cu``) keeps the diagonals ``c*K`` and ``c*K - 1`` for
   every group of ``K`` diagonals, O((N+M)/K * N) memory, and under local
   scoring each row's maximum and the diagonal that first reached it.
2. **Backtrack (host, NumPy):** the path is walked band by band.  Band
   ``c`` covers diagonals ``(cK, (c+1)K]``; its cells are refilled exactly
   from checkpoint ``c`` on a window of 2K+1 slots around the path (the
   dependence cone of any path cell stays inside it; boundary cells are
   re-injected), so the walk sees the full table's values and follows the
   reference's tie order (diag > up > left, ``serial.cpp:29-30``) and, for
   local scoring, the row-major-first maximum cell.

The result is string for string ``tpualign``'s ``align_diag`` and the
port's :func:`tpualign_torch.ops.oracle.traceback`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..config import ScoringConfig, ensure_pair_modes
from . import pallas_diag
from .bitpal import _device
from .oracle import BASES
from .oracle import traceback as full_traceback

NEG = pallas_diag.NEG_INF


class _BandCache:
    """Exact refill of one diagonal band restricted to a slot window (the
    port of ``tpualign.ops.traceback_diag._BandCache``)."""

    def __init__(self, c: int, k_hi: int, ck_a: np.ndarray, ck_b: np.ndarray,
                 s1: np.ndarray, s2: np.ndarray, K: int, cfg: ScoringConfig):
        n, m = s2.size, s1.size
        total = n + m
        d0 = c * K  # checkpoint diagonal (t index 1); t=0 is diagonal d0-1
        self.d0 = d0
        self.wlo = max(0, k_hi - 2 * K)
        whi = min(n, k_hi)
        W = whi - self.wlo + 1
        t_max = min(K, total - d0)  # diagonals d0+1 .. d0+t_max
        H = np.empty((t_max + 2, W), dtype=np.int64)
        H[0] = ck_b[c, self.wlo: whi + 1]
        H[1] = ck_a[c, self.wlo: whi + 1]
        if c == 0:
            # synthetic seeds: diag -1 has no cells; diag 0 is H(0,0)=0
            H[0] = NEG
            H[1] = NEG
            if self.wlo == 0:
                H[1][0] = 0
        g = cfg.gap
        local = cfg.is_local
        ks = np.arange(self.wlo, whi + 1, dtype=np.int64)  # absolute slots
        s1p = np.full(total + 2 * K + 4, -9, dtype=np.int64)
        s1p[:m] = s1
        s2p = np.full(n + 1, -7, dtype=np.int64)
        s2p[1:] = s2
        s2k = s2p[np.clip(ks, 0, n)]  # s2[k-1] per slot (k=0 dummy)
        up = np.empty(W, dtype=np.int64)
        dg = np.empty(W, dtype=np.int64)
        up[0] = NEG  # outside the window: cone-safe for path cells
        dg[0] = NEG
        for t in range(2, t_max + 2):
            d = d0 - 1 + t
            # s1[d-1-k] per slot, dead indices map to the -9 pad
            j_idx = np.clip(d - 1 - ks, 0, s1p.size - 1)
            sub = np.where(s1p[j_idx] == s2k, cfg.match, cfg.mismatch)
            prev = H[t - 1]
            up[1:] = prev[:-1]
            dg[1:] = H[t - 2][:-1]
            row = np.maximum(dg + sub, np.maximum(up, prev) + g)
            if local:
                np.maximum(row, 0, out=row)
            bval = 0 if local else d * g
            if self.wlo == 0:
                row[0] = bval  # i = 0 boundary
            if self.wlo <= d <= whi:
                row[d - self.wlo] = bval  # j = 0 boundary
            H[t] = row
        self.H = H
        self.whi = whi

    def value(self, d: int, k: int) -> int:
        return int(self.H[d - self.d0 + 1, k - self.wlo])

    def contains(self, d: int, k: int) -> bool:
        return (self.d0 - 1 <= d <= self.d0 + self.H.shape[0] - 2
                and self.wlo <= k <= self.whi)


def _walk(s1: np.ndarray, s2: np.ndarray, cfg: ScoringConfig, ck_a: np.ndarray,
          ck_b: np.ndarray, K: int, d: int, k: int,
          counts: dict) -> Tuple[int, str, str]:
    """Backtrack from cell (diag d, slot k) to the start; returns (score
    at the start cell, aligned strings).  ``counts["bands"]`` counts the
    bands refilled."""
    g = cfg.gap
    local = cfg.is_local
    a1: List[str] = []
    a2: List[str] = []
    band = None

    def get(dd: int, kk: int) -> int:
        nonlocal band
        if band is None or not band.contains(dd, kk):
            c = max(0, (dd - 1) // K) if dd > 0 else 0
            band = _BandCache(c, k, ck_a, ck_b, s1, s2, K, cfg)
            counts["bands"] += 1
        return band.value(dd, kk)

    score = get(d, k)
    while True:
        i, j = k, d - k
        if i == 0 or j == 0:
            if not local:
                while j > 0:
                    a1.append(BASES[s1[j - 1]])
                    a2.append("-")
                    j -= 1
                while i > 0:
                    a1.append("-")
                    a2.append(BASES[s2[i - 1]])
                    i -= 1
            break
        h = get(d, k)
        if local and h == 0:
            break
        sub = cfg.match if s1[j - 1] == s2[i - 1] else cfg.mismatch
        if get(d - 2, k - 1) + sub == h:
            a1.append(BASES[s1[j - 1]])
            a2.append(BASES[s2[i - 1]])
            d, k = d - 2, k - 1
        elif get(d - 1, k - 1) + g == h:
            a1.append("-")
            a2.append(BASES[s2[i - 1]])
            d, k = d - 1, k - 1
        elif get(d - 1, k) + g == h:
            a1.append(BASES[s1[j - 1]])
            a2.append("-")
            d = d - 1
        else:  # pragma: no cover
            raise AssertionError(f"no predecessor at diag {d} slot {k}")

    return score, "".join(reversed(a1)), "".join(reversed(a2))


def align_diag(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, k_stride: int = 1024,
               device, stats: Optional[dict] = None) -> Tuple[int, str, str]:
    """Score plus aligned strings of ``s1`` (columns) against ``s2`` (rows,
    the diagonal axis) through the checkpointed diagonal fill on ``device``
    (``"cuda"`` runs K9's port, ``"cpu"`` its plain version) and the band
    walk on the host; the counterpart of
    ``tpualign.ops.traceback_diag.align_diag``.

    String for string ``tpualign``'s and the oracle's: the same tie order
    and, for local scoring, the same row-major-first maximum cell.  Refuses
    (ValueError) matrix and ends-free configs, affine gaps and what
    :func:`tpualign_torch.ops.pallas_diag.forward_checkpoints` refuses.
    ``k_stride`` is clamped to ``[8, 2^20]`` and rounded up to a multiple
    of 8.

    ``stats``, when given, gets ``fill_ms`` (the fill's time: CUDA events
    on CUDA, the host clock on the CPU), ``copy_s`` (the checkpoints' copy
    to the host), ``groups``, ``bands`` (bands refilled) and ``walk_s``.
    The spans (:mod:`tpualign_torch.trace`) ``fill`` (on the CPU
    ``fill_ms``), ``copy`` (``copy_s``) and ``walk`` (``walk_s``); the
    counter ``bands``."""
    ensure_pair_modes(cfg, "traceback_diag")
    if cfg.is_affine:
        raise ValueError(
            "affine gaps are outside the diagonal traceback's envelope; "
            "small problems align via the oracle (see api.align)")
    s1 = np.asarray(s1, dtype=np.int8)
    s2 = np.asarray(s2, dtype=np.int8)
    m, n = int(s1.size), int(s2.size)
    if m == 0 or n == 0:
        return full_traceback(s1, s2, cfg)

    K = pallas_diag.ckpt_stride(k_stride)
    dev = _device(device)
    cuda = dev.type == "cuda"
    timed = stats is not None
    with trace.span("fill", timed) as fill:
        if cuda:
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            e0.record()
        ck = pallas_diag.forward_checkpoints(s1, s2, cfg, k_stride=K, device=dev)
        if cuda:
            e1.record()
            e1.synchronize()
    with trace.span("copy", timed) as copy:
        # the checkpoints stay int32 on the host; bands upcast their window
        ck_a = ck.cka.cpu().numpy()
        ck_b = ck.ckb.cpu().numpy()
        best = None if ck.v is None else (ck.v.cpu().numpy().astype(np.int64),
                                          ck.dbest.cpu().numpy().astype(np.int64))
    counts = dict(bands=0)
    with trace.span("walk", timed) as walk:
        if best is not None:
            vf, dbest = best
            score = int(vf.max(initial=0))
            if score <= 0:
                out = 0, "", ""
            else:
                k0 = int(np.argmax(vf))  # smallest slot (= row) holding the max
                out = _walk(s1, s2, cfg, ck_a, ck_b, K, int(dbest[k0]), k0, counts)
                assert out[0] == score
        else:
            out = _walk(s1, s2, cfg, ck_a, ck_b, K, n + m, n, counts)
    trace.count("bands", counts["bands"])
    if stats is not None:
        fill_ms = e0.elapsed_time(e1) if cuda else fill.seconds * 1e3
        stats.update(fill_ms=fill_ms, copy_s=copy.seconds, groups=ck_a.shape[0],
                     bands=counts["bands"], walk_s=walk.seconds)
    return out
