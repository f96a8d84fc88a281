"""Row-scan scorer in plain PyTorch on the device of its tensors: the port of
``tpualign/ops/xla.py:score``.  It holds no XLA; the module keeps its
counterpart's name so that a reader finds one from the other.

It is the port's portable engine (``impl="xla"``), any scoring config, and
the one plain PyTorch version that the band and diagonal kernels are held
against (:func:`tpualign_torch.ops.band.score_plain`,
:func:`tpualign_torch.ops.pallas_diag.score_plain`).

``text`` runs across the columns (length m) and ``query`` down the rows
(length n).  One DP row is a handful of tensor ops over the whole row: the
in-row left dependency ``H[j] = max(T[j], H[j-1] + g)`` unrolls to
``H = j*g + cummax(T - j*g)`` (``torch.cummax`` in place of
``associative_scan``), and under affine gaps the horizontal gap ``E``
resolves by the same scan over the gap-free candidates (valid because
``gap_open <= 0``, see ``ops/oracle.py:_affine_row``).  Values are int64,
exact for any config; the query's codes are read to the host once, so the
row loop never waits on the device.

:func:`score_batch` runs the same recurrence over a batch of pairs at once
(one row of every pair a step, rows past a pair's query frozen): the plain
version of the batch kernel ``band_batch_fill``
(:func:`tpualign_torch.ops.band_batch.batch_fill`) and, behind
:func:`score_batch_affine`, the port of ``tpualign/ops/xla.py``'s
``score_batch_affine``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AlignMode, ScoringConfig
from .bitpal import _device
from .pairs import Pairs, batch_lengths, pack_pairs, pad_pairs

#: -inf stand-in for the affine gap rows: far below any score, and far from
#: int64's limits after a few gap charges
NEG = -(2**40)


def _profile(text: torch.Tensor, codes: list, cfg: ScoringConfig):
    """``(table, row_of)``: ``table[row_of[b]]`` is the substitution row of
    query code ``b`` against every text column (int64, on the text's
    device)."""
    dev = text.device
    t = text.long()
    if cfg.has_matrix:
        mat = torch.tensor(cfg.matrix, dtype=torch.int64, device=dev)
        return mat.t()[:, t], {c: c for c in range(len(cfg.matrix))}
    uniq = sorted(set(codes))
    u = torch.tensor(uniq, dtype=torch.int64, device=dev)
    table = torch.where(t[None, :] == u[:, None], cfg.match, cfg.mismatch)
    return table, {c: r for r, c in enumerate(uniq)}


def gap_run(cfg: ScoringConfig, length: int) -> int:
    """Score of one all-gap run of ``length`` (> 0) cells."""
    if cfg.is_affine:
        return cfg.gap_open + cfg.gap_extend * length
    return cfg.gap * length


def check_pair(a: torch.Tensor, b: torch.Tensor, names: Tuple[str, str]) -> None:
    """ValueError unless ``a`` and ``b`` are non-empty contiguous 1-D int8
    tensors on one device (the kernels' code arguments)."""
    for name, t in zip(names, (a, b)):
        if t.dtype != torch.int8 or t.dim() != 1 or t.numel() == 0:
            raise ValueError(f"{name} must be a non-empty 1-D int8 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device != b.device:
        raise ValueError(f"{names[0]} on {a.device} but {names[1]} on {b.device}")


def check_codes(s1, s2, cfg: ScoringConfig) -> None:
    """Matrix configs score codes ``0..K-1`` only: ValueError otherwise, as
    ``tpualign.ops.oracle`` refuses them (a gather past the matrix would
    fault on the device)."""
    if not cfg.has_matrix:
        return
    K = len(cfg.matrix)
    for s in (s1, s2):
        if s.numel() and (int(s.min()) < 0 or int(s.max()) >= K):
            raise ValueError("sequence codes outside the matrix alphabet")


class Scan(NamedTuple):
    """What :func:`rows_scan` returns; each part it was not asked for is
    None (``h`` is always there)."""

    h: torch.Tensor  # the last row H(n, 0..m)
    best: Optional[torch.Tensor]  # 0-d: the max over rows 1..n
    col: Optional[torch.Tensor]  # (n,): the last column H(1..n, m)
    caps: Optional[torch.Tensor]  # (J, m+1): the captured rows
    cell: Optional[torch.Tensor]  # (3,): the located cell (v, i, j)
    f: Optional[torch.Tensor]  # (m+1,): affine, the last row F(n, 0..m)


def rows_scan(
    text: torch.Tensor,
    query: torch.Tensor,
    cfg: ScoringConfig,
    *,
    zero_row: bool,
    zero_col: bool,
    want_best: bool = False,
    want_col: bool = False,
    capture_rows=(),
    want_cell: bool = False,
    tb: Optional[int] = None,
) -> Scan:
    """Fill the table of ``text`` (columns) against ``query`` (rows), both
    non-empty code tensors on one device, one row at a time.

    ``zero_row``: H(0, j) = 0 (else the gap charges of ``cfg``);
    ``zero_col``: H(i, 0) = 0.  Local mode (``cfg.is_local``) adds the zero
    floor.  Returns the last row H(n, 0..m); with ``want_best`` the max over
    every row 1..n; with ``want_col`` the last column H(1..n, m);
    ``capture_rows`` (DP rows in 1..n, increasing) adds those rows
    H(r, 0..m), and ``want_cell`` the first max over the cells
    ``i >= 1, j >= 1`` in row-major order, ``(v, i, j)``: each row's max
    and its first argmax, then the first row with the greatest max.

    Affine gaps also return the last row of F, with F(n, 0) taken as
    H(n, 0); ``tb`` (default ``gap_open``, in ``[gap_open, 0]``) is the
    top-edge open of Myers-Miller: F(0, j) = H(0, j) + tb and, unless
    ``zero_col``, H(i, 0) = tb + i*ext."""
    dev = text.device
    m = text.numel()
    codes = query.tolist()
    table, row_of = _profile(text, codes, cfg)
    local = cfg.is_local
    affine = cfg.is_affine
    j = torch.arange(m + 1, dtype=torch.int64, device=dev)
    best = torch.full((m + 1,), NEG, dtype=torch.int64, device=dev) if want_best else None
    col = torch.empty(len(codes), dtype=torch.int64, device=dev) if want_col else None
    slot = {r: s for s, r in enumerate(capture_rows)}
    caps = torch.empty((len(slot), m + 1), dtype=torch.int64, device=dev)
    row_max = torch.empty(len(codes), dtype=torch.int64, device=dev) if want_cell else None
    row_arg = torch.empty(len(codes), dtype=torch.int64, device=dev) if want_cell else None
    t = torch.empty(m + 1, dtype=torch.int64, device=dev)
    if affine:
        open_, ext = cfg.gap_open, cfg.gap_extend
        tb = open_ if tb is None else tb
        jg = j * ext  # the in-row scan's slope: ext under affine gaps
        open_jext = jg + open_
        h = torch.zeros(m + 1, dtype=torch.int64, device=dev)
        if not zero_row:
            h[1:] = open_jext[1:]
        f = h + tb
        e = torch.empty(m + 1, dtype=torch.int64, device=dev)
        e[0] = NEG
    else:
        g = cfg.gap
        jg = j * g
        h = torch.zeros(m + 1, dtype=torch.int64, device=dev) if zero_row else jg.clone()
    for i, b in enumerate(codes, start=1):
        if affine:
            f = torch.maximum(h + open_, f).add_(ext)
            torch.maximum(h[:-1] + table[row_of[b]], f[1:], out=t[1:])
        else:
            torch.maximum(h[:-1] + table[row_of[b]], h[1:] + g, out=t[1:])
        if local:
            t.clamp_(min=0)
        t[0] = 0 if (local or zero_col) else (tb + i * ext if affine else i * g)
        c = torch.cummax(t - jg, 0).values
        if affine:
            torch.add(c[:-1], open_jext[1:], out=e[1:])
            h = torch.maximum(t, e)
        else:
            h = c.add_(jg)
        if want_best:
            torch.maximum(best, h, out=best)
        if want_col:
            col[i - 1] = h[-1]
        if i in slot:
            caps[slot[i]] = h
        if want_cell:
            row_max[i - 1], row_arg[i - 1] = h[1:].max(0)
    cell = None
    if want_cell:
        i = torch.argmax(row_max)
        cell = torch.stack([row_max[i], i + 1, row_arg[i] + 1])
    if affine:
        f[0] = h[0]
    return Scan(h, None if best is None else best.max(), col,
                caps if slot else None, cell, f if affine else None)


def _empty_score(m: int, n: int, cfg: ScoringConfig) -> int:
    """``tpualign.ops.xla.score``'s rule when either sequence is empty."""
    if cfg.is_local or cfg.mode is AlignMode.SEMIGLOBAL:
        return 0
    # infix: an empty query aligns for free; an empty text forces an
    # all-gap alignment of the query
    length = n if cfg.mode is AlignMode.INFIX else m + n
    return gap_run(cfg, length) if length else 0


def score_tensors(s1: torch.Tensor, s2: torch.Tensor, cfg: ScoringConfig) -> torch.Tensor:
    """Score of two non-empty code tensors on one device, as a 0-d int64
    tensor there: ``s1`` across the columns, ``s2`` down the rows."""
    zero_row = cfg.is_local or cfg.free_start_s1
    zero_col = cfg.is_local or cfg.free_start_s2
    h, best, col = rows_scan(
        s1, s2, cfg, zero_row=zero_row, zero_col=zero_col,
        want_best=cfg.is_local, want_col=cfg.free_end_s2,
    )[:3]
    if cfg.is_local:
        return best.clamp(min=0)
    if cfg.free_end_s1:
        ans = h.max()
        if cfg.free_end_s2:
            # last column: rows 1..n from the scan, row 0 is H(0, m)
            h0m = 0 if zero_row else gap_run(cfg, s1.numel())
            ans = torch.maximum(ans, col.max()).clamp(min=h0m)
        return ans
    return h[-1]


def score(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, device) -> int:
    """Alignment score of two code sequences by the row scan on ``device``
    (``"cuda"`` or ``"cpu"``); the counterpart of ``tpualign.ops.xla.score``."""
    a = np.asarray(s1)
    b = np.asarray(s2)
    if a.ndim != 1 or b.ndim != 1:
        raise ValueError("sequences must be 1-D")
    dev = _device(device)
    t1 = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
    t2 = torch.from_numpy(np.ascontiguousarray(b, dtype=np.int64))
    check_codes(t1, t2, cfg)
    if a.size == 0 or b.size == 0:
        return _empty_score(a.size, b.size, cfg)
    return int(score_tensors(t1.to(dev), t2.to(dev), cfg))


def score_batch(pairs: Pairs, cfg: ScoringConfig, ends) -> torch.Tensor:
    """Plain PyTorch version of the batch kernel: ``(P,)`` int64 on the
    pairs' device, pair ``p``'s result under the band kernel's contract
    (:mod:`tpualign_torch.ops.band`'s docstring) for its text (columns)
    against its query (rows), ``ends`` the flags ``(zr, zc, er, ec)`` of
    every pair.

    One row of every pair a step over ``(P, m_cap + 1)`` tensors, as
    :func:`rows_scan` runs one pair: rows past a pair's query keep its H
    (and F), as ``tpualign``'s ``_batch_affine_impl`` does; columns past a
    pair's text hold padding whose values never flow left, and the maxima
    read columns ``1..m_p`` only.  Matrix codes must lie in the matrix
    (:func:`check_codes`)."""
    zr, zc, er, ec = ends
    local, affine = cfg.is_local, cfg.is_affine
    dev = pairs.texts.device
    m = pairs.lengths[0].long().view(-1, 1)
    n = pairs.lengths[1].long().view(-1, 1)
    n_min = int(n.min())
    t = pad_pairs(pairs.texts, pairs.offsets[0], m, pairs.m_cap)
    q = pad_pairs(pairs.queries, pairs.offsets[1], n, pairs.n_cap).t().contiguous()
    if cfg.has_matrix:
        mat = torch.tensor(cfg.matrix, dtype=torch.int64, device=dev).view(-1)
        t_k = t * len(cfg.matrix)

        def sub(i):
            return mat[t_k + q[i].view(-1, 1)]
    else:
        def sub(i):
            return torch.where(t == q[i].view(-1, 1), cfg.match, cfg.mismatch)
    P = t.shape[0]
    j = torch.arange(pairs.m_cap + 1, dtype=torch.int64, device=dev)
    if affine:
        open_, ext = cfg.gap_open, cfg.gap_extend
        jg = j * ext
        open_jext = jg + open_
        h = torch.zeros((P, pairs.m_cap + 1), dtype=torch.int64, device=dev)
        if not (local or zr):
            h[:, 1:] = open_jext[1:]
        f = h + open_
        e = torch.empty_like(h)
        e[:, 0] = NEG
    else:
        g = cfg.gap
        jg = j * g
        h = (torch.zeros((P, pairs.m_cap + 1), dtype=torch.int64, device=dev)
             if (local or zr) else jg.expand(P, -1).clone())
    best = torch.zeros_like(h) if local else None
    col = torch.full((P, 1), NEG, dtype=torch.int64, device=dev) if ec else None
    t_row = torch.empty_like(h)
    for i in range(1, pairs.n_cap + 1):
        if affine:
            fn = torch.maximum(h + open_, f).add_(ext)
            torch.maximum(h[:, :-1] + sub(i - 1), fn[:, 1:], out=t_row[:, 1:])
        else:
            torch.maximum(h[:, :-1] + sub(i - 1), h[:, 1:] + g, out=t_row[:, 1:])
        if local:
            t_row.clamp_(min=0)
        t_row[:, 0] = 0 if (local or zc) else (open_ + i * ext if affine else i * g)
        c = torch.cummax(t_row - jg, 1).values
        if affine:
            torch.add(c[:, :-1], open_jext[1:], out=e[:, 1:])
            hn = torch.maximum(t_row, e)
        else:
            hn = c.add_(jg)
        if i > n_min:  # some pair's query has ended: freeze its rows
            live = n >= i
            h = torch.where(live, hn, h)
            if affine:
                f = torch.where(live, fn, f)
        else:
            h = hn
            if affine:
                f = fn
        if local:
            torch.maximum(best, h, out=best)
        if ec:
            col = torch.maximum(col, h.gather(1, m))
    in_text = (j >= 1) & (j <= m)
    if local:
        return torch.where(in_text, best, 0).amax(1)
    if er or ec:
        parts = ([torch.where(in_text, h, NEG).amax(1)] if er else []) + (
            [col.view(-1)] if ec else [])
        return torch.stack(parts).amax(0)
    return h.gather(1, m).view(-1)


def score_batch_affine(texts: Sequence, queries: Sequence, cfg: ScoringConfig, *,
                       device) -> np.ndarray:
    """Gotoh scores of a batch of pairs by one batched row scan on
    ``device``: the port of ``tpualign.ops.xla.score_batch_affine``, with
    its envelope (ValueError for a linear, matrix or ends-free config) and
    its closed form for a pair with an empty side.  ``texts[p]`` runs
    across the columns, ``queries[p]`` down the rows; returns ``(P,)``
    int64."""
    if not cfg.is_affine:
        raise ValueError("score_batch_affine requires an affine config")
    if cfg.has_matrix or cfg.is_ends_free:
        raise ValueError("score_batch_affine serves pair-scored global/local configs; "
                         "matrix/ends-free configs run on the band or xla engines")
    m, n = batch_lengths(texts, queries)
    dev = _device(device)
    live = (m > 0) & (n > 0)
    out = np.zeros(m.size, np.int64)
    if not cfg.is_local:  # an empty side: one gap run, or nothing
        total = m + n
        out = np.where(total > 0, gap_run(cfg, total), 0)
    if live.any():
        pairs = pack_pairs(texts, queries, np.flatnonzero(live)).to(dev)
        out[live] = score_batch(pairs, cfg, (False,) * 4).cpu().numpy()
    return out
