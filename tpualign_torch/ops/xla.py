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
``associative_scan``, in blocks on CUDA: :class:`_PrefixMax`), and under
affine gaps the horizontal gap ``E`` resolves by the same scan over the
gap-free candidates (valid because ``gap_open <= 0``, see
``ops/oracle.py:_affine_row``).  Values are int64,
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
#: on CUDA a row longer than ``4 * SCAN_BLOCK`` scans in blocks of this
#: many columns: ``torch.cummax`` runs one long row on one thread block,
#: 361.3 us for 126,441 columns against 63.8 us as a (247, 512) view with
#: a running max over the blocks (``tools/bench_row_scan.py`` on an NVIDIA
#: H100 80GB HBM3 at 700 W)
SCAN_BLOCK = 512


class _PrefixMax:
    """``cummax(x)`` of rows of ``size`` values on ``device``: one
    ``torch.cummax``, or, ``blocked`` (rows_scan: on CUDA) past
    ``4 * SCAN_BLOCK`` values, the cummax of each block of ``SCAN_BLOCK``
    (many thread blocks) and the running max of the blocks' maxima, the
    same values."""

    def __init__(self, size: int, device: torch.device, blocked: bool):
        self.size = size
        self.rows = -(-size // SCAN_BLOCK) if blocked and size > 4 * SCAN_BLOCK else 0
        if self.rows:  # the tail past ``size`` stays NEG
            self.buf = torch.full((self.rows * SCAN_BLOCK,), NEG, dtype=torch.int64,
                                  device=device)

    def __call__(self, t: torch.Tensor, jg: torch.Tensor) -> torch.Tensor:
        """A fresh tensor: ``cummax(t - jg)``."""
        if not self.rows:
            return torch.cummax(t - jg, 0).values
        torch.sub(t, jg, out=self.buf[: self.size])
        v = self.buf.view(self.rows, SCAN_BLOCK).cummax(1).values
        carry = v[:, -1].cummax(0).values
        torch.maximum(v[1:], carry[:-1, None], out=v[1:])
        return v.view(-1)[: self.size]


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
    cols: Optional[torch.Tensor]  # (n, C): H(1..n, 0), H(1..n, k), ...: every k-th column
    ck: Optional[torch.Tensor]  # (2, groups, n+1): the diagonal checkpoints
    row_max: Optional[Tuple[torch.Tensor, torch.Tensor]]  # (n,) twice: max and first argmax


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
    want_row_max: bool = False,
    col_stride: Optional[int] = None,
    diag_stride: Optional[int] = None,
    tb: Optional[int] = None,
) -> Scan:
    """Fill the table of ``text`` (columns) against ``query`` (rows), both
    non-empty code tensors on one device, one row at a time.

    ``zero_row``: H(0, j) = 0 (else the gap charges of ``cfg``);
    ``zero_col``: H(i, 0) = 0 (else the gap charges).  Local mode
    (``cfg.is_local``) adds the zero floor.  Returns the last row
    H(n, 0..m); with ``want_best`` the max over every row 1..n; with
    ``want_col`` the last column H(1..n, m); ``capture_rows`` (DP rows in
    1..n, increasing) adds those rows H(r, 0..m), and ``want_cell`` the
    first max over the cells ``i >= 1, j >= 1`` in row-major order,
    ``(v, i, j)``: each row's max and its first argmax, then the first row
    with the greatest max; ``want_row_max`` returns those two per row
    (``(n,)`` each, the argmax as the column j >= 1).  ``col_stride`` k
    keeps every row's columns 0, k, 2k, ... (the checkpointed traceback's
    block edges); ``diag_stride`` K the diagonal checkpoints of the
    diagonal kernel's contract (:mod:`tpualign_torch.ops.pallas_diag`):
    ``ck[0][c][i] = H(i, cK - i)`` and ``ck[1][c][i] = H(i, cK - 1 - i)``
    for c < ceil((n + m) / K), rows 0..n, ``CK_NEG`` outside the table.

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
    want_row_max = want_row_max or want_cell
    row_max = torch.empty(len(codes), dtype=torch.int64, device=dev) if want_row_max else None
    row_arg = torch.empty(len(codes), dtype=torch.int64, device=dev) if want_row_max else None
    cols = (torch.empty((len(codes), m // col_stride + 1), dtype=torch.int64, device=dev)
            if col_stride else None)
    t = torch.empty(m + 1, dtype=torch.int64, device=dev)
    prefix_max = _PrefixMax(m + 1, dev, blocked=dev.type == "cuda")
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
    ck = _DiagCheckpoints(h, len(codes), diag_stride) if diag_stride else None
    for i, b in enumerate(codes, start=1):
        if affine:
            f = torch.maximum(h + open_, f).add_(ext)
            torch.maximum(h[:-1] + table[row_of[b]], f[1:], out=t[1:])
        else:
            torch.maximum(h[:-1] + table[row_of[b]], h[1:] + g, out=t[1:])
        if local:
            t.clamp_(min=0)
        t[0] = 0 if zero_col else (tb + i * ext if affine else i * g)
        c = prefix_max(t, jg)
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
        if want_row_max:
            row_max[i - 1], row_arg[i - 1] = h[1:].max(0)
        if col_stride:
            cols[i - 1] = h[::col_stride]
        if ck is not None:
            ck.add(i, h)
    cell = None
    if want_row_max:
        row_arg += 1
    if want_cell:
        i = torch.argmax(row_max)
        cell = torch.stack([row_max[i], i + 1, row_arg[i]])
    if affine:
        f[0] = h[0]
    return Scan(h, None if best is None else best.max(), col,
                caps if slot else None, cell, f if affine else None, cols,
                None if ck is None else ck.result(),
                (row_max, row_arg) if want_row_max else None)


#: the diagonal checkpoints' value on slots outside the table
#: (``tpualign.ops.pallas_diag.NEG_INF``)
CK_NEG = -(2**30)


class _DiagCheckpoints:
    """The cells of rows 0..n on the diagonals cK and cK - 1, c <
    ceil((n + m) / K), gathered one row at a time from a copy of the row
    padded with ``CK_NEG`` at both ends (four small ops a row)."""

    def __init__(self, h0: torch.Tensor, n: int, K: int):
        m = h0.numel() - 1
        dev = h0.device
        groups = -(-(n + m) // K)
        cK = torch.arange(groups, dtype=torch.int64, device=dev) * K + 1  # hp index of cK
        self.idx = torch.cat([cK, cK - 1])  # row 0's columns cK and cK - 1, as hp indices
        self.at = torch.empty_like(self.idx)
        self.hp = torch.full((m + 3,), CK_NEG, dtype=torch.int64, device=dev)
        self.out = torch.empty((n + 1, 2 * groups), dtype=torch.int64, device=dev)
        self.m, self.groups, self.n = m, groups, n
        self.add(0, h0)

    def add(self, i: int, h: torch.Tensor) -> None:
        self.hp[1:-1] = h
        torch.clamp(self.idx - i, 0, self.m + 2, out=self.at)
        torch.index_select(self.hp, 0, self.at, out=self.out[i])

    def result(self) -> torch.Tensor:
        return self.out.t().reshape(2, self.groups, self.n + 1)


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


def last_row(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, reverse: bool = False,
             device) -> torch.Tensor:
    """The last DP row H(n, 0..m) of ``s1`` (columns) against ``s2`` (rows)
    by the row scan on ``device``, as ``(m+1,)`` int64 there; with
    ``reverse`` the last row of the suffix problem (both sequences
    reversed).  The counterpart of ``tpualign.ops.xla.last_row``: the
    boundaries are the gap charges H(0, j) = j*gap and H(i, 0) = i*gap in
    every mode (local scoring adds only the zero floor), and affine
    configs are refused (ValueError)."""
    if cfg.is_affine:
        # splitting affine problems needs both the H and E rows
        raise ValueError("last_row supports linear-gap configs only")
    a = np.asarray(s1)
    b = np.asarray(s2)
    if a.ndim != 1 or b.ndim != 1:
        raise ValueError("sequences must be 1-D")
    if reverse:
        a, b = a[::-1], b[::-1]
    dev = _device(device)
    t1 = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
    t2 = torch.from_numpy(np.ascontiguousarray(b, dtype=np.int64))
    check_codes(t1, t2, cfg)
    if b.size == 0:
        return torch.arange(a.size + 1, dtype=torch.int64, device=dev) * cfg.gap
    return rows_scan(t1.to(dev), t2.to(dev), cfg, zero_row=False, zero_col=False).h


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
