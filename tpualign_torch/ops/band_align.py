"""General-scoring alignment past the full table, in PyTorch and CUDA: the
port of ``tpualign/ops/band_align.py`` (``align_global``, ``align_local``,
``locate_flex_device``) over the capture fill of K7's port
(:func:`tpualign_torch.ops.band.capture_fill`).  Linear gaps, pair scoring
or a substitution matrix of up to 16 codes; ``s1`` is the text (columns),
``s2`` the query (rows), as in ``tpualign.api.align``.

- **Global** (:func:`align_global`): the breadth-first split of
  :func:`tpualign_torch.ops.hirschberg.tree` with K7's nodes.  A k-way node
  captures the rows ``r_j`` of its segment forward and the rows ``n - r_j``
  of the reversed segment, each a whole row of H, and takes the crossing
  column of each row as the first argmax of ``F + R``; a binary node takes
  the last column of ``text[ta:mid]`` forward and of the reversed right
  half, and the crossing row the same way.  Leaves are walked on the host.
- **Local** (:func:`align_local`): one fill locates the end cell
  ``(i*, j*)`` of an optimal local alignment, the row-major first maximum
  (the oracle's cell).  A short hit is walked in a window ending there by
  the C++ full-table walk (:func:`tpualign_torch.utils.native.traceback`,
  the oracle's strings), the window doubled until its score is the
  maximum.  A long hit takes the *anchored*
  start locate: the reversed prefixes ``s1[:j*]``, ``s2[:i*]`` filled under
  global boundaries with no floor, so every path starts at the end cell,
  and the maximum over all cells is the start; then :func:`align_global`
  of the substrings between the two.  That maximum equals the local
  optimum by construction (a global path into the end cell scores at most
  the local optimum there, and the optimal local path is one), so the two
  cells always lie on one optimal path and the core scores the optimum.
- **Ends-free** (:func:`locate_flex_device`): one fill under the mode's
  free-start boundaries gives the last row and the last column, from which
  the end cell is taken by the native walk's rule (the last row first,
  the last column only if strictly greater, first occurrences; infix the
  last row only).  Anchored, the same on global boundaries.
  ``ops/ends_free.py`` builds the alignment from it.

Dropped, each because only the TPU needed it: the jit shape buckets
(``_bucket``); bottom-aligned strips and the first live slot ``klo``
(``_plan_strips``), since the port captures any row; the per-slot running
max planes and the refill that turned them into a cell (``_fill_from``,
``_rowscan_np``), since the kernel returns the cell; the per-strip top-row
profiles and the sentinels (``_prof0s``); the ``MAX_BOUNDARY`` swap
recursion, since the boundary row lives in global memory at any length;
``MAX_LEAF_CELLS`` and ``_binary_walk``, since the tree's binary nodes do
that; the right-column capture planes and ``_caps_to_col``, since the
kernel writes the last column; the unanchored reverse locate of long SW
hits and its "tie split" refusal.  Configs that ``tpualign``'s
``align_local`` refuses (positive mismatch or gap) are served: the
kernel's maximum covers live cells only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import trace
from ..config import AlignMode, ScoringConfig
from ..utils import native
from . import band, hirschberg, xla
from .bitpal import _device
from .pairs import int8_codes

#: SW hits scoring at most this many times the best substitution take the
#: window walk first (``tpualign``'s ``SW_WINDOW_LIMIT``) ...
SW_WINDOW_LIMIT = 2048

#: ... while the window stays at most this many cells; past it, the long
#: hit's path (anchored start locate plus a global core) takes over
WINDOW_MAX_CELLS = 1 << 24


def _check_align_cfg(cfg: ScoringConfig) -> None:
    """ValueError outside the band alignment's envelope, as ``tpualign``'s
    ``_check_align_cfg``: global or local, linear gaps."""
    if cfg.is_ends_free:
        raise ValueError("band_align serves global/local configs; ends-free modes "
                         "reduce through ops.ends_free")
    if cfg.is_affine:
        raise ValueError("band_align takes linear gaps; affine gaps align through "
                         "ops/affine_align.py")


def _codes(s1, s2, cfg: ScoringConfig):
    """Both sequences as int8 code arrays, refused (ValueError) past the
    int32 headroom or outside a matrix's alphabet."""
    with trace.span("check"):
        s1, s2 = int8_codes(s1), int8_codes(s2)
        xla.check_codes(torch.from_numpy(s1), torch.from_numpy(s2), cfg)
        band._check_cfg(cfg, s1.size + s2.size)
    return s1, s2


def _kway_node(seqs, ta, tb, qa, qb, rows, cfg):
    """k-way node: the crossing column of each row of ``rows``,
    segment-local, as a ``(J,)`` device tensor."""
    q, rq, t, rt = seqs
    N, M = q.numel(), t.numel()
    n = qb - qa
    rrows = [n - r for r in reversed(rows)]  # ascending, as the fill takes them
    F = band.capture_fill(t[ta:tb], q[qa:qb], cfg, rows).caps
    Rc = band.capture_fill(rt[M - tb : M - ta], rq[N - qb : N - qa], cfg, rrows).caps
    # R(r, x) = Rc[row n - r][column mt - x]
    return torch.argmax(F.long() + Rc.flip(0).flip(1).long(), dim=1)


def _split_node(seqs, ta, mid, tb, qa, qb, cfg):
    """Binary node: the crossing row of column ``mid``, segment-local, as a
    0-d device tensor."""
    q, rq, t, rt = seqs
    N, M = q.numel(), t.numel()
    F = band.capture_fill(t[ta:mid], q[qa:qb], cfg, col=True).col
    R = band.capture_fill(rt[M - tb : M - mid], rq[N - qb : N - qa], cfg, col=True).col
    return torch.argmax(F.long() + R.flip(0).long())


def align_global(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, device,
                 stats: dict | None = None) -> Tuple[int, str, str]:
    """Global alignment of ``s1`` (columns) against ``s2`` (rows) under a
    linear-gap ``cfg``: the tree of :func:`tpualign_torch.ops.hirschberg.tree`
    over K7's capture fills on ``device``.  Optimal; its tie order among
    co-optimal paths may differ from the oracle's.  ``stats`` as the tree's."""
    _check_align_cfg(cfg)
    if cfg.is_local:
        raise ValueError("align_global requires a global config")
    s1, s2 = _codes(s1, s2, cfg)
    return hirschberg.tree(s1, s2, cfg, lambda *a: _kway_node(*a, cfg),
                           lambda *a: _split_node(*a, cfg), device=device, stats=stats)


def _first_max(cands):
    """The candidate ``(v, i, j)`` with the greatest ``v``, first in
    row-major order."""
    return max(cands, key=lambda c: (c[0], -c[1], -c[2]))


def locate_all(text: torch.Tensor, query: torch.Tensor, cfg: ScoringConfig, *,
               anchored: bool = False) -> Tuple[int, int, int]:
    """``(v, i, j)``: the row-major first maximum over every cell of the
    table of ``text`` (columns) against ``query`` (rows), boundary cells
    included, by one capture fill, linear or affine gaps: local
    (``cfg.is_local``), with zero boundaries and the floor; ``anchored``,
    under global boundaries and no floor.  The kernel locates over
    ``i, j >= 1``; row 0 and column 0 are closed-form (as
    ``tpualign.utils.native.locate_flex``'s extraction 1).  Under affine
    gaps, where a hit scores above 0, this is the cell that
    ``tpualign.ops.affine_align`` locates (``_locate``; anchored,
    ``_first_hit_fn``)."""
    fill_cfg = cfg.with_mode(AlignMode.GLOBAL) if anchored else cfg
    found = band.capture_fill(text, query, fill_cfg, cell=True).cell
    with trace.span("read_back"):
        v, i, j = found.tolist()
    m, n = text.numel(), query.numel()
    zero = not anchored
    if cfg.is_affine:
        # row 0: H(0, 0) = 0 >= H(0, x) = open + x*ext; column 0: H(y, 0) =
        # open + y*ext, the largest at y = 1 (0 when zero)
        row0 = (0, 0, 0)
        col0 = (0, 1, 0) if zero else (cfg.gap_open + cfg.gap_extend, 1, 0)
    else:
        # row 0: H(0, x) = x*g; column 0: H(y, 0) = y*g, y >= 1 (0 when zero)
        g = cfg.gap
        row0 = (0, 0, 0) if zero or g <= 0 else (m * g, 0, m)
        col0 = (0, 1, 0) if zero else ((g, 1, 0) if g <= 0 else (n * g, n, 0))
    return _first_max([(v, i, j), row0, col0])


def align_local(s1, s2, cfg: ScoringConfig, *, device,
                stats: dict | None = None) -> Tuple[int, str, str]:
    """Smith-Waterman alignment of ``s1`` (columns) against ``s2`` (rows)
    under a linear-gap local ``cfg`` on ``device`` (module docstring).
    Returns the score and the aligned strings of the matched substrings, as
    ``tpualign_torch.ops.oracle.traceback`` in local mode (an optimal path;
    its tie order may differ from the oracle's).

    ``stats``, when given, gets ``end`` and ``vmax`` (the located end cell
    and the optimum), ``route`` (``"window"`` or ``"core"``), for a window
    ``window`` (its rows and columns) and ``leaf_walk`` (``"native"``), for
    a core ``start`` and ``core``
    (its rows and columns) and ``core_stats`` (the tree's), and host-clock
    seconds ``locate_s``, ``start_s`` and ``wall_s``: the durations of the
    spans ``locate``, ``start`` and ``align_local``
    (:mod:`tpualign_torch.trace`)."""
    timed = stats is not None
    with trace.span("align_local", timed) as whole:
        out = _align_local(s1, s2, cfg, device, stats)
    if timed and "route" in stats:
        stats["wall_s"] = whole.seconds
    return out


def _to_device(s1: np.ndarray, s2: np.ndarray, dev):
    with trace.span("to_device"):
        return torch.from_numpy(s1).to(dev), torch.from_numpy(s2).to(dev)


def _align_local(s1, s2, cfg: ScoringConfig, device, stats: dict | None):
    timed = stats is not None
    with trace.span("locate", timed) as locate:
        _check_align_cfg(cfg)
        if not cfg.is_local:
            raise ValueError("align_local requires a local (SW) config")
        s1, s2 = _codes(s1, s2, cfg)
        m, n = s1.size, s2.size
        info = {} if stats is None else stats
        if m == 0 or n == 0:
            return 0, "", ""
        dev = _device(device)
        vmax, i_end, j_end = locate_all(*_to_device(s1, s2, dev), cfg)
    info.update(end=(i_end, j_end), vmax=vmax)
    if timed:
        info["locate_s"] = locate.seconds
    if vmax == 0:
        return 0, "", ""
    # a hit scoring little is likely short: walk a window ending at the end
    # cell, doubled until its local optimum is vmax (window values never
    # exceed the table's, so equality certifies it)
    if vmax <= SW_WINDOW_LIMIT * max(cfg.sub_bounds()[1], 1):
        span = SW_WINDOW_LIMIT
        while (min(span, i_end) + 1) * (min(span, j_end) + 1) <= WINDOW_MAX_CELLS:
            ia, ja = max(0, i_end - span), max(0, j_end - span)
            with trace.span("window"):
                sc, a1, a2 = native.traceback(s1[ja:j_end], s2[ia:i_end], cfg)
            if sc == vmax:
                info.update(route="window", window=(i_end - ia, j_end - ja),
                            leaf_walk="native")
                return sc, a1, a2
            if ia == 0 and ja == 0:  # pragma: no cover - a broken locate
                raise AssertionError(f"window walk found {sc}, the locate {vmax}")
            span *= 4
    # a long hit: the anchored start locate on the reversed prefixes, then
    # the global core between the start and the end
    with trace.span("start", timed) as start:
        v0, p, qq = locate_all(*_to_device(s1[:j_end][::-1].copy(), s2[:i_end][::-1].copy(),
                                           dev), cfg, anchored=True)
    if v0 != vmax:  # pragma: no cover - a broken locate
        raise AssertionError(f"anchored start locate {v0} != the end locate {vmax}")
    i0, j0 = i_end - p, j_end - qq
    core_stats = {}
    info.update(route="core", start=(i0, j0), core=(i_end - i0, j_end - j0),
                core_stats=core_stats)
    if timed:
        info["start_s"] = start.seconds
    sc, a1, a2 = align_global(s1[j0:j_end], s2[i0:i_end], cfg.with_mode(AlignMode.GLOBAL),
                              device=dev, stats=core_stats)
    if sc != vmax:  # pragma: no cover - a broken core
        raise AssertionError(f"core score {sc} != the located optimum {vmax}")
    return sc, a1, a2


def locate_flex_device(s1, s2, cfg: ScoringConfig, *, anchored: bool = False,
                       device) -> Tuple[int, int, int]:
    """``(score, ie, je)`` of an optimal extraction cell for the ends-free
    modes, linear or affine gaps, the counterpart of
    ``tpualign.utils.native.locate_flex`` and of
    ``tpualign.ops.affine_align.locate_flex`` (same boundaries, extraction
    sets and first-occurrence rules) by one capture fill on ``device``.
    ``anchored=False``: the forward end locate under the mode's free-start
    boundaries; ``anchored=True``: the reversed start locate under global
    boundaries, the same extraction set (the reversed last row is the
    original row 0, the reversed last column column 0).  Both sequences
    non-empty."""
    if not cfg.is_ends_free:
        raise ValueError("locate_flex_device serves the sg/infix modes")
    s1, s2 = _codes(s1, s2, cfg)
    m, n = s1.size, s2.size
    dev = _device(device)
    zr, zc = (False, False) if anchored else (cfg.free_start_s1, cfg.free_start_s2)
    res = band.capture_fill(*_to_device(s1, s2, dev), cfg, zero_row=zr, zero_col=zc,
                            col=cfg.free_end_s2)
    with trace.span("read_back"):
        j = int(torch.argmax(res.row))
        best = (int(res.row[j]), n, j)
        if cfg.free_end_s2:  # semiglobal: the last column only if strictly greater
            i = int(torch.argmax(res.col))
            if int(res.col[i]) > best[0]:
                best = (int(res.col[i]), i, m)
    return best
