"""Affine-gap (Gotoh) alignment at any size in linear space, in PyTorch and
CUDA: the port of ``tpualign/ops/affine_align.py`` (Myers and Miller,
CABIOS 1988) over the affine capture fill of K7's port
(:func:`tpualign_torch.ops.band.capture_fill`).  Global and local modes,
pair scoring or a substitution matrix of up to 16 codes; ``s1`` is the
text (columns), ``s2`` the query (rows).  The ends-free modes reduce to a
global core here through ``ops/ends_free.py``.

- **Global** (:func:`align`): a node ``s1[ta:tb] x s2[qa:qb]`` with the
  top and bottom edges' vertical-gap opens ``top`` and ``bot`` (the
  config's ``gap_open``, or 0 where the parent carries an open gap through
  that edge) splits its rows at ``mid = n // 2``.  One capture fill of rows
  ``1..mid`` under ``tb = top`` and one of the reversed rows ``n..mid+1``
  under ``tb = bot`` give the last rows ``(H, F)`` both ways.  The crossing
  is the first argmax of ``Hf + Hr[::-1]`` (the path meets row ``mid``
  gap-free) against that of ``Ff + Fr[::-1] - gap_open`` (a vertical gap
  spans rows ``mid`` and ``mid + 1``, its open charged in both halves),
  the H case winning ties.  The F case emits those two rows as gap columns
  and waives the open on the edges it touches.  Nodes are visited breadth
  first, as in :func:`tpualign_torch.ops.hirschberg.tree`: a level's fills
  are queued before the oldest crossing is read back.  Segments of at most
  ``BASE_CELLS`` cells, and those the kernel refuses (no column, or fewer
  than two rows), are leaves: the flagged full-table Gotoh
  (:func:`_base_align`) walks them on a thread pool while the bisection
  goes on.  The score is the root's crossing value.
- **Local** (:func:`align_local`): one located-cell fill finds the end
  cell, the row-major first maximum (the oracle's cell); the *anchored*
  located cell on the reversed prefixes (global boundaries, no floor) finds
  the start, as ``tpualign``'s ``_first_hit_fn`` does; then :func:`align`
  of the substrings between the two.

The crossings, their tie rules and the leaf walk are ``tpualign``'s, so
the strings equal its strings.  Dropped, each because only the TPU needed
it: the jit shape buckets and pad codes (``_bucket``, ``_scan_fn``,
``_pad_code``, ``_mat17``), the XLA-scan fallback and ``_band_rows_ok``,
and ``band_chunked``'s column blocking (the port's boundary row lives in
global memory at any length).  Positive-mismatch local configs, which
``tpualign`` refuses because its locate scan's maximum would reach into
pad columns, are served: the kernel's maximum covers live cells only.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from .. import trace
from ..config import AlignMode, ScoringConfig
from . import band, band_align, hirschberg, oracle
from .bitpal import _device

#: segments at or under this many DP cells are leaves (``tpualign``'s
#: ``BASE_CELLS``)
BASE_CELLS = 1 << 20


def _check_cfg(cfg: ScoringConfig) -> None:
    """ValueError outside affine global/local configs (the ends-free affine
    modes reduce through ``ops.ends_free``)."""
    if not cfg.is_affine:
        raise ValueError("affine_align requires an affine config")
    if cfg.is_ends_free:
        raise ValueError("affine_align serves global/local configs; ends-free affine "
                         "modes reduce through ops.ends_free")


def _base_align(s1, s2, cfg: ScoringConfig, tb: int, te: int,
                tables=None) -> Tuple[int, str, str]:
    """Exact Gotoh alignment of a small global block with boundary flags,
    the port of ``tpualign.ops.affine_align._base_align``.

    ``tb``/``te`` are the vertical-gap opens at the top and bottom edges
    (``cfg.gap_open``, or 0 where the parent carries an open gap through
    that edge).  Tie order as the oracle's: diag > up (F) > left (E);
    closing beats extending.  ``tables`` are the block's ``(H, E, F)``
    where the caller has filled them (:func:`oracle.affine_tables` with
    ``tb``)."""
    BASES = oracle.BASES
    s1 = np.asarray(s1, np.int64)
    s2 = np.asarray(s2, np.int64)
    N, M = s2.size, s1.size
    open_, ext = cfg.gap_open, cfg.gap_extend
    H, E, F = oracle.affine_tables(s1, s2, cfg, tb) if tables is None else tables
    # te: the alignment may end inside a vertical gap with the open waived;
    # a vertical gap needs a row, so an empty query cannot end in one
    end_f = int(F[N, M]) + te - open_ if N > 0 else int(oracle.NEG)
    sc = max(int(H[N, M]), end_f)
    state = "F" if end_f > int(H[N, M]) else "H"
    i, j = N, M
    a1: list = []
    a2: list = []
    while i > 0 or j > 0:
        if state == "H":
            if j == 0:
                state = "F"
                continue
            if i == 0:
                a1.append(BASES[s1[j - 1]])
                a2.append("-")
                j -= 1
                continue
            if H[i, j] == H[i - 1, j - 1] + cfg.sub_score(int(s1[j - 1]), int(s2[i - 1])):
                a1.append(BASES[s1[j - 1]])
                a2.append(BASES[s2[i - 1]])
                i, j = i - 1, j - 1
            elif H[i, j] == F[i, j]:
                state = "F"
            elif H[i, j] == E[i, j]:
                state = "E"
            else:  # pragma: no cover - would indicate a broken table
                raise AssertionError(f"no predecessor at H({i},{j})")
        elif state == "F":
            a1.append("-")
            a2.append(BASES[s2[i - 1]])
            row_open = tb if i == 1 else open_
            close = j > 0 and F[i, j] == H[i - 1, j] + row_open + ext
            i -= 1
            state = "H" if close or i == 0 else "F"  # the top edge closes a gap
        else:  # E
            a1.append(BASES[s1[j - 1]])
            a2.append("-")
            close = i > 0 and E[i, j] == H[i, j - 1] + open_ + ext
            j -= 1
            state = "H" if close or j == 0 else "E"
    return sc, "".join(reversed(a1)), "".join(reversed(a2))


def _crossing(seqs, ta, tb, qa, qb, mid, top, bot, cfg):
    """A node's forward and reverse fills and, on the device, ``(jh, vh,
    jf, vf)``: the first argmax and maximum of the H case and of the F
    case (segment-local columns)."""
    q, rq, t, rt = seqs
    N, M = q.numel(), t.numel()
    fwd = band.capture_fill(t[ta:tb], q[qa:qa + mid], cfg, tb=top)
    rev = band.capture_fill(rt[M - tb:M - ta], rq[N - qb:N - qa - mid], cfg, tb=bot)
    h_case = fwd.row.long() + rev.row.flip(0).long()
    f_case = fwd.f.long() + rev.f.flip(0).long() - cfg.gap_open
    jh, jf = torch.argmax(h_case), torch.argmax(f_case)
    return torch.stack([jh, h_case[jh], jf, f_case[jf]])


def align(s1, s2, cfg: ScoringConfig, *, device,
          stats: dict | None = None) -> Tuple[int, str, str]:
    """Score plus aligned strings of ``s1`` (columns) against ``s2`` (rows)
    under an affine global ``cfg`` (local goes to :func:`align_local`), by
    Myers-Miller on ``device`` (module docstring): ``tpualign``'s strings.

    ``stats``, when given, is filled with counts and host-clock seconds:
    ``nodes`` (two fills each), ``gap_nodes`` (those whose crossing is a
    vertical gap), ``leaves``, ``leaf_cells``, ``bisect_s``
    (until the last node's crossing is read back), ``leaf_walk`` (always
    ``"numpy"``: the flagged Gotoh walk has no C++ counterpart, ROADMAP
    item 15), ``leaf_walk_s`` (the leaf walks' own times, summed over the
    threads), its two parts ``leaf_fill_s`` (the leaves' Gotoh table
    fills) and ``leaf_trace_s`` (their walks and strings), and ``wall_s``.
    The spans and counters are :func:`tpualign_torch.ops.hirschberg.tree`'s,
    a node's fills the span ``node.affine`` and the counter
    ``nodes.affine``, a vertical-gap crossing the counter
    ``nodes.affine_gap``; the walkers' clock readings come back with their
    results and are counted on the calling thread as ``leaf_walk_ns``,
    ``leaf_fill_ns``, ``leaf_trace_ns`` and ``leaf_queue_ns``."""
    _check_cfg(cfg)
    if cfg.is_local:
        return align_local(s1, s2, cfg, device=device, stats=stats)
    timed = stats is not None
    with trace.span("tree", timed) as whole:
        open_ = cfg.gap_open
        counts = dict(nodes=0, gap_nodes=0, leaves=0, leaf_cells=0)
        # (ta, qa, future of (queue ns, fill ns, walk ns, (score, a1, a2)) or
        # strings)
        pieces = []
        pending = deque()

        def walk(submitted, ta, tb, qa, qb, top, bot):
            t0 = time.perf_counter_ns()
            t, q = np.asarray(s1[ta:tb], np.int64), np.asarray(s2[qa:qb], np.int64)
            tables = oracle.affine_tables(t, q, cfg, top)
            t1 = time.perf_counter_ns()
            result = _base_align(t, q, cfg, top, bot, tables)
            return t0 - submitted, t1 - t0, time.perf_counter_ns() - t1, result

        def submit(ta, tb, qa, qb, top, bot):
            m, n = tb - ta, qb - qa
            if (m + 1) * (n + 1) <= BASE_CELLS or n < 2 or m < 1:
                counts["leaves"] += 1
                counts["leaf_cells"] += (m + 1) * (n + 1)
                trace.count("leaves")
                trace.count("leaf_cells", (m + 1) * (n + 1))
                pieces.append((ta, qa, pool.submit(walk, time.perf_counter_ns(), ta, tb, qa, qb,
                                                   top, bot)))
                return
            counts["nodes"] += 1
            trace.count("nodes.affine")
            mid = n // 2
            with trace.span("node.affine"):
                found = _crossing(seqs, ta, tb, qa, qb, mid, top, bot, cfg)
            pending.append((ta, tb, qa, qb, top, bot, mid, found))

        score = None
        with ThreadPoolExecutor(max_workers=hirschberg.LEAF_WORKERS) as pool:
            with trace.span("bisect", timed) as bisect:
                s1, s2 = band_align._codes(s1, s2, cfg)
                dev = _device(device)
                with trace.span("to_device"):
                    q = torch.from_numpy(s2).to(dev)
                    t = torch.from_numpy(s1).to(dev)
                seqs = (q, q.flip(0), t, t.flip(0))
                submit(0, s1.size, 0, s2.size, open_, open_)
                while pending:
                    ta, tb, qa, qb, top, bot, mid, found = pending.popleft()
                    with trace.span("read_back"):
                        jh, vh, jf, vf = found.tolist()
                    if score is None:
                        score = max(vh, vf)  # the root's crossing value is the score
                    if vh >= vf:  # the path meets (mid, jh) gap-free
                        submit(ta, ta + jh, qa, qa + mid, top, open_)
                        submit(ta + jh, tb, qa + mid, qb, open_, bot)
                        continue
                    # a vertical gap spans rows mid and mid + 1 at column jf
                    counts["gap_nodes"] += 1
                    trace.count("nodes.affine_gap")
                    submit(ta, ta + jf, qa, qa + mid - 1, top, 0)
                    pieces.append((ta + jf, qa + mid - 1, ("--", oracle.BASES[s2[qa + mid - 1]]
                                                           + oracle.BASES[s2[qa + mid]])))
                    submit(ta + jf, tb, qa + mid + 1, qb, 0, bot)
            with trace.span("leaves.wait"):
                # the pieces tile the path: sorting by (column, row) restores its order
                pieces.sort(key=lambda piece: piece[:2])
                walked = [(0, 0, 0, (None, *p)) if isinstance(p, tuple) else p.result()
                          for _, _, p in pieces]
        if score is None:  # the root is a leaf
            score = walked[0][3][0]
        with trace.span("assemble"):
            a1 = "".join(r[1] for *_, r in walked)
            a2 = "".join(r[2] for *_, r in walked)
    fill_ns = sum(fill for _, fill, _, _ in walked)
    trace_ns = sum(walk for _, _, walk, _ in walked)
    walk_ns = fill_ns + trace_ns
    trace.count("leaf_walk_ns", walk_ns)
    trace.count("leaf_fill_ns", fill_ns)
    trace.count("leaf_trace_ns", trace_ns)
    trace.count("leaf_queue_ns", sum(wait for wait, *_ in walked))
    if stats is not None:
        stats.update(counts, bisect_s=bisect.seconds, leaf_walk="numpy",
                     leaf_walk_s=walk_ns / 1e9, leaf_fill_s=fill_ns / 1e9,
                     leaf_trace_s=trace_ns / 1e9, wall_s=whole.seconds)
    return score, a1, a2


def align_local(s1, s2, cfg: ScoringConfig, *, device,
                stats: dict | None = None) -> Tuple[int, str, str]:
    """Smith-Waterman alignment of ``s1`` (columns) against ``s2`` (rows)
    under an affine local ``cfg`` on ``device`` (module docstring).  Returns
    the score and the aligned strings of the matched substrings, as
    ``tpualign.ops.affine_align.align_local``.

    ``stats``, when given, gets ``end`` and ``vmax`` (the located end cell
    and the optimum), ``start`` and ``core`` (its rows and columns),
    ``core_stats`` (:func:`align`'s) and host-clock seconds ``locate_s``,
    ``start_s`` and ``wall_s``: the durations of the spans ``locate``,
    ``start`` and ``align_local`` (:mod:`tpualign_torch.trace`)."""
    timed = stats is not None
    with trace.span("align_local", timed) as whole:
        out = _align_local(s1, s2, cfg, device, stats)
    if timed and "core" in stats:
        stats["wall_s"] = whole.seconds
    return out


def _align_local(s1, s2, cfg: ScoringConfig, device, stats: dict | None):
    timed = stats is not None
    with trace.span("locate", timed) as locate:
        _check_cfg(cfg)
        if not cfg.is_local:
            raise ValueError("align_local requires a local affine config")
        s1, s2 = band_align._codes(s1, s2, cfg)
        info = {} if stats is None else stats
        if s1.size == 0 or s2.size == 0:
            return 0, "", ""
        dev = _device(device)
        vmax, i_end, j_end = band_align.locate_all(*band_align._to_device(s1, s2, dev), cfg)
    info.update(end=(i_end, j_end), vmax=vmax)
    if timed:
        info["locate_s"] = locate.seconds
    if vmax == 0:
        return 0, "", ""
    with trace.span("start", timed) as start:
        v0, p, qq = band_align.locate_all(
            *band_align._to_device(s1[:j_end][::-1].copy(), s2[:i_end][::-1].copy(), dev),
            cfg, anchored=True)
    if v0 != vmax:  # pragma: no cover - a broken locate
        raise AssertionError(f"anchored start locate {v0} != the end locate {vmax}")
    i0, j0 = i_end - p, j_end - qq
    core_stats = {}
    info.update(start=(i0, j0), core=(i_end - i0, j_end - j0), core_stats=core_stats)
    if timed:
        info["start_s"] = start.seconds
    sc, a1, a2 = align(s1[j0:j_end], s2[i0:i_end], cfg.with_mode(AlignMode.GLOBAL),
                       device=dev, stats=core_stats)
    if sc != vmax:  # pragma: no cover - a broken core
        raise AssertionError(f"core score {sc} != the located optimum {vmax}")
    return sc, a1, a2
