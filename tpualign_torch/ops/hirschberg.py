"""Linear-space alignment at bit-parallel speed: Hirschberg's divide and
conquer over the port's (1, 0, -g) fills.  The port of
``tpualign/ops/hirschberg.py:align``.

``s1`` is the text (columns), ``s2`` the query (rows, the fills' bit axis).
A segment ``text[ta:tb]`` x ``query[qa:qb]`` is split in one of two ways:

- **k-way** (``n = qb - qa >= KWAY_MIN_ROWS``): one forward
  :func:`~tpualign_torch.ops.bitpal.capture_fill` of the segment captures
  the horizontal deltas of DP rows ``r_1 < ... < r_J``, and one reverse fill
  (both sequences reversed) captures rows ``n - r_j``, the same rows counted
  from the bottom.  Cumulative sums turn each capture into a whole row of
  scores, forward ``F(r, x) = H(r, x)`` and reverse ``R(r, x)``, the best
  score of aligning ``query[r:]`` with ``text[x:]``; the crossing column of
  row ``r_j`` is the first argmax of ``F + R``.  J split points on the
  optimal path from two fills.
- **binary** (otherwise): the text is split at ``mid``; one
  :func:`~tpualign_torch.ops.bitpal.fill_g` of ``text[ta:mid]`` gives the
  column ``F(i) = H(i, mid)``, one fill of the reversed right half the
  reverse column, and the crossing row is the first argmax of ``F + R``.

Both reductions run on the device; a node reads back only its crossing
points.  Nodes are visited breadth first, so that the fills of a level are
queued on the stream before the oldest node's crossings are read.
Segments of at most ``BASE_CELLS`` cells are leaves: they are walked by the
exact full-table traceback in C++ (:func:`tpualign_torch.utils.native.traceback`,
string for string :func:`tpualign_torch.ops.oracle.traceback`'s) on a pool
of ``NATIVE_LEAF_WORKERS`` threads while the bisection goes on, and
concatenated in path order.

The first-argmax crossings of one k-way node lie on the leftmost optimal
path, so they are jointly consistent; if they ever were not (non-monotone
columns), the node falls back to the binary split.  The recovered alignment
is optimal (the tests check its score against the oracle's); its tie order
among co-optimal paths may differ from the oracle's diag > up > left.

The tree (:func:`tree`) takes its node fills as parameters: :func:`align`
gives it the bit-parallel fills above, and
:func:`tpualign_torch.ops.band_align.align_global` the capture fill of
K7's port, whose rows hold H itself, for every other linear-gap config.

What exists only for the TPU is gone: the jit shape buckets, text packing
and the 2w stagger offsets into the capture streams (the port's fills take
exact lengths, and capture entry ``x - 1`` is column ``x``), the 128-row
capture cap, and the bridge of ``n mod 31`` rows between the forward and
reverse capture grids (the port captures the same rows both ways).
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..config import ScoringConfig
from ..utils import native
from . import bitpal, oracle

#: segments at or under this many DP cells are leaves, walked by the exact
#: full-table traceback (fast in NumPy, and it fixes the in-leaf tie order)
BASE_CELLS = 1 << 22

#: the k-way split engages at this many query rows; below it, binary
KWAY_MIN_ROWS = 8 * 1024

#: a k-way node splits its rows into this many spans while the spans stay
#: at least KWAY_MIN_ROWS long (its children are split k-way again) ...
KWAY_FANOUT = 33

#: ... and otherwise straight into spans of this many rows (leaf-sized)
KWAY_LEAF_ROWS = 640

#: threads walking leaves in C++ beside the thread that runs the bisection
#: (``tpualign``'s pool): ctypes releases the interpreter lock for a walk.
#: At the 64gb shape (1, 0, -1) ``align`` took 0.279 s with one walker and
#: 0.154-0.164 s with eight (``tools/ab_leaf_walk.py``, H100 80GB HBM3
#: host, 700 W card)
NATIVE_LEAF_WORKERS = 8

#: threads walking leaves in NumPy (:func:`tpualign_torch.ops.oracle.traceback`,
#: ``affine_align``'s Gotoh walk).  The NumPy walk holds the interpreter
#: lock, so more threads only contend for it: at the 64gb shape (199 leaves
#: of ~640 x 640) one walker took 3.2 s, two 8.0 s, eight 25.2 s (H100 80GB
#: HBM3 host, 700 W card)
LEAF_WORKERS = 1

#: the fills are one thread block: queries past this many rows are refused
MAX_QUERY_ROWS = bitpal.MAX_THREADS * bitpal.MAX_K * bitpal.WORD


def _kway_rows(n: int) -> list:
    """The DP rows (segment-local, in ``1..n-1``) a k-way node splits at."""
    spacing = n // KWAY_FANOUT
    if spacing < KWAY_MIN_ROWS:
        spacing = KWAY_LEAF_ROWS
    return list(range(spacing, n, spacing))


def _col_scores(text: torch.Tensor, query: torch.Tensor, g: int) -> torch.Tensor:
    """``(n+1,)`` int64 on the tensors' device: ``H(i, len(text))`` for
    ``i = 0..n`` under ``(1, 0, -g)``."""
    n = query.numel()
    planes = bitpal.fill_g(text, bitpal._eq_planes(query, n), n, g)
    v = bitpal.row_deltas(planes, n, g)
    return torch.cat([v.new_zeros(1), v.cumsum(0)]) - g * text.numel()


def _row_scores(caps: torch.Tensor, rows, g: int) -> torch.Tensor:
    """``(J, mt+1)`` int64: ``H(r, x)`` for ``x = 0..mt`` at each row ``r``
    of ``rows``, from the fill's ``(J, mt)`` horizontal-delta captures."""
    d = caps.long() - g
    r = torch.tensor(rows, dtype=torch.int64, device=caps.device).unsqueeze(1)
    return torch.cat([d.new_zeros(len(rows), 1), d.cumsum(1)], 1) - g * r


def _split_node(seqs, ta, mid, tb, qa, qb, g):
    """Binary node: the crossing row of column ``mid``, segment-local, as a
    0-d device tensor."""
    q, rq, t, rt = seqs
    N, M = q.numel(), t.numel()
    F = _col_scores(t[ta:mid], q[qa:qb], g)
    R = _col_scores(rt[M - tb : M - mid], rq[N - qb : N - qa], g)
    return torch.argmax(F + R.flip(0))


def _kway_node(seqs, ta, tb, qa, qb, rows, g):
    """k-way node: the crossing column of each row of ``rows``,
    segment-local, as a ``(J,)`` device tensor."""
    q, rq, t, rt = seqs
    N, M = q.numel(), t.numel()
    n = qb - qa
    fwd = t[ta:tb], bitpal._eq_planes(q[qa:qb], n)
    rev = rt[M - tb : M - ta], bitpal._eq_planes(rq[N - qb : N - qa], n)
    rrows = [n - r for r in reversed(rows)]  # ascending, as the fill takes them
    _, caps_f = bitpal.capture_fill(*fwd, n, g, rows)
    _, caps_r = bitpal.capture_fill(*rev, n, g, rrows)
    F = _row_scores(caps_f, rows, g)
    Rc = _row_scores(caps_r.flip(0), rrows[::-1], g)
    # R(r, x) = Rc[mt - x]: the reverse fill's column mt - x is column x
    return torch.argmax(F + Rc.flip(1), dim=1)


def align(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, device,
          stats: dict | None = None) -> Tuple[int, str, str]:
    """Score plus aligned strings of ``s1`` (text, columns) against ``s2``
    (query, rows) under a (1, 0, -g) family config, on ``device``
    (``"cuda"`` runs the kernels, ``"cpu"`` their plain versions).

    The score is the sum of the leaves' scores, i.e. the score of the
    returned alignment.  It stays exact where the strings cannot be
    re-scored: code 0 (the ``.bdna`` gap byte) prints as ``-``.

    Raises ValueError for a config outside the family, for codes outside
    0..4, and for a query past the one-block fill's ``MAX_QUERY_ROWS``.
    ``stats`` as in :func:`tree`."""
    fam = bitpal.family(cfg)
    if fam is None:
        raise ValueError(
            "hirschberg alignment requires a bit-parallel scoring family "
            "(global, affinely reducible to (1, 0, -g), 1 <= g <= 7)"
        )
    g = fam[1]
    s1, s2 = bitpal._codes(s1), bitpal._codes(s2)
    if s2.size > MAX_QUERY_ROWS:
        raise ValueError(
            f"query of {s2.size} rows exceeds the one-block fill's "
            f"{MAX_QUERY_ROWS} rows: ROADMAP queue 1 item 5 (multi-block "
            "wavefront)"
        )
    # looked up at each call, so that a test can replace a node
    return tree(s1, s2, cfg, lambda *a: _kway_node(*a, g),
                lambda *a: _split_node(*a, g), device=device, stats=stats)


def tree(s1: np.ndarray, s2: np.ndarray, cfg: ScoringConfig, kway_node, split_node,
         *, device, stats: dict | None = None) -> Tuple[int, str, str]:
    """The breadth-first split of ``s1`` (text, columns) against ``s2``
    (query, rows), both code arrays, under the global linear-gap ``cfg``,
    with the node fills as parameters (module docstring): on ``seqs =
    (query, reversed query, text, reversed text)`` as tensors on
    ``device``, ``kway_node(seqs, ta, tb, qa, qb, rows)`` returns the
    crossing column of each row of ``rows`` (segment-local, a ``(J,)``
    device tensor) and ``split_node(seqs, ta, mid, tb, qa, qb)`` the
    crossing row of column ``mid`` (segment-local, 0-d).  Leaves are walked
    under ``cfg`` by :func:`tpualign_torch.utils.native.traceback` where it
    serves ``cfg`` (:func:`tpualign_torch.utils.native.walks`), else by
    :func:`tpualign_torch.ops.oracle.traceback`.

    ``stats``, when given, is filled with counts and host-clock seconds:
    ``kway_nodes``, ``binary_nodes``, ``leaves``, ``leaf_cells``,
    ``bisect_s`` (until the last node's crossings are read back),
    ``leaf_walk`` (``"native"`` or ``"numpy"``), ``leaf_walk_s`` (the leaf
    walks' own times, summed over the threads) and ``wall_s``.

    The spans (:mod:`tpualign_torch.trace`): ``tree`` (``wall_s``) holds
    ``bisect`` (``bisect_s``: the sequences' ``to_device``, each node's
    fills as ``node.kway`` or ``node.binary``, its crossings' ``read_back``,
    and ``submit``: the node's children, leaves handed to the walkers and
    nodes' fills), ``leaves.wait`` (the wait on the walkers after the
    bisection) and ``assemble`` (the strings' join).  The counters:
    ``nodes.kway``, ``nodes.binary``, ``leaves``, ``leaf_cells``, and from
    the walkers' returns ``leaf_walk_ns`` (the walks' own time) and
    ``leaf_queue_ns`` (from a leaf's submission to its walk's start),
    summed over the leaves."""
    in_cpp = native.walks(cfg)
    if in_cpp:
        native.load()  # built at first use, before the clock starts
    walk_table = native.traceback if in_cpp else oracle.traceback
    timed = stats is not None
    counts = dict(kway_nodes=0, binary_nodes=0, leaves=0, leaf_cells=0)
    # (ta, qa, future of (queue ns, walk ns, (score, a1, a2)))
    leaves = []
    pending = deque()

    def walk(submitted, ta, tb, qa, qb):
        t0 = time.perf_counter_ns()
        result = walk_table(s1[ta:tb], s2[qa:qb], cfg)
        return t0 - submitted, time.perf_counter_ns() - t0, result

    def submit(ta, tb, qa, qb, force_bin=False):
        m, n = tb - ta, qb - qa
        if (m + 1) * (n + 1) <= BASE_CELLS or m < 2 or n < 2:
            counts["leaves"] += 1
            counts["leaf_cells"] += (m + 1) * (n + 1)
            trace.count("leaves")
            trace.count("leaf_cells", (m + 1) * (n + 1))
            leaves.append((ta, qa, pool.submit(walk, time.perf_counter_ns(), ta, tb, qa, qb)))
            return
        rows = _kway_rows(n) if n >= KWAY_MIN_ROWS and not force_bin else []
        if rows:
            counts["kway_nodes"] += 1
            trace.count("nodes.kway")
            with trace.span("node.kway"):
                xs = kway_node(seqs, ta, tb, qa, qb, rows)
            pending.append(("kway", ta, tb, qa, qb, rows, xs))
            return
        counts["binary_nodes"] += 1
        trace.count("nodes.binary")
        mid = ta + m // 2
        with trace.span("node.binary"):
            split = split_node(seqs, ta, mid, tb, qa, qb)
        pending.append(("binary", ta, tb, qa, qb, mid, split))

    with trace.span("tree", timed) as whole, ThreadPoolExecutor(
            max_workers=NATIVE_LEAF_WORKERS if in_cpp else LEAF_WORKERS) as pool:
        with trace.span("bisect", timed) as bisect:
            dev = bitpal._device(device)
            with trace.span("to_device"):
                q = torch.from_numpy(s2).to(dev)
                t = torch.from_numpy(s1).to(dev)
            seqs = (q, q.flip(0), t, t.flip(0))
            submit(0, s1.size, 0, s2.size)
            while pending:
                kind, ta, tb, qa, qb, at, found = pending.popleft()
                if kind == "binary":  # `at` is mid, `found` the crossing row
                    with trace.span("read_back"):
                        split = qa + int(found)
                    with trace.span("submit"):
                        submit(ta, at, qa, split)
                        submit(at, tb, split, qb)
                    continue
                with trace.span("read_back"):
                    xs = found.tolist()  # `at` holds the rows, `found` their columns
                if any(x0 > x1 for x0, x1 in zip(xs, xs[1:])):
                    submit(ta, tb, qa, qb, force_bin=True)
                    continue
                bounds = [(qa, ta)] + [(qa + r, ta + x) for r, x in zip(at, xs)]
                bounds.append((qb, tb))
                with trace.span("submit"):
                    for (r0, x0), (r1, x1) in zip(bounds, bounds[1:]):
                        submit(x0, x1, r0, r1)
        with trace.span("leaves.wait"):
            # leaves tile the text axis in order, and the query axis within
            # a column: sorting by (ta, qa) restores path order
            leaves.sort(key=lambda leaf: leaf[:2])
            walked = [fut.result() for _, _, fut in leaves]
        with trace.span("assemble"):
            a1 = "".join(r[1] for _, _, r in walked)
            a2 = "".join(r[2] for _, _, r in walked)
    walk_ns = sum(w for _, w, _ in walked)
    trace.count("leaf_walk_ns", walk_ns)
    trace.count("leaf_queue_ns", sum(q for q, _, _ in walked))
    if stats is not None:
        stats.update(counts, bisect_s=bisect.seconds, leaf_walk="native" if in_cpp else "numpy",
                     leaf_walk_s=walk_ns / 1e9, wall_s=whole.seconds)
    return sum(r[0] for _, _, r in walked), a1, a2


#: the sharded bisection's leaves: ``tpualign``'s ``base_cells`` and pool
SHARDED_BASE_CELLS = 1 << 18
SHARDED_LEAF_WORKERS = 4


def _soft_bucket(x: int) -> int:
    """``x`` rounded up to 1/8 of an octave (at least 16), as
    ``tpualign``'s query buckets."""
    x = max(16, x)
    p = 1 << max(1, x.bit_length() - 4)
    return -(-x // p) * p


def align_sharded(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, group=None,
                  chunk_cols: int = 512, base_cells: Optional[int] = None,
                  device="cuda") -> Tuple[int, str, str]:
    """Hirschberg's binary bisection whose forward and reverse column
    scores run the sharded bit-parallel pipeline
    (:func:`tpualign_torch.parallel.bitpal_strips.col_deltas_fn` over
    ``group``, default the default group of ``device``): the port of
    ``tpualign.ops.hirschberg.align_sharded``, split for split.

    ``s1`` is the text (columns), ``s2`` the query (rows, sharded in bands
    of words).  A segment of at most ``base_cells`` cells (or under 2 rows
    or columns; default ``SHARDED_BASE_CELLS``) is a leaf; otherwise the
    text is halved at ``mid``, the
    query padded to its bucket (:func:`_soft_bucket`; rows below a segment
    never change it), and the crossing row is the first argmax of the
    forward and reverse column scores.  The leaves are walked after the
    recursion on ``SHARDED_LEAF_WORKERS`` threads, in C++
    (:func:`tpualign_torch.utils.native.traceback`), so the strings are
    ``tpualign``'s; the score is the strings' (``oracle.alignment_score``).
    ValueError for a config outside the family."""
    fam = bitpal.family(cfg)
    if fam is None:
        raise ValueError("sharded hirschberg requires a bit-parallel scoring family")
    g = fam[1]
    base_cells = SHARDED_BASE_CELLS if base_cells is None else base_cells
    from ..parallel import bitpal_strips, mesh

    group = mesh.default_group(bitpal._device(device)) if group is None else group
    s1, s2 = bitpal._codes(s1), bitpal._codes(s2)
    solvers: dict = {}

    def col_scores(text, query):
        n_seg = len(query)
        if n_seg == 0:
            return np.zeros(1, np.int64) - g * len(text)
        nb = _soft_bucket(n_seg)
        qpad = np.ones(nb, np.int8)
        qpad[:n_seg] = query
        key = (len(text), nb)
        if key not in solvers:
            solvers[key] = bitpal_strips.col_deltas_fn(len(text), nb, cfg, group=group,
                                                       chunk_cols=chunk_cols)
        d = solvers[key](np.ascontiguousarray(text), qpad)[:n_seg].cpu().numpy()
        return np.concatenate(([0], np.cumsum(d))) - g * len(text)

    segs = []

    def rec(ta, tb, qa, qb):
        m, n = tb - ta, qb - qa
        if (m + 1) * (n + 1) <= base_cells or m < 2 or n < 2:
            segs.append((ta, tb, qa, qb))
            return
        mid = ta + m // 2
        F = col_scores(s1[ta:mid], s2[qa:qb])
        R = col_scores(s1[mid:tb][::-1], s2[qa:qb][::-1])
        split = int(np.argmax(F + R[::-1]))
        rec(ta, mid, qa, qa + split)
        rec(mid, tb, qa + split, qb)

    rec(0, len(s1), 0, len(s2))

    def leaf(seg):
        ta, tb, qa, qb = seg
        return native.traceback(s1[ta:tb], s2[qa:qb], cfg)

    with ThreadPoolExecutor(max_workers=SHARDED_LEAF_WORKERS) as pool:
        results = list(pool.map(leaf, segs))
    a1 = "".join(r[1] for r in results)
    a2 = "".join(r[2] for r in results)
    return oracle.alignment_score(a1, a2, cfg), a1, a2
