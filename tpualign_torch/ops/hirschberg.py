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
exact full-table traceback (:func:`tpualign_torch.ops.oracle.traceback`) on
a thread pool while the bisection goes on, and concatenated in path order.

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
from typing import Tuple

import numpy as np
import torch

from ..config import ScoringConfig
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

#: threads walking leaves, beside the thread that runs the bisection.  The
#: NumPy walk holds the interpreter lock, so more threads only contend for
#: it: at the 64gb shape (199 leaves of ~640 x 640) one walker took 3.2 s,
#: two 8.0 s, eight 25.2 s (H100 80GB HBM3 host, 700 W card)
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
    by :func:`tpualign_torch.ops.oracle.traceback` under ``cfg``.

    ``stats``, when given, is filled with counts and host-clock seconds:
    ``kway_nodes``, ``binary_nodes``, ``leaves``, ``leaf_cells``,
    ``bisect_s`` (until the last node's crossings are read back),
    ``leaf_walk_s`` (the leaf walks' own times, summed over the threads)
    and ``wall_s``."""
    t_start = time.perf_counter()
    dev = bitpal._device(device)
    q = torch.from_numpy(s2).to(dev)
    t = torch.from_numpy(s1).to(dev)
    seqs = (q, q.flip(0), t, t.flip(0))
    counts = dict(kway_nodes=0, binary_nodes=0, leaves=0, leaf_cells=0)
    leaves = []  # (ta, qa, future of (walk seconds, (score, a1, a2)))
    pending = deque()

    def walk(ta, tb, qa, qb):
        t0 = time.perf_counter()
        result = oracle.traceback(s1[ta:tb], s2[qa:qb], cfg)
        return time.perf_counter() - t0, result

    def submit(ta, tb, qa, qb, force_bin=False):
        m, n = tb - ta, qb - qa
        if (m + 1) * (n + 1) <= BASE_CELLS or m < 2 or n < 2:
            counts["leaves"] += 1
            counts["leaf_cells"] += (m + 1) * (n + 1)
            leaves.append((ta, qa, pool.submit(walk, ta, tb, qa, qb)))
            return
        rows = _kway_rows(n) if n >= KWAY_MIN_ROWS and not force_bin else []
        if rows:
            counts["kway_nodes"] += 1
            xs = kway_node(seqs, ta, tb, qa, qb, rows)
            pending.append(("kway", ta, tb, qa, qb, rows, xs))
            return
        counts["binary_nodes"] += 1
        mid = ta + m // 2
        split = split_node(seqs, ta, mid, tb, qa, qb)
        pending.append(("binary", ta, tb, qa, qb, mid, split))

    with ThreadPoolExecutor(max_workers=LEAF_WORKERS) as pool:
        submit(0, s1.size, 0, s2.size)
        while pending:
            kind, ta, tb, qa, qb, at, found = pending.popleft()
            if kind == "binary":  # `at` is mid, `found` the crossing row
                split = qa + int(found)
                submit(ta, at, qa, split)
                submit(at, tb, split, qb)
                continue
            xs = found.tolist()  # `at` holds the rows, `found` their columns
            if any(x0 > x1 for x0, x1 in zip(xs, xs[1:])):
                submit(ta, tb, qa, qb, force_bin=True)
                continue
            bounds = [(qa, ta)] + [(qa + r, ta + x) for r, x in zip(at, xs)]
            bounds.append((qb, tb))
            for (r0, x0), (r1, x1) in zip(bounds, bounds[1:]):
                submit(x0, x1, r0, r1)
        bisect_s = time.perf_counter() - t_start
        # leaves tile the text axis in order, and the query axis within a
        # column: sorting by (ta, qa) restores path order
        leaves.sort(key=lambda leaf: leaf[:2])
        walked = [fut.result() for _, _, fut in leaves]
    a1 = "".join(r[1] for _, r in walked)
    a2 = "".join(r[2] for _, r in walked)
    if stats is not None:
        stats.update(counts, bisect_s=bisect_s,
                     leaf_walk_s=sum(s for s, _ in walked),
                     wall_s=time.perf_counter() - t_start)
    return sum(r[0] for _, r in walked), a1, a2
