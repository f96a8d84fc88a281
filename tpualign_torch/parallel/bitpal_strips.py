"""Bit-parallel strips over a shard group: the port of
``tpualign/parallel/bitpal_strips.py``.

Shard ``c`` owns a band of the query's 64-row words, ``nwl = ceil(nw / P)``
of them (the last bands padded with rows that match nothing), and keeps
its band's state (the planes and the hand-offs,
:class:`tpualign_torch.ops.bitpal.WaveState`) on its device for the whole
run.  The text, every column, lies on every shard.  Each superstep runs
one chunk of at most ``chunk_cols`` steps of the shard's own staggered
fill (:func:`tpualign_torch.ops.bitpal.fill_g_stream`, K4's sharded
contract): word 0's h_top at each step is the upstream shard's tail, and
the shard's last word's h_out at each step (its tail) goes to the next
shard.

The delay is the port's own.  In a fill of ``nwl`` words one step of
stagger apart, the last word's h_out for column ``j`` leaves at step
``j + nwl - 1``, and word 0 of the next shard takes column ``j`` at its
step ``j``: the stream runs ``d = nwl - 1`` steps ahead of its reader.  So
shard ``c``'s chunk ``q`` runs its steps ``q*T - c*d + 1 .. (q+1)*T - c*d``
(those in ``1 .. mt + d``, the fill's steps), and its tail is what shard
``c + 1``'s chunk ``q`` reads, step for step at the same place of a
buffer of ``T`` bytes: one superstep of delay a shard, where the TPU's
two-step stagger and bottom-aligned slots needed two and a splice of two
chunks.  A reader's steps past ``mt`` take no column, so the bytes past
the writer's last step (zeros) change nothing.  ``K = ceil((mt + d +
(P-1)*d) / T)`` chunks a shard, ``K + P - 1`` supersteps in all.

``score`` sums each shard's final-column deltas over its real rows (the
``psum`` of the reference); ``col_deltas_fn`` returns the final column's
deltas row for row up to ``n`` (the sharded Hirschberg's column scores).
The family only (:func:`tpualign_torch.ops.bitpal.family`), pair-scored
global configs (``ensure_pair_modes``), codes 0..4.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ScoringConfig, ensure_pair_modes
from ..ops import bitpal
from ..ops.bitpal import WORD, _device
from . import mesh

#: the chunk's steps, ``tpualign``'s ``chunk_cols`` default
CHUNK_COLS = 2048


def geometry(n: int, m: int, P: int, chunk_cols: int):
    """``(nw, nwl, d, K)``: the query's words, the words of a shard, the
    stream's delay in steps and the chunks a shard runs, for a query of
    ``n`` rows, a text of ``m`` columns and ``P`` shards."""
    nw = -(-n // WORD)
    nwl = -(-nw // P)
    d = nwl - 1
    K = -(-(m + nwl - 1 + (P - 1) * d) // chunk_cols)
    return nw, nwl, d, K


def _family(cfg: ScoringConfig) -> int:
    ensure_pair_modes(cfg, "bitpal_strips")
    fam = bitpal.family(cfg)
    if fam is None:
        raise ValueError(
            "bitpal_strips requires a bit-parallel scoring family "
            "(affinely reducible to (1,0,-g)); use parallel.strips otherwise")
    return fam[1]


def check(s1, s2, cfg: ScoringConfig) -> None:
    """ValueError where :func:`score` refuses the pair before it runs: a
    config outside the family, codes outside 0..4."""
    _family(cfg)
    bitpal._codes(s1), bitpal._codes(s2)


def _run(s1: np.ndarray, s2: np.ndarray, g: int, group, chunk_cols: int):
    """The pipeline over ``group``: each local shard's final planes and
    its real rows, ``{c: (planes, rows)}``."""
    m, n = s1.size, s2.size
    P = group.size
    nw, nwl, d, K = geometry(n, m, P, chunk_cols)
    T = chunk_cols
    shards = {}
    for c in group.shards:
        dev = group.device(c)
        r0 = min(c * nwl * WORD, n)
        rows = min(n - r0, nwl * WORD)
        q = torch.full((nwl * WORD,), -1, dtype=torch.int64)
        q[:rows] = torch.from_numpy(s2[r0 : r0 + rows].astype(np.int64))
        shards[c] = dict(dev=dev, rows=rows, text=torch.from_numpy(s1).to(dev),
                         eq=bitpal._eq_planes_batch(q.view(1, -1))[0].to(dev),
                         state=bitpal.init_state(nwl, g, dev))

    total = bitpal.total_steps(m, nwl, 1)

    def step(c, t, got):
        sh = shards[c]
        out = torch.zeros(T, dtype=torch.uint8, device=sh["dev"])
        q = t - c
        base = q * T - c * d  # the step before the chunk's first place
        lo, hi = max(0, base), min(base + T, total)
        if not 0 <= q < K or hi <= lo:
            return out
        u_in = None if c == 0 else got[lo - base : hi - base]
        sh["state"], tail = bitpal.fill_g_stream(sh["text"], sh["eq"], nwl * WORD, g, lo,
                                                 hi - lo, sh["state"], u_in, nwl - 1)
        out[lo - base : hi - base] = tail
        return out

    mesh.run(group, step, K + P - 1)
    return {c: (sh["state"].planes, sh["rows"]) for c, sh in shards.items()}


def score_fn(m: int, n: int, cfg: ScoringConfig = ScoringConfig(), *, group=None,
             chunk_cols: int = CHUNK_COLS, device="cuda"):
    """``(s1, s2) -> score`` for ``len(s1) = m`` (text, columns) and
    ``len(s2) = n`` (query, rows, sharded in bands of words over
    ``group``, default :func:`tpualign_torch.parallel.mesh.default_group` of
    ``device``).  Refuses configs outside the family (ValueError)."""
    g = _family(cfg)
    if chunk_cols < 1:
        raise ValueError(f"chunk_cols must be positive, got {chunk_cols}")
    group = mesh.default_group(_device(device)) if group is None else group

    def fn(s1, s2) -> int:
        a, b = bitpal._codes(s1), bitpal._codes(s2)
        if (a.size, b.size) != (m, n):
            raise ValueError(f"score_fn built for lengths ({m}, {n}), got ({a.size}, {b.size})")
        if m == 0 or n == 0:
            return cfg.gap * (m + n)
        parts = _run(a, b, g, group, chunk_cols)
        sums = [bitpal.row_deltas(planes, rows, g).sum() if rows
                else torch.zeros((), dtype=torch.int64, device=planes[0].device)
                for planes, rows in parts.values()]
        unit = int(group.sum(sums)) - g * m
        return bitpal._from_unit(cfg, m + n, unit)

    return fn


def col_deltas_fn(m: int, n: int, cfg: ScoringConfig = ScoringConfig(), *, group=None,
                  chunk_cols: int = CHUNK_COLS, device="cuda"):
    """``(s1, s2) -> (n,)`` int64: the final column's vertical deltas
    ``v(i, m)`` under the family's reduced scheme ``(1, 0, -g)``, row for
    row, on every shard of ``group``: ``H(i, m) = -g*m + cumsum(v)[i]``,
    the sharded Hirschberg's column scores."""
    g = _family(cfg)
    group = mesh.default_group(_device(device)) if group is None else group

    def fn(s1, s2) -> torch.Tensor:
        a, b = bitpal._codes(s1), bitpal._codes(s2)
        if (a.size, b.size) != (m, n) or n == 0:
            raise ValueError(f"col_deltas_fn built for lengths ({m}, {n} >= 1), got "
                             f"({a.size}, {b.size})")
        if m == 0:  # the boundary column: v = -g in every row
            return torch.full((n,), -g, dtype=torch.int64)
        parts = _run(a, b, g, group, chunk_cols)
        nwl = geometry(n, m, group.size, chunk_cols)[1]
        return group.gather([bitpal.row_deltas(planes, nwl * WORD, g)
                             for planes, _ in parts.values()])[:n]

    return fn


def score(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, group=None,
          chunk_cols: int = CHUNK_COLS, device="cuda") -> int:
    """Sharded bit-parallel NW score of ``s1`` (text) against ``s2``
    (query, sharded); see the module docstring."""
    a, b = bitpal._codes(s1), bitpal._codes(s2)
    return score_fn(a.size, b.size, cfg, group=group, chunk_cols=chunk_cols,
                    device=device)(a, b)
