"""Alignment scores under affine gaps (Gotoh), global or local, by a plain
row scan in PyTorch.

A gap of length ``L`` costs ``open + L * ext`` (``gap_open``,
``gap_extend``).  Row ``i`` of the tables (``i`` over the query, ``j`` over
the text; ``H`` the best score of a cell, ``E`` of one that ends in a
horizontal gap, ``F`` in a vertical one) follows from row ``i - 1``:

- ``F[i][j] = max(H[i-1][j] + open, F[i-1][j]) + ext``;
- ``T[j] = max(H[i-1][j-1] + s(q[i], t[j]), F[i][j])``, and at least 0
  when local; ``T[0]`` is the left edge;
- ``E[i][j] = max_{k < j} H[i][k] + open + (j - k) ext
  = j * ext + open + max_{k < j} (T[k] - k * ext)``, by ``torch.cummax``;
- ``H[i][j] = max(T[j], E[i][j])``.

The third line's second form holds for ``open <= 0``: a gap that starts in
``E[i][k]`` is itself a run from some ``T[k']``, and one open more never
helps.  Edges: global ``H[0][j] = open + j * ext`` and ``H[i][0] = open +
i * ext``, 0 at the corner, ``F[0] = H[0] + open``; local, 0 on both
edges.  The score is ``H[n][m]`` (global) or the largest cell (local).

Many pairs scan together, padded to the longest text and query, and on a
CUDA device blocks of ``ROWS_A_GRAPH`` rows are captured once as a CUDA
graph and replayed, as :mod:`.linear` does (see there).  ``dtype`` is the
arithmetic's width: int32 holds every value of the benchmark's cells, and
the control computes in int16.

It gives the harness ``scores(texts, queries, config, *, device, dtype)``
and ``fault(s1, s2, a1, a2, config, optimum)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import alignment

#: columns a block of the blocked prefix max (``torch.cummax`` over one long
#: row runs on one thread block on CUDA)
PREFIX_BLOCK = 512
#: rows a captured CUDA graph
ROWS_A_GRAPH = 64


@dataclasses.dataclass(frozen=True)
class Scheme:
    match: int
    mismatch: int
    open: int
    ext: int
    local: bool

    @classmethod
    def from_config(cls, config: dict) -> "Scheme":
        """The scheme of a configuration file; ValueError unless it is an
        affine-gap global or local one with ``gap_open <= 0``."""
        mode = config["mode"]
        if mode not in ("global", "local") or config.get("gap_open") is None:
            raise ValueError(f"the affine reference scores affine-gap global or local "
                             f"schemes, not {config}")
        if config["gap_open"] > 0:
            raise ValueError("the affine reference needs gap_open <= 0")
        if config.get("matrix") is not None:
            raise ValueError("the affine reference scores match and mismatch, not a matrix")
        return cls(int(config["match"]), int(config["mismatch"]), int(config["gap_open"]),
                   int(config["gap_extend"]), mode == "local")

    def columns(self, c1: np.ndarray, c2: np.ndarray) -> int:
        """The score of an alignment's columns, codes with 0 for a gap:
        each maximal run of gaps in either string costs ``open + L * ext``,
        so two adjacent runs in different strings are two gaps."""
        gap1, gap2 = c1 == 0, c2 == 0
        gaps = gap1 | gap2
        same = c1[~gaps] == c2[~gaps]
        runs = sum(int((g & ~np.concatenate([[False], g[:-1]])).sum()) for g in (gap1, gap2))
        return (self.match * int(same.sum()) + self.mismatch * int((~same).sum())
                + self.open * runs + self.ext * int(gaps.sum()))


def _padded(seqs: Sequence[np.ndarray], width: int, fill: int) -> torch.Tensor:
    out = np.full((len(seqs), width), fill, dtype=np.int64)
    for p, s in enumerate(seqs):
        out[p, :s.size] = s
    return torch.from_numpy(out)


def _prefix_max(x: torch.Tensor, floor: torch.Tensor) -> torch.Tensor:
    """Running max along the rows of ``x`` ``(P, L)``, ``L`` a multiple of
    ``PREFIX_BLOCK``: within blocks, then each block raised to the max of
    the blocks before it."""
    P, L = x.shape
    blocks = torch.cummax(x.view(P, L // PREFIX_BLOCK, PREFIX_BLOCK), dim=2).values
    carry = torch.cummax(blocks[:, :, -1], dim=1).values
    carry = torch.cat([floor.expand(P, 1), carry[:, :-1]], dim=1)
    return torch.maximum(blocks, carry.unsqueeze(2)).view(P, L)


def scores(texts: Sequence[np.ndarray], queries: Sequence[np.ndarray], config: dict, *,
           device, dtype: torch.dtype = torch.int32) -> np.ndarray:
    """Scores of the pairs ``(texts[p], queries[p])`` (text across the
    columns, query down the rows) under ``config``'s scheme, as an int64
    array."""
    scheme = Scheme.from_config(config)
    dev = torch.device(device)
    P = len(texts)
    m = torch.tensor([t.size for t in texts], dtype=torch.int64)
    n = torch.tensor([q.size for q in queries], dtype=torch.int64)
    W = int(m.max())
    L = -(-(W + 1) // PREFIX_BLOCK) * PREFIX_BLOCK
    graphed = dev.type == "cuda"
    R = int(n.max())
    if graphed:
        R = -(-R // ROWS_A_GRAPH) * ROWS_A_GRAPH
    op, ext, local = scheme.open, scheme.ext, scheme.local
    # codes: the text's column j at j - 1; the query's row i at i (row 0 unused)
    text = _padded(texts, L - 1, -1).to(dev, dtype)
    query = _padded([np.concatenate([[0], q]) for q in queries], R + 1, -2).to(dev, dtype)
    match = torch.tensor(scheme.match, dtype=dtype, device=dev)
    mismatch = torch.tensor(scheme.mismatch, dtype=dtype, device=dev)
    j = torch.arange(L, dtype=torch.int64, device=dev)
    ramp = (ext * j).to(dtype)
    floor = torch.tensor(torch.iinfo(dtype).min, dtype=dtype, device=dev)
    if local:
        row0 = torch.zeros(P, L, dtype=dtype, device=dev)
    else:
        row0 = torch.where(j == 0, 0, op + ext * j).to(dtype).expand(P, L)
    m, n = m.to(dev), n.to(dev)
    in_text = j.unsqueeze(0) <= m.unsqueeze(1)
    first = torch.zeros(P, dtype=dtype, device=dev) if local else (op + ext * m).to(dtype)

    H = row0.clone()
    F = row0 + op
    i = torch.ones(1, dtype=torch.int64, device=dev)
    best = first.clone()

    def step() -> None:
        q = query.index_select(1, i)
        F.copy_(torch.maximum(H + op, F) + ext)
        t = torch.maximum(H[:, :-1] + torch.where(text == q, match, mismatch), F[:, 1:])
        if local:
            t = t.clamp_min(0)
            left = torch.zeros(P, 1, dtype=dtype, device=dev)
        else:
            left = (op + ext * i).to(dtype).expand(P, 1)
        t = torch.cat([left, t], dim=1)
        # E[j] for j >= 1 from the running max of T[k] - k * ext over k < j
        e = _prefix_max(t - ramp, floor)[:, :-1] + ramp[1:] + op
        row = torch.cat([left, torch.maximum(t[:, 1:], e)], dim=1)
        H.copy_(row)
        if local:
            seen = torch.where(in_text, row, 0).amax(dim=1)
            best.copy_(torch.where(i <= n, torch.maximum(best, seen), best))
        else:
            best.copy_(torch.where(i == n, row.gather(1, m.unsqueeze(1)).squeeze(1), best))
        i.add_(1)

    if not graphed:
        for _ in range(R):
            step()
        return best.to(torch.int64).cpu().numpy()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()  # warm-up before the capture, then the state starts again
        H.copy_(row0)
        F.copy_(row0 + op)
        i.fill_(1)
        best.copy_(first)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ROWS_A_GRAPH):
            step()
    for _ in range(R // ROWS_A_GRAPH):
        graph.replay()
    out = best.to(torch.int64).cpu().numpy()
    del graph
    return out


def fault(s1: np.ndarray, s2: np.ndarray, a1: str, a2: str, config: dict,
          optimum: int) -> Optional[str]:
    """None if ``(a1, a2)`` is an alignment of ``s1`` against ``s2`` scoring
    ``optimum`` under ``config``'s affine scheme, else what is wrong with
    it."""
    scheme = Scheme.from_config(config)
    return alignment.fault(s1, s2, a1, a2, local=scheme.local, value=scheme.columns,
                           optimum=optimum)
