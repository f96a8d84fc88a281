"""Alignment scores under linear gaps, global (Needleman-Wunsch) or local
(Smith-Waterman), by a plain row scan in PyTorch.

Row ``i`` of the table ``H`` (``i`` over the query, ``j`` over the text)
follows from row ``i - 1``:

- ``T[j] = max(H[i-1][j-1] + s(q[i], t[j]), H[i-1][j] + gap)``, and at
  least 0 when local; ``T[0]`` is the left edge, ``i * gap`` (global) or 0;
- ``H[i][j] = max(T[j], H[i][j-1] + gap) = max_{k <= j} T[k] + (j - k) gap
  = j * gap + cummax_k (T[k] - k * gap)``.

The score is ``H[n][m]`` (global) or the largest cell (local).  Many pairs
scan together, padded to the longest text and query: a cell depends only on
cells above and to its left, so the padding never reaches a pair's own
cells, and each pair's score is read from its own rows and columns.

On a CUDA device the steps of ``ROWS_A_GRAPH`` rows are captured once as a
CUDA graph and replayed, so the host launches one graph a block of rows; on
the CPU the same steps run one by one.  ``dtype`` is the arithmetic's width:
int32 holds every value of the benchmark's cells, and the control computes
in int16.

A configuration names its reference by path (``"reference":
"benchmark/reference/linear.py"``).  Every reference module gives the
harness the same two functions: ``scores(texts, queries, config, *, device,
dtype)`` and ``fault(s1, s2, a1, a2, config, optimum)``.
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
    gap: int
    local: bool

    @classmethod
    def from_config(cls, config: dict) -> "Scheme":
        """The scheme of a configuration file; ValueError unless it is a
        linear-gap global or local one with a negative gap."""
        mode = config["mode"]
        if mode not in ("global", "local") or config.get("gap_open") is not None:
            raise ValueError(f"the plain reference scores linear-gap global or local "
                             f"schemes, not {config}")
        if config["gap"] >= 0:
            raise ValueError("the plain reference needs a negative gap")
        if config.get("matrix") is not None:
            raise ValueError("the plain reference scores match and mismatch, not a matrix")
        return cls(int(config["match"]), int(config["mismatch"]), int(config["gap"]),
                   mode == "local")

    def columns(self, c1: np.ndarray, c2: np.ndarray) -> int:
        """The score of an alignment's columns, codes with 0 for a gap."""
        gaps = (c1 == 0) | (c2 == 0)
        same = c1[~gaps] == c2[~gaps]
        return (self.match * int(same.sum()) + self.mismatch * int((~same).sum())
                + self.gap * int(gaps.sum()))


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
    g, local = scheme.gap, scheme.local
    # codes: the text's column j at j - 1; the query's row i at i (row 0 unused)
    text = _padded(texts, L - 1, -1).to(dev, dtype)
    query = _padded([np.concatenate([[0], q]) for q in queries], R + 1, -2).to(dev, dtype)
    match = torch.tensor(scheme.match, dtype=dtype, device=dev)
    mismatch = torch.tensor(scheme.mismatch, dtype=dtype, device=dev)
    j = torch.arange(L, dtype=torch.int64, device=dev)
    ramp = (-g * j).to(dtype)
    floor = torch.tensor(torch.iinfo(dtype).min, dtype=dtype, device=dev)
    row0 = torch.zeros(P, L, dtype=dtype, device=dev) if local else (g * j).to(dtype).expand(P, L)
    m, n = m.to(dev), n.to(dev)
    in_text = j.unsqueeze(0) <= m.unsqueeze(1)
    first = torch.zeros(P, dtype=dtype, device=dev) if local else (g * m).to(dtype)

    H = row0.clone()
    i = torch.ones(1, dtype=torch.int64, device=dev)
    best = first.clone()

    def step() -> None:
        q = query.index_select(1, i)
        t = torch.maximum(H[:, :-1] + torch.where(text == q, match, mismatch), H[:, 1:] + g)
        if local:
            t = t.clamp_min(0)
            left = torch.zeros(P, 1, dtype=dtype, device=dev)
        else:
            left = (i * g).to(dtype).expand(P, 1)
        row = _prefix_max(torch.cat([left, t], dim=1) + ramp, floor) - ramp
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
    ``optimum`` under ``config``'s scheme, else what is wrong with it."""
    scheme = Scheme.from_config(config)
    return alignment.fault(s1, s2, a1, a2, local=scheme.local, value=scheme.columns,
                           optimum=optimum)
