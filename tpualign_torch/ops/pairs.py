"""A batch of pairs packed for the batch fills: the host side that
``ops/band_batch.py``, ``ops/bitpal.py``'s batch and ``ops/xla.py``'s
batched row scan share.  The pairs are concatenated once, so packing
costs no Python work per pair beyond reading its length."""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import trace


def int8_codes(seq) -> np.ndarray:
    """A 1-D code sequence as a contiguous int8 array (ValueError if a code
    does not fit), the form the band and diagonal kernels read."""
    a = np.asarray(seq)
    if a.ndim != 1:
        raise ValueError(f"sequence must be 1-D, got shape {a.shape}")
    if a.size and (a.min() < -128 or a.max() > 127):
        raise ValueError("sequence codes must fit int8")
    return np.ascontiguousarray(a, dtype=np.int8)


class Pairs(NamedTuple):
    """A batch of non-empty pairs packed for the batch fills: pair ``p``'s
    text (columns) is ``texts[offsets[0, p]:][:lengths[0, p]]`` and its
    query (rows) ``queries[offsets[1, p]:][:lengths[1, p]]``; ``m_cap`` and
    ``n_cap`` are the longest text and query, known on the host."""

    texts: torch.Tensor  # (sum m,) int8
    queries: torch.Tensor  # (sum n,) int8
    offsets: torch.Tensor  # (2, P) int64
    lengths: torch.Tensor  # (2, P) int32, each at least 1
    m_cap: int
    n_cap: int

    def to(self, device) -> "Pairs":
        return self._replace(texts=self.texts.to(device), queries=self.queries.to(device),
                             offsets=self.offsets.to(device), lengths=self.lengths.to(device))


def batch_lengths(texts: Sequence, queries: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """The text and query lengths of a batch as int64 arrays; ValueError
    unless there are as many texts as queries."""
    if len(texts) != len(queries):
        raise ValueError(f"{len(texts)} texts but {len(queries)} queries")
    return (np.fromiter(map(len, texts), np.int64, len(texts)),
            np.fromiter(map(len, queries), np.int64, len(queries)))


def pack_pairs(texts: Sequence, queries: Sequence, live: np.ndarray) -> Pairs:
    """The pairs at the indices ``live`` (each non-empty) packed on the host:
    one concatenation of the texts and one of the queries, as int8 codes
    (ValueError if a code does not fit).  The span ``pack``; the counter
    ``pairs`` counts the pairs packed."""
    with trace.span("pack"):
        if len(live) == len(texts):
            ts, qs = texts, queries
        else:
            ts, qs = [texts[i] for i in live], [queries[i] for i in live]
        m, n = batch_lengths(ts, qs)
        flat_t, flat_q = int8_codes(np.concatenate(ts)), int8_codes(np.concatenate(qs))
        offsets = np.stack([np.cumsum(m) - m, np.cumsum(n) - n])
        lengths = np.stack([m, n]).astype(np.int32)
    trace.count("pairs", len(m))
    return Pairs(torch.from_numpy(flat_t), torch.from_numpy(flat_q),
                 torch.from_numpy(offsets), torch.from_numpy(lengths),
                 int(m.max()), int(n.max()))


def pad_pairs(flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor,
              cap: int, fill: int = 0) -> torch.Tensor:
    """``(P, cap)`` int64: row ``p`` is ``flat[offsets[p]:][:lengths[p]]``
    followed by ``fill``."""
    cols = torch.arange(cap, device=flat.device)
    idx = (offsets.view(-1, 1) + cols).clamp_(max=flat.numel() - 1)
    return torch.where(cols < lengths.view(-1, 1), flat[idx].long(), fill)
