"""Batch scoring of many pairs under any ``ScoringConfig`` in one launch:
the port of ``tpualign/ops/band_batch.py``.

Each pair gets a thread block of its own in one launch of the batch
kernel ``band_batch_fill`` (``csrc/band_batch.cu``, the batch contract of
K7's port over the fill template of K6's, ``csrc/band_fill.cuh``), so the
card's scheduler spreads the pairs over its SMs.  Its plain version is the
batched row scan :func:`tpualign_torch.ops.xla.score_batch`.

Orientation is fixed, as in the JAX module: texts run across the columns
and queries down the rows, so no pair swaps and neither a matrix nor the
ends-free flags transpose per pair.  The host takes pairs with an empty
side out before the launch (closed form, :func:`band._empty_score`) and
adds the closed-form boundary cells H(n_p, 0) and H(0, m_p) after it, as
:func:`band.plan` does for one pair.  The port refuses only the int32
headroom; it serves what the TPU batch refuses (affine gaps, masked local
scoring, pairs past one strip), with the same scores, since its fill takes
all of them: the port's own choice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..config import ScoringConfig
from . import band, xla
from .bitpal import _device
from .pairs import Pairs, batch_lengths, pack_pairs


def _check_pairs(pairs: Pairs) -> None:
    for name, t, dtype in (("texts", pairs.texts, torch.int8),
                           ("queries", pairs.queries, torch.int8),
                           ("offsets", pairs.offsets, torch.int64),
                           ("lengths", pairs.lengths, torch.int32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor, got {t.dtype}")
        if t.device != pairs.texts.device:
            raise ValueError(f"{name} on {t.device} but texts on {pairs.texts.device}")
    if pairs.offsets.dim() != 2 or pairs.offsets.shape[0] != 2 or pairs.offsets.shape[1] < 1:
        raise ValueError(f"offsets must be (2, P) with P >= 1, got {tuple(pairs.offsets.shape)}")
    if pairs.lengths.shape != pairs.offsets.shape:
        raise ValueError(f"lengths {tuple(pairs.lengths.shape)} != offsets "
                         f"{tuple(pairs.offsets.shape)}")
    if pairs.m_cap < 1 or pairs.n_cap < 1:
        raise ValueError(f"m_cap and n_cap must be at least 1, got {pairs.m_cap}, {pairs.n_cap}")


def batch_fill(pairs: Pairs, cfg: ScoringConfig, ends,
               geometry: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Every pair's result under the band kernel's contract (``(P,)`` int64
    on the pairs' device, ``ends`` the flags of every pair): the CUDA kernel
    ``band_batch_fill`` for CUDA tensors, one block per pair;
    :func:`tpualign_torch.ops.xla.score_batch` for CPU tensors.

    ``geometry``: ``(k, threads)`` for every block, as in
    :func:`band.band_fill`; default :func:`band.kernel_geometry` of the
    longest query with ``k`` at most :func:`band.max_k`.  It never changes
    the result.  On CUDA the wrapper allocates the boundary rows and the
    output, launches on the current stream without synchronising, and
    counts the launch in ``batch_fill.launches``.  A launch the device
    refuses raises; nothing falls back to the plain version."""
    _check_pairs(pairs)
    dev = pairs.texts.device
    if dev.type == "cpu":
        return xla.score_batch(pairs, cfg, ends)
    if dev.type != "cuda":
        raise ValueError(f"batch_fill runs on cpu or cuda tensors, got {dev}")
    P = pairs.offsets.shape[1]
    k, threads = geometry or band.kernel_geometry(pairs.n_cap, band.max_k(cfg))
    lib = _build.load()
    K = len(cfg.matrix) if cfg.has_matrix else 0
    matrix = torch.tensor(cfg.matrix if K else [0], dtype=torch.int32).to(dev)
    boundary = torch.empty((P, 2, pairs.m_cap + 1), dtype=torch.int32, device=dev)
    out = torch.empty(P, dtype=torch.int32, device=dev)
    off, lens = pairs.offsets, pairs.lengths
    with torch.cuda.device(dev):
        err = lib.band_batch_fill(
            pairs.texts.data_ptr(), pairs.queries.data_ptr(), off[0].data_ptr(),
            off[1].data_ptr(), lens[0].data_ptr(), lens[1].data_ptr(), P, pairs.m_cap,
            matrix.data_ptr(), K, cfg.match, cfg.mismatch, cfg.gap, cfg.gap_open or 0,
            cfg.gap_extend or 0, band._flags(cfg, ends), k, threads, boundary.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"band_batch_fill launch failed with CUDA error {err}")
    batch_fill.launches += 1
    return out.long()


batch_fill.launches = 0


def floors(cfg: ScoringConfig, m: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Per pair, the largest closed-form boundary cell the score maxes over
    (:func:`band.plan`'s ``floor`` in the batch's orientation): H(n_p, 0)
    with a free row end, H(0, m_p) with a free column end; None when the
    config has neither."""
    zr, zc, er, ec = band._ends_flags(cfg, False)
    parts = []
    if er:
        parts.append(np.zeros_like(n) if zc else xla.gap_run(cfg, n))
    if ec:
        parts.append(np.zeros_like(m) if zr else xla.gap_run(cfg, m))
    return np.max(parts, axis=0) if parts else None


def score_batch(texts: Sequence, queries: Sequence, cfg: ScoringConfig = ScoringConfig(), *,
                device) -> np.ndarray:
    """Scores of the pairs ``(texts[p], queries[p])`` under ``cfg`` on
    ``device`` (``"cuda"`` runs one launch of the batch kernel, ``"cpu"``
    the plain version), as ``(P,)`` int64: the counterpart of
    ``tpualign.ops.band_batch.score_batch``, with ``texts[p]`` across the
    columns and ``queries[p]`` down the rows.  Refuses a batch past the
    int32 headroom (ValueError)."""
    m, n = batch_lengths(texts, queries)
    if not m.size:
        return np.zeros(0, np.int64)
    band._check_cfg(cfg, int(m.max()) + int(n.max()))
    dev = _device(device)
    out = np.zeros(m.size, np.int64)
    live = (m > 0) & (n > 0)
    for p in np.flatnonzero(~live):
        out[p] = band._empty_score(int(m[p]), int(n[p]), cfg)
    if not live.any():
        return out
    pairs = pack_pairs(texts, queries, np.flatnonzero(live))
    xla.check_codes(pairs.texts, pairs.queries, cfg)
    raw = batch_fill(pairs.to(dev), cfg, band._ends_flags(cfg, False)).cpu().numpy()
    floor = floors(cfg, m[live], n[live])
    out[live] = raw if floor is None else np.maximum(raw, floor)
    return out
