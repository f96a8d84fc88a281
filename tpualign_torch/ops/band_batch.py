"""Batch scoring of many pairs under any ``ScoringConfig`` in one launch:
the port of ``tpualign/ops/band_batch.py``.

The batch kernel ``band_batch_fill`` (``csrc/band_batch.cu``, the batch
contract of K7's port over the fill template of K6's,
``csrc/band_fill.cuh``) runs the whole batch in one launch, each pair on
one of two schedules that the host's plan (:func:`batch_plan`) picks by its
query's length:

- a short pair, a query of at most ``32 * k`` rows (``k`` rows a lane, at
  most :func:`band.max_k`), takes a warp of its own: each lane owns ``k``
  rows, the row above comes by a shuffle, the top row in closed form, and
  no step waits on a block barrier, so the pairs run side by side, as many
  as the card holds warps;
- a long pair's rows are cut into strips of ``LONG_K * threads`` rows, and
  the strips of every long pair, longest pair first, are numbered into one
  ticket that the blocks take in order, each pair a pipeline of its own
  with its own ring of rows and progress flags, as K6's fill runs one
  table (:func:`band.pipeline_plan`).

The short pairs are bounded by the instructions of their cells, the long
ones by the step latency of their pipelines (the longest pair's steps).
Its plain version is the batched row scan
:func:`tpualign_torch.ops.xla.score_batch`.

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

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build, trace
from ..config import ScoringConfig
from . import band, xla
from .bitpal import _device
from .pairs import Pairs, batch_lengths, pack_pairs

#: a long pair's rows a thread (kLongK in csrc/band_batch.cu): the strip
#: pipeline's geometry that :func:`band.pipeline_geometry` picks for mix
#: (A)'s pairs and the 64gb shape, at most MAX_K_LOCAL_AFFINE
LONG_K = 8


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


class BatchPlan(NamedTuple):
    """One launch of the batch fill over ``blocks`` blocks of ``threads``
    threads.  The short pairs (queries of at most ``32 * k`` rows) run a warp
    each at ``k`` rows a lane; the ``longs`` long pairs' strips of ``LONG_K *
    threads`` rows run on the pipeline, long pair ``i``'s strips the tickets
    ``first[i] .. first[i + 1] - 1``, its ring ``depth[i]`` rows (0 for one
    strip) at int32 offset ``ring_at[i]`` of ``ring`` int32 in all.
    ``order`` lists the pairs' indices: the long ones longest first (text
    plus query), then the short ones in the batch's order."""

    k: int
    threads: int
    blocks: int
    order: np.ndarray
    longs: int
    first: np.ndarray
    depth: np.ndarray
    ring_at: np.ndarray
    ring: int

    @property
    def strips(self) -> int:
        """The long pairs' strips, every one."""
        return int(self.first[-1])

    @property
    def sched(self) -> np.ndarray:
        """The kernel's ``sched`` argument: ``order``, ``first``, ``ring_at``
        and ``depth`` in one int64 array."""
        return np.concatenate([self.order, self.first, self.ring_at, self.depth]).astype(np.int64)

    def describe(self) -> str:
        """The plan in one line, for logs."""
        shorts = self.order.size - self.longs
        rings = (f", rings of {self.depth.min()}..{self.depth.max()} rows"
                 if self.longs else "")
        return (f"{shorts} short pairs a warp each at k = {self.k}, {self.longs} long pairs in "
                f"{self.strips} strips of {LONG_K} x {self.threads} rows{rings}; {self.blocks} "
                f"blocks of {self.threads} threads")


def batch_plan(m, n, affine: bool, max_k: int = band.MAX_K,
               geometry: Optional[Tuple[int, ...]] = None,
               budget: Optional[int] = None) -> BatchPlan:
    """The launch of the batch fill of pairs of texts of ``m[p]`` columns and
    queries of ``n[p]`` rows (each at least 1).  ``geometry`` is ``(k,
    threads)`` or ``(k, threads, blocks)``; by default ``k`` is the fewest
    rows a lane that hold the longest query of at most ``32 * max_k`` rows
    (1 when there is none), ``threads`` :data:`band.PIPE_THREADS`, and
    ``blocks`` ``min(strips + ceil(shorts / warps), SMS * BLOCKS_PER_SM)``.
    A pair whose query has at most ``32 * k`` rows is short.  Each long pair
    with two strips or more has a ring of ``min(strips, blocks + 1)`` rows of
    ``m + 1`` int32 (twice under affine gaps), fewer if the rings pass
    ``budget`` bytes (default ``band.RING_BUDGET``; the CUDA wrapper passes
    ``band.ring_budget()``), never fewer than 2.  ValueError for a batch, a
    geometry or a ticket count the kernel refuses; ``torch.OutOfMemoryError``
    when rings of 2 rows do not fit the budget, which no route falls back
    on."""
    m = np.asarray(m, np.int64)
    n = np.asarray(n, np.int64)
    if m.ndim != 1 or m.shape != n.shape or not m.size:
        raise ValueError(f"the batch fill needs one length a pair on each side, got "
                         f"{m.shape} and {n.shape}")
    if m.min() < 1 or n.min() < 1:
        raise ValueError("every pair's text and query need at least one code")
    if geometry is not None and len(geometry) not in (2, 3):
        raise ValueError(f"geometry is (k, threads) or (k, threads, blocks), got {geometry}")
    threads = band.PIPE_THREADS if geometry is None else int(geometry[1])
    if threads % band.WARP or not band.WARP <= threads <= band.MAX_PIPE_THREADS:
        raise ValueError(f"threads must be a multiple of {band.WARP} in "
                         f"{band.WARP}..{band.MAX_PIPE_THREADS}, got {threads}")
    if geometry is None:
        fits = n[n <= band.WARP * max_k]
        k = 1
        while fits.size and band.WARP * k < fits.max():
            k *= 2
    else:
        k = int(geometry[0])
        if k not in band.KS or k > max_k:
            raise ValueError(f"rows a lane must be one of {band.KS} up to {max_k}, got {k}")
    short = n <= band.WARP * k
    long_ = np.flatnonzero(~short)
    order = np.concatenate([long_[np.argsort(-(m + n)[long_], kind="stable")],
                            np.flatnonzero(short)])
    longs = long_.size
    lm, strips = m[order[:longs]], -(-n[order[:longs]] // (LONG_K * threads))
    first = np.concatenate([[0], np.cumsum(strips)])
    warps = threads // band.WARP
    shorts = m.size - longs
    tickets = int(first[-1]) + -(-shorts // warps)
    blocks = (min(tickets, band.SMS * band.BLOCKS_PER_SM) if geometry is None or len(geometry) < 3
              else int(geometry[2]))
    if blocks < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    if first[-1] + blocks > 2**31 - 1 or shorts + blocks * warps > 2**31 - 1:
        raise ValueError(f"{first[-1]} strips and {shorts} short pairs over {blocks} blocks "
                         f"pass the int32 tickets")
    row = (2 if affine else 1) * (lm + 1)  # int32 a ring row
    want = np.where(strips >= 2, np.minimum(strips, blocks + 1), 0)
    budget = band.RING_BUDGET if budget is None else int(budget)

    def ring_bytes(cap: int) -> int:  # the rings' bytes at most cap rows deep
        return 4 * int((np.minimum(want, cap) * row).sum())

    cap = int(want.max(initial=0))
    if ring_bytes(cap) > budget:
        if ring_bytes(2) > budget:
            raise torch.OutOfMemoryError(
                f"rings of 2 rows for {int((want > 0).sum())} pairs take {ring_bytes(2)} bytes, "
                f"past the budget of {budget} bytes of device memory")
        lo, hi = 2, cap  # the deepest cap that fits
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if ring_bytes(mid) <= budget else (lo, mid - 1)
        cap = lo
    depth = np.minimum(want, cap)
    sizes = depth * row
    return BatchPlan(k, threads, blocks, order, longs, first, depth, np.cumsum(sizes) - sizes,
                     int(sizes.sum()))


def batch_fill(pairs: Pairs, cfg: ScoringConfig, ends,
               geometry: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Every pair's result under the band kernel's contract (``(P,)`` int64
    on the pairs' device, ``ends`` the flags of every pair): the CUDA kernel
    ``band_batch_fill`` for CUDA tensors, short pairs a warp each and long
    pairs' strips on the pipeline (:func:`batch_plan`);
    :func:`tpualign_torch.ops.xla.score_batch` for CPU tensors.

    ``geometry``: :func:`batch_plan`'s, with ``k`` at most
    :func:`band.max_k`; it never changes the result.  On CUDA the wrapper
    reads the pairs' lengths back for the plan, allocates the output, then
    the rings (within :func:`band.ring_budget`: ``torch.OutOfMemoryError``
    past it) and the flags, launches on the current stream without
    synchronising, counts the launch in ``launch.band_batch_fill`` and
    keeps its plan in ``batch_fill.last_plan``.  A launch the device refuses
    raises; nothing falls back to the plain version."""
    _check_pairs(pairs)
    dev = pairs.texts.device
    if dev.type == "cpu":
        return xla.score_batch(pairs, cfg, ends)
    if dev.type != "cuda":
        raise ValueError(f"batch_fill runs on cpu or cuda tensors, got {dev}")
    with trace.span("read_back"):
        m, n = pairs.lengths.cpu().numpy()
    P = m.size
    with trace.span("plan"):
        # only a query past one strip of the smallest block takes a ring
        # (the free memory costs a call into CUDA)
        budget = band.ring_budget(dev) if pairs.n_cap > LONG_K * band.WARP else None
        plan = batch_plan(m, n, cfg.is_affine, band.max_k(cfg), geometry, budget)
    lib = _build.load()
    K = len(cfg.matrix) if cfg.has_matrix else 0
    matrix = band._matrix(cfg, dev)
    with trace.span("to_device"):
        sched = torch.from_numpy(plan.sched).to(dev)
    with trace.span("alloc"):
        out = torch.full((P,), 0 if cfg.is_local else band.NEG, dtype=torch.int32, device=dev)
        ring = torch.empty(plan.ring, dtype=torch.int32, device=dev) if plan.ring else None
        sync = torch.zeros(2 + plan.strips, dtype=torch.int32, device=dev)
    trace.count_bytes("alloc_bytes", out, ring, sync)
    off, lens = pairs.offsets, pairs.lengths
    with trace.span("launch.band_batch_fill"), torch.cuda.device(dev):
        err = lib.band_batch_fill(
            pairs.texts.data_ptr(), pairs.queries.data_ptr(), off[0].data_ptr(),
            off[1].data_ptr(), lens[0].data_ptr(), lens[1].data_ptr(), P, matrix.data_ptr(), K,
            cfg.match, cfg.mismatch, cfg.gap, cfg.gap_open or 0, cfg.gap_extend or 0,
            band._flags(cfg, ends), plan.k, plan.threads, plan.blocks, sched.data_ptr(),
            plan.longs, plan.strips, band._ptr(ring), sync.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"band_batch_fill launch failed with CUDA error {err}")
    trace.count("launch.band_batch_fill")
    batch_fill.last_plan = plan
    return out.long()


batch_fill.last_plan = None


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
    with trace.span("to_device"):
        pairs = pairs.to(dev)
    raw = batch_fill(pairs, cfg, band._ends_flags(cfg, False))
    with trace.span("read_back"):
        raw = raw.cpu().numpy()
    floor = floors(cfg, m[live], n[live])
    out[live] = raw if floor is None else np.maximum(raw, floor)
    return out
