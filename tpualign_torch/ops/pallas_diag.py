"""Flat anti-diagonal score in PyTorch and CUDA: the port of
``tpualign/ops/pallas_diag.py:score`` (the ``impl="pallas"`` engine, and the
one ``bitpal`` falls back to).  It holds no Pallas; the module keeps its
counterpart's name so that a reader finds one from the other.

Pair scoring, linear gaps, global (Needleman-Wunsch) or local
(Smith-Waterman), as ``tpualign``'s kernel.  Its contract, shared by
:func:`diag_fill` and :func:`score_plain`: ``s1`` (m,) int8 across the
columns, ``s2`` (n,) int8 down the rows, ``n <= m``; the result is
``H(n, m)`` (global) or the max over every cell and 0 (local).  Neither
depends on the order the cells are filled in, so the kernel
(``csrc/diag_fill.cu``, K8's port) runs the row strips of the band fills
(``csrc/band_fill.cuh``'s pipeline over many thread blocks,
:func:`tpualign_torch.ops.band.pipeline_plan`), ``s1`` the strips' text
and ``s2`` their query; the TPU kernel's VMEM cap (``MAX_DIAG_ELEMS``) and
its rolled, staged window of ``s1`` have no counterpart.

The checkpointed fill (``csrc/diag_ckpt.cu``, K9's port, the forward pass
of :func:`tpualign_torch.ops.traceback_diag.align_diag`) keeps the
diagonals ``cK`` and ``cK - 1`` for ``c < groups = ceil((n + m) / K)`` of
the table of ``s1`` (columns) against ``s2`` (rows, the diagonal axis, no
swap, either sequence the longer), and under local scoring each row's
maximum and the diagonal that first reached it.  Its values do not depend
on the order the cells are filled in, so the kernel runs the row strips of
the band fills (``csrc/band_fill.cuh``'s pipeline over many thread
blocks, :func:`tpualign_torch.ops.band.pipeline_plan`), each row's owner
storing the row's checkpoint cells.  Its contract, shared by
:func:`ckpt_fill` and :func:`ckpt_plain`, is in :func:`ckpt_plain`'s
docstring.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import _build, trace
from ..config import ScoringConfig, ensure_pair_modes
from . import band, xla
from .bitpal import _device
from .pairs import int8_codes

#: the checkpoints' value on slots outside the table (``tpualign``'s
#: ``pallas_diag.NEG_INF``)
NEG_INF = xla.CK_NEG
#: checkpoint strides are multiples of this (``tpualign``'s unroll)
UNROLL = 8
#: the diagonal axis's cap, ``tpualign.ops.pallas_diag.MAX_DIAG_ELEMS``:
#: the TPU kernel's VMEM budget, kept for the checkpointed fill because
#: its checkpoints grow as n (n + m) / K and because past it ``align``
#: goes on to the checkpointed row-scan traceback, as ``tpualign``'s does
MAX_DIAG_ELEMS = 1024 * 1024


def _check_cfg(cfg: ScoringConfig, total: int) -> None:
    """ValueError for what ``tpualign.ops.pallas_diag._check_cfg`` refuses:
    affine gaps, a positive global gap, and scores past the int32
    headroom."""
    if cfg.is_affine:
        raise ValueError(
            "affine gaps are outside the flat wavefront kernel's envelope; "
            "use impl='xla' (or 'oracle')")
    if not cfg.is_local and cfg.gap > 0:
        raise ValueError("global diagonal kernel requires gap <= 0; use impl='xla'")
    drift = total * max(abs(cfg.gap), abs(cfg.match), abs(cfg.mismatch), 1)
    if drift > 2**29:
        raise ValueError("scoring magnitudes too large for int32 headroom")


def _check_fill_args(s1: torch.Tensor, s2: torch.Tensor) -> None:
    xla.check_pair(s1, s2, ("s1", "s2"))
    if s2.numel() > s1.numel():
        raise ValueError("s2 (the diagonal axis) must be the shorter sequence")


def score_plain(s1: torch.Tensor, s2: torch.Tensor, cfg: ScoringConfig) -> torch.Tensor:
    """Plain PyTorch version of the diagonal kernel (module docstring) by
    the row scan of :func:`tpualign_torch.ops.xla.rows_scan`, as a 0-d
    int64 tensor on the tensors' device."""
    _check_fill_args(s1, s2)
    local = cfg.is_local
    h, best = xla.rows_scan(s1, s2, cfg, zero_row=local, zero_col=local,
                            want_best=local)[:2]
    return best.clamp(min=0) if local else h[-1]


def diag_fill(s1: torch.Tensor, s2: torch.Tensor, cfg: ScoringConfig,
              geometry=None) -> torch.Tensor:
    """The diagonal kernel's result on the device of its tensors: the CUDA
    kernel ``diag_fill`` (``csrc/diag_fill.cu``) for CUDA tensors,
    :func:`score_plain` for CPU tensors; a 0-d int64 tensor.

    ``geometry``: ``(k, threads)`` or ``(k, threads, blocks)`` of the strip
    pipeline (:func:`tpualign_torch.ops.band.pipeline_plan`), default
    :func:`tpualign_torch.ops.band.pipeline_geometry`; it never changes the
    result.  On CUDA the wrapper allocates the output, seeded with the
    max's identity, then the ring (within
    :func:`tpualign_torch.ops.band.ring_budget`: a ring past it raises
    ValueError) and the flags, launches on the current stream without
    synchronising, counts the launch in ``launch.diag_fill`` and keeps its
    plan in ``diag_fill.last_plan``.  A launch the device refuses raises;
    nothing falls back to the plain version."""
    _check_fill_args(s1, s2)
    if s1.device.type == "cpu":
        return score_plain(s1, s2, cfg)
    if s1.device.type != "cuda":
        raise ValueError(f"diag_fill runs on cpu or cuda tensors, got {s1.device}")
    m, n = s1.numel(), s2.numel()
    dev = s1.device
    lib = _build.load()
    with trace.span("alloc"):
        out = torch.full((1,), 0 if cfg.is_local else band.NEG, dtype=torch.int32, device=dev)
    trace.count_bytes("alloc_bytes", out)
    # K8's rows (s2) are the strips' query, its columns (s1) their text
    plan = band._plan(n, m, False, geometry, band.MAX_K, dev)
    ring, sync, _ = band._pipe_scratch(plan, m, False, dev, False)
    with trace.span("launch.diag_fill"), torch.cuda.device(dev):
        err = lib.diag_fill(
            s1.data_ptr(), m, s2.data_ptr(), n, cfg.match, cfg.mismatch, cfg.gap,
            int(cfg.is_local), plan.k, plan.threads, plan.blocks, band._ptr(ring), plan.depth,
            sync.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"diag_fill launch failed with CUDA error {err}")
    trace.count("launch.diag_fill")
    diag_fill.last_plan = plan
    return out[0].long()


diag_fill.last_plan = None


def score(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, device) -> int:
    """NW or SW score of two code sequences on ``device`` (``"cuda"`` runs
    the kernel, ``"cpu"`` the plain version); the counterpart of
    ``tpualign.ops.pallas_diag.score``.  The shorter sequence goes on the
    diagonal axis (the score is symmetric under the swap)."""
    with trace.span("check"):
        a, b = int8_codes(s1), int8_codes(s2)
    ensure_pair_modes(cfg, "pallas_diag")
    dev = _device(device)
    if a.size == 0 or b.size == 0:
        return 0 if cfg.is_local else cfg.gap * (a.size + b.size)
    _check_cfg(cfg, a.size + b.size)
    if b.size > a.size:
        a, b = b, a
    with trace.span("to_device"):
        d1, d2 = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    res = diag_fill(d1, d2, cfg)
    with trace.span("read_back"):
        return int(res)


class Checkpoints(NamedTuple):
    """The checkpointed fill's outputs (:func:`ckpt_plain`)."""

    cka: torch.Tensor  # (groups, n+1) int32: diagonal cK
    ckb: torch.Tensor  # (groups, n+1) int32: diagonal cK - 1
    v: Optional[torch.Tensor]  # (n+1,) int32, local: each row's max, floored at 0
    dbest: Optional[torch.Tensor]  # (n+1,) int32, local: the diagonal that first reached it


def _check_ckpt_args(s1: torch.Tensor, s2: torch.Tensor, K: int) -> None:
    xla.check_pair(s1, s2, ("s1", "s2"))
    if K < UNROLL or K % UNROLL:
        raise ValueError(f"the checkpoint stride must be a positive multiple of {UNROLL}, "
                         f"got {K}")


def ckpt_plain(s1: torch.Tensor, s2: torch.Tensor, cfg: ScoringConfig, K: int) -> Checkpoints:
    """Plain PyTorch version of the checkpointed diagonal kernel, on the
    tensors' device: ``s1`` (m,) int8 across the columns, ``s2`` (n,) int8
    down the rows (the diagonal axis), stride ``K`` (a multiple of 8).

    ``cka[c][k] = H(k, cK - k)`` and ``ckb[c][k] = H(k, cK - 1 - k)`` for
    ``c < groups = ceil((n + m) / K)``, ``NEG_INF`` on slots outside the
    table (row 0: diagonal 0, whose one cell is H(0, 0) = 0, and diagonal
    -1, all ``NEG_INF``).  Under local scoring ``v[k]`` is the max over row
    k's cells with j >= 1, floored at 0, and ``dbest[k]`` the first
    diagonal k + j at which it was strictly reached, or 0 (the TPU
    kernel's ``improved = masked > v``).  One row scan
    (:func:`tpualign_torch.ops.xla.rows_scan`) gathers each row's cells on
    the checkpoint diagonals and its first maximum."""
    _check_ckpt_args(s1, s2, K)
    local = cfg.is_local
    scan = xla.rows_scan(s1, s2, cfg, zero_row=local, zero_col=local,
                         want_row_max=local, diag_stride=K)
    cka, ckb = scan.ck.int()
    if not local:
        return Checkpoints(cka, ckb, None, None)
    row_max, row_arg = scan.row_max
    reached = row_max > 0
    zero = row_max.new_zeros(1)
    v = torch.cat([zero, torch.where(reached, row_max, 0)]).int()
    rows = torch.arange(1, s2.numel() + 1, dtype=torch.int64, device=s2.device)
    dbest = torch.cat([zero, torch.where(reached, rows + row_arg, 0)]).int()
    return Checkpoints(cka, ckb, v, dbest)


def ckpt_fill(s1: torch.Tensor, s2: torch.Tensor, cfg: ScoringConfig, K: int,
              geometry=None) -> Checkpoints:
    """The checkpointed kernel's outputs (:func:`ckpt_plain`) on the device
    of its tensors: the CUDA kernel ``diag_ckpt_fill``
    (``csrc/diag_ckpt.cu``) for CUDA tensors, :func:`ckpt_plain` for CPU
    tensors.

    ``geometry``: ``(k, threads)`` or ``(k, threads, blocks)`` of the strip
    pipeline (:func:`tpualign_torch.ops.band.pipeline_plan`), default
    :func:`tpualign_torch.ops.band.pipeline_geometry`; it never changes the
    result.  On CUDA the wrapper allocates the outputs, then the ring
    (within :func:`tpualign_torch.ops.band.ring_budget`) and the flags,
    launches on the current stream without synchronising, and counts the
    launch in ``launch.diag_ckpt_fill``.  A launch the device refuses raises;
    nothing falls back to the plain version."""
    _check_ckpt_args(s1, s2, K)
    if s1.device.type == "cpu":
        return ckpt_plain(s1, s2, cfg, K)
    if s1.device.type != "cuda":
        raise ValueError(f"ckpt_fill runs on cpu or cuda tensors, got {s1.device}")
    m, n = s1.numel(), s2.numel()
    groups = -(-(n + m) // K)
    dev = s1.device
    lib = _build.load()
    with trace.span("alloc"):
        ck = torch.empty((2, groups, n + 1), dtype=torch.int32, device=dev)
        best = torch.empty((2, n + 1), dtype=torch.int32, device=dev) if cfg.is_local else None
    trace.count_bytes("alloc_bytes", ck, best)
    # K9's rows (s2) are the strips' query, its columns (s1) their text
    plan = band._plan(n, m, False, geometry, band.MAX_K, dev)
    ring, sync, _ = band._pipe_scratch(plan, m, False, dev, False)
    v, dbest = (None, None) if best is None else (best[0].data_ptr(), best[1].data_ptr())
    with trace.span("launch.diag_ckpt_fill"), torch.cuda.device(dev):
        err = lib.diag_ckpt_fill(
            s1.data_ptr(), m, s2.data_ptr(), n, cfg.match, cfg.mismatch, cfg.gap,
            int(cfg.is_local), K, plan.k, plan.threads, plan.blocks, band._ptr(ring),
            plan.depth, sync.data_ptr(), ck[0].data_ptr(), ck[1].data_ptr(), v, dbest,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"diag_ckpt_fill launch failed with CUDA error {err}")
    trace.count("launch.diag_ckpt_fill")
    if cfg.is_local:
        return Checkpoints(ck[0], ck[1], best[0], best[1])
    return Checkpoints(ck[0], ck[1], None, None)


def ckpt_stride(k_stride: int) -> int:
    """``tpualign.ops.traceback_diag.align_diag``'s stride rule: clamped to
    ``[UNROLL, 2^20]``, rounded up to a multiple of ``UNROLL``."""
    k = max(UNROLL, min(int(k_stride), 1 << 20))
    return -(-k // UNROLL) * UNROLL


def forward_checkpoints(s1, s2, cfg: ScoringConfig = ScoringConfig(), *,
                        k_stride: int = 1024, device) -> Checkpoints:
    """The checkpointed fill of two non-empty code sequences on ``device``
    (``"cuda"`` runs the kernel, ``"cpu"`` the plain version), ``s1``
    across the columns and ``s2`` down the rows, no swap; the counterpart
    of ``tpualign.ops.pallas_diag.forward_checkpoints``, with its refusals
    (ValueError): matrix and ends-free configs, affine gaps, a positive
    global gap, scores past the int32 headroom and ``len(s2) + 2 >
    MAX_DIAG_ELEMS``.  ``k_stride`` rounds up to a multiple of ``UNROLL``;
    the outputs stay on the device (:func:`ckpt_plain`)."""
    a, b = int8_codes(s1), int8_codes(s2)
    ensure_pair_modes(cfg, "pallas_diag")
    if b.size + 2 > MAX_DIAG_ELEMS:
        raise ValueError("s2 too long for the diagonal kernel's checkpoints "
                         f"({b.size} > {MAX_DIAG_ELEMS - 2})")
    _check_cfg(cfg, a.size + b.size)
    dev = _device(device)
    K = -(-int(k_stride) // UNROLL) * UNROLL
    with trace.span("to_device"):
        d1, d2 = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    return ckpt_fill(d1, d2, cfg, K)
