"""General-scoring fills in row strips, in PyTorch and CUDA: the port of
``tpualign/ops/band.py`` (``score_fn``, ``_band_call``) and of the strip
kernel under ``tpualign/ops/band_align.py`` (``_strip_call``).

Any ``ScoringConfig``: linear or affine (Gotoh) gaps, pair scoring or a
substitution matrix of up to 16 codes, global, local (Smith-Waterman),
semiglobal and infix modes.  The kernel (``csrc/band_fill.cu``, K6's port)
fills the table in strips of ``R = k * threads`` rows, each thread owning
``k`` consecutive rows, over many thread blocks of one launch: the blocks
take strips in order from a ticket and hand each strip's bottom row
``H(i0, 0..m)`` (plus the F row under affine gaps) down through a ring of
rows in global memory with progress flags, so the strips run side by side,
each a column-skew behind the one above (:func:`pipeline_geometry`,
:func:`pipeline_plan`).  The score fill (:func:`band_fill`) computes a tile
of ``k`` rows by ``TILE_W[k]`` columns a thread a step (:func:`tile_geometry`,
:func:`score_plan`, :func:`tile_steps`).  Its contract, shared by
:func:`band_fill` and :func:`score_plain`:

- ``text`` (m,) int8 runs across the columns, ``query`` (n,) int8 down the
  rows; ``cfg`` is the config in kernel coordinates (its matrix transposed
  when the orientation swaps) and ``ends`` the kernel-coordinate flags
  ``(zr, zc, er, ec)`` of :func:`_ends_flags`;
- the result is one int: local, the max over every cell with
  ``1 <= j <= m`` (and 0); with ``er`` and/or ``ec``, the max over row n
  (``j`` in 1..m) and/or column m (``i`` in 1..n); otherwise ``H(n, m)``.

The capture kernel (``band_capture_fill``, K7's port, one more flag of
the same template, so the two cannot drift apart) runs the same fill under
linear gaps and returns in place of the score the rows that the alignment
paths read: chosen DP rows, the last row and column, and the row-major
first maximum cell (:func:`capture_fill`, :func:`capture_plain`).

The host adds the closed-form boundary cells H(n, 0) and H(0, m)
(:func:`score_fn`).  What the TPU kernel carries for its own sake is gone:
the SMEM boundary caps and the orientation rule built on them, the float32
value path, the 4-bit text pack, the column-major strip layout, the 2-step
stagger, the pend rings and the sentinel pad codes.  Values are int32; the
int32 headroom rule of ``_check_cfg`` stays.  Masked and unmasked local
scoring are one path, so positive-mismatch local affine configs, which the
TPU kernel refuses, run here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build, trace
from ..config import ScoringConfig
from . import xla
from .bitpal import _device
from .pairs import int8_codes

#: kernel geometry: blocks of up to MAX_PIPE_THREADS threads (a multiple of
#: WARP), each thread owning k consecutive rows of a strip, k a power of two
#: up to MAX_K (registers per thread); MAX_THREADS bounds the one-block
#: geometry of :func:`kernel_geometry`; local affine gaps carry E and the
#: masked running max beside H and spill 208-220 bytes at 16 rows a thread
#: in 1,024-thread blocks, which made them slower there than at 8 on the
#: H100 (PERF.md), so their captures stop at MAX_K_LOCAL_AFFINE
MAX_THREADS = 1024
MAX_PIPE_THREADS = 256
MAX_K = 16
MAX_K_LOCAL_AFFINE = 8
WARP = 32
KS = (1, 2, 4, 8, 16)

#: the pipeline's planner: the H100's SMs, PIPE_THREADS threads a block,
#: at most BLOCKS_PER_SM blocks an SM in flight, PUBLISH columns between two
#: progress flags (kPublish in csrc/band_fill.cuh), STEP_OVERHEAD a step's
#: fixed cost in rows' work (a step took about 340 + 8.25 k ns for k rows a
#: thread on the H100 in the strip body the other fills keep, measured by
#: tools/sweep_band_pipeline.py before K6's tile), the ring's
#: RING_BUDGET bytes when no budget is given (the CUDA wrappers give
#: ring_budget()'s, from the card's free memory)
SMS = 132
PIPE_THREADS = 128
BLOCKS_PER_SM = 4
PUBLISH = 32
STEP_OVERHEAD = 41
RING_BUDGET = 1 << 30

#: K6's tiled fill (band_fill_kernel's tile_strip in csrc/band_fill.cuh): a
#: step computes TILE_W[k] columns of a thread's k rows (the kernel's
#: tile_w), and costs about TILE_STEP_NS ns plus TILE_CELL_NS a cell of the
#: tile on the H100 (PERF.md); :func:`tile_geometry` weighs TILE_THREADS
TILE_W = {1: 4, 2: 4, 4: 4, 8: 8, 16: 8}
TILE_STEP_NS = 455.0
TILE_CELL_NS = 6.5
TILE_THREADS = (32, 64, 128, 256)

#: flag bits of the kernel's ``flags`` argument
LOCAL, AFFINE, ZERO_ROW, ZERO_COL, END_ROW, END_COL = 1, 2, 4, 8, 16, 32
#: the kernels' minus infinity (kNeg)
NEG = -(1 << 30)


def kernel_geometry(n: int, max_k: int = MAX_K) -> Tuple[int, int]:
    """``(k, threads)`` of one block walking ``n`` rows in strips, for a
    batch kernel that runs a block a pair (``tools/ab_band_fill.py`` times
    such a version of ``band_batch.cu``): as few strips as the block allows
    (each at most ``MAX_THREADS * max_k`` rows), cut evenly, then the
    fewest rows per thread that fit, threads rounded up to whole warps."""
    n_strips = -(-n // (MAX_THREADS * max_k))
    rows = -(-n // n_strips)
    k = 1
    while k * MAX_THREADS < rows:
        k *= 2
    warps = -(-rows // (k * WARP))
    return k, warps * WARP


def strips(n: int, k: int, threads: int) -> int:
    """The pipeline's strip count ``S = ceil(n / (k * threads))``."""
    return -(-n // (k * threads))


def pipeline_geometry(n: int, m: int, max_k: int = MAX_K) -> Tuple[int, int, int]:
    """``(k, threads, blocks)`` of the pipelined fill of ``n`` rows and ``m``
    columns.  ``threads`` is PIPE_THREADS, fewer (whole warps) when one strip
    holds every row.  For each ``k`` up to ``max_k`` the cost model counts
    the steps, ``ceil(S/G) * (m + T) + (G - 1) * (T + 2 * PUBLISH)`` for S
    strips over G = min(S, SMS * BLOCKS_PER_SM) blocks (each strip starts
    about T + 2 * PUBLISH columns behind the one above; a block walks
    ceil(S/G) strips), times a step's cost, ``STEP_OVERHEAD + k *
    ceil(G / SMS)`` rows' work (blocks that share an SM share its issue);
    the cheapest ``k`` wins, the larger on a tie.  On the H100 this picks
    k = 8 and 128 threads for SW at 20,000 x 20,000 and at the 64gb shape,
    the fastest of the 20 and 19 geometries swept there."""
    best = None
    for k in KS:
        if k > max_k:
            break
        rows = -(-n // k)
        T = min(PIPE_THREADS, WARP * -(-rows // WARP))
        S = strips(n, k, T)
        G = min(S, SMS * BLOCKS_PER_SM)
        steps = -(-S // G) * (m + T) + (G - 1) * (T + 2 * PUBLISH)
        cost = steps * (STEP_OVERHEAD + k * -(-G // SMS))
        if best is None or cost <= best[0]:
            best = (cost, (k, T, G))
    return best[1]


def tile_steps(n: int, m: int, k: int, threads: int, blocks: int) -> int:
    """The tiled fill's steps: ``ceil(S/G) * (ceil(m/W) + T) + (G - 1) * (T
    + 2 * PUBLISH / W)`` for S strips of ``k * threads`` rows over G =
    min(S, ``blocks``) blocks, W = TILE_W[k] (each strip starts about T + 2
    * PUBLISH / W steps behind the one above; a block walks ceil(S/G)
    strips)."""
    W = TILE_W[k]
    S = strips(n, k, threads)
    G = min(S, blocks)
    return -(-S // G) * (-(-m // W) + threads) + (G - 1) * (threads + 2 * PUBLISH // W)


def tile_geometry(n: int, m: int, max_k: int = MAX_K) -> Tuple[int, int, int]:
    """``(k, threads, blocks)`` of K6's tiled fill (:func:`band_fill`) of
    ``n`` rows and ``m`` columns.  For each ``k`` up to ``max_k`` and each
    of TILE_THREADS (fewer, whole warps, when one strip holds every row),
    with G = min(S, SMS * BLOCKS_PER_SM) blocks, the cost model is
    :func:`tile_steps` times a step's cost, ``TILE_STEP_NS + TILE_CELL_NS *
    k * W * share``, where ``share`` is the warps that one of an SM's 4
    schedulers issues for (the blocks spread evenly over the SMS SMs); the
    cheapest wins, the larger ``k``, then the more threads, on a tie."""
    best = None
    for k in KS:
        if k > max_k:
            break
        rows = -(-n // k)
        for T in TILE_THREADS:
            T = min(T, WARP * -(-rows // WARP))
            S = strips(n, k, T)
            G = min(S, SMS * BLOCKS_PER_SM)
            share = -(-(-(-G // SMS) * T // WARP) // 4)
            cost = tile_steps(n, m, k, T, G) * (TILE_STEP_NS + TILE_CELL_NS * k * TILE_W[k] * share)
            if best is None or cost <= best[0]:
                best = (cost, (k, T, G))
    return best[1]


class PipePlan(NamedTuple):
    """One pipelined launch: ``strips`` strips of ``k * threads`` rows over
    ``blocks`` blocks, a ring of ``depth`` rows (0 with one strip)."""

    k: int
    threads: int
    blocks: int
    strips: int
    depth: int


def pipeline_plan(n: int, m: int, affine: bool, geometry=None, max_k: int = MAX_K,
                  budget: Optional[int] = None) -> PipePlan:
    """The launch of a pipelined fill of ``n`` rows and ``m`` columns:
    ``geometry`` is ``(k, threads)`` or ``(k, threads, blocks)``, default
    :func:`pipeline_geometry`; ``blocks`` defaults to ``min(S, SMS *
    BLOCKS_PER_SM)``.  The ring holds ``min(S, blocks + 1)`` rows (a block
    reads the row above while the strips of the other blocks are in
    flight), fewer if its ``m + 1`` int32 of H (and F under affine gaps) a
    row pass ``budget`` bytes (default RING_BUDGET; the CUDA wrappers pass
    :func:`ring_budget`), never fewer than 2 when ``S >= 2``.  ValueError
    for a geometry the kernel refuses, or when 2 rows do not fit the
    budget: on the card, a fill that does not fit its memory."""
    if geometry is None:
        geometry = pipeline_geometry(n, m, max_k)
    if len(geometry) not in (2, 3):
        raise ValueError(f"geometry is (k, threads) or (k, threads, blocks), got {geometry}")
    k, threads = int(geometry[0]), int(geometry[1])
    if k not in KS:
        raise ValueError(f"rows per thread must be one of {KS}, got {k}")
    if threads % WARP or not WARP <= threads <= MAX_PIPE_THREADS:
        raise ValueError(f"threads must be a multiple of {WARP} in {WARP}..{MAX_PIPE_THREADS}, "
                         f"got {threads}")
    S = strips(n, k, threads)
    blocks = int(geometry[2]) if len(geometry) == 3 else min(S, SMS * BLOCKS_PER_SM)
    if blocks < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    if S == 1:
        return PipePlan(k, threads, blocks, S, 0)
    budget = RING_BUDGET if budget is None else int(budget)
    row_bytes = 4 * (2 if affine else 1) * (m + 1)
    depth = min(S, blocks + 1, budget // row_bytes)
    if depth < 2:
        raise ValueError(f"a ring of 2 rows of {m + 1} columns takes {2 * row_bytes} bytes, "
                         f"past the budget of {budget} bytes of device memory")
    return PipePlan(k, threads, blocks, S, depth)


def score_plan(n: int, m: int, affine: bool, geometry=None, max_k: int = MAX_K,
               budget: Optional[int] = None) -> PipePlan:
    """:func:`pipeline_plan` of K6's tiled fill (:func:`band_fill`):
    ``geometry`` by default :func:`tile_geometry`'s."""
    if geometry is None:
        geometry = tile_geometry(n, m, max_k)
    return pipeline_plan(n, m, affine, geometry, max_k, budget)


#: the share of a card's free memory that a fill's ring may take (the CUDA
#: wrappers plan after allocating the fill's outputs): half, since the ring
#: is one allocation that the caching allocator rounds up and must find in
#: one piece, and the caller's next tensors (a traceback's copies, the next
#: fill's outputs) need room beside it
RING_SHARE = 0.5


def ring_budget(device=None, free_bytes: Optional[int] = None) -> int:
    """The ring's budget in bytes on a CUDA device: RING_SHARE of its free
    bytes, ``free_bytes`` where given, else ``torch.cuda.mem_get_info``'s
    free bytes plus what PyTorch's caching allocator holds and does not
    use (it hands that out first).  On an 80 GB card a ring of 2 rows fits
    every pair inside the int32 headroom (2^29 columns, 4.3 GB; 8.6 GB
    affine)."""
    if free_bytes is None:
        trace.count("free_memory")
        with trace.span("free_memory"):
            free_bytes = (torch.cuda.mem_get_info(device)[0]
                          + torch.cuda.memory_reserved(device)
                          - torch.cuda.memory_allocated(device))
    return int(free_bytes * RING_SHARE)


def _pipe_scratch(plan: PipePlan, m: int, affine: bool, dev, cells: bool):
    """The ring, the zeroed ticket, done counter and progress flags, and,
    for a located cell, each block's cell (the span ``alloc``)."""
    with trace.span("alloc"):
        ring = (torch.empty((plan.depth, 2 if affine else 1, m + 1), dtype=torch.int32,
                            device=dev) if plan.depth else None)
        sync = torch.zeros(plan.strips + 2, dtype=torch.int32, device=dev)
        block_cells = (torch.empty((plan.blocks, 3), dtype=torch.int32, device=dev)
                       if cells else None)
    trace.count_bytes("alloc_bytes", ring, sync, block_cells)
    return ring, sync, block_cells


def _plan(n: int, m: int, affine: bool, geometry, most_k: int, dev,
          tiled: bool = False) -> PipePlan:
    """:func:`pipeline_plan`, or where ``tiled`` (K6's fill)
    :func:`score_plan`, within :func:`ring_budget` of ``dev`` (the span
    ``plan``)."""
    with trace.span("plan"):
        return (score_plan if tiled else pipeline_plan)(n, m, affine, geometry, most_k,
                                                        ring_budget(dev))


def _matrix(cfg: ScoringConfig, dev) -> torch.Tensor:
    """The config's matrix, flat, as int32 on ``dev`` (``[0]`` without one;
    the span ``to_device``)."""
    with trace.span("to_device"):
        return torch.tensor(cfg.matrix if cfg.has_matrix else [0], dtype=torch.int32).to(dev)


def max_k(cfg: ScoringConfig) -> int:
    """The most rows a thread takes under ``cfg`` (see ``MAX_K``)."""
    return MAX_K_LOCAL_AFFINE if (cfg.is_affine and cfg.is_local) else MAX_K


def _wmax(cfg: ScoringConfig) -> int:
    """Largest per-step value change (the int32 headroom bound)."""
    if cfg.has_matrix:
        lo, hi = cfg.sub_bounds()
        sub_mag = max(abs(lo), abs(hi), 1)
    else:
        sub_mag = max(abs(cfg.match), abs(cfg.mismatch), 1)
    if cfg.is_affine:
        return max(sub_mag, abs(cfg.gap_open) + abs(cfg.gap_extend))
    return max(sub_mag, abs(cfg.gap))


def _ends_flags(cfg: ScoringConfig, swapped: bool):
    """Kernel-coordinate ends-free flags ``(zr, zc, er, ec)``.

    ``zr``: boundary row H(0, :) = 0; ``zc``: column H(:, 0) = 0; ``er``:
    score maxes over the last DP row; ``ec``: over the last column.
    Swapping the orientation transposes the table, exchanging row flags
    with column flags."""
    if not cfg.is_ends_free:
        return (False, False, False, False)
    zr, zc = cfg.free_start_s1, cfg.free_start_s2
    er, ec = cfg.free_end_s1, cfg.free_end_s2
    if swapped:
        zr, zc, er, ec = zc, zr, ec, er
    return (zr, zc, er, ec)


def _check_cfg(cfg: ScoringConfig, total: int) -> None:
    """ValueError past the int32 headroom, as ``tpualign.ops.band._check_cfg``.
    Its refusal of positive-mismatch local affine configs guards the TPU
    kernel's unmasked running max; this kernel's max covers live cells only,
    so it serves them."""
    if total * _wmax(cfg) > 2**29:
        raise ValueError("scoring magnitudes too large for int32 headroom")


def _empty_score(m: int, n: int, cfg: ScoringConfig) -> int:
    """Closed-form score when either sequence is empty."""
    if cfg.is_local or m + n == 0:
        return 0
    if cfg.is_ends_free:
        if n == 0:  # s1 runs against nothing: skippable iff an s1 end is free
            return 0 if (cfg.free_start_s1 or cfg.free_end_s1) else xla.gap_run(cfg, m)
        return 0 if (cfg.free_start_s2 or cfg.free_end_s2) else xla.gap_run(cfg, n)
    return xla.gap_run(cfg, m + n)


def _flags(cfg: ScoringConfig, ends) -> int:
    zr, zc, er, ec = ends
    return ((LOCAL if cfg.is_local else 0) | (AFFINE if cfg.is_affine else 0)
            | (ZERO_ROW if zr else 0) | (ZERO_COL if zc else 0)
            | (END_ROW if er else 0) | (END_COL if ec else 0))


def score_plain(text: torch.Tensor, query: torch.Tensor, cfg: ScoringConfig,
                ends) -> torch.Tensor:
    """Plain PyTorch version of the band kernel: its arguments and result
    (module docstring) by the row scan of :func:`tpualign_torch.ops.xla.rows_scan`,
    as a 0-d int64 tensor on the tensors' device."""
    xla.check_pair(text, query, ("text", "query"))
    zr, zc, er, ec = ends
    local = cfg.is_local
    h, best, col = xla.rows_scan(
        text, query, cfg, zero_row=local or zr, zero_col=local or zc,
        want_best=local, want_col=ec and not local,
    )[:3]
    if local:
        return best.clamp(min=0)
    if er or ec:
        parts = ([h[1:].max()] if er else []) + ([col.max()] if ec else [])
        return torch.stack(parts).max()
    return h[-1]


def band_fill(text: torch.Tensor, query: torch.Tensor, cfg: ScoringConfig,
              ends, geometry: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """The band kernel's result (module docstring) on the device of its
    tensors: the CUDA kernel ``band_fill`` (``csrc/band_fill.cu``) for CUDA
    tensors, :func:`score_plain` for CPU tensors; a 0-d int64 tensor.

    ``geometry``: ``(k, threads)`` or ``(k, threads, blocks)``: rows per
    thread (1, 2, 4, 8 or 16), threads (a multiple of 32 up to 256) and
    blocks (:func:`pipeline_plan`); default :func:`tile_geometry` with
    ``k`` at most :func:`max_k`.  It sets the strip height ``k * threads``
    and the blocks that run the strips, never the result; ``blocks=1`` is
    the single-block schedule.  On CUDA the wrapper allocates the output,
    then the ring (within :func:`ring_budget`) and the flags, launches on
    the current stream without synchronising, and counts the launch in the
    counter ``launch.band_fill`` (:mod:`tpualign_torch.trace`) and the
    plan's :func:`tile_steps` in ``band_fill.steps``.  A launch the device
    refuses raises; nothing falls back to the plain version or to fewer
    blocks."""
    xla.check_pair(text, query, ("text", "query"))
    if text.device.type == "cpu":
        return score_plain(text, query, cfg, ends)
    if text.device.type != "cuda":
        raise ValueError(f"band_fill runs on cpu or cuda tensors, got {text.device}")
    m, n = text.numel(), query.numel()
    dev = text.device
    lib = _build.load()
    K = len(cfg.matrix) if cfg.has_matrix else 0
    matrix = _matrix(cfg, dev)
    with trace.span("alloc"):  # the identity of the blocks' max
        out = torch.full((1,), 0 if cfg.is_local else NEG, dtype=torch.int32, device=dev)
    trace.count_bytes("alloc_bytes", out)
    plan = _plan(n, m, cfg.is_affine, geometry, max_k(cfg), dev, tiled=True)
    ring, sync, _ = _pipe_scratch(plan, m, cfg.is_affine, dev, False)
    with trace.span("launch.band_fill"), torch.cuda.device(dev):
        err = lib.band_fill(
            text.data_ptr(), m, query.data_ptr(), n, matrix.data_ptr(), K,
            cfg.match, cfg.mismatch, cfg.gap, cfg.gap_open or 0,
            cfg.gap_extend or 0, _flags(cfg, ends), plan.k, plan.threads, plan.blocks,
            _ptr(ring), plan.depth, sync.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"band_fill launch failed with CUDA error {err}")
    trace.count("launch.band_fill")
    trace.count("band_fill.steps", tile_steps(n, m, plan.k, plan.threads, plan.blocks))
    return out[0].long()


class Capture(NamedTuple):
    """What :func:`capture_fill` and :func:`capture_plain` return: int32
    tensors on the device of their inputs, None where not asked for."""

    row: torch.Tensor  # (m+1,): the last row H(n, 0..m)
    caps: Optional[torch.Tensor]  # (J, m+1): H(rows[s], 0..m)
    col: Optional[torch.Tensor]  # (n+1,): the last column H(0..n, m)
    cell: Optional[torch.Tensor]  # (3,): (v, i, j), the row-major first max
    #                               over the cells i >= 1, j >= 1
    f: Optional[torch.Tensor]  # (m+1,): affine, the last row F(n, 0..m),
    #                            F(n, 0) taken as H(n, 0)


def _check_capture(text: torch.Tensor, query: torch.Tensor, cfg: ScoringConfig,
                   rows, tb: Optional[int]) -> Tuple[list, int]:
    """The rows as a list and the top-edge open (0 under linear gaps)."""
    xla.check_pair(text, query, ("text", "query"))
    rows = [int(r) for r in rows]
    n = query.numel()
    if any(not 1 <= r <= n for r in rows) or any(a >= b for a, b in zip(rows, rows[1:])):
        raise ValueError(f"captured rows must increase within 1..{n}, got {rows}")
    if not cfg.is_affine:
        if tb is not None:
            raise ValueError("tb, the top edge's vertical-gap open, takes affine gaps")
        return rows, 0
    tb = cfg.gap_open if tb is None else int(tb)
    if not cfg.gap_open <= tb <= 0:
        raise ValueError(f"tb must lie in [gap_open, 0] = [{cfg.gap_open}, 0], got {tb}")
    return rows, tb


def capture_plain(text: torch.Tensor, query: torch.Tensor, cfg: ScoringConfig,
                  rows=(), *, zero_row: bool = False, zero_col: bool = False,
                  col: bool = False, cell: bool = False,
                  tb: Optional[int] = None, top: Optional[torch.Tensor] = None,
                  left: Optional[torch.Tensor] = None) -> Capture:
    """Plain PyTorch version of the capture kernel: the fill of ``text``
    (columns) against ``query`` (rows) under ``cfg`` (in kernel
    coordinates), with H(0, :) = 0 under ``zero_row`` or local scoring and
    H(:, 0) = 0 under ``zero_col`` or local scoring, by one
    :func:`tpualign_torch.ops.xla.rows_scan`.  Returns the last row, the
    rows ``rows`` (DP rows in 1..n, increasing), with ``col`` the last
    column, with ``cell`` the located cell, and under affine gaps the last
    row of F, where ``tb`` (default ``gap_open``, in ``[gap_open, 0]``) is
    Myers-Miller's top-edge open: F(0, j) = H(0, j) + tb and H(i, 0) =
    tb + i*ext (:class:`Capture`).

    K7's sharded contract, linear gaps: with ``top`` and ``left``
    (:func:`edge_fill`) the table is a block of a larger one, its top row
    H(0, 0..m) ``top`` ``(m+1,)`` and its left column H(0..n, 0) ``left``
    ``(n+1,)`` (the corner in both), in place of the closed forms
    (``zero_row`` and ``zero_col`` unread); the local floor applies to the
    cells i, j >= 1 only."""
    rows, tb = _check_capture(text, query, cfg, rows, tb)
    edges = _check_edges(text, query, cfg, top, left)
    zr, zc = cfg.is_local or zero_row, cfg.is_local or zero_col
    scan = xla.rows_scan(text, query, cfg, zero_row=zr, zero_col=zc, want_col=col,
                         capture_rows=rows, want_cell=cell,
                         tb=tb if cfg.is_affine else None,
                         top_h=top if edges else None, left_h=left if edges else None)
    last_col = None
    if col:
        if edges:
            h0m = top[-1:].to(scan.col.dtype)
        else:
            h0m = scan.col.new_full((1,), 0 if zr else xla.gap_run(cfg, text.numel()))
        last_col = torch.cat([h0m, scan.col]).int()
    return Capture(scan.h.int(), scan.caps.int() if rows else None, last_col,
                   scan.cell.int() if cell else None,
                   scan.f.int() if cfg.is_affine else None)


def _check_edges(text: torch.Tensor, query: torch.Tensor, cfg: ScoringConfig,
                 top: Optional[torch.Tensor], left: Optional[torch.Tensor]) -> bool:
    """Whether the edges come in: both or neither, linear gaps, int32
    ``(m+1,)`` and ``(n+1,)`` contiguous on the text's device (ValueError
    otherwise)."""
    if top is None and left is None:
        return False
    if top is None or left is None:
        raise ValueError("the edges in are the top row and the left column together")
    if cfg.is_affine:
        raise ValueError("the edges in take linear gaps")
    for name, t, size in (("top", top, text.numel() + 1), ("left", left, query.numel() + 1)):
        if t.dtype != torch.int32 or tuple(t.shape) != (size,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor of shape ({size},), "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != text.device:
            raise ValueError(f"{name} on {t.device} but text on {text.device}")
    return True


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def capture_fill(text: torch.Tensor, query: torch.Tensor, cfg: ScoringConfig,
                 rows=(), *, zero_row: bool = False, zero_col: bool = False,
                 col: bool = False, cell: bool = False, tb: Optional[int] = None,
                 geometry: Optional[Tuple[int, ...]] = None) -> Capture:
    """The capture kernel's result (:func:`capture_plain`) on the device of
    its tensors: K7's port for CUDA tensors, the CUDA kernel
    ``band_capture_fill`` (``csrc/band_fill.cu``) or, under affine gaps,
    ``band_capture_affine`` (``csrc/band_capture_affine.cu``), one fill
    template (``csrc/band_fill.cuh``); :func:`capture_plain` for CPU
    tensors.

    ``geometry`` as in :func:`band_fill`.  On CUDA the wrapper allocates the
    outputs, then the pipeline's scratch (the ring within
    :func:`ring_budget`), launches on the current stream without
    synchronising, and counts the launch in the counter
    ``launch.band_capture_fill`` or ``launch.band_capture_affine``.  A
    launch the device refuses raises; nothing falls back to the plain
    version or to fewer blocks."""
    rows, tb = _check_capture(text, query, cfg, rows, tb)
    if text.device.type == "cpu":
        return capture_plain(text, query, cfg, rows, zero_row=zero_row, zero_col=zero_col,
                             col=col, cell=cell, tb=tb if cfg.is_affine else None)
    if text.device.type != "cuda":
        raise ValueError(f"capture_fill runs on cpu or cuda tensors, got {text.device}")
    m, n = text.numel(), query.numel()
    dev = text.device
    lib = _build.load()
    K = len(cfg.matrix) if cfg.has_matrix else 0
    matrix = _matrix(cfg, dev)
    # the kernel returns the last row as a captured row
    krows = rows if rows and rows[-1] == n else rows + [n]
    with trace.span("to_device"):
        cap_rows = torch.tensor(krows, dtype=torch.int32).to(dev)
    with trace.span("alloc"):
        caps = torch.empty((len(krows), m + 1), dtype=torch.int32, device=dev)
        last_col = torch.empty(n + 1, dtype=torch.int32, device=dev) if col else None
        found = torch.empty(3, dtype=torch.int32, device=dev) if cell else None
        f_row = torch.empty(m + 1, dtype=torch.int32, device=dev) if cfg.is_affine else None
    trace.count_bytes("alloc_bytes", caps, last_col, found, f_row)
    plan = _plan(n, m, cfg.is_affine, geometry, max_k(cfg), dev)
    ring, sync, block_cells = _pipe_scratch(plan, m, cfg.is_affine, dev, cell)
    pipe = (_ptr(ring), plan.depth, sync.data_ptr(), _ptr(block_cells))
    head = (text.data_ptr(), m, query.data_ptr(), n, matrix.data_ptr(), K, cfg.match,
            cfg.mismatch)
    flags = _flags(cfg, (zero_row, zero_col, False, False))
    outs = (cap_rows.data_ptr(), len(krows), caps.data_ptr(), _ptr(last_col), _ptr(found))
    geom = (plan.k, plan.threads, plan.blocks)
    # csrc/band_capture_affine.cu under affine gaps
    entry = "band_capture_affine" if cfg.is_affine else "band_capture_fill"
    with trace.span("launch." + entry), torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if cfg.is_affine:
            err = lib.band_capture_affine(*head, cfg.gap_open, cfg.gap_extend, tb, flags,
                                          *geom, *outs, f_row.data_ptr(), *pipe, stream)
        else:
            err = lib.band_capture_fill(*head, cfg.gap, flags, *geom, *outs, *pipe, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err}")
    trace.count("launch." + entry)
    return Capture(caps[-1], caps[: len(rows)] if rows else None, last_col, found, f_row)


def edge_fill(text: torch.Tensor, query: torch.Tensor, cfg: ScoringConfig,
              top: torch.Tensor, left: torch.Tensor, rows=(), *, cell: bool = False) -> Capture:
    """K7's sharded contract, linear gaps: :func:`capture_fill` of a block
    of a larger table whose top row ``top`` H(0, 0..m) and left column
    ``left`` H(0..n, 0) (int32, the corner in both) come in
    (:func:`capture_plain`'s ``top`` and ``left``), with the right column
    H(0..n, m) always out, on the device of its tensors: the CUDA kernel
    ``band_capture_edge`` (``csrc/band_capture_edge.cu``, the strip body of
    ``band_fill.cuh`` with its EDGE flag) for CUDA tensors, planned as
    :func:`capture_fill` and counted in ``launch.band_capture_edge``;
    :func:`capture_plain` for CPU tensors."""
    rows, _ = _check_capture(text, query, cfg, rows, None)
    _check_edges(text, query, cfg, top, left)
    if text.device.type == "cpu":
        return capture_plain(text, query, cfg, rows, col=True, cell=cell, top=top, left=left)
    if text.device.type != "cuda":
        raise ValueError(f"edge_fill runs on cpu or cuda tensors, got {text.device}")
    m, n = text.numel(), query.numel()
    dev = text.device
    lib = _build.load()
    K = len(cfg.matrix) if cfg.has_matrix else 0
    matrix = _matrix(cfg, dev)
    krows = rows if rows and rows[-1] == n else rows + [n]
    with trace.span("to_device"):
        cap_rows = torch.tensor(krows, dtype=torch.int32).to(dev)
    with trace.span("alloc"):
        caps = torch.empty((len(krows), m + 1), dtype=torch.int32, device=dev)
        last_col = torch.empty(n + 1, dtype=torch.int32, device=dev)
        found = torch.empty(3, dtype=torch.int32, device=dev) if cell else None
    trace.count_bytes("alloc_bytes", caps, last_col, found)
    plan = _plan(n, m, False, None, max_k(cfg), dev)
    ring, sync, block_cells = _pipe_scratch(plan, m, False, dev, cell)
    with trace.span("launch.band_capture_edge"), torch.cuda.device(dev):
        err = lib.band_capture_edge(
            text.data_ptr(), m, query.data_ptr(), n, matrix.data_ptr(), K, cfg.match,
            cfg.mismatch, cfg.gap, _flags(cfg, (False,) * 4), plan.k, plan.threads,
            plan.blocks, cap_rows.data_ptr(), len(krows), caps.data_ptr(), last_col.data_ptr(),
            _ptr(found), top.data_ptr(), left.data_ptr(), _ptr(ring), plan.depth,
            sync.data_ptr(), _ptr(block_cells), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"band_capture_edge launch failed with CUDA error {err}")
    trace.count("launch.band_capture_edge")
    return Capture(caps[-1], caps[: len(rows)] if rows else None, last_col, found, None)


class Plan(NamedTuple):
    """How :func:`score_fn` runs one shape: ``swapped`` puts ``s2`` on the
    text axis (columns); ``cfg`` and ``ends`` are in kernel coordinates;
    ``floor`` holds the closed-form boundary cells the score maxes over."""

    swapped: bool
    cfg: ScoringConfig
    ends: Tuple[bool, bool, bool, bool]
    floor: Tuple[int, ...]


def plan(m: int, n: int, cfg: ScoringConfig) -> Plan:
    """The kernel's orientation, config and flags for ``len(s1) = m``,
    ``len(s2) = n`` (both non-empty).  The strips run across the shorter
    sequence (ties keep ``s2`` on the rows), so a swap puts ``s2`` on the
    columns and transposes an asymmetric matrix and the ends-free flags."""
    swapped = n > m
    mb, ns = (n, m) if swapped else (m, n)
    ends = _ends_flags(cfg, swapped)
    kcfg = cfg
    if swapped and cfg.has_matrix:
        # the kernel scores matrix[text char][row char]; swapping puts s2 on
        # the text axis, so an asymmetric matrix must transpose
        kcfg = dataclasses.replace(cfg, matrix=tuple(zip(*cfg.matrix)))
    zr, zc, er, ec = ends
    # the kernel's maxes cover j in [1, m] / i in [1, n]; the j = 0 / i = 0
    # boundary cells are closed-form (affine: one open + extend run)
    floor = ()
    if er:  # H(n, 0)
        floor += (0 if zc else xla.gap_run(cfg, ns),)
    if ec:  # H(0, m)
        floor += (0 if zr else xla.gap_run(cfg, mb),)
    return Plan(swapped, kcfg, ends, floor)


def score_fn(m: int, n: int, cfg: ScoringConfig = ScoringConfig(), *, device):
    """``(s1, s2) -> score`` for fixed lengths ``m = len(s1)`` (columns),
    ``n = len(s2)`` (rows): takes int8 code tensors on ``device`` and
    returns the score as a 0-d int64 tensor there, without synchronising.
    Refuses what ``tpualign.ops.band.score_fn`` refuses (ValueError); runs
    :func:`band_fill` as :func:`plan` says."""
    _check_cfg(cfg, m + n)
    dev = _device(device)
    if m == 0 or n == 0:
        base = _empty_score(m, n, cfg)
        return lambda s1, s2: torch.tensor(base, device=dev)
    p = plan(m, n, cfg)

    def fn(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
        if (s1.numel(), s2.numel()) != (m, n):
            raise ValueError(f"score_fn built for lengths ({m}, {n}), got "
                             f"({s1.numel()}, {s2.numel()})")
        text, query = (s2, s1) if p.swapped else (s1, s2)
        res = band_fill(text, query, p.cfg, p.ends)
        return res.clamp(min=max(p.floor)) if p.floor else res

    return fn


def score(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, device) -> int:
    """Alignment score of two code sequences on ``device`` (``"cuda"`` runs
    the kernel, ``"cpu"`` the plain version); the counterpart of
    ``tpualign.ops.band.score``."""
    with trace.span("check"):
        s1, s2 = int8_codes(s1), int8_codes(s2)
        t1, t2 = torch.from_numpy(s1), torch.from_numpy(s2)
        xla.check_codes(t1, t2, cfg)
    dev = _device(device)
    fn = score_fn(s1.size, s2.size, cfg, device=dev)
    with trace.span("to_device"):
        d1, d2 = t1.to(dev), t2.to(dev)
    res = fn(d1, d2)
    with trace.span("read_back"):
        return int(res)
