"""Flat anti-diagonal score in PyTorch and CUDA: the port of
``tpualign/ops/pallas_diag.py:score`` (the ``impl="pallas"`` engine, and the
one ``bitpal`` falls back to).  It holds no Pallas; the module keeps its
counterpart's name so that a reader finds one from the other.

Pair scoring, linear gaps, global (Needleman-Wunsch) or local
(Smith-Waterman), as ``tpualign``'s kernel.  The kernel
(``csrc/diag_fill.cu``, K8's port) sweeps the anti-diagonals of the table
with the shorter sequence on the diagonal axis, three rotating diagonals in
global memory; the TPU kernel's VMEM cap (``MAX_DIAG_ELEMS``) and its
rolled, staged window of ``s1`` have no counterpart.  Its contract, shared
by :func:`diag_fill` and :func:`score_plain`: ``s1`` (m,) int8 across the
columns, ``s2`` (n,) int8 down the rows, ``n <= m``; the result is
``H(n, m)`` (global) or the max over every cell and 0 (local).
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import ScoringConfig
from . import xla
from .bitpal import _device
from .pairs import int8_codes

MAX_THREADS = 1024
WARP = 32


def _ensure_pair_modes(cfg: ScoringConfig) -> None:
    """ValueError for matrix and ends-free configs, as
    ``tpualign.config.ensure_pair_modes``."""
    if cfg.has_matrix or cfg.is_ends_free:
        raise ValueError(
            "pallas_diag serves pair-scored global/local configs; "
            "matrix/ends-free configs run on the band or xla engines")


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


def kernel_threads(n: int) -> int:
    """Threads of the one block for ``n`` rows: one a diagonal element
    (``n + 1`` of them) up to ``MAX_THREADS``, rounded up to whole warps."""
    return min(MAX_THREADS, -(-(n + 1) // WARP) * WARP)


def score_plain(s1: torch.Tensor, s2: torch.Tensor, cfg: ScoringConfig) -> torch.Tensor:
    """Plain PyTorch version of the diagonal kernel (module docstring) by
    the row scan of :func:`tpualign_torch.ops.xla.rows_scan`, as a 0-d
    int64 tensor on the tensors' device."""
    _check_fill_args(s1, s2)
    local = cfg.is_local
    h, best = xla.rows_scan(s1, s2, cfg, zero_row=local, zero_col=local,
                            want_best=local)[:2]
    return best.clamp(min=0) if local else h[-1]


def diag_fill(s1: torch.Tensor, s2: torch.Tensor, cfg: ScoringConfig) -> torch.Tensor:
    """The diagonal kernel's result on the device of its tensors: the CUDA
    kernel ``diag_fill`` (``csrc/diag_fill.cu``) for CUDA tensors,
    :func:`score_plain` for CPU tensors; a 0-d int64 tensor.

    On CUDA the wrapper allocates the diagonals and the output, launches on
    the current stream without synchronising, and counts the launch in
    ``diag_fill.launches``.  A launch the device refuses raises; nothing
    falls back to the plain version."""
    _check_fill_args(s1, s2)
    if s1.device.type == "cpu":
        return score_plain(s1, s2, cfg)
    if s1.device.type != "cuda":
        raise ValueError(f"diag_fill runs on cpu or cuda tensors, got {s1.device}")
    m, n = s1.numel(), s2.numel()
    threads = kernel_threads(n)
    dev = s1.device
    lib = _build.load()
    diag = torch.empty((3, n + 1), dtype=torch.int32, device=dev)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.diag_fill(
            s1.data_ptr(), m, s2.data_ptr(), n, cfg.match, cfg.mismatch,
            cfg.gap, int(cfg.is_local), threads, diag.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"diag_fill launch failed with CUDA error {err}")
    diag_fill.launches += 1
    return out[0].long()


diag_fill.launches = 0


def score(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, device) -> int:
    """NW or SW score of two code sequences on ``device`` (``"cuda"`` runs
    the kernel, ``"cpu"`` the plain version); the counterpart of
    ``tpualign.ops.pallas_diag.score``.  The shorter sequence goes on the
    diagonal axis (the score is symmetric under the swap)."""
    a, b = int8_codes(s1), int8_codes(s2)
    _ensure_pair_modes(cfg)
    dev = _device(device)
    if a.size == 0 or b.size == 0:
        return 0 if cfg.is_local else cfg.gap * (a.size + b.size)
    _check_cfg(cfg, a.size + b.size)
    if b.size > a.size:
        a, b = b, a
    return int(diag_fill(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), cfg))
