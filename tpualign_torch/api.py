"""Top-level API of the port: the counterpart of ``tpualign/api.py``'s
``resolve_impl``, ``align_score`` and ``align``.

``align_score`` serves every ``ScoringConfig`` and routes as ``tpualign``
does on a TPU: the bit-parallel engine for the (1, 0, -g) family, g = 1..7,
the band engine for everything else, and the same fallbacks when an engine
refuses a config or a shape with ValueError.  Every engine runs on
``engine.device``: its CUDA kernel on a CUDA device, its plain PyTorch
version on the CPU.  ``align`` serves every ``ScoringConfig`` too: it walks
the full table up to ``FULL_TABLE_CELL_LIMIT`` cells; above it, it runs the
bit-parallel Hirschberg split for the family, Myers-Miller over K7's affine
capture fill (``ops/affine_align.py``) for affine gaps, the split over
K7's port (``ops/band_align.py``, ``ops/ends_free.py``) for the other
configs, the diagonal-band traceback over K9's port
(``ops/traceback_diag.py``) for local configs with a positive mismatch or
gap, and the checkpointed row-scan traceback (``ops/traceback.py``) for
``impl="oracle"``/``"xla"`` and as the last fallback.
``align_score_batch`` scores many pairs in one kernel launch: the
bit-parallel batch kernel (K5's port) for the family, the strip kernel's
batch contract (K7's) for every other config, routed as ``tpualign``'s.
What is not ported raises NotImplementedError naming the ROADMAP item
that ports it; nothing runs quietly on another engine or device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .config import UNPORTED_IMPLS, EngineConfig, ScoringConfig
from .ops import (affine_align, band, band_align, band_batch, bitpal, ends_free, hirschberg,
                  oracle, pallas_diag, traceback, traceback_diag, xla)

#: ``align`` walks the exact full table up to this many DP cells (as
#: ``tpualign.api.FULL_TABLE_CELL_LIMIT``), and bisects above it
FULL_TABLE_CELL_LIMIT = 16 * 1024 * 1024


def resolve_impl(engine: EngineConfig, scoring: ScoringConfig) -> str:
    """The engine for ``engine.impl`` and ``scoring``: a named engine as it
    is; ``auto`` gives ``bitpal`` for the (1, 0, -g) family, g = 1..7, and
    ``band`` for every other config, affine included (``tpualign``'s rule
    on a TPU).  ``band-chunked`` gives ``band``: the JAX tier exists to lift
    the TPU kernel's SMEM cap on the boundary row, which the port's band
    kernel does not have.  The sharded engines raise NotImplementedError."""
    if engine.impl in UNPORTED_IMPLS:
        raise NotImplementedError(
            f"impl={engine.impl!r} is not ported yet: {UNPORTED_IMPLS[engine.impl]}")
    if engine.impl == "band-chunked":
        return "band"
    if engine.impl != "auto":
        return engine.impl
    return "bitpal" if bitpal.family(scoring) is not None else "band"


def align_score(
    s1: np.ndarray,
    s2: np.ndarray,
    scoring: ScoringConfig = ScoringConfig(),
    engine: EngineConfig = EngineConfig(),
) -> int:
    """Alignment score of ``s1`` (columns) vs ``s2`` (rows) as ``.bdna``
    codes, with the semantics of ``tpualign.align_score``.  Runs on
    ``engine.device``.

    Falls back as ``tpualign/api.py:162-203`` does, and only on the
    ValueError by which an engine refuses a config or a shape: ``bitpal``
    to ``pallas``; ``band`` to ``xla`` for matrix, ends-free or affine
    configs.  ``band`` refuses a linear pair-scored config only past the
    int32 headroom, where ``pallas`` refuses it too, or on a card without
    the memory for its ring of 2 rows (``band.pipeline_plan``), so that
    error is raised; ``pallas`` runs the same strip pipeline and raises it
    too.  ``bitpal`` on a card without the memory for its ring
    of 2 rows raises ``torch.OutOfMemoryError`` (``bitpal.pipeline_plan``),
    no refusal, so no engine takes its place; so does ``align``."""
    impl = resolve_impl(engine, scoring)
    dev = engine.device
    if impl == "oracle":
        return oracle.score(s1, s2, scoring)
    if impl == "bitpal":
        try:
            return bitpal.score(s1, s2, scoring, device=dev)
        except ValueError:  # outside the family or the one-block kernel
            impl = "pallas"
    if impl == "band":
        try:
            return band.score(s1, s2, scoring, device=dev)
        except ValueError:  # past the int32 headroom or the card's memory
            if not (scoring.has_matrix or scoring.is_ends_free or scoring.is_affine):
                raise
            impl = "xla"
    if impl == "xla":
        return xla.score(s1, s2, scoring, device=dev)
    return pallas_diag.score(s1, s2, scoring, device=dev)


def align(
    s1: np.ndarray,
    s2: np.ndarray,
    scoring: ScoringConfig = ScoringConfig(),
    engine: EngineConfig = EngineConfig(),
    *,
    stats: dict | None = None,
) -> Tuple[int, str, str]:
    """Score plus aligned strings (gap ``-``) of ``s1`` (text, columns)
    against ``s2`` (query, rows), with the semantics of ``tpualign.align``.

    Up to ``FULL_TABLE_CELL_LIMIT`` cells: the exact full-table traceback
    (:func:`tpualign_torch.ops.oracle.traceback`), any config, on the host.
    Above it, on ``engine.device``, routed as ``tpualign/api.py:218-288``
    routes on a TPU: matrix or ends-free configs to
    :func:`tpualign_torch.ops.ends_free.align_large`; other affine configs,
    whatever ``impl`` is, to Myers-Miller
    (:func:`tpualign_torch.ops.affine_align.align` or ``align_local``); the
    (1, 0, -g) family (``bitpal``) to the bit-parallel Hirschberg split;
    ``band`` and ``pallas`` to :func:`tpualign_torch.ops.band_align.align_local`
    or ``align_global``, except local configs with a positive mismatch or
    gap, which ``tpualign``'s band split refuses
    (``tpualign/ops/band_align.py:950-954``) and which go to the
    diagonal-band traceback
    (:func:`tpualign_torch.ops.traceback_diag.align_diag`, K9's port); on
    ValueError from the band split, ``align_diag`` too; on ValueError from
    it (past ``pallas_diag.MAX_DIAG_ELEMS`` rows, past the int32 headroom,
    a positive global gap), and for ``impl="oracle"`` or ``"xla"``, the
    checkpointed row-scan traceback
    (:func:`tpualign_torch.ops.traceback.align_checkpointed`).  Where the
    bit-parallel split refuses a pair (ValueError), the port goes on to the
    band split: its own choice, where ``tpualign`` goes to the checkpointed
    traceback.  The alignments are optimal; the two checkpointed
    tracebacks return the oracle's strings, the splits under linear gaps
    may take another tie, and under affine gaps the strings are
    ``tpualign``'s.

    ``stats``, when given, gets the split of the path past the full table:
    the tree's counts and host-clock seconds
    (:func:`tpualign_torch.ops.hirschberg.tree`,
    :func:`tpualign_torch.ops.affine_align.align`), for local configs the
    located cells (:func:`tpualign_torch.ops.band_align.align_local`,
    :func:`tpualign_torch.ops.affine_align.align_local`), and the
    checkpointed tracebacks' fill, copy and walk
    (:func:`tpualign_torch.ops.traceback_diag.align_diag`,
    :func:`tpualign_torch.ops.traceback.align_checkpointed`)."""
    s1 = np.asarray(s1, dtype=np.int8)
    s2 = np.asarray(s2, dtype=np.int8)
    if (s1.size + 1) * (s2.size + 1) <= FULL_TABLE_CELL_LIMIT:
        return oracle.traceback(s1, s2, scoring)
    dev = engine.device
    if scoring.has_matrix or scoring.is_ends_free:
        return ends_free.align_large(s1, s2, scoring, device=dev, stats=stats)
    if scoring.is_affine:
        return affine_align.align(s1, s2, scoring, device=dev, stats=stats)
    impl = resolve_impl(engine, scoring)
    if impl == "bitpal":
        try:
            return hirschberg.align(s1, s2, scoring, device=dev, stats=stats)
        except ValueError:  # outside the family, its codes or its one block
            impl = "band"
    if impl in ("band", "pallas"):
        if not (scoring.is_local and (scoring.mismatch > 0 or scoring.gap > 0)):
            try:
                if scoring.is_local:
                    return band_align.align_local(s1, s2, scoring, device=dev, stats=stats)
                return band_align.align_global(s1, s2, scoring, device=dev, stats=stats)
            except ValueError:  # past the int32 headroom
                pass
        try:
            return traceback_diag.align_diag(s1, s2, scoring, device=dev, stats=stats)
        except ValueError:  # outside the diagonal kernel's envelope
            pass
    return traceback.align_checkpointed(s1, s2, scoring, device=dev, stats=stats)


def align_score_batch(
    texts: Sequence,
    queries: Sequence,
    scoring: ScoringConfig = ScoringConfig(),
    engine: EngineConfig = EngineConfig(),
) -> np.ndarray:
    """Scores of the pairs ``(texts[p], queries[p])`` (text across the
    columns, query down the rows, as ``align_score(texts[p], queries[p])``)
    as a ``(P,)`` int64 array, with the semantics of
    ``tpualign.align_score_batch``.  Runs on ``engine.device``.

    Routed as ``tpualign/api.py:306-347``: affine gaps without a matrix or
    an ends-free mode under ``impl="xla"`` take the batched row scan
    (:func:`tpualign_torch.ops.xla.score_batch_affine`); an engine that
    resolves to ``bitpal`` takes the bit-parallel batch kernel
    (:func:`tpualign_torch.ops.bitpal.score_batch`) for a family config;
    an engine that
    resolves to ``band`` or ``bitpal`` then takes the strip kernel's batch
    (:func:`tpualign_torch.ops.band_batch.score_batch`), each going on to
    the next on ValueError; everything else takes a loop of
    :func:`align_score` over the pairs.  The port's own choices: the strip
    batch takes affine configs (under ``impl="auto"`` too), matrices and
    ends-free modes with them, masked local scoring and pairs past one
    strip, which ``tpualign`` sends to the row scan or its per-pair loop,
    with the same scores; an empty batch returns an empty array (where
    ``tpualign`` fails an assertion)."""
    if len(texts) != len(queries):
        raise ValueError(f"{len(texts)} texts but {len(queries)} queries")
    if not len(texts):
        return np.zeros(0, np.int64)
    impl = resolve_impl(engine, scoring)
    dev = engine.device
    if (engine.impl == "xla" and scoring.is_affine
            and not (scoring.has_matrix or scoring.is_ends_free)):
        return xla.score_batch_affine(texts, queries, scoring, device=dev)
    if impl == "bitpal":
        try:
            return bitpal.score_batch(texts, queries, scoring, device=dev)
        except ValueError:  # outside the family, its headroom or one block
            pass
    if impl in ("band", "bitpal"):
        try:
            return band_batch.score_batch(texts, queries, scoring, device=dev)
        except ValueError:  # past the int32 headroom
            pass
    return np.asarray([align_score(t, q, scoring, engine) for t, q in zip(texts, queries)],
                      dtype=np.int64)
