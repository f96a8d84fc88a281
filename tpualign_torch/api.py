"""Top-level API of the port: the counterpart of ``tpualign/api.py``'s
``resolve_impl``, ``align_score`` and ``align``.

``align_score`` serves every ``ScoringConfig`` and routes as ``tpualign``
does on a TPU: the bit-parallel engine for the (1, 0, -g) family, g = 1..7,
the band engine for everything else, and the same fallbacks when an engine
refuses a config or a shape with ValueError.  Every engine runs on
``engine.device``: its CUDA kernel on a CUDA device, its plain PyTorch
version on the CPU.  ``align`` serves every ``ScoringConfig`` too: it walks
the full table up to ``FULL_TABLE_CELL_LIMIT`` cells (in C++ for linear-gap
global configs, ``utils/native.py``); above it, it runs the
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
The sharded engines (:mod:`tpualign_torch.parallel`) run over the default
shard group, which ``auto`` takes where the group has more than one shard
and the pair gives each a large enough block.  Nothing runs quietly on
another engine or device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import trace
from .config import EngineConfig, ScoringConfig
from .ops import (affine_align, band, band_align, band_batch, bitpal, ends_free, hirschberg,
                  oracle, pallas_diag, traceback, traceback_diag, xla)
from .parallel import band_strips, bitpal_strips, mesh, strips
from .utils import native

#: ``align`` walks the exact full table up to this many DP cells (as
#: ``tpualign.api.FULL_TABLE_CELL_LIMIT``), and bisects above it
FULL_TABLE_CELL_LIMIT = 16 * 1024 * 1024


#: a sharded engine takes a pair under ``auto`` when its sharded axis gives
#: each shard at least this many bases (``tpualign``'s rule)
SHARD_MIN = 4096


def resolve_impl(engine: EngineConfig, scoring: ScoringConfig, shape=None) -> str:
    """The engine for ``engine.impl`` and ``scoring``: a named engine as it
    is; ``auto`` by ``tpualign``'s rule on a TPU (``tpualign/api.py:40-109``),
    with ``n_dev`` the size of the default shard group of
    ``engine.device`` (:func:`tpualign_torch.parallel.mesh.default_group`:
    the ``torch.distributed`` world, else the visible cards, else 1 on the
    CPU).  Given ``shape = (len(s1), len(s2))`` on a group of more than one
    shard: affine configs without a matrix or ends-free mode take
    ``strips`` when ``max(m, n) >= 4096 * n_dev``; matrix and ends-free
    configs ``band-strips`` by the same test; the (1, 0, -g) family
    ``bitpal-strips`` when ``min(m, n) >= 4096 * n_dev``, other configs
    ``band-strips`` when ``max(m, n)`` is.  Otherwise ``bitpal`` for the
    family, g = 1..7, and ``band`` for every other config, affine included.
    On one card ``n_dev`` is 1, so ``auto`` stays on one device, as
    ``tpualign`` does on one chip.  ``band-chunked`` gives ``band``: the
    JAX tier exists to lift the TPU kernel's SMEM cap on the boundary row,
    which the port's band kernel does not have."""
    if engine.impl == "band-chunked":
        return "band"
    if engine.impl != "auto":
        return engine.impl
    fam = bitpal.family(scoring)
    if shape is not None:
        n_dev = mesh.default_group(engine.device).size
        m, n = shape
        wide = max(m, n) >= SHARD_MIN * n_dev
        if n_dev > 1:
            if scoring.is_affine:
                if wide and not (scoring.has_matrix or scoring.is_ends_free):
                    return "strips"
            elif scoring.has_matrix or scoring.is_ends_free:
                if wide:
                    return "band-strips"
            elif fam is not None:
                if min(m, n) >= SHARD_MIN * n_dev:
                    return "bitpal-strips"
            elif wide:
                return "band-strips"
    return "bitpal" if fam is not None else "band"


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
    no refusal, so no engine takes its place; so does ``align``.

    The sharded engines fall back as ``tpualign/api.py:130-161``, on the
    refusals their ``check`` finds before they run (a ValueError raised
    inside a pipeline propagates): ``bitpal-strips`` (``chunk_cols``
    ``engine.chunk_rows``) to ``strips``; ``band-strips`` to ``strips``, or
    for matrix and ends-free configs to ``band``; ``strips``
    (``engine.chunk_rows``) refuses matrix and ends-free configs.

    The call is the root span ``align_score`` (:mod:`tpualign_torch.trace`),
    tagged with the engine it resolved to (``impl``), which the child span
    ``route`` resolves."""
    with trace.span("align_score"):
        return _align_score(s1, s2, scoring, engine)


def _align_score(s1, s2, scoring: ScoringConfig, engine: EngineConfig) -> int:
    s1, s2 = np.asarray(s1), np.asarray(s2)
    with trace.span("route"):
        impl = resolve_impl(engine, scoring, (int(s1.size), int(s2.size)))
    dev = engine.device
    trace.tag(impl=impl)
    if impl == "bitpal-strips":
        try:
            bitpal_strips.check(s1, s2, scoring)
        except ValueError:  # outside the family or its codes
            impl = "strips"
        else:
            return bitpal_strips.score(s1, s2, scoring, chunk_cols=engine.chunk_rows,
                                       device=dev)
    if impl == "band-strips":
        try:
            band_strips.check(s1, s2, scoring)
        except ValueError:  # affine gaps, or past the int32 headroom
            impl = "band" if (scoring.has_matrix or scoring.is_ends_free) else "strips"
        else:
            return band_strips.score(s1, s2, scoring, device=dev)
    if impl == "strips":
        return strips.score(s1, s2, scoring, chunk_rows=engine.chunk_rows, device=dev)
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

    Up to ``FULL_TABLE_CELL_LIMIT`` cells: the exact full-table traceback on
    the host, any config; in C++ for linear-gap global configs
    (:func:`tpualign_torch.utils.native.traceback`, as
    ``tpualign/api.py:221-231``), else in NumPy
    (:func:`tpualign_torch.ops.oracle.traceback`), the same strings.
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
    (:func:`tpualign_torch.ops.traceback.align_checkpointed`), which the
    sharded engines' names take too, as in ``tpualign``.  Where the
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
    :func:`tpualign_torch.ops.traceback.align_checkpointed`).

    The call is the root span ``align`` (:mod:`tpualign_torch.trace`),
    tagged with its ``impl`` past the full table (``"full_table"`` up to
    it)."""
    with trace.span("align"):
        return _align(s1, s2, scoring, engine, stats)


def _align(s1, s2, scoring: ScoringConfig, engine: EngineConfig,
           stats: dict | None) -> Tuple[int, str, str]:
    s1 = np.asarray(s1, dtype=np.int8)
    s2 = np.asarray(s2, dtype=np.int8)
    if (s1.size + 1) * (s2.size + 1) <= FULL_TABLE_CELL_LIMIT:
        trace.tag(impl="full_table")
        if native.walks(scoring) and not scoring.is_local:
            # the oracle's refusal of codes outside a matrix, a ValueError
            xla.check_codes(torch.from_numpy(s1), torch.from_numpy(s2), scoring)
            return native.traceback(s1, s2, scoring)
        return oracle.traceback(s1, s2, scoring)
    dev = engine.device
    if scoring.has_matrix or scoring.is_ends_free:
        trace.tag(impl="ends_free")
        return ends_free.align_large(s1, s2, scoring, device=dev, stats=stats)
    if scoring.is_affine:
        trace.tag(impl="affine")
        return affine_align.align(s1, s2, scoring, device=dev, stats=stats)
    with trace.span("route"):
        impl = resolve_impl(engine, scoring)
    trace.tag(impl=impl)
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
    ``tpualign`` fails an assertion).

    The call is the root span ``align_score_batch``
    (:mod:`tpualign_torch.trace`), tagged with its ``impl``."""
    with trace.span("align_score_batch"):
        return _align_score_batch(texts, queries, scoring, engine)


def _align_score_batch(texts: Sequence, queries: Sequence, scoring: ScoringConfig,
                       engine: EngineConfig) -> np.ndarray:
    if len(texts) != len(queries):
        raise ValueError(f"{len(texts)} texts but {len(queries)} queries")
    if not len(texts):
        return np.zeros(0, np.int64)
    with trace.span("route"):
        impl = resolve_impl(engine, scoring)
    trace.tag(impl=impl)
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
