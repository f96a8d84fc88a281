"""K7's batch contract (``tpualign_torch.ops.band_batch.batch_fill``): its
planner, and its kernel run on the CPU.

- ``batch_plan``: a pair whose query has at most ``32 * k`` rows is short
  and runs a warp of its own at ``k`` rows a lane (``k`` the fewest that
  hold the longest such query, at most ``band.max_k``, so at most
  ``band.MAX_K_LOCAL_AFFINE`` under local affine scoring); longer pairs cut
  into strips of ``LONG_K * threads`` rows, numbered into one ticket,
  longest pair first, each with a ring of its own within the budget; the
  refusals of geometries and ticket counts the kernel does not take, and
  rings past the device's memory, which raise ``torch.OutOfMemoryError``.
  Only the CUDA branch of ``batch_fill`` calls the planner, so it is tested
  here directly.
- ``band_batch_fill`` (``tpualign_torch/csrc/band_batch.cu``) compiled with
  ``g++`` through the shim of ``tools/rehearse_kernels.py`` and held against
  ``xla.score_batch`` (``rehearse_kernels.band_batch_case``: the rings
  seeded with garbage, both tickets and every strip's progress flag checked
  at the end): all 38 instantiations on ragged batches of both schedules,
  1 x 1 pairs, pairs of several strips, one block and fewer blocks than a
  pair's strips, rings of 2 rows, and batches of short pairs with the
  grid's blocks at once.  ``xla.score_batch`` is held against
  ``tpualign.ops.band_batch.score_batch`` in ``tests/test_torch_batch.py``.
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from tpualign_torch import matrices
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import band, band_batch
from tpualign_torch.probe import read_pairs, serve_pairs

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
LONG = band_batch.LONG_K * band.PIPE_THREADS  # a long pair's strip at the default threads


def _plan(n, m=None, affine=False, max_k=band.MAX_K, geometry=None, budget=None):
    n = np.asarray(n, np.int64)
    m = np.full(n.size, 100, np.int64) if m is None else np.asarray(m, np.int64)
    return band_batch.batch_plan(m, n, affine, max_k, geometry, budget)


@pytest.mark.parametrize("k", band.KS)
def test_batch_plan_splits_at_32_k_rows(k):
    """A query of 32 k rows is short, one of 32 k + 1 long, k forced; by
    default the split is at 32 x MAX_K rows."""
    plan = _plan([32 * k + 1, 32 * k], geometry=(k, 128))
    assert plan.k == k and plan.longs == 1 and plan.order.tolist() == [0, 1]
    plan = _plan([32 * band.MAX_K + 1, 32 * band.MAX_K, 32 * k])
    assert plan.k == band.MAX_K and plan.longs == 1 and plan.order[0] == 0


@pytest.mark.parametrize("n_max, k", [(1, 1), (32, 1), (33, 2), (64, 2), (65, 4), (150, 8),
                                      (256, 8), (257, 16), (512, 16)])
def test_batch_plan_picks_k_from_the_longest_short_query(n_max, k):
    """The fewest rows a lane that hold the longest query of at most 32 x
    MAX_K rows; a longer query does not raise it."""
    plan = _plan([1, n_max, 513, 20000])
    assert plan.k == k
    assert plan.longs == 2 and sorted(plan.order[:2].tolist()) == [2, 3]


def test_batch_plan_without_short_pairs():
    plan = _plan([600, 5000])
    assert plan.k == 1 and plan.longs == 2
    assert plan.first.tolist() == [0, 5, 6]


def test_batch_plan_caps_k_under_local_affine():
    """Local affine scoring stops at MAX_K_LOCAL_AFFINE rows a lane: a
    query past 32 x 8 rows is long, and a forced k of 16 is refused."""
    cap = band.MAX_K_LOCAL_AFFINE
    cfg = ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2, mode=AlignMode.LOCAL)
    assert band.max_k(cfg) == cap
    plan = _plan([32 * cap, 32 * cap + 1], affine=True, max_k=band.max_k(cfg))
    assert plan.k == cap and plan.order.tolist() == [1, 0] and plan.longs == 1
    with pytest.raises(ValueError, match="rows a lane"):
        _plan([10], affine=True, max_k=cap, geometry=(16, 128))


def test_batch_plan_orders_longest_first():
    """Long pairs by text plus query, longest first, then the short pairs
    in the batch's order; the long pairs' strips numbered in that order."""
    m = np.array([10, 7000, 50, 300, 20000, 9, 5000])
    n = np.array([100, 3000, 12, 4000, 900, 150, 8000])
    plan = band_batch.batch_plan(m, n, False)
    assert plan.k == 8
    assert plan.order.tolist() == [4, 6, 1, 3, 0, 2, 5]
    strips = [-(-int(n[p]) // LONG) for p in plan.order[:plan.longs]]
    assert plan.first.tolist() == np.concatenate([[0], np.cumsum(strips)]).tolist()
    assert plan.strips == sum(strips) == 16


@pytest.mark.parametrize("blocks", [None, 1, 3, 1000])
def test_batch_plan_rings(blocks):
    """A ring of min(strips, blocks + 1) rows of m + 1 int32 for each long
    pair of two strips or more (twice under affine gaps), none for one
    strip, laid out one after another."""
    m = np.array([5000, 300, 40, 900])
    n = np.array([LONG * 5 - 3, LONG + 1, 2 * LONG, LONG])
    geometry = None if blocks is None else (1, band.PIPE_THREADS, blocks)
    for affine in (False, True):
        plan = band_batch.batch_plan(m, n, affine, band.MAX_K, geometry)
        G = plan.blocks
        assert G == (10 if blocks is None else blocks)  # a ticket a strip: 5 + 2 + 2 + 1
        strips = np.diff(plan.first)
        lm = m[plan.order[:plan.longs]]
        assert plan.depth.tolist() == [min(s, G + 1) if s > 1 else 0 for s in strips]
        rows = (2 if affine else 1) * (lm + 1)
        sizes = plan.depth * rows
        assert plan.ring_at.tolist() == (np.cumsum(sizes) - sizes).tolist()
        assert plan.ring == int(sizes.sum())


@pytest.mark.parametrize("affine", [False, True])
def test_batch_plan_cuts_rings_to_the_budget(affine):
    """Rings cut to the deepest common cap that fits the budget, down to 2
    rows; 2 rows past it raise torch.OutOfMemoryError."""
    m = np.array([25000, 12000, 9000])
    n = np.array([LONG * 20, LONG * 9, LONG * 3])
    full = band_batch.batch_plan(m, n, affine)
    assert full.depth.tolist() == [20, 9, 3]
    row = 4 * (2 if affine else 1) * (m[full.order] + 1)
    for cap in (2, 3, 7, 19):
        budget = int((np.minimum(full.depth, cap) * row).sum())
        plan = band_batch.batch_plan(m, n, affine, budget=budget)
        assert plan.depth.tolist() == np.minimum(full.depth, cap).tolist()
        assert 4 * plan.ring <= budget
        assert cap == 2 or band_batch.batch_plan(m, n, affine, budget=budget - 1).depth.max() < cap
    with pytest.raises(torch.OutOfMemoryError, match="past the budget"):
        band_batch.batch_plan(m, n, affine, budget=int(2 * row.sum()) - 1)
    # a batch without a ring of 2 strips takes none, whatever the budget
    assert band_batch.batch_plan(m, np.array([LONG, 300, 5]), affine, budget=0).ring == 0


def test_batch_plan_refuses_int32_tickets():
    """Every block takes one ticket past the strips and every warp one past
    the short pairs: counts past int32 are refused."""
    with pytest.raises(ValueError, match="int32 tickets"):
        _plan([256 * 11], geometry=(1, 32, 2**31 - 11))
    _plan([256 * 11], geometry=(1, 32, 2**31 - 12))
    with pytest.raises(ValueError, match="int32 tickets"):
        _plan([5], geometry=(1, 256, 2**28))
    _plan([5], geometry=(1, 256, 2**28 - 1))


@pytest.mark.parametrize("geometry, match", [
    ((3, 128), "rows a lane"), ((32, 128), "rows a lane"), ((1, 48), "threads"),
    ((1, 512), "threads"), ((1, 0), "threads"), ((1, 128, 0), "blocks"),
    ((1,), "geometry is"), ((1, 128, 4, 2), "geometry is"),
])
def test_batch_plan_refuses_bad_geometry(geometry, match):
    with pytest.raises(ValueError, match=match):
        _plan([10, 2000], geometry=geometry)


@pytest.mark.parametrize("m, n", [([], []), ([3, 4], [5]), ([0, 4], [5, 6]), ([3], [0]),
                                  ([[3]], [[4]])])
def test_batch_plan_refuses_bad_lengths(m, n):
    with pytest.raises(ValueError):
        band_batch.batch_plan(m, n, False)


def test_batch_plan_forced_geometry():
    """A forced (k, threads, blocks) is taken as it is: the split at 32 k,
    strips of LONG_K x threads rows, the blocks."""
    plan = _plan([20, 40, 300, 1000], geometry=(1, 32, 3))
    assert (plan.k, plan.threads, plan.blocks) == (1, 32, 3)
    assert plan.order[plan.longs:].tolist() == [0] and plan.longs == 3
    assert np.diff(plan.first).tolist() == [4, 2, 1]
    assert plan.depth.tolist() == [4, 2, 0]
    assert "3 long pairs in 7 strips of 8 x 32 rows" in plan.describe()


def test_batch_plan_of_the_two_mixes():
    """Mix (A), the serving demo: 16 long pairs, 245 strips of 1,024 rows on
    245 blocks, each pair's ring as deep as its strips.  Mix (B): 8,192
    short pairs a warp each at 8 rows a lane, 528 blocks of 4 warps."""
    texts, queries = serve_pairs()
    m, n = (np.fromiter(map(len, x), np.int64) for x in (texts, queries))
    plan = band_batch.batch_plan(m, n, False)
    assert (plan.longs, plan.strips, plan.blocks, plan.threads) == (16, 245, 245, 128)
    assert plan.depth.tolist() == np.diff(plan.first).tolist()
    texts, queries = read_pairs()
    m, n = (np.fromiter(map(len, x), np.int64) for x in (texts, queries))
    plan = band_batch.batch_plan(m, n, False)
    assert (plan.k, plan.longs, plan.strips, plan.blocks, plan.ring) == (8, 0, 0, 528, 0)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ builds the kernels through the shim")
    sys.path.insert(0, TOOLS)
    try:
        import rehearse_kernels
    finally:
        sys.path.remove(TOOLS)
    dll = rehearse_kernels.build(str(tmp_path_factory.mktemp("shim")), ("band_batch.cu",))
    return rehearse_kernels, dll


def _cfg(affine, matrix, local, mode=AlignMode.GLOBAL):
    gaps = dict(gap_open=-5, gap_extend=-2) if affine else {}
    return ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL if local else mode,
                         matrix=matrices.dna(2, -1, -3) if matrix else None, **gaps)


def _pairs(rng, m, n):
    return ([rng.integers(0, 5, int(x)).astype(np.int8) for x in m],
            [rng.integers(0, 5, int(x)).astype(np.int8) for x in n])


@pytest.mark.parametrize("kind", range(38))
def test_every_instantiation_through_the_shim(shim, kind):
    """Each (k, affine, matrix, local) on a ragged batch of short pairs (up
    to 32 k rows, the last exactly 32 k), long ones of one to three strips
    of 256 rows and a 1 x 1 pair, over two blocks and rings of 2 rows."""
    rk, dll = shim
    k, affine, matrix, local = rk.BATCH_KINDS[kind]
    rng = np.random.default_rng(100 + kind)
    n = [1, 32 * k, *rng.integers(1, 32 * k + 1, 2), 32 * k + 1, 32 * k + 300, 700]
    m = [1, *rng.integers(1, 70, len(n) - 1)]
    mode = (AlignMode.GLOBAL, AlignMode.SEMIGLOBAL, AlignMode.INFIX)[kind % 3]
    cfg = _cfg(affine, matrix, local, mode)
    plan = band_batch.batch_plan(np.array(m), np.array(n), affine, band.max_k(cfg), (k, 32, 2))
    assert plan.longs == 3 and plan.k == k
    budget = rk.two_row_budget(plan, np.array(m), affine)
    ok, where = rk.band_batch_case(dll, rng, cfg, *_pairs(rng, m, n), (k, 32, 2), budget)
    assert ok, where


@pytest.mark.parametrize("blocks", [1, 2, 5, None])
@pytest.mark.parametrize("affine", [False, True])
def test_long_pairs_through_the_shim(shim, blocks, affine):
    """Long pairs only, of one to five strips of 256 rows, texts from 1 to
    90 columns, one block, fewer blocks than a pair's strips and the
    planner's blocks; the rings as deep as the plan makes them."""
    rk, dll = shim
    rng = np.random.default_rng(7 + affine)
    n = [33, 256, 257, 600, 1280]
    m = [90, 1, 45, 17, 60]
    geometry = (1, 32) + (() if blocks is None else (blocks,))
    cfg = _cfg(affine, False, False)
    ok, where = rk.band_batch_case(dll, rng, cfg, *_pairs(rng, m, n), geometry)
    assert ok, where


@pytest.mark.parametrize("local", [False, True])
def test_one_by_one_pairs_through_the_shim(shim, local):
    """Batches of 1 x 1 pairs, short and (at k = 1, 32 threads) a long one
    of 33 x 1."""
    rk, dll = shim
    rng = np.random.default_rng(3)
    for n in ([1], [1] * 9, [1, 33, 1]):
        ok, where = rk.band_batch_case(dll, rng, _cfg(False, False, local),
                                       *_pairs(rng, [1] * len(n), n), (1, 32))
        assert ok, where


@pytest.mark.parametrize("matrix", [False, True])
@pytest.mark.parametrize("k", [1, 8])
def test_short_pairs_with_blocks_at_once_through_the_shim(shim, k, matrix):
    """Short pairs only, the grid's blocks at once: more warps than pairs
    and fewer, each warp taking pairs from its own ticket."""
    rk, dll = shim
    rng = np.random.default_rng(20 + k + matrix)
    for P, geometry in ((13, (k, 64, 3)), (3, (k, 128, 4))):
        n = rng.integers(1, 32 * k + 1, P)
        m = rng.integers(1, 80, P)
        ok, where = rk.band_batch_case(dll, rng, _cfg(False, matrix, True), *_pairs(rng, m, n),
                                       geometry, concurrent=True)
        assert ok, where
