"""The bit-parallel batch fill (``tpualign_torch.ops.bitpal.batch_fill``,
K5's port): its planner, and its kernel run on the CPU.

- ``batch_plan``: a pair of at most 16 words takes a segment of the next
  power of two lanes of a warp, a wider one bands of 32 words over many
  blocks with a ring a pair within the budget; the refusals of batches and
  block counts the kernel does not take, and rings past the device's
  memory, which raise ``torch.OutOfMemoryError``.
- ``bitpal_batch_fill`` (``tpualign_torch/csrc/bitpal_batch.cu``)
  compiled with ``g++`` through the shim of ``tools/rehearse_kernels.py``
  and held against ``bitpal.batch_fill_plain`` word for word
  (``rehearse_kernels.batch_case``: the texts past each pair's length,
  the rings and the planes seeded with garbage, the flags checked at the
  end): every segment width (nw = 1, 2, 3, 5, 8, 16), one band and
  several (17, 32, 33, 65 words), g = 1..7 (B = 2, 3, 4), pairs of one
  column, a warp whose pairs end far apart, fewer blocks than bands, rings
  of 2 rows, and the grid's blocks at once (a band then waits on the band
  above through its pair's flags).  ``batch_fill_plain`` is held against
  ``tpualign``'s K5 in ``tests/test_torch_batch.py``; here the kernel's
  scores are also held against ``tpualign``'s oracle.
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from tpualign.config import ScoringConfig as JaxScoring
from tpualign.ops import oracle as joracle
from tpualign_torch.config import ScoringConfig
from tpualign_torch.ops import bitpal
from tpualign_torch.probe import read_pairs, serve_pairs

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


@pytest.mark.parametrize("nw, width", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8),
                                       (9, 16), (16, 16)])
@pytest.mark.parametrize("P", [1, 7, 8192])
def test_batch_plan_segments(nw, width, P):
    """Up to 16 words a pair takes a segment of the next power of two
    lanes, 32 / width pairs a warp, a warp a block; no ring."""
    plan = bitpal.batch_plan(P, nw, 150)
    assert plan == bitpal.BatchPlan(width, 1, -(-P * width // 32), 0)


@pytest.mark.parametrize("nw, bands", [(17, 1), (32, 1), (33, 2), (65, 3), (391, 13)])
@pytest.mark.parametrize("P", [1, 16, 100])
def test_batch_plan_bands(nw, bands, P):
    """Past 16 words a pair takes bands of 32 words, a block a band up to
    BLOCKS_PER_SM blocks an SM, and with two bands or more a ring of
    min(bands, blocks + 1) rows."""
    plan = bitpal.batch_plan(P, nw, 25000)
    blocks = min(P * bands, bitpal.SMS * bitpal.BLOCKS_PER_SM)
    depth = 0 if bands == 1 else min(bands, blocks + 1)
    assert plan == bitpal.BatchPlan(bitpal.BAND, bands, blocks, depth)


def test_batch_plan_of_the_two_mixes():
    """Mix (A), the serving demo: 16 pairs, queries of up to 23,701 bases
    (371 words), 12 bands each, a block a band, each pair's ring of 12
    rows.  Mix (B), 8,192 reads of 150 bases: 3 words, segments of 4
    lanes, 8 pairs a warp, 1,024 warps."""
    for (texts, queries), want in (
            (serve_pairs(), bitpal.BatchPlan(32, 12, 192, 12)),
            (read_pairs(), bitpal.BatchPlan(4, 1, 1024, 0))):
        nw = -(-max(map(len, queries)) // bitpal.WORD)
        assert bitpal.batch_plan(len(texts), nw, max(map(len, texts))) == want


@pytest.mark.parametrize("blocks, budget, depth", [
    (1, None, 2), (5, None, 6), (500, None, 13),
    (None, 16 * 25000 * 7, 7), (None, 16 * 25000 * 2, 2),
])
def test_batch_plan_blocks_and_budget(blocks, budget, depth):
    """Fewer blocks than bands keep a shallower ring; a budget cuts it to
    what the 16 rings of 25,000 bytes a row fit, never below 2."""
    plan = bitpal.batch_plan(16, 391, 25000, blocks, budget)
    assert plan.depth == depth
    assert plan.blocks == (blocks or 208)


def test_batch_plan_refuses_rings_past_the_budget():
    with pytest.raises(torch.OutOfMemoryError, match="device memory"):
        bitpal.batch_plan(16, 391, 25000, None, 16 * 25000 * 2 - 1)
    assert bitpal.batch_plan(16, 32, 25000, None, 1).depth == 0  # one band: no ring


@pytest.mark.parametrize("args, match", [
    ((0, 3, 150), "a pair"), ((5, 0, 150), "a word"), ((5, 3, 0), "columns"),
    ((5, 3, 2**31), "columns"), ((5, 40, 150, 0), "at least 1"),
    ((2**30, 65, 150), "int32"),
])
def test_batch_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        bitpal.batch_plan(*args)


def test_batch_fill_on_cpu_takes_blocks_and_runs_the_plain_version():
    """On CPU tensors the wrapper is the plain version whatever the blocks;
    a block count that is no positive int is refused."""
    rng = np.random.default_rng(4)
    texts = torch.from_numpy(rng.integers(0, 5, (3, 40)).astype(np.int8))
    tlen = torch.tensor([40, 1, 17])
    qpad = torch.from_numpy(rng.integers(0, 5, (3, 128)).astype(np.int8))
    eq = bitpal._eq_planes_batch(qpad)
    want = bitpal.batch_fill_plain(texts, tlen, eq, 128, 2)
    before = bitpal.batch_fill.launches
    assert torch.equal(bitpal.batch_fill(texts, tlen, eq, 128, 2, blocks=1), want)
    assert bitpal.batch_fill.launches == before
    with pytest.raises(ValueError, match="blocks"):
        bitpal.batch_fill(texts, tlen, eq, 128, 2, blocks=0)


# the kernel through the shim


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ builds the kernels through the shim")
    sys.path.insert(0, TOOLS)
    try:
        import rehearse_kernels
    finally:
        sys.path.remove(TOOLS)
    dll = rehearse_kernels.build(str(tmp_path_factory.mktemp("shim")), ("bitpal_batch.cu",))
    return rehearse_kernels, dll


def _ragged(rng, P, nw, mt_hi):
    """P query lengths of at most nw words (the last exactly nw) and P text
    lengths in 1..mt_hi (the first 1)."""
    nqs = rng.integers(1, nw * bitpal.WORD + 1, P)
    nqs[-1] = nw * bitpal.WORD - int(rng.integers(0, bitpal.WORD))
    mts = rng.integers(1, mt_hi + 1, P)
    mts[0] = 1
    return nqs, mts


#: nw: every segment width, one band (17, 32 words) and several (33, 65)
NWS = (1, 2, 3, 5, 8, 16, 17, 32, 33, 65)
#: texts of the bands' cases: a band's bottom word lies 2,048 rows below
#: the band above's, and rows that far below the columns saturate (every
#: pair's h_out stream there is the same), so only texts past 2,048
#: columns show one pair's ring or flags read for another's
LONG = 2500


@pytest.mark.parametrize("nw", NWS)
@pytest.mark.parametrize("g", [1, 2, 4])
def test_batch_fill_through_the_shim(shim, g, nw):
    """A ragged batch of 11 pairs (segments: several warps, the last one
    part full), texts up to 200 columns, or LONG in bands (whole steady
    chunks), the planner's blocks."""
    rk, dll = shim
    rng = np.random.default_rng([g, nw])
    nqs, mts = _ragged(rng, 11, nw, 200 if nw <= bitpal.SEGMENT_MAX else LONG)
    ok, where = rk.batch_case(dll, rng, nqs, mts, g)
    assert ok, where


@pytest.mark.parametrize("g", range(1, 8))
@pytest.mark.parametrize("nw", [3, 33])
def test_batch_fill_every_g_through_the_shim(shim, nw, g):
    """g = 1..7 (B = 2, 3, 4) on segments of 4 lanes and on two bands."""
    rk, dll = shim
    rng = np.random.default_rng([nw, g, 1])
    nqs, mts = _ragged(rng, 6, nw, 120)
    ok, where = rk.batch_case(dll, rng, nqs, mts, g, blocks=3)
    assert ok, where


@pytest.mark.parametrize("nw", [1, 3, 8, 16])
def test_batch_fill_segments_end_apart_through_the_shim(shim, nw):
    """A warp whose pairs end far apart (1 to 300 columns): each pair
    freezes at its own text's end, and the warp runs to its longest."""
    rk, dll = shim
    rng = np.random.default_rng([nw, 2])
    P = 32 // (1 << (nw - 1).bit_length()) + 1  # a full warp and one pair more
    nqs = rng.integers(1, nw * bitpal.WORD + 1, P)
    nqs[-1] = nw * bitpal.WORD
    mts = np.resize([1, 300, 2, 150, 33, 1, 64, 7], P)
    ok, where = rk.batch_case(dll, rng, nqs, mts, 2)
    assert ok, where


@pytest.mark.parametrize("nw, blocks", [(65, 1), (65, 2), (65, 5), (33, 1), (130, 3)])
@pytest.mark.parametrize("g", [1, 3])
def test_batch_fill_fewer_blocks_than_bands_through_the_shim(shim, g, nw, blocks):
    """Fewer blocks than one pair's bands, or than the batch's, with each
    pair's ring cut to 2 rows: a reused row's writer waits for its reader."""
    rk, dll = shim
    rng = np.random.default_rng([nw, blocks, g])
    nqs, mts = _ragged(rng, 4, nw, LONG)
    ok, where = rk.batch_case(dll, rng, nqs, mts, g, blocks, shallow=True)
    assert ok, where


@pytest.mark.parametrize("nw, blocks", [(65, 3), (65, None), (33, 2), (3, 2), (16, None)])
def test_batch_fill_blocks_at_once_through_the_shim(shim, nw, blocks):
    """The grid's blocks run at once, rings of 2 rows: a band waits on the
    band above through its own pair's flags, and the pairs' rings and
    flags must not meet (at the planner's blocks every pair's band 0
    writes at once)."""
    rk, dll = shim
    rng = np.random.default_rng([nw, 5])
    nqs, mts = _ragged(rng, 5, nw, LONG if nw > bitpal.SEGMENT_MAX else 150)
    ok, where = rk.batch_case(dll, rng, nqs, mts, 2, blocks, shallow=True, concurrent=True)
    assert ok, where


@pytest.mark.parametrize("nw", [3, 33])
def test_batch_fill_one_column_pairs_and_foreign_codes_through_the_shim(shim, nw):
    """Every pair one column long; codes outside 0..4 match nothing."""
    rk, dll = shim
    rng = np.random.default_rng([nw, 6])
    nqs, _ = _ragged(rng, 9, nw, 1)
    ok, where = rk.batch_case(dll, rng, nqs, np.ones(9, np.int64), 1, lo=-3)
    assert ok, where
    nqs, mts = _ragged(rng, 9, nw, 90)
    ok, where = rk.batch_case(dll, rng, nqs, mts, 3, lo=-3)
    assert ok, where


@pytest.mark.parametrize("nw", [3, 40])
@pytest.mark.parametrize("g", [1, 2, 5])
def test_batch_fill_scores_match_the_reference_oracle(shim, g, nw):
    """Each pair's score from the kernel's planes is ``tpualign``'s oracle
    score under (1, 0, -g)."""
    rk, dll = shim
    rng = np.random.default_rng([g, nw, 7])
    P = 9
    nqs, mts = _ragged(rng, P, nw, 140)
    queries = [rng.integers(0, 5, int(n)).astype(np.int8) for n in nqs]
    texts = [rng.integers(0, 5, int(m)).astype(np.int8) for m in mts]
    m_cap = int(mts.max())
    tpad = torch.zeros((P, m_cap), dtype=torch.int8)
    qpad = torch.full((P, nw * bitpal.WORD), -1, dtype=torch.int8)
    for p in range(P):
        tpad[p, : mts[p]] = torch.from_numpy(texts[p])
        qpad[p, : nqs[p]] = torch.from_numpy(queries[p])
    tlen, nq = torch.from_numpy(mts.astype(np.int64)), torch.from_numpy(nqs.astype(np.int64))
    eq = bitpal._eq_planes_batch(qpad)
    plan = bitpal.batch_plan(P, nw, m_cap, 2)
    ring = torch.zeros((P, max(plan.depth, 1), m_cap), dtype=torch.uint8)
    sync = torch.zeros(1 + P * plan.bands, dtype=torch.int32)
    planes = torch.empty((P, bitpal.n_planes(g), nw), dtype=torch.int64)
    err = dll.bitpal_batch_fill(tpad.data_ptr(), m_cap, tlen.data_ptr(), eq.data_ptr(), P, nw,
                                g, plan.blocks, ring.data_ptr(), plan.depth, sync.data_ptr(),
                                planes.data_ptr(), None)
    assert err == 0
    got = bitpal._batch_scores(planes, tlen, nq, g, ScoringConfig(gap=-g)).tolist()
    cfg = JaxScoring(match=1, mismatch=0, gap=-g)
    assert got == [joracle.score(t, q, cfg) for t, q in zip(texts, queries)]


def test_batch_fill_entry_refusals_through_the_shim(shim):
    """The C entry refuses what the planner refuses: no blocks, g outside
    1..7, bands without flags, two bands without a ring of 2 rows."""
    _, dll = shim
    texts = torch.zeros((2, 10), dtype=torch.int8)
    tlen = torch.tensor([10, 3])
    buf = torch.zeros(2 * 5 * 40, dtype=torch.int64)
    ring = torch.zeros(2 * 2 * 10, dtype=torch.uint8)
    sync = torch.zeros(1 + 2 * 2, dtype=torch.int32)
    out = torch.zeros(2 * 2 * 40, dtype=torch.int64)

    def call(nw, g=1, blocks=1, ring_=ring, depth=2, sync_=sync):
        return dll.bitpal_batch_fill(texts.data_ptr(), 10, tlen.data_ptr(), buf.data_ptr(), 2,
                                     nw, g, blocks, None if ring_ is None else ring_.data_ptr(),
                                     depth, None if sync_ is None else sync_.data_ptr(),
                                     out.data_ptr(), None)

    for bad in (dict(nw=3, blocks=0), dict(nw=3, g=8), dict(nw=3, g=0), dict(nw=0),
                dict(nw=40, sync_=None), dict(nw=40, ring_=None), dict(nw=40, depth=1)):
        assert call(**bad) != 0, bad
    assert call(nw=3, ring_=None, sync_=None) == 0  # segments take no ring and no flags
