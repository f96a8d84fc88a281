"""The bit-parallel fills' pipeline (``tpualign_torch.ops.bitpal``): its
planner, and its kernel run on the CPU.

- ``pipeline_plan``: bands of 32 words, blocks of one warp, the ring's
  depth within its budget, ``row_owner`` (the band and lane that store a
  captured row), ``band_edge_rows``, the refusals of shapes and block
  counts the kernel does not take, and a ring past the device's memory,
  which raises ``torch.OutOfMemoryError`` and which ``api`` does not
  reroute to another engine.
- ``bitpal_gfill`` and ``bitpal_capture_fill``
  (``tpualign_torch/csrc/bitpal_gfill.cu``) compiled with ``g++`` through
  the shim of ``tools/rehearse_kernels.py`` and held against
  ``bitpal.fill_g_plain`` (planes word for word, captures byte for byte,
  the ring and the outputs seeded with garbage) at forced block counts:
  several bands, bands past the blocks, rings of 2 rows, captured rows on
  band edges, B = 2, 3 and 4.  The shim runs a grid's blocks one after
  another unless asked to run them at once: then a band waits on the band
  above through the ring's flags as on the card, and its stores through
  ``__stcg`` sleep first, so that a flag published before its bytes
  shows.  ``fill_g_plain`` is held against
  ``tpualign``'s K2 and K4 in ``tests/test_torch_bitpal_g.py``; here the
  kernel's scores are also held against ``tpualign``'s oracle.
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
from tpualign_torch import api
from tpualign_torch.config import EngineConfig, ScoringConfig
from tpualign_torch.ops import band, band_align, bitpal, pallas_diag

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")

NWS = (1, 31, 32, 33, 1989, 16384)


@pytest.mark.parametrize("nw", NWS)
@pytest.mark.parametrize("mt", [1, 300, 126440])
def test_pipeline_plan_default_blocks(nw, mt):
    """A band a block, up to BLOCKS_PER_SM blocks an SM; one band needs no
    ring, more a ring of min(bands, blocks + 1) rows."""
    plan = bitpal.pipeline_plan(nw, mt)
    bands = -(-nw // bitpal.BAND)
    assert plan.bands == bands
    assert 1 <= plan.blocks == min(bands, bitpal.SMS * bitpal.BLOCKS_PER_SM)
    assert plan.depth == (0 if bands == 1 else min(bands, plan.blocks + 1))


@pytest.mark.parametrize("nw", NWS)
def test_bands_cover_every_word_once(nw):
    """Every word has one owner (band, lane); the bands tile the words, the
    last one partial at most."""
    plan = bitpal.pipeline_plan(nw, 1000)
    assert (plan.bands - 1) * bitpal.BAND < nw <= plan.bands * bitpal.BAND
    owners = [bitpal.row_owner(bitpal.WORD * w + r) for w in range(nw) for r in (1, 64)]
    assert len(set(owners)) == nw
    for x, (s, t) in enumerate(owners):
        assert 0 <= s < plan.bands and 0 <= t < 32
        assert s * bitpal.BAND + t == x // 2


@pytest.mark.parametrize("row, want", [
    (1, (0, 0)), (64, (0, 0)), (65, (0, 1)),
    (2048, (0, 31)), (2049, (1, 0)),  # a band's last and first word
    (4096, (1, 31)), (4097, (2, 0)),
    (64 * 70 + 5, (2, 6)), (64 * 71, (2, 6)), (64 * 100 + 1, (3, 4)),
    (64 * 300 + 64, (9, 12)), (126440, (61, 23)),
])
def test_row_owner(row, want):
    """A captured row is stored by the lane that owns its word: 64 rows a
    word, a word a lane, 32 words a band."""
    assert bitpal.row_owner(row) == want


@pytest.mark.parametrize("nq", [1, 2047, 2048, 2049, 4096, 4161, 5000, 126440])
def test_band_edge_rows_sit_on_band_edges(nq):
    """The rows lie in 1..nq, take row 1 and row nq, and every band edge
    that the query reaches among the first two bands' (their last lane's
    first and last row, the next band's first lane's first row)."""
    rows = bitpal.band_edge_rows(nq)
    assert rows == sorted(set(rows)) and rows[0] == 1 and rows[-1] == nq
    for edge in (2048, 4096):
        for r in (edge - 63, edge, edge + 1):
            assert (r in rows) == (r <= nq)
            if r <= nq:
                band_no, lane = bitpal.row_owner(r)
                assert lane == (31 if r <= edge else 0)


@pytest.mark.parametrize("nw, blocks, budget, want", [
    (1989, None, None, (63, 63, 63)),  # every band its block: a row a band
    (1989, 10, None, (10, 63, 11)),  # bands past the blocks
    (1989, 1, None, (1, 63, 2)),  # one block walks every band
    (1989, 200, None, (200, 63, 63)),  # blocks past the bands
    (1989, None, 5 * 1000, (63, 63, 5)),  # the budget cuts the ring
    (1989, None, 2 * 1000, (63, 63, 2)),
    (33, None, None, (2, 2, 2)),
    (32, None, None, (1, 1, 0)),  # one band: no ring
    (16384, None, None, (512, 512, 512)),
    (16384, 256, None, (256, 512, 257)),
    (16896 + 1, None, None, (528, 529, 529)),  # past the card's blocks
])
def test_pipeline_plan_blocks_and_depth(nw, blocks, budget, want):
    """The ring holds min(bands, blocks + 1) rows of mt bytes within the
    budget, and none with one band."""
    plan = bitpal.pipeline_plan(nw, 1000, blocks, budget)
    assert (plan.blocks, plan.bands, plan.depth) == want


@pytest.mark.parametrize("nw", NWS)
def test_pipeline_plan_ring_stays_in_budget(nw):
    for mt, budget in ((126440, None), (126440, 10 * 126440), (2_000_000, 3 * 2_000_000),
                       (5, 64)):
        plan = bitpal.pipeline_plan(nw, mt, None, budget)
        limit = band.RING_BUDGET if budget is None else budget
        assert plan.depth * mt <= limit
        assert plan.depth == (0 if plan.bands == 1 else min(plan.bands, plan.blocks + 1,
                                                             limit // mt))


def test_pipeline_plan_refuses_a_ring_past_the_budget():
    """Two rows past the budget is the card's memory running short, not a
    refusal of the shape: no ValueError, which the api would reroute."""
    with pytest.raises(torch.OutOfMemoryError, match="device memory") as err:
        bitpal.pipeline_plan(1989, 126440, None, 2 * 126440 - 1)
    assert not isinstance(err.value, ValueError)
    # one band needs no ring, whatever the budget
    assert bitpal.pipeline_plan(32, 126440, None, 0).depth == 0


@pytest.mark.parametrize("args, match", [
    ((1000, 100, 0), "at least 1"), ((1000, 100, -3), "at least 1"),
    ((0, 100, None), "a word of query rows"), ((-5, 100, 4), "a word of query rows"),
    ((10, -1, None), "texts of"), ((10, 2**31, None), "texts of"),
])
def test_pipeline_plan_refuses_bad_geometry(args, match):
    with pytest.raises(ValueError, match=match):
        bitpal.pipeline_plan(*args)


def test_kernel_geometry_keeps_the_routing_rule():
    """The one-block geometry stays the family's routing rule: the
    pipelined fill takes any number of words, the router still refuses a
    query past MAX_THREADS * MAX_K words on both sides."""
    assert bitpal.pipeline_plan(16385, 100).bands >= 1
    with pytest.raises(ValueError, match="one-block"):
        bitpal.kernel_geometry(16385)
    with pytest.raises(ValueError, match="both sequences"):
        bitpal._orientation(16385 * bitpal.WORD, 16385 * bitpal.WORD)


@pytest.mark.parametrize("entry", ["align_score", "align"])
def test_a_ring_past_device_memory_is_not_rerouted(monkeypatch, entry):
    """With the ring's budget cut below 2 rows, the family's fills plan as
    the CUDA wrappers do (``pipeline_plan`` within ``band.ring_budget``)
    and raise ``torch.OutOfMemoryError``; neither ``align_score`` nor
    ``align`` hands the pair to another engine."""
    monkeypatch.setattr(band, "ring_budget", lambda *a, **kw: 1)

    def planned(text, eq, *args, **kwargs):
        bitpal.pipeline_plan(eq.shape[1], text.shape[0], None, band.ring_budget(text.device))
        raise AssertionError("a ring of 2 rows fit a budget of 1 byte")

    def rerouted(*args, **kwargs):
        raise AssertionError("the pair went to another engine")

    for mod, name, fn in ((bitpal, "fill_g", planned), (bitpal, "capture_fill", planned),
                          (pallas_diag, "score", rerouted), (band_align, "align_global", rerouted)):
        monkeypatch.setattr(mod, name, fn)
    rng = np.random.default_rng(3)
    # 4,200 x 4,200 (1, 0, -2): two bands; past the full table for align
    s1, s2 = (rng.integers(1, 5, 4200).astype(np.int8) for _ in range(2))
    engine, cfg = EngineConfig(device="cpu"), ScoringConfig(gap=-2)
    with pytest.raises(torch.OutOfMemoryError, match="device memory"):
        getattr(api, entry)(s1, s2, cfg, engine)


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
    dll = rehearse_kernels.build(str(tmp_path_factory.mktemp("shim")), ("bitpal_gfill.cu",))
    return rehearse_kernels, dll


#: (nq, mt, blocks, ring of 2): nw = 1, 31, 32, 33 words at one band;
#: several bands over as many blocks, over fewer blocks (one block walks
#: them), over more blocks; rings of 2 rows; texts of whole steady chunks
#: (mt past 96) and of none
SHIM_CASES = [
    (1, 7, None, False), (31 * 64 - 5, 40, None, False), (32 * 64, 40, None, False),
    (33 * 64 - 63, 40, None, False), (40 * 64, 150, 2, False),
    (100 * 64 + 3, 190, None, False), (100 * 64 + 3, 190, 1, True),
    (100 * 64 + 3, 90, 2, True), (100 * 64 + 3, 90, 9, False),
    (150 * 64, 270, 2, True), (150 * 64, 170, None, False),
    (200 * 64 - 1, 45, 1, True), (300 * 64, 333, 3, False),
]


@pytest.mark.parametrize("case", range(len(SHIM_CASES)))
@pytest.mark.parametrize("g", [1, 2, 4])
def test_gfill_through_the_shim(shim, g, case):
    """``bitpal_gfill`` (B = 2, 3, 4) and ``bitpal_capture_fill`` with rows
    on the bands' first and last words, word for word against
    ``fill_g_plain``; the flags end at every band's last column."""
    rk, dll = shim
    nq, mt, blocks, shallow = SHIM_CASES[case]
    rng = np.random.default_rng([g, case])
    ok, where = rk.gfill_case(dll, rng, nq, mt, g, blocks, None, shallow)
    assert ok, where
    ok, where = rk.gfill_case(dll, rng, nq, mt, g, blocks, bitpal.band_edge_rows(nq), shallow)
    assert ok, where


@pytest.mark.parametrize("nq, mt, g, blocks", [
    (100 * 64 + 3, 120, 1, None), (100 * 64 + 3, 120, 3, 2),
    (150 * 64, 200, 3, 9), (9000, 300, 7, 3),
])
def test_gfill_bands_at_once_through_the_shim(shim, nq, mt, g, blocks):
    """The blocks run at once: each band waits on the band above through the
    flags, the ring cut to 2 rows."""
    rk, dll = shim
    rng = np.random.default_rng([nq, mt, g])
    ok, where = rk.gfill_case(dll, rng, nq, mt, g, blocks, bitpal.band_edge_rows(nq),
                              shallow=True, concurrent=True)
    assert ok, where


@pytest.mark.parametrize("mt", [0, 1])
def test_gfill_short_texts_through_the_shim(shim, mt):
    """No live column (mt = 0: the planes stay at the boundary) and one."""
    rk, dll = shim
    rng = np.random.default_rng(mt)
    ok, where = rk.gfill_case(dll, rng, 5000, mt, 2, 2, [1, 2048, 2049, 5000])
    assert ok, where


def test_gfill_codes_outside_the_alphabet_through_the_shim(shim):
    """Code 0 matches code 0; codes outside 0..4 match nothing."""
    rk, dll = shim
    rng = np.random.default_rng(9)
    ok, where = rk.gfill_case(dll, rng, 3000, 180, 1, None, [1, 2048, 2049], lo=-3)
    assert ok, where


@pytest.mark.parametrize("g", [1, 2, 5])
def test_gfill_scores_match_the_reference_oracle(shim, g):
    """The kernel's final column over three bands gives ``tpualign``'s
    oracle score."""
    rk, dll = shim
    rng = np.random.default_rng(g)
    nq, mt = 2 * 2048 + 500, 300
    query, text = rng.integers(0, 5, nq).astype(np.int8), rng.integers(0, 5, mt).astype(np.int8)
    nw = -(-nq // bitpal.WORD)
    plan = bitpal.pipeline_plan(nw, mt, 2)
    eq = bitpal._eq_planes(torch.from_numpy(query), nq)
    t = torch.from_numpy(text)
    ring = torch.zeros((plan.depth, mt), dtype=torch.uint8)
    sync = torch.zeros(plan.bands + 1, dtype=torch.int32)
    planes = torch.empty((bitpal.n_planes(g), nw), dtype=torch.int64)
    err = dll.bitpal_gfill(t.data_ptr(), eq.data_ptr(), mt, nw, g, plan.blocks, ring.data_ptr(),
                           plan.depth, sync.data_ptr(), planes.data_ptr(), None)
    assert err == 0
    unit = int(bitpal._reduce_score(planes.unbind(0), nq, mt, g))
    cfg = JaxScoring(match=1, mismatch=0, gap=-g)
    assert unit == joracle.score(text, query, cfg)
