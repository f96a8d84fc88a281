"""The staggered fills' pipeline (``tpualign_torch/csrc/bitpal_rc.cu``):
its planner, and its kernels run on the CPU.

- ``bitpal.wave_plan``: ``pipeline_plan`` with ring rows of a byte a step,
  as many as a launch runs (a chunk's ``t_steps``, K3a's ``total_steps``),
  the plans of the family's routes (5 bands at 1M x 10k, 49 at 2M x 100k),
  steps past the int32 flags refused, a ring past the budget raising
  ``torch.OutOfMemoryError``; ``wave_scratch``; the wrappers' ``blocks``.
- ``bitpal_rc_fill`` (K3a), ``bitpal_rc_chunk`` (K3b) and
  ``bitpal_gfill_chunk`` (K4's state in and out) compiled with ``g++``
  through the shim of ``tools/rehearse_kernels.py`` and held word for word
  against ``fill_rc_plain`` and, chunk by chunk, ``chunk_plain`` (planes
  and hand-offs, the ring and the outputs seeded with garbage, the flags
  checked after every launch; ``rehearse_kernels.wave_case``): one band and
  many, blocks forced to 1, 2 and 3 with rings of 2 rows, the grid's blocks
  at once (``rehearse_concurrent(1)``: a band waits on the band above
  through the flags, and ``__stcg`` sleeps first, so a flag published
  before its bytes shows), chunk edges inside a band's dead ramp and
  drain, a random state in, codes outside 0..4, and a band's last steady
  chunk ending on the text's last whole window.  ``fill_rc_plain`` and
  ``chunk_plain`` are held against ``tpualign`` in
  ``tests/test_torch_bitpal_rc.py``; here the kernels' scores are also
  held against ``tpualign``'s oracle.
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
from tpualign_torch.ops import band, bitpal

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")

NWS = (1, 31, 32, 33, 65, 160)


# the planner


@pytest.mark.parametrize("nw", NWS + (1563,))
@pytest.mark.parametrize("steps", [1, 33, 786432])
def test_wave_plan_rows_are_steps(nw, steps):
    """A staggered fill's ring rows hold a byte a step: the plan is
    ``pipeline_plan``'s with the steps as the row's length."""
    plan = bitpal.wave_plan(nw, steps)
    assert plan == bitpal.pipeline_plan(nw, steps)
    assert plan.bands == -(-nw // bitpal.BAND)
    assert plan.depth * steps <= band.RING_BUDGET
    assert plan.depth == (0 if plan.bands == 1 else min(plan.bands, plan.blocks + 1,
                                                         band.RING_BUDGET // steps))


@pytest.mark.parametrize("m, n, g, kind, bands, launches, steps", [
    (20000, 20000, 1, "rc", 10, 1, 5000 + 312),  # 313 words
    (1000000, 10000, 1, "rc", 5, 1, 250000 + 156),  # 157 words, 10k the query
    (4000000, 2000, 1, "rc_chunk", 1, 6, 196608),  # 32 words, chunks of 196,608
    (2000000, 200, 1, "rc_chunk", 1, 3, 196608),
    (2000000, 100000, 2, "g_chunk", 49, 3, 786432),  # 1,563 words
])
def test_route_plans(m, n, g, kind, bands, launches, steps):
    """The family's routes on the pipeline: the route's launches, each over
    ``wave_plan``'s bands and ring rows of its steps."""
    got_kind, rc, s1q = bitpal.route(m, n, ScoringConfig(gap=-g))
    assert got_kind == kind
    nq, mt = (m, n) if s1q else (n, m)
    nw = -(-nq // bitpal.WORD)
    total = bitpal.total_steps(mt, nw, rc)
    t_steps = total if kind == "rc" else bitpal.chunk_steps(rc)
    assert -(-total // t_steps) == launches and t_steps == steps
    plan = bitpal.wave_plan(nw, t_steps)
    assert (plan.bands, plan.blocks) == (bands, bands)
    assert plan.depth == (0 if bands == 1 else bands)


def test_wave_plan_refuses_steps_past_the_flags():
    """The progress flags count steps in int32."""
    assert bitpal.wave_plan(1, 2**31 - 1).bands == 1
    for steps in (2**31, -1):
        with pytest.raises(ValueError, match="steps a launch"):
            bitpal.wave_plan(40, steps)


def test_wave_plan_refuses_a_ring_past_the_budget():
    """Two rows of the launch's steps past the budget is the card's memory
    running short: ``torch.OutOfMemoryError``, no ValueError that a route
    would take for a refusal."""
    with pytest.raises(torch.OutOfMemoryError, match="device memory") as err:
        bitpal.wave_plan(33, 786432, None, 2 * 786432 - 1)
    assert not isinstance(err.value, ValueError)
    assert bitpal.wave_plan(33, 786432, None, 2 * 786432).depth == 2
    assert bitpal.wave_plan(32, 786432, None, 0).depth == 0  # one band: no ring


@pytest.mark.parametrize("nw, steps, blocks, want", [
    (160, 200, None, (5, 5, 5)), (160, 200, 1, (1, 5, 2)), (160, 200, 3, (3, 5, 4)),
    (33, 1, None, (2, 2, 2)), (1, 0, None, (1, 1, 0)),
])
def test_wave_scratch(monkeypatch, nw, steps, blocks, want):
    """The plan within ``band.ring_budget`` of the device, a ring of
    ``depth`` rows of ``steps`` bytes (none with one band) and zeroed
    flags, a ticket and a progress flag a band."""
    monkeypatch.setattr(band, "ring_budget", lambda *a, **kw: band.RING_BUDGET)
    plan, ring, sync = bitpal.wave_scratch(nw, steps, "cpu", blocks)
    assert tuple(plan) == want
    assert (ring is None) == (plan.depth == 0)
    if ring is not None:
        assert ring.dtype == torch.uint8 and tuple(ring.shape) == (plan.depth, steps)
    assert sync.dtype == torch.int32 and sync.tolist() == [0] * (plan.bands + 1)


@pytest.mark.parametrize("blocks", [0, -2, 1.5, "2"])
def test_wrappers_refuse_bad_blocks(blocks):
    text = torch.ones(10, dtype=torch.int8)
    eq = bitpal._eq_planes(torch.ones(70, dtype=torch.int8), 70)
    state = bitpal.init_state(2, 1, "cpu")
    for call in (lambda: bitpal.fill_rc(text, eq, 70, 2, blocks),
                 lambda: bitpal.fill_rc_chunk(text, eq, 70, 2, 0, 4, state, blocks),
                 lambda: bitpal.fill_g_chunk(text, eq, 70, 1, 0, 4, state, blocks)):
        with pytest.raises(ValueError, match="blocks"):
            call()


# the kernels through the shim


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ builds the kernels through the shim")
    sys.path.insert(0, TOOLS)
    try:
        import rehearse_kernels
    finally:
        sys.path.remove(TOOLS)
    dll = rehearse_kernels.build(str(tmp_path_factory.mktemp("shim")), ("bitpal_rc.cu",))
    return rehearse_kernels, dll


def _nq(nw):
    return bitpal.WORD * nw - (nw * 7) % bitpal.WORD  # a partial last word at most nw


#: (blocks, ring of 2): the planner's, and blocks forced below the bands
BLOCKS = [(None, False), (1, True), (2, True), (3, True)]
#: chunk lengths cycled: 1, 31, 32, 33 put edges inside the bands' dead
#: ramps (band b's first live step is 32b + 1) and the drain; odd ones
LENGTHS = [[1, 31, 32, 33], [33, 32, 31, 1], [5, 17, 63]]


@pytest.mark.parametrize("nw", NWS)
@pytest.mark.parametrize("rc", [2, 3, 4])
def test_rc_fill_and_chunks_through_the_shim(shim, nw, rc):
    """K3a's ``bitpal_rc_fill`` against ``fill_rc_plain``, and K3b's
    ``bitpal_rc_chunk`` chunk by chunk against ``chunk_plain``, planes and
    hand-offs word for word, at forced block counts with rings of 2 rows."""
    rk, dll = shim
    rng = np.random.default_rng([nw, rc])
    blocks, shallow = BLOCKS[(nw + rc) % len(BLOCKS)]
    ok, where = rk.wave_case(dll, rng, _nq(nw), int(rng.integers(20, 90)), 1, rc,
                             LENGTHS[nw % 3], blocks, shallow)
    assert ok, where


@pytest.mark.parametrize("nw", NWS)
@pytest.mark.parametrize("g", range(1, 8))
def test_gfill_chunks_through_the_shim(shim, nw, g):
    """K4's state in and out, ``bitpal_gfill_chunk`` (B = 2, 3, 4), chunk
    by chunk against ``chunk_plain`` at forced block counts."""
    rk, dll = shim
    rng = np.random.default_rng([nw, g, 1])
    blocks, shallow = BLOCKS[(nw + g) % len(BLOCKS)]
    ok, where = rk.wave_case(dll, rng, _nq(nw), int(rng.integers(20, 90)), g, 1,
                             LENGTHS[(nw + g) % 3], blocks, shallow)
    assert ok, where


@pytest.mark.parametrize("rc, g, blocks", [
    (1, 1, None), (1, 2, 2), (1, 5, 3), (2, 1, 2), (3, 1, None), (4, 1, 3),
])
def test_bands_at_once_through_the_shim(shim, rc, g, blocks):
    """The grid's blocks at once: each band waits on the band above
    through the flags, the ring cut to 2 rows, 5 bands.  Launches of 2 and
    34 steps end 2 steps past a publish of 32: a fetch that waits for 2
    steps too few reads bytes the band above has not yet written."""
    rk, dll = shim
    rng = np.random.default_rng([rc, g, 2])
    ok, where = rk.wave_case(dll, rng, _nq(160), 60, g, rc, [1, 2, 31, 32, 33, 34, 45], blocks,
                             shallow=True, concurrent=True)
    assert ok, where


@pytest.mark.parametrize("rc, g", [(1, 1), (1, 3), (1, 7), (2, 1), (3, 1), (4, 1)])
@pytest.mark.parametrize("blocks", [None, 2])
def test_random_state_through_the_shim(shim, rc, g, blocks):
    """A chunk from a state of random planes and whole random hand-off
    bytes (junk in their high bits, and in a state no fill reaches): the
    kernels read each byte's RC*B bits as ``chunk_plain`` does."""
    rk, dll = shim
    rng = np.random.default_rng([rc, g, 3])
    ok, where = rk.wave_case(dll, rng, _nq(65), 50, g, rc, [7, 32, 40], blocks,
                             shallow=blocks is not None, junk=True)
    assert ok, where


@pytest.mark.parametrize("rc, g", [(1, 1), (1, 4), (2, 1), (4, 1)])
def test_codes_outside_the_alphabet_through_the_shim(shim, rc, g):
    """Code 0 matches code 0; codes outside 0..4 match nothing."""
    rk, dll = shim
    rng = np.random.default_rng([rc, g, 4])
    ok, where = rk.wave_case(dll, rng, _nq(40), 70, g, rc, [9, 33], 2, lo=-3)
    assert ok, where


@pytest.mark.parametrize("mt", [0, 1])
@pytest.mark.parametrize("rc", [1, 4])
def test_short_texts_through_the_shim(shim, mt, rc):
    """No text column (only dead steps: the planes stay at the boundary,
    the hand-offs move) and one."""
    rk, dll = shim
    rng = np.random.default_rng([mt, rc, 5])
    ok, where = rk.wave_case(dll, rng, _nq(70), mt, 2, rc, [1, 31, 33], 2, shallow=True)
    assert ok, where


@pytest.mark.parametrize("rc, mt", [
    (1, 95),  # band 0's last steady chunk ends on window 94, word 0 not saturated
    (2, 2 * 1023 + 1), (3, 3 * 671 + 1), (4, 4 * 511 + 1),  # band 1's, near the diagonal
])
def test_last_steady_chunk_through_the_shim(shim, rc, mt):
    """A band's last chunk of steady steps ends right before the step whose
    lane 0 reaches the text's last (partial) window: a steady range one
    step too long runs that window unchecked.  Band 1's lane 0 (rows from
    2,049) sits near the DP's diagonal at ~2,000 columns, where a dead
    column still moves the planes."""
    rk, dll = shim
    rng = np.random.default_rng([rc, mt])
    ok, where = rk.wave_case(dll, rng, 64 * 40, mt, 2, rc, [5000])
    assert ok, where


@pytest.mark.parametrize("rc, g", [(4, 1), (2, 1), (1, 2), (1, 5)])
def test_scores_match_the_reference_oracle(shim, rc, g):
    """The kernels' final planes over three bands give ``tpualign``'s
    oracle score: one ``bitpal_rc_fill`` launch (rc > 1) or chunks of
    ``bitpal_gfill_chunk`` in turn."""
    rk, dll = shim
    rng = np.random.default_rng([rc, g, 6])
    nq, mt = 2 * 2048 + 500, 300
    query, text = rng.integers(0, 5, nq).astype(np.int8), rng.integers(0, 5, mt).astype(np.int8)
    nw = -(-nq // bitpal.WORD)
    eq = bitpal._eq_planes(torch.from_numpy(query), nq)
    t = torch.from_numpy(text)
    total = bitpal.total_steps(mt, nw, rc)
    t_steps = total if rc > 1 else 101
    plan = bitpal.wave_plan(nw, t_steps, 2)
    ring = torch.zeros((plan.depth, t_steps), dtype=torch.uint8)
    sync = torch.zeros(plan.bands + 1, dtype=torch.int32)
    if rc > 1:
        planes = torch.empty((2, nw), dtype=torch.int64)
        assert dll.bitpal_rc_fill(t.data_ptr(), eq.data_ptr(), mt, nw, rc, plan.blocks,
                                  ring.data_ptr(), plan.depth, sync.data_ptr(),
                                  planes.data_ptr(), None) == 0
    else:
        state = bitpal.init_state(nw, g, "cpu")
        planes, hand = torch.stack(state.planes), state.hand
        for t0 in range(0, total, t_steps):
            steps = min(t_steps, total - t0)
            v_out, h_out = torch.empty_like(planes), torch.empty_like(hand)
            sync.zero_()
            assert dll.bitpal_gfill_chunk(t.data_ptr(), eq.data_ptr(), mt, nw, g, plan.blocks,
                                          ring.data_ptr(), plan.depth, sync.data_ptr(), t0,
                                          steps, planes.data_ptr(), hand.data_ptr(),
                                          v_out.data_ptr(), h_out.data_ptr(), None) == 0
            planes, hand = v_out, h_out
    unit = int(bitpal._reduce_score(planes.unbind(0), nq, mt, g))
    assert unit == joracle.score(text, query, JaxScoring(match=1, mismatch=0, gap=-g))


def test_entries_refuse_what_the_kernel_does_not_take(shim):
    """The C entries return cudaErrorInvalidValue (1) for a launch they do
    not take, before any band runs: no block, no ring with two bands, a
    ring of one row, steps past the int32 flags, rc or g outside range."""
    _, dll = shim
    t = torch.zeros(50, dtype=torch.int8)
    eq = torch.zeros((5, 40), dtype=torch.int64)
    ring = torch.zeros((2, 100), dtype=torch.uint8)
    sync = torch.zeros(3, dtype=torch.int32)
    planes = torch.zeros((4, 40), dtype=torch.int64)
    hand = torch.zeros(40, dtype=torch.uint8)
    p, r, s = planes.data_ptr(), ring.data_ptr(), sync.data_ptr()

    def fill(rc=4, blocks=2, ring_=r, depth=2, mt=50):
        return dll.bitpal_rc_fill(t.data_ptr(), eq.data_ptr(), mt, 40, rc, blocks, ring_, depth,
                                  s, p, None)

    def chunk(entry, r_or_g, steps=20, blocks=2, ring_=r, depth=2, t0=0):
        return entry(t.data_ptr(), eq.data_ptr(), 50, 40, r_or_g, blocks, ring_, depth, s, t0,
                     steps, p, hand.data_ptr(), p, hand.data_ptr(), None)

    assert fill() == 0 and sync[1].item() == bitpal.total_steps(50, 40, 4)
    for bad in (fill(rc=1), fill(rc=5), fill(blocks=0), fill(ring_=None), fill(depth=1),
                fill(mt=-1)):
        assert bad == 1
    for entry, r_or_g in ((dll.bitpal_rc_chunk, 3), (dll.bitpal_gfill_chunk, 2)):
        sync.zero_()
        assert chunk(entry, r_or_g) == 0
        for bad in (chunk(entry, r_or_g, steps=0), chunk(entry, r_or_g, steps=2**31),
                    chunk(entry, r_or_g, blocks=0), chunk(entry, r_or_g, depth=1),
                    chunk(entry, r_or_g, t0=-1), chunk(entry, 8)):
            assert bad == 1
    assert chunk(dll.bitpal_rc_chunk, 1) == 1
