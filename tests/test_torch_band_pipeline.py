"""The band fills' pipeline (``tpualign_torch.ops.band``): its planner, and
its kernels run on the CPU.

- ``pipeline_geometry`` and ``pipeline_plan``: strips, blocks, the ring's
  depth, its memory budget (``RING_BUDGET`` by default, ``ring_budget``'s
  share of the card's free memory in the CUDA wrappers) and the refusals
  of geometries the kernels do not take and of rings past the budget.
- ``ring_budget``'s cache of a card's usable bytes and ``ringed``, the
  wrappers' one way to plan and allocate: the driver and PyTorch's caching
  allocator monkeypatched (``FakeCard``), the budgets and the four cells'
  plans held to the per-call formula ``RING_SHARE * (free + reserved -
  allocated)``, one query a device, and a fresh query after an
  ``OutOfMemoryError``.
- ``tile_geometry``, ``tile_steps`` and ``TILE_W``: K6's tiled fill's
  planner, its step count and its tile widths, the kernel's own.
- ``band_fill``, ``band_capture_fill``, ``band_capture_affine`` and
  ``band_batch_fill`` (``tpualign_torch/csrc/band_*.cu``) compiled with
  ``g++`` through the shim of ``tools/rehearse_kernels.py`` and held
  against their plain versions (``band.score_plain``,
  ``band.capture_plain``, ``xla.score_batch``) at geometries of one block,
  of blocks past the strips and of fewer blocks than strips, with rings cut
  to 2 rows.  The shim runs a grid's blocks one after another, so the first
  block takes every strip: this checks the strip arithmetic, the ring's
  slots, the progress flags' values and the located cell's reduction over
  blocks, not their timing, which only the card shows (``chip_smoke.py``).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpualign_torch import matrices, trace
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import band, bitpal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
CSRC = os.path.join(ROOT, "tpualign_torch", "csrc")


@pytest.mark.parametrize("n, k, threads, want", [
    (1, 1, 32, 1), (32, 1, 32, 1), (33, 1, 32, 2), (126440, 8, 128, 124), (126440, 16, 64, 124),
    (20000, 4, 64, 79),
])
def test_strips(n, k, threads, want):
    assert band.strips(n, k, threads) == want


@pytest.mark.parametrize("n, m, max_k", [
    (1, 1, 16), (5, 1000, 16), (31, 7, 8), (700, 900, 16), (20000, 20000, 16),
    (20000, 20000, 8), (63620, 126440, 16), (126440, 127240, 16), (126440, 127240, 8),
    (1_000_000, 300, 16), (300, 1_000_000, 16),
])
def test_pipeline_geometry_is_a_geometry_the_kernels_take(n, m, max_k):
    k, threads, blocks = band.pipeline_geometry(n, m, max_k)
    S = band.strips(n, k, threads)
    assert k in band.KS and k <= max_k
    assert threads % band.WARP == 0 and band.WARP <= threads <= band.PIPE_THREADS
    assert 1 <= blocks == min(S, band.SMS * band.BLOCKS_PER_SM)
    if S == 1:  # one strip: no more warps than its rows need
        assert threads - band.WARP < -(-n // k)
    plan = band.pipeline_plan(n, m, False, None, max_k)
    assert (plan.k, plan.threads, plan.blocks, plan.strips) == (k, threads, blocks, S)


@pytest.mark.parametrize("n, m, max_k, want", [
    (126440, 127240, 16, (8, 128, 124)),
    (63620, 126440, 16, (4, 128, 125)),
    (127240, 126440, 8, (8, 128, 125)),
    (20000, 20000, 16, (8, 128, 20)),
    (5, 1000, 16, (1, 32, 1)),
    (1000, 5, 16, (16, 64, 1)),
])
def test_pipeline_geometry_pins(n, m, max_k, want):
    """The cost model's choices at the main paths' shapes (the 64gb shape's
    SW fill, affine root fill and local affine locate, 20k, a short and a
    narrow table)."""
    assert band.pipeline_geometry(n, m, max_k) == want


@pytest.mark.parametrize("n, m", [(126440, 127240), (63620, 126440), (20000, 20000),
                                  (3000, 500_000)])
def test_pipeline_geometry_cost_model(n, m):
    """The chosen k is the cheapest under the docstring's model."""
    k, threads, blocks = band.pipeline_geometry(n, m)

    def cost(k):
        S = band.strips(n, k, threads)
        G = min(S, band.SMS * band.BLOCKS_PER_SM)
        steps = -(-S // G) * (m + threads) + (G - 1) * (threads + 2 * band.PUBLISH)
        return steps * (band.STEP_OVERHEAD + k * -(-G // band.SMS))

    assert all(cost(k) <= cost(other) for other in band.KS)


@pytest.mark.parametrize("n, m, want", [
    (126440, 127240, (8, 128, 124)), (20000, 20000, (8, 128, 20)), (5, 1000, (1, 32, 1)),
    (1000, 5, (16, 64, 1)),
])
def test_tile_geometry_pins(n, m, want):
    """K6's tiled fill's choices at the 64gb shape's SW score, 20k, a short
    and a narrow table (the first two the fastest of the geometries swept
    on the H100, PERF.md)."""
    assert band.tile_geometry(n, m) == want


@pytest.mark.parametrize("n, m, max_k", [(126440, 127240, 16), (63620, 126440, 16),
                                         (20000, 20000, 8), (3000, 500_000, 16),
                                         (1_000_000, 300, 16), (300, 1_000_000, 16)])
def test_tile_geometry_cost_model(n, m, max_k):
    """The chosen geometry is the cheapest under the docstring's model over
    every k up to ``max_k`` and every thread count of TILE_THREADS."""
    k, threads, blocks = band.tile_geometry(n, m, max_k)

    def cost(k, T):
        W = band.TILE_W[k]
        T = min(T, band.WARP * -(-(-(-n // k)) // band.WARP))
        S = band.strips(n, k, T)
        G = min(S, band.SMS * band.BLOCKS_PER_SM)
        steps = -(-S // G) * (-(-m // W) + T) + (G - 1) * (T + 2 * band.PUBLISH // W)
        warps = -(-G // band.SMS) * T // band.WARP
        return steps * (band.TILE_STEP_NS + band.TILE_CELL_NS * k * W * -(-warps // 4))

    assert k <= max_k and blocks == min(band.strips(n, k, threads), band.SMS * band.BLOCKS_PER_SM)
    assert all(cost(k, threads) <= cost(other, T) for other in band.KS if other <= max_k
               for T in band.TILE_THREADS)


def test_tile_steps_at_the_64gb_shape():
    """The step count that ``band_fill`` adds to its counter
    ``band_fill.steps`` at the 64gb shape's SW score: 124 strips of 8 x 128
    rows on 124 blocks, 15,905 tiles of 8 columns, each strip 128 + 8 steps
    behind the one above."""
    n, m = 126440, 127240
    plan = band.score_plan(n, m, False)
    assert tuple(plan)[:4] == (8, 128, 124, 124)
    assert band.tile_steps(n, m, plan.k, plan.threads, plan.blocks) == (
        (15905 + 128) + 123 * (128 + 8)) == 32761
    # blocks past the strips run no more steps; fewer take their strips in turn
    assert band.tile_steps(n, m, 8, 128, 500) == 32761
    assert band.tile_steps(n, m, 8, 128, 62) == 2 * (15905 + 128) + 61 * 136


def test_tile_w_is_the_kernels(tmp_path):
    """TILE_W is the tile width that ``csrc/band_fill.cuh`` compiles at each
    k (its ``tile_w``), read by g++ through the shim's headers."""
    if shutil.which("g++") is None:
        pytest.skip("g++ reads tile_w through the shim")
    sys.path.insert(0, TOOLS)
    try:
        import rehearse_kernels
    finally:
        sys.path.remove(TOOLS)
    (tmp_path / "cuda").mkdir()
    (tmp_path / "cuda_runtime.h").write_text(rehearse_kernels.SHIM)
    (tmp_path / "cuda" / "atomic").write_text(rehearse_kernels.CUDA_ATOMIC)
    with open(os.path.join(CSRC, "band_fill.cuh")) as f:  # its launches as the shim's
        head = rehearse_kernels.LAUNCH.sub(r"shim::launch(\2, \3, [&] { \1(\5); });", f.read())
    (tmp_path / "band_fill.cuh").write_text(head)
    src = tmp_path / "tile_w.cpp"
    src.write_text('#include <cstdio>\n#include "band_fill.cuh"\n'
                   'int main() { for (int k : {1, 2, 4, 8, 16}) std::printf("%d ", tile_w(k)); }\n')
    exe = tmp_path / "tile_w"
    subprocess.run(["g++", "-std=c++20", "-I", str(tmp_path), "-o", str(exe), str(src),
                    "-lpthread"], check=True)
    widths = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout
    assert [int(w) for w in widths.split()] == [band.TILE_W[k] for k in band.KS]


@pytest.mark.parametrize("geometry, affine, want", [
    ((8, 128), False, (8, 128, 124, 124, 124)),  # blocks default: every strip
    ((8, 128, 1), False, (8, 128, 1, 124, 2)),  # one block: a ring of 2 rows
    ((8, 128, 500), True, (8, 128, 500, 124, 124)),  # blocks past the strips
    ((8, 128, 40), False, (8, 128, 40, 124, 41)),  # fewer blocks than strips
    ((16, 256), False, (16, 256, 31, 31, 31)),
    ((1, 32), False, (1, 32, 528, 3952, 529)),  # blocks capped at SMS * BLOCKS_PER_SM
])
def test_pipeline_plan_blocks_and_depth(geometry, affine, want):
    assert tuple(band.pipeline_plan(126440, 127240, affine, geometry)) == want


def test_pipeline_plan_one_strip_needs_no_ring():
    plan = band.pipeline_plan(100, 5000, True, (4, 32, 3))
    assert (plan.strips, plan.depth, plan.blocks) == (1, 0, 3)


@pytest.mark.parametrize("affine", [False, True])
def test_pipeline_plan_ring_stays_in_budget(affine, monkeypatch):
    m = 127240
    row_bytes = 4 * (2 if affine else 1) * (m + 1)
    monkeypatch.setattr(band, "RING_BUDGET", 5 * row_bytes + 7)
    plan = band.pipeline_plan(126440, m, affine, (8, 128))
    assert plan.depth == 5 and plan.depth * row_bytes <= band.RING_BUDGET
    monkeypatch.setattr(band, "RING_BUDGET", 2 * row_bytes)
    assert band.pipeline_plan(126440, m, affine, (8, 128)).depth == 2
    monkeypatch.setattr(band, "RING_BUDGET", 2 * row_bytes - 1)
    with pytest.raises(ValueError, match="past the budget"):
        band.pipeline_plan(126440, m, affine, (8, 128))
    # one strip needs no ring, whatever the budget
    assert band.pipeline_plan(100, m, affine, (8, 128)).depth == 0


def test_pipeline_plan_default_ring_within_budget_at_any_width():
    for m in (1, 127240, 10_000_000, 60_000_000):
        plan = band.pipeline_plan(126440, m, True)
        assert 2 <= plan.depth and plan.depth * 8 * (m + 1) <= band.RING_BUDGET
    with pytest.raises(ValueError, match="past the budget"):
        band.pipeline_plan(126440, 2**31 - 2, True)


@pytest.mark.parametrize("m, affine", [(140_000_000, False), (70_000_000, True)])
def test_pipeline_plan_serves_very_wide_pairs_within_the_cards_memory(m, affine):
    """A pair inside the int32 headroom whose 2 ring rows pass RING_BUDGET
    plans a ring of at least 2 rows within an 80 GB card's budget."""
    budget = 80 << 30
    plan = band.pipeline_plan(5000, m, affine, budget=budget)
    assert plan.strips >= 2 and plan.depth >= 2
    assert plan.depth * 4 * (2 if affine else 1) * (m + 1) <= budget
    with pytest.raises(ValueError, match="past the budget"):  # RING_BUDGET's 1 GiB
        band.pipeline_plan(5000, m, affine)


@pytest.mark.parametrize("affine", [False, True])
def test_pipeline_plan_refuses_a_ring_past_the_cards_memory(affine):
    m = 140_000_000
    two_rows = 2 * 4 * (2 if affine else 1) * (m + 1)
    assert band.pipeline_plan(5000, m, affine, budget=two_rows).depth == 2
    with pytest.raises(ValueError, match="of device memory"):
        band.pipeline_plan(5000, m, affine, budget=two_rows - 1)


@pytest.mark.parametrize("free, want", [(80 << 30, 40 << 30), (1001, 500), (0, 0)])
def test_ring_budget_is_a_share_of_the_free_bytes(free, want):
    assert band.ring_budget(free_bytes=free) == want == int(free * band.RING_SHARE)


def test_ring_budget_of_a_full_card_plans_the_wide_fills():
    """What the wrappers plan on an 80 GB card with 79 GB free: the
    widest pairs inside the int32 headroom keep rings of 2 rows or more."""
    budget = band.ring_budget(free_bytes=79 << 30)
    for m, affine in ((140_000_000, False), (70_000_000, True), (2**29 - 5000, False),
                      (2**29 - 5000, True)):
        assert band.pipeline_plan(5000, m, affine, budget=budget).depth >= 2


class FakeCard:
    """Cards as ``band.ring_budget`` reads them: per device index, the
    driver's free bytes and the caching allocator's reserved and allocated
    bytes, moved as a cudaMalloc, a tensor's release and ``empty_cache``
    move them; counts the driver's queries."""

    def __init__(self, monkeypatch, free=(79 << 30, 79 << 30)):
        self.free, self.reserved, self.allocated = list(free), [0] * len(free), [0] * len(free)
        self.queries = 0
        self.current = 0
        monkeypatch.setattr(band, "_usable", {})
        monkeypatch.setattr(torch.cuda, "mem_get_info", self.mem_get_info)
        monkeypatch.setattr(torch.cuda, "memory_reserved", lambda i: self.reserved[i])
        monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: self.allocated[i])
        monkeypatch.setattr(torch.cuda, "current_device", lambda: self.current)

    def mem_get_info(self, i):
        self.queries += 1
        return self.free[i], self.free[i] + self.reserved[i]

    def allocate(self, i, nbytes):
        """A tensor of ``nbytes``: from what the allocator holds unused,
        else a cudaMalloc of the rest."""
        short = nbytes - (self.reserved[i] - self.allocated[i])
        if short > 0:
            self.free[i] -= short
            self.reserved[i] += short
        self.allocated[i] += nbytes

    def release(self, i, nbytes):
        """A tensor freed: the allocator keeps its bytes."""
        self.allocated[i] -= nbytes

    def empty_cache(self, i):
        self.free[i] += self.reserved[i] - self.allocated[i]
        self.reserved[i] = self.allocated[i]

    def per_call(self, i):
        """The budget asked of the driver on every call."""
        return int((self.free[i] + self.reserved[i] - self.allocated[i]) * band.RING_SHARE)


@pytest.fixture
def card(monkeypatch):
    return FakeCard(monkeypatch)


def _counts():
    c = trace.counters()
    return c.get("free_memory", 0), c.get("free_memory.cached", 0)


CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("n", [1, 2, 7])
def test_ring_budget_asks_the_driver_once_a_device(card, n):
    before = _counts()
    budgets = [band.ring_budget(CUDA0) for _ in range(n)]
    assert budgets == [card.per_call(0)] * n
    assert card.queries == 1
    after = _counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, n - 1)


#: the allocator's moves between two budgets, in turn: an output from what
#: it holds, a ring past it (a cudaMalloc), their release, its cache
#: emptied, a fill's outputs again
MOVES = [("allocate", 1 << 20), ("allocate", 40 << 30), ("release", 40 << 30),
         ("empty_cache", None), ("allocate", 3 << 29), ("release", 1 << 20),
         ("allocate", 7 << 20)]


@pytest.mark.parametrize("moves", range(1, len(MOVES) + 1))
def test_ring_budget_from_the_cache_is_the_per_call_budget(card, moves):
    card.allocate(0, 5 << 20)  # the context's first tensors, reserved before the query
    assert band.ring_budget(CUDA0) == card.per_call(0)
    for name, nbytes in MOVES[:moves]:
        getattr(card, name)(0, *(() if nbytes is None else (nbytes,)))
        assert band.ring_budget(CUDA0) == card.per_call(0)
    assert card.queries == 1


def test_ring_budget_keeps_a_cache_a_device(monkeypatch):
    card = FakeCard(monkeypatch, free=(79 << 30, 31 << 30))
    card.allocate(1, 3 << 30)
    assert band.ring_budget(CUDA0) == card.per_call(0)
    assert band.ring_budget(CUDA1) == card.per_call(1) != card.per_call(0)
    card.allocate(0, 1 << 30)
    card.current = 1  # no index: the current device
    assert band.ring_budget() == band.ring_budget("cuda:1") == card.per_call(1)
    assert band.ring_budget("cuda:0") == card.per_call(0)
    assert card.queries == 2 and sorted(band._usable) == [0, 1]


def _raising(times):
    """A callable that raises ``torch.OutOfMemoryError`` on its first
    ``times`` calls and then returns its argument."""
    calls = []

    def fn(x):
        calls.append(x)
        if len(calls) <= times:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return x
    fn.calls = calls
    return fn


@pytest.mark.parametrize("where", ["plan", "scratch"])
def test_ringed_plans_again_from_a_fresh_query_after_out_of_memory(card, where):
    assert band.ringed(CUDA0, lambda b: b, lambda p: "s") == (card.per_call(0), "s")
    card.free[0] -= 9 << 30  # another process took memory: the cache is stale
    plan, scratch = (_raising(1), lambda p: p) if where == "plan" else (lambda b: b, _raising(1))
    before = _counts()
    assert band.ringed(CUDA0, plan, scratch) == (card.per_call(0),) * 2
    assert card.queries == 2 and _counts()[0] - before[0] == 1
    # the budget asked again is the fresh one, and the next plan reads it from the cache
    assert band.ringed(CUDA0, lambda b: b, lambda p: None)[0] == card.per_call(0)
    assert card.queries == 2


@pytest.mark.parametrize("where", ["plan", "scratch"])
def test_ringed_lets_a_second_out_of_memory_through(card, where):
    fails = _raising(2)
    plan, scratch = (fails, lambda p: p) if where == "plan" else (lambda b: b, fails)
    with pytest.raises(torch.OutOfMemoryError):
        band.ringed(CUDA0, plan, scratch)
    assert len(fails.calls) == 2 and card.queries == 2


def test_ringed_without_a_ring_asks_nothing(card):
    assert band.ringed(CUDA0, lambda b: b, lambda p: p, ring=False) == (None, None)
    fails = _raising(1)
    with pytest.raises(torch.OutOfMemoryError):
        band.ringed(CUDA0, lambda b: b, fails, ring=False)
    assert card.queries == 0 and len(fails.calls) == 1


_NW, _SW = ScoringConfig(), ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
_AFFINE = ScoringConfig(match=1, mismatch=-4, gap_open=-6, gap_extend=-1)
#: each cell's plan as its wrapper makes it from a budget: K1 (nw-unit) at
#: 126,440 x 127,240, K6 (sw-2-1-2) there, the affine root fill (bwa-mem-1-4-6-1)
#: of half the query, and the planted SW fill of 2,048 x 134,217,728
CELL_PLANS = {
    "nw.pair64gb.score": lambda b: bitpal.pipeline_plan(-(-126440 // bitpal.WORD), 127240,
                                                        None, b),
    "sw.pair64gb.score": lambda b: band.score_plan(126440, 127240, False, None,
                                                   band.max_k(_SW), b),
    "affine.pair64gb.align": lambda b: band.pipeline_plan(63620, 126440, True, None,
                                                          band.max_k(_AFFINE), b),
    "planted SW": lambda b: band.score_plan(2048, 1 << 27, False, None, band.max_k(_SW), b),
}


@pytest.mark.parametrize("free", [79 << 30, 5 << 29])
@pytest.mark.parametrize("cell", list(CELL_PLANS))
def test_the_cells_plans_are_the_per_call_plans(monkeypatch, cell, free):
    """Call after call of a cell, the allocator holding and freeing its
    outputs and rings, the plans from the cache are the plans from a query
    a call, on a full card and on one where the planted fill's ring is
    2 rows of its budget."""
    card = FakeCard(monkeypatch, free=(free,))
    planner = CELL_PLANS[cell]
    plans = []
    for call in range(4):
        want = planner(card.per_call(0))
        plan, ring = band.ringed(CUDA0, planner, lambda p: p.depth * 8 * 127241)
        assert plan == want
        card.allocate(0, ring + (1 << 20))
        card.release(0, ring + (1 << 20))
        if call == 2:
            card.empty_cache(0)
        plans.append(plan)
    assert card.queries == 1 and len(set(plans)) == 1


@pytest.mark.parametrize("geometry, match", [
    ((3, 64), "rows per thread"), ((32, 64), "rows per thread"), ((8, 48), "multiple of 32"),
    ((8, 512), "multiple of 32"), ((8, 0), "multiple of 32"), ((8, 64, 0), "at least 1"),
    ((8,), "geometry is"), ((8, 64, 2, 1), "geometry is"),
])
def test_pipeline_plan_refuses_bad_geometry(geometry, match):
    with pytest.raises(ValueError, match=match):
        band.pipeline_plan(1000, 1000, False, geometry)


# the kernels through the shim

GEOMETRIES = [(1, 32, 1), (2, 32, 1), (1, 32, 2), (2, 64, 3), (1, 32, 40), (1, 64), (4, 32),
              (16, 32), None]


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ builds the kernels through the shim")
    sys.path.insert(0, TOOLS)
    try:
        import rehearse_kernels
    finally:
        sys.path.remove(TOOLS)
    dll = rehearse_kernels.build(str(tmp_path_factory.mktemp("shim")),
                                 ("band_fill.cu", "band_capture_affine.cu", "band_batch.cu"))
    return rehearse_kernels, dll


def _shapes(rng, c):
    m, n = (int(x) for x in rng.integers(1, 90, 2))
    n = int(rng.integers(90, 300)) if c % 3 == 0 else n  # up to 9 strips of 32 rows
    return (1 if c % 10 == 3 else m), (1 if c % 10 == 7 else n)  # 1-column, 1-row


def _tile_cases(group, rng):
    """``(m, n, geometry, shallow)`` of a group of K6 cases: ``ragged`` the
    tile's ragged ends (m below W, m = 1, m of every residue mod W, over
    several strips); ``strips`` one strip, several over blocks past them,
    fewer blocks than strips, one block; ``ring2`` several strips over a
    ring cut to 2 rows; ``ks`` every k the planner may pick, the planner's
    own geometry among them."""
    if group == "ragged":  # at each k, m below W, m = 1 and every residue mod its W
        cases = []
        for k in band.KS:
            W = band.TILE_W[k]
            ms = [1, W - 1] + [W * int(rng.integers(1, 6)) + x for x in range(1, W)] + [3 * W]
            cases += [(m, int(rng.integers(1, 200)), (k, 32, 1 + i % 3), None)
                      for i, m in enumerate(ms)]
        return cases
    if group == "strips":
        return [(int(rng.integers(1, 90)), n, geometry, None)
                for n, geometry in ((60, (2, 32)), (64, (2, 32)), (250, (2, 32)),
                                    (250, (1, 32, 40)), (300, (2, 32, 2)), (300, (1, 64, 1)),
                                    (129, (4, 32, 3)))]
    if group == "ring2":
        return [(int(rng.integers(30, 120)), int(rng.integers(200, 400)), (1, 32, blocks), True)
                for blocks in (1, 2, 3, 40)]
    return [(int(rng.integers(1, 120)), int(rng.integers(1, 600)), geometry, None)
            for geometry in [(k, 32) for k in band.KS] + [(8, 64, 2), (16, 32, 1), None, None]]


@pytest.mark.parametrize("group", ["random", "ragged", "strips", "ring2", "ks"])
def test_band_fill_through_the_shim(shim, group):
    """K6's tiled fill (``band_fill``) against ``band.score_plain``: random
    shapes and geometries, one config each, and the groups of
    :func:`_tile_cases`, each case under every ``AlignMode``, linear and
    affine gaps and pair scoring and two matrices in turn."""
    rk, dll = shim
    rng = np.random.default_rng(1 + ["random", "ragged", "strips", "ring2", "ks"].index(group))
    mats = [None, matrices.dna(2, -1, -3), matrices.iupac()]
    if group == "random":
        for c in range(24):
            m, n = _shapes(rng, c)
            ok, info = rk._band_case(dll, rng, list(AlignMode)[c % 4], mats[(c // 4) % 3],
                                     bool((c // 2) % 2), m, n, GEOMETRIES[c % len(GEOMETRIES)])
            assert ok, info
        return
    for c, (m, n, geometry, shallow) in enumerate(_tile_cases(group, rng)):
        for mode in AlignMode:
            ok, info = rk._band_case(dll, rng, mode, mats[(c // 2) % 3], bool(c % 2), m, n,
                                     geometry, shallow)
            assert ok, info
            if shallow:
                assert info[4].depth == 2 and info[4].strips > 2, info


@pytest.mark.parametrize("affine", [False, True])
def test_capture_fill_through_the_shim(shim, affine):
    """``band_capture_fill`` (linear) and ``band_capture_affine``: captured
    rows at the strip edges, the last column, the located cell, F's last
    row."""
    rk, dll = shim
    rng = np.random.default_rng(2 + affine)
    mats = [None, matrices.dna(2, -1, -3), matrices.iupac()]
    for c in range(24):
        m, n = _shapes(rng, c)
        ok, info = rk._capture_case(dll, rng, bool(c % 2), mats[(c // 2) % 3], m, n,
                                    GEOMETRIES[c % len(GEOMETRIES)], locate=c % 3 != 2,
                                    affine=affine)
        assert ok, info


def test_band_batch_fill_through_the_shim(shim):
    """Ragged batches of both schedules, one for each of the batch kernel's
    38 instantiations (``rehearse_kernels._band_batch_case``)."""
    rk, dll = shim
    rng = np.random.default_rng(4)
    for c in range(len(rk.BATCH_KINDS)):
        ok, info = rk._band_batch_case(dll, rng, c)
        assert ok, info
