"""K8's port on the strip pipeline (``tpualign_torch/csrc/diag_fill.cu``),
run on the CPU.

``diag_fill`` is compiled with ``g++`` through the shim of
``tools/rehearse_kernels.py`` and held against ``pallas_diag.score_plain``
(``rehearse_kernels.diag_case``: ``out`` seeded with the max's identity as
the wrapper seeds it, the flags checked at the end): NW and SW at (2, -1,
-2) and (1, 0, -1), rows at strip edges (R = k * threads), several strips,
1-row and square tables, one block, blocks past the strips, fewer blocks
than strips over rings of 2 rows.  ``score_plain`` is held against
``tpualign``'s K8 in interpret mode in ``tests/test_torch_diag.py``.  The
shim runs a grid's blocks one after another, so the first block takes every
strip: this checks the strip arithmetic, the ring's slots and the flags'
values, not their timing, which only the card shows (``chip_smoke.py``).
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from tpualign_torch import trace
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import pallas_diag


def launches(kernel: str) -> int:
    """The launches of ``kernel`` counted so far in this process."""
    return trace.counters().get("launch." + kernel, 0)


TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")

CFGS = {
    "NW (2, -1, -2)": ScoringConfig(match=2, mismatch=-1, gap=-2),
    "SW (2, -1, -2)": ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL),
    "NW (1, 0, -1)": ScoringConfig(),
    "SW (1, 0, -1)": ScoringConfig(match=1, mismatch=0, gap=-1, mode=AlignMode.LOCAL),
}


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ builds the kernels through the shim")
    sys.path.insert(0, TOOLS)
    try:
        import rehearse_kernels
    finally:
        sys.path.remove(TOOLS)
    dll = rehearse_kernels.build(str(tmp_path_factory.mktemp("shim")), ("diag_fill.cu",))
    return rehearse_kernels, dll


@pytest.mark.parametrize("n", [1, 63, 64, 65, 128, 129, 191])
@pytest.mark.parametrize("name", CFGS)
def test_diag_fill_rows_at_strip_edges(shim, name, n):
    """Strips of 64 rows (2 a thread, 32 threads): n one short of a strip
    edge, on it and one past it, a 1-row table; the last strip alone holds
    H(n, m)."""
    rk, dll = shim
    rng = np.random.default_rng([list(CFGS).index(name), n])
    ok, info = rk.diag_case(dll, rng, CFGS[name], 200, n, (2, 32))
    assert ok, info


@pytest.mark.parametrize("geometry, shallow", [
    ((1, 32, 1), False),  # one block walks the 7 strips
    ((1, 32, 64), False),  # blocks past the strips
    ((1, 32, 2), True),  # fewer blocks than strips, the ring cut to 2 rows
    ((2, 64, 1), True),  # two strips, one block, a ring of 2 rows
    ((16, 32, 3), True),  # one strip past its rows
], ids=["one block", "blocks past the strips", "fewer blocks, ring of 2",
        "two strips, one block", "one strip"])
@pytest.mark.parametrize("name", CFGS)
def test_diag_fill_schedules(shim, name, geometry, shallow):
    rk, dll = shim
    rng = np.random.default_rng([7, list(CFGS).index(name), geometry[2]])
    ok, info = rk.diag_case(dll, rng, CFGS[name], 260, 200, geometry, shallow)
    assert ok, info


@pytest.mark.parametrize("m, n", [(1, 1), (2, 1), (97, 97), (300, 1), (257, 256)])
@pytest.mark.parametrize("name", CFGS)
def test_diag_fill_small_and_square_tables_at_the_planners_geometry(shim, name, m, n):
    rk, dll = shim
    rng = np.random.default_rng([m, n, list(CFGS).index(name)])
    ok, info = rk.diag_case(dll, rng, CFGS[name], m, n)
    assert ok, info


def test_diag_fill_entry_refusals_through_the_shim(shim):
    """The C entry refuses n > m, a geometry outside the pipeline's, and
    several strips without a ring of 2 rows or without flags."""
    _, dll = shim
    s = torch.zeros(300, dtype=torch.int8)
    ring = torch.zeros(2 * 301, dtype=torch.int32)
    sync = torch.zeros(16, dtype=torch.int32)
    out = torch.zeros(1, dtype=torch.int32)

    def call(m=300, n=200, k=1, threads=32, blocks=1, ring_=ring, depth=2, sync_=sync):
        return dll.diag_fill(s.data_ptr(), m, s.data_ptr(), n, 2, -1, -2, 0, k, threads, blocks,
                             None if ring_ is None else ring_.data_ptr(), depth,
                             None if sync_ is None else sync_.data_ptr(), out.data_ptr(), None)

    for bad in (dict(n=301), dict(k=3), dict(threads=48), dict(threads=512), dict(blocks=0),
                dict(ring_=None), dict(depth=1), dict(sync_=None)):
        assert call(**bad) != 0, bad
    assert call(n=20, ring_=None, depth=0) == 0  # one strip takes no ring


def test_diag_fill_wrapper_on_cpu_takes_a_geometry_and_runs_the_plain_version():
    rng = np.random.default_rng(11)
    s1 = torch.from_numpy(rng.integers(0, 5, 90).astype(np.int8))
    s2 = torch.from_numpy(rng.integers(0, 5, 70).astype(np.int8))
    cfg = CFGS["SW (2, -1, -2)"]
    before = launches("diag_fill")
    got = pallas_diag.diag_fill(s1, s2, cfg, geometry=(1, 32, 2))
    assert int(got) == int(pallas_diag.score_plain(s1, s2, cfg))
    assert launches("diag_fill") == before

