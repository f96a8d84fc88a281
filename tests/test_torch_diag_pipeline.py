"""K9's port on the strip pipeline (``tpualign_torch/csrc/diag_ckpt.cu``),
run on the CPU.

``diag_ckpt_fill`` is compiled with ``g++`` through the shim of
``tools/rehearse_kernels.py`` and held word for word against
``pallas_diag.ckpt_plain``: both checkpoint arrays with their dead slots
and, under local scoring, each row's maximum ``v`` and the first diagonal
that reached it ``dbest``, the outputs seeded with garbage so that a slot
the kernel leaves unwritten shows.  ``ckpt_plain`` is held against
``tpualign``'s ``forward_checkpoints(interpret=True)`` in
``tests/test_torch_traceback_diag.py``.  The shim runs a grid's blocks one
after another, so the first block takes every strip: this checks the strip
arithmetic, the ring's slots, the progress flags' values and the
checkpoint stores across strip edges, not their timing, which only the
card shows (``chip_smoke.py``).
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np
import pytest

from tpualign_torch.config import AlignMode, ScoringConfig

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")

CFGS = {
    "NW": ScoringConfig(),
    "SW": ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL),
    "positive-mismatch SW": ScoringConfig(match=3, mismatch=1, gap=-2, mode=AlignMode.LOCAL),
    "positive-gap local": ScoringConfig(match=1, mismatch=-3, gap=1, mode=AlignMode.LOCAL),
}
#: (m, n): s1 across the columns, s2 down the rows
SHAPES = {"1 x k": (1, 70), "k x 1": (70, 1), "n > m": (60, 150), "n < m": (150, 60)}


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ builds the kernels through the shim")
    sys.path.insert(0, TOOLS)
    try:
        import rehearse_kernels
    finally:
        sys.path.remove(TOOLS)
    dll = rehearse_kernels.build(str(tmp_path_factory.mktemp("shim")), ("diag_ckpt.cu",))
    return rehearse_kernels, dll


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("K", [8, 16, 1024])
@pytest.mark.parametrize("name", CFGS)
def test_ckpt_fill_shapes_and_strides(shim, name, K, shape):
    """Strips of 64 rows (2 a thread, 32 threads): the tall shapes run
    several strips, the others one."""
    rk, dll = shim
    rng = np.random.default_rng([list(CFGS).index(name), K, list(SHAPES).index(shape)])
    m, n = SHAPES[shape]
    ok, info = rk._ckpt_case(dll, rng, CFGS[name], m, n, K, (2, 32))
    assert ok, info


@pytest.mark.parametrize("geometry, shallow", [
    ((1, 32, 1), False),  # one block walks the 5 strips
    ((1, 32, 64), False),  # blocks past the strips
    ((1, 32, 2), True),  # fewer blocks than strips, the ring cut to 2 rows
], ids=["one block", "blocks past the strips", "fewer blocks, ring of 2"])
@pytest.mark.parametrize("name", CFGS)
def test_ckpt_fill_schedules(shim, name, geometry, shallow):
    rk, dll = shim
    rng = np.random.default_rng([7, list(CFGS).index(name), geometry[2]])
    ok, info = rk._ckpt_case(dll, rng, CFGS[name], 90, 150, 24, geometry, shallow)
    assert ok, info


@pytest.mark.parametrize("m, n, K, geometry", [
    (64, 96, 32, (1, 32)),  # diagonal 32 meets row 32, strip 0's last, at column 0
    (31, 96, 16, (1, 32, 1)),  # the last column before each strip edge
    (40, 128, 8, (2, 32)),  # a stride of 8 against 2 rows a thread
    (33, 64, 16, (16, 32)),  # 16 rows a thread: two rows of a thread hit at once
], ids=["K divides the strip", "narrow", "K = 8", "16 rows a thread"])
@pytest.mark.parametrize("name", ["NW", "positive-mismatch SW"])
def test_ckpt_fill_checkpoints_on_strip_edges(shim, name, m, n, K, geometry):
    """Checkpoint diagonals that land on the strips' edge rows: each strip
    stores its own cells of them; none goes through the ring."""
    rk, dll = shim
    rng = np.random.default_rng([11, m, n, K])
    ok, info = rk._ckpt_case(dll, rng, CFGS[name], m, n, K, geometry)
    assert ok, info
