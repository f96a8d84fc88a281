"""The port's alignment paths through its C++ full-table walk
(``tpualign_torch.utils.native.traceback``) on the CPU: the trees' leaves
(``hirschberg.align``, ``band_align.align_global``, ``align`` past the full
table), ``band_align.align_local``'s window and core, and ``align``'s
full-table route.  With the split thresholds lowered, each path walks every
leaf in C++ (the NumPy walk made to fail) and returns the strings of the
same path walked in NumPy; the full-table route returns ``tpualign.align``'s
strings, whose tie order the JAX package promises there.  ``stats`` names
the walk, and the affine leaves stay on one NumPy walker.  Inputs come from
numpy with a seed; comparisons are exact."""

import concurrent.futures

import numpy as np
import pytest

import tpualign
from tpualign import api as japi
from tpualign import matrices as jmat
from tpualign.config import AlignMode as JaxMode
from tpualign.config import ScoringConfig as JaxScoring
from tpualign_torch import EngineConfig, align, api, matrices
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import affine_align, band_align, hirschberg, oracle
from tpualign_torch.utils import native

CPU = EngineConfig(device="cpu")


def _pair(m, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 5, m).astype(np.int8), rng.integers(1, 5, n).astype(np.int8)


@pytest.fixture
def small_tree(monkeypatch):
    """k-way and binary nodes and leaves of a few thousand cells on
    test-sized pairs, ``align`` past the full table from tiny tables on."""
    monkeypatch.setattr(hirschberg, "BASE_CELLS", 3000)
    monkeypatch.setattr(hirschberg, "KWAY_MIN_ROWS", 300)
    monkeypatch.setattr(hirschberg, "KWAY_LEAF_ROWS", 70)
    monkeypatch.setattr(api, "FULL_TABLE_CELL_LIMIT", 3000)
    monkeypatch.setattr(japi, "FULL_TABLE_CELL_LIMIT", 3000)


def _walked(monkeypatch, fn, walk):
    """``fn()`` with every table walked by ``walk`` (``"native"`` or
    ``"numpy"``), the other walk made to fail; returns ``fn()``'s result
    and the number of C++ walks."""
    calls = []
    c_walk, np_walk = native.traceback, oracle.traceback

    def counted(*args):
        calls.append(args)
        return c_walk(*args)

    def fail(*args):
        raise AssertionError(f"a {'NumPy' if walk == 'native' else 'C++'} walk ran")

    with monkeypatch.context() as mp:
        if walk == "native":
            mp.setattr(native, "traceback", counted)
            mp.setattr(oracle, "traceback", fail)
        else:
            mp.setattr(native, "walks", lambda cfg: False)
            mp.setattr(native, "traceback", lambda *args: np_walk(*args))
            mp.setattr(native, "load", fail)
        return fn(), len(calls)


TREE_CASES = {
    "hirschberg unit": (lambda s1, s2, st: hirschberg.align(s1, s2, device="cpu", stats=st),
                        ScoringConfig()),
    "hirschberg g2": (lambda s1, s2, st: hirschberg.align(
        s1, s2, ScoringConfig(gap=-2), device="cpu", stats=st), ScoringConfig(gap=-2)),
    "align_global 2,-1,-3": (lambda s1, s2, st: band_align.align_global(
        s1, s2, ScoringConfig(match=2, mismatch=-1, gap=-3), device="cpu", stats=st),
        ScoringConfig(match=2, mismatch=-1, gap=-3)),
    "align_global dna": (lambda s1, s2, st: band_align.align_global(
        s1, s2, ScoringConfig(matrix=matrices.dna(2, -1, -3), gap=-3), device="cpu",
        stats=st), ScoringConfig(matrix=matrices.dna(2, -1, -3), gap=-3)),
    "api.align unit": (lambda s1, s2, st: align(s1, s2, engine=CPU, stats=st),
                       ScoringConfig()),
}


@pytest.mark.parametrize("m,n", [(150, 700), (700, 150), (420, 400)],
                         ids=["kway", "binary", "square"])
@pytest.mark.parametrize("case", list(TREE_CASES))
def test_tree_walks_every_leaf_in_cpp(small_tree, monkeypatch, case, m, n):
    run, cfg = TREE_CASES[case]
    s1, s2 = _pair(m, n, seed=m + 2 * n + len(case))
    st_c, st_np = {}, {}
    got, n_walks = _walked(monkeypatch, lambda: run(s1, s2, st_c), "native")
    want, _ = _walked(monkeypatch, lambda: run(s1, s2, st_np), "numpy")
    assert got == want
    assert got[0] == oracle.score(s1, s2, cfg) == oracle.alignment_score(got[1], got[2], cfg)
    assert (st_c["leaf_walk"], st_np["leaf_walk"]) == ("native", "numpy")
    assert n_walks == st_c["leaves"] == st_np["leaves"] >= 2
    assert st_c["leaf_walk_s"] > 0


@pytest.mark.parametrize("route", ["window", "core"])
@pytest.mark.parametrize("cfg", [
    ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL),
    ScoringConfig(matrix=matrices.dna(3, -1, -2), gap=-2, mode=AlignMode.LOCAL),
], ids=["sw", "sw-dna"])
def test_local_window_and_core_walk_in_cpp(small_tree, monkeypatch, cfg, route):
    if route == "core":  # every hit is long: the anchored start and a core
        monkeypatch.setattr(band_align, "SW_WINDOW_LIMIT", 0)
    s1, s2 = _pair(400, 420, seed=7)
    st_c, st_np = {}, {}
    got, n_walks = _walked(monkeypatch, lambda: band_align.align_local(
        s1, s2, cfg, device="cpu", stats=st_c), "native")
    want, _ = _walked(monkeypatch, lambda: band_align.align_local(
        s1, s2, cfg, device="cpu", stats=st_np), "numpy")
    assert got == want and got[0] == oracle.score(s1, s2, cfg) > 0
    assert st_c["route"] == route
    walk = st_c if route == "window" else st_c["core_stats"]
    assert walk["leaf_walk"] == "native"
    assert n_walks >= 1
    assert align(s1, s2, cfg, CPU) == got


FULL_TABLE_CASES = {
    "unit": dict(),
    "2,-1,-3": dict(match=2, mismatch=-1, gap=-3),
    "dna": dict(matrix="dna", gap=-3),
    "sw": dict(mode="LOCAL", match=2, mismatch=-1, gap=-2),
    "semiglobal": dict(mode="SEMIGLOBAL", match=2, mismatch=-1, gap=-2),
    "affine": dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2),
}


@pytest.mark.parametrize("case", list(FULL_TABLE_CASES))
def test_full_table_route(monkeypatch, case):
    """Global linear-gap configs walk in C++, the rest in NumPy (as
    ``tpualign/api.py:221-231``); both give ``tpualign.align``'s strings."""
    kw = dict(FULL_TABLE_CASES[case])
    mode = kw.pop("mode", "GLOBAL")
    mat = kw.pop("matrix", None)
    ours = ScoringConfig(mode=AlignMode[mode], matrix=mat and matrices.dna(2, -1, -3), **kw)
    theirs = JaxScoring(mode=JaxMode[mode], matrix=mat and jmat.dna(2, -1, -3), **kw)
    s1, s2 = _pair(300, 280, seed=len(case))
    in_cpp = mode == "GLOBAL" and "gap_open" not in kw
    got, n_walks = _walked(monkeypatch, lambda: align(s1, s2, ours, CPU),
                           "native" if in_cpp else "numpy")
    assert n_walks == (1 if in_cpp else 0)
    assert got == tpualign.align(s1, s2, theirs)
    assert got == oracle.traceback(s1, s2, ours)


def test_full_table_route_refuses_codes_outside_the_matrix():
    cfg = ScoringConfig(matrix=matrices.dna(2, -1, -3), gap=-3)
    s = np.asarray([1, 2, 5], np.int8)
    with pytest.raises(ValueError, match="outside the matrix alphabet"):
        align(s, s, cfg, CPU)
    with pytest.raises(ValueError, match="outside the matrix alphabet"):
        tpualign.align(s, s, JaxScoring(matrix=jmat.dna(2, -1, -3), gap=-3))


class _Pool(concurrent.futures.ThreadPoolExecutor):
    sizes = []

    def __init__(self, max_workers=None, **kw):
        self.sizes.append(max_workers)
        super().__init__(max_workers=max_workers, **kw)


@pytest.mark.parametrize("path", ["tree native", "tree numpy", "affine"])
def test_walker_threads(small_tree, monkeypatch, path):
    """The C++ walk runs on ``NATIVE_LEAF_WORKERS`` threads (8, as
    ``tpualign``'s pool), every NumPy walk, the affine leaves' too, on
    ``LEAF_WORKERS`` = 1: it holds the interpreter lock."""
    assert (hirschberg.NATIVE_LEAF_WORKERS, hirschberg.LEAF_WORKERS) == (8, 1)
    monkeypatch.setattr(_Pool, "sizes", [])
    monkeypatch.setattr(hirschberg, "ThreadPoolExecutor", _Pool)
    monkeypatch.setattr(affine_align, "ThreadPoolExecutor", _Pool)
    monkeypatch.setattr(affine_align, "BASE_CELLS", 3000)
    s1, s2 = _pair(300, 320, seed=11)
    stats = {}
    if path == "affine":
        cfg = ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2)
        sc, a1, a2 = affine_align.align(s1, s2, cfg, device="cpu", stats=stats)
    else:
        cfg = ScoringConfig()
        if path == "tree numpy":
            monkeypatch.setattr(native, "walks", lambda cfg: False)
        sc, a1, a2 = hirschberg.align(s1, s2, cfg, device="cpu", stats=stats)
    assert sc == oracle.score(s1, s2, cfg) == oracle.alignment_score(a1, a2, cfg)
    walk = "native" if path == "tree native" else "numpy"
    assert stats["leaf_walk"] == walk and stats["leaves"] >= 2
    assert _Pool.sizes == [8 if walk == "native" else 1]
