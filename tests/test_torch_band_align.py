"""The port's general-scoring alignment on the CPU, where the capture fill
(``tpualign_torch.ops.band.capture_fill``, K7's port) runs its plain
version: the fill's rows, last column and maximum against the TPU kernel
(``tpualign.ops.band_align._fill`` in interpret mode), its located cells
against ``tpualign.utils.native.locate_flex`` (or a scan of
``tpualign.ops.oracle.score_table`` where native does not build), the
wrapper's refusals, and ``band_align.align_global``, ``align_local`` and
``ends_free.align_large`` end to end: each alignment valid and scoring
exactly ``tpualign.ops.oracle.score`` and ``tpualign.align``.  Inputs come
from numpy with a seed; every comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

import tpualign
from tpualign import matrices as jmat
from tpualign.config import AlignMode as JaxMode
from tpualign.config import EngineConfig as JaxEngine
from tpualign.config import ScoringConfig as JaxScoring
from tpualign.ops import band_align as jband_align
from tpualign.ops import oracle
from tpualign.utils import native
from tpualign_torch import EngineConfig, align, api, matrices, trace
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import affine_align, band, band_align, ends_free, hirschberg
from tpualign_torch.ops import oracle as toracle


def launches(kernel: str) -> int:
    """The launches of ``kernel`` counted so far in this process."""
    return trace.counters().get("launch." + kernel, 0)


CPU = EngineConfig(device="cpu")
MATS = {"pair": (None, None), "dna": (matrices.dna(2, -1, -3), jmat.dna(2, -1, -3)),
        "iupac": (matrices.iupac(), jmat.iupac())}


def _cfgs(mode="GLOBAL", matrix="pair", **kw):
    ours, theirs = MATS[matrix]
    return (ScoringConfig(mode=AlignMode[mode], matrix=ours, **kw),
            JaxScoring(mode=JaxMode[mode], matrix=theirs, **kw))


def _pair(m, n, seed, hi=5, lo=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, hi, m).astype(np.int8),
            rng.integers(lo, hi, n).astype(np.int8))


def _decode(seq) -> str:
    return "".join(toracle.BASES[int(c)] for c in seq)


# -- the capture fill's contract ---------------------------------------------


@pytest.mark.parametrize(
    "mode,matrix,zero_row,zero_col",
    [("GLOBAL", "pair", False, False), ("LOCAL", "dna", False, False),
     ("SEMIGLOBAL", "pair", True, True)],
    ids=["global", "local-dna", "zero-boundaries"])
def test_capture_plain_matches_tpu_strip_kernel(mode, matrix, zero_row, zero_col):
    """Three strips of 128 rows: the TPU kernel's strip-boundary rows are
    the port's captures at rows 128 and 256, its right-column capture planes
    the port's last column, and its running max the located cell's value."""
    ours, theirs = _cfgs(mode, matrix, match=2, mismatch=-1, gap=-2)
    s1, s2 = _pair(200, 300, seed=len(mode))
    bs, vmaxs, _, plan, caps = jband_align._fill(
        s1.astype(np.int32), s2.astype(np.int32), theirs, 1, interpret=True,
        zero_row=zero_row, zero_col=zero_col, capture=True)
    got = band.capture_plain(torch.from_numpy(s1), torch.from_numpy(s2), ours, [128, 256],
                             zero_row=zero_row, zero_col=zero_col, col=True, cell=True)
    m, n = s1.size, s2.size
    assert [p[0] for p in plan] == [0, 128, 256]
    assert np.array_equal(got.caps.numpy(), bs[:2, : m + 1])
    b0m = 0 if (zero_row or ours.is_local) else m * ours.gap
    want_col = jband_align._caps_to_col(caps, plan, n, 128, 1, b0m)
    assert np.array_equal(got.col.numpy(), want_col)
    if ours.is_local:
        assert int(got.cell[0]) == int(vmaxs.max())
    assert got.caps.dtype == got.col.dtype == got.row.dtype == torch.int32


def _scan_locate(s1, s2, cfg: JaxScoring, anchored: bool):
    """``native.locate_flex``'s ``(score, i, j)`` from the full table: local
    (and anchored), the row-major first max over every cell; ends-free, the
    last row first, then the last column if strictly greater (infix: the
    last row only)."""
    H = oracle.score_table(s1, s2, dataclasses.replace(cfg, mode=JaxMode.GLOBAL)
                           if anchored else cfg).astype(np.int64)
    if cfg.mode is JaxMode.LOCAL:
        i, j = np.unravel_index(int(np.argmax(H)), H.shape)
        return int(H[i, j]), int(i), int(j)
    n, m = H.shape[0] - 1, H.shape[1] - 1
    j = int(np.argmax(H[n]))
    best = (int(H[n, j]), n, j)
    if cfg.free_end_s2:
        i = int(np.argmax(H[:, m]))
        if H[i, m] > best[0]:
            best = (int(H[i, m]), i, m)
    return best


@pytest.mark.parametrize("m,n", [(60, 45), (45, 60)])
@pytest.mark.parametrize("anchored", [False, True], ids=["forward", "anchored"])
@pytest.mark.parametrize("matrix", ["pair", "dna"])
@pytest.mark.parametrize("mode", ["LOCAL", "SEMIGLOBAL", "INFIX"])
def test_located_cell_matches_native(mode, matrix, anchored, m, n):
    ours, theirs = _cfgs(mode, matrix, match=2, mismatch=-1, gap=-2)
    # two codes: many co-optimal cells, so the tie rules decide
    s1, s2 = _pair(m, n, seed=m + 7 * n + len(mode), hi=3)
    if native.available():
        want = native.locate_flex(s1, s2, theirs, anchored=anchored)
    else:
        want = _scan_locate(s1, s2, theirs, anchored)
    assert tuple(want) == _scan_locate(s1, s2, theirs, anchored)
    if ours.is_local:
        got = band_align.locate_all(torch.from_numpy(s1), torch.from_numpy(s2), ours,
                                    anchored=anchored)
    else:
        got = band_align.locate_flex_device(s1, s2, ours, anchored=anchored, device="cpu")
    assert got == tuple(want)


@pytest.mark.parametrize("gap", [-2, 1], ids=["gap-2", "positive-gap"])
def test_located_cell_boundaries(gap):
    """The closed-form row 0 and column 0 compete in row-major order: with
    a positive gap the anchored maximum lies on a boundary."""
    cfg = ScoringConfig(match=1, mismatch=-3, gap=gap, mode=AlignMode.LOCAL)
    jcfg = JaxScoring(match=1, mismatch=-3, gap=gap, mode=JaxMode.LOCAL)
    s1, s2 = _pair(9, 13, seed=3)
    t, q = torch.from_numpy(s1), torch.from_numpy(s2)
    for anchored in (False, True):
        want = _scan_locate(s1, s2, jcfg, anchored)
        assert band_align.locate_all(t, q, cfg, anchored=anchored) == want


def test_capture_fill_on_cpu_is_the_plain_version():
    cfg = ScoringConfig(match=2, mismatch=-1, gap=-2, matrix=matrices.dna(2, -1, -3))
    s1, s2 = (torch.from_numpy(s) for s in _pair(50, 70, seed=4))
    before = launches("band_capture_fill")
    got = band.capture_fill(s1, s2, cfg, [1, 32, 33, 70], zero_col=True, col=True,
                            cell=True, geometry=(1, 32))
    want = band.capture_plain(s1, s2, cfg, [1, 32, 33, 70], zero_col=True, col=True,
                              cell=True)
    assert all(a is b is None or torch.equal(a, b) for a, b in zip(got, want))
    assert got.f is None  # F's last row: affine gaps only
    assert torch.equal(got.caps[-1], got.row)  # row n is also the last row
    assert int(got.col[-1]) == int(got.row[-1])  # H(n, m) in both
    assert launches("band_capture_fill") == before  # the count is of kernel launches
    bare = band.capture_fill(s1, s2, cfg)
    assert bare.caps is None and bare.col is None and bare.cell is None


def test_capture_fill_rejects_bad_arguments():
    text, query = torch.ones(10, dtype=torch.int8), torch.ones(7, dtype=torch.int8)
    cfg = ScoringConfig()
    with pytest.raises(ValueError, match="int8"):
        band.capture_fill(text.long(), query, cfg)
    with pytest.raises(ValueError, match="non-empty"):
        band.capture_fill(text, query[:0], cfg)
    with pytest.raises(ValueError, match="contiguous"):
        band.capture_fill(torch.ones(20, dtype=torch.int8)[::2], query, cfg)
    with pytest.raises(ValueError, match="cpu or cuda"):
        band.capture_fill(text.to("meta"), query.to("meta"), cfg)
    with pytest.raises(ValueError, match="takes affine gaps"):  # the top-edge open
        band.capture_fill(text, query, cfg, tb=0)
    with pytest.raises(ValueError, match="tb must lie"):
        band.capture_fill(text, query, ScoringConfig(gap_open=-3, gap_extend=-1), tb=-4)
    for rows in ([0], [8], [3, 3], [4, 2]):
        with pytest.raises(ValueError, match="captured rows"):
            band.capture_fill(text, query, cfg, rows)


# -- the alignment paths -----------------------------------------------------


@pytest.fixture
def small_tree(monkeypatch):
    """k-way and binary nodes on test-sized pairs, leaves of a few thousand
    cells, and ``align`` past the full table from tiny tables on."""
    monkeypatch.setattr(hirschberg, "BASE_CELLS", 3000)
    monkeypatch.setattr(hirschberg, "KWAY_MIN_ROWS", 300)
    monkeypatch.setattr(hirschberg, "KWAY_LEAF_ROWS", 70)
    monkeypatch.setattr(api, "FULL_TABLE_CELL_LIMIT", 3000)


def _check_alignment(s1, s2, ours, theirs, sc, a1, a2, *, whole):
    """Valid (``whole``: gaps stripped give back both sequences; else the
    aligned cores are substrings), no column of two gaps, and optimal."""
    assert len(a1) == len(a2)
    assert not any(x == "-" and y == "-" for x, y in zip(a1, a2))
    if whole:
        assert a1.replace("-", "") == _decode(s1) and a2.replace("-", "") == _decode(s2)
    else:
        assert a1.replace("-", "") in _decode(s1) and a2.replace("-", "") in _decode(s2)
    want = oracle.score(s1, s2, theirs)
    assert sc == toracle.alignment_score(a1, a2, ours) == want
    assert sc == tpualign.align(s1, s2, theirs)[0]


GLOBAL_CASES = {
    "nw-3,-2,-4": dict(match=3, mismatch=-2, gap=-4),
    "2,1,-2": dict(match=2, mismatch=1, gap=-2),
    "gap0": dict(match=1, mismatch=0, gap=0),
    "dna": dict(matrix="dna", gap=-3),
    "iupac": dict(matrix="iupac", gap=-2),
}


@pytest.mark.parametrize("m,n", [(150, 700), (700, 150), (420, 400)],
                         ids=["kway", "binary", "square"])
@pytest.mark.parametrize("case", list(GLOBAL_CASES))
def test_align_global(small_tree, case, m, n):
    ours, theirs = _cfgs(**GLOBAL_CASES[case])
    s1, s2 = _pair(m, n, seed=m + n + len(case), hi=16 if case == "iupac" else 5)
    stats = {}
    sc, a1, a2 = band_align.align_global(s1, s2, ours, device="cpu", stats=stats)
    _check_alignment(s1, s2, ours, theirs, sc, a1, a2, whole=True)
    assert stats["kway_nodes"] + stats["binary_nodes"] >= 1
    if n >= hirschberg.KWAY_MIN_ROWS:
        assert stats["kway_nodes"] >= 1
    # through the public entry point (the bit-parallel split for a family
    # config, whose tie order may differ), its split in ``stats``
    api_stats = {}
    assert align(s1, s2, ours, CPU, stats=api_stats)[0] == sc
    assert api_stats["leaves"] >= 1


LOCAL_CASES = {
    "sw": dict(match=2, mismatch=-1, gap=-2),
    "sw-positive-mismatch": dict(match=3, mismatch=1, gap=-2),
    "sw-dna": dict(matrix="dna", gap=-3),
    "sw-iupac": dict(matrix="iupac", gap=-2),
}


@pytest.mark.parametrize("route", ["window", "core"])
@pytest.mark.parametrize("m,n", [(150, 700), (700, 150), (400, 420)])
@pytest.mark.parametrize("case", list(LOCAL_CASES))
def test_align_local(small_tree, monkeypatch, case, m, n, route):
    if route == "core":  # every hit is long: the anchored start and a core
        monkeypatch.setattr(band_align, "SW_WINDOW_LIMIT", 0)
    ours, theirs = _cfgs("LOCAL", **LOCAL_CASES[case])
    s1, s2 = _pair(m, n, seed=m * n + len(case), hi=16 if case == "sw-iupac" else 5)
    stats = {}
    sc, a1, a2 = band_align.align_local(s1, s2, ours, device="cpu", stats=stats)
    _check_alignment(s1, s2, ours, theirs, sc, a1, a2, whole=False)
    assert stats["route"] == route
    api_stats = {}
    got = align(s1, s2, ours, CPU, stats=api_stats)
    if ours.mismatch > 0:
        # tpualign's band split refuses a positive mismatch
        # (tpualign/ops/band_align.py:950-954), so align takes the
        # diagonal-band traceback over K9 in both packages
        monkeypatch.setattr(tpualign.api, "FULL_TABLE_CELL_LIMIT", 3000)
        assert got == tpualign.align(s1, s2, theirs, JaxEngine(impl="band", interpret=True))
        assert got[0] == sc and api_stats["bands"] >= 1 and "route" not in api_stats
    else:
        assert got[0] == sc
        assert (api_stats["route"], api_stats["end"]) == (route, stats["end"])


ENDS_FREE_CASES = {
    "semiglobal": dict(mode="SEMIGLOBAL", match=2, mismatch=-1, gap=-2),
    "infix": dict(mode="INFIX", match=2, mismatch=-1, gap=-2),
    "semiglobal-dna": dict(mode="SEMIGLOBAL", matrix="dna", gap=-3),
    "infix-iupac": dict(mode="INFIX", matrix="iupac", gap=-2),
}


@pytest.mark.parametrize("m,n", [(700, 150), (150, 700), (400, 420)],
                         ids=["s1-longer", "s2-longer", "square"])
@pytest.mark.parametrize("case", list(ENDS_FREE_CASES))
def test_align_ends_free(small_tree, case, m, n):
    ours, theirs = _cfgs(**ENDS_FREE_CASES[case])
    s1, s2 = _pair(m, n, seed=m + 3 * n + len(case), hi=16 if "iupac" in case else 5)
    sc, a1, a2 = ends_free.align_large(s1, s2, ours, device="cpu")
    _check_alignment(s1, s2, ours, theirs, sc, a1, a2, whole=False)
    assert align(s1, s2, ours, CPU) == (sc, a1, a2)


@pytest.mark.parametrize(
    "cfg,m,n",
    [(dict(match=3, mismatch=-2, gap=-4), 1, 5000), (dict(match=3, mismatch=-2, gap=-4), 5000, 1),
     (dict(mode="LOCAL", match=2, mismatch=-1, gap=-2), 1, 4000),
     (dict(mode="LOCAL", match=2, mismatch=-1, gap=-2), 4000, 1),
     (dict(mode="SEMIGLOBAL", match=2, mismatch=-1, gap=-2), 4000, 1),
     (dict(mode="INFIX", match=2, mismatch=-1, gap=-2), 4000, 1),
     (dict(mode="INFIX", match=2, mismatch=-1, gap=-2), 1, 4000),
     (dict(mode="INFIX", match=-5, mismatch=-5, gap=-2), 1, 4000),
     (dict(matrix="dna", gap=-3), 2, 3000)],
    ids=["nw-1-row-text", "nw-1-row-query", "sw-1-col", "sw-1-row", "sg-1-row",
         "infix-1-row", "infix-1-col", "infix-all-gaps", "dna-2-col"])
def test_one_row_and_one_column_tables(small_tree, monkeypatch, cfg, m, n):
    monkeypatch.setattr(band_align, "SW_WINDOW_LIMIT", 0)
    ours, theirs = _cfgs(**cfg)
    s1, s2 = _pair(m, n, seed=m + n)
    sc, a1, a2 = align(s1, s2, ours, CPU)
    whole = not (ours.is_local or ours.is_ends_free)
    _check_alignment(s1, s2, ours, theirs, sc, a1, a2, whole=whole)


def test_anchored_start_cannot_split(small_tree, monkeypatch):
    """Two co-optimal SW hits: the forward end locate takes the first hit's
    end, and an unanchored reverse locate (the JAX package's) the second
    hit's start, whose substring scores less: its "tie split".  The
    anchored start locate runs into the located end, so it finds the first
    hit's start."""
    monkeypatch.setattr(band_align, "SW_WINDOW_LIMIT", 0)
    cfg = ScoringConfig(match=2, mismatch=-3, gap=-4, mode=AlignMode.LOCAL)
    jcfg = JaxScoring(match=2, mismatch=-3, gap=-4, mode=JaxMode.LOCAL)
    hit = np.array([1, 2, 3, 4, 4, 3, 2, 1, 1, 3, 1, 4] * 3, np.int8)
    rng = np.random.default_rng(6)
    junk = rng.integers(1, 5, 600).astype(np.int8)
    s1 = np.concatenate([rng.integers(1, 5, 50).astype(np.int8), hit, junk, hit,
                         rng.integers(1, 5, 40).astype(np.int8)])
    s2 = hit.copy()
    vmax, i_end, j_end = band_align.locate_all(torch.from_numpy(s1), torch.from_numpy(s2), cfg)
    assert vmax == 2 * hit.size and (i_end, j_end) == (hit.size, 50 + hit.size)
    # the unanchored reverse locate lands on the other hit
    _, ir, jr = _scan_locate(s1[::-1].copy(), s2[::-1].copy(), jcfg, False)
    assert (s2.size - ir, s1.size - jr) != (0, 50)
    stats = {}
    sc, a1, a2 = band_align.align_local(s1, s2, cfg, device="cpu", stats=stats)
    assert stats["start"] == (0, 50) and stats["route"] == "core"
    assert sc == vmax == oracle.score(s1, s2, jcfg)
    assert a1 == a2 == _decode(hit)


def test_refusals():
    s1, s2 = _pair(30, 20, seed=2)
    with pytest.raises(ValueError, match="ends-free"):
        band_align.align_global(s1, s2, ScoringConfig(mode=AlignMode.SEMIGLOBAL), device="cpu")
    affine_sw = ScoringConfig(mode=AlignMode.LOCAL, gap_open=-3, gap_extend=-1)
    with pytest.raises(ValueError, match="ops/affine_align.py"):
        band_align.align_local(s1, s2, affine_sw, device="cpu")
    sc, a1, a2 = affine_align.align_local(s1, s2, affine_sw, device="cpu")  # served there
    assert sc == toracle.score(s1, s2, affine_sw) == toracle.alignment_score(a1, a2, affine_sw)
    with pytest.raises(ValueError, match="local"):
        band_align.align_local(s1, s2, ScoringConfig(gap=-2), device="cpu")
    with pytest.raises(ValueError, match="sg/infix"):
        band_align.locate_flex_device(s1, s2, ScoringConfig(), device="cpu")
    with pytest.raises(ValueError, match="matrix alphabet"):
        band_align.align_global(s1 + 5, s2, ScoringConfig(matrix=matrices.dna()), device="cpu")
    with pytest.raises(ValueError, match="int32 headroom"):
        band_align.align_global(s1, s2, ScoringConfig(match=1 << 24, gap=-(1 << 24)),
                                device="cpu")
    # affine ends-free alignment, once refused, reduces to a Myers-Miller core
    affine_sg = ScoringConfig(mode=AlignMode.SEMIGLOBAL, gap_open=-3, gap_extend=-1)
    b1, b2 = _pair(300, 200, seed=1)
    sc, a1, a2 = ends_free.align_large(b1, b2, affine_sg, device="cpu")
    assert sc == toracle.score(b1, b2, affine_sg) == toracle.alignment_score(a1, a2, affine_sg)
    assert a1.replace("-", "") in _decode(b1) and a2.replace("-", "") in _decode(b2)
