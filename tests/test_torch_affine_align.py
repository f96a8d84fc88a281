"""The port's affine (Gotoh) alignment on the CPU, where the capture fill
(``tpualign_torch.ops.band.capture_fill``, K7's port) runs its plain
version: the affine capture's last rows (H, F) under the top-edge open
``tb`` against ``tpualign.ops.affine_align._scan`` and the TPU kernel in
interpret mode (``tpualign.ops.band_chunked.gotoh_rows`` and
``gotoh_locate_rows``), the affine located cells against ``_locate`` and
``_first_hit_fn``, the flagged leaf solver and Myers-Miller
(``tpualign_torch.ops.affine_align``) string for string against
``tpualign.ops.affine_align`` with both packages' leaf sizes lowered, and
the ends-free affine path and the infix column-0 end against
``tpualign.align``.  Inputs come from numpy with a seed; every comparison
is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpualign
from tpualign import api as japi
from tpualign import matrices as jmat
from tpualign.config import AlignMode as JaxMode
from tpualign.config import ScoringConfig as JaxScoring
from tpualign.ops import affine_align as jaffine
from tpualign.ops import band_chunked
from tpualign.ops import ends_free as jends_free
from tpualign.ops import oracle
from tpualign_torch import EngineConfig, align, api, matrices, trace
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import affine_align, band, band_align, ends_free
from tpualign_torch.ops import oracle as toracle


def launches(kernel: str) -> int:
    """The launches of ``kernel`` counted so far in this process."""
    return trace.counters().get("launch." + kernel, 0)


CPU = EngineConfig(device="cpu")
DNA = (matrices.dna(2, -1, -3), jmat.dna(2, -1, -3))


def _cfgs(mode="GLOBAL", matrix=False, **kw):
    kw = dict(dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2), **kw)
    ours, theirs = DNA if matrix else (None, None)
    return (ScoringConfig(mode=AlignMode[mode], matrix=ours, **kw),
            JaxScoring(mode=JaxMode[mode], matrix=theirs, **kw))


def _pair(m, n, seed, lo=1):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, 5, m).astype(np.int8), rng.integers(lo, 5, n).astype(np.int8)


def _decode(seq) -> str:
    return "".join(toracle.BASES[int(c)] for c in seq)


# -- the affine capture fill's contract --------------------------------------


@pytest.mark.parametrize("tb", ["open", "zero"])
@pytest.mark.parametrize("matrix", [False, True], ids=["pair", "dna"])
@pytest.mark.parametrize("m,n", [(37, 29), (12, 1), (1, 9)])
def test_last_rows_match_jax_scan(matrix, tb, m, n):
    """The plain capture's last rows H and F equal ``tpualign``'s
    Myers-Miller scan, under ``tb = gap_open`` and the waived ``tb = 0``."""
    ours, theirs = _cfgs(matrix=matrix)
    top = ours.gap_open if tb == "open" else 0
    s1, s2 = _pair(m, n, seed=m + 3 * n)
    H, F = jaffine._scan(s1.astype(np.int32), s2.astype(np.int32), theirs, top)
    got = band.capture_plain(torch.from_numpy(s1), torch.from_numpy(s2), ours, tb=top)
    assert got.row.tolist() == H.tolist() and got.f.tolist() == F.tolist()
    assert got.row.dtype == got.f.dtype == torch.int32


def test_capture_plain_matches_tpu_strip_kernel_rows():
    """Two strips of 128 rows: the TPU kernel's (H, F) last row under the
    waiver tb = 0 (``gotoh_rows``, the Myers-Miller building block)."""
    ours, theirs = _cfgs()
    s1, s2 = _pair(150, 200, seed=1)
    H, F = band_chunked.gotoh_rows(s1, s2, theirs, 0, rows=1, interpret=True)
    got = band.capture_plain(torch.from_numpy(s1), torch.from_numpy(s2), ours, tb=0)
    assert np.array_equal(got.row.numpy(), H) and np.array_equal(got.f.numpy(), F)


def test_capture_plain_matches_tpu_strip_kernel_locate():
    """The TPU kernel's last row and last column under a free top row
    (``gotoh_locate_rows``, the ends-free affine locate)."""
    ours, theirs = _cfgs("SEMIGLOBAL")
    s1, s2 = _pair(150, 200, seed=2)
    row, col = band_chunked.gotoh_locate_rows(s1, s2, theirs, zr=True, zc=False, rows=1,
                                              interpret=True)
    got = band.capture_plain(torch.from_numpy(s1), torch.from_numpy(s2),
                             ours.with_mode(AlignMode.GLOBAL), zero_row=True, col=True)
    assert np.array_equal(got.row.numpy(), row) and np.array_equal(got.col.numpy(), col)


@pytest.mark.parametrize("matrix", [False, True], ids=["pair", "dna"])
@pytest.mark.parametrize("m,n", [(60, 45), (45, 70)])
def test_affine_captures_and_cell_match_the_score_table(matrix, m, n):
    """Captured rows, the last column and the located cell under affine
    gaps, local and global, against ``tpualign.ops.oracle.score_table``."""
    for mode in ("LOCAL", "GLOBAL"):
        ours, theirs = _cfgs(mode, matrix)
        s1, s2 = _pair(m, n, seed=m * n, lo=1)
        H = oracle.score_table(s1, s2, theirs).astype(np.int64)
        rows = [1, n // 2, n - 1]
        got = band.capture_plain(torch.from_numpy(s1), torch.from_numpy(s2), ours, rows,
                                 col=True, cell=True)
        assert got.caps.tolist() == H[rows].tolist() and got.row.tolist() == H[n].tolist()
        assert got.col.tolist() == H[:, m].tolist()
        sub = H[1:, 1:]
        i, j = np.unravel_index(int(np.argmax(sub)), sub.shape)
        assert got.cell.tolist() == [int(sub[i, j]), i + 1, j + 1]


@pytest.mark.parametrize("matrix", [False, True], ids=["pair", "dna"])
@pytest.mark.parametrize("mismatch", [-1, -3])
def test_located_cells_match_jax(matrix, mismatch):
    """The local end cell equals ``_locate``'s, and the anchored start cell
    on the reversed prefixes ``_first_hit_fn``'s first hit of the optimum."""
    ours, theirs = _cfgs("LOCAL", matrix, mismatch=mismatch)
    s1, s2 = _pair(90, 70, seed=4 - mismatch, lo=1)
    best, ie, je = jaffine._locate(s1.astype(np.int32), s2.astype(np.int32), theirs)
    got = band_align.locate_all(torch.from_numpy(s1), torch.from_numpy(s2), ours)
    assert got == (best, ie, je) and best > 0
    r1, r2 = s1[:je][::-1].copy(), s2[:ie][::-1].copy()
    mb, nb = jaffine._bucket(r1.size), jaffine._bucket(r2.size)
    p1 = np.full(mb, jaffine._pad_code(theirs), np.int32)
    p1[: r1.size] = r1
    p2 = np.full(nb, jaffine._pad_code(theirs), np.int32)
    p2[: r2.size] = r2
    found, i2, j2 = jaffine._first_hit_fn(mb, nb, theirs)(
        jnp.asarray(p1), jnp.asarray(p2), jnp.int32(r2.size), jnp.int32(r1.size),
        jnp.int32(best))
    got = band_align.locate_all(torch.from_numpy(r1), torch.from_numpy(r2), ours, anchored=True)
    assert bool(found) and got == (best, int(i2), int(j2))


def test_capture_fill_affine_on_cpu_is_the_plain_version():
    ours, _ = _cfgs(matrix=True)
    s1, s2 = (torch.from_numpy(s) for s in _pair(50, 70, seed=4))
    before = launches("band_capture_affine")
    for tb in (None, 0, ours.gap_open):
        got = band.capture_fill(s1, s2, ours, [1, 32, 33, 70], col=True, cell=True, tb=tb,
                                geometry=(1, 32))
        want = band.capture_plain(s1, s2, ours, [1, 32, 33, 70], col=True, cell=True, tb=tb)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert int(got.f[0]) == int(got.row[0])  # F(n, 0) is H(n, 0)
    assert launches("band_capture_affine") == before
    with pytest.raises(ValueError, match=r"tb must lie in \[gap_open, 0\]"):
        band.capture_fill(s1, s2, ours, tb=1)
    with pytest.raises(ValueError, match="tb must lie"):
        band.capture_fill(s1, s2, ours, tb=ours.gap_open - 1)


# -- the leaf solver and Myers-Miller ----------------------------------------


@pytest.mark.parametrize("matrix", [False, True], ids=["pair", "dna"])
@pytest.mark.parametrize("m,n", [(0, 0), (0, 5), (6, 0), (1, 1), (9, 1), (1, 7), (23, 31)])
def test_base_align_matches_jax(matrix, m, n):
    ours, theirs = _cfgs(matrix=matrix)
    s1, s2 = _pair(m, n, seed=7 * m + n)
    for tb in (ours.gap_open, 0):
        for te in (ours.gap_open, 0):
            got = affine_align._base_align(s1, s2, ours, tb, te)
            assert got == jaffine._base_align(s1, s2, theirs, tb, te), (tb, te)


@pytest.fixture
def small_leaves(monkeypatch):
    """Leaves of a few hundred cells in both packages."""
    monkeypatch.setattr(affine_align, "BASE_CELLS", 300)
    monkeypatch.setattr(jaffine, "BASE_CELLS", 300)


ALIGN_CASES = {
    "global": dict(),
    "global-dna": dict(matrix=True),
    "global-open0": dict(gap_open=0, gap_extend=-1),
    "local": dict(mode="LOCAL"),
    "local-dna": dict(mode="LOCAL", matrix=True),
}


@pytest.mark.parametrize("m,n", [(70, 50), (40, 90)])
@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_myers_miller_matches_jax(small_leaves, case, m, n):
    ours, theirs = _cfgs(**ALIGN_CASES[case])
    s1, s2 = _pair(m, n, seed=m + n + len(case))
    stats = {}
    got = affine_align.align(s1, s2, ours, device="cpu", stats=stats)
    assert got == jaffine.align(s1, s2, theirs)
    assert got[0] == oracle.score(s1, s2, theirs) == toracle.alignment_score(*got[1:], ours)
    core = stats["core_stats"] if ours.is_local else stats
    assert core["leaves"] >= 1 and (ours.is_local or core["nodes"] >= 1)


def test_myers_miller_every_node_split(monkeypatch):
    """BASE_CELLS = 1: every segment with a column and two rows is split,
    down to single rows."""
    monkeypatch.setattr(affine_align, "BASE_CELLS", 1)
    monkeypatch.setattr(jaffine, "BASE_CELLS", 1)
    for mode in ("GLOBAL", "LOCAL"):
        ours, theirs = _cfgs(mode)
        s1, s2 = _pair(17, 21, seed=len(mode))
        assert affine_align.align(s1, s2, ours, device="cpu") == jaffine.align(s1, s2, theirs)


@pytest.mark.parametrize("insert_in", ["query", "text"])
def test_myers_miller_long_insertion(small_leaves, insert_in):
    """A 25-base insertion: one long gap, which crosses a node's middle row
    as a vertical gap (the F case) when the query carries it."""
    ours, theirs = _cfgs(gap_open=-5, gap_extend=-1)
    rng = np.random.default_rng(5)
    a = rng.integers(1, 5, 60).astype(np.int8)
    b = np.concatenate([a[:30], rng.integers(1, 5, 25).astype(np.int8), a[30:]])
    s1, s2 = (a, b) if insert_in == "query" else (b, a)
    stats = {}
    got = affine_align.align(s1, s2, ours, device="cpu", stats=stats)
    assert got == jaffine.align(s1, s2, theirs)
    gapped = got[1] if insert_in == "query" else got[2]
    assert "-" * 25 in gapped
    assert (stats["gap_nodes"] >= 1) == (insert_in == "query")


def test_positive_mismatch_local_is_served(small_leaves):
    """``tpualign`` refuses positive-mismatch local affine alignment past
    its full table; the port serves it with the oracle's score."""
    ours, theirs = _cfgs("LOCAL", match=3, mismatch=1)
    s1, s2 = _pair(80, 60, seed=9)
    with pytest.raises(ValueError, match="positive-mismatch"):
        jaffine.align_local(s1, s2, theirs)
    sc, a1, a2 = affine_align.align(s1, s2, ours, device="cpu")
    assert sc == oracle.score(s1, s2, theirs) == toracle.alignment_score(a1, a2, ours)
    assert a1.replace("-", "") in _decode(s1) and a2.replace("-", "") in _decode(s2)


def test_refusals():
    s1, s2 = _pair(30, 20, seed=2)
    with pytest.raises(ValueError, match="affine config"):
        affine_align.align(s1, s2, ScoringConfig(), device="cpu")
    with pytest.raises(ValueError, match="ends-free"):
        affine_align.align(s1, s2, _cfgs("INFIX")[0], device="cpu")
    with pytest.raises(ValueError, match="local affine"):
        affine_align.align_local(s1, s2, _cfgs()[0], device="cpu")
    assert affine_align.align(s1[:0], s2[:0], _cfgs()[0], device="cpu") == (0, "", "")


# -- through the public entry point ------------------------------------------


@pytest.fixture
def large_paths(monkeypatch):
    """Both packages past their full tables from small pairs on, with small
    Myers-Miller leaves."""
    for mod in (api, japi):
        monkeypatch.setattr(mod, "FULL_TABLE_CELL_LIMIT", 2000)
    monkeypatch.setattr(jends_free, "LEAF_CELLS", 2000)
    monkeypatch.setattr(affine_align, "BASE_CELLS", 400)
    monkeypatch.setattr(jaffine, "BASE_CELLS", 400)


@pytest.mark.parametrize(
    "case", [dict(mode="SEMIGLOBAL"), dict(mode="INFIX"), dict(mode="SEMIGLOBAL", matrix=True),
             dict(mode="INFIX", matrix=True), dict(matrix=True), dict(mode="LOCAL", matrix=True),
             dict(), dict(mode="LOCAL")],
    ids=["semiglobal", "infix", "semiglobal-dna", "infix-dna", "dna", "local-dna", "global",
         "local"])
def test_api_align_matches_jax(large_paths, case):
    ours, theirs = _cfgs(**case)
    s1, s2 = _pair(90, 70, seed=len(str(case)))
    got = align(s1, s2, ours, CPU)
    assert got == tpualign.align(s1, s2, theirs)
    assert got[0] == oracle.score(s1, s2, theirs) == toracle.alignment_score(*got[1:], ours)
    if not ours.is_ends_free:
        assert align(s1, s2, ours, EngineConfig(impl="oracle", device="cpu")) == got


@pytest.mark.parametrize("affine", [False, True], ids=["linear", "affine"])
def test_infix_end_in_column_zero_differs_from_jax(monkeypatch, affine):
    """An infix whose end cell is (n, 0) (every substitution costs more
    than its gaps): the port returns the query against gaps, as both
    oracles walk; ``tpualign``'s large path returns empty strings, which
    re-score to 0, not to the score (ROADMAP queue 3)."""
    for mod in (api, japi):
        monkeypatch.setattr(mod, "FULL_TABLE_CELL_LIMIT", 500)
    monkeypatch.setattr(jends_free, "LEAF_CELLS", 500)
    kw = dict(gap_open=-3, gap_extend=-2) if affine else dict(gap=-2)
    ours = ScoringConfig(mode=AlignMode.INFIX, match=-5, mismatch=-5, **kw)
    theirs = JaxScoring(mode=JaxMode.INFIX, match=-5, mismatch=-5, **kw)
    s1, s2 = _pair(1, 500, seed=3)
    sc = oracle.score(s1, s2, theirs)
    want = (sc, "-" * s2.size, _decode(s2))
    assert align(s1, s2, ours, CPU) == want == oracle.traceback(s1, s2, theirs)
    assert toracle.alignment_score(*want[1:], ours) == sc
    assert tpualign.align(s1, s2, theirs) == (sc, "", "")


def test_ends_free_affine_core_takes_myers_miller(large_paths, monkeypatch):
    calls = []
    real = affine_align.align
    monkeypatch.setattr(affine_align, "align", lambda *a, **k: calls.append(1) or real(*a, **k))
    ours, theirs = _cfgs("SEMIGLOBAL")
    s1, s2 = _pair(120, 80, seed=11)
    got = ends_free.align_large(s1, s2, ours, device="cpu")
    assert calls and got == tpualign.align(s1, s2, theirs)


# -- BWA-MEM's scheme (1, -4, -6, -1), global, through the entry point --------

BWA = dict(match=1, mismatch=-4, gap_open=-6, gap_extend=-1)


def _recorded_align(s1, s2, cfg):
    """``align`` on the CPU inside ``trace.recording``: its result, its
    stats and the counters its call moved."""
    trace.take()
    stats = {}
    with trace.recording():
        got = align(s1, s2, cfg, CPU, stats=stats)
    call = [c for c in trace.take() if c.name == "align"][-1]
    return got, stats, call.counters


@pytest.mark.parametrize("seed", range(6))
def test_bwa_mem_scheme_past_the_full_table(large_paths, seed):
    """BWA-MEM's default penalties on unrelated pairs past the full table,
    with nodes split into small leaves: the full-table traceback's optimum,
    and ``tpualign``'s strings.  Where optimal alignments tie, Myers-Miller's
    crossings may pick another of them than the full-table walk does (seeds
    3 and 5 here), so the strings are held to ``tpualign``'s Myers-Miller.  The
    walker's two clock readings add up to its whole, and the vertical-gap
    crossings are counted as ``stats`` has them."""
    ours, theirs = _cfgs(**BWA)
    s1, s2 = _pair(90, 80, seed=seed)
    got, stats, counters = _recorded_align(s1, s2, ours)
    want = toracle.traceback(s1, s2, ours)
    assert got[0] == want[0] == oracle.score(s1, s2, theirs)
    assert got == tpualign.align(s1, s2, theirs)
    assert toracle.alignment_score(*got[1:], ours) == got[0]
    assert stats["nodes"] >= 1 and counters["nodes.affine"] == stats["nodes"]
    assert counters.get("nodes.affine_gap", 0) == stats["gap_nodes"]
    assert counters["leaf_fill_ns"] > 0 and counters["leaf_trace_ns"] > 0
    assert counters["leaf_fill_ns"] + counters["leaf_trace_ns"] == counters["leaf_walk_ns"]
    assert stats["leaf_fill_s"] > 0 and stats["leaf_trace_s"] > 0
    assert stats["leaf_fill_s"] + stats["leaf_trace_s"] == pytest.approx(stats["leaf_walk_s"])


def test_bwa_mem_scheme_vertical_gap_crossing(large_paths):
    """A copy of the text with substitutions and a 5-base insertion across
    the query's middle row: the root's crossing is the F case (a vertical gap
    over rows mid and mid + 1), and the strings are the full-table
    traceback's."""
    ours, theirs = _cfgs(**BWA)
    rng = np.random.default_rng(1)
    s1 = rng.integers(1, 5, 90).astype(np.int8)
    s2 = s1.copy()
    s2[::13] = s2[::13] % 4 + 1
    s2 = np.concatenate([s2[:43], rng.integers(1, 5, 5).astype(np.int8), s2[43:]])
    got, stats, counters = _recorded_align(s1, s2, ours)
    assert got == toracle.traceback(s1, s2, ours) == tpualign.align(s1, s2, theirs)
    assert stats["gap_nodes"] >= 1 and counters["nodes.affine_gap"] == stats["gap_nodes"]
    assert counters["leaf_fill_ns"] > 0 and counters["leaf_trace_ns"] > 0
    assert counters["leaf_fill_ns"] + counters["leaf_trace_ns"] == counters["leaf_walk_ns"]
