"""The port's full-table oracle (``tpualign_torch.ops.oracle``: score table,
traceback, ends-free start, re-scoring) against ``tpualign.ops.oracle``,
string for string in every mode and with a matrix, and the port's
``align`` against ``tpualign.align``: the small path string for string, the
large paths (bit-parallel Hirschberg, the band split for every other
linear-gap config and Myers-Miller under affine gaps, forced on small pairs
by lowering the full-table limit) valid and optimal, and its refusals.  Inputs come from
numpy with a seed; comparisons are exact."""

import numpy as np
import pytest

import tpualign
from tpualign import config as jconfig
from tpualign.io.bdna import BASES
from tpualign.ops import oracle
from tpualign_torch import api
from tpualign_torch import AlignMode, EngineConfig, ScoringConfig, align
from tpualign_torch.ops import band_align, hirschberg
from tpualign_torch.ops import oracle as toracle

CPU = EngineConfig(device="cpu")

_DNA = ((0, -9, -9, -9, -9), (-9, 2, -1, 0, -1), (-9, -1, 2, -1, 0),
        (-9, 0, -1, 2, -1), (-9, -1, 0, -1, 2))

CONFIGS = [
    dict(), dict(match=2, mismatch=-1, gap=-3), dict(gap=-2),
    dict(mode="LOCAL", mismatch=-1, gap=-2), dict(mode="SEMIGLOBAL", gap=-2),
    dict(mode="INFIX", mismatch=-1), dict(matrix=_DNA, gap=-2),
    dict(matrix=_DNA, mode="LOCAL", gap=-3), dict(matrix=_DNA, mode="INFIX", gap=-1),
    dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2),
    dict(mode="LOCAL", match=2, mismatch=-1, gap_open=-5, gap_extend=-2),
    dict(mode="SEMIGLOBAL", match=2, mismatch=-1, gap_open=-3, gap_extend=-1),
    dict(mode="INFIX", mismatch=-1, gap_open=-2, gap_extend=-1),
    dict(gap_open=0, gap_extend=-1),
    dict(matrix=_DNA, gap_open=-4, gap_extend=-1),
    dict(matrix=_DNA, mode="LOCAL", gap_open=-4, gap_extend=-2),
    dict(matrix=_DNA, mode="SEMIGLOBAL", gap_open=-3, gap_extend=-1),
]
IDS = ["unit", "2,-1,-3", "g2", "local", "semiglobal", "infix", "matrix",
       "matrix-local", "matrix-infix", "affine", "affine-local", "affine-semiglobal",
       "affine-infix", "affine-open0", "affine-matrix", "affine-matrix-local",
       "affine-matrix-semiglobal"]


def _configs(kwargs):
    kwargs = dict(kwargs)
    mode = kwargs.pop("mode", "GLOBAL")
    return (ScoringConfig(mode=AlignMode[mode], **kwargs),
            jconfig.ScoringConfig(mode=jconfig.AlignMode[mode], **kwargs))


def _pair(m, n, seed, lo=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, 5, m).astype(np.int8),
            rng.integers(lo, 5, n).astype(np.int8))


@pytest.mark.parametrize("kwargs", CONFIGS, ids=IDS)
@pytest.mark.parametrize("m,n", [(0, 7), (7, 0), (1, 1), (60, 45), (45, 120)])
def test_traceback_matches_jax_package(kwargs, m, n):
    ours, theirs = _configs(kwargs)
    s1, s2 = _pair(m, n, seed=m + 31 * n, lo=0)
    assert toracle.traceback(s1, s2, ours) == oracle.traceback(s1, s2, theirs)


@pytest.mark.parametrize("kwargs", CONFIGS, ids=IDS)
def test_score_table_matches_jax_package(kwargs):
    ours, theirs = _configs(kwargs)
    s1, s2 = _pair(33, 41, seed=7, lo=0)
    got, want = toracle.score_table(s1, s2, ours), oracle.score_table(s1, s2, theirs)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kwargs", CONFIGS, ids=IDS)
def test_alignment_score_matches_jax_package(kwargs):
    ours, theirs = _configs(kwargs)
    rng = np.random.default_rng(3)
    # random columns: base/base, base/gap or gap/base, codes 1..4
    cols = rng.integers(0, 3, 200)
    b1, b2 = rng.integers(1, 5, 200), rng.integers(1, 5, 200)
    a1 = "".join("-" if c == 1 else BASES[x] for c, x in zip(cols, b1))
    a2 = "".join("-" if c == 2 else BASES[x] for c, x in zip(cols, b2))
    assert toracle.alignment_score(a1, a2, ours) == oracle.alignment_score(a1, a2, theirs)
    with pytest.raises(ValueError, match="differ in length"):
        toracle.alignment_score(a1, a2[:-1], ours)


def test_bases_match_jax_package():
    assert toracle.BASES == BASES


@pytest.mark.parametrize("kwargs", CONFIGS, ids=IDS)
def test_api_align_small_path_matches_jax_package(kwargs):
    ours, theirs = _configs(kwargs)
    s1, s2 = _pair(90, 70, seed=21)
    assert align(s1, s2, ours, CPU) == tpualign.align(s1, s2, theirs)


@pytest.mark.parametrize("cfg", [ScoringConfig(), ScoringConfig(gap=-3)], ids=["unit", "g3"])
def test_api_align_large_path_is_hirschberg(monkeypatch, cfg):
    monkeypatch.setattr(api, "FULL_TABLE_CELL_LIMIT", 5000)
    s1, s2 = _pair(150, 130, seed=8)
    sc, a1, a2 = align(s1, s2, cfg, CPU)
    assert a1.replace("-", "") == "".join(BASES[c] for c in s1)
    assert a2.replace("-", "") == "".join(BASES[c] for c in s2)
    jcfg = jconfig.ScoringConfig(gap=cfg.gap)
    assert sc == toracle.alignment_score(a1, a2, cfg) == oracle.score(s1, s2, jcfg)
    assert sc == tpualign.align(s1, s2, jcfg)[0]


@pytest.mark.parametrize(
    "cfg,item",
    [(ScoringConfig(mode=AlignMode.LOCAL), None),
     (ScoringConfig(mode=AlignMode.SEMIGLOBAL), None),
     (ScoringConfig(matrix=_DNA), None),
     (ScoringConfig(gap=-8), None),
     (ScoringConfig(gap_open=-3, gap_extend=-1), None)],
    ids=["local", "semiglobal", "matrix", "g8", "affine"])
def test_api_align_large_unported_configs_raise(monkeypatch, cfg, item):
    """Past the full table every config aligns (the band split over K7's
    port, or Myers-Miller over its affine capture fill): valid, with the
    oracle's score.  No config raises any more."""
    monkeypatch.setattr(api, "FULL_TABLE_CELL_LIMIT", 5000)
    s1, s2 = _pair(150, 130, seed=8)
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            align(s1, s2, cfg, CPU)
        return
    sc, a1, a2 = align(s1, s2, cfg, CPU)
    core1, core2 = a1.replace("-", ""), a2.replace("-", "")
    assert core1 in "".join(BASES[c] for c in s1) and core2 in "".join(BASES[c] for c in s2)
    if not (cfg.is_local or cfg.is_ends_free):
        assert len(core1) == s1.size and len(core2) == s2.size
    assert not any(x == "-" and y == "-" for x, y in zip(a1, a2))
    jcfg = _configs(dict(mode=cfg.mode.name, gap=cfg.gap, matrix=cfg.matrix,
                         gap_open=cfg.gap_open, gap_extend=cfg.gap_extend))[1]
    assert sc == toracle.alignment_score(a1, a2, cfg) == oracle.score(s1, s2, jcfg)


def test_api_align_refusals(monkeypatch):
    s1, s2 = _pair(30, 20, seed=2)
    # affine alignment, once refused, is tpualign's on the full table
    assert align(s1, s2, ScoringConfig(gap_open=-3, gap_extend=-1), CPU) == tpualign.align(
        s1, s2, jconfig.ScoringConfig(gap_open=-3, gap_extend=-1))
    # a family query past the one-block bit-parallel fill falls through to
    # the band split, as tpualign's align does
    monkeypatch.setattr(hirschberg, "MAX_QUERY_ROWS", 100)
    monkeypatch.setattr(api, "FULL_TABLE_CELL_LIMIT", 100)
    calls = []
    real = band_align.align_global
    monkeypatch.setattr(band_align, "align_global",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    b1, b2 = _pair(90, 140, seed=4)
    sc, a1, a2 = align(b1, b2, engine=CPU)
    assert calls and sc == oracle.score(b1, b2) == toracle.alignment_score(a1, a2)
    # impl="oracle" past the full table takes the checkpointed row-scan
    # traceback, as tpualign's align does: the oracle's strings
    monkeypatch.setattr(tpualign.api, "FULL_TABLE_CELL_LIMIT", 100)
    assert align(s1, s2, engine=EngineConfig(impl="oracle", device="cpu")) == tpualign.align(
        s1, s2, engine=jconfig.EngineConfig(impl="oracle")) == oracle.traceback(s1, s2)
