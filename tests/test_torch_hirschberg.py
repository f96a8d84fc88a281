"""The port's Hirschberg alignment (``tpualign_torch.ops.hirschberg.align``)
on the CPU, where the fills run their plain versions: each alignment is
valid (stripping gaps gives back the inputs, and no column holds two gaps)
and scores exactly ``tpualign.ops.oracle.score``; a few cases are held to
``tpualign.ops.hirschberg.align`` in interpret mode.  The shapes follow
``tests/test_hirschberg.py``.  Codes 1..4 from numpy with a seed; code 0
(printed as ``-``, so the strings cannot be checked) is held to the
oracle's score."""

import numpy as np
import pytest

from tpualign.config import ScoringConfig as JaxScoring
from tpualign.ops import hirschberg as jhirschberg
from tpualign.ops import oracle
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import hirschberg
from tpualign_torch.ops import oracle as toracle

UNIT = ScoringConfig()


def _pair(m, n, seed, lo=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, 5, m).astype(np.int8),
            rng.integers(lo, 5, n).astype(np.int8))


def _decode(seq) -> str:
    return "".join(toracle.BASES[int(c)] for c in seq)


def _assert_valid(s1, s2, a1, a2):
    assert len(a1) == len(a2)
    assert a1.replace("-", "") == _decode(s1)
    assert a2.replace("-", "") == _decode(s2)
    assert not any(x == "-" and y == "-" for x, y in zip(a1, a2))


def _align(s1, s2, cfg=UNIT, base_cells=512, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hirschberg, "BASE_CELLS", base_cells)
        return hirschberg.align(s1, s2, cfg, device="cpu", **kw)


def _check(m, n, seed, cfg=UNIT, base_cells=512):
    s1, s2 = _pair(m, n, seed)
    stats = {}
    sc, a1, a2 = _align(s1, s2, cfg, base_cells, stats=stats)
    _assert_valid(s1, s2, a1, a2)
    jcfg = JaxScoring(match=cfg.match, mismatch=cfg.mismatch, gap=cfg.gap)
    want = oracle.score(s1, s2, jcfg)
    assert sc == want == toracle.alignment_score(a1, a2, cfg), (m, n, seed, sc, want)
    return stats


@pytest.mark.parametrize("m,n", [(8, 8), (40, 37), (64, 100), (150, 90), (200, 210)])
def test_optimal_and_valid(m, n):
    _check(m, n, seed=m + n)


def test_deep_recursion_tiny_base():
    stats = _check(120, 130, seed=1, base_cells=64)
    assert stats["binary_nodes"] >= 15 and stats["leaves"] == stats["binary_nodes"] + 1


def test_scaled_scoring():
    _check(90, 80, seed=2, cfg=ScoringConfig(match=3, mismatch=0, gap=-3))


@pytest.mark.parametrize("m,n", [(1, 50), (50, 1), (0, 9), (9, 0), (0, 0), (2, 2)])
def test_degenerate_lengths(m, n):
    _check(m, n, seed=3 + m)


def test_matches_exact_traceback_score():
    s1, s2 = _pair(70, 75, seed=5)
    sc, a1, a2 = _align(s1, s2, UNIT, base_cells=128)
    want_sc, w1, w2 = toracle.traceback(s1, s2, UNIT)
    assert sc == want_sc == toracle.alignment_score(w1, w2, UNIT)
    _assert_valid(s1, s2, a1, a2)


@pytest.mark.parametrize(
    "cfg", [ScoringConfig(gap=-2), ScoringConfig(match=3, mismatch=2, gap=-1),
            ScoringConfig(gap=-7)],
    ids=["g2", "3,2,-1", "g7"])
def test_generalized_gap_alignment(cfg):
    _check(130, 140, seed=11, cfg=cfg, base_cells=256)


@pytest.mark.parametrize("m,n", [(400, 12), (12, 400), (350, 31)])
def test_extreme_aspect_ratios(m, n):
    _check(m, n, seed=m * 7 + n, base_cells=256)


@pytest.fixture
def kway(monkeypatch):
    """The k-way split (normally from 8k query rows) on test-sized pairs."""
    monkeypatch.setattr(hirschberg, "KWAY_MIN_ROWS", 1200)
    monkeypatch.setattr(hirschberg, "KWAY_LEAF_ROWS", 310)


@pytest.mark.parametrize(
    "m,n,cfg",
    [(90, 1300, UNIT), (80, 64 * 20, UNIT), (70, 1333, ScoringConfig(gap=-2)),
     (60, 64 * 21, ScoringConfig(match=3, mismatch=2, gap=-1))],
    ids=["n1300", "n64x20", "g2-n1333", "3,2,-1-n64x21"])
def test_kway_row_split(kway, m, n, cfg):
    # n = 1300 and 1333 are not multiples of the 64-row word, 1280 and 1344
    # are; either way the forward and reverse fills capture the same rows
    stats = _check(m, n, seed=m + n, cfg=cfg, base_cells=4096)
    assert stats["kway_nodes"] >= 1


def test_kway_rows():
    assert hirschberg._kway_rows(9000) == list(range(640, 9000, 640))
    assert hirschberg._kway_rows(33 * 9000) == list(range(9000, 33 * 9000, 9000))


def test_kway_falls_back_to_binary_on_crossed_columns(kway, monkeypatch):
    # crossings that are not monotone never become segments: the node is
    # split binary instead
    real = hirschberg._kway_node

    def reversed_columns(*args):
        return real(*args).flip(0)

    monkeypatch.setattr(hirschberg, "_kway_node", reversed_columns)
    stats = _check(90, 1300, seed=99, base_cells=4096)
    assert stats["kway_nodes"] >= 1 and stats["binary_nodes"] >= 1


@pytest.mark.parametrize("g", [1, 2])
def test_code_zero_score_matches_oracle(g):
    s1, s2 = _pair(300, 200, seed=3, lo=0)
    assert 0 in s1 and 0 in s2
    sc, a1, a2 = _align(s1, s2, ScoringConfig(gap=-g))
    assert sc == oracle.score(s1, s2, JaxScoring(gap=-g))
    assert len(a1) == len(a2) >= 300


@pytest.mark.parametrize("m,n,cfg", [(64, 100, UNIT), (90, 80, ScoringConfig(gap=-2))],
                         ids=["unit", "g2"])
def test_matches_jax_hirschberg(m, n, cfg):
    s1, s2 = _pair(m, n, seed=m * n)
    jcfg = JaxScoring(match=cfg.match, mismatch=cfg.mismatch, gap=cfg.gap)
    jsc, j1, j2 = jhirschberg.align(s1, s2, jcfg, interpret=True, base_cells=512)
    sc, a1, a2 = _align(s1, s2, cfg)
    _assert_valid(s1, s2, a1, a2)
    _assert_valid(s1, s2, j1, j2)
    assert sc == jsc == oracle.score(s1, s2, jcfg)


@pytest.mark.parametrize(
    "cfg",
    [ScoringConfig(match=1, mismatch=1, gap=-1), ScoringConfig(gap=-8),
     ScoringConfig(mode=AlignMode.LOCAL), ScoringConfig(mode=AlignMode.SEMIGLOBAL),
     ScoringConfig(gap_open=-3, gap_extend=-1), ScoringConfig(matrix=((1, 0), (0, 1)))],
    ids=["mismatch-eq-match", "g8", "local", "semiglobal", "affine", "matrix"])
def test_configs_outside_the_family_raise(cfg):
    s1, s2 = _pair(10, 10, seed=0)
    with pytest.raises(ValueError, match="bit-parallel scoring family"):
        hirschberg.align(s1, s2, cfg, device="cpu")


def test_query_past_one_block_raises():
    s1 = np.ones(20, np.int8)
    s2 = np.ones(hirschberg.MAX_QUERY_ROWS + 1, np.int8)
    with pytest.raises(ValueError, match="item 5"):
        hirschberg.align(s1, s2, UNIT, device="cpu")


def test_codes_outside_bdna_raise():
    with pytest.raises(ValueError, match="0..4"):
        hirschberg.align(np.array([1, 5], np.int8), np.array([1], np.int8), UNIT,
                         device="cpu")
