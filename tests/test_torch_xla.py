"""The port's row scan (``tpualign_torch.ops.xla``) and its oracle's affine
branch (``tpualign_torch.ops.oracle``) on the CPU against the JAX package's
``tpualign.ops.xla.score``, ``oracle.score`` and ``oracle.score_table``.
Inputs come from numpy with a seed; every comparison is exact integer
equality."""

import numpy as np
import pytest
import torch

from tpualign.config import AlignMode as JaxMode
from tpualign.config import ScoringConfig as JaxScoring
from tpualign.ops import oracle, xla
from tpualign_torch import matrices
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import oracle as toracle
from tpualign_torch.ops import xla as txla

ASYM = ((1, -2, 0), (-1, 2, -3), (0, -1, 3))
CONFIGS = {
    "pair": dict(match=2, mismatch=-1, gap=-2),
    "gap0": dict(match=1, mismatch=0, gap=0),
    "matrix": dict(matrix=matrices.dna(2, -1, -3), gap=-3),
    "asym": dict(matrix=ASYM, gap=-1),
    "affine": dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2),
    "affine-matrix": dict(matrix=matrices.dna(2, -1, -3), gap_open=-4, gap_extend=-1),
    "affine-open0": dict(match=1, mismatch=-1, gap_open=0, gap_extend=-1),
}


def _case(mode, name, m, n, seed):
    kw = CONFIGS[name]
    hi = len(kw["matrix"]) if "matrix" in kw else 5
    rng = np.random.default_rng(seed)
    s1 = rng.integers(0, hi, m).astype(np.int8)
    s2 = rng.integers(0, hi, n).astype(np.int8)
    return (s1, s2, ScoringConfig(mode=AlignMode[mode], **kw),
            JaxScoring(mode=JaxMode[mode], **kw))


@pytest.mark.parametrize("m,n", [(33, 47), (47, 33), (1, 20), (20, 1)])
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("mode", [m.name for m in AlignMode])
def test_score_matches_jax_xla(mode, name, m, n):
    s1, s2, ours, theirs = _case(mode, name, m, n, seed=m * 31 + n)
    got = txla.score(s1, s2, ours, device="cpu")
    assert got == xla.score(s1, s2, theirs)
    assert got == oracle.score(s1, s2, theirs)


@pytest.mark.parametrize("m,n", [(0, 0), (0, 8), (8, 0)])
@pytest.mark.parametrize("name", ["pair", "affine"])
@pytest.mark.parametrize("mode", [m.name for m in AlignMode])
def test_empty_inputs_match_jax_xla(mode, name, m, n):
    s1, s2, ours, theirs = _case(mode, name, m, n, seed=1)
    assert txla.score(s1, s2, ours, device="cpu") == xla.score(s1, s2, theirs)


@pytest.mark.parametrize("m,n", [(25, 40), (40, 25), (0, 6), (6, 0)])
@pytest.mark.parametrize("name", ["affine", "affine-matrix", "affine-open0"])
@pytest.mark.parametrize("mode", [m.name for m in AlignMode])
def test_affine_oracle_matches_jax_oracle(mode, name, m, n):
    s1, s2, ours, theirs = _case(mode, name, m, n, seed=m + 7 * n)
    assert toracle.score(s1, s2, ours) == oracle.score(s1, s2, theirs)
    np.testing.assert_array_equal(toracle.score_table(s1, s2, ours),
                                  oracle.score_table(s1, s2, theirs))


def test_rows_scan_returns_last_row_best_and_column():
    s1, s2, ours, theirs = _case("GLOBAL", "pair", 30, 20, seed=3)
    table = oracle.score_table(s1, s2, theirs)
    h, best, col = txla.rows_scan(torch.from_numpy(s1), torch.from_numpy(s2), ours,
                                  zero_row=False, zero_col=False, want_best=True,
                                  want_col=True)[:3]
    assert h.tolist() == table[-1].tolist()
    assert int(best) == table[1:].max()
    assert col.tolist() == table[1:, -1].tolist()


@pytest.mark.parametrize("size", [2048, 2049, 2050, 4097, 70001])
def test_blocked_prefix_max_equals_cummax(size):
    """The in-row scan CUDA runs in blocks (``xla._PrefixMax``) gives
    ``torch.cummax``'s values, the tail block partial or not."""
    rng = np.random.default_rng(size)
    scan = txla._PrefixMax(size, torch.device("cpu"), blocked=True)
    assert scan.rows == (0 if size <= 4 * txla.SCAN_BLOCK else -(-size // txla.SCAN_BLOCK))
    jg = torch.arange(size, dtype=torch.int64) * -3
    for _ in range(3):
        t = torch.from_numpy(rng.integers(-10**6, 10**6, size))
        assert torch.equal(scan(t, jg), torch.cummax(t - jg, 0).values)


def test_refuses_codes_outside_the_matrix():
    cfg = ScoringConfig(matrix=ASYM)
    with pytest.raises(ValueError, match="matrix alphabet"):
        txla.score(np.array([0, 3], np.int8), np.array([1], np.int8), cfg, device="cpu")
    with pytest.raises(ValueError, match="matrix alphabet"):
        toracle.score(np.array([0, 3], np.int8), np.array([1], np.int8), cfg)
