"""The port's flat anti-diagonal engine (``tpualign_torch.ops.pallas_diag``)
on the CPU against the TPU kernel it ports (``tpualign.ops.pallas_diag`` in
interpret mode) and the oracle, its refusals beside the JAX package's, and
its wrapper.  Inputs come from numpy with a seed; every comparison is exact
integer equality."""

import numpy as np
import pytest
import torch

from tpualign.config import AlignMode as JaxMode
from tpualign.config import ScoringConfig as JaxScoring
from tpualign.ops import oracle
from tpualign.ops import pallas_diag as jdiag
from tpualign_torch import matrices
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import pallas_diag


def _pair(m, n, seed, lo=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, 5, m).astype(np.int8),
            rng.integers(lo, 5, n).astype(np.int8))


@pytest.mark.parametrize("m,n", [(40, 30), (30, 40), (1, 25), (25, 1), (50, 50)])
@pytest.mark.parametrize("mode", ["GLOBAL", "LOCAL"])
def test_matches_tpu_kernel_in_interpret_mode(mode, m, n):
    kw = dict(match=2, mismatch=-1, gap=-2)
    s1, s2 = _pair(m, n, seed=m * 7 + n)
    want = jdiag.score(s1, s2, JaxScoring(mode=JaxMode[mode], **kw), interpret=True)
    got = pallas_diag.score(s1, s2, ScoringConfig(mode=AlignMode[mode], **kw), device="cpu")
    assert got == want


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(match=1, mismatch=0, gap=0), dict(match=3, mismatch=1, gap=-2),
     dict(match=5, mismatch=-4, gap=-3)],
    ids=["unit", "gap0", "positive-mismatch", "5,-4,-3"],
)
@pytest.mark.parametrize("mode", ["GLOBAL", "LOCAL"])
def test_score_matches_oracle(mode, kw):
    s1, s2 = _pair(120, 77, seed=len(kw) + len(mode), lo=0)
    want = oracle.score(s1, s2, JaxScoring(mode=JaxMode[mode], **kw))
    assert pallas_diag.score(s1, s2, ScoringConfig(mode=AlignMode[mode], **kw),
                             device="cpu") == want
    assert pallas_diag.score(s2, s1, ScoringConfig(mode=AlignMode[mode], **kw),
                             device="cpu") == oracle.score(s2, s1, JaxScoring(
                                 mode=JaxMode[mode], **kw))


@pytest.mark.parametrize("m,n", [(0, 0), (0, 5), (5, 0)])
@pytest.mark.parametrize("mode", ["GLOBAL", "LOCAL"])
def test_empty_inputs(mode, m, n):
    s1, s2 = np.ones(m, np.int8), np.ones(n, np.int8)
    got = pallas_diag.score(s1, s2, ScoringConfig(mode=AlignMode[mode], gap=-3), device="cpu")
    assert got == jdiag.score(s1, s2, JaxScoring(mode=JaxMode[mode], gap=-3), interpret=True)


@pytest.mark.parametrize(
    "kw,match",
    [(dict(matrix=matrices.dna()), "pair-scored"),
     (dict(mode="SEMIGLOBAL"), "pair-scored"), (dict(mode="INFIX"), "pair-scored"),
     (dict(gap_open=-3, gap_extend=-1), "affine"), (dict(gap=1), "gap <= 0"),
     (dict(match=1 << 22, gap=-1), "int32 headroom")],
    ids=["matrix", "semiglobal", "infix", "affine", "positive-gap", "headroom"],
)
def test_refuses_what_the_jax_package_refuses(kw, match):
    mode = kw.pop("mode", "GLOBAL")
    s1, s2 = _pair(100, 90, seed=1)
    with pytest.raises(ValueError, match=match):
        pallas_diag.score(s1, s2, ScoringConfig(mode=AlignMode[mode], **kw), device="cpu")
    with pytest.raises(ValueError):
        jdiag.score(s1, s2, JaxScoring(mode=JaxMode[mode], **kw), interpret=True)


def test_local_positive_gap_is_served():
    kw = dict(match=2, mismatch=-1, gap=1)
    s1, s2 = _pair(30, 20, seed=2)
    got = pallas_diag.score(s1, s2, ScoringConfig(mode=AlignMode.LOCAL, **kw), device="cpu")
    assert got == oracle.score(s1, s2, JaxScoring(mode=JaxMode.LOCAL, **kw))


def test_wrapper_on_cpu_is_the_plain_version():
    s1, s2 = (torch.from_numpy(s) for s in _pair(60, 40, seed=3))
    cfg = ScoringConfig(mode=AlignMode.LOCAL, match=2, mismatch=-1, gap=-2)
    before = pallas_diag.diag_fill.launches
    got = pallas_diag.diag_fill(s1, s2, cfg)
    assert torch.equal(got, pallas_diag.score_plain(s1, s2, cfg))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert pallas_diag.diag_fill.launches == before  # the count is of kernel launches


def test_wrapper_rejects_bad_arguments():
    s1, s2 = torch.ones(10, dtype=torch.int8), torch.ones(7, dtype=torch.int8)
    cfg = ScoringConfig()
    with pytest.raises(ValueError, match="shorter"):
        pallas_diag.diag_fill(s2, s1, cfg)
    with pytest.raises(ValueError, match="int8"):
        pallas_diag.diag_fill(s1.long(), s2, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        pallas_diag.diag_fill(torch.ones(20, dtype=torch.int8)[::2], s2, cfg)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pallas_diag.diag_fill(s1.to("meta"), s2.to("meta"), cfg)
