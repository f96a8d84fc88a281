"""The port's bit-parallel engine (``tpualign_torch.ops.bitpal``) against the
JAX package: the K1 fill row for row (Pallas in interpret mode), and scores
against ``score_bigint``, the oracle and the XLA engine.  Inputs come from
numpy with a seed; every comparison is exact integer equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpualign.config import ScoringConfig as JaxScoring
from tpualign.ops import bitpal as jbp
from tpualign.ops import oracle, xla
from tpualign_torch.config import ScoringConfig
from tpualign_torch.ops import bitpal as tbp


def _codes(rng, size, lo=1):
    return rng.integers(lo, 5, size).astype(np.int8)


def _jax_k1_rows(query, text, lean):
    """Per-row final-column deltas from K1, run as ``_score_fn_build`` runs
    it (interpret mode), converted through :func:`planes_from_jax`."""
    nq, mt = query.size, text.size
    nw, rows, total = jbp._layout(nq, mt, jbp.UNROLL_INTERPRET)
    b0, b1 = jbp._bitpal_call(
        jbp._pack_text(jnp.asarray(text, jnp.int32), mt),
        jbp._eq_planes(jnp.asarray(query, jnp.int32), nq, nw, rows),
        mt=mt, rows=rows, total=total, unroll=jbp.UNROLL_INTERPRET, nw=nw,
        interpret=True, lean=lean,
    )
    return tbp.row_deltas(tbp.planes_from_jax([b0, b1], nq), nq)


def _plain_rows(query, text):
    nq = query.size
    eq = tbp._eq_planes(torch.from_numpy(query), nq)
    return tbp.row_deltas(tbp.fill_plain(torch.from_numpy(text), eq, nq), nq)


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "base"])
@pytest.mark.parametrize("mt", [1, 7, 90])
@pytest.mark.parametrize("nq", [1, 31, 32, 63, 64, 65, 130])
def test_fill_plain_matches_jax_k1(nq, mt, lean):
    rng = np.random.default_rng(1000 * nq + mt)
    query, text = _codes(rng, nq), _codes(rng, mt)
    assert torch.equal(_plain_rows(query, text), _jax_k1_rows(query, text, lean))


def test_fill_wrapper_on_cpu_is_the_plain_version():
    """K1's contract runs through ``fill_g`` at g = 1 (``bitpal_gfill``)."""
    rng = np.random.default_rng(7)
    query, text = torch.from_numpy(_codes(rng, 150)), torch.from_numpy(_codes(rng, 40))
    eq = tbp._eq_planes(query, 150)
    before = tbp.fill_g.launches
    got = tbp.fill_g(text, eq, 150, 1)
    want = tbp.fill_plain(text, eq, 150)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tbp.fill_g.launches == before  # the count is of kernel launches


def test_fill_wrapper_rejects_bad_arguments():
    text = torch.ones(10, dtype=torch.int8)
    eq = tbp._eq_planes(torch.ones(70, dtype=torch.int8), 70)
    with pytest.raises(ValueError, match="int8"):
        tbp.fill_g(text.long(), eq, 70, 1)
    with pytest.raises(ValueError, match="shape"):
        tbp.fill_g(text, eq, 200, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tbp.fill_g(torch.ones(20, dtype=torch.int8)[::2], eq, 70, 1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tbp.fill_g(text.to("meta"), eq.to("meta"), 70, 1)


@pytest.mark.parametrize(
    "nw,want",
    [(1, (1, 1)), (1024, (1, 1024)), (1025, (2, 513)), (4096, (4, 1024)),
     (16384, (16, 1024))],
)
def test_kernel_geometry(nw, want):
    assert tbp.kernel_geometry(nw) == want


def test_kernel_geometry_refuses_past_one_block():
    with pytest.raises(ValueError, match="one-block"):
        tbp.kernel_geometry(16385)
    with pytest.raises(ValueError, match="one-block"):
        tbp._orientation(16385 * 64, 16385 * 64)
    # one orientation fits: it is taken whatever the cost
    assert tbp._orientation(10, 16385 * 64) is True
    assert tbp._orientation(16385 * 64, 10) is False


def test_orientation_prefers_fewer_steps():
    assert tbp._orientation(127240, 126440) is True  # 64gb shape: longer query
    assert tbp._orientation(126440, 127240) is False
    assert tbp._orientation(500, 500) is True  # ties go to s1


SCALED = [
    dict(),
    dict(match=2, mismatch=0, gap=-2),
    dict(match=1, mismatch=-2, gap=-4),
    dict(match=5, mismatch=2, gap=-2),
]


@pytest.mark.parametrize("m,n", [(50, 130), (130, 50), (64, 64), (1, 200), (200, 1)])
@pytest.mark.parametrize("cfg", SCALED, ids=["unit", "2,0,-2", "1,-2,-4", "5,2,-2"])
def test_score_matches_bigint_and_oracle(cfg, m, n):
    rng = np.random.default_rng(m * 7 + n)
    s1, s2 = _codes(rng, m), _codes(rng, n)
    got = tbp.score(s1, s2, ScoringConfig(**cfg), device="cpu")
    jcfg = JaxScoring(**cfg)
    assert got == oracle.score(s1, s2, jcfg)
    assert got == jbp._from_unit(jcfg, m + n, jbp.score_bigint(s1, s2))


@pytest.mark.parametrize("m,n", [(0, 0), (0, 9), (9, 0)])
@pytest.mark.parametrize("cfg", SCALED, ids=["unit", "2,0,-2", "1,-2,-4", "5,2,-2"])
def test_score_empty_sequences(cfg, m, n):
    s1, s2 = np.ones(m, np.int8), np.full(n, 2, np.int8)
    got = tbp.score(s1, s2, ScoringConfig(**cfg), device="cpu")
    jcfg = JaxScoring(**cfg)
    assert got == jcfg.gap * (m + n) == oracle.score(s1, s2, jcfg)
    assert got == jbp.score(s1, s2, jcfg, interpret=True)


@pytest.mark.parametrize("m,n", [(37, 91), (91, 37), (300, 200)])
def test_code_zero_matches_oracle_and_xla(m, n):
    """Codes 0..4: the port matches 0 against 0, as oracle and xla do (K1
    and ``score_bigint`` do not, so they are not the reference here)."""
    rng = np.random.default_rng(m + 1000 * n)
    s1, s2 = _codes(rng, m, lo=0), _codes(rng, n, lo=0)
    assert 0 in s1 and 0 in s2
    got = tbp.score(s1, s2, device="cpu")
    assert got == oracle.score(s1, s2) == xla.score(s1, s2, JaxScoring())


def test_score_fn_returns_a_tensor_and_checks_lengths():
    rng = np.random.default_rng(3)
    s1, s2 = _codes(rng, 80), _codes(rng, 120)
    fn = tbp.score_fn(80, 120, device="cpu")
    got = fn(torch.from_numpy(s1), torch.from_numpy(s2))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == oracle.score(s1, s2)
    with pytest.raises(ValueError, match="lengths"):
        fn(torch.from_numpy(s2), torch.from_numpy(s1))


def test_score_refuses_codes_outside_bdna():
    with pytest.raises(ValueError, match="0..4"):
        tbp.score(np.array([1, 5], np.int8), np.array([1], np.int8), device="cpu")
