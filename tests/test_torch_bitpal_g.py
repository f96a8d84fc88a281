"""The port's (1, 0, -g) fills (``tpualign_torch.ops.bitpal.fill_g_plain``,
the plain version of the K2 and K4 ports) against the JAX package: K2's
final column and K4's capture streams row for row (Pallas in interpret
mode), and g = 2..7 scores against ``tpualign``'s bit-parallel engine and
oracle.  Inputs come from numpy with a seed; JAX gets codes 1..4 (its
kernels send code 0 to the plane of code 2, ROADMAP queue 3), and code 0 is
held to the oracle.  Every comparison is exact integer equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpualign.config import ScoringConfig as JaxScoring
from tpualign.ops import bitpal as jbp
from tpualign.ops import oracle
from tpualign_torch import trace
from tpualign_torch.config import ScoringConfig
from tpualign_torch.ops import bitpal as tbp
from tpualign_torch.ops import oracle as toracle


def launches(kernel: str) -> int:
    """The launches of ``kernel`` counted so far in this process."""
    return trace.counters().get("launch." + kernel, 0)


def _codes(rng, size, lo=1):
    return rng.integers(lo, 5, size).astype(np.int8)


def _plain(query, text, g, cap_rows=None):
    nq = query.size
    eq = tbp._eq_planes(torch.from_numpy(query), nq)
    return tbp.fill_g_plain(torch.from_numpy(text), eq, nq, g, cap_rows)


def _jax_k2_rows(query, text, g):
    """Per-row final-column deltas from K2, run as ``_score_fn_build`` runs
    it (interpret mode), converted through :func:`planes_from_jax`."""
    nq, mt = query.size, text.size
    nw, rows, total = jbp._layout(nq, mt, jbp.UNROLL_INTERPRET)
    planes = jbp._g_call(
        jbp._pack_text(jnp.asarray(text, jnp.int32), mt),
        jbp._eq_planes(jnp.asarray(query, jnp.int32), nq, nw, rows),
        g, mt, rows, total, jbp.UNROLL_INTERPRET, nw, True,
    )
    return tbp.row_deltas(tbp.planes_from_jax([np.asarray(p) for p in planes], nq), nq, g)


K2_CASES = [(g, nq, 90) for g in (2, 3, 7) for nq in (1, 31, 64, 65, 130)]
K2_CASES += [(g, 65, mt) for g in (2, 3, 7) for mt in (1, 7)]


@pytest.mark.parametrize("g,nq,mt", K2_CASES)
def test_fill_g_plain_matches_jax_k2(g, nq, mt):
    rng = np.random.default_rng(100 * g + 1000 * nq + mt)
    query, text = _codes(rng, nq), _codes(rng, mt)
    planes, caps = _plain(query, text, g)
    assert len(planes) == tbp.n_planes(g) and caps.shape == (0, mt)
    assert torch.equal(tbp.row_deltas(planes, nq, g), _jax_k2_rows(query, text, g))


@pytest.mark.parametrize("g,nq,mt", [(1, 130, 40), (2, 130, 40), (2, 93, 7)])
def test_capture_streams_match_jax_k4(g, nq, mt):
    """K4's multi-row capture (one chunk) holds the bottom-row h_out of
    chosen 31-row words; word ``w`` runs 2w steps late, so column ``x`` of
    the stream of word ``w`` is entry ``x - 1 + 2w``.  The port captures
    the same DP rows ``31(w + 1)``, column ``x`` at entry ``x - 1``."""
    rng = np.random.default_rng(nq + 7 * mt + g)
    query, text = _codes(rng, nq), _codes(rng, mt)
    B = tbp.n_planes(g)
    unroll = jbp.UNROLL_INTERPRET
    nw, rows, _ = jbp._layout(nq, mt, unroll)
    t_steps = -(-(mt + 2 * (nw - 1)) // 16) * 16
    words = [w for w in range(nw) if 31 * (w + 1) <= nq]
    state, _, jcaps = jbp.chunk_call(
        jnp.asarray([0, mt], jnp.int32),
        jbp._pack_text(jnp.asarray(text, jnp.int32), t_steps),
        jnp.zeros((t_steps // jbp.stream_epw(B),), jnp.int32),
        jbp._eq_planes(jnp.asarray(query, jnp.int32), nq, nw, rows),
        jbp.init_chunk_state(rows, g),
        rows=rows, t_steps=t_steps, r_star=None, unroll=unroll, interpret=True,
        g=g, cap_slots=tuple((w % rows, w // rows) for w in words), nw=nw,
    )
    jcaps = np.asarray(jcaps) & ((1 << B) - 1)
    want = np.stack([jcaps[2 * w : 2 * w + mt, j] for j, w in enumerate(words)])
    planes, caps = _plain(query, text, g, [31 * (w + 1) for w in words])
    assert np.array_equal(caps.numpy(), want)
    jplanes = tbp.planes_from_jax([np.asarray(p) for p in state[:B]], nq)
    assert torch.equal(tbp.row_deltas(planes, nq, g), tbp.row_deltas(jplanes, nq, g))


@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("lo", [1, 0], ids=["codes1-4", "codes0-4"])
def test_captures_at_any_row_are_row_differences(g, lo):
    """Captures at rows that are and are not word bottoms equal the column
    differences of the port's full DP table, code 0 included."""
    rng = np.random.default_rng(g + 10 * lo)
    query, text = _codes(rng, 150, lo), _codes(rng, 37, lo)
    rows = [1, 2, 31, 63, 64, 65, 100, 128, 149, 150]
    planes, caps = _plain(query, text, g, rows)
    H = toracle.score_table(text, query, ScoringConfig(gap=-g)).astype(np.int64)
    assert np.array_equal(caps.numpy().astype(np.int64) - g, np.diff(H[rows], axis=1))
    assert np.array_equal(tbp.row_deltas(planes, 150, g).numpy(), np.diff(H[:, -1]))


@pytest.mark.parametrize("g", [2, 3, 4, 5, 6, 7])
def test_g_scores_match_jax_package(g):
    rng = np.random.default_rng(g)
    s1, s2 = _codes(rng, 70), _codes(rng, 90)
    got = tbp.score(s1, s2, ScoringConfig(gap=-g), device="cpu")
    jcfg = JaxScoring(gap=-g)
    assert got == jbp.score(s1, s2, jcfg, interpret=True) == oracle.score(s1, s2, jcfg)


G_FAMILY = [
    dict(match=1, mismatch=0, gap=-2),
    dict(match=2, mismatch=0, gap=-4),
    dict(match=3, mismatch=2, gap=-1),
    dict(match=1, mismatch=0, gap=-5),
    dict(match=1, mismatch=-2, gap=-10),
]


@pytest.mark.parametrize("m,n", [(50, 130), (130, 50), (64, 64), (1, 200), (200, 1)])
@pytest.mark.parametrize("cfg", G_FAMILY, ids=["1,0,-2", "2,0,-4", "3,2,-1", "1,0,-5",
                                               "1,-2,-10"])
def test_g_family_scores_match_oracle(cfg, m, n):
    rng = np.random.default_rng(m * 7 + n)
    s1, s2 = _codes(rng, m), _codes(rng, n)
    fam = tbp.family(ScoringConfig(**cfg))
    assert fam is not None and fam[1] >= 2
    assert tbp.score(s1, s2, ScoringConfig(**cfg), device="cpu") == oracle.score(
        s1, s2, JaxScoring(**cfg))


@pytest.mark.parametrize("g", [2, 7])
def test_code_zero_scores_match_oracle(g):
    rng = np.random.default_rng(40 + g)
    s1, s2 = _codes(rng, 120, lo=0), _codes(rng, 77, lo=0)
    assert 0 in s1 and 0 in s2
    got = tbp.score(s1, s2, ScoringConfig(gap=-g), device="cpu")
    assert got == oracle.score(s1, s2, JaxScoring(gap=-g))


def test_wrappers_on_cpu_are_the_plain_version():
    rng = np.random.default_rng(8)
    query, text = torch.from_numpy(_codes(rng, 150)), torch.from_numpy(_codes(rng, 40))
    eq = tbp._eq_planes(query, 150)
    before = (launches("bitpal_gfill"), launches("bitpal_capture_fill"))
    want, want_caps = tbp.fill_g_plain(text, eq, 150, 3, [5, 64, 150])
    got = tbp.fill_g(text, eq, 150, 3)
    got_c, got_caps = tbp.capture_fill(text, eq, 150, 3, [5, 64, 150])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got_c, want))
    assert torch.equal(got_caps, want_caps) and got_caps.dtype == torch.int8
    # the counts are of kernel launches
    assert (launches("bitpal_gfill"), launches("bitpal_capture_fill")) == before


def test_fill_plain_is_fill_g_plain_at_g1():
    rng = np.random.default_rng(9)
    query, text = torch.from_numpy(_codes(rng, 100)), torch.from_numpy(_codes(rng, 30))
    eq = tbp._eq_planes(query, 100)
    assert all(torch.equal(a, b) for a, b in zip(
        tbp.fill_plain(text, eq, 100), tbp.fill_g_plain(text, eq, 100, 1)[0]))


@pytest.mark.parametrize(
    "kwargs,match",
    [(dict(g=0), "g must be"), (dict(g=8), "g must be"), (dict(g=2.0), "g must be"),
     (dict(cap_rows=[0]), "1..70"), (dict(cap_rows=[71]), "1..70"),
     (dict(cap_rows=[5, 3]), "ascending"), (dict(cap_rows=[4, 4]), "ascending")],
    ids=["g0", "g8", "g-float", "row0", "row-past-nq", "descending", "repeated"],
)
def test_fills_refuse_bad_arguments(kwargs, match):
    text = torch.ones(10, dtype=torch.int8)
    eq = tbp._eq_planes(torch.ones(70, dtype=torch.int8), 70)
    args = dict(g=2, cap_rows=[1, 70]) | kwargs
    with pytest.raises(ValueError, match=match):
        tbp.capture_fill(text, eq, 70, args["g"], args["cap_rows"])
    with pytest.raises(ValueError, match=match):
        tbp.fill_g_plain(text, eq, 70, args["g"], args["cap_rows"])
    if "g" in kwargs:
        with pytest.raises(ValueError, match=match):
            tbp.fill_g(text, eq, 70, args["g"])


def test_fills_refuse_bad_tensors():
    text = torch.ones(10, dtype=torch.int8)
    eq = tbp._eq_planes(torch.ones(70, dtype=torch.int8), 70)
    with pytest.raises(ValueError, match="int8"):
        tbp.fill_g(text.long(), eq, 70, 2)
    with pytest.raises(ValueError, match="shape"):
        tbp.capture_fill(text, eq, 200, 2, [1])
    with pytest.raises(ValueError, match="cpu or cuda"):
        tbp.fill_g(text.to("meta"), eq.to("meta"), 70, 2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tbp.capture_fill(text.to("meta"), eq.to("meta"), 70, 2, [1])


@pytest.mark.parametrize("g,B", [(1, 2), (2, 3), (3, 3), (4, 4), (7, 4)])
def test_plane_count(g, B):
    assert tbp.n_planes(g) == B
    assert len(tbp.fill_g(torch.ones(3, dtype=torch.int8),
                          tbp._eq_planes(torch.ones(5, dtype=torch.int8), 5), 5, g)) == B
