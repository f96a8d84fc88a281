"""The port's short-query and long-text score routes against the JAX package:
``tpualign_torch.ops.bitpal.route`` against ``tpualign``'s rule, scores on
every route (K3a at rc columns a step, K3b's chunks, K4's chunks with state)
against ``tpualign.ops.bitpal.score_fn`` in interpret mode, K3a's final
planes row for row, and the resumable fills' chunks against the one-launch
plain fill word for word.  Inputs come from numpy with a seed; scores and
planes are exact integers, so every comparison is equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpualign.config import AlignMode as JaxMode
from tpualign.config import ScoringConfig as JaxScoring
from tpualign.ops import bitpal as jbp
from tpualign.ops import oracle
from tpualign_torch import trace
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import bitpal as tbp


def launches(kernel: str) -> int:
    """The launches of ``kernel`` counted so far in this process."""
    return trace.counters().get("launch." + kernel, 0)


UNIT, SCALED = dict(), dict(match=2, mismatch=0, gap=-2)  # (1, 0, -1) and 2x it


def _codes(rng, size, lo=1):
    return rng.integers(lo, 5, size).astype(np.int8)


def _jax_route(m, n, g, rc, cap):
    """``tpualign``'s route from its own ``_layout``, ``_orientation`` and
    ``TEXT_SMEM_CAP`` (``_score_fn_build``): ``(kind, rc, s1_is_query)``,
    the query side None where the port keeps its own orientation."""
    s1q = jbp._orientation(m, n)
    nq, mt = (m, n) if s1q else (n, m)
    rows = jbp._layout(nq, mt)[1]
    if rc is None:
        rc = 4 if g == 1 and rows <= 16 else 1
    if mt > cap:
        return ("rc_chunk" if rc > 1 and g == 1 else "g_chunk"), rc, s1q
    if g > 1 or rc == 1:
        return "fill_g", 1, None
    return "rc", rc, s1q


Q_EDGE = 16 * 128 * 31  # 63,488: the longest query of 16 rows of 31-bit words
CAP = jbp.TEXT_SMEM_CAP
ROUTES = [
    # (m, n, g, cols_per_step, text_cap)
    (20000, 20000, 1, None, CAP),  # the smoke's pair: K3a
    (1000000, 10000, 1, None, CAP),  # the docstring's 1M x 10k: K3a, 10k the query
    (10000, 1000000, 1, None, CAP),
    (1000000, 60000, 1, None, CAP),
    (Q_EDGE, 1000000, 1, None, CAP), (Q_EDGE + 1, 1000000, 1, None, CAP),
    (1000000, Q_EDGE, 1, None, CAP), (1000000, Q_EDGE + 1, 1, None, CAP),
    (126440, 127240, 1, None, CAP),  # the 64gb shape: K1 on the port's orientation
    (126440, 127240, 1, 4, CAP),
    (1000, CAP, 1, None, CAP), (1000, CAP + 1, 1, None, CAP),  # mt = cap, cap + 1
    (CAP + 1, 1000, 1, 1, CAP), (CAP, 1000, 2, None, CAP), (CAP + 1, 1000, 2, None, CAP),
    (2000000, 200, 1, None, CAP), (4000000, 2000, 1, None, CAP),
    (2000000, 100000, 2, None, CAP), (2000000, 100000, 1, None, CAP),
    (300, 200, 1, 2, 64), (300, 200, 1, 3, 64), (300, 200, 1, 1, 64), (300, 200, 5, 1, 64),
    (50, 40, 2, 1, CAP), (50, 40, 1, 1, CAP), (50, 40, 1, 2, CAP), (50, 40, 7, None, CAP),
    (1, 1, 1, None, CAP), (1, 5000000, 3, None, CAP),
]


@pytest.mark.parametrize("m,n,g,rc,cap", ROUTES)
def test_route_is_tpualigns(m, n, g, rc, cap):
    cfg = ScoringConfig(gap=-g)
    kind, got_rc, s1q = tbp.route(m, n, cfg, rc, cap)
    want_kind, want_rc, want_s1q = _jax_route(m, n, g, rc, cap)
    assert (kind, got_rc) == (want_kind, want_rc)
    if want_s1q is None:  # one launch at one column a step: the port's cost model
        assert s1q == tbp._orientation(m, n)
    else:
        assert s1q == want_s1q


def test_route_edges():
    """The edges the table holds, spelled out."""
    assert tbp.route(Q_EDGE, 10**6)[:2] == ("rc", 4)
    assert tbp.route(Q_EDGE + 1, 10**6)[:2] == ("fill_g", 1)
    assert tbp.route(1000, CAP)[:2] == ("rc", 4)
    assert tbp.route(1000, CAP + 1)[:2] == ("rc_chunk", 4)
    assert tbp.route(1000, CAP + 1, ScoringConfig(gap=-2))[:2] == ("g_chunk", 1)
    assert tbp.route(10**6, 10**4) == ("rc", 4, False)  # 10k on the bit axis


@pytest.mark.parametrize(
    "cfg,rc",
    [(dict(gap=-2), 2), (dict(gap=-3), 4), (dict(), 0), (dict(), 5),
     (dict(mode="LOCAL"), None), (dict(gap_open=-2, gap_extend=-1), None)],
    ids=["g2-rc2", "g3-rc4", "rc0", "rc5", "local", "affine"],
)
def test_score_fn_refusals_match_tpualign(cfg, rc):
    """The counterpart of ``test_rc_rejects_higher_g``: the same inputs
    refused with the same messages."""
    mode = cfg.pop("mode", "GLOBAL")
    with pytest.raises(ValueError) as theirs:
        jbp.score_fn(50, 40, JaxScoring(mode=JaxMode[mode], **cfg), cols_per_step=rc)
    with pytest.raises(ValueError) as ours:
        tbp.score_fn(50, 40, ScoringConfig(mode=AlignMode[mode], **cfg), device="cpu",
                     cols_per_step=rc)
    assert str(ours.value) == str(theirs.value)


def _jax_score(s1, s2, cfg, **kw):
    fn = jbp.score_fn(s1.size, s2.size, JaxScoring(**cfg), interpret=True, **kw)
    return int(fn(jnp.asarray(s1, jnp.int32), jnp.asarray(s2, jnp.int32)))


@pytest.mark.parametrize("rc,cap", [(1, 64), (2, 64), (3, 64), (4, 64),
                                    (2, None), (3, None), (4, None)],
                         ids=["rc1-chunked", "rc2-chunked", "rc3-chunked", "rc4-chunked",
                              "rc2", "rc3", "rc4"])
def test_scores_match_tpualign_on_every_rc(rc, cap):
    """As ``tests/test_bitpal.py:test_chunked_text_rc_variants``: a capped
    text takes the chunked routes (K3b at rc > 1, K4's chunks at rc 1), an
    uncapped one K3a's one launch (rc 1 in one launch is K1's route, held in
    ``tests/test_torch_bitpal.py``)."""
    rng = np.random.default_rng(100 * rc + (cap or 0))
    # both fit 8 rows of the TPU's words, so tpualign puts the longer on the
    # bit axis: the text is the shorter, past the cap
    m, n = int(rng.integers(150, 400)), int(rng.integers(65, 150))
    s1, s2 = _codes(rng, m), _codes(rng, n)
    cfg = UNIT if rc % 2 else SCALED
    kw = dict(cols_per_step=rc) | (dict(text_cap=cap) if cap else {})
    kind = tbp.route(m, n, ScoringConfig(**cfg), rc, cap or tbp.TEXT_CAP)[0]
    assert kind == ({None: "rc", 64: "rc_chunk"}[cap] if rc > 1 else "g_chunk")
    got = tbp.score(s1, s2, ScoringConfig(**cfg), device="cpu", **kw)
    assert got == _jax_score(s1, s2, cfg, **kw) == oracle.score(s1, s2, JaxScoring(**cfg))


@pytest.mark.parametrize("g", [2, 3, 4, 5, 6, 7])
def test_chunked_g_scores_match_tpualign(g):
    """g >= 2 past the cap: K4's chunks with their state
    (``_score_chunked_fn``)."""
    rng = np.random.default_rng(g)
    m, n = int(rng.integers(150, 260)), int(rng.integers(65, 120))
    s1, s2 = _codes(rng, m), _codes(rng, n)
    cfg = dict(gap=-g) if g % 2 else dict(match=2, mismatch=0, gap=-2 * g)
    assert tbp.family(ScoringConfig(**cfg))[1] == g
    assert tbp.route(m, n, ScoringConfig(**cfg), None, 64)[0] == "g_chunk"
    got = tbp.score(s1, s2, ScoringConfig(**cfg), device="cpu", text_cap=64)
    assert got == _jax_score(s1, s2, cfg, text_cap=64) == oracle.score(s1, s2, JaxScoring(**cfg))


def _jax_k3a_rows(query, text, rc, lean):
    """Per-row final-column deltas from K3a, run as ``_score_fn_build`` runs
    it (interpret mode), converted through :func:`planes_from_jax`."""
    nq, mt = query.size, text.size
    unroll = jbp.UNROLL_INTERPRET
    nw, rows, _ = jbp._layout(nq, mt, unroll)
    max_off = (nw - 1) % rows + (rows + 1) * ((nw - 1) // rows)
    total = -(-(-(-mt // rc) + max_off) // unroll) * unroll
    b0, b1 = jbp._rc_call(
        jbp._pack_text(jnp.asarray(text, jnp.int32), mt),
        jbp._eq_planes(jnp.asarray(query, jnp.int32), nq, nw, rows),
        mt=mt, rows=rows, total=total, unroll=unroll, rc=rc, interpret=True, lean=lean,
    )
    return tbp.row_deltas(tbp.planes_from_jax([b0, b1], nq), nq)


@pytest.mark.parametrize("lean", [True, False], ids=["lean", "base"])
@pytest.mark.parametrize("rc", [2, 3, 4])
@pytest.mark.parametrize("nq,mt", [(1, 1), (31, 9), (64, 30), (65, 7), (130, 41)])
def test_fill_rc_plain_matches_jax_k3a(nq, mt, rc, lean):
    rng = np.random.default_rng(1000 * nq + 10 * mt + rc)
    query, text = _codes(rng, nq), _codes(rng, mt)
    eq = tbp._eq_planes(torch.from_numpy(query), nq)
    planes = tbp.fill_rc_plain(torch.from_numpy(text), eq, nq, rc)
    assert torch.equal(tbp.row_deltas(planes, nq), _jax_k3a_rows(query, text, rc, lean))


def _chunks_in_turn(text, eq, nq, g, rc, lengths):
    """The plain chunks of the given lengths (cycled) up to the last step."""
    nw, mt = eq.shape[1], text.shape[0]
    state, t0, i = tbp.init_state(nw, g, "cpu"), 0, 0
    while t0 < tbp.total_steps(mt, nw, rc):
        state = tbp.chunk_plain(text, eq, nq, g, rc, t0, lengths[i % len(lengths)], state)
        t0 += lengths[i % len(lengths)]
        i += 1
    return state.planes


@pytest.mark.parametrize("g,rc", [(1, 2), (1, 3), (1, 4)] + [(g, 1) for g in range(1, 8)])
def test_chunks_in_turn_equal_one_fill(g, rc):
    """Every chunk length from 1 to 30 steps; one chunk edge in the ramp
    (the first nw steps) and the rest past it; codes 0..4."""
    rng = np.random.default_rng(10 * g + rc)
    nq, mt = 200, 57  # 4 words: a ramp of 3 steps
    query, text = torch.from_numpy(_codes(rng, nq, 0)), torch.from_numpy(_codes(rng, mt, 0))
    eq = tbp._eq_planes(query, nq)
    whole = tbp.fill_rc_plain(text, eq, nq, rc) if rc > 1 else tbp.fill_g_plain(text, eq, nq, g)[0]
    for length in range(1, 31):
        for lengths in ([length], [2, length]):  # [2, ...]: an edge inside the ramp
            got = _chunks_in_turn(text, eq, nq, g, rc, lengths)
            assert all(torch.equal(a, b) for a, b in zip(got, whole)), (length, lengths)


def test_long_text_against_a_short_query_chunked():
    """ROADMAP item 5's 2,000,000-char text against a 200-char query: K3b's
    route in 3 chunks at the default cap.  The plain fill runs a Python
    step per four columns, so the text is cut 256-fold to 7,812 chars and
    the chunk so that it still runs 3 chunks, held against the one-launch
    plain fill; the card runs the full size (``chip_smoke.py``)."""
    nw = -(-200 // tbp.WORD)
    assert tbp.route(2000000, 200) == ("rc_chunk", 4, False)
    assert -(-tbp.total_steps(2000000, nw, 4) // tbp.chunk_steps(4)) == 3
    rng = np.random.default_rng(2)
    text, query = _codes(rng, 2000000 // 256), _codes(rng, 200)
    t_steps = tbp.chunk_steps(4, 3072)
    assert -(-tbp.total_steps(text.size, nw, 4) // t_steps) == 3
    t, q = torch.from_numpy(text), torch.from_numpy(query)
    eq = tbp._eq_planes(q, 200)
    chunked = tbp.fill_chunked(t, eq, 200, 1, 4, t_steps)
    whole = tbp.fill_g_plain(t, eq, 200, 1)[0]
    assert all(torch.equal(a, b) for a, b in zip(chunked, whole))


@pytest.mark.parametrize(
    "kw,g",
    [(dict(cols_per_step=4), 1), (dict(cols_per_step=3, text_cap=40), 1),
     (dict(text_cap=40), 1), (dict(cols_per_step=1, text_cap=40), 1),
     (dict(text_cap=40), 3), (dict(cols_per_step=1, text_cap=40), 7)],
    ids=["rc", "rc-chunked", "auto-chunked", "g1-chunked", "g3-chunked", "g7-chunked"])
def test_code_zero_matches_oracle(kw, g):
    """Codes 0..4: code 0 matches 0 on every route, as in the oracle."""
    rng = np.random.default_rng(g + len(kw))
    s1, s2 = _codes(rng, 173, 0), _codes(rng, 88, 0)
    assert 0 in s1 and 0 in s2
    cfg = ScoringConfig(gap=-g)
    assert tbp.score(s1, s2, cfg, device="cpu", **kw) == oracle.score(s1, s2, JaxScoring(gap=-g))


def test_k3a_code_zero_differs_from_jax_package():
    """ROADMAP queue 3: ``tpualign``'s K3a and K3b select the match plane
    as K1 does, so a text code 0 takes code 2's plane; the port's routes
    match 0 against 0, as the oracle does."""
    rng = np.random.default_rng(5)
    s1, s2 = _codes(rng, 300, 0), _codes(rng, 120, 0)
    want = oracle.score(s1, s2)
    for kw in (dict(cols_per_step=4), dict(cols_per_step=4, text_cap=64)):
        assert tbp.score(s1, s2, device="cpu", **kw) == want
        assert _jax_score(s1, s2, UNIT, **kw) != want


def test_wrappers_on_cpu_are_the_plain_versions():
    rng = np.random.default_rng(7)
    nq, mt = 150, 40
    query, text = torch.from_numpy(_codes(rng, nq)), torch.from_numpy(_codes(rng, mt))
    eq = tbp._eq_planes(query, nq)
    counts = [launches("bitpal_rc_fill"), launches("bitpal_rc_chunk"), launches("bitpal_gfill_chunk")]
    for rc in (2, 3, 4):
        assert all(torch.equal(a, b) for a, b in zip(tbp.fill_rc(text, eq, nq, rc),
                                                     tbp.fill_rc_plain(text, eq, nq, rc)))
    state = tbp.init_state(3, 1, "cpu")
    got = tbp.fill_rc_chunk(text, eq, nq, 4, 0, 5, state)
    want = tbp.chunk_plain(text, eq, nq, 1, 4, 0, 5, state)
    assert all(torch.equal(a, b) for a, b in zip(got.planes + (got.hand,),
                                                 want.planes + (want.hand,)))
    state = tbp.init_state(3, 5, "cpu")
    got = tbp.fill_g_chunk(text, eq, nq, 5, 0, 7, state)
    want = tbp.chunk_plain(text, eq, nq, 5, 1, 0, 7, state)
    assert all(torch.equal(a, b) for a, b in zip(got.planes + (got.hand,),
                                                 want.planes + (want.hand,)))
    # the counts are of kernel launches
    assert counts == [launches("bitpal_rc_fill"), launches("bitpal_rc_chunk"),
                      launches("bitpal_gfill_chunk")]


def test_wrappers_refuse_bad_arguments():
    text = torch.ones(10, dtype=torch.int8)
    eq = tbp._eq_planes(torch.ones(70, dtype=torch.int8), 70)
    with pytest.raises(ValueError, match="rc must be"):
        tbp.fill_rc(text, eq, 70, 1)
    with pytest.raises(ValueError, match="rc must be"):
        tbp.fill_rc(text, eq, 70, 5)
    with pytest.raises(ValueError, match="more than one only at g = 1"):
        tbp.chunk_plain(text, eq, 70, 2, 2, 0, 4, tbp.init_state(2, 2, "cpu"))
    with pytest.raises(ValueError, match="state planes"):
        tbp.fill_g_chunk(text, eq, 70, 2, 0, 4, tbp.init_state(2, 1, "cpu"))
    with pytest.raises(ValueError, match="state hand"):
        tbp.fill_rc_chunk(text, eq, 70, 2, 0, 4, tbp.WaveState(
            tbp.init_state(2, 1, "cpu").planes, torch.zeros(3, dtype=torch.uint8)))
    with pytest.raises(ValueError, match="t_steps"):
        tbp.fill_rc_chunk(text, eq, 70, 2, 0, 0, tbp.init_state(2, 1, "cpu"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tbp.fill_rc(text.to("meta"), eq.to("meta"), 70, 2)
    with pytest.raises(ValueError, match="blocks"):
        tbp.fill_rc(text, eq, 70, 2, blocks=0)
    with pytest.raises(ValueError, match="blocks"):
        tbp.fill_g_chunk(text, eq, 70, 1, 0, 4, tbp.init_state(2, 1, "cpu"), blocks=-1)
    assert tbp.wave_geometry(1) == (1, 32) and tbp.wave_geometry(1000) == (1, 1024)
    assert tbp.wave_geometry(1025) == (2, 544)


def test_one_block_refusal_on_the_new_routes(monkeypatch):
    """The rc and chunked routes refuse a query past one block as the
    one-launch route does, before any fill runs."""
    monkeypatch.setattr(tbp, "MAX_THREADS", 32)
    monkeypatch.setattr(tbp, "MAX_K", 1)
    with pytest.raises(ValueError, match="one-block"):
        tbp.score_fn(3000, 4000, device="cpu")  # rc 4, 47 words
    with pytest.raises(ValueError, match="one-block"):
        tbp.score_fn(3000, 4000, device="cpu", text_cap=100)
    assert tbp.route(3000, 4000) == ("rc", 4, False)
