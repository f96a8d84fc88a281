"""The port's checkpointed tracebacks on the CPU against the JAX package:
the checkpointed diagonal fill's plain version
(``tpualign_torch.ops.pallas_diag.ckpt_plain``, K9's contract) against the
TPU kernel (``tpualign.ops.pallas_diag.forward_checkpoints`` in interpret
mode) on the slots that lie in the table, ``v`` and ``dbest``;
``traceback_diag.align_diag`` string for string against ``tpualign``'s and
the oracle; ``traceback.align_checkpointed`` and ``xla.last_row`` against
``tpualign``'s; the refusals beside ``tpualign``'s; and ``align``'s new
routes past a lowered full-table limit against ``tpualign.align``.  Inputs
come from numpy with a seed; every comparison is exact."""

import numpy as np
import pytest
import torch

import tpualign
from tpualign import api as japi
from tpualign.config import AlignMode as JaxMode
from tpualign.config import EngineConfig as JaxEngine
from tpualign.config import ScoringConfig as JaxScoring
from tpualign.ops import oracle as joracle
from tpualign.ops import pallas_diag as jdiag
from tpualign.ops import traceback as jtraceback
from tpualign.ops import traceback_diag as jtraceback_diag
from tpualign.ops import xla as jxla
from tpualign_torch import EngineConfig, align, api
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import oracle, pallas_diag, traceback, traceback_diag, xla

CPU = EngineConfig(device="cpu")

CASES = {
    "nw": dict(),
    "sw": dict(mode="LOCAL", match=2, mismatch=-1, gap=-2),
    "sw-positive-mismatch": dict(mode="LOCAL", match=3, mismatch=1, gap=-2),
    "local-positive-gap": dict(mode="LOCAL", match=1, mismatch=-3, gap=1),
}
SHAPES = [(60, 50), (50, 60), (33, 3), (3, 33), (1, 20), (20, 1)]
STRIDES = (8, 16, 24)


def _cfgs(case):
    kw = dict(CASES[case])
    mode = kw.pop("mode", "GLOBAL")
    return (ScoringConfig(mode=AlignMode[mode], **kw),
            JaxScoring(mode=JaxMode[mode], **kw))


def _pair(m, n, seed, hi=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, hi, m).astype(np.int8),
            rng.integers(1, hi, n).astype(np.int8))


def _shape_case(case, shape):
    """The pair and the stride of one (config, shape) case: the strides
    rotate over the shapes, so every case's interpret-mode kernel compiles
    once and serves both tests that use it."""
    m, n = shape
    s1, s2 = _pair(m, n, seed=m * 31 + n + len(case))
    return s1, s2, STRIDES[SHAPES.index(shape) % len(STRIDES)]


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{m}x{n}" for m, n in SHAPES])
@pytest.mark.parametrize("case", list(CASES))
def test_ckpt_plain_matches_tpu_kernel(case, shape):
    ours, theirs = _cfgs(case)
    s1, s2, K = _shape_case(case, shape)
    m, n = s1.size, s2.size
    cka, ckb, v, dbest, _, groups = jdiag.forward_checkpoints(s1, s2, theirs, k_stride=K,
                                                              interpret=True)
    got = pallas_diag.ckpt_plain(torch.from_numpy(s1), torch.from_numpy(s2), ours, K)
    assert groups == -(-(n + m) // K)
    assert got.cka.shape == got.ckb.shape == (groups, n + 1)
    assert got.cka.dtype == got.ckb.dtype == torch.int32
    c = np.arange(groups)[:, None]
    k = np.arange(n + 1)[None, :]
    for ours_ck, theirs_ck, d in ((got.cka, cka, c * K), (got.ckb, ckb, c * K - 1)):
        live = (d - k >= 0) & (d - k <= m)
        want = np.asarray(theirs_ck).reshape(groups, -1)[:, : n + 1]
        assert np.array_equal(ours_ck.numpy()[live], want[live])
        assert (ours_ck.numpy()[~live] == pallas_diag.NEG_INF).all()  # the port's dead slots
    if ours.is_local:
        assert np.array_equal(got.v.numpy(), np.asarray(v).reshape(-1)[: n + 1])
        assert np.array_equal(got.dbest.numpy(), np.asarray(dbest).reshape(-1)[: n + 1])
        assert got.v.dtype == got.dbest.dtype == torch.int32
    else:
        assert got.v is None and got.dbest is None
    # the entry point rounds the stride up to a multiple of 8, as tpualign's
    ck = pallas_diag.forward_checkpoints(s1, s2, ours, k_stride=K - 5, device="cpu")
    assert all(a is b is None or torch.equal(a, b) for a, b in zip(ck, got))


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{m}x{n}" for m, n in SHAPES])
@pytest.mark.parametrize("case", list(CASES))
def test_align_diag_matches_tpualign_and_oracle(case, shape):
    ours, theirs = _cfgs(case)
    s1, s2, K = _shape_case(case, shape)
    want = jtraceback_diag.align_diag(s1, s2, theirs, k_stride=K, interpret=True)
    stats = {}
    got = traceback_diag.align_diag(s1, s2, ours, k_stride=K, device="cpu", stats=stats)
    assert got == want == oracle.traceback(s1, s2, ours)
    assert stats["groups"] == -(-(s1.size + s2.size) // K)
    assert stats["bands"] >= (1 if got[0] else 0)


@pytest.mark.parametrize("case", ["nw", "sw"])
def test_align_diag_strides(case):
    ours, theirs = _cfgs(case)
    s1, s2 = _pair(90, 70, seed=73)
    want = oracle.traceback(s1, s2, ours)
    for k in (8, 24, 64):
        assert traceback_diag.align_diag(s1, s2, ours, k_stride=k, device="cpu") == want
        assert jtraceback_diag.align_diag(s1, s2, theirs, k_stride=k, interpret=True) == want
    # strides clamp to [8, 2^20]
    assert traceback_diag.align_diag(s1, s2, ours, k_stride=3, device="cpu") == want
    assert pallas_diag.ckpt_stride(3) == 8 and pallas_diag.ckpt_stride(1 << 30) == 1 << 20
    assert pallas_diag.ckpt_stride(20) == 24


def test_align_diag_sw_zero_and_empty():
    """All-mismatch SW gives the empty local alignment; an empty side goes
    to the oracle, as tpualign's."""
    kw = dict(match=1, mismatch=-2, gap=-2)
    ours = ScoringConfig(mode=AlignMode.LOCAL, **kw)
    theirs = JaxScoring(mode=JaxMode.LOCAL, **kw)
    s1 = np.full(40, 1, dtype=np.int8)
    s2 = np.full(40, 2, dtype=np.int8)
    assert traceback_diag.align_diag(s1, s2, ours, k_stride=16, device="cpu") == (0, "", "")
    assert jtraceback_diag.align_diag(s1, s2, theirs, k_stride=16, interpret=True) == (0, "", "")
    for a, b in ((s1[:0], s2), (s1, s2[:0])):
        assert (traceback_diag.align_diag(a, b, ScoringConfig(), device="cpu")
                == jtraceback_diag.align_diag(a, b, JaxScoring()))


@pytest.mark.parametrize("k", [8, 16, None], ids=["k8", "k16", "default"])
@pytest.mark.parametrize("case", ["nw", "sw", "sw-positive-mismatch"])
def test_align_checkpointed_matches_tpualign(case, k):
    ours, theirs = _cfgs(case)
    s1, s2 = _pair(90, 70, seed=5 + len(case))
    want = jtraceback.align_checkpointed(s1, s2, theirs, k=k)
    stats = {}
    got = traceback.align_checkpointed(s1, s2, ours, k=k, device="cpu", stats=stats)
    assert got == want == oracle.traceback(s1, s2, ours)
    assert stats["k"] == (k or 512) and stats["blocks"] >= 1


def test_align_checkpointed_default_stride_and_edges():
    assert [traceback.default_k(m, n) for m, n in ((100, 100), (126440, 127240),
                                                    (10**6, 10**6))] == [512, 2048, 131072]
    s1, s2 = _pair(30, 1, seed=2)
    for ours, theirs in (_cfgs("nw"), _cfgs("sw")):
        for a, b in ((s1, s2), (s2, s1), (s1[:0], s2), (s1, s2[:0])):
            assert (traceback.align_checkpointed(a, b, ours, k=8, device="cpu")
                    == jtraceback.align_checkpointed(a, b, theirs, k=8))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("case", ["nw", "sw", "local-positive-gap"])
def test_last_row_matches_jax(case, reverse):
    ours, theirs = _cfgs(case)
    s1, s2 = _pair(45, 33, seed=11)
    want = np.asarray(jxla.last_row(s1, s2, theirs, reverse=reverse))
    got = xla.last_row(s1, s2, ours, reverse=reverse, device="cpu")
    assert got.tolist() == want.tolist()
    table = joracle.score_table(s1[::-1] if reverse else s1, s2[::-1] if reverse else s2,
                                theirs.with_mode(JaxMode.GLOBAL))
    if not ours.is_local:
        assert got.tolist() == table[-1].tolist()
    empty = xla.last_row(s1, s2[:0], ours, reverse=reverse, device="cpu")
    assert empty.tolist() == np.asarray(jxla.last_row(s1, s2[:0], theirs)).tolist()


def test_refusals_beside_tpualign(monkeypatch):
    s1, s2 = _pair(50, 40, seed=3)
    t1, t2 = torch.from_numpy(s1), torch.from_numpy(s2)
    affine = dict(gap_open=-3, gap_extend=-1)
    refused = [
        (ScoringConfig(**affine), JaxScoring(**affine), "affine"),
        (ScoringConfig(mode=AlignMode.SEMIGLOBAL), JaxScoring(mode=JaxMode.SEMIGLOBAL),
         "ends-free"),
        (ScoringConfig(matrix=((0, 1), (1, 0))), JaxScoring(matrix=((0, 1), (1, 0))),
         "matrix"),
        (ScoringConfig(gap=1), JaxScoring(gap=1), "gap <= 0"),
        (ScoringConfig(match=2**24), JaxScoring(match=2**24), "headroom"),
    ]
    for ours, theirs, why in refused:
        with pytest.raises(ValueError):
            jtraceback_diag.align_diag(s1, s2, theirs, interpret=True)
        with pytest.raises(ValueError):
            traceback_diag.align_diag(s1, s2, ours, device="cpu")
        if why in ("gap <= 0", "headroom"):
            with pytest.raises(ValueError):
                jdiag.forward_checkpoints(s1, s2, theirs, interpret=True)
            with pytest.raises(ValueError, match=why):
                pallas_diag.forward_checkpoints(s1, s2, ours, device="cpu")
        if why in ("affine", "ends-free", "matrix"):
            with pytest.raises(ValueError):
                jtraceback.align_checkpointed(s1, s2, theirs)
            with pytest.raises(ValueError):
                traceback.align_checkpointed(s1, s2, ours, device="cpu")
    with pytest.raises(ValueError, match="linear-gap"):
        xla.last_row(s1, s2, ScoringConfig(**affine), device="cpu")
    with pytest.raises(ValueError, match="linear-gap"):
        jxla.last_row(s1, s2, JaxScoring(**affine))
    # the diagonal axis's cap, lowered in both packages
    monkeypatch.setattr(jdiag, "MAX_DIAG_ELEMS", s2.size + 2)
    monkeypatch.setattr(pallas_diag, "MAX_DIAG_ELEMS", s2.size + 2)
    with pytest.raises(ValueError, match="too long"):  # 50 rows on the diagonal axis
        jtraceback_diag.align_diag(s2, s1, JaxScoring(), interpret=True)
    with pytest.raises(ValueError, match="too long"):
        traceback_diag.align_diag(s2, s1, ScoringConfig(), device="cpu")
    assert traceback_diag.align_diag(s1, s2, ScoringConfig(), device="cpu") == \
        oracle.traceback(s1, s2, ScoringConfig())  # 40 rows: at the cap
    # the wrapper's own argument checks
    with pytest.raises(ValueError, match="multiple of 8"):
        pallas_diag.ckpt_fill(t1, t2, ScoringConfig(), 12)
    with pytest.raises(ValueError, match="int8"):
        pallas_diag.ckpt_fill(t1.long(), t2, ScoringConfig(), 8)
    with pytest.raises(ValueError, match="non-empty"):
        pallas_diag.ckpt_fill(t1, t2[:0], ScoringConfig(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        pallas_diag.ckpt_fill(t1[::2], t2, ScoringConfig(), 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pallas_diag.ckpt_fill(t1.to("meta"), t2.to("meta"), ScoringConfig(), 8)


def test_ckpt_fill_on_cpu_is_the_plain_version():
    s1, s2 = (torch.from_numpy(s) for s in _pair(70, 45, seed=8))
    ours = _cfgs("sw")[0]
    before = pallas_diag.ckpt_fill.launches
    got = pallas_diag.ckpt_fill(s1, s2, ours, 16)
    want = pallas_diag.ckpt_plain(s1, s2, ours, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pallas_diag.ckpt_fill.launches == before  # the count is of kernel launches
    # row 0: diagonal 0 holds H(0, 0) = 0 alone, diagonal -1 nothing
    assert got.cka[0, 0] == 0 and (got.cka[0, 1:] == pallas_diag.NEG_INF).all()
    assert (got.ckb[0] == pallas_diag.NEG_INF).all()


@pytest.fixture
def past_full_table(monkeypatch):
    """``align`` past the full table in both packages from tiny tables on."""
    monkeypatch.setattr(api, "FULL_TABLE_CELL_LIMIT", 3000)
    monkeypatch.setattr(japi, "FULL_TABLE_CELL_LIMIT", 3000)


@pytest.mark.parametrize("m,n", [(150, 120), (120, 150)])
def test_api_align_positive_mismatch_sw_takes_k9(past_full_table, m, n):
    """tpualign's band split refuses a local config with a positive
    mismatch (``tpualign/ops/band_align.py:950-954``), so its ``align``
    takes the diagonal-band traceback, and the port's with it."""
    ours, theirs = _cfgs("sw-positive-mismatch")
    s1, s2 = _pair(m, n, seed=m + n)
    stats = {}
    got = align(s1, s2, ours, CPU, stats=stats)
    assert got == tpualign.align(s1, s2, theirs, JaxEngine(impl="band", interpret=True))
    assert got == oracle.traceback(s1, s2, ours)
    assert stats["bands"] >= 1 and "fill_ms" in stats  # align_diag's split
    gap_cfg = _cfgs("local-positive-gap")
    got = align(s1, s2, gap_cfg[0], CPU)
    assert got == tpualign.align(s1, s2, gap_cfg[1], JaxEngine(impl="band", interpret=True))


@pytest.mark.parametrize("impl", ["oracle", "xla"])
@pytest.mark.parametrize("case", ["nw", "sw"])
def test_api_align_oracle_and_xla_take_the_checkpointed_traceback(past_full_table, case, impl):
    ours, theirs = _cfgs(case)
    s1, s2 = _pair(110, 90, seed=len(case) + len(impl))
    stats = {}
    got = align(s1, s2, ours, EngineConfig(impl=impl, device="cpu"), stats=stats)
    assert got == tpualign.align(s1, s2, theirs, JaxEngine(impl=impl))
    assert got == oracle.traceback(s1, s2, ours)
    assert stats["blocks"] >= 1 and stats["k"] == 512  # align_checkpointed's split


def test_api_align_falls_back_past_k9(past_full_table, monkeypatch):
    """Where the diagonal kernel refuses the pair (here past a lowered
    ``MAX_DIAG_ELEMS``), both packages go on to the checkpointed row-scan
    traceback."""
    monkeypatch.setattr(jdiag, "MAX_DIAG_ELEMS", 64)
    monkeypatch.setattr(pallas_diag, "MAX_DIAG_ELEMS", 64)
    ours, theirs = _cfgs("sw-positive-mismatch")
    s1, s2 = _pair(100, 80, seed=12)
    stats = {}
    got = align(s1, s2, ours, CPU, stats=stats)
    assert got == tpualign.align(s1, s2, theirs, JaxEngine(impl="band", interpret=True))
    assert got == oracle.traceback(s1, s2, ours)
    assert "blocks" in stats and "bands" not in stats
