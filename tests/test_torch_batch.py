"""The port's batch scoring (``tpualign_torch.align_score_batch``, K5's
port ``ops/bitpal.py:batch_fill`` and the strip kernel's batch contract
``ops/band_batch.py:batch_fill``, through their plain versions) on the CPU
against the JAX package: ``tpualign.ops.bitpal.score_batch`` (K5) and
``tpualign.ops.band_batch.score_batch`` (K7 in a scan) in interpret mode,
``tpualign.ops.xla.score_batch_affine``, and ``tpualign.align_score_batch``
under every engine, with the route each engine takes.  Inputs come from
numpy with a seed, codes 1..4 where the JAX kernels take part (K5 builds
no plane for code 0, ROADMAP queue 3); every comparison is exact integer
equality."""

import numpy as np
import pytest
import torch

import tpualign
from tpualign import matrices as jmatrices
from tpualign.config import AlignMode as JaxMode
from tpualign.config import EngineConfig as JaxEngine
from tpualign.config import ScoringConfig as JaxScoring
from tpualign.ops import band_batch as jband_batch
from tpualign.ops import bitpal as jbp
from tpualign.ops import oracle
from tpualign.ops import xla as jxla
from tpualign_torch import EngineConfig, ScoringConfig, AlignMode, align_score_batch, api
from tpualign_torch import matrices
from tpualign_torch.ops import band, band_batch, bitpal, pairs, xla


def _batch(count, seed, tmax, qmax, lo=1):
    rng = np.random.default_rng(seed)
    texts = [rng.integers(lo, 5, int(rng.integers(1, tmax))).astype(np.int8)
             for _ in range(count)]
    queries = [rng.integers(lo, 5, int(rng.integers(1, qmax))).astype(np.int8)
               for _ in range(count)]
    return texts, queries


def _configs(**kw):
    mode = kw.pop("mode", "GLOBAL")
    matrix = kw.pop("matrix", None)
    ours, theirs = dict(kw, mode=AlignMode[mode]), dict(kw, mode=JaxMode[mode])
    if matrix:
        ours["matrix"] = getattr(matrices, matrix)(2, -1, -3)
        theirs["matrix"] = getattr(jmatrices, matrix)(2, -1, -3)
    return ScoringConfig(**ours), JaxScoring(**theirs)


# --- K5: the bit-parallel batch ---------------------------------------------


@pytest.mark.parametrize("g", [1, 2, 7])
def test_bitpal_score_batch_matches_jax_k5(g):
    """Ragged pairs as ``tests/test_bitpal.py``'s batch tests draw them."""
    texts, queries = _batch(6, seed=1000 + g, tmax=200, qmax=150)
    ours, theirs = ScoringConfig(gap=-g), JaxScoring(gap=-g)
    got = bitpal.score_batch(texts, queries, ours, device="cpu")
    want = jbp.score_batch(texts, queries, theirs, interpret=True)
    assert got.dtype == np.int64
    assert got.tolist() == want.tolist() == [oracle.score(t, q, theirs)
                                             for t, q in zip(texts, queries)]


def test_bitpal_score_batch_degenerate():
    texts = [np.asarray([1, 2, 3], np.int8), np.empty(0, np.int8), np.asarray([4], np.int8)]
    queries = [np.empty(0, np.int8), np.asarray([1, 2], np.int8), np.asarray([4, 4], np.int8)]
    got = bitpal.score_batch(texts, queries, ScoringConfig(), device="cpu")
    want = jbp.score_batch(texts, queries, JaxScoring(), interpret=True)
    assert got.tolist() == want.tolist() == [-3, -2, 0]


def test_bitpal_score_batch_scales_a_family_member():
    """(3, 2, -1) is g = 2 of the family at multiplier 1; scores map back."""
    texts, queries = _batch(5, seed=31, tmax=90, qmax=130)
    ours, theirs = ScoringConfig(match=3, mismatch=2, gap=-1), JaxScoring(match=3, mismatch=2,
                                                                           gap=-1)
    got = bitpal.score_batch(texts, queries, ours, device="cpu")
    assert got.tolist() == jbp.score_batch(texts, queries, theirs, interpret=True).tolist()


@pytest.mark.parametrize("g", [1, 3, 5])
def test_batch_fill_plain_equals_per_pair_fill_word_for_word(g):
    """Each pair's planes, over all ``nw`` words (rows past its query
    included), are ``fill_g_plain``'s on its own text and match planes."""
    texts, queries = _batch(5, seed=40 + g, tmax=70, qmax=200)
    queries[2] = queries[2][:1]  # a one-row query among longer ones
    nq = torch.tensor([q.size for q in queries])
    mt = torch.tensor([t.size for t in texts])
    nw = -(-int(nq.max()) // bitpal.WORD)
    qpad = torch.full((5, nw * bitpal.WORD), -1, dtype=torch.int8)
    tpad = torch.zeros((5, int(mt.max())), dtype=torch.int8)
    for p, (t, q) in enumerate(zip(texts, queries)):
        qpad[p, : q.size] = torch.from_numpy(q)
        tpad[p, : t.size] = torch.from_numpy(t)
    eq = bitpal._eq_planes_batch(qpad)
    got = bitpal.batch_fill_plain(tpad, mt, eq, int(nq.max()), g)
    assert got.shape == (5, bitpal.n_planes(g), nw)
    for p, (t, q) in enumerate(zip(texts, queries)):
        own = bitpal._eq_planes(torch.from_numpy(q), q.size)
        assert torch.equal(eq[p, :, : own.shape[1]], own) and not eq[p, :, own.shape[1]:].any()
        want, _ = bitpal.fill_g_plain(torch.from_numpy(t), eq[p].contiguous(), int(nq.max()), g)
        assert torch.equal(got[p], torch.stack(want))


def test_batch_fill_wrapper_runs_the_plain_version_on_cpu():
    texts, queries = _batch(3, seed=5, tmax=40, qmax=70)
    planes = []
    for fill in (bitpal.batch_fill, bitpal.batch_fill_plain):
        tpad = torch.zeros((3, 39), dtype=torch.int8)
        qpad = torch.full((3, 128), -1, dtype=torch.int8)
        for p, (t, q) in enumerate(zip(texts, queries)):
            tpad[p, : t.size] = torch.from_numpy(t)
            qpad[p, : q.size] = torch.from_numpy(q)
        mt = torch.tensor([t.size for t in texts])
        planes.append(fill(tpad, mt, bitpal._eq_planes_batch(qpad), 128, 2))
    assert torch.equal(*planes)
    assert bitpal.batch_fill.launches == 0  # the plain version is no launch
    with pytest.raises(ValueError, match="eq must be"):
        bitpal.batch_fill(tpad, mt, torch.zeros((3, 5, 1), dtype=torch.int64), 128, 2)
    with pytest.raises(ValueError, match="g must be"):
        bitpal.batch_fill(tpad, mt, bitpal._eq_planes_batch(qpad), 128, 8)


def test_bitpal_score_batch_refusals(monkeypatch):
    texts, queries = _batch(3, seed=6, tmax=40, qmax=40)
    with pytest.raises(ValueError, match="bitpal engine requires"):
        bitpal.score_batch(texts, queries, ScoringConfig(gap=-8), device="cpu")
    big = ScoringConfig(match=1 << 20, mismatch=0, gap=-(1 << 20))
    long_t = [np.ones(600, np.int8)] * 2
    for q_len in (424, 423):  # the headroom rule over m_cap + n_cap, as in JAX
        long_q = [np.ones(q_len, np.int8)] * 2
        if q_len == 424:
            with pytest.raises(ValueError, match="int32 headroom"):
                bitpal.score_batch(long_t, long_q, big, device="cpu")
            with pytest.raises(ValueError, match="int32 headroom"):
                jbp.score_batch_fn(2, 600, q_len, JaxScoring(match=1 << 20, mismatch=0,
                                                             gap=-(1 << 20)), True)
        else:
            assert bitpal.score_batch(long_t, long_q, big, device="cpu").tolist() == [
                oracle.score(t, q, JaxScoring(match=1 << 20, mismatch=0, gap=-(1 << 20)))
                for t, q in zip(long_t, long_q)]
    # a query bucket past one block; the TPU caps (VMEM planes, SMEM text)
    # are not refusals of the port
    monkeypatch.setattr(bitpal, "MAX_THREADS", 1)
    monkeypatch.setattr(bitpal, "MAX_K", 1)
    with pytest.raises(ValueError, match="one-block"):
        bitpal.score_batch(texts, [np.ones(65, np.int8)] * 3, ScoringConfig(), device="cpu")
    with pytest.raises(ValueError, match="0..4"):
        bitpal.score_batch([np.asarray([5], np.int8)], [np.asarray([1], np.int8)],
                           ScoringConfig(), device="cpu")


def test_k5_code_zero_differs_from_jax_package():
    """ROADMAP queue 3: ``tpualign``'s K5 builds match planes for codes
    1..4 only, so code 0 does not match 0; the port's batch does, as the
    oracle does."""
    texts, queries = _batch(4, seed=5, tmax=300, qmax=200, lo=0)
    assert all(0 in t for t in texts) and all(0 in q for q in queries)
    got = bitpal.score_batch(texts, queries, ScoringConfig(), device="cpu")
    want = [oracle.score(t, q) for t, q in zip(texts, queries)]
    assert got.tolist() == want
    assert jbp.score_batch(texts, queries, JaxScoring(), interpret=True).tolist() != want


# --- K7's batch contract: the strip kernel, one block per pair --------------


BAND_CASES = {
    "nw": dict(match=3, mismatch=-2, gap=-4),
    "sw": dict(match=2, mismatch=-1, gap=-2, mode="LOCAL"),
    "semiglobal": dict(match=2, mismatch=-1, gap=-2, mode="SEMIGLOBAL"),
    "infix": dict(match=2, mismatch=-1, gap=-2, mode="INFIX"),
    "dna": dict(matrix="dna", gap=-3),
}


@pytest.mark.parametrize("case", list(BAND_CASES))
def test_band_score_batch_matches_jax_band_batch(case):
    """With an empty pair in the batch, as ``tests/test_band_batch.py``."""
    ours, theirs = _configs(**BAND_CASES[case])
    texts, queries = _batch(4, seed=17, tmax=60, qmax=90)
    texts.append(np.empty(0, np.int8))
    queries.append(np.asarray([1, 2, 3], np.int8))
    got = band_batch.score_batch(texts, queries, ours, device="cpu")
    want = jband_batch.score_batch(texts, queries, theirs, interpret=True)
    assert got.dtype == np.int64
    assert got.tolist() == want.tolist() == [oracle.score(t, q, theirs)
                                             for t, q in zip(texts, queries)]


@pytest.mark.parametrize("affine", [False, True], ids=["linear", "affine"])
@pytest.mark.parametrize("matrix", [None, "dna"], ids=["pair", "dna"])
@pytest.mark.parametrize("mode", [m.name for m in AlignMode])
def test_batch_plain_equals_per_pair_score_plain(mode, matrix, affine):
    """``xla.score_batch`` (the batch kernel's plain version) gives each
    pair ``band.score_plain``'s result, every pair in one orientation."""
    kw = dict(match=2, mismatch=-1, gap=-2, mode=mode, matrix=matrix)
    if affine:
        kw.update(gap_open=-5, gap_extend=-2)
    cfg, _ = _configs(**kw)
    texts, queries = _batch(6, seed=len(mode) + 10 * affine, tmax=50, qmax=50, lo=0)
    ends = band._ends_flags(cfg, False)
    packed = pairs.pack_pairs(texts, queries, np.arange(6))
    got = band_batch.batch_fill(packed, cfg, ends)
    want = [int(band.score_plain(torch.from_numpy(t), torch.from_numpy(q), cfg, ends))
            for t, q in zip(texts, queries)]
    assert got.tolist() == want
    assert band_batch.batch_fill.launches == 0


@pytest.mark.parametrize("case", ["global", "local"])
def test_score_batch_affine_matches_jax(case):
    kw = dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2,
              mode="LOCAL" if case == "local" else "GLOBAL")
    ours, theirs = _configs(**kw)
    texts, queries = _batch(5, seed=23, tmax=80, qmax=60)
    texts += [np.empty(0, np.int8), np.asarray([1, 2], np.int8), np.empty(0, np.int8)]
    queries += [np.asarray([3, 4], np.int8), np.empty(0, np.int8), np.empty(0, np.int8)]
    got = xla.score_batch_affine(texts, queries, ours, device="cpu")
    want = jxla.score_batch_affine(texts, queries, theirs)
    assert got.tolist() == want.tolist()
    assert band_batch.score_batch(texts, queries, ours, device="cpu").tolist() == want.tolist()


@pytest.mark.parametrize(
    "kw",
    [dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2, matrix="dna"),
     dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2, mode="SEMIGLOBAL"),
     dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2, mode="INFIX"),
     dict(match=3, mismatch=1, gap=-2, mode="LOCAL"),
     dict(match=3, mismatch=1, gap_open=-5, gap_extend=-2, mode="LOCAL")],
    ids=["affine-dna", "affine-semiglobal", "affine-infix", "masked-sw",
         "masked-affine-sw"])
def test_band_batch_serves_what_the_jax_batches_refuse(kw):
    """Configs ``tpualign`` scores through its per-pair loop: the port's
    strip batch gives the same scores."""
    ours, theirs = _configs(**kw)
    texts, queries = _batch(5, seed=29, tmax=70, qmax=70)
    texts.append(np.asarray([2], np.int8))
    queries.append(np.empty(0, np.int8))
    got = band_batch.score_batch(texts, queries, ours, device="cpu")
    assert got.tolist() == tpualign.align_score_batch(texts, queries, theirs).tolist()
    assert api.align_score_batch(texts, queries, ours, EngineConfig(device="cpu")).tolist() == (
        got.tolist())


def test_score_batch_affine_refuses_as_jax_does():
    texts, queries = _batch(2, seed=3, tmax=20, qmax=20)
    for kw in (dict(gap_open=-3, gap_extend=-1, matrix="dna"),
               dict(gap_open=-3, gap_extend=-1, mode="SEMIGLOBAL"),
               dict(gap_open=-3, gap_extend=-1, mode="INFIX"),
               dict(gap=-2)):
        ours, theirs = _configs(**kw)
        with pytest.raises(ValueError):
            jxla.score_batch_affine(texts, queries, theirs)
        with pytest.raises(ValueError):
            xla.score_batch_affine(texts, queries, ours, device="cpu")


def test_band_batch_refuses_the_int32_headroom():
    cfg = ScoringConfig(match=1 << 20, mismatch=0, gap=-(1 << 20), mode=AlignMode.LOCAL)
    with pytest.raises(ValueError, match="int32 headroom"):
        band_batch.score_batch([np.ones(300, np.int8)], [np.ones(213, np.int8)], cfg,
                               device="cpu")


# --- the public entry: routing, refusals ------------------------------------


def _spy_routes(monkeypatch):
    """Record which engine each call of ``align_score_batch`` reaches."""
    calls = []
    for module, name, tag in ((bitpal, "batch_fill", "k5"), (band_batch, "batch_fill", "band"),
                              (xla, "score_batch_affine", "xla"), (api, "align_score", "loop")):
        fn = getattr(module, name)

        def spy(*args, _fn=fn, _tag=tag, **kwargs):
            calls.append(_tag)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)
    return calls


ROUTES = {  # the route of each config under each impl
    "unit": {"auto": "k5", "bitpal": "k5", "band": "band", "xla": "loop", "oracle": "loop",
             "pallas": "loop"},
    "sw": {"auto": "band", "bitpal": "band", "band": "band", "xla": "loop", "oracle": "loop",
           "pallas": "loop"},
    "affine": {"auto": "band", "bitpal": "band", "band": "band", "xla": "xla",
               "oracle": "loop"},
}
ROUTE_CONFIGS = {"unit": dict(), "sw": dict(match=2, mismatch=-1, gap=-2, mode="LOCAL"),
                 "affine": dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2)}


@pytest.mark.parametrize("case,impl", [(c, i) for c in ROUTES for i in ROUTES[c]])
def test_align_score_batch_matches_jax_package_under_every_impl(case, impl, monkeypatch):
    ours, theirs = _configs(**ROUTE_CONFIGS[case])
    texts, queries = _batch(4, seed=1, tmax=30, qmax=30)
    want = tpualign.align_score_batch(texts, queries, theirs,
                                      JaxEngine(impl=impl, interpret=impl == "pallas"))
    calls = _spy_routes(monkeypatch)
    got = align_score_batch(texts, queries, ours, EngineConfig(impl=impl, device="cpu"))
    assert got.dtype == np.int64 and got.tolist() == want.tolist()
    route = ROUTES[case][impl]
    assert calls == ([route] * len(texts) if route == "loop" else [route])


def test_align_score_batch_falls_through_refusals(monkeypatch):
    """A refusal of the bit-parallel batch goes on to the strip batch, and
    one of the strip batch to the per-pair loop."""
    texts, queries = _batch(3, seed=8, tmax=40, qmax=40)
    want = [oracle.score(t, q) for t, q in zip(texts, queries)]
    monkeypatch.setattr(bitpal, "MAX_THREADS", 0)  # no query fits one block
    calls = _spy_routes(monkeypatch)
    got = align_score_batch(texts, queries, engine=EngineConfig(device="cpu"))
    assert got.tolist() == want and calls == ["band"]

    def refuse(*args):
        raise ValueError("refused")

    monkeypatch.setattr(band, "_check_cfg", refuse)
    calls.clear()
    aff, jaff = _configs(**ROUTE_CONFIGS["affine"])
    got = align_score_batch(texts, queries, aff, EngineConfig(impl="band", device="cpu"))
    assert got.tolist() == tpualign.align_score_batch(texts, queries, jaff).tolist()
    assert calls == ["loop"] * 3


def test_align_score_batch_validates_and_takes_an_empty_batch():
    with pytest.raises(ValueError, match="2 texts but 1 queries"):
        align_score_batch([np.ones(3, np.int8)] * 2, [np.ones(3, np.int8)],
                          engine=EngineConfig(device="cpu"))
    for cfg in (ScoringConfig(), ScoringConfig(mode=AlignMode.LOCAL),
                ScoringConfig(gap_open=-3, gap_extend=-1)):
        for impl in ("auto", "xla", "oracle"):
            got = align_score_batch([], [], cfg, EngineConfig(impl=impl, device="cpu"))
            assert got.dtype == np.int64 and got.shape == (0,)


def test_pack_pairs_concatenates_and_pads():
    texts = [np.asarray([1, 2, 3], np.int8), np.asarray([4], np.int8), [2, 2]]
    queries = [np.asarray([1], np.int8), np.asarray([3, 3, 3, 3], np.int8), [1, 4]]
    packed = pairs.pack_pairs(texts, queries, np.asarray([0, 2]))
    assert packed.texts.tolist() == [1, 2, 3, 2, 2]
    assert packed.offsets.tolist() == [[0, 3], [0, 1]]
    assert packed.lengths.tolist() == [[3, 2], [1, 2]]
    assert (packed.m_cap, packed.n_cap) == (3, 2)
    padded = pairs.pad_pairs(packed.texts, packed.offsets[0], packed.lengths[0], 4, fill=-1)
    assert padded.tolist() == [[1, 2, 3, -1], [2, 2, -1, -1]]
    with pytest.raises(ValueError, match="fit int8"):
        pairs.pack_pairs([np.asarray([300])], [np.asarray([1])], np.asarray([0]))


def test_serve_pairs_is_the_serving_demo_batch():
    """The smoke's mix (A) is ``examples/serve_batch.py``'s batch."""
    from tpualign.io.bdna import random_pair
    from tpualign_torch.probe import serve_pairs

    texts, queries = serve_pairs()
    rng = np.random.default_rng(0)
    for i, (t, q) in enumerate(zip(texts, queries)):
        m, n = int(rng.integers(5_000, 25_000)), int(rng.integers(5_000, 25_000))
        s1, s2 = random_pair(m, n, seed=i)
        assert np.array_equal(t, s1) and np.array_equal(q, s2)
    assert len(texts) == 16


def test_read_pairs_cut_each_read_from_its_window():
    from tpualign_torch import probe

    texts, queries = probe.read_pairs(64, seed=3)
    assert len(texts) == len(queries) == 64
    for t, q in zip(texts, queries):
        assert probe.WINDOW[0] <= t.size <= probe.WINDOW[1] and q.size == probe.READ_LEN
        assert t.dtype == q.dtype == np.int8 and 1 <= min(t.min(), q.min()) <= 4 >= max(
            t.max(), q.max())
        best = max((t[s : s + q.size] == q).mean() for s in range(t.size - q.size + 1))
        assert best >= 0.8  # the read's own place, at 5% substitutions
