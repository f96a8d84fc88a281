"""The port's band engine (``tpualign_torch.ops.band``) on the CPU against the
JAX package: scores of every mode x pair/matrix x linear/affine in both
orientations against ``tpualign.ops.xla.score`` and ``tpualign.ops.oracle``,
a few tiny cases against the TPU kernel itself (``tpualign.ops.band`` in
interpret mode), the empty-input rule, the refusals both packages share,
and the wrapper.  Inputs come from numpy with a seed; every comparison is
exact integer equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpualign import matrices as jmat
from tpualign.config import AlignMode as JaxMode
from tpualign.config import ScoringConfig as JaxScoring
from tpualign.ops import band as jband
from tpualign.ops import oracle, xla
from tpualign_torch import matrices, trace
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import band


def launches(kernel: str) -> int:
    """The launches of ``kernel`` counted so far in this process."""
    return trace.counters().get("launch." + kernel, 0)


ASYM = ((3, -1, -2, 0, 1), (-2, 2, -3, -1, 0), (0, -1, 4, -2, -1),
        (1, 0, -1, 3, -2), (-1, -2, 0, -3, 2))
MATRICES = {"pair": None, "dna": matrices.dna(2, -1, -3), "asym5": ASYM,
            "iupac": matrices.iupac()}
GAPS = {"linear": {}, "affine": dict(gap_open=-5, gap_extend=-2)}


def _cfgs(mode, matrix, gaps, **kw):
    kw = dict(match=2, mismatch=-1, gap=-2, **GAPS[gaps], **kw)
    if MATRICES[matrix] is not None:
        kw["matrix"] = MATRICES[matrix]
    return (ScoringConfig(mode=AlignMode[mode], **kw),
            JaxScoring(mode=JaxMode[mode], **kw))


def _pair(m, n, seed, hi=5, lo=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, hi, m).astype(np.int8),
            rng.integers(lo, hi, n).astype(np.int8))


@pytest.mark.parametrize("m,n", [(37, 53), (53, 37)], ids=["rows-s2", "swapped"])
@pytest.mark.parametrize("gaps", list(GAPS))
@pytest.mark.parametrize("matrix", list(MATRICES))
@pytest.mark.parametrize("mode", [m.name for m in AlignMode])
def test_score_matches_xla_and_oracle(mode, matrix, gaps, m, n):
    ours, theirs = _cfgs(mode, matrix, gaps)
    hi = 16 if matrix == "iupac" else 5
    s1, s2 = _pair(m, n, seed=m * 100 + n + len(mode), hi=hi)
    got = band.score(s1, s2, ours, device="cpu")
    assert got == oracle.score(s1, s2, theirs)
    assert got == xla.score(s1, s2, theirs)


@pytest.mark.parametrize("mode", ["GLOBAL", "LOCAL", "SEMIGLOBAL"])
def test_iupac_codes_0_to_15(mode):
    ours, theirs = _cfgs(mode, "iupac", "linear")
    s1, s2 = _pair(60, 45, seed=16, hi=16)
    assert set(np.concatenate([s1, s2])) == set(range(16))
    assert band.score(s1, s2, ours, device="cpu") == oracle.score(s1, s2, theirs)


@pytest.mark.parametrize("m,n", [(40, 70), (70, 40)])
def test_masked_local_positive_mismatch(m, n):
    """Local with mismatch > 0: the TPU kernel's masked running max."""
    kw = dict(match=3, mismatch=1, gap=-2, mode=AlignMode.LOCAL)
    s1, s2 = _pair(m, n, seed=7)
    want = oracle.score(s1, s2, JaxScoring(**{**kw, "mode": JaxMode.LOCAL}))
    assert band.score(s1, s2, ScoringConfig(**kw), device="cpu") == want


@pytest.mark.parametrize("m,n", [(40, 70), (70, 40), (1, 30), (30, 1)])
def test_masked_local_affine_positive_mismatch(m, n):
    """Local affine with mismatch > 0, which the TPU kernel refuses: the
    port's band engine scores it, equal to the JAX package's oracle."""
    kw = dict(match=3, mismatch=1, gap_open=-5, gap_extend=-2)
    s1, s2 = _pair(m, n, seed=8)
    want = oracle.score(s1, s2, JaxScoring(mode=JaxMode.LOCAL, **kw))
    assert want == xla.score(s1, s2, JaxScoring(mode=JaxMode.LOCAL, **kw))
    assert band.score(s1, s2, ScoringConfig(mode=AlignMode.LOCAL, **kw), device="cpu") == want


@pytest.mark.parametrize(
    "m,n,mode,gaps",
    [(9, 12, "LOCAL", "linear"), (12, 9, "GLOBAL", "affine"),
     (10, 10, "SEMIGLOBAL", "linear")],
)
def test_matches_tpu_kernel_in_interpret_mode(m, n, mode, gaps):
    ours, theirs = _cfgs(mode, "pair", gaps)
    s1, s2 = _pair(m, n, seed=m + n, lo=1)
    fn = jband.score_fn(m, n, theirs, rows=1, unroll=8, interpret=True)
    want = int(fn(jnp.asarray(s1, jnp.int32), jnp.asarray(s2, jnp.int32)))
    assert band.score(s1, s2, ours, device="cpu") == want


@pytest.mark.parametrize("m,n", [(0, 0), (0, 6), (6, 0)])
@pytest.mark.parametrize("gaps", list(GAPS))
@pytest.mark.parametrize("mode", [m.name for m in AlignMode])
def test_empty_inputs(mode, gaps, m, n):
    ours, theirs = _cfgs(mode, "pair", gaps)
    s1, s2 = np.ones(m, np.int8), np.full(n, 2, np.int8)
    got = band.score(s1, s2, ours, device="cpu")
    assert got == band._empty_score(m, n, ours) == jband._empty_score(m, n, theirs)
    assert got == oracle.score(s1, s2, theirs) == jband.score(s1, s2, theirs)


def test_refuses_what_the_jax_package_refuses():
    big = dict(match=1 << 20, mismatch=0, gap=-(1 << 20), mode=AlignMode.LOCAL)
    for m, n, refused in [(300, 213, True), (300, 212, False)]:
        for cfg, mod in [(ScoringConfig(**big), band),
                         (JaxScoring(**{**big, "mode": JaxMode.LOCAL}), jband)]:
            if refused:
                with pytest.raises(ValueError, match="int32 headroom"):
                    mod._check_cfg(cfg, m + n)
            else:
                mod._check_cfg(cfg, m + n)
    # positive-mismatch local affine: the TPU kernel refuses it (its running
    # max is unmasked); the port's max covers live cells only and scores it
    kw = dict(match=2, mismatch=1, gap=-2, gap_open=-3, gap_extend=-1)
    s1, s2 = _pair(10, 12, seed=3)
    with pytest.raises(ValueError, match="positive-mismatch"):
        jband.score_fn(10, 12, JaxScoring(mode=JaxMode.LOCAL, **kw), interpret=True)
    want = oracle.score(s1, s2, JaxScoring(mode=JaxMode.LOCAL, **kw))
    assert band.score(s1, s2, ScoringConfig(mode=AlignMode.LOCAL, **kw), device="cpu") == want
    # a matrix config takes its own sentinel path in the TPU kernel: served
    mat = ScoringConfig(mode=AlignMode.LOCAL, matrix=matrices.uniform(2, 1), gap_open=-3,
                        gap_extend=-1)
    want = oracle.score(s1, s2, JaxScoring(mode=JaxMode.LOCAL, matrix=jmat.uniform(2, 1),
                                           gap_open=-3, gap_extend=-1))
    assert band.score(s1, s2, mat, device="cpu") == want


def test_refuses_codes_outside_the_matrix():
    cfg = ScoringConfig(matrix=matrices.dna())
    with pytest.raises(ValueError, match="matrix alphabet"):
        band.score(np.array([1, 5], np.int8), np.array([1], np.int8), cfg, device="cpu")


@pytest.mark.parametrize(
    "n,max_k,want",
    [(1, 16, (1, 32)), (33, 16, (1, 64)), (1024, 16, (1, 1024)), (1025, 16, (2, 544)),
     (16384, 16, (16, 1024)), (16385, 16, (16, 544)), (20000, 16, (16, 640)),
     (126440, 16, (16, 992)),
     # local affine gaps stop at 8 rows a thread
     (8192, 8, (8, 1024)), (8193, 8, (8, 544)), (20000, 8, (8, 864)),
     (126440, 8, (8, 992))],
)
def test_kernel_geometry(n, max_k, want):
    k, threads = band.kernel_geometry(n, max_k)
    assert (k, threads) == want
    assert threads % 32 == 0 and threads <= band.MAX_THREADS and k <= max_k


@pytest.mark.parametrize("mode", [m.name for m in AlignMode])
@pytest.mark.parametrize("gaps", list(GAPS))
def test_max_k_stops_local_affine_at_8(mode, gaps):
    ours, _ = _cfgs(mode, "pair", gaps)
    want = 8 if (mode == "LOCAL" and gaps == "affine") else 16
    assert band.max_k(ours) == want


def test_wrapper_on_cpu_is_the_plain_version():
    cfg = ScoringConfig(mode=AlignMode.LOCAL, gap_open=-4, gap_extend=-1)
    s1, s2 = (torch.from_numpy(s) for s in _pair(50, 30, seed=4))
    ends = band._ends_flags(cfg, False)
    before = launches("band_fill")
    got = band.band_fill(s1, s2, cfg, ends, geometry=(2, 32))
    assert torch.equal(got, band.score_plain(s1, s2, cfg, ends))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert launches("band_fill") == before  # the count is of kernel launches


def test_wrapper_rejects_bad_arguments():
    text, query = torch.ones(10, dtype=torch.int8), torch.ones(7, dtype=torch.int8)
    cfg, ends = ScoringConfig(), (False,) * 4
    with pytest.raises(ValueError, match="int8"):
        band.band_fill(text.long(), query, cfg, ends)
    with pytest.raises(ValueError, match="non-empty"):
        band.band_fill(text, query[:0], cfg, ends)
    with pytest.raises(ValueError, match="contiguous"):
        band.band_fill(torch.ones(20, dtype=torch.int8)[::2], query, cfg, ends)
    with pytest.raises(ValueError, match="cpu or cuda"):
        band.band_fill(text.to("meta"), query.to("meta"), cfg, ends)


@pytest.mark.parametrize("mode", [m.name for m in AlignMode])
@pytest.mark.parametrize("swapped", [False, True])
def test_ends_flags_match_jax_package(mode, swapped):
    ours, theirs = _cfgs(mode, "pair", "linear")
    assert band._ends_flags(ours, swapped) == jband._ends_flags(theirs, swapped)


def test_score_fn_returns_a_tensor_and_checks_lengths():
    cfg = ScoringConfig(mode=AlignMode.INFIX, gap=-2)
    s1, s2 = _pair(30, 80, seed=5)
    fn = band.score_fn(30, 80, cfg, device="cpu")
    got = fn(torch.from_numpy(s1), torch.from_numpy(s2))
    assert got.dim() == 0
    assert int(got) == oracle.score(s1, s2, JaxScoring(mode=JaxMode.INFIX, gap=-2))
    with pytest.raises(ValueError, match="lengths"):
        fn(torch.from_numpy(s2), torch.from_numpy(s1))
