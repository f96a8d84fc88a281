"""The port's public API (``tpualign_torch.align_score``) end to end on the
CPU against ``tpualign.align_score``, its engine routing and fallbacks, its
refusals, its scoring config, matrices and oracle against ``tpualign``'s,
and its independence from JAX and from the JAX package (``align_score`` and
``align``).  Inputs come from numpy with a seed; comparisons are exact."""

import dataclasses

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpualign
from tpualign import config as jconfig
from tpualign import matrices as jmatrices
from tpualign.ops import bitpal as jbp
from tpualign.ops import oracle
from tpualign_torch import AlignMode, EngineConfig, ScoringConfig, align, align_score
from tpualign_torch import api, matrices
from tpualign_torch.api import resolve_impl
from tpualign_torch.ops import bitpal as tbp
from tpualign_torch.ops import band as tband
from tpualign_torch.ops import oracle as toracle
from tpualign_torch.ops import pallas_diag as tdiag
from tpualign_torch.ops import xla as txla

CPU = EngineConfig(device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 5, m).astype(np.int8),
            rng.integers(1, 5, n).astype(np.int8))


def test_slice_end_to_end_matches_jax_package():
    s1, s2 = _pair(2000, 3000, seed=11)
    assert align_score(s1, s2, engine=CPU) == tpualign.align_score(s1, s2)


@pytest.mark.parametrize("gap", [-2, -7])
def test_g_family_end_to_end_matches_jax_package(gap):
    s1, s2 = _pair(300, 400, seed=-gap)
    got = align_score(s1, s2, ScoringConfig(gap=gap), CPU)
    assert got == tpualign.align_score(s1, s2, jconfig.ScoringConfig(gap=gap))


@pytest.mark.parametrize("impl", ["auto", "bitpal", "oracle", "band", "pallas", "xla"])
def test_impls_agree(impl):
    s1, s2 = _pair(120, 77, seed=5)
    got = align_score(s1, s2, engine=EngineConfig(impl=impl, device="cpu"))
    assert got == oracle.score(s1, s2)


def test_resolve_impl():
    assert resolve_impl(EngineConfig(), ScoringConfig()) == "bitpal"
    assert resolve_impl(EngineConfig(), ScoringConfig(match=2, gap=-2)) == "bitpal"
    assert resolve_impl(EngineConfig(), ScoringConfig(gap=-2)) == "bitpal"
    assert resolve_impl(EngineConfig(), ScoringConfig(match=3, mismatch=2, gap=-1)) == "bitpal"
    assert resolve_impl(EngineConfig(impl="oracle"), ScoringConfig(mode=AlignMode.LOCAL)) == "oracle"
    # everything outside the family goes to the band engine, affine included
    for cfg in (ScoringConfig(gap=-8), ScoringConfig(mode=AlignMode.LOCAL),
                ScoringConfig(gap_open=-5, gap_extend=-2),
                ScoringConfig(mode=AlignMode.SEMIGLOBAL), ScoringConfig(gap=0),
                ScoringConfig(matrix=matrices.dna())):
        assert resolve_impl(EngineConfig(), cfg) == "band"


def test_headroom_refusal_matches_jax():
    # g = 1 member with large magnitudes: (0 + 2 * 2**20) * (m + n) >= 2**31
    # exactly when m + n >= 1024, in both packages
    cfg = ScoringConfig(match=1 << 20, mismatch=0, gap=-(1 << 20))
    for m, n in [(600, 424), (1000, 1000)]:
        with pytest.raises(ValueError, match="int32 headroom"):
            jbp.score_fn(m, n, cfg, interpret=True)
        with pytest.raises(ValueError, match="int32 headroom"):
            tbp.score_fn(m, n, cfg, device="cpu")
    jbp.score_fn(600, 423, cfg, interpret=True)
    tbp.score_fn(600, 423, cfg, device="cpu")
    s1, s2 = _pair(600, 423, seed=2)
    assert align_score(s1, s2, cfg, CPU) == oracle.score(s1, s2, cfg)


@pytest.mark.parametrize(
    "cfg,item",
    [
        (ScoringConfig(match=1, mismatch=0, gap=-8), None),
        (ScoringConfig(mode=AlignMode.LOCAL), None),
        (ScoringConfig(gap_open=-5, gap_extend=-2), None),
        (ScoringConfig(mode=AlignMode.SEMIGLOBAL), None),
        (ScoringConfig(matrix=((1, 0), (0, 1))), None),
        (ScoringConfig(match=1, mismatch=0, gap=0), None),
    ],
    ids=["g8", "local", "affine", "semiglobal", "matrix", "gap0"],
)
@pytest.mark.parametrize("impl", ["auto", "bitpal"])
def test_unported_configs_raise(cfg, item, impl, monkeypatch):
    """Alignment past the full table outside the family runs the band split
    over K7's port, or under affine gaps Myers-Miller over its affine
    capture fill, and scores the oracle's optimum; no config raises any
    more."""
    monkeypatch.setattr(api, "FULL_TABLE_CELL_LIMIT", 100)
    s1, s2 = _pair(20, 30, seed=1)
    if cfg.has_matrix:  # the 2-code matrix scores codes 0 and 1
        s1, s2 = s1 % 2, s2 % 2
    engine = EngineConfig(impl=impl, device="cpu")
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            align(s1, s2, cfg, engine)
        return
    sc, a1, a2 = align(s1, s2, cfg, engine)
    assert len(a1) == len(a2)
    assert sc == toracle.score(s1, s2, cfg)
    if not cfg.has_matrix:  # code 0 prints as the gap
        assert sc == toracle.alignment_score(a1, a2, cfg)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s1, s2 = _pair(20, 30, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        align_score(s1, s2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbp.score(s1, s2, device="cuda")
    # not a refusal: no engine falls back on it
    for impl in ("auto", "band", "xla", "pallas"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            align_score(s1, s2, ScoringConfig(mode=AlignMode.LOCAL), EngineConfig(impl=impl))


def test_engine_config_validates():
    assert EngineConfig().device == "cuda"
    with pytest.raises(ValueError, match="unknown impl"):
        EngineConfig(impl="cuda")
    with pytest.raises(ValueError, match="cpu or cuda"):
        EngineConfig(device="meta")


def test_package_imports_and_scores_without_jax():
    s1, s2 = _pair(40, 25, seed=9)
    code = (
        "import sys\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib')]:\n"
        "    del sys.modules[k]\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['tpualign'] = None\n"
        "import numpy as np\n"
        "import tpualign_torch\n"
        "from tpualign_torch import EngineConfig, align_score\n"
        f"s1 = np.array({s1.tolist()}, np.int8)\n"
        f"s2 = np.array({s2.tolist()}, np.int8)\n"
        "print(align_score(s1, s2, engine=EngineConfig(device='cpu')))\n"
        "print(align_score(s1, s2, engine=EngineConfig('oracle', 'cpu')))\n"
        "for impl in ('band', 'xla', 'pallas'):\n"
        "    print(align_score(s1, s2, engine=EngineConfig(impl, 'cpu')))\n"
        "print(tpualign_torch.align(s1, s2, engine=EngineConfig(device='cpu'))[0])\n"
        "from tpualign_torch.ops import hirschberg\n"
        "hirschberg.BASE_CELLS = 64\n"
        "print(hirschberg.align(s1, s2, device='cpu')[0])\n"
        "from tpualign_torch.ops import traceback, traceback_diag\n"
        "print(traceback_diag.align_diag(s1, s2, k_stride=16, device='cpu')[0])\n"
        "print(traceback.align_checkpointed(s1, s2, k=16, device='cpu')[0])\n"
        "for impl in ('auto', 'band'):\n"
        "    print(*tpualign_torch.align_score_batch([s1, s2], [s2, s1],\n"
        "                                            engine=EngineConfig(impl, 'cpu')))\n"
        "assert not [k for k in sys.modules if k.startswith('jax') and sys.modules[k] is not None]\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    want = oracle.score(s1, s2)
    assert [int(x) for x in out.stdout.split()] == [want] * 9 + [want, oracle.score(s2, s1)] * 2


def test_scoring_config_fields_match_jax_package():
    ours = [(f.name, f.default) for f in dataclasses.fields(ScoringConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jconfig.ScoringConfig)]
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    assert [getattr(d, "value", d) for _, d in ours] == [
        getattr(d, "value", d) for _, d in theirs]
    assert [(m.name, m.value) for m in AlignMode] == [
        (m.name, m.value) for m in jconfig.AlignMode]


@pytest.mark.parametrize("mode", list(AlignMode), ids=lambda m: m.name)
def test_scoring_config_flags_match_jax_package(mode):
    ours = ScoringConfig(mode=mode, gap_open=-3, gap_extend=-1)
    theirs = jconfig.ScoringConfig(mode=jconfig.AlignMode(mode.value),
                                   gap_open=-3, gap_extend=-1)
    for flag in ("is_local", "is_affine", "has_matrix", "free_start_s1",
                 "free_start_s2", "free_end_s1", "free_end_s2", "is_ends_free"):
        assert getattr(ours, flag) == getattr(theirs, flag), flag


@pytest.mark.parametrize(
    "kwargs,exc",
    [
        (dict(match=1.0), TypeError),
        (dict(mode="nw"), TypeError),
        (dict(matrix=[[1]]), TypeError),
        (dict(matrix=((1, 0),)), TypeError),
        (dict(matrix=tuple((0,) * 17 for _ in range(17))), ValueError),
        (dict(matrix=((1, 0.5), (0, 1))), TypeError),
        (dict(gap_open=-2), ValueError),
        (dict(gap_open=1, gap_extend=-1), ValueError),
        (dict(gap_open=-1, gap_extend=1.0), TypeError),
    ],
    ids=["float", "mode", "list-matrix", "ragged", "17-codes", "float-entry",
         "open-alone", "open-positive", "extend-float"],
)
def test_scoring_config_refuses_what_jax_package_refuses(kwargs, exc):
    with pytest.raises(exc):
        ScoringConfig(**kwargs)
    with pytest.raises(exc):
        jconfig.ScoringConfig(**kwargs)


_DNA = ((0, -9, -9, -9, -9), (-9, 2, -1, 0, -1), (-9, -1, 2, -1, 0),
        (-9, 0, -1, 2, -1), (-9, -1, 0, -1, 2))


@pytest.mark.parametrize(
    "kwargs",
    [dict(), dict(match=2, mismatch=-1, gap=-3), dict(match=1, mismatch=0, gap=0),
     dict(mode="LOCAL", mismatch=-1, gap=-2), dict(mode="SEMIGLOBAL", gap=-2),
     dict(mode="INFIX", mismatch=-1), dict(matrix=_DNA, gap=-2),
     dict(matrix=_DNA, mode="LOCAL", gap=-3)],
    ids=["unit", "2,-1,-3", "gap0", "local", "semiglobal", "infix", "matrix",
         "matrix-local"],
)
@pytest.mark.parametrize("m,n", [(0, 7), (7, 0), (60, 45), (45, 120)])
def test_oracle_matches_jax_package(kwargs, m, n):
    mode = kwargs.pop("mode", "GLOBAL")
    rng = np.random.default_rng(m + 31 * n)
    s1 = rng.integers(0, 5, m).astype(np.int8)
    s2 = rng.integers(0, 5, n).astype(np.int8)
    ours = ScoringConfig(mode=AlignMode[mode], **kwargs)
    theirs = jconfig.ScoringConfig(mode=jconfig.AlignMode[mode], **kwargs)
    assert toracle.score(s1, s2, ours) == oracle.score(s1, s2, theirs)


def test_oracle_refuses_affine():
    """Repaired: the oracle's affine traceback and so ``align`` raised even
    on a 10 x 12 table; both now walk it as ``tpualign`` does."""
    cfg = ScoringConfig(gap_open=-3, gap_extend=-1)
    jcfg = jconfig.ScoringConfig(gap_open=-3, gap_extend=-1)
    s1, s2 = _pair(10, 12, seed=4)
    want = oracle.traceback(s1, s2, jcfg)
    assert toracle.traceback(s1, s2, cfg) == want == tpualign.align(s1, s2, jcfg)
    assert align(s1, s2, cfg, CPU) == want


@pytest.mark.parametrize("mode", list(AlignMode), ids=lambda m: m.name)
def test_oracle_scores_affine_as_jax_package(mode):
    """Repaired: ``impl="oracle"`` scored no affine config (it raised)."""
    kw = dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2)
    s1, s2 = _pair(70, 55, seed=12)
    got = align_score(s1, s2, ScoringConfig(mode=mode, **kw),
                      EngineConfig(impl="oracle", device="cpu"))
    want = tpualign.align_score(s1, s2, jconfig.ScoringConfig(
        mode=jconfig.AlignMode(mode.value), **kw), jconfig.EngineConfig(impl="oracle"))
    assert got == want


def _spy(monkeypatch, module, name):
    """Record the calls of ``module.name`` and let them through."""
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_bitpal_refusal_falls_back_to_pallas(monkeypatch):
    """Repaired: a ValueError of ``bitpal`` (here the one-block kernel's row
    limit, patched small) escaped; ``tpualign`` retries on ``pallas``."""
    monkeypatch.setattr(tbp, "MAX_THREADS", 1)
    monkeypatch.setattr(tbp, "MAX_K", 1)
    s1, s2 = _pair(300, 200, seed=13)
    with pytest.raises(ValueError, match="one-block"):
        tbp.score(s1, s2, device="cpu")
    calls = _spy(monkeypatch, tdiag, "score_plain")
    for impl in ("auto", "bitpal"):
        got = align_score(s1, s2, engine=EngineConfig(impl=impl, device="cpu"))
        assert got == oracle.score(s1, s2)
    assert calls == ["score_plain"] * 2


@pytest.mark.parametrize(
    "cfg,engine",
    [(ScoringConfig(mode=AlignMode.LOCAL, match=2, mismatch=-1, gap=-2), None),
     (ScoringConfig(gap=-8), None),
     (ScoringConfig(gap_open=-5, gap_extend=-2), "xla"),
     (ScoringConfig(matrix=matrices.dna(2, -1, -3), gap=-2), "xla"),
     (ScoringConfig(mode=AlignMode.INFIX, gap=-2), "xla")],
    ids=["local", "g8", "affine", "matrix", "infix"],
)
def test_band_refusal_falls_back(cfg, engine, monkeypatch):
    """``band``'s ValueError goes to ``xla`` for matrix, ends-free or affine
    configs (``tpualign/api.py:173-194``).  A linear pair-scored config is
    refused only past the int32 headroom, which ``pallas`` shares, so the
    error is raised and no other engine runs."""
    def refuse(*args):
        raise ValueError("refused")

    monkeypatch.setattr(tband, "_check_cfg", refuse)
    diag = _spy(monkeypatch, tdiag, "score_plain")
    rows = _spy(monkeypatch, txla, "score")
    s1, s2 = _pair(90, 60, seed=14)
    if engine is None:
        with pytest.raises(ValueError, match="refused"):
            align_score(s1, s2, cfg, CPU)
        assert (diag, rows) == ([], [])
        return
    got = align_score(s1, s2, cfg, CPU)
    assert got == toracle.score(s1, s2, cfg)
    assert (diag, rows) == ([], ["score"])


def test_linear_pair_headroom_refusal_is_shared_with_pallas():
    """Past the int32 headroom ``band`` and ``pallas`` refuse the same
    linear pair-scored config, and ``align_score`` raises as ``tpualign``
    does on a TPU."""
    cfg = ScoringConfig(match=1 << 20, mismatch=0, gap=-(1 << 20), mode=AlignMode.LOCAL)
    s1, s2 = _pair(300, 213, seed=15)
    for mod in (tband, tdiag):
        with pytest.raises(ValueError, match="int32 headroom"):
            mod.score(s1, s2, cfg, device="cpu")
    with pytest.raises(ValueError, match="int32 headroom"):
        align_score(s1, s2, cfg, CPU)


@pytest.mark.parametrize(
    "kw", [dict(match=2, mismatch=-1, gap=-2, mode="LOCAL"),
           dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2, mode="SEMIGLOBAL"),
           dict(gap=-2, mode="GLOBAL")],
    ids=["sw", "affine-sg", "g2"])
def test_band_chunked_is_the_band_engine(kw):
    """``band-chunked`` lifts the TPU kernel's SMEM cap on the boundary row;
    the port's band kernel has none, so it resolves to ``band``, and both
    give ``tpualign``'s score."""
    kw = dict(kw)
    mode = kw.pop("mode")
    cfg = ScoringConfig(mode=AlignMode[mode], **kw)
    s1, s2 = _pair(160, 110, seed=12)
    assert resolve_impl(EngineConfig(impl="band-chunked"), cfg) == "band"
    got = align_score(s1, s2, cfg, EngineConfig(impl="band-chunked", device="cpu"))
    assert got == align_score(s1, s2, cfg, EngineConfig(impl="band", device="cpu"))
    assert got == tpualign.align_score(s1, s2, jconfig.ScoringConfig(
        mode=jconfig.AlignMode[mode], **kw))


def test_unported_impls_raise():
    s1, s2 = _pair(20, 30, seed=1)
    for impl, item in [("bitpal-strips", "item 13"), ("band-strips", "item 13"),
                       ("strips", "item 13")]:
        with pytest.raises(NotImplementedError, match=item):
            align_score(s1, s2, engine=EngineConfig(impl=impl, device="cpu"))


@pytest.mark.parametrize(
    "kw",
    [dict(match=2, mismatch=-1, gap=-2, mode="LOCAL"),
     dict(match=2, mismatch=-1, gap=-3, mode="GLOBAL"),
     dict(matrix="dna", gap=-3, mode="GLOBAL"),
     dict(match=2, mismatch=-1, gap=-2, mode="SEMIGLOBAL"),
     dict(match=2, mismatch=-1, gap=-2, mode="INFIX"),
     dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2, mode="GLOBAL"),
     dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2, mode="LOCAL"),
     dict(matrix="iupac", gap_open=-4, gap_extend=-1, mode="SEMIGLOBAL")],
    ids=["sw", "2,-1,-3", "dna", "semiglobal", "infix", "affine", "affine-local",
         "iupac-affine-sg"],
)
@pytest.mark.parametrize("m,n", [(230, 170), (170, 230)])
def test_every_config_end_to_end_matches_jax_package(kw, m, n):
    kw = dict(kw)
    mode = kw.pop("mode")
    matrix = kw.pop("matrix", None)
    hi = 16 if matrix == "iupac" else 5
    ours = dict(kw, mode=AlignMode[mode])
    theirs = dict(kw, mode=jconfig.AlignMode[mode])
    if matrix:
        ours["matrix"] = getattr(matrices, matrix)()
        theirs["matrix"] = getattr(jmatrices, matrix)()
    rng = np.random.default_rng(m * n)
    s1 = rng.integers(0, hi, m).astype(np.int8)
    s2 = rng.integers(0, hi, n).astype(np.int8)
    got = align_score(s1, s2, ScoringConfig(**ours), CPU)
    assert got == tpualign.align_score(s1, s2, jconfig.ScoringConfig(**theirs))


def test_matrices_match_jax_package():
    for name, args in [("dna", ()), ("dna", (2, -1, -3)), ("dna", (5, 1, -4, -9)),
                       ("uniform", ()), ("uniform", (3, -2, 7)), ("iupac", ()),
                       ("iupac", (4, -3))]:
        assert getattr(matrices, name)(*args) == getattr(jmatrices, name)(*args)
    for spec in ("dna:2,-1,-3", "iupac:1,-1", "1,0/0,1", "3,-1,-2/-1,3,0/-2,0,3"):
        assert matrices.parse(spec) == jmatrices.parse(spec)
    for bad in ("dna:1,2", "iupac:1", "1,0/0"):
        with pytest.raises(ValueError):
            matrices.parse(bad)
        with pytest.raises(ValueError):
            jmatrices.parse(bad)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(match=-2, mismatch=3), dict(matrix=_DNA), dict(matrix=((5,),))],
    ids=["default", "inverted", "matrix", "1x1"],
)
def test_sub_bounds_and_with_mode_match_jax_package(kw):
    ours, theirs = ScoringConfig(**kw), jconfig.ScoringConfig(**kw)
    assert ours.sub_bounds() == theirs.sub_bounds()
    for mode in AlignMode:
        got = ours.with_mode(mode)
        want = theirs.with_mode(jconfig.AlignMode(mode.value))
        assert got.mode is mode and got.mode.value == want.mode.value
        assert got.sub_bounds() == want.sub_bounds() and got.matrix == want.matrix
