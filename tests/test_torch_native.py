"""The port's host C++ (``tpualign_torch/utils/native.py`` over
``tpualign_torch/native/bdna_tools.cpp``) against the port's NumPy oracle and
the JAX package's native library (``tpualign.utils.native``): the full-table
walk string for string and score for score, the scorers, the corpus tools,
the refusals and the build cache.  Inputs come from numpy with a seed;
comparisons are exact.  Every case shares one build of the library."""

import os
import shutil

import numpy as np
import pytest

from tpualign import config as jconfig
from tpualign.utils import native as jnative
from tpualign_torch import matrices
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import oracle
from tpualign_torch.utils import native


def _jcfg(cfg: ScoringConfig):
    return jconfig.ScoringConfig(
        match=cfg.match, mismatch=cfg.mismatch, gap=cfg.gap,
        mode=jconfig.AlignMode(cfg.mode.value), matrix=cfg.matrix,
        gap_open=cfg.gap_open, gap_extend=cfg.gap_extend)


def _random_matrix(k, seed):
    rng = np.random.default_rng(seed)
    return tuple(tuple(int(v) for v in row) for row in rng.integers(-4, 6, (k, k)))


WALK_CFGS = {
    "unit": ScoringConfig(),
    "2,-1,-3": ScoringConfig(match=2, mismatch=-1, gap=-3),
    "sw 2,-1,-2": ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL),
    "dna matrix": ScoringConfig(matrix=matrices.dna(2, -1, -3), gap=-3),
    "dna matrix sw": ScoringConfig(matrix=matrices.dna(3, -1, -2), gap=-2,
                                   mode=AlignMode.LOCAL),
    "16-code matrix": ScoringConfig(matrix=_random_matrix(16, 7), gap=-3),
}


def _pairs(kind, cfg, seed):
    """The pairs of one case: random lengths 1..200 (codes 1..4, or every
    code of a 16-code matrix), codes 0..4, empty sequences, one base."""
    rng = np.random.default_rng(seed)
    hi = len(cfg.matrix) if cfg.has_matrix and len(cfg.matrix) > 5 else 5
    code = lambda n, lo=1: rng.integers(lo, hi, n).astype(np.int8)  # noqa: E731
    if kind == "random":
        return [(code(int(rng.integers(1, 201))), code(int(rng.integers(1, 201))))
                for _ in range(6)]
    if kind == "codes 0..4":
        return [(code(int(rng.integers(1, 120)), 0), code(int(rng.integers(1, 120)), 0))
                for _ in range(4)]
    if kind == "empty":
        e = np.empty(0, np.int8)
        return [(e, e), (code(7), e), (e, code(5))]
    return [(code(1), code(1)), (code(1), code(30)), (code(30), code(1))]  # one base


@pytest.mark.parametrize("kind", ["random", "codes 0..4", "empty", "one base"])
@pytest.mark.parametrize("name", list(WALK_CFGS))
def test_traceback_matches_oracle_and_jax_package(name, kind):
    cfg = WALK_CFGS[name]
    for s1, s2 in _pairs(kind, cfg, seed=len(name) * 31 + len(kind)):
        got = native.traceback(s1, s2, cfg)
        assert got == oracle.traceback(s1, s2, cfg)
        assert got == jnative.traceback(s1, s2, _jcfg(cfg))


def test_traceback_past_int32_takes_the_int64_table():
    """Weights scaled by 2^26 scale the score and keep the strings (every
    comparison scales); the cells pass int32 at 390 bases, so the walk takes
    the int64 table.  The JAX package's int32 walk wraps there (ROADMAP
    queue 3)."""
    rng = np.random.default_rng(3)
    s1, s2 = rng.integers(1, 5, 200).astype(np.int8), rng.integers(1, 5, 190).astype(np.int8)
    unit = ScoringConfig(match=1, mismatch=-1, gap=-3)
    k = 1 << 26
    big = ScoringConfig(match=k, mismatch=-k, gap=-3 * k)
    assert (s1.size + s2.size) * 3 * k >= native.INT32_LIMIT
    sc, a1, a2 = native.traceback(s1, s2, unit)
    assert native.traceback(s1, s2, big) == (k * sc, a1, a2)
    assert oracle.alignment_score(a1, a2, big) == k * sc
    assert jnative.traceback(s1, s2, _jcfg(big))[0] != k * sc


SCORE_CFGS = {
    "linear": ScoringConfig(match=2, mismatch=-1, gap=-2),
    "local": ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL),
    "affine": ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2),
    "affine local": ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2,
                                  mode=AlignMode.LOCAL),
    "matrix": ScoringConfig(matrix=matrices.dna(2, -1, -3), gap=-3),
    "semiglobal": ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.SEMIGLOBAL),
    "infix": ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.INFIX),
    "affine matrix infix": ScoringConfig(matrix=matrices.dna(2, -1, -3), gap_open=-4,
                                         gap_extend=-1, mode=AlignMode.INFIX),
}


@pytest.mark.parametrize("name", list(SCORE_CFGS))
def test_score_matches_jax_package_and_oracle(name):
    cfg = SCORE_CFGS[name]
    rng = np.random.default_rng(len(name))
    for _ in range(5):
        s1 = rng.integers(0, 5, int(rng.integers(0, 150))).astype(np.int8)
        s2 = rng.integers(0, 5, int(rng.integers(0, 150))).astype(np.int8)
        got = native.score(s1, s2, cfg)
        assert got == oracle.score(s1, s2, cfg)
        assert got == jnative.score(s1, s2, _jcfg(cfg))


@pytest.mark.parametrize("length,seed", [(0, 0), (31, 1), (32, 2), (10_000, 3), (100_003, 64)])
def test_generate_and_validate_match_jax_package(length, seed):
    seq = native.generate(length, seed=seed)
    assert seq.tobytes() == jnative.generate(length, seed=seed).tobytes()
    assert native.validate(seq) == jnative.validate(seq) == -1
    if length:
        bad = seq.copy()
        bad[length // 2] = 9
        bad[-1] = -1
        assert native.validate(bad) == jnative.validate(bad) == length // 2


@pytest.mark.parametrize("cfg,match", [
    (ScoringConfig(gap_open=-3, gap_extend=-1), "linear-gap only"),
    (ScoringConfig(mode=AlignMode.SEMIGLOBAL), "global/local walks"),
    (ScoringConfig(mode=AlignMode.INFIX), "global/local walks"),
], ids=["affine", "semiglobal", "infix"])
def test_traceback_refusals(cfg, match):
    s = np.asarray([1, 2, 3], np.int8)
    assert not native.walks(cfg)
    with pytest.raises(RuntimeError, match=match):
        native.traceback(s, s, cfg)
    with pytest.raises(RuntimeError, match=match):
        jnative.traceback(s, s, _jcfg(cfg))


@pytest.mark.parametrize("codes", [[1, 5, 2], [1, -1, 2]], ids=["past K", "negative"])
def test_codes_outside_the_matrix_are_refused(codes):
    cfg = ScoringConfig(matrix=matrices.dna(2, -1, -3), gap=-3)
    bad, ok = np.asarray(codes, np.int8), np.asarray([1, 2], np.int8)
    assert native.walks(cfg)
    for s1, s2 in ((bad, ok), (ok, bad)):
        with pytest.raises(RuntimeError, match="outside the matrix alphabet"):
            native.traceback(s1, s2, cfg)
        with pytest.raises(ValueError, match="outside the matrix alphabet"):
            native.score(s1, s2, cfg)


def test_build_cache(tmp_path):
    """An unchanged source loads from the cache, an edited one builds anew,
    a broken one raises with g++'s output; no temporary file stays."""
    src, build = str(tmp_path / "bdna_tools.cpp"), str(tmp_path / "build")
    shutil.copy(native.SRC, src)
    first = native.library_path(src, build)
    assert first == native.library_file(native.SRC, build)
    stamp = os.stat(first).st_mtime_ns
    assert native.library_path(src, build) == first
    assert os.stat(first).st_mtime_ns == stamp
    with open(src, "a") as f:
        f.write("\n// edited\n")
    second = native.library_path(src, build)
    assert second != first and os.path.exists(second)
    seq = np.full(5, 3, np.int8)
    assert native.load(src, build).bdna_validate(seq, seq.size) == -1
    with open(src, "a") as f:
        f.write("\nint broken(\n")
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed with exit code .*error"):
        native.library_path(src, build)
    assert sorted(os.listdir(build)) == sorted(os.path.basename(p) for p in (first, second))
