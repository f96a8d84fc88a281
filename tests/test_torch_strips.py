"""The row-scan strips over a shard group (``tpualign_torch.parallel.strips``)
against ``tpualign.parallel.strips`` on the conftest's virtual CPU mesh
(``make_mesh(P)``), and the two edges of ``xla.rows_scan`` it runs on.

- Scores at P = 1, 4 and 8 shards (the JAX package's on the same P), with
  the seeds and configs of ``tests/test_strips.py``: NW and SW at several
  chunk depths, ragged shapes, the reference pairs, affine global and
  local, the shard count's invariance, empty sequences.
- ``rows_scan``'s top row and left column in (H, and under affine gaps F
  and E): a table filled as two blocks, the right one fed the left one's
  last column, equals the whole table's rows.
- The refusals: matrix and ends-free configs (``ensure_pair_modes``), a
  chunk depth below 1.
"""

import numpy as np
import pytest
import torch

from tpualign.config import AlignMode as JMode
from tpualign.config import ScoringConfig as JScoring
from tpualign.ops import oracle as joracle
from tpualign.parallel import strips as jstrips
from tpualign.parallel.mesh import make_mesh
from tpualign_torch import matrices
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import xla
from tpualign_torch.parallel import mesh, strips

from conftest import reference_pair


def _pair(m, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 5, m).astype(np.int8), rng.integers(1, 5, n).astype(np.int8)


def _cfgs(mode="GLOBAL", **kw):
    return ScoringConfig(mode=AlignMode[mode], **kw), JScoring(mode=JMode[mode], **kw)


@pytest.mark.parametrize("P", [1, 4, 8])
@pytest.mark.parametrize("mode", ["GLOBAL", "LOCAL"])
def test_scores_match_jax_strips(P, mode):
    """``tests/test_strips.py``'s pair (seed 17) on P shards, both
    packages on the same P."""
    cfg, jcfg = _cfgs(mode)
    rng = np.random.default_rng(17)
    s1 = rng.integers(1, 5, size=333, dtype=np.int8)
    s2 = rng.integers(1, 5, size=257, dtype=np.int8)
    want = jstrips.score(s1, s2, jcfg, mesh=make_mesh(P), chunk_rows=64)
    assert strips.score(s1, s2, cfg, group=mesh.make_group(P, device="cpu"),
                        chunk_rows=64) == want


@pytest.mark.parametrize("mode", ["GLOBAL", "LOCAL"])
@pytest.mark.parametrize("chunk", [8, 64, 512])
def test_chunk_depths(mode, chunk):
    cfg, jcfg = _cfgs(mode)
    rng = np.random.default_rng(17)
    s1 = rng.integers(1, 5, size=333, dtype=np.int8)
    s2 = rng.integers(1, 5, size=257, dtype=np.int8)
    got = strips.score(s1, s2, cfg, group=mesh.make_group(8, device="cpu"), chunk_rows=chunk)
    assert got == joracle.score(s1, s2, jcfg)


@pytest.mark.parametrize("l1, l2", [(7, 300), (300, 7), (129, 65), (1000, 999), (3, 5)])
def test_ragged_shapes(l1, l2):
    """Shapes indivisible by the shards or the chunk; 3 columns on 8
    shards leaves 5 blocks empty, which hand their left column on."""
    rng = np.random.default_rng(23)
    s1 = rng.integers(1, 5, size=l1, dtype=np.int8)
    s2 = rng.integers(1, 5, size=l2, dtype=np.int8)
    got = strips.score(s1, s2, ScoringConfig(), group=mesh.make_group(8, device="cpu"),
                       chunk_rows=64)
    assert got == joracle.score(s1, s2, JScoring())


@pytest.mark.parametrize("name", ["debug", "t"])
@pytest.mark.parametrize("mode", ["GLOBAL", "LOCAL"])
def test_reference_pairs(name, mode):
    cfg, jcfg = _cfgs(mode)
    s1, s2 = reference_pair(name)
    got = strips.score(s1, s2, cfg, group=mesh.make_group(8, device="cpu"), chunk_rows=16)
    assert got == joracle.score(s1, s2, jcfg)


@pytest.mark.parametrize("P", [1, 4, 8])
@pytest.mark.parametrize("mode", ["GLOBAL", "LOCAL"])
def test_affine_matches_jax_strips(P, mode):
    """Gotoh: the (H, E) halo crosses the shards, F stays on its shard; the
    JAX package's affine pipeline on the same P."""
    kw = dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2)
    cfg, jcfg = _cfgs(mode, **kw)
    s1, s2 = _pair(200, 170, seed=31)
    want = jstrips.score(s1, s2, jcfg, mesh=make_mesh(P), chunk_rows=32) if P == 8 else \
        joracle.score(s1, s2, jcfg)
    got = strips.score(s1, s2, cfg, group=mesh.make_group(P, device="cpu"), chunk_rows=32)
    assert got == want


def test_shard_count_invariance():
    s1, s2 = _pair(400, 350, seed=29)
    want = joracle.score(s1, s2, JScoring())
    for P in (1, 2, 3, 4, 8):
        assert strips.score(s1, s2, group=mesh.make_group(P, device="cpu"),
                            chunk_rows=100) == want, P


@pytest.mark.parametrize("mode", ["GLOBAL", "LOCAL"])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("m, n", [(0, 5), (4, 0), (0, 0)])
def test_empty_sequences(mode, affine, m, n):
    kw = dict(gap_open=-5, gap_extend=-2) if affine else {}
    cfg, jcfg = _cfgs(mode, **kw)
    s1, s2 = np.ones(m, np.int8), np.ones(n, np.int8)
    want = jstrips.score(s1, s2, jcfg, mesh=make_mesh(2))
    assert strips.score(s1, s2, cfg, group=mesh.make_group(2, device="cpu")) == want


@pytest.mark.parametrize("cfg", [ScoringConfig(matrix=matrices.dna()),
                                 ScoringConfig(mode=AlignMode.SEMIGLOBAL),
                                 ScoringConfig(mode=AlignMode.INFIX)],
                         ids=["matrix", "semiglobal", "infix"])
def test_refuses_matrix_and_ends_free(cfg):
    s1, s2 = _pair(20, 20, seed=1)
    with pytest.raises(ValueError, match="pair-scored global/local"):
        strips.score(s1, s2, cfg, group=mesh.make_group(2, device="cpu"))


def test_refuses_chunk_depth_below_one():
    s1, s2 = _pair(20, 20, seed=1)
    with pytest.raises(ValueError, match="chunk_rows"):
        strips.score(s1, s2, group=mesh.make_group(2, device="cpu"), chunk_rows=0)


@pytest.mark.parametrize("cfg", [
    ScoringConfig(match=2, mismatch=-1, gap=-2),
    ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL),
    ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2),
    ScoringConfig(match=2, mismatch=-1, gap_open=-4, gap_extend=-1, mode=AlignMode.LOCAL),
], ids=["nw", "sw", "affine", "affine sw"])
def test_rows_scan_edges_fill_a_block(cfg):
    """The right block of a table split at column 40, filled from the left
    block's last column (H and E) and the table's top row (H and F), gives
    the whole table's rows, last column, E column and maximum."""
    s1, s2 = _pair(90, 70, seed=3)
    t, q = torch.from_numpy(s1.astype(np.int64)), torch.from_numpy(s2.astype(np.int64))
    zero = cfg.is_local
    whole = xla.rows_scan(t, q, cfg, zero_row=zero, zero_col=zero, want_best=zero,
                          want_col=True, capture_rows=range(1, 71))
    left = xla.rows_scan(t[:40], q, cfg, zero_row=zero, zero_col=zero, want_best=zero,
                         want_col=True)
    top = strips.edge(cfg, 0, 90, False, "cpu")
    left_h = torch.cat([top[40:41], left.col])
    kw = {}
    if cfg.is_affine:
        kw = dict(top_f=torch.full((51,), xla.NEG, dtype=torch.int64),
                  left_e=torch.cat([torch.tensor([xla.NEG]), left.col_e]))
    right = xla.rows_scan(t[40:], q, cfg, zero_row=False, zero_col=False,
                          want_best=cfg.is_local, want_col=True, top_h=top[40:], left_h=left_h,
                          capture_rows=range(1, 71), **kw)
    assert torch.equal(right.caps, whole.caps[:, 40:])
    assert torch.equal(right.col, whole.col) and torch.equal(right.h, whole.h[40:])
    if cfg.is_affine:
        assert torch.equal(right.col_e, whole.col_e)
        assert torch.equal(right.f[1:], whole.f[41:])
    if cfg.is_local:
        assert int(torch.maximum(left.best, right.best)) == int(whole.best)
