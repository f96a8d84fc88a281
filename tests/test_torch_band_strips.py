"""The strip kernel over a shard group (``tpualign_torch.parallel.band_strips``)
against ``tpualign.parallel.band_strips`` on the conftest's virtual CPU
mesh (``make_mesh(P)``, ``interpret=True``, ``rows=2`` as
``tests/test_band_strips.py`` runs it), and K7's sharded contract.

- Scores: the JAX package's engine itself at P = 4 and 8 (~16 s a call in
  interpret mode, so two calls), and at P = 1, 2, 3, 4 and 8 the cases of
  ``tests/test_band_strips.py``, which hold the JAX engine to its oracle,
  against that oracle: NW under general scoring, SW with the optimum on an
  interior shard, the DNA matrix under NW, SW, semiglobal and infix,
  swapped shapes (the matrix transposed), ragged shapes and empty blocks,
  the semiglobal last column's early rows, empty sequences.
- Where the port serves past the TPU engine: masked SW (a positive
  mismatch), which ``tpualign``'s refuses, scores the oracle's optimum.
- Refusals: affine gaps (before any scoring, empty pairs included), a chunk
  depth below 1.
- K7's sharded contract (``band_capture_edge``, the strip body's EDGE flag)
  built through ``tools/rehearse_kernels.py``'s shim
  (``band_capture_edge.cu`` alone) against ``capture_plain`` with the same
  edges in, word for word (``rehearse_kernels.edge_case``: random edges,
  outputs and ring seeded with garbage, one block, blocks past the strips,
  fewer blocks than strips over rings of 2 rows, the located cell), and
  the pipeline at P = 3 driven through that entry.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tpualign import matrices as jmatrices
from tpualign.config import AlignMode as JMode
from tpualign.config import ScoringConfig as JScoring
from tpualign.ops import oracle as joracle
from tpualign.parallel import band_strips as jband_strips
from tpualign.parallel.mesh import make_mesh
from tpualign_torch import matrices, trace
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import band
from tpualign_torch.parallel import band_strips, mesh

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")

GEN = dict(match=2, mismatch=-3, gap=-4)
SW = dict(match=3, mismatch=-2, gap=-1, mode="LOCAL")


def _cfgs(mode="GLOBAL", matrix=False, **kw):
    if matrix:
        cfg = ScoringConfig(mode=AlignMode[mode], matrix=matrices.dna(2, -1, -3), **kw)
        return cfg, JScoring(mode=JMode[mode], matrix=jmatrices.dna(2, -1, -3), **kw)
    return ScoringConfig(mode=AlignMode[mode], **kw), JScoring(mode=JMode[mode], **kw)


def random_pair(m, n, seed, lo=0):
    r = np.random.default_rng(seed)
    return r.integers(lo, 5, m).astype(np.int8), r.integers(lo, 5, n).astype(np.int8)


def _group(P):
    return mesh.make_group(P, device="cpu")


@pytest.mark.parametrize("P, kw", [(8, GEN), (4, SW)], ids=["P8 gen", "P4 sw"])
def test_scores_match_jax_band_strips(P, kw):
    """The JAX package's sharded band engine on the same P (interpret
    mode, strips of 256 rows), codes 0..4."""
    cfg, jcfg = _cfgs(**kw)
    s1, s2 = random_pair(300, 350, 42)
    want = jband_strips.score(s1, s2, jcfg, mesh=make_mesh(P), rows=2, interpret=True)
    assert band_strips.score(s1, s2, cfg, group=_group(P), chunk_rows=64) == want


@pytest.mark.parametrize("P", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kw", [GEN, SW, dict(gap=-1)], ids=["gen", "sw", "unit"])
def test_shard_count_invariance(P, kw):
    cfg, jcfg = _cfgs(**kw)
    s1, s2 = random_pair(500, 400, 7)
    got = band_strips.score(s1, s2, cfg, group=_group(P), chunk_rows=96)
    assert got == joracle.score(s1, s2, jcfg)


@pytest.mark.parametrize(
    "mode,mat,m,n",
    [
        ("GLOBAL", True, 900, 600),
        ("LOCAL", True, 900, 600),
        ("SEMIGLOBAL", False, 900, 600),
        ("SEMIGLOBAL", True, 600, 900),  # swap + matrix transpose
        ("INFIX", False, 600, 900),  # swapped infix: ec-only flags
        ("INFIX", True, 900, 600),
    ],
    ids=["nw-mat", "sw-mat", "sg", "sg-mat-swap", "infix-swap", "infix-mat"],
)
def test_modes_on_8_shards(mode, mat, m, n):
    """``tests/test_band_strips.py``'s mode table (seeds ``m + 3n``)."""
    kw = dict(gap=-2) if mat else dict(match=2, mismatch=-1, gap=-2)
    cfg, jcfg = _cfgs(mode, mat, **kw)
    s1, s2 = random_pair(m, n, m + 3 * n, lo=1)
    got = band_strips.score(s1, s2, cfg, group=_group(8), chunk_rows=128)
    assert got == joracle.score(s1, s2, jcfg)


def test_asymmetric_matrix_transposed_when_swapped():
    asym = ((3, -1, -2, 0, 1), (-2, 2, -3, -1, 0), (0, -1, 4, -2, -1),
            (1, 0, -1, 3, -2), (-1, -2, 0, -3, 2))
    s1, s2 = random_pair(120, 260, 13)
    for mode in ("GLOBAL", "SEMIGLOBAL"):
        cfg = ScoringConfig(matrix=asym, gap=-3, mode=AlignMode[mode])
        jcfg = JScoring(matrix=asym, gap=-3, mode=JMode[mode])
        got = band_strips.score(s1, s2, cfg, group=_group(4), chunk_rows=50)
        assert got == joracle.score(s1, s2, jcfg), mode


def test_sg_last_column_early_row():
    """The semiglobal optimum in the last column's first rows, on the shard
    that owns it (the reference's 400k regression, score 12)."""
    r = np.random.default_rng(23)
    s1 = r.integers(1, 3, 808).astype(np.int8)
    s2 = r.integers(3, 5, 700).astype(np.int8)
    s2[:6] = s1[-6:]
    cfg, jcfg = _cfgs("SEMIGLOBAL", match=2, mismatch=-1, gap=-2)
    got = band_strips.score(s1, s2, cfg, group=_group(8), chunk_rows=64)
    assert got == joracle.score(s1, s2, jcfg) == 12


@pytest.mark.parametrize("m, n", [(333, 901), (901, 333), (130, 131), (5, 3), (3, 90)])
def test_swap_path_and_ragged(m, n):
    """n > m puts the strips across s1; 5 columns on 8 shards leave empty
    blocks."""
    s1, s2 = random_pair(m, n, m * 7 + n)
    got = band_strips.score(s1, s2, ScoringConfig(), group=_group(8), chunk_rows=40)
    assert got == joracle.score(s1, s2, JScoring())


def test_sw_max_on_interior_shard():
    r = np.random.default_rng(3)
    s1 = r.integers(1, 5, 640).astype(np.int8)
    s2 = r.integers(1, 5, 300).astype(np.int8)
    s1[300:340] = s2[100:140]
    cfg, jcfg = _cfgs(**SW)
    assert band_strips.score(s1, s2, cfg, group=_group(8), chunk_rows=64) == \
        joracle.score(s1, s2, jcfg)


def test_masked_sw_served_past_the_tpu_engine():
    """``tpualign``'s engine refuses a positive mismatch under SW (its
    kernel's unmasked running max); the port's located cell covers live
    cells only, so it serves it, with the oracle's score."""
    s1, s2 = random_pair(100, 100, 5)
    cfg, jcfg = _cfgs("LOCAL", match=1, mismatch=1, gap=-1)
    with pytest.raises(ValueError):
        jband_strips.score(s1, s2, jcfg, mesh=make_mesh(8), rows=2, interpret=True)
    assert band_strips.score(s1, s2, cfg, group=_group(8), chunk_rows=32) == \
        joracle.score(s1, s2, jcfg)


@pytest.mark.parametrize("mode", ["GLOBAL", "LOCAL", "SEMIGLOBAL", "INFIX"])
@pytest.mark.parametrize("m, n", [(0, 5), (4, 0), (0, 0)])
def test_empty_sequences(mode, m, n):
    cfg, jcfg = _cfgs(mode, match=2, mismatch=-1, gap=-2)
    s1, s2 = np.ones(m, np.int8), np.ones(n, np.int8)
    assert band_strips.score(s1, s2, cfg, group=_group(2)) == \
        jband_strips.score(s1, s2, jcfg, mesh=make_mesh(2))


@pytest.mark.parametrize("m, n", [(30, 40), (0, 5)])
def test_refuses_affine(m, n):
    s1, s2 = random_pair(m, n, 1)
    cfg, jcfg = _cfgs(gap_open=-5, gap_extend=-2)
    with pytest.raises(ValueError, match="affine"):
        jband_strips.score(s1, s2, jcfg, mesh=make_mesh(2))
    with pytest.raises(ValueError, match="affine"):
        band_strips.score(s1, s2, cfg, group=_group(2))


def test_refuses_chunk_depth_below_one():
    s1, s2 = random_pair(30, 40, 1)
    with pytest.raises(ValueError, match="chunk_rows"):
        band_strips.score(s1, s2, group=_group(2), chunk_rows=0)


# K7's sharded contract through the shim


@pytest.fixture(scope="module")
def dll(tmp_path_factory):
    sys.path.insert(0, TOOLS)
    import rehearse_kernels

    return rehearse_kernels, rehearse_kernels.build(
        str(tmp_path_factory.mktemp("rehearse_edge")), sources=("band_capture_edge.cu",))


EDGE_GEOMETRIES = [(1, 32), (2, 32), (1, 32, 1), (2, 64, 3), (1, 32, 9), (16, 32), None]


@pytest.mark.parametrize("c", range(21))
def test_edge_fill_through_the_shim(dll, c):
    """``band_capture_edge`` word for word against ``capture_plain`` with
    the same edges: pair scoring and the DNA matrix, NW and SW, several
    strips, one block, blocks past the strips, fewer blocks than strips,
    rings of 2 rows, with and without the located cell."""
    rk, lib = dll
    rng = np.random.default_rng(100 + c)
    local = c % 2 == 1
    mat = [None, matrices.dna(2, -1, -3)][(c // 2) % 2]
    cfg = ScoringConfig(match=2, mismatch=-1, gap=-2, matrix=mat,
                        mode=AlignMode.LOCAL if local else AlignMode.GLOBAL)
    m, n = (int(x) for x in rng.integers(1, 90, 2))
    if c % 3 == 0:
        n = int(rng.integers(90, 300))
    ok, where = rk.edge_case(lib, rng, cfg, m, n, EDGE_GEOMETRIES[c % len(EDGE_GEOMETRIES)],
                             locate=c % 3 != 2, shallow=c % 4 == 0)
    assert ok, where


@pytest.mark.parametrize("kw", [GEN, SW, dict(match=2, mismatch=-1, gap=-2, mode="INFIX")],
                         ids=["gen", "sw", "infix"])
def test_pipeline_through_the_shim(dll, monkeypatch, kw):
    """The pipeline at P = 3 with ``band.edge_fill`` replaced by the shim's
    entry: the oracle's score, one launch a chunk a shard."""
    rk, lib = dll
    shim = rk.shim_edge_fill(lib)
    monkeypatch.setattr(band, "edge_fill", shim)
    cfg, jcfg = _cfgs(**kw)
    s1, s2 = random_pair(150, 110, 19, lo=1)
    before = trace.counters().get("launch.band_capture_edge", 0)
    got = band_strips.score(s1, s2, cfg, group=_group(3), chunk_rows=40)
    assert got == joracle.score(s1, s2, jcfg)
    # 3 chunks of the 110 rows on each shard
    assert trace.counters()["launch.band_capture_edge"] - before == 3 * 3


def test_capture_plain_edges_refusals():
    t = torch.ones(5, dtype=torch.int8)
    q = torch.ones(4, dtype=torch.int8)
    top, left = torch.zeros(6, dtype=torch.int32), torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        band.capture_plain(t, q, ScoringConfig(), top=top)
    with pytest.raises(ValueError, match="linear gaps"):
        band.capture_plain(t, q, ScoringConfig(gap_open=-3, gap_extend=-1), top=top, left=left)
    with pytest.raises(ValueError, match=r"shape \(5,\)"):
        band.edge_fill(t, q, ScoringConfig(), top, left[:4])
    with pytest.raises(ValueError, match="int32"):
        band.edge_fill(t, q, ScoringConfig(), top.long(), left)
