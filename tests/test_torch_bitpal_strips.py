"""The bit-parallel strips over a shard group
(``tpualign_torch.parallel.bitpal_strips``) against
``tpualign.parallel.bitpal_strips`` on the conftest's virtual CPU mesh
(``make_mesh(P)``, ``interpret=True``), and K4's sharded contract.

- Scores: the JAX package's engine at P = 1, 4 and 8 (g = 1) and at P = 4
  for g = 2 and 3 and a scaled member, on ``tests/test_bitpal_strips.py``'s
  pairs and chunk lengths; against its oracle, the cases that file holds
  its engine to (several words a shard and many chunks, one chunk, a last
  shard of pad words), at g = 1..3, and the shard count's invariance.
- ``col_deltas_fn``: the final column's deltas row for row up to n, equal
  to the JAX package's and to one plain fill's (``bitpal.row_deltas``).
- Refusals: a config outside the family, matrix and ends-free configs,
  codes outside 0..4; empty sequences as the JAX package's.
- K4's sharded contract (``bitpal_gfill_stream``, the band body's STREAM
  flag) built through ``tools/rehearse_kernels.py``'s shim
  (``bitpal_rc.cu`` alone) against ``chunk_plain`` with the same upstream
  stream, chunk by chunk: planes, hand-offs and the tail word for word
  (``rehearse_kernels.stream_case``: outputs and ring seeded with garbage,
  blocks 1, 2, 3 and the planner's, rings of 2 rows, blocks at once, a
  random state in, tails of the first, the last and a middle word, no
  stream in); and the pipeline at P = 3 driven through that entry.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tpualign.config import ScoringConfig as JScoring
from tpualign.io.bdna import random_pair
from tpualign.ops import oracle as joracle
from tpualign.parallel import bitpal_strips as jbitpal_strips
from tpualign.parallel.mesh import make_mesh
from tpualign_torch import matrices, trace
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.ops import bitpal
from tpualign_torch.parallel import bitpal_strips, mesh

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


def _group(P):
    return mesh.make_group(P, device="cpu")


@pytest.mark.parametrize("P", [1, 4, 8])
def test_scores_match_jax_bitpal_strips(P):
    """``tests/test_bitpal_strips.py``'s small pair on P shards: 80 rows,
    pad words on most shards."""
    s1, s2 = random_pair(70, 80, seed=P)
    want = jbitpal_strips.score(s1, s2, JScoring(), mesh=make_mesh(P), chunk_cols=16,
                                interpret=True)
    assert bitpal_strips.score(s1, s2, group=_group(P), chunk_cols=16) == want


@pytest.mark.parametrize("kw", [dict(gap=-2), dict(gap=-3), dict(match=3, mismatch=2, gap=-1),
                                dict(match=2, mismatch=0, gap=-2)],
                         ids=["g2", "g3", "(3, 2, -1)", "(2, 0, -2)"])
def test_generalized_gap_matches_jax(kw):
    s1, s2 = random_pair(140, 170, seed=13)
    want = jbitpal_strips.score(s1, s2, JScoring(**kw), mesh=make_mesh(4), chunk_cols=32,
                                interpret=True)
    assert want == joracle.score(s1, s2, JScoring(**kw))
    assert bitpal_strips.score(s1, s2, ScoringConfig(**kw), group=_group(4),
                               chunk_cols=32) == want


@pytest.mark.parametrize("m, n, P, chunk", [
    (300, 31 * 17 + 5, 8, 32),  # several words a shard, many chunks
    (40, 200, 4, 4096),  # one chunk
    (90, 64 * 5 + 3, 4, 16),  # 6 words on 4 shards of 2: the last shard pads
    (700, 1300, 3, 100),  # 21 words, 7 a shard: the stream's delay of 6 steps
    (1, 130, 3, 8), (130, 1, 3, 8),
])
@pytest.mark.parametrize("g", [1, 2, 3])
def test_against_the_oracle(m, n, P, chunk, g):
    s1, s2 = random_pair(m, n, seed=m + n + g)
    cfg = ScoringConfig(gap=-g)
    got = bitpal_strips.score(s1, s2, cfg, group=_group(P), chunk_cols=chunk)
    assert got == joracle.score(s1, s2, JScoring(gap=-g))


def test_shard_count_invariance():
    s1, s2 = random_pair(400, 900, seed=29)
    want = joracle.score(s1, s2, JScoring())
    for P in (1, 2, 3, 5, 8):
        assert bitpal_strips.score(s1, s2, group=_group(P), chunk_cols=64) == want, P


@pytest.mark.parametrize("g, P", [(1, 4), (2, 8)])
def test_col_deltas_match_jax(g, P):
    """The final column's deltas row for row up to n: the JAX package's
    sharded ``col_deltas_fn`` and one plain fill's."""
    s1, s2 = random_pair(150, 330, seed=g)
    import jax.numpy as jnp

    jfn = jbitpal_strips.col_deltas_fn(150, 330, JScoring(gap=-g), mesh=make_mesh(P),
                                       chunk_cols=32, interpret=True)
    want = np.asarray(jfn(jnp.asarray(s1, jnp.int32), jnp.asarray(s2, jnp.int32)))[:330]
    got = bitpal_strips.col_deltas_fn(150, 330, ScoringConfig(gap=-g), group=_group(P),
                                      chunk_cols=32)(s1, s2)
    assert got.tolist() == want.tolist()
    t, q = torch.from_numpy(s1), torch.from_numpy(s2)
    planes = bitpal.fill_g_plain(t, bitpal._eq_planes(q, 330), 330, g)[0]
    assert torch.equal(got, bitpal.row_deltas(planes, 330, g))


def test_refusals():
    s1, s2 = random_pair(50, 60, seed=6)
    with pytest.raises(ValueError, match="family"):
        bitpal_strips.score(s1, s2, ScoringConfig(match=2, mismatch=1, gap=-2), group=_group(4))
    for cfg in (ScoringConfig(matrix=matrices.dna()), ScoringConfig(mode=AlignMode.SEMIGLOBAL)):
        with pytest.raises(ValueError, match="pair-scored global/local"):
            bitpal_strips.score(s1, s2, cfg, group=_group(4))
    with pytest.raises(ValueError, match="family"):
        bitpal_strips.score(s1, s2, ScoringConfig(mode=AlignMode.LOCAL), group=_group(4))
    with pytest.raises(ValueError, match="codes 0..4"):
        bitpal_strips.score(s1 + 3, s2, group=_group(4))
    with pytest.raises(ValueError, match="chunk_cols"):
        bitpal_strips.score(s1, s2, group=_group(4), chunk_cols=0)


@pytest.mark.parametrize("m, n", [(0, 5), (4, 0), (0, 0)])
def test_empty_sequences(m, n):
    s1, s2 = np.ones(m, np.int8), np.ones(n, np.int8)
    want = jbitpal_strips.score(s1, s2, JScoring(gap=-2), mesh=make_mesh(2))
    assert bitpal_strips.score(s1, s2, ScoringConfig(gap=-2), group=_group(2)) == want


# K4's sharded contract through the shim


@pytest.fixture(scope="module")
def dll(tmp_path_factory):
    sys.path.insert(0, TOOLS)
    import rehearse_kernels

    return rehearse_kernels, rehearse_kernels.build(
        str(tmp_path_factory.mktemp("rehearse_stream")), sources=("bitpal_rc.cu",))


@pytest.mark.parametrize("c", range(21))
def test_stream_chunks_through_the_shim(dll, c):
    """``bitpal_gfill_stream`` chunk by chunk against ``chunk_plain`` with
    the same random upstream stream: g = 1..7 in turn, one band to three,
    chunk edges in the ramps, forced blocks, rings of 2 rows, blocks at
    once, a random state in, tails of the last, the first and a middle
    word, a launch without a stream in."""
    rk, lib = dll
    rng = np.random.default_rng(200 + c)
    g = 1 + c % 7
    bands = int(rng.integers(1, 4))
    nq = int(rng.integers(1, 32 * bands * 64 + 1))
    nw = -(-nq // 64)
    mt = int(rng.integers(1, 80)) if c % 3 else int(rng.integers(64, 128))
    lengths = ([int(x) for x in rng.integers(1, 40, 3)] if c % 2 else
               [int(rng.integers(1, 34)), 32, 33])
    tail_word = [None, 0, int(rng.integers(0, nw))][c % 3]
    ok, where = rk.stream_case(lib, rng, nq, mt, g, lengths, [1, 2, 3, None][c % 4],
                               shallow=c % 3 == 0, concurrent=c % 5 == 0,
                               tail_word=tail_word, junk=c % 7 == 3, with_u=c % 6 != 5)
    assert ok, where


@pytest.mark.parametrize("g", [1, 2])
def test_pipeline_through_the_shim(dll, monkeypatch, g):
    """The pipeline at P = 3 with ``bitpal.fill_g_stream`` replaced by the
    shim's entry: the oracle's score, one launch a live chunk a shard."""
    rk, lib = dll
    shim = rk.shim_fill_g_stream(lib)
    monkeypatch.setattr(bitpal, "fill_g_stream", shim)
    s1, s2 = random_pair(200, 64 * 7 + 9, seed=g)
    before = trace.counters().get("launch.bitpal_gfill_stream", 0)
    got = bitpal_strips.score(s1, s2, ScoringConfig(gap=-g), group=_group(3), chunk_cols=48)
    assert got == joracle.score(s1, s2, JScoring(gap=-g))
    nw, nwl, d, K = bitpal_strips.geometry(s2.size, s1.size, 3, 48)
    launched = trace.counters()["launch.bitpal_gfill_stream"] - before
    assert (nw, nwl, d) == (8, 3, 2) and launched == 3 * K
