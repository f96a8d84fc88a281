"""The generator: the same seed gives the same inputs, every seed the same
shapes, and a call's cells are what the traffic defines."""

import json

import numpy as np
import pytest

from benchmark import spec, traffic

SEEDS = [0, 7, 2**31 + 11, 2**40 + 3]


def _load(name):
    with open(spec.traffic_file(name)) as f:
        return json.load(f)


SMALL = dict(entry="align_score_batch", pairs=16, text=[50, 249], query=[30, 99], pool=2)
CONFIG = dict(alphabet=[1, 4])


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(seed):
    a = traffic.make_pool(SMALL, CONFIG, seed)
    b = traffic.make_pool(SMALL, CONFIG, seed)
    c = traffic.make_pool(SMALL, CONFIG, seed + 1)
    for x, y in zip(a, b):
        assert all(np.array_equal(s, t) for s, t in zip(x.texts + x.queries, y.texts + y.queries))
    assert not all(np.array_equal(s, t) for s, t in zip(a[0].texts, c[0].texts))


@pytest.mark.parametrize("seed", SEEDS)
def test_every_seed_the_same_shapes(seed):
    want = sorted(map(tuple, traffic.shapes(SMALL)))
    pool = traffic.make_pool(SMALL, CONFIG, seed)
    assert len(pool) == 2
    for inp in pool:
        assert sorted((t.size, q.size) for t, q in zip(inp.texts, inp.queries)) == want
        assert inp.cells == sum(m * n for m, n in want)
        codes = np.concatenate(inp.texts + inp.queries)
        assert codes.dtype == np.int8 and codes.min() >= 1 and codes.max() <= 4


def test_quantiles_of_the_uniform_law():
    m = traffic.shapes(dict(pairs=64, text=[5000, 24999], query=[5000, 24999]))
    assert m.min() >= 5000 and m.max() <= 24999
    assert sorted(m[:, 0]) == sorted(m[:, 1]) and len(set(m[:, 0])) == 64
    assert abs(m[:, 0].mean() - 15000) < 1


def test_the_cells_of_the_benchmark_mixes():
    pair = traffic.shapes(_load("pair64gb.score"))
    assert pair.tolist() == [[126440, 127240]]
    assert int(pair.prod(axis=1).sum()) == 16_088_225_600
    assert traffic.shapes(_load("pair64gb.align")).tolist() == pair.tolist()


def test_the_pairing_is_fixed():
    a, b = traffic.shapes(SMALL), traffic.shapes(dict(SMALL))
    assert a.tolist() == b.tolist()
    assert a[:, 1].tolist() != sorted(a[:, 1].tolist())  # query lengths paired out of order
