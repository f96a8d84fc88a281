"""The affine plain reference (``benchmark/reference/affine.py``) against the
port's NumPy Gotoh tables, its check of an alignment's strings, and the cell
``affine.pair64gb.align`` at a small size with Myers-Miller's nodes split
into leaves, as at the cell's own size."""

import time

import numpy as np
import pytest
import torch

import tpualign_torch as tt
from benchmark import harness, program_spans, spec
from benchmark.reference import affine, alignment
from benchmark.tests.test_bench_harness import Fault, core_route, correct, small  # noqa: F401
from tpualign_torch.ops import affine_align, oracle

SPEC = spec.load()
CELL = "affine.pair64gb.align"
CONFIG = spec.workload(SPEC, CELL).config


def _config(mode):
    return dict(CONFIG, mode=mode)


def _scoring(config):
    return harness.Port(tt, config, "cpu").scoring


def _pairs(seed, count):
    rng = np.random.default_rng(seed)
    texts = [rng.integers(1, 5, rng.integers(1, 300), dtype=np.int8) for _ in range(count)]
    queries = [rng.integers(1, 5, rng.integers(1, 200), dtype=np.int8) for _ in range(count)]
    # one-base pairs, and a query copied from its text, beside unrelated ones
    texts += [texts[0][:1], texts[1][:1], texts[2][:120]]
    queries += [queries[0][:1], queries[1][:7], texts[2][30:90].copy()]
    return texts, queries


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode", ["global", "local"])
def test_scores_equal_the_gotoh_tables(mode, seed):
    """The corner of ``oracle.affine_tables`` (global) or its largest cell
    (local), pair by pair, from one padded scan; int16 is exact where every
    value fits."""
    config = _config(mode)
    texts, queries = _pairs(seed, 6)
    want = []
    for t, q in zip(texts, queries):
        H, _, _ = oracle.affine_tables(t, q, _scoring(config))
        want.append(int(H[-1, -1]) if mode == "global" else int(H.max()))
    got = affine.scores(texts, queries, config, device="cpu")
    assert got.dtype == np.int64 and got.tolist() == want
    low = affine.scores(texts, queries, config, device="cpu", dtype=torch.int16)
    assert low.tolist() == want


def test_the_reference_refuses_other_schemes():
    for bad in (dict(CONFIG, mode="infix"), dict(CONFIG, mode="semiglobal"),
                dict(CONFIG, gap_open=None, gap_extend=None, gap=-2),
                dict(CONFIG, gap_open=2),
                dict(CONFIG, matrix=[[0, 1], [1, 0]])):
        with pytest.raises(ValueError):
            affine.Scheme.from_config(bad)


def _split_a_gap_run(a1, a2):
    """The same alignment with one gap run of two or more split in two: the
    letter beside the run moves into the run's end column, where it meets
    a letter equal to the one it left, and the gap it leaves touches no
    other run, so one open more is charged and nothing else changes.  None
    where no run allows it."""
    for x, y, swap in ((a1, a2, False), (a2, a1, True)):
        k = 0
        while k < len(x):
            if x[k] != "-":
                k += 1
                continue
            end = k
            while end < len(x) and x[end] == "-":
                end += 1
            if end - k >= 2:
                if (end < len(x) and y[end] != "-" and y[end - 1] == y[end]
                        and x[end + 1:end + 2] != "-"):
                    x2 = x[:end - 1] + x[end] + "-" + x[end + 1:]
                    return (y, x2) if swap else (x2, y)
                if k > 0 and y[k - 1] != "-" and y[k - 1] == y[k] and x[k - 2:k - 1] != "-":
                    x2 = x[:k - 1] + "-" + x[k - 1] + x[k + 1:]
                    return (y, x2) if swap else (x2, y)
            k = end
    return None


@pytest.mark.parametrize("where", ["text", "query"])
def test_the_check_of_the_strings(where):
    """The full-table traceback's strings pass; the same letters with one
    gap run split in two, a misspelled string, a wrong optimum and a column
    of two gaps do not."""
    config = _config("global")
    cfg = _scoring(config)
    rng = np.random.default_rng(4)
    a = rng.integers(1, 5, 80).astype(np.int8)
    b = a.copy()
    b[::9] = b[::9] % 4 + 1
    c = a[40]  # an insertion of three copies of the next base: one gap run of 3
    b = np.concatenate([b[:40], [c, c, c], b[40:]]).astype(np.int8)
    s1, s2 = (a, b) if where == "query" else (b, a)
    score, a1, a2 = oracle.traceback(s1, s2, cfg)
    best = int(affine.scores([s1], [s2], config, device="cpu")[0])
    assert score == best and affine.fault(s1, s2, a1, a2, config, best) is None
    split = _split_a_gap_run(a1, a2)
    assert split is not None
    assert affine.Scheme.from_config(config).columns(
        *(alignment._codes(s) for s in split)) == best + config["gap_open"]
    assert "score" in affine.fault(s1, s2, *split, config, best)
    k = next(i for i, ch in enumerate(a1) if ch != "-")
    assert affine.fault(s1, s2, a1[:k] + ("A" if a1[k] != "A" else "C") + a1[k + 1:], a2,
                        config, best)
    assert affine.fault(s1, s2, a1, a2, config, best + 1)
    assert affine.fault(s1, s2, a1 + "-", a2 + "-", config, best)


def test_two_adjacent_runs_in_different_strings_are_two_gaps():
    scheme = affine.Scheme.from_config(_config("global"))
    # "AC-G" over "A-TG": a gap in each string, side by side
    c1, c2 = alignment._codes("AC-G"), alignment._codes("A-TG")
    assert scheme.columns(c1, c2) == 2 * 1 + 2 * (scheme.open + scheme.ext)
    c1, c2 = alignment._codes("A--G"), alignment._codes("ACTG")
    assert scheme.columns(c1, c2) == 2 * 1 + scheme.open + 2 * scheme.ext


@pytest.fixture
def split_nodes(monkeypatch):
    """Myers-Miller nodes at the small cell's size, down to leaves of a few
    thousand cells."""
    monkeypatch.setattr(affine_align, "BASE_CELLS", 3000)


def run_cell(w, target, traced=False):
    """``test_bench_harness.run_cell`` with a window of 1 s: a call with its
    nodes split takes ~0.1-0.3 s on the CPU, and a stale answer shows only
    from the second call on."""
    run = harness.measure(w, target, seed=2**31 + 5, seconds=1.0, traced=traced, device="cpu",
                          start=time.perf_counter(), program=tt)
    checks, at_fault = harness.judge(run, harness.expected_scores(run, device="cpu"))
    return run, checks, at_fault


def test_the_cell_splits_nodes_and_is_correct(split_nodes):
    w = small(CELL)
    run, checks, at_fault = run_cell(w, harness.Port(tt, w.config, "cpu"), traced=True)
    assert correct(checks) and at_fault == 0 and len(run.calls) >= 2
    calls = program_spans.window(run)
    assert all(c.counters["nodes.affine"] >= 3 for c in calls)
    got = harness.metrics(run, traced=True)
    for name in ("affine_bisect_ms.align", "affine_leaf_fill_ms.align",
                 "affine_leaf_trace_ms.align", "leaf_wait_ms.align"):
        assert got[name]["value"] > 0, name
    assert got["launches.align"]["value"] == 0  # the plain versions launch nothing
    assert "align_kernels_roofline" not in got  # read from the device trace


@pytest.mark.parametrize("kind", ["stale", "altered"])
def test_a_broken_path_in_the_cell_is_not_correct(split_nodes, kind):
    w = small(CELL)
    run, checks, at_fault = run_cell(w, Fault(harness.Port(tt, w.config, "cpu"), kind))
    expected = harness.expected_scores(run, device="cpu")
    assert not np.array_equal(expected[0], expected[1])  # a stale answer can show
    assert not correct(checks) and at_fault >= 1
