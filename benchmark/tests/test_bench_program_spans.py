"""The program's spans in the traced run (``benchmark/program_spans.py``)
on the CPU at small sizes: the instrument binds once however many metrics
give it, every program span is a harness span of its call, and the four
readers of the program's spans and counters return their numbers; against
a program without ``trace`` (a version of the port older than its recorder)
the instrument does nothing and every reader returns None."""

import contextlib
import time
import types

import pytest

import tpualign_torch as tt
from benchmark import harness, program_spans, spec
from benchmark.tests.test_bench_harness import core_route, run_cell, small  # noqa: F401

NEW = ("free_memory_ms.score", "host_ms.score", "leaf_wait_ms.align", "launches.align")
SCORE_CELLS = ("sw.pair64gb.score", "nw.pair64gb.score")


def _readers(cell):
    return [m for m in spec.workload(spec.load(), cell).per_layer if m.name in NEW]


@pytest.mark.parametrize("cell", SCORE_CELLS + ("sw.pair64gb.align",))
def test_the_readers_read_the_programs_records(cell):
    w = small(cell)
    readers = _readers(cell)
    assert readers and all(m.reader.instrument is program_spans.instrument for m in readers)
    run, checks, _ = run_cell(w, harness.Port(tt, w.config, "cpu"), traced=True)
    assert all(v == 0 for v in checks.values())
    calls = program_spans.window(run)
    entry = w.traffic["entry"]
    assert len(calls) == len(run.calls) and {c.name for c in calls} == {entry}
    # each program span is a harness span of the call it ran in
    for record, call in zip(calls, run.calls):
        assert {s.name for s in record.spans} <= set(call.spans)
        assert call.spans[entry] <= call.spans["call"]
    got = {m.name: m.reader.read(run) for m in readers}
    if cell in SCORE_CELLS:
        assert got["free_memory_ms.score"] == 0.0  # no ring is planned on the CPU
        assert 0 < got["host_ms.score"] < 1e3 * max(c.seconds for c in run.calls)
    else:
        assert got["launches.align"] == 0.0  # the plain versions launch nothing
        assert 0 <= got["leaf_wait_ms.align"] < 1e3 * max(c.seconds for c in run.calls)


def test_the_instrument_binds_once_and_takes_the_records():
    entered = []

    @contextlib.contextmanager
    def label(name):
        entered.append(name)
        yield

    with program_spans.instrument(tt, label), program_spans.instrument(tt, label):
        with tt.trace.span("x"):
            pass
    assert entered == ["x"]  # one recording: the span was labelled once
    run = types.SimpleNamespace(calls=[None])
    assert [c.name for c in program_spans.window(run)] == ["x"]
    assert tt.trace.take() == [] and not tt.trace._on


@pytest.mark.parametrize("cell", SCORE_CELLS + ("sw.pair64gb.align",))
def test_a_program_without_trace_gives_none(cell):
    """A port without the recorder: the instrument does nothing, the run is
    correct, and the readers of the recorder return None."""
    stand_in = types.SimpleNamespace(**{k: getattr(tt, k) for k in tt.__all__})
    w = small(cell)
    readers = _readers(cell)
    run_cell(w, harness.Port(tt, w.config, "cpu"), traced=True)  # records left behind
    run = harness.measure(w, harness.Port(stand_in, w.config, "cpu"), seed=2**31 + 7,
                          seconds=0.2, traced=True, device="cpu", start=time.perf_counter(),
                          program=stand_in)
    checks, _ = harness.judge(run, harness.expected_scores(run, device="cpu"))
    assert all(v == 0 for v in checks.values())
    assert all(m.reader.read(run) is None for m in readers)
    got = harness.metrics(run, traced=True)
    assert not set(got) & set(NEW)
