"""A run's window, check and metrics on the CPU at small sizes: the
program's CPU path comes out correct in every cell, and a run with the timed
path broken underneath comes out not correct, once for each fault the cell
can have (a call that returns the state it had, an answer altered where it
is produced, half of a batch left out)."""

import contextlib
import dataclasses
import importlib
import time
import types

import numpy as np
import pytest
import torch

import tpualign_torch as tt
from benchmark import harness, spec, trace
from benchmark.control import Control, control_run
from tpualign_torch import api
from tpualign_torch.ops import band_align, hirschberg

SPEC = spec.load()
#: the benchmark's cells, and a batch of pairs through ``align_score_batch``
#: under a cell's configuration, which no cell drives yet
BATCH = "batch"
CELLS = [w["name"] for w in SPEC["workloads"]] + [BATCH]


def small(name: str) -> spec.Workload:
    """The cell with its pairs cut to a few hundred bases a side."""
    if name == BATCH:
        w = spec.workload(SPEC, SPEC["workloads"][0]["name"])
        return dataclasses.replace(w, name=BATCH, traffic=dict(
            entry="align_score_batch", pairs=8, text=[50, 249], query=[50, 249], pool=2))
    w = spec.workload(SPEC, name)
    t = dict(w.traffic)
    assert t["pairs"] == 1
    t.update(text=[400, 400], query=[420, 420])
    return dataclasses.replace(w, traffic=t)


@pytest.fixture(autouse=True)
def core_route(monkeypatch):
    """``align``'s route past the full table, at small sizes."""
    monkeypatch.setattr(api, "FULL_TABLE_CELL_LIMIT", 3000)
    monkeypatch.setattr(hirschberg, "BASE_CELLS", 3000)
    monkeypatch.setattr(hirschberg, "KWAY_MIN_ROWS", 300)
    monkeypatch.setattr(hirschberg, "KWAY_LEAF_ROWS", 70)
    monkeypatch.setattr(band_align, "SW_WINDOW_LIMIT", 0)


def run_cell(w, target, traced=False, seed=2**31 + 5):
    run = harness.measure(w, target, seed=seed, seconds=0.2, traced=traced, device="cpu",
                          start=time.perf_counter(), program=tt)
    checks, at_fault = harness.judge(run, harness.expected_scores(run, device="cpu"))
    return run, checks, at_fault


def correct(checks):
    return all(v <= harness.LIMITS[k] for k, v in checks.items())


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(cell):
    w = small(cell)
    run, checks, at_fault = run_cell(w, harness.Port(tt, w.config, "cpu"))
    assert correct(checks) and at_fault == 0 and len(run.calls) >= 2
    assert set(checks) == ({"wrong_scores", "failed_calls", "bad_alignments"}
                           if w.traffic["entry"] == "align" else {"wrong_scores", "failed_calls"})
    metrics = harness.metrics(run, traced=False)
    assert set(metrics) == {m.name for m in w.end_to_end}
    assert all(v["value"] > 0 for v in metrics.values())
    if "score_gcups" in metrics:
        cells = sum(run.pool[c.index].cells for c in run.calls)
        assert metrics["score_gcups"]["value"] == pytest.approx(cells / run.window_s / 1e9)


class Fault:
    """The program with a fault planted where the answer is produced."""

    def __init__(self, port, kind):
        self.port, self.kind, self.last = port, kind, None

    def _out(self, answer):
        if self.kind == "stale":
            answer, self.last = (answer if self.last is None else self.last), answer
        elif self.kind == "altered":
            if isinstance(answer, tuple):
                score, a1, a2 = answer
                k = next(i for i, c in enumerate(a1) if c != "-")
                answer = (score, a1[:k] + ("A" if a1[k] != "A" else "C") + a1[k + 1:], a2)
            elif isinstance(answer, np.ndarray):
                answer = answer.copy()
                answer[len(answer) // 2] += 1
            else:
                answer += 1
        elif self.kind == "half_batch":
            half = len(answer) // 2
            answer = answer.copy()
            answer[half:] = int(answer[:half].mean())
        return answer

    def align_score(self, s1, s2):
        return self._out(self.port.align_score(s1, s2))

    def align(self, s1, s2, stats=None):
        return self._out(self.port.align(s1, s2, stats))

    def align_score_batch(self, texts, queries):
        return self._out(self.port.align_score_batch(texts, queries))


FAULTS = [(cell, kind) for cell in CELLS for kind in ("stale", "altered")]
FAULTS += [(BATCH, "half_batch")]


@pytest.mark.parametrize("cell, kind", FAULTS)
def test_a_broken_path_is_not_correct(cell, kind):
    w = small(cell)
    port = harness.Port(tt, w.config, "cpu")
    run, checks, at_fault = run_cell(w, Fault(port, kind))
    expected = harness.expected_scores(run, device="cpu")
    assert not np.array_equal(expected[0], expected[1])  # a stale answer can show
    assert not correct(checks) and at_fault >= 1


def test_a_call_that_raises_is_counted():
    w = small(CELLS[0])

    class Raises:
        calls = 0

        def align_score(self, s1, s2):
            Raises.calls += 1
            if Raises.calls == 4:
                raise RuntimeError("planted")
            return tt.align_score(s1, s2, harness.Port(tt, w.config, "cpu").scoring,
                                  tt.EngineConfig(device="cpu"))

    run, checks, at_fault = run_cell(w, Raises())
    assert checks["failed_calls"] == 1 and at_fault == 1 and not correct(checks)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_at_a_small_size_is_judged(cell):
    """Where every value fits 16 bits the control is exact; the card's
    readings at the cells' sizes are in ``PERF.md``."""
    w = small(cell)
    run = control_run(w, Control(w, "cpu"), seed=3, device="cpu")
    checks, _ = harness.judge(run, harness.expected_scores(run, device="cpu"))
    assert checks["wrong_scores"] == 0 and checks["failed_calls"] == 0
    if w.traffic["entry"] == "align":  # the control gives no strings
        assert checks["bad_alignments"] == len(run.calls)


#: per-layer metrics read from the device trace: nothing to read without a
#: device, so their readers leave them out on the CPU
FROM_THE_DEVICE = {e["name"] for e in SPEC["per_layer"] if e["source"] == "device_trace"}
#: per-layer metrics whose readers document 0 on the CPU, with the reason
ZERO_ON_THE_CPU = {
    "free_memory_ms.score": "no ring is planned on the CPU, so no free-memory query runs",
    "launches.align": "the plain versions launch nothing",
}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_metrics_on_the_cpu(cell):
    w = small(cell)
    run, checks, _ = run_cell(w, harness.Port(tt, w.config, "cpu"), traced=True)
    assert correct(checks) and run.trace is None  # no device activity on the CPU
    got = harness.metrics(run, traced=True)
    names = {m.name for m in w.per_layer}
    assert set(got) == names - FROM_THE_DEVICE
    for name, v in got.items():
        assert v["value"] >= 0 if name in ZERO_ON_THE_CPU else v["value"] > 0, name
    run.trace = trace.Trace(busy_s=1.0, kernel_s=2.0, device_ops=[], idle_gaps=[])
    got = harness.metrics(run, traced=True)
    if "score_kernels_roofline" in names:
        from benchmark import roofline
        least = sum(roofline.call_bound(w.config, [(t.size, q.size) for t, q in zip(
            run.pool[c.index].texts, run.pool[c.index].queries)]) for c in run.calls)
        assert got["score_kernels_roofline"]["value"] == pytest.approx(100 * least / 2.0)


def test_a_readers_instrument_wraps_the_program_in_the_traced_run():
    """A per-layer metric's reader may put a host-clock span around a part
    of the program; the traced run enters it, and takes it off after."""
    from tpualign_torch.ops import band_batch

    original = band_batch.pack_pairs

    @contextlib.contextmanager
    def instrument(program, span):
        module = importlib.import_module(f"{program.__name__}.ops.band_batch")

        def timed(*args, **kwargs):
            with span("pack_pairs"):
                return original(*args, **kwargs)

        module.pack_pairs = timed
        try:
            yield
        finally:
            module.pack_pairs = original

    def read(run):
        times = [c.spans["pack_pairs"] for c in run.calls if "pack_pairs" in c.spans]
        return 1e3 * sum(times) / len(times) if times else None

    reader = types.SimpleNamespace(instrument=instrument, read=read)
    w = small(BATCH)
    w = dataclasses.replace(w, per_layer=[spec.Metric("pack_ms", "ms", reader)])
    run, checks, _ = run_cell(w, harness.Port(tt, w.config, "cpu"), traced=True)
    assert correct(checks) and band_batch.pack_pairs is original
    assert all("pack_pairs" in c.spans and "call" in c.spans for c in run.calls)
    assert harness.metrics(run, traced=True)["pack_ms"]["value"] > 0


@pytest.mark.parametrize("extra, want", [
    ({}, dict(gap_open=None, gap_extend=None, matrix=None)),
    (dict(gap_open=-5, gap_extend=-2), dict(gap_open=-5, gap_extend=-2, matrix=None)),
    (dict(matrix=[[0, 0, 0, 0, 0]] + [[0] + [2 if a == b else -1 for b in range(1, 5)]
                                       for a in range(1, 5)]),
     dict(gap_open=None, gap_extend=None)),
])
def test_the_port_takes_every_key_of_the_scheme(extra, want):
    config = dict(spec.workload(SPEC, CELLS[0]).config, **extra)
    scoring = harness.Port(tt, config, "cpu").scoring
    assert (scoring.match, scoring.mismatch, scoring.gap) == (
        config["match"], config["mismatch"], config["gap"])
    assert scoring.mode is tt.AlignMode[config["mode"].upper()]
    for key, value in want.items():
        assert getattr(scoring, key) == value
    if "matrix" in extra:
        assert scoring.matrix == tuple(map(tuple, extra["matrix"]))
    assert harness.Port(tt, dict(config, mode="infix"), "cpu").scoring.mode is tt.AlignMode.INFIX


def _event(name, start, end, device):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start, end=end),
                                 device_type=device)


def test_reading_a_trace():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _event("bench:window", 0, 100, cpu),
        _event("bench:call", 5, 50, cpu), _event("bench:pack_pairs", 6, 20, cpu),
        _event("bench:call", 55, 98, cpu),
        _event("bench:call", 5, 50, cuda),  # the profiler's copy of a label on the device
        _event("Memcpy HtoD (Pageable -> Device)", 21, 23, cuda),
        _event("band_fill_kernel", 23, 45, cuda), _event("band_fill_kernel", 60, 90, cuda),
        _event("aten::max", 40, 47, cuda), _event("before the window", -10, -5, cuda),
    ]
    got = trace.read(types.SimpleNamespace(events=lambda: events))
    assert got.busy_s == pytest.approx((47 - 21 + 30) / 1e6)
    assert got.kernel_s == pytest.approx((22 + 30 + 7) / 1e6)
    assert got.device_ops[0] == ("band_fill_kernel", pytest.approx(52 / 1e6))
    assert got.idle_gaps[0] == ("pack_pairs", pytest.approx(21 / 1e6))
    assert [name for name, _ in got.idle_gaps] == ["pack_pairs", "between calls", "call"]
