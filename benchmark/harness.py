"""One run of one cell: set-up, the measured window, the check, the result.

The window is a closed loop with one caller, as a pipeline calls the
library: each call starts once the last result is back on the host, takes
the next input of the pool, and is timed on the host clock from the call to
its result.  After the window the plain reference scores every input of the
pool on the same device, and every answer of the window is compared with
it.  The reference is the module that the configuration names
(``spec.reference``); the harness calls its ``scores`` and, for
alignments, its ``fault``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import trace as tracing
from .spec import Workload
from .traffic import Input, make_pool

#: modules that may not be loaded in the process that prints a result,
#: compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "tpualign")

#: each number compared and its limit: every comparison is exact
LIMITS = {"wrong_scores": 0, "bad_alignments": 0, "failed_calls": 0}


@dataclasses.dataclass
class Answer:
    scores: np.ndarray  # int64, one a pair of the call
    strings: Optional[List[Tuple[str, str]]] = None


#: a configuration's keys that state its scheme, as the program's
#: ``ScoringConfig`` names them; ``mode`` and ``matrix`` are converted
SCHEME_KEYS = ("match", "mismatch", "gap", "gap_open", "gap_extend")


class Port:
    """The program as the window drives it: its public entry points under
    the configuration's scheme (every key of it: the costs, affine gaps, a
    matrix, the mode), on ``device`` with the engine ``auto``."""

    def __init__(self, module, config: dict, device: str):
        self.module = module
        scheme = {k: config[k] for k in SCHEME_KEYS if config.get(k) is not None}
        if config.get("matrix") is not None:
            scheme["matrix"] = tuple(tuple(row) for row in config["matrix"])
        self.scoring = module.ScoringConfig(mode=module.AlignMode[config["mode"].upper()],
                                            **scheme)
        self.engine = module.EngineConfig(device=device)

    def align_score(self, s1, s2):
        return self.module.align_score(s1, s2, self.scoring, self.engine)

    def align(self, s1, s2, stats=None):
        return self.module.align(s1, s2, self.scoring, self.engine, stats=stats)

    def align_score_batch(self, texts, queries):
        return self.module.align_score_batch(texts, queries, self.scoring, self.engine)


def _align_score(target, inp: Input, stats) -> Answer:
    return Answer(np.array([target.align_score(inp.texts[0], inp.queries[0])], np.int64))


def _align(target, inp: Input, stats) -> Answer:
    score, a1, a2 = target.align(inp.texts[0], inp.queries[0], stats=stats)
    return Answer(np.array([score], np.int64), [(a1, a2)])


def _align_score_batch(target, inp: Input, stats) -> Answer:
    return Answer(np.asarray(target.align_score_batch(inp.texts, inp.queries), np.int64))


#: a traffic mix's ``entry``: how a call drives it
ENTRIES: Dict[str, Callable[..., Answer]] = {
    "align_score": _align_score,
    "align": _align,
    "align_score_batch": _align_score_batch,
}


@dataclasses.dataclass
class Call:
    index: int  # the pool's input
    seconds: float
    answer: Optional[Answer]
    error: Optional[str]
    stats: Optional[dict]
    spans: Dict[str, float]  # host-clock seconds by span name


@dataclasses.dataclass
class Run:
    """What a run measured; the metrics' readers take their numbers here."""

    workload: Workload
    pool: List[Input]
    calls: List[Call]
    setup_s: float
    window_s: float
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)  # seconds by part
    trace: Optional[tracing.Trace] = None

    @property
    def cells_done(self) -> int:
        return sum(self.pool[c.index].cells for c in self.calls if c.answer is not None)


class Spans:
    """Host-clock spans of the window's calls, labelled for the profiler
    when the run is traced."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.current: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        label = (torch.profiler.record_function(tracing.PREFIX + name) if self.traced
                 else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with label:
                yield
        finally:
            self.current[name] = self.current.get(name, 0.0) + time.perf_counter() - t0


def _one_call(entry, target, inp: Input, stats) -> Tuple[Optional[Answer], Optional[str]]:
    try:
        return entry(target, inp, stats), None
    except Exception:  # a failed call is counted, and the window goes on
        return None, traceback.format_exc()


def measure(workload: Workload, target, *, seed: int, seconds: float, traced: bool,
            device: str, start: float, program=None) -> Run:
    """Set-up and the window.  ``start`` is the host clock when the process
    began; set-up runs from it to the window.  ``program`` is the module the
    per-layer metrics' instruments wrap (traced runs)."""
    entry = ENTRIES[workload.traffic["entry"]]
    t0 = time.perf_counter()
    pool = make_pool(workload.traffic, workload.config, seed)
    t1 = time.perf_counter()
    for inp in pool:  # every shape of the cell, once
        _, error = _one_call(entry, target, inp, None)
        if error:
            raise RuntimeError(f"the warm-up call failed:\n{error}")
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    setup_parts = {"pool": t1 - t0, "warm_calls": time.perf_counter() - t1}
    spans = Spans(traced)
    with contextlib.ExitStack() as stack:
        if traced:
            for metric in workload.per_layer:
                if hasattr(metric.reader, "instrument"):
                    stack.enter_context(metric.reader.instrument(program, spans))
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.startswith("cuda"):
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            t0 = time.perf_counter()
            prof = stack.enter_context(torch.profiler.profile(activities=activities))
            for inp in pool:  # the profiler's own start-up, outside the window
                _one_call(entry, target, inp, None)
            setup_parts["profiler"] = time.perf_counter() - t0
        setup_s = time.perf_counter() - start
        calls: List[Call] = []
        window = (torch.profiler.record_function(tracing.PREFIX + "window") if traced
                  else contextlib.nullcontext())
        with window:
            t_window = time.perf_counter()
            while True:
                index = len(calls) % len(pool)
                stats = {} if traced else None
                spans.current = {}
                with spans("call"):
                    t0 = time.perf_counter()
                    answer, error = _one_call(entry, target, pool[index], stats)
                    t1 = time.perf_counter()
                calls.append(Call(index, t1 - t0, answer, error, stats, spans.current))
                if t1 - t_window >= seconds:
                    break
            window_s = t1 - t_window
    run = Run(workload, pool, calls, setup_s, window_s, setup_parts)
    if traced and device.startswith("cuda"):
        run.trace = tracing.read(prof)
    return run


def expected_scores(run: Run, *, device: str) -> List[np.ndarray]:
    """The reference's scores of every input of the pool, in one call."""
    texts = [t for inp in run.pool for t in inp.texts]
    queries = [q for inp in run.pool for q in inp.queries]
    flat = run.workload.reference.scores(texts, queries, run.workload.config, device=device)
    return np.split(flat, np.cumsum([len(inp.texts) for inp in run.pool])[:-1])


def judge(run: Run, expected: List[np.ndarray]) -> Tuple[Dict[str, int], int]:
    """Each number compared (wrong scores over every pair of every call,
    calls that raised, and for alignments the calls whose strings are not an
    optimal alignment), and the calls at fault."""
    wrong = bad = raised = at_fault = 0
    for call in run.calls:
        if call.answer is None:
            raised += 1
            at_fault += 1
            continue
        want = expected[call.index]
        got = call.answer.scores
        here = int((got != want).sum()) if got.shape == want.shape else want.size
        wrong += here
        if call.answer.strings is not None:
            inp = run.pool[call.index]
            faults = sum(run.workload.reference.fault(inp.texts[p], inp.queries[p], a1, a2,
                                                      run.workload.config, int(want[p]))
                         is not None
                         for p, (a1, a2) in enumerate(call.answer.strings))
            bad += faults
            here += faults
        at_fault += here > 0
    checks = {"wrong_scores": wrong, "failed_calls": raised}
    if ENTRIES[run.workload.traffic["entry"]] is _align:
        checks["bad_alignments"] = bad
    return checks, at_fault


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def metrics(run: Run, traced: bool) -> Dict[str, dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones; a reader that finds nothing to read leaves its metric out."""
    out = {}
    for metric in (run.workload.per_layer if traced else run.workload.end_to_end):
        value = metric.reader.read(run)
        if value is not None:
            out[metric.name] = {"value": float(value), "unit": metric.unit}
    return out
