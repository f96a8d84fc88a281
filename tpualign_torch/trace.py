"""The port's one recorder of spans and counters.

A **span** names a stretch of host work: ``with trace.span("plan"): ...``.
Spans are off by default: :func:`span` then returns one shared null context
after a single test of a module flag, reads no clock and records nothing.
Inside :func:`recording` each span records ``(call, parent, name, t0, t1)``
on ``time.perf_counter_ns`` in memory and enters a **label** around its
work, by default ``torch.profiler.record_function("tpualign:" + name)``, so
that a profiled run shows the spans on the same timeline as the device's
kernels.  A span opened while no span is open is a **root**: it opens a new
call, and every span inside it carries the call's id and its parent.  The
entry points' roots are ``align_score``, ``align`` and
``align_score_batch``; an entry point called inside another's call is a
span of that call.  Spans open and close on the thread that opened the
call's root; a span on another thread is not recorded.

``span(name, timed=True)`` also gives its own duration (``.seconds``) when
recording is off, for the ``stats=`` dicts of the alignment paths, which
read the same two clock readings as the span.

A **counter** is one integer by name (``launch.band_fill``,
``free_memory``, ``alloc_bytes``, ...), always on: :func:`count` adds to it
and :func:`counters` reads every counter.  While a call is recorded, the
call also keeps its own share of each counter.

:func:`take` returns the finished calls (:class:`Call`) and forgets them.
The one hook for an exporter is ``recording(label=...)``: a factory
``label(name) -> context manager`` that replaces the default label for the
recording's extent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, ContextManager, Dict, List, NamedTuple, Optional

import torch

#: the default label's prefix on the profiler's timeline
PREFIX = "tpualign:"

_clock = time.perf_counter_ns
_NULL = contextlib.nullcontext()

_on = False  # inside recording()
_labels: List[Optional[Callable[[str], ContextManager]]] = []  # the open recordings'
_label: Callable[[str], ContextManager]  # the label in effect
_open: List["_Span"] = []  # the open spans of the recorded call, its root first
_call: Optional["Call"] = None  # the call being recorded
_owner: Optional[int] = None  # the thread of its root
_done: List["Call"] = []
_ids = 0
_counters: Dict[str, int] = {}


def _default_label(name: str) -> ContextManager:
    return torch.profiler.record_function(PREFIX + name)


_label = _default_label


class Span(NamedTuple):
    """A recorded span: host-clock nanoseconds ``t0``, ``t1``; ``parent``
    is the index of the enclosing span in its call's spans, None for the
    root; ``attrs`` what :func:`tag` set on it."""

    call: int
    parent: Optional[int]
    name: str
    t0: int
    t1: int
    attrs: Optional[dict] = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


@dataclasses.dataclass
class Call:
    """One root call: its spans in the order they opened (the root first),
    whether it raised, and the counters it moved."""

    name: str
    id: int
    raised: bool
    spans: List[Span]
    counters: Dict[str, int]

    @property
    def root(self) -> Span:
        return self.spans[0]

    def ms(self, name: str) -> float:
        """Milliseconds of every span named ``name``, summed."""
        return sum(s.t1 - s.t0 for s in self.spans if s.name == name) / 1e6

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "raised": self.raised,
                "counters": dict(self.counters),
                "spans": [{"name": s.name, "parent": s.parent, "t0_ns": s.t0, "t1_ns": s.t1,
                           **({"attrs": s.attrs} if s.attrs else {})} for s in self.spans]}


class _Clock:
    """A span's two clock readings, without recording."""

    __slots__ = ("t0", "t1")

    def __enter__(self):
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.t1 = _clock()
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


class _Span(_Clock):
    __slots__ = ("name", "index", "parent", "attrs", "label")

    def __init__(self, name: str):
        self.name = name
        self.attrs = None

    def __enter__(self):
        global _call, _owner, _ids
        # the label's own cost falls inside the span, not in its parent's
        # self time
        self.t0 = _clock()
        if _open:
            self.parent = _open[-1].index
        else:
            _ids += 1
            _call = Call(self.name, _ids, False, [], {})
            _owner = threading.get_ident()
            self.parent = None
        self.index = len(_call.spans)
        _call.spans.append(self)
        _open.append(self)
        self.label = _label(self.name)
        self.label.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _call
        self.label.__exit__(exc_type, exc, tb)
        self.t1 = _clock()
        _open.pop()
        if not _open:
            call, _call = _call, None
            call.raised = exc_type is not None
            call.spans = [Span(call.id, s.parent, s.name, s.t0, s.t1, s.attrs)
                          for s in call.spans]
            _done.append(call)
        return False


def span(name: str, timed: bool = False):
    """A context manager around the work called ``name``: the shared null
    context when recording is off (a :class:`_Clock` with ``timed``), else
    a recorded span (module docstring).  ``as`` gives an object whose
    ``seconds`` is the span's duration, where it was timed or recorded."""
    if not _on:
        return _Clock() if timed else _NULL
    if _open and threading.get_ident() != _owner:
        return _Clock() if timed else _NULL
    return _Span(name)


def tag(**attrs) -> None:
    """Set attributes on the innermost open span of the recorded call
    (nothing when no call is recorded)."""
    if _open:
        s = _open[-1]
        s.attrs = {**(s.attrs or {}), **attrs}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, and to the recorded call's share
    of it while a call is recorded.  Counters are read and written on the
    calling thread: work on other threads returns its numbers to it."""
    _counters[name] = _counters.get(name, 0) + n
    if _open:
        _call.counters[name] = _call.counters.get(name, 0) + n


def count_bytes(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Add the bytes of ``tensors`` (None skipped) to the counter
    ``name``."""
    count(name, sum(t.nbytes for t in tensors if t is not None))


def counters() -> Dict[str, int]:
    """Every counter, as a new dict."""
    return dict(_counters)


@contextlib.contextmanager
def recording(label: Optional[Callable[[str], ContextManager]] = None):
    """Record spans for the extent of the block.  Nests: the innermost
    recording that gives a ``label`` factory decides every span's label
    (the default: ``torch.profiler.record_function("tpualign:" + name)``),
    and recording stops when the outermost block ends."""
    global _on, _label
    _labels.append(label)
    _on = True
    _label = next((f for f in reversed(_labels) if f is not None), _default_label)
    try:
        yield
    finally:
        _labels.pop()
        _on = bool(_labels)
        _label = next((f for f in reversed(_labels) if f is not None), _default_label)


def take() -> List[Call]:
    """The calls finished since the last take, oldest first; forgets
    them."""
    out = list(_done)
    _done.clear()
    return out
