"""The program's own spans and counters in a traced run.

The program records spans and counters (``tpualign_torch.trace``) inside
``trace.recording(label=...)``.  :func:`instrument` enters that recording
for the traced run with the harness's span as the label, so every span of
the program is also a ``bench:`` span on the profiler's timeline, inside
``bench:call``, and the trace's idle gaps are named by the program's
innermost span.  On exit it keeps the calls the program recorded; the
readers take the window's calls, the last ``len(run.calls)`` of them (the
profiler's start-up calls come first).

A metric's reader gives ``instrument = program_spans.instrument``; several
metrics of one cell bind it once.  Against a program without ``trace`` it
does nothing, and :func:`window` returns None.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

#: the calls the program recorded in the last traced run; None where it
#: recorded none (no traced run yet, or a program without ``trace``)
_calls: Optional[list] = None
_depth = 0


@contextlib.contextmanager
def instrument(program, span):
    """Record the program's spans for the traced run, labelled by the
    harness's ``span``; nests, and binds once."""
    global _calls, _depth
    if _depth:
        yield
        return
    _calls = None
    trace = getattr(program, "trace", None)
    if trace is None or not hasattr(trace, "recording"):
        yield
        return
    _depth += 1
    trace.take()  # calls recorded before this run
    try:
        with trace.recording(label=span):
            yield
    finally:
        _depth -= 1
        _calls = trace.take()


def window(run) -> Optional[List]:
    """The program's records of the window's calls, oldest first, or None
    where the program recorded none."""
    if not _calls or len(_calls) < len(run.calls):
        return None
    return _calls[-len(run.calls):]


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None
