"""``affine_leaf_trace_ms.align``: mean milliseconds an affine global
alignment spends walking its leaves' Gotoh tables after they are filled
and making its strings (the program's counter ``leaf_trace_ns``: the
walker's wall-clock time in a leaf past its fill, summed over the leaves),
over the window's calls.  None where the program does not count it."""

from benchmark import program_spans

instrument = program_spans.instrument


def read(run):
    calls = program_spans.window(run)
    if calls is None or not all("leaf_trace_ns" in c.counters for c in calls):
        return None
    return program_spans.mean(c.counters["leaf_trace_ns"] / 1e6 for c in calls)
