"""``affine_leaf_fill_ms.align``: mean milliseconds an affine global
alignment spends filling its leaves' Gotoh tables (the program's counter
``leaf_fill_ns``: the walker's wall-clock time in a leaf's table fill,
summed over the leaves, so a wait for a core or for the interpreter lock is
in it), over the window's calls.  None where the program does not count
it."""

from benchmark import program_spans

instrument = program_spans.instrument


def read(run):
    calls = program_spans.window(run)
    if calls is None or not all("leaf_fill_ns" in c.counters for c in calls):
        return None
    return program_spans.mean(c.counters["leaf_fill_ns"] / 1e6 for c in calls)
