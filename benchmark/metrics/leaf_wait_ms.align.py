"""``leaf_wait_ms.align``: mean milliseconds an alignment waits on its leaf
walkers after the bisection (the program's ``leaves.wait`` span in
``hirschberg.tree``): wall time in which the card has nothing queued.
Host clock, over the window's calls."""

from benchmark import program_spans

instrument = program_spans.instrument


def read(run):
    calls = program_spans.window(run)
    return None if calls is None else program_spans.mean(c.ms("leaves.wait") for c in calls)
