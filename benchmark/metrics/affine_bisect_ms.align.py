"""``affine_bisect_ms.align``: mean milliseconds an affine global alignment
spends in its Myers-Miller bisection (the program's ``bisect`` span in
``affine_align.align``: the node fills until the last node's crossings are
back, and the hand-over of the leaves to the walker), over the window's
calls.  Host clock."""

from benchmark import program_spans

instrument = program_spans.instrument


def read(run):
    calls = program_spans.window(run)
    return None if calls is None else program_spans.mean(c.ms("bisect") for c in calls)
