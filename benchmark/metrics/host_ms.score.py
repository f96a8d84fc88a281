"""``host_ms.score``: mean milliseconds of a score call that the card does
not work through: the root span's (``align_score``) duration less its
``read_back`` spans', where the host waits on the card.  Host clock, over
the window's calls."""

from benchmark import program_spans

instrument = program_spans.instrument


def read(run):
    calls = program_spans.window(run)
    if calls is None:
        return None
    return program_spans.mean((c.root.t1 - c.root.t0) / 1e6 - c.ms("read_back") for c in calls)
