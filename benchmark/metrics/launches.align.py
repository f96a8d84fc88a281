"""``launches.align``: mean kernel launches an alignment makes (the sum of
the program's ``launch.<kernel>`` counters moved in a call), over the
window's calls.  0 on the CPU, where the plain versions launch
nothing."""

from benchmark import program_spans

instrument = program_spans.instrument


def read(run):
    calls = program_spans.window(run)
    if calls is None:
        return None
    return program_spans.mean(sum(n for k, n in c.counters.items() if k.startswith("launch."))
                              for c in calls)
