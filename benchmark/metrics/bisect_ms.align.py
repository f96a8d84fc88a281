"""``bisect_ms.align``: mean milliseconds an alignment spends in the
bisection of its core (the program's ``stats["core_stats"]["bisect_s"]``,
host clock, from ``hirschberg.tree``: the node fills until the last node's
crossings are back)."""


def read(run):
    times = [c.stats["core_stats"]["bisect_s"] for c in run.calls
             if c.stats and "bisect_s" in c.stats.get("core_stats", {})]
    return 1e3 * sum(times) / len(times) if times else None
