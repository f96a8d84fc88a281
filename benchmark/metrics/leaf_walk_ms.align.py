"""``leaf_walk_ms.align``: mean milliseconds of leaf walks an alignment
runs (the program's ``stats["core_stats"]["leaf_walk_s"]``, host clock,
summed over the walker threads, so CPU seconds rather than wall)."""


def read(run):
    times = [c.stats["core_stats"]["leaf_walk_s"] for c in run.calls
             if c.stats and "leaf_walk_s" in c.stats.get("core_stats", {})]
    return 1e3 * sum(times) / len(times) if times else None
