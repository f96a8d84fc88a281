"""``locate_ms.align``: mean milliseconds an alignment spends locating its
end and its anchored start (the program's ``stats["locate_s"] +
stats["start_s"]``, host clock, from ``band_align.align_local``)."""


def read(run):
    times = [c.stats["locate_s"] + c.stats.get("start_s", 0.0) for c in run.calls
             if c.stats and "locate_s" in c.stats]
    return 1e3 * sum(times) / len(times) if times else None
