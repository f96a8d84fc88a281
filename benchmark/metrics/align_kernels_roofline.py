"""``align_kernels_roofline``: the share of the roofline that the kernels of
an alignment's calls reach, in %.  The least time of a call is one fill of
its whole table (``roofline.call_bound``: 9 operations a cell under affine
gaps, from the pair's shape and the scheme, never from a launch's
geometry), the least any exact method must do; summed over every call the
window completed, it is divided by the summed device time of every kernel
the traced window ran (``torch.profiler``).  It reads the same work
whatever implements it: the bisection's second fills of each level count
as time, not as work."""

from benchmark import roofline


def read(run):
    if run.trace is None or run.trace.kernel_s <= 0:
        return None
    least = 0.0
    for c in run.calls:
        if c.answer is not None:
            inp = run.pool[c.index]
            least += roofline.call_bound(run.workload.config,
                                         [(t.size, q.size) for t, q in zip(inp.texts, inp.queries)])
    return 100.0 * least / run.trace.kernel_s
