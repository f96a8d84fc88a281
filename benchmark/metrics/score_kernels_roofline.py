"""``score_kernels_roofline``: the share of the roofline that the kernels of
a score's calls reach, in %.  The least time of the work of every call the
window completed (``benchmark/roofline.py``: from the pairs' shapes and the
scheme, never from a launch's geometry) over the summed device time of every
kernel the traced window ran (``torch.profiler``).  It reads the same work
whatever kernel does it."""

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
