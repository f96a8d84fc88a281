"""``call_p95_ms``: the 95th percentile of the host-clock latency of every
call of the window, from the call to its result on the host."""

import numpy as np


def read(run):
    return float(np.percentile([c.seconds for c in run.calls], 95)) * 1e3
