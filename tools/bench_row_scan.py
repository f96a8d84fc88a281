"""Time the pieces of the port's PyTorch row scan on a CUDA card.

    python3 tools/bench_row_scan.py

Prints, at 20,001 and 126,441 columns (a 20k pair's and the 64gb pair's
rows), the microseconds of one ``torch.cummax`` of the row and of the
blocked scan ``tpualign_torch.ops.xla`` uses on CUDA, at several block
widths (checked equal to ``torch.cummax``), then the microseconds a row
of ``xla.rows_scan`` over 2,000 rows of 126,440 columns, plain and with
each option the checkpointed tracebacks use.  Host-clock times over
repeated calls closed by a synchronize.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpualign_torch.config import ScoringConfig  # noqa: E402
from tpualign_torch.ops import xla  # noqa: E402


def per_call_us(fn, iters=500):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("bench_row_scan: needs a CUDA device")
    dev = torch.device("cuda")
    for m in (20001, 126441):
        x = torch.randint(-1000, 1000, (m,), dtype=torch.int64, device=dev)
        ref = torch.cummax(x, 0).values
        print(f"[{m} columns] torch.cummax {per_call_us(lambda: torch.cummax(x, 0).values):.1f} us")
        for width in (128, 256, 512, 1024, 2048):
            rows = -(-m // width)
            buf = torch.full((rows * width,), xla.NEG, dtype=torch.int64, device=dev)

            def blocked():
                buf[:m] = x
                v = buf.view(rows, width).cummax(1).values
                carry = v[:, -1].cummax(0).values
                torch.maximum(v[1:], carry[:-1, None], out=v[1:])
                return v.view(-1)[:m]

            if not torch.equal(blocked(), ref):
                raise AssertionError(f"the blocked scan differs at width {width}")
            print(f"[{m} columns] blocked, width {width}: {per_call_us(blocked):.1f} us")
    rng = np.random.default_rng(0)
    m, n = 126440, 2000
    s1 = torch.from_numpy(rng.integers(1, 5, m).astype(np.int8)).to(dev)
    s2 = torch.from_numpy(rng.integers(1, 5, n).astype(np.int8)).to(dev)
    for name, kw in (("plain", {}), ("want_row_max", dict(want_row_max=True)),
                     ("diag_stride 1024", dict(diag_stride=1024)),
                     ("col_stride 2048", dict(col_stride=2048))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xla.rows_scan(s1, s2, ScoringConfig(), zero_row=False, zero_col=False, **kw)
        torch.cuda.synchronize()
        print(f"[rows_scan {name}] {m} columns: "
              f"{(time.perf_counter() - t0) / n * 1e6:.1f} us a row")


if __name__ == "__main__":
    main()
