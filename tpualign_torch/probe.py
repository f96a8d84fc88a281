"""The card and the pipelined fill's per-step cost, on one CUDA device.

    python -m tpualign_torch.probe

Prints, each part on lines of its own:

1. the card: name, power limit, and the SM clock and power draw read while
   the kernel runs at the 64gb shape (126,440 x 127,240, random codes);
2. the kernel's per-step cost against its geometry: ``bitpal_gfill`` at
   g = 1 (K1's port) at ``mt = 20,000`` for queries of 1 to 16,384 words
   (1 to 1,024 threads, 1 to 16 words per thread), CUDA events, median of
   3 after a warm-up.

Where a call's time goes, host work and device work on one timeline, is
the benchmark's traced run (``python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace 1``), which reads the spans of
:mod:`tpualign_torch.trace`.

:func:`serve_pairs` and :func:`read_pairs` are the two batches that
``chip_smoke.py`` drives ``align_score_batch`` with.

Nothing is compared here: ``chip_smoke.py`` checks the kernel.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .ops import bitpal

PAIR_LENGTHS = (126440, 127240)  # bdna/64gb-{1,2}.bdna
#: the short-read mix: a read mapper's candidate checks, each a read of
#: READ_LEN bases against a reference window of WINDOW bases that holds it
READS, READ_LEN, WINDOW = 8192, 150, (150, 350)
READ_SUBSTITUTIONS = 0.05
SWEEP_TEXT = 20000
SWEEP_ROWS = (64, 2048, 8192, 16384, 32768, 49152, 65536, 127240, 131072,
              262144, 524288, 1048576)


def serve_pairs():
    """``examples/serve_batch.py``'s batch, drawn as it draws it: 16 pairs,
    each length uniform in 5,000..24,999 from ``default_rng(0)``, codes
    1..4 from ``default_rng(i)`` as ``tpualign.io.bdna.random_pair`` draws
    them.  Returns ``(texts, queries)``."""
    rng = np.random.default_rng(0)
    texts, queries = [], []
    for i in range(16):
        m, n = int(rng.integers(5_000, 25_000)), int(rng.integers(5_000, 25_000))
        pair = np.random.default_rng(i)
        texts.append(pair.integers(1, 5, size=m, dtype=np.int8))
        queries.append(pair.integers(1, 5, size=n, dtype=np.int8))
    return texts, queries


def read_pairs(count: int = READS, seed: int = 0):
    """A read mapper's candidate checks: ``count`` reads of ``READ_LEN``
    bases (the queries), each cut from a random reference window of
    ``WINDOW`` bases (the texts) at a random offset, with
    ``READ_SUBSTITUTIONS`` of its bases changed to another base; codes
    1..4.  Returns ``(texts, queries)``, views of two arrays."""
    rng = np.random.default_rng(seed)
    lo, hi = WINDOW
    lengths = rng.integers(lo, hi + 1, count)
    windows = rng.integers(1, 5, (count, hi), dtype=np.int8)
    starts = (rng.random(count) * (lengths - READ_LEN + 1)).astype(np.int64)
    reads = np.take_along_axis(windows, starts[:, None] + np.arange(READ_LEN), axis=1)
    changed = rng.random((count, READ_LEN)) < READ_SUBSTITUTIONS
    other = (reads - 1 + rng.integers(1, 4, (count, READ_LEN), dtype=np.int8)) % 4 + 1
    reads = np.where(changed, other, reads).astype(np.int8)
    return [w[:k] for w, k in zip(windows, lengths)], list(reads)


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _planes(nq: int, mt: int, seed: int):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(1, 5, nq, dtype=np.int8)).cuda()
    t = torch.from_numpy(rng.integers(1, 5, mt, dtype=np.int8)).cuda()
    return t, bitpal._eq_planes(q, nq)


def _kernel_ms(t, eq, nq: int, runs: int = 3) -> float:
    times = []
    for i in range(runs + 1):  # one warm-up
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        bitpal.fill_g(t, eq, nq, 1)
        e1.record()
        e1.synchronize()
        if i:
            times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe: torch.cuda.is_available() is false; this needs a CUDA device")
    print(_smi("name,power.limit"))
    bitpal.fill_g(*_planes(64, 1, 0), 64, 1)  # build and load the kernel

    m, n = PAIR_LENGTHS
    rng = np.random.default_rng(64)
    s1, s2 = (rng.integers(1, 5, size=k, dtype=np.int8) for k in PAIR_LENGTHS)
    query, text = (s1, s2) if bitpal._orientation(m, n) else (s2, s1)
    nq = query.size
    q, t = torch.from_numpy(query).cuda(), torch.from_numpy(text).cuda()

    # 1: clock and draw while 25 fills (about 3 s) are queued on the card
    eq = bitpal._eq_planes(q, nq)
    for _ in range(25):
        bitpal.fill_g(t, eq, nq, 1)
    time.sleep(1.0)
    print(f"[under load] sm clock, power draw: {_smi('clocks.sm,power.draw')}")
    torch.cuda.synchronize()

    # 2: the sweep
    for nq_s in SWEEP_ROWS:
        nw = -(-nq_s // bitpal.WORD)
        plan = bitpal.pipeline_plan(nw, SWEEP_TEXT)
        ms = _kernel_ms(*_planes(nq_s, SWEEP_TEXT, nq_s), nq_s)
        steps = SWEEP_TEXT + nw - 1  # the wavefront's path: the last word trails by nw - 1
        step_ns = ms * 1e6 / steps
        print(f"[sweep mt {SWEEP_TEXT}] nq {nq_s:7d} nw {nw:5d} blocks {plan.blocks:3d} "
              f"bands {plan.bands:3d}: {ms:9.3f} ms, {step_ns:8.1f} ns a step of the "
              f"wavefront's {steps}, {nq_s * SWEEP_TEXT / ms / 1e6:7.2f} GCUPS")


if __name__ == "__main__":
    main()
