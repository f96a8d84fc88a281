"""A/B of the port's leaf walk on a CUDA card: the C++ walk against the NumPy
walk, inside one call.

    python3 tools/ab_leaf_walk.py [--runs 2]

On the 64gb-shape pair (126,440 x 127,240, seed 64, as ``chip_smoke.py``),
``tpualign_torch.align`` at (1, 0, -1) and under SW (2, -1, -2): the
leaves walked in C++ on ``hirschberg.NATIVE_LEAF_WORKERS`` threads
(``native``), and with ``utils.native.walks`` and ``utils.native.traceback``
patched so that the NumPy walk takes them on ``hirschberg.LEAF_WORKERS``
threads (``numpy``, the parent's path), in the order numpy, native, native,
numpy, ``--runs`` times: the call's wall, ``leaf_walk_s`` (summed over the
threads), ``bisect_s`` and the leaves, every run's strings equal to the
first's.  Then the C++ walk's threads swept at (1, 0, -1).  Host clock;
the card's name and power limit on every line.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tpualign_torch  # noqa: E402
from tpualign_torch.config import AlignMode, ScoringConfig  # noqa: E402
from tpualign_torch.ops import hirschberg, oracle  # noqa: E402
from tpualign_torch.utils import native  # noqa: E402

PAIR_LENGTHS = (126440, 127240)
PAIR_SEED = 64


def drive(s1, s2, cfg, walk):
    """``(wall s, the tree's stats, result)`` of one ``align`` with the
    leaves walked by ``walk`` (``"native"`` or ``"numpy"``)."""
    walks, traceback = native.walks, native.traceback
    if walk == "numpy":
        native.walks = lambda c: False
        native.traceback = oracle.traceback  # the SW window's walk
    try:
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tpualign_torch.align(s1, s2, cfg, stats=stats)
        wall = time.perf_counter() - t0
    finally:
        native.walks, native.traceback = walks, traceback
    tree = stats.get("core_stats", stats)
    if tree["leaf_walk"] != walk:
        raise AssertionError(f"asked for the {walk} walk, the tree took {tree['leaf_walk']}")
    return wall, tree, out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_leaf_walk: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    rng = np.random.default_rng(PAIR_SEED)
    s1, s2 = (rng.integers(1, 5, size=n, dtype=np.int8) for n in PAIR_LENGTHS)
    t0 = time.perf_counter()
    tpualign_torch.align(s1[:5000], s2[:5000])  # builds the kernels and the C++
    print(f"[warm-up] {time.perf_counter() - t0:.1f} s")
    cfgs = {"(1, 0, -1)": ScoringConfig(),
            "SW (2, -1, -2)": ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)}
    for name, cfg in cfgs.items():
        first = None
        for walk in ["numpy", "native", "native", "numpy"] * args.runs:
            wall, tree, out = drive(s1, s2, cfg, walk)
            first = first or out
            if out != first:
                raise AssertionError(f"{name}: the {walk} walk's strings differ")
            print(f"[{walk}] {smi}: align {name} at {PAIR_LENGTHS[0]} x {PAIR_LENGTHS[1]}: "
                  f"wall {wall:.3f} s, leaf_walk_s {tree['leaf_walk_s']:.3f} s over "
                  f"{tree['leaves']} leaves ({tree['leaf_cells']} cells), bisect_s "
                  f"{tree['bisect_s']:.3f} s, score {out[0]}")
    workers = hirschberg.NATIVE_LEAF_WORKERS
    try:
        for n in (1, 2, 4, 8, 16):
            hirschberg.NATIVE_LEAF_WORKERS = n
            wall, tree, _ = drive(s1, s2, cfgs["(1, 0, -1)"], "native")
            print(f"[threads {n}] {smi}: align (1, 0, -1): wall {wall:.3f} s, leaf_walk_s "
                  f"{tree['leaf_walk_s']:.3f} s, bisect_s {tree['bisect_s']:.3f} s")
    finally:
        hirschberg.NATIVE_LEAF_WORKERS = workers
    print(f"[host] {os.cpu_count()} CPUs")


if __name__ == "__main__":
    main()
