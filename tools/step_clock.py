"""Time the parts of a step of K6's tiled strip body with ``clock64()``
stamps, in a build of its own: the program's sources are copied, the stamps
put into the copy's ``tile_strip`` at lines it already has, and the copy
built with ``nvcc`` beside the program's library.  The program never
carries a stamp.

    python3 tools/step_clock.py [--runs 3] [--geometry k,threads[,blocks]]

From the repo root on a machine with a card and ``nvcc``.  One thread a
block (thread 33, or 1 in a block of one warp: no hand-off lane, not the
fetching thread 0) sums the cycles of each part over its live steps:

- ``shuffle``: the W (2W affine) shuffles of the hand-off;
- ``fetch``: warp 0's chunk of the input row, lane 0's shared hand-off,
  thread 0's top row;
- ``tile``: the K x W cells;
- ``row out``: the last thread's ring writes (0 for the stamping thread);
- ``codes``: the next tile's text codes and lane 31's shared hand-off;
- ``barrier``: the wait at the step's ``__syncthreads()``, the block's
  slowest warp included.

It runs K6 under SW (2, -1, -2) at the 64gb shape (126,440 x 127,240,
seed 64) and at 20,000 x 20,000, the planner's geometry unless
``--geometry``, prints cycles a part a step and the step's wall time
(the launch's CUDA-event time over ``band.tile_steps``), and holds the
stamped build's score to the program's.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import ab_band_fill  # noqa: E402
from tpualign_torch import _build  # noqa: E402
from tpualign_torch.config import AlignMode, ScoringConfig  # noqa: E402
from tpualign_torch.ops import band  # noqa: E402

SW = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
PARTS = ("shuffle", "fetch", "tile", "row out", "codes", "barrier")

#: (line of tile_strip the stamp goes before, the stamp)
STAMPS = [
    ("  const int steps = tiles + t_live - 1;\n",
     "  long long clk_sum[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  const int clk_r = T > 32 ? 33 : 1;\n"),
    ("    // thread r-1's bottom row of tile t - r, computed at step t - 1\n",
     "    long long clk[7];\n    clk[0] = clock64();\n"),
    ("    const int b = t - r;\n    const bool active = b >= 0 && b < tiles && r < t_live;\n",
     "    clk[1] = clock64();\n"),
    ("    if (active) {\n      const int j0 = b * W;\n", "    clk[2] = clock64();\n"),
    ("      if (r == T - 1 && l.out_h != nullptr) {  // the next strip's input row\n",
     "      clk[3] = clock64();\n"),
    ("    // the next tile's codes, a step ahead\n", "    clk[4] = clock64();\n"),
    ("    __syncthreads();\n  }\n  if (LOCAL) {\n",
     "    clk[5] = clock64();\n    __syncthreads();\n    clk[6] = clock64();\n"
     "    if (active && r == clk_r) {\n"
     "      clk_sum[0] += clk[1] - clk[0];\n      clk_sum[1] += clk[2] - clk[1];\n"
     "      clk_sum[2] += clk[3] - clk[2];\n      clk_sum[3] += clk[4] - clk[3];\n"
     "      clk_sum[4] += clk[5] - clk[4];\n      clk_sum[5] += clk[6] - clk[5];\n"
     "      clk_sum[6] += 1;\n    }\n  }\n"
     "  if (r == clk_r) {\n    for (int x = 0; x < 7; ++x) {\n"
     "      atomicAdd(reinterpret_cast<unsigned long long*>(&g_clk[x]),\n"
     "                static_cast<unsigned long long>(clk_sum[x]));\n    }\n  }\n"
     "  if (LOCAL) {\n"),
]

READER = r"""
extern "C" int step_clock_read(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk)));
}
extern "C" int step_clock_zero() {
  static const long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_clk, zero, sizeof(zero)));
}
"""


def stamped(out: str) -> str:
    """The stamped copy of ``band_fill.cu`` and its header in ``out``;
    returns the source's path."""
    with open(os.path.join(_build.CSRC, "band_fill.cuh")) as f:
        head = f.read()
    body = head[head.index("void tile_strip("):]
    start = len(head) - len(body)
    for line, stamp in STAMPS:
        at = body.find(line)
        if at < 0:
            raise RuntimeError(f"tile_strip has no line {line!r}: the stamps need updating")
        if stamp.startswith("    clk[5]"):
            body = body[:at] + stamp + body[at + len(line):]
        else:
            body = body[:at] + stamp + body[at:]
    head = head[:start] + body
    head = head.replace("namespace {\n", "namespace {\n__device__ long long g_clk[7];\n", 1)
    with open(os.path.join(out, "band_fill.cuh"), "w") as f:
        f.write(head)
    with open(os.path.join(_build.CSRC, "band_fill.cu")) as f:
        src = f.read()
    path = os.path.join(out, "band_fill.cu")
    with open(path, "w") as f:
        f.write(src + READER)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--geometry", help="k,threads[,blocks]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {smi.strip()}")
    tmp = tempfile.mkdtemp()
    try:
        src = stamped(tmp)
        lib = os.path.join(tmp, "stamped.so")
        proc = ab_band_fill.build("stamped", src, tmp)
        log = proc.communicate()[0]
        if proc.returncode:
            print(log)
            raise RuntimeError("nvcc failed on the stamped build")
        for name, regs, spill in ab_band_fill.ptxas(log, "band_fill_kernelILi8ELb0ELb0ELb1E"):
            print(f"[ptxas stamped] {name}: {regs} registers, {spill} bytes spilled")
        forced = tuple(int(x) for x in args.geometry.split(",")) if args.geometry else None
        dll = ab_band_fill.bind(lib, True, tile=True, geometry=forced)
        dll.step_clock_read.argtypes = [ctypes.c_void_p]
        g = np.random.default_rng(64)
        shapes = [("64gb", g.integers(1, 5, 126440), g.integers(1, 5, 127240)),
                  ("20k", g.integers(1, 5, 20000), g.integers(1, 5, 20000))]
        for tag, a, b in shapes:
            s1 = torch.from_numpy(a.astype(np.int8)).cuda()
            s2 = torch.from_numpy(b.astype(np.int8)).cuda()
            p = band.plan(s1.numel(), s2.numel(), SW)
            text, query = (s2, s1) if p.swapped else (s1, s2)
            n, m = query.numel(), text.numel()
            run = ab_band_fill.score_call(dll, text, query, p.cfg, p.ends)
            ms, runs, out = ab_band_fill.time_ms(run, args.runs)
            want = int(band.band_fill(text, query, p.cfg, p.ends, forced))
            if int(out.cpu()[0]) != want:
                print(f"[differs] {tag}: the stamped build's score {int(out[0])} != {want}")
                return 1
            geometry = forced or band.tile_geometry(n, m, band.max_k(p.cfg))
            plan = band.pipeline_plan(n, m, False, geometry)
            steps = band.tile_steps(n, m, plan.k, plan.threads, plan.blocks)
            dll.step_clock_zero()
            run()
            torch.cuda.synchronize()
            sums = np.zeros(7, np.int64)
            dll.step_clock_read(sums.ctypes.data)
            per = sums[:6] / max(int(sums[6]), 1)
            parts = ", ".join(f"{name} {c:.1f}" for name, c in zip(PARTS, per))
            print(f"[step clock] {smi.strip()}: K6 SW {tag} {n} x {m}, k = {plan.k}, "
                  f"{plan.threads} threads, {plan.blocks} blocks, a tile of {plan.k} x "
                  f"{band.TILE_W[plan.k]}; stamped launch {ms:.3f} ms over {steps} steps "
                  f"({ms * 1e6 / steps:.1f} ns a step); cycles a step: {parts}; "
                  f"total {per.sum():.1f} ({int(sums[6])} steps stamped)")
    finally:
        shutil.rmtree(tmp, True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
