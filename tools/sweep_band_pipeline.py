"""Sweep the pipelined band fills' geometry on one card, after holding the
pipeline against its plain version where races would show.

    python3 tools/sweep_band_pipeline.py [--runs 3] [--no-full] [--steps]

From the repo root on a machine with a card and ``nvcc``.  Builds the
port's kernels, prints ptxas's registers and spills for the band kernels,
then:

- holds the pipeline where races would show (``chip_smoke.py``'s phase
  (a3), ``pipeline_phase``: one block, blocks past the strips, fewer
  blocks than strips over a ring of 2 rows, a partial last strip, a table
  whose cells all tie), each launch ``--repeat`` times word for word
  against one plain run;
- times K6 (``band_fill``) under SW (2, -1, -2) at 20,000 x 20,000 and
  at the 64gb shape (126,440 x 127,240 bases, seed 64) over a grid of
  ``(k, threads, blocks)``, K7's SW locate and K7's affine root forward
  fill (2, -1, open -5, extend -2; 63,620 x 126,440) at a few, every
  result equal to the first geometry's: CUDA-event medians of ``--runs``
  after one warm-up.

With ``--steps`` it only times K6 on one strip alone (``n = k * threads``
rows, 127,240 columns, one block) under SW and affine NW at a grid of
``(k, threads)``, and prints the time of a step (the fill's time over its
``band.tile_steps``, ``ceil(m / W) + threads`` for a tile of W columns):
the tiled strip body without the pipeline's hand-off, the readings that
``band.TILE_STEP_NS`` and ``TILE_CELL_NS`` are fitted to.

Prints one JSON line of every time at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tpualign_torch import _build  # noqa: E402
from tpualign_torch.config import AlignMode, ScoringConfig  # noqa: E402
from tpualign_torch.ops import band  # noqa: E402

SW = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
AFF = ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2)
#: K6 SW's grid at the 64gb shape: (k, threads) with the planner's blocks,
#: and a few block counts below the strips
GRID_64GB = [(k, t) for k in (4, 8, 16) for t in (32, 64, 128, 256)] + [
    (2, 128), (16, 64, 66), (8, 64, 132)]
GRID_20K = [(k, t) for k in (1, 2, 4, 8, 16) for t in (32, 64, 128, 256)]
#: --steps: one strip at each (k, threads)
GRID_STEPS = [(k, t) for k in (1, 4, 8, 16) for t in (32, 64, 128, 256)]
GRID_K7 = [(16, 64), (8, 64), (8, 96), (8, 128), (4, 64), (4, 128)]


def cuda_ms(fn, runs):
    """Median CUDA-event ms of ``runs`` calls after one warm-up, and the
    last result."""
    out, times = fn(), []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def flat(res):
    """A fill's result as one host tensor."""
    if isinstance(res, torch.Tensor):
        return res.reshape(-1).cpu()
    return torch.cat([t.reshape(-1).cpu() for t in res if t is not None])


def hold_capture(got, want, where):
    """A capture fill's result against ``capture_plain``'s, word for word."""
    if not torch.equal(flat(got), flat(want)):
        raise AssertionError(f"the capture fill differs from capture_plain at {where}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--repeat", type=int, default=20)
    ap.add_argument("--no-full", action="store_true", help="skip the 64gb shape")
    ap.add_argument("--steps", action="store_true", help="time one strip alone, then stop")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}")
    path = _build.library_path()
    with open(path + ".log") as f:
        log = f.read()
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        if "band_" in (name or "") and ("registers" in line or "spill" in line):
            print(f"[ptxas] {name}: {line.strip()}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    if args.steps:
        m = 127240
        text = torch.from_numpy(rng.integers(1, 5, m).astype(np.int8)).to(dev)
        times = {}
        for cfg in (SW, AFF):
            for k, threads in GRID_STEPS:
                query = torch.from_numpy(rng.integers(1, 5, k * threads).astype(np.int8)).to(dev)
                ends = band._ends_flags(cfg, False)
                ms, _ = cuda_ms(lambda: band.band_fill(text, query, cfg, ends, (k, threads, 1)),
                                args.runs)
                ns = ms * 1e6 / band.tile_steps(k * threads, m, k, threads, 1)
                times[f"{'affine' if cfg.is_affine else 'SW'} {k}x{threads}"] = ns
                print(f"[step] {smi}: one strip, {cfg}, k = {k}, {threads} threads, a tile of "
                      f"{k} x {band.TILE_W[k]}: {ms:.3f} ms, {ns:.1f} ns a step")
        print(json.dumps({"card": smi, "ns_a_step": times}))
        return 0
    chip_smoke.PIPE_REPEAT = args.repeat
    chip_smoke.pipeline_phase(argparse.Namespace(dev=dev, rng=rng), hold_capture)

    times = {}

    def sweep(tag, make, grid, runs):
        first = None
        for geometry in grid:
            ms, out = cuda_ms(lambda: make(geometry), runs)
            out = flat(out)
            if first is not None and not torch.equal(out, first):
                raise AssertionError(f"{tag}: {geometry} differs from {grid[0]}")
            first = out if first is None else first
            times.setdefault(tag, {})[str(geometry)] = ms
            print(f"[time] {smi}: {tag} {geometry}: median of {runs} {ms:.3f} ms")

    a = torch.from_numpy(rng.integers(1, 5, 20000).astype(np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(1, 5, 20000).astype(np.int8)).to(dev)
    ends = band._ends_flags(SW, False)
    sweep("K6 SW 20k", lambda g: band.band_fill(a, b, SW, ends, g), GRID_20K, args.runs)
    sweep("K7 SW locate 20k", lambda g: band.capture_fill(a, b, SW, cell=True, geometry=g),
          [(4, 32), (4, 64), (2, 64), (8, 64)], args.runs)
    if not args.no_full:
        g64 = np.random.default_rng(64)
        s1 = torch.from_numpy(g64.integers(1, 5, 126440).astype(np.int8)).to(dev)
        s2 = torch.from_numpy(g64.integers(1, 5, 127240).astype(np.int8)).to(dev)
        p = band.plan(s1.numel(), s2.numel(), SW)
        text, query = (s2, s1) if p.swapped else (s1, s2)
        sweep("K6 SW 64gb", lambda g: band.band_fill(text, query, p.cfg, p.ends, g),
              GRID_64GB, args.runs)
        sweep("K6 SW 64gb one block", lambda g: band.band_fill(text, query, p.cfg, p.ends, g),
              [(16, 256, 1)], 1)
        sweep("K7 SW locate 64gb", lambda g: band.capture_fill(s1, s2, SW, cell=True,
                                                               geometry=g), GRID_K7, args.runs)
        qh = s2[: s2.numel() // 2]
        sweep("K7 affine root 64gb", lambda g: band.capture_fill(s1, qh, AFF, geometry=g),
              GRID_K7, args.runs)
        aff_sw = AFF.with_mode(AlignMode.LOCAL)
        sweep("K7 affine local locate 64gb",
              lambda g: band.capture_fill(s1, s2, aff_sw, cell=True, geometry=g),
              [(8, 64), (4, 64), (4, 128)], 1)
    print(json.dumps({"card": smi, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
