"""A/B of versions of ``tpualign_torch/csrc/bitpal_gfill.cu`` on one card,
in one process: each version builds alone into a library of its own (the
port's flags, the headers it includes from the source's directory), and the
script prints each version's ``[ptxas]`` registers and spills per
instantiation, then times the same fills of every version in the order
A B .. B A, CUDA events, median of ``--runs`` after a warm-up:

- K1, ``bitpal_gfill`` at g = 1, K2 at g = 2 and K4's captures,
  ``bitpal_capture_fill`` at g = 1 with the k-way root's 198 rows
  (``hirschberg._kway_rows``), at the 64gb shape (127,240 query rows,
  126,440 text columns, codes 1..4 from a seed) unless ``--no-full``;
- K1 at 20,000 x 20,000 and ``bitpal_gfill`` at g = 2 on a 100,000-row
  query against a text of 2,000,000 columns (the one-launch fill beside
  K4's state chunks) unless ``--no-full``.

Every version's planes and captures must equal the first version's, word
for word, or the script exits 1.  A version whose source takes ``int
blocks, void* ring`` is a pipelined one (``bitpal.pipeline_plan``'s plan,
its ring and flags, allocated each launch as the wrapper does); an older
one the one-block kernel's (``bitpal.kernel_geometry``).  With ``--sweep
LABEL`` that (pipelined) version also runs each shape over ``SWEEP``'s
block counts (``[sweep]`` lines).  The builds, the ``[ptxas]`` report and
the timer are ``tools/ab_band_fill.py``'s.

Usage, from the repo root on a machine with a card and ``nvcc`` (the
parent's source under ``_checkout/``, which is git-ignored but copied to
the card):

    python3 tools/ab_bitpal_gfill.py \\
        parent=_checkout/parent/bitpal_gfill.cu \\
        change=tpualign_torch/csrc/bitpal_gfill.cu [--sweep change]
"""

from __future__ import annotations

import argparse
import atexit
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ab_band_fill import build, ptxas, time_ms  # noqa: E402
from tpualign_torch.ops import band, bitpal, hirschberg  # noqa: E402

#: (name, query rows, text columns, g, captured rows or None)
FULL = [
    ("K1", 127240, 126440, 1, None),
    ("K2", 127240, 126440, 2, None),
    ("K4 captures", 127240, 126440, 1, "root"),
]
MORE = [
    ("K1 20k", 20000, 20000, 1, None),
    ("K2 2M x 100k", 100000, 2000000, 2, None),
]
SMALL = [
    ("K1 small", 5000, 3000, 1, None),
    ("K4 small", 5000, 3000, 3, "root"),
]
#: blocks (None: the planner's, a band a block)
SWEEP = [None, 128, 32, 16]


class Version:
    """One built version and its launcher."""

    def __init__(self, label, src, lib):
        with open(src) as f:
            self.pipelined = "int blocks, void* ring" in f.read()
        self.label = label
        self.dll = ctypes.CDLL(lib)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        if self.pipelined:
            head = [vp, vp, i64, i32, i32, i32, vp, i32, vp]
            self.dll.bitpal_gfill.argtypes = head + [vp, vp]
            self.dll.bitpal_capture_fill.argtypes = head + [vp, i32, vp, vp, vp]
        else:
            self.dll.bitpal_gfill.argtypes = [vp, vp, i64, i32, i32, i32, i32, vp, vp]
            self.dll.bitpal_capture_fill.argtypes = [vp, vp, i64, i32, i32, i32, i32, vp, i32,
                                                     vp, vp, vp]

    def fill(self, t, eq, g, rows, blocks=None):
        """One launch, its outputs allocated as the port's wrapper does:
        ``(planes, caps)``."""
        nw, mt = eq.shape[1], t.shape[0]
        dev = t.device
        planes = torch.empty((bitpal.n_planes(g), nw), dtype=torch.int64, device=dev)
        caps = None if rows is None else torch.empty((rows.numel(), mt), dtype=torch.int8,
                                                     device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        tail = ((planes.data_ptr(), stream) if rows is None else
                (rows.data_ptr(), rows.numel(), caps.data_ptr(), planes.data_ptr(), stream))
        entry = self.dll.bitpal_gfill if rows is None else self.dll.bitpal_capture_fill
        if self.pipelined:
            plan = bitpal.pipeline_plan(nw, mt, blocks, band.ring_budget())
            ring = (torch.empty((plan.depth, mt), dtype=torch.uint8, device=dev)
                    if plan.depth else None)
            sync = torch.zeros(plan.bands + 1, dtype=torch.int32, device=dev)
            err = entry(t.data_ptr(), eq.data_ptr(), mt, nw, g, plan.blocks,
                        None if ring is None else ring.data_ptr(), plan.depth, sync.data_ptr(),
                        *tail)
        else:
            k, threads = bitpal.kernel_geometry(nw)
            err = entry(t.data_ptr(), eq.data_ptr(), mt, nw, g, k, threads, *tail)
        if err:
            raise RuntimeError(f"{self.label}: launch failed with CUDA error {err}")
        return planes, caps


def same(a, b):
    return torch.equal(a[0], b[0]) and (a[1] is None or torch.equal(a[1], b[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", help="label=path/to/bitpal_gfill.cu")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--sweep", default=None, metavar="LABEL",
                    help="sweep the blocks of this (pipelined) version")
    ap.add_argument("--no-full", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_bitpal_gfill: needs a CUDA device")
    tmp = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, tmp, True)
    versions = [v.split("=", 1) for v in args.versions]
    procs = [(label, src, build(label, src, tmp)) for label, src in versions]
    built = []
    for label, src, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            print(log)
            raise RuntimeError(f"nvcc failed for {label}")
        for name, regs, spill in ptxas(log):
            print(f"[ptxas {label}] {name}: {regs} registers, {spill} bytes spill stores")
        built.append(Version(label, src, os.path.join(tmp, f"{label}.so")))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rng = np.random.default_rng(64)
    ok = True
    cases = SMALL + ([] if args.no_full else FULL + MORE)
    for name, nq, mt, g, rows in cases:
        q = torch.from_numpy(rng.integers(1, 5, nq).astype(np.int8)).cuda()
        t = torch.from_numpy(rng.integers(1, 5, mt).astype(np.int8)).cuda()
        eq = bitpal._eq_planes(q, nq)
        rows_t = (None if rows is None else
                  torch.tensor(hirschberg._kway_rows(nq), dtype=torch.int32, device="cuda"))
        order = list(range(len(built))) + list(reversed(range(len(built))))
        ms = {v.label: [] for v in built}
        outs = {}
        for i in order:
            v = built[i]
            got_ms, _, outs[v.label] = time_ms(lambda: v.fill(t, eq, g, rows_t), args.runs)
            ms[v.label].append(got_ms)
        first = outs[built[0].label]
        equal = all(same(outs[v.label], first) for v in built[1:])
        if nq * mt <= 5000 * 3000:  # and the plain version, where it is quick
            want = bitpal.fill_g_plain(t, eq, nq, g, None if rows_t is None else rows_t.tolist())
            equal = equal and same((torch.stack(want[0]), None if rows is None else want[1]),
                                   first)
        ok = ok and equal
        plan = bitpal.pipeline_plan(eq.shape[1], mt, None, band.ring_budget())
        print(f"[ab {name}] {nq} x {mt}, g = {g}" + ("" if rows is None else
              f", {rows_t.numel()} rows") + f"; planner {tuple(plan)}: " + "; ".join(
              f"{label} {', '.join(f'{x:.3f}' for x in v)} ms" for label, v in ms.items())
              + f"; outputs equal {equal}")
        for v in built:
            if v.label != args.sweep or not v.pipelined:
                continue
            for blocks in SWEEP:
                p = bitpal.pipeline_plan(eq.shape[1], mt, blocks, band.ring_budget())
                got_ms, _, out = time_ms(lambda: v.fill(t, eq, g, rows_t, blocks), args.runs)
                equal = same(out, first)
                ok = ok and equal
                print(f"[sweep {v.label} {name}] {p.blocks} blocks ({p.bands} bands, ring "
                      f"{p.depth}): {got_ms:.3f} ms; equal {equal}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
