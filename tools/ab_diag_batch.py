"""A/B of versions of ``tpualign_torch/csrc/diag_fill.cu`` (K8's port) and
``bitpal_batch.cu`` (K5's) on one card, in one process: each version is a
directory holding both sources beside the headers they include, built alone
into a library of its own with the port's flags; the script prints each
version's ``[ptxas]`` registers and spills per instantiation, then times
the same work of every version in the order A B .. B A, CUDA events,
median of ``--runs`` after a warm-up:

- K8, ``diag_fill`` under NW (2, -1, -2) at 20,000 x 20,000 and under SW
  (2, -1, -2) at the 64gb shape (126,440 x 127,240), each beside one
  ``band_fill`` launch (K6, the port's ``band.band_fill``) on the same pair;
- K5, ``bitpal_batch_fill`` on mix (A), the serving demo's 16 pairs, at
  g = 1 and g = 2, and on mix (B), 8,192 reads of 150 bases, at g = 1
  (``tpualign_torch.probe``'s mixes, packed as ``align_score_batch`` packs
  them);

after small cases that every version must match against the plain
versions (``pallas_diag.score_plain``, ``bitpal.batch_fill_plain``).
Every version's result must equal the first version's, word for word, or
the script exits 1.  A source whose entry takes ``int blocks, void* ring``
is a pipelined one (the plans and scratch of ``band.pipeline_plan`` and
``bitpal.batch_plan``, made for each launch as the wrappers make them); an
older one the one-block kernel's (one block of ``n + 1`` threads up to
1,024 for K8, ``bitpal.kernel_geometry``'s block a pair for K5).  With
``--sweep LABEL`` that (pipelined) version also runs each full shape over
other geometries (``[sweep]`` lines; K5's block counts twice in turn);
``--only k8`` or ``--only k5`` runs one kernel's full shapes; ``--launches
N`` traces N launches of each version on K5's mixes (``torch.profiler``'s
device time of each kernel beside each call's CUDA-event time).

Usage, from the repo root on a machine with a card and ``nvcc`` (the
parent's sources under ``_checkout/``, which is git-ignored but copied to
the card):

    python3 tools/ab_diag_batch.py parent=_checkout/parent/tpualign_torch/csrc \\
        change=tpualign_torch/csrc [--sweep change] [--no-full]
"""

from __future__ import annotations

import argparse
import atexit
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

from ab_band_fill import build, ptxas, time_ms  # noqa: E402
from tpualign_torch.config import AlignMode, ScoringConfig  # noqa: E402
from tpualign_torch.ops import band, bitpal, pallas_diag  # noqa: E402
from tpualign_torch.ops import pairs as packing  # noqa: E402
from tpualign_torch.probe import read_pairs, serve_pairs  # noqa: E402

NW = ScoringConfig(match=2, mismatch=-1, gap=-2)
SW = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
PIPELINED = re.compile(r"int blocks,\s*void\* ring")
#: K8's sweep: (k, threads, blocks) beside the planner's
DIAG_SWEEP = [(8, 128, None), (16, 128, None), (4, 128, None), (8, 64, None), (16, 256, None)]


class Version:
    """One built version and its launchers."""

    def __init__(self, label, srcdir, lib):
        self.label = label
        with open(os.path.join(srcdir, "diag_fill.cu")) as f:
            self.diag_pipe = bool(PIPELINED.search(f.read()))
        with open(os.path.join(srcdir, "bitpal_batch.cu")) as f:
            self.batch_pipe = bool(PIPELINED.search(f.read()))
        self.last_plan = None
        self.dll = ctypes.CDLL(lib)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        self.dll.diag_fill.argtypes = (
            [vp, i32, vp, i32] + [i32] * 7 + [vp, i32, vp, vp, vp] if self.diag_pipe
            else [vp, i32, vp, i32] + [i32] * 5 + [vp, vp, vp])
        self.dll.bitpal_batch_fill.argtypes = (
            [vp, i64, vp, vp] + [i32] * 4 + [vp, i32, vp, vp, vp] if self.batch_pipe
            else [vp, i64, vp, vp] + [i32] * 5 + [vp, vp])

    def diag(self, s1, s2, cfg, geometry=None):
        """One ``diag_fill`` launch: the score as a 0-d int32 tensor."""
        m, n = s1.numel(), s2.numel()
        dev = s1.device
        stream = torch.cuda.current_stream().cuda_stream
        head = (s1.data_ptr(), m, s2.data_ptr(), n, cfg.match, cfg.mismatch, cfg.gap,
                int(cfg.is_local))
        if self.diag_pipe:
            out = torch.full((1,), 0 if cfg.is_local else band.NEG, dtype=torch.int32, device=dev)
            plan = band.pipeline_plan(n, m, False, geometry, band.MAX_K, band.ring_budget(dev))
            ring, sync, _ = band._pipe_scratch(plan, m, False, dev, False)
            self.last_plan = plan
            err = self.dll.diag_fill(*head, plan.k, plan.threads, plan.blocks, band._ptr(ring),
                                     plan.depth, sync.data_ptr(), out.data_ptr(), stream)
        else:  # one block of a thread a diagonal element, up to 1,024
            out = torch.empty(1, dtype=torch.int32, device=dev)
            diag = torch.empty((3, n + 1), dtype=torch.int32, device=dev)
            err = self.dll.diag_fill(*head, min(1024, -(-(n + 1) // 32) * 32), diag.data_ptr(),
                                     out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"{self.label}: diag_fill failed with CUDA error {err}")
        return out[0]

    def batch(self, tpad, mt, eq, g, blocks=None):
        """One ``bitpal_batch_fill`` launch: the planes (P, B, nw)."""
        (P, m_cap), nw = tpad.shape, eq.shape[2]
        dev = tpad.device
        planes = torch.empty((P, bitpal.n_planes(g), nw), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        head = (tpad.data_ptr(), m_cap, mt.data_ptr(), eq.data_ptr(), P, nw, g)
        if self.batch_pipe:
            plan = bitpal.batch_plan(P, nw, m_cap, blocks,
                                     band.ring_budget(dev) if nw > bitpal.BAND else None)
            ring = (torch.empty((P, plan.depth, m_cap), dtype=torch.uint8, device=dev)
                    if plan.depth else None)
            sync = (torch.zeros(1 + P * plan.bands, dtype=torch.int32, device=dev)
                    if plan.width == bitpal.BAND else None)
            self.last_plan = plan
            err = self.dll.bitpal_batch_fill(*head, plan.blocks, band._ptr(ring), plan.depth,
                                             band._ptr(sync), planes.data_ptr(), stream)
        else:  # one block a pair
            err = self.dll.bitpal_batch_fill(*head, *bitpal.kernel_geometry(nw),
                                             planes.data_ptr(), stream)
        if err:
            raise RuntimeError(f"{self.label}: bitpal_batch_fill failed with CUDA error {err}")
        return planes


def launch_spread(run, launches):
    """``launches`` calls of ``run``: each call's CUDA-event time (host work
    inside the window included) and each kernel's device time from
    ``torch.profiler``, in ms."""
    from torch.profiler import ProfilerActivity, profile

    calls = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            calls.append(a.elapsed_time(b))
    device = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if "bitpal_batch" in e.name and e.device_type.name == "CUDA"]
    return calls, device


def batch_inputs(texts, queries):
    """A batch's kernel arguments on the card, as ``bitpal.score_batch`` packs
    them."""
    packed = packing.pack_pairs(texts, queries, np.arange(len(texts))).to("cuda")
    tpad, mt, eq, _ = bitpal.batch_inputs(packed)
    return tpad, mt, eq, packed.n_cap


def ragged(rng, P, nw, mt_hi):
    """P pairs, queries of up to nw words (the last nw), texts of 1..mt_hi."""
    nqs = rng.integers(1, nw * bitpal.WORD + 1, P)
    nqs[-1] = nw * bitpal.WORD
    mts = rng.integers(1, mt_hi + 1, P)
    return ([rng.integers(0, 5, int(x)).astype(np.int8) for x in mts],
            [rng.integers(0, 5, int(x)).astype(np.int8) for x in nqs])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", help="label=directory of diag_fill.cu and "
                    "bitpal_batch.cu")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--sweep", default=None, metavar="LABEL",
                    help="sweep the geometry of this (pipelined) version")
    ap.add_argument("--no-full", action="store_true")
    ap.add_argument("--only", choices=("k8", "k5"), default=None,
                    help="the full shapes of one kernel only")
    ap.add_argument("--launches", type=int, default=0,
                    help="also trace this many launches of each version on K5's mixes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_diag_batch: needs a CUDA device")
    tmp = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, tmp, True)
    versions = [v.split("=", 1) for v in args.versions]
    procs = [(label, d, build(label, os.path.join(d, "diag_fill.cu") + "+"
                              + os.path.join(d, "bitpal_batch.cu"), tmp))
             for label, d in versions]
    built = []
    for label, d, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            print(log)
            raise RuntimeError(f"nvcc failed for {label}")
        for name, regs, spill in ptxas(log):
            print(f"[ptxas {label}] {name}: {regs} registers, {spill} bytes spill stores")
        built.append(Version(label, d, os.path.join(tmp, f"{label}.so")))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    rng = np.random.default_rng(14)
    ok = True
    order = list(range(len(built))) + list(reversed(range(len(built))))

    def ab(name, run, equal, runs, beside=""):
        """Run every version in the order A B .. B A; print and return the
        first version's output and whether every output equals it."""
        ms = {v.label: [] for v in built}
        outs = {}
        for i in order:
            v = built[i]
            got_ms, _, outs[v.label] = time_ms(lambda: run(v), runs)
            ms[v.label].append(got_ms)
        first = outs[built[0].label]
        same = all(equal(outs[v.label], first) for v in built[1:])
        plan = next((v.last_plan for v in reversed(built) if v.last_plan is not None), None)
        print(f"[ab {name}] plan {plan and tuple(plan)}: "
              + "; ".join(f"{label} {', '.join(f'{x:.3f}' for x in t)} ms"
                          for label, t in ms.items())
              + f"; outputs equal {same}{beside}")
        return first, same

    # small cases, held against the plain versions too
    for cfg, m, n in ((NW, 3000, 2000), (SW, 3000, 2000), (NW, 700, 700), (SW, 4100, 1)):
        s1 = torch.from_numpy(rng.integers(0, 5, m).astype(np.int8)).cuda()
        s2 = torch.from_numpy(rng.integers(0, 5, n).astype(np.int8)).cuda()
        got, same = ab(f"K8 small {m} x {n} {'SW' if cfg.is_local else 'NW'}",
                       lambda v: v.diag(s1, s2, cfg), torch.equal, 1)
        want = int(pallas_diag.score_plain(s1.cpu(), s2.cpu(), cfg))
        ok = ok and same and int(got) == want
    for nw, g in ((1, 1), (3, 2), (5, 3), (16, 4), (17, 1), (40, 2), (130, 5)):
        texts, queries = ragged(rng, 13, nw, 400)
        tpad, mt, eq, nq = batch_inputs(texts, queries)
        got, same = ab(f"K5 small nw {nw} g {g}", lambda v: v.batch(tpad, mt, eq, g),
                       torch.equal, 1)
        want = bitpal.batch_fill_plain(tpad.cpu(), mt.cpu(), eq.cpu(), nq, g)
        ok = ok and same and torch.equal(got.cpu(), want)
    if args.no_full:
        return 0 if ok else 1

    s1_64, s2_64 = (torch.from_numpy(rng.integers(1, 5, x).astype(np.int8)).cuda()
                    for x in (127240, 126440))
    a20, b20 = (torch.from_numpy(rng.integers(1, 5, 20000).astype(np.int8)).cuda()
                for _ in range(2))
    k8 = (("K8 NW 20k", NW, a20, b20), ("K8 SW 64gb", SW, s1_64, s2_64))
    for name, cfg, s1, s2 in k8 if args.only != "k5" else ():
        ends = band._ends_flags(cfg, False)
        k6_ms, _, k6 = time_ms(lambda: band.band_fill(s1, s2, cfg, ends), args.runs)
        got, same = ab(f"{name} {s2.numel()} x {s1.numel()}", lambda v: v.diag(s1, s2, cfg),
                       torch.equal, args.runs, f"; band_fill (K6) {k6_ms:.3f} ms")
        ok = ok and same and int(got) == int(k6)
        for v in built:
            if v.label != args.sweep or not v.diag_pipe:
                continue
            for geometry in DIAG_SWEEP:
                geometry = geometry if geometry[2] else geometry[:2]
                got_ms, _, out = time_ms(lambda: v.diag(s1, s2, cfg, geometry), args.runs)
                equal = torch.equal(out, got)
                ok = ok and equal
                print(f"[sweep {v.label} {name}] {tuple(v.last_plan)}: {got_ms:.3f} ms; "
                      f"equal {equal}")
    k5 = (("K5 mix A g 1", serve_pairs(), 1), ("K5 mix A g 2", serve_pairs(), 2),
          ("K5 mix B g 1", read_pairs(), 1))
    for name, (texts, queries), g in k5 if args.only != "k8" else ():
        tpad, mt, eq, _ = batch_inputs(texts, queries)
        got, same = ab(name, lambda v: v.batch(tpad, mt, eq, g), torch.equal, args.runs)
        ok = ok and same
        for v in built if args.launches else ():
            calls, device = launch_spread(lambda: v.batch(tpad, mt, eq, g), args.launches)
            print(f"[launches {v.label} {name}] {len(device)} kernels traced: device ms "
                  + ", ".join(f"{x:.3f}" for x in device) + "; call ms "
                  + ", ".join(f"{x:.3f}" for x in calls))
        for v in built:
            if v.label != args.sweep or not v.batch_pipe:
                continue
            plan = bitpal.batch_plan(tpad.shape[0], eq.shape[2], tpad.shape[1])
            grid = {4 * plan.blocks, 2 * plan.blocks, 3 * plan.blocks // 2, plan.blocks + 1,
                    plan.blocks, -(-plan.blocks // 2), -(-plan.blocks // 4)}
            for blocks in sorted(grid, reverse=True) * 2:
                got_ms, _, out = time_ms(lambda: v.batch(tpad, mt, eq, g, blocks), args.runs)
                equal = torch.equal(out, got)
                ok = ok and equal
                print(f"[sweep {v.label} {name}] {tuple(v.last_plan)}: {got_ms:.3f} ms; "
                      f"equal {equal}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
