"""A/B of versions of ``tpualign_torch/csrc/bitpal_rc.cu`` on one card, in
one process: each version builds alone into a library of its own (the
port's flags, the headers it includes from the source's directory), and the
script prints each version's ``[ptxas]`` registers and spills per
instantiation, then times the same fills of every version in the order
A B .. B A, CUDA events, median of ``--runs`` after a warm-up:

- K4's state chunks, ``bitpal_gfill_chunk`` at g = 2 on a 100,000-row
  query against a text of 2,000,000 columns, the route's 3 chunks;
- K3a, ``bitpal_rc_fill`` at rc 4, 10,000 rows against 1,000,000
  columns, and 20,000 x 20,000;
- K3b, ``bitpal_rc_chunk`` at rc 4, 2,000 rows against 4,000,000
  columns, the route's 6 chunks;

each beside one ``bitpal_gfill`` launch on the same query and text (the
port's ``fill_g``), after small shapes that every version must match
against the plain versions (``fill_rc_plain``, ``chunk_plain``).  Every
version's planes (and a chunk route's hand-offs) must equal the first
version's, word for word, or the script exits 1.  A version whose source
takes ``int blocks, void* ring`` is a pipelined one (the plan, ring and
flags of ``bitpal.wave_scratch``, made for each launch as the wrappers
make them); an older one the one-block kernel's
(``bitpal.wave_geometry``).  With ``--sweep LABEL`` that (pipelined)
version also runs each shape over fewer blocks than bands and more
(``[sweep]`` lines).  The builds, the ``[ptxas]`` report and the timer
are ``tools/ab_band_fill.py``'s.

Usage, from the repo root on a machine with a card and ``nvcc`` (the
parent's source beside the headers it includes under ``_checkout/``, which
is git-ignored but copied to the card):

    python3 tools/ab_bitpal_rc.py \\
        parent=_checkout/parent/bitpal_rc.cu \\
        change=tpualign_torch/csrc/bitpal_rc.cu [--sweep change] [--no-full]
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
from tpualign_torch.ops import bitpal  # noqa: E402

#: (name, query rows, text columns, rc, g, chunked): a chunked case runs
#: the route's chunks of ``bitpal.chunk_steps(rc)`` steps
FULL = [
    ("K4 state 2M x 100k", 100000, 2000000, 1, 2, True),
    ("K3a 1M x 10k", 10000, 1000000, 4, 1, False),
    ("K3a 20k", 20000, 20000, 4, 1, False),
    ("K3b 4M x 2k", 2000, 4000000, 4, 1, True),
]
#: held against the plain versions too: (name, rows, columns, rc, g, chunk
#: steps)
SMALL = [
    ("K3a small", 5000, 3000, 4, 1, None),
    ("K3b small", 5000, 3000, 3, 1, 333),
    ("K4 small", 5000, 3000, 1, 3, 1001),
]


class Version:
    """One built version and its launchers."""

    def __init__(self, label, src, lib):
        with open(src) as f:
            self.pipelined = "int blocks, void* ring" in f.read()
        self.last_plan = None  # the plan of the last pipelined launch
        self.label = label
        self.dll = ctypes.CDLL(lib)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        head = ([vp, vp, i64, i32, i32, i32, vp, i32, vp] if self.pipelined
                else [vp, vp, i64, i32, i32, i32, i32])
        self.dll.bitpal_rc_fill.argtypes = head + [vp, vp]
        for entry in (self.dll.bitpal_rc_chunk, self.dll.bitpal_gfill_chunk):
            entry.argtypes = head + [i64, i64, vp, vp, vp, vp, vp]

    def _head(self, t, eq, r, steps, blocks):
        """The entry's arguments up to the steps, and what they point to:
        a pipelined version's plan, ring and flags for a launch of
        ``steps`` steps (the plan kept in ``last_plan``), or the one
        block's geometry."""
        nw, mt = eq.shape[1], t.shape[0]
        if not self.pipelined:
            return (t.data_ptr(), eq.data_ptr(), mt, nw, r) + bitpal.wave_geometry(nw), None
        scratch = bitpal.wave_scratch(nw, steps, t.device, blocks)
        plan, ring, sync = scratch
        self.last_plan = plan
        return (t.data_ptr(), eq.data_ptr(), mt, nw, r, plan.blocks,
                None if ring is None else ring.data_ptr(), plan.depth, sync.data_ptr()), scratch

    def fill(self, t, eq, rc, blocks=None):
        """One ``bitpal_rc_fill`` launch: the planes (2, nw)."""
        nw, mt = eq.shape[1], t.shape[0]
        planes = torch.empty((2, nw), dtype=torch.int64, device=t.device)
        head, _keep = self._head(t, eq, rc, bitpal.total_steps(mt, nw, rc), blocks)
        err = self.dll.bitpal_rc_fill(*head, planes.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.label}: bitpal_rc_fill failed with CUDA error {err}")
        return planes, None

    def chunked(self, t, eq, rc, g, t_steps, blocks=None):
        """The route's chunks in turn from the boundary: the planes and the
        hand-offs after the last step."""
        nw, mt = eq.shape[1], t.shape[0]
        total = bitpal.total_steps(mt, nw, rc)
        entry = self.dll.bitpal_rc_chunk if rc > 1 else self.dll.bitpal_gfill_chunk
        state = bitpal.init_state(nw, g, t.device)
        v_in = torch.stack(state.planes)
        h_in = state.hand
        for t0 in range(0, total, t_steps):
            steps = min(t_steps, total - t0)
            v_out = torch.empty_like(v_in)
            h_out = torch.empty_like(h_in)
            head, _keep = self._head(t, eq, rc if rc > 1 else g, steps, blocks)
            err = entry(*head, t0, steps, v_in.data_ptr(), h_in.data_ptr(), v_out.data_ptr(),
                        h_out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{self.label}: chunk at {t0} failed with CUDA error {err}")
            v_in, h_in = v_out, h_out
        return v_in, h_in


def same(a, b):
    return torch.equal(a[0], b[0]) and (a[1] is None or torch.equal(a[1], b[1]))


def plain(t, eq, nq, rc, g, t_steps):
    """The plain version's planes (and hand-offs) of a small case."""
    tc, eqc = t.cpu(), eq.cpu()
    if t_steps is None:
        return torch.stack(bitpal.fill_rc_plain(tc, eqc, nq, rc)), None
    nw = eq.shape[1]
    total = bitpal.total_steps(tc.shape[0], nw, rc)
    state = bitpal.init_state(nw, g, "cpu")
    for t0 in range(0, total, t_steps):
        state = bitpal.chunk_plain(tc, eqc, nq, g, rc, t0, min(t_steps, total - t0), state)
    return torch.stack(state.planes), state.hand


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", help="label=path/to/bitpal_rc.cu")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--sweep", default=None, metavar="LABEL",
                    help="sweep the blocks of this (pipelined) version")
    ap.add_argument("--no-full", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_bitpal_rc: needs a CUDA device")
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    rng = np.random.default_rng(13)
    ok = True
    cases = [(name, nq, mt, rc, g, steps, True) for name, nq, mt, rc, g, steps in SMALL]
    if not args.no_full:
        cases += [(name, nq, mt, rc, g, bitpal.chunk_steps(rc) if chunked else None, False)
                  for name, nq, mt, rc, g, chunked in FULL]
    for name, nq, mt, rc, g, t_steps, small in cases:
        q = torch.from_numpy(rng.integers(1 if not small else 0, 5, nq).astype(np.int8)).cuda()
        t = torch.from_numpy(rng.integers(1 if not small else 0, 5, mt).astype(np.int8)).cuda()
        eq = bitpal._eq_planes(q, nq)
        nw = eq.shape[1]

        def run(v, blocks=None):
            if t_steps is None:
                return v.fill(t, eq, rc, blocks)
            return v.chunked(t, eq, rc, g, t_steps, blocks)

        order = list(range(len(built))) + list(reversed(range(len(built))))
        ms = {v.label: [] for v in built}
        outs = {}
        for i in order:
            v = built[i]
            got_ms, _, outs[v.label] = time_ms(lambda: run(v), args.runs)
            ms[v.label].append(got_ms)
        first = outs[built[0].label]
        equal = all(same(outs[v.label], first) for v in built[1:])
        if small:
            equal = equal and same(plain(t, eq, nq, rc, g, t_steps), (first[0].cpu(), (
                None if first[1] is None else first[1].cpu())))
        ok = ok and equal
        total = bitpal.total_steps(mt, nw, rc)
        launches = 1 if t_steps is None else -(-total // t_steps)
        # the plan of the last pipelined version's last launch, as it ran
        plan = next((v.last_plan for v in reversed(built) if v.pipelined), None)
        k1_ms, _, _ = time_ms(lambda: bitpal.fill_g(t, eq, nq, g), 1)
        print(f"[ab {name}] {nq} x {mt}, rc {rc}, g {g}, {launches} launch(es) of "
              f"{total if t_steps is None else t_steps} steps; plan {plan and tuple(plan)}: "
              + "; ".join(
                  f"{label} {', '.join(f'{x:.3f}' for x in v)} ms" for label, v in ms.items())
              + f"; outputs equal {equal}; bitpal_gfill (one launch) {k1_ms:.3f} ms")
        for v in built:
            bands = -(-nw // bitpal.BAND)
            if v.label != args.sweep or not v.pipelined or small or bands == 1:
                continue
            for blocks in sorted({bands + 16, -(-bands // 2), -(-bands // 4)}, reverse=True):
                got_ms, _, out = time_ms(lambda: run(v, blocks), 1)
                p = v.last_plan
                equal = same(out, first)
                ok = ok and equal
                print(f"[sweep {v.label} {name}] {p.blocks} blocks ({p.bands} bands, ring "
                      f"{p.depth}): {got_ms:.3f} ms; equal {equal}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
