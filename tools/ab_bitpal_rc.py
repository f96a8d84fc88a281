"""A/B two versions of ``tpualign_torch/csrc/bitpal_rc.cu`` on the card.

Usage, from the repo root (on a machine with ``nvcc`` and a CUDA device):

    python3 tools/ab_bitpal_rc.py A.cu B.cu

Builds each version alone into its own library (the port's flags, the
port's ``csrc/`` on the include path for ``bitpal_step.cuh``), then times
``bitpal_rc_fill``, and ``bitpal_rc_chunk`` or ``bitpal_gfill_chunk`` as
one chunk over every step, of both on the same inputs in the order
A B B A, CUDA events, median of 3 after a warm-up, beside ``bitpal_gfill``
on the same query and text.
Prints one line a shape, with whether both versions' planes are equal, and
exits 1 if they are not.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpualign_torch import _build  # noqa: E402
from tpualign_torch.ops import bitpal  # noqa: E402

#: (name, text length, query length, rc, g, (k, threads) or None)
CASES = [
    ("K3a", 1000000, 10000, 4, 1, None),
    ("K3a one warp", 1000000, 10000, 4, 1, (8, 32)),
    ("K3a 20k", 20000, 20000, 4, 1, None),
    ("K3a rc 2", 1000000, 10000, 2, 1, None),
    ("K3b shape", 4000000, 2000, 4, 1, None),
    ("K4 g 2", 200000, 100000, 1, 2, None),
    ("K4 g 1", 1000000, 10000, 1, 1, None),
]


def build(sources, out_dir):
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", _build.CSRC,
                               "-o", os.path.join(out_dir, f"{i}.so"), src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, src in enumerate(sources)]
    libs = []
    for i, proc in enumerate(procs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {sources[i]}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{i}.so"))
        lib.bitpal_rc_fill.argtypes = [vp, vp, i64, i32, i32, i32, i32, vp, vp]
        for entry in (lib.bitpal_rc_chunk, lib.bitpal_gfill_chunk):
            entry.argtypes = [vp, vp, i64, i32, i32, i32, i32, i64, i64, vp, vp, vp, vp, vp]
        libs.append(lib)
    return libs


def cuda_ms(fn, runs=3):
    times = []
    for i in range(runs + 1):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        if i:
            times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def launcher(lib, t, eq, rc, g, geometry, planes, chunk):
    """``bitpal_rc_fill`` (rc > 1, not ``chunk``), else one chunk of
    ``bitpal_rc_chunk`` (rc > 1) or ``bitpal_gfill_chunk`` over every step."""
    nw, mt = eq.shape[1], t.shape[0]
    k, threads = geometry
    stream = torch.cuda.current_stream().cuda_stream
    if rc > 1 and not chunk:
        return lambda: lib.bitpal_rc_fill(t.data_ptr(), eq.data_ptr(), mt, nw, rc, k, threads,
                                          planes.data_ptr(), stream)
    state = bitpal.init_state(nw, g, t.device)
    v_in, hand = torch.stack(state.planes), torch.empty(nw, dtype=torch.uint8, device=t.device)
    steps = bitpal.total_steps(mt, nw, rc)
    entry = lib.bitpal_rc_chunk if rc > 1 else lib.bitpal_gfill_chunk
    return lambda: entry(t.data_ptr(), eq.data_ptr(), mt, nw, rc if rc > 1 else g, k, threads,
                         0, steps, v_in.data_ptr(), state.hand.data_ptr(), planes.data_ptr(),
                         hand.data_ptr(), stream)


def main() -> int:
    if len(sys.argv) != 3 or not torch.cuda.is_available():
        sys.exit(__doc__)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sys.argv[1:], tmp)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
        rng = np.random.default_rng(1)
        ok = True
        for name, mt, nq, rc, g, geometry in CASES:
            t = torch.from_numpy(rng.integers(1, 5, mt).astype(np.int8)).cuda()
            q = torch.from_numpy(rng.integers(1, 5, nq).astype(np.int8)).cuda()
            eq = bitpal._eq_planes(q, nq)
            geometry = geometry or bitpal.wave_geometry(eq.shape[1])
            planes = [torch.empty((bitpal.n_planes(g), eq.shape[1]), dtype=torch.int64,
                                  device="cuda") for _ in libs]
            k1 = cuda_ms(lambda: bitpal.fill_g(t, eq, nq, g), runs=1)
            for chunk in ((False, True) if rc > 1 else (True,)):
                ms = {0: [], 1: []}
                for v in (0, 1, 1, 0):
                    ms[v].append(cuda_ms(launcher(libs[v], t, eq, rc, g, geometry, planes[v],
                                                  chunk)))
                same = torch.equal(planes[0], planes[1])
                ok = ok and same
                entry = ("bitpal_rc_chunk" if rc > 1 else "bitpal_gfill_chunk") if chunk \
                    else "bitpal_rc_fill"
                print(f"[ab {name}] {entry}{' (one chunk)' if chunk else ''}, {nq} x {mt}, rc "
                      f"{rc}, g {g}, geometry {geometry}: A "
                      f"{', '.join(f'{x:.3f}' for x in ms[0])} ms, B "
                      f"{', '.join(f'{x:.3f}' for x in ms[1])} ms; planes equal {same}; "
                      f"bitpal_gfill {k1:.3f} ms")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
