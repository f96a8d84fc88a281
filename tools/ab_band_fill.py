"""A/B of versions of the band kernels' sources on one card, in one process:
each version builds into a library of its own, and the script prints, per
version, the registers and spills that ptxas reports for the
16-rows-a-thread kernels, their SASS instruction counts (``cuobjdump``),
whether ``band_batch_kernel``'s SASS equals the first version's, and the
times of the same fills, run in the order A B .. B A so that drift on the
card shows as asymmetry.  Every version's result must equal the first
version's, or the script exits 1.

Usage, from the repo root on a machine with a card and ``nvcc``:

    python3 tools/ab_band_fill.py \
        parent=OLD/band_fill.cu+OLD/band_capture_affine.cu+OLD/band_batch.cu \
        change=tpualign_torch/csrc/band_fill.cu+tpualign_torch/csrc/band_capture_affine.cu+tpualign_torch/csrc/band_batch.cu

A version is one source or several joined by ``+``, built into one library
(each source beside the ``band_fill.cuh`` it includes).  A version whose
``band_fill.cuh`` defines ``pipe_args`` takes the pipelined entries'
arguments (geometry ``band.pipeline_plan``'s, with its ring and flags);
an older one the single-block entries' (``band.kernel_geometry``, one
boundary row).

Times are CUDA-event medians of ``--runs`` runs after one warm-up: K6
(``band_fill``) under SW (2, -1, -2), the DNA matrix, affine NW and affine
SW at 20,000 x 20,000, and SW at the 64gb shape unless ``--no-full``; K7
(``band_capture_fill``, where a version has it) as the SW locate and as a
global fill with 31 rows at 20,000 x 20,000 and as the SW locate at the
64gb shape, and where a version has ``band_capture_affine`` as
Myers-Miller's half fill (10,000 rows at 20k; 63,620 at the 64gb shape,
the last rows H and F) and the affine SW locate at 20k; where a version
has ``band_batch_fill``, the batch of mix (A) under SW and of mix (B)
under infix (``tpualign_torch.probe``).  With ``--out DIR`` the SASS of
K6's SW kernel at 16 rows a thread goes to DIR, one file per version.
"""

from __future__ import annotations

import argparse
import atexit
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpualign_torch import _build, matrices  # noqa: E402
from tpualign_torch.config import AlignMode, ScoringConfig  # noqa: E402
from tpualign_torch.ops import band, hirschberg, pairs  # noqa: E402
from tpualign_torch.probe import read_pairs, serve_pairs  # noqa: E402

SW = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
SCORES = {
    "SW": SW,
    "dna NW": ScoringConfig(matrix=matrices.dna(2, -1, -3), gap=-3),
    "affine NW": ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2),
    "affine SW": ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2,
                               mode=AlignMode.LOCAL),
}
#: K6's SW kernel at 16 rows a thread (pair scoring, linear gaps, local)
SW_KERNEL = "band_fill_kernelILi16ELb0ELb0ELb1E"


def build(label: str, srcs: str, out: str) -> subprocess.Popen:
    """nvcc of one version: its sources, joined by ``+``, into one library."""
    lib = os.path.join(out, f"{label}.so")
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, *srcs.split("+")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas(log: str, match: str = ""):
    """(kernel, registers, spill bytes) of the kernels in a ptxas log whose
    mangled names hold ``match``."""
    rows, name = [], None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\S+)'", line)
        if hit:
            name = hit.group(1)
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name and match in name:
            spill = re.search(r"(\d+) bytes spill stores", log[log.find(name):])
            rows.append((name, int(hit.group(1)), int(spill.group(1)) if spill else None))
            name = None
    return rows


def sass(lib: str):
    """{kernel: [instruction, ...]} of a library, addresses and encodings cut."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        hit = re.match(r"\s*Function : (\S+)", line)
        if hit:
            name = hit.group(1)
            out[name] = []
            continue
        hit = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if hit and name:
            out[name].append(hit.group(1))
    return out


def pipelined(srcs: str) -> bool:
    """Whether a version's band_fill.cuh is the pipelined one."""
    head = os.path.join(os.path.dirname(srcs.split("+")[0]), "band_fill.cuh")
    with open(head) as f:
        return "pipe_args" in f.read()


def bind(lib: str, pipe: bool) -> ctypes.CDLL:
    dll = ctypes.CDLL(lib)
    dll.pipe = pipe
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if pipe:
        dll.band_fill.argtypes = [vp, i32, vp, i32, vp] + [i32] * 10 + [vp, i32, vp, vp, vp]
    else:
        dll.band_fill.argtypes = [vp, i32, vp, i32, vp, i32] + [i32] * 8 + [vp, vp, vp]
    dll.band_fill.restype = i32
    if hasattr(dll, "band_capture_fill"):
        dll.band_capture_fill.argtypes = (
            [vp, i32, vp, i32, vp] + [i32] * 8 + [vp, i32, vp, vp, vp, vp, i32, vp, vp, vp]
            if pipe else [vp, i32, vp, i32, vp, i32] + [i32] * 6 + [vp, i32] + [vp] * 5)
        dll.band_capture_fill.restype = i32
    if hasattr(dll, "band_capture_affine"):
        dll.band_capture_affine.argtypes = (
            [vp, i32, vp, i32, vp] + [i32] * 10 + [vp, i32, vp, vp, vp, vp, vp, i32, vp, vp, vp]
            if pipe else [vp, i32, vp, i32, vp, i32] + [i32] * 8 + [vp, i32] + [vp] * 6)
        dll.band_capture_affine.restype = i32
    if hasattr(dll, "band_batch_fill"):
        dll.band_batch_fill.argtypes = [vp] * 6 + [i32, i64, vp] + [i32] * 9 + [vp] * 3
        dll.band_batch_fill.restype = i32
    return dll


def scratch(dll, n, m, cfg, cell):
    """A version's geometry arguments and scratch: ``(k, threads, blocks)``,
    ring, depth, flags and the blocks' cells for a pipelined version;
    ``(k, threads)`` and one boundary buffer for an older one."""
    if not dll.pipe:
        k, threads = band.kernel_geometry(n, band.max_k(cfg))
        boundary = torch.empty((2, m + 1), dtype=torch.int32, device="cuda")
        return (k, threads), (boundary,), lambda: (boundary.data_ptr(),)
    plan = band.pipeline_plan(n, m, cfg.is_affine, None, band.max_k(cfg))
    ring, sync, cells = band._pipe_scratch(plan, m, cfg.is_affine, "cuda", cell)

    def args():
        sync.zero_()
        return (band._ptr(ring), plan.depth, sync.data_ptr(), band._ptr(cells))
    return (plan.k, plan.threads, plan.blocks), (ring, sync, cells), args


def score_call(dll, text, query, cfg, ends):
    m, n = text.numel(), query.numel()
    geom, keep, pipe_args = scratch(dll, n, m, cfg, False)
    K = len(cfg.matrix) if cfg.has_matrix else 0
    matrix = torch.tensor(cfg.matrix if K else [0], dtype=torch.int32).cuda()
    out = torch.empty(1, dtype=torch.int32, device="cuda")

    def run():
        if dll.pipe:
            out.fill_(0 if cfg.is_local else band.NEG)
            extra = pipe_args()[:3]
        else:
            extra = pipe_args()
        err = dll.band_fill(text.data_ptr(), m, query.data_ptr(), n, matrix.data_ptr(), K,
                            cfg.match, cfg.mismatch, cfg.gap, cfg.gap_open or 0,
                            cfg.gap_extend or 0, band._flags(cfg, ends), *geom, *extra,
                            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"band_fill launch failed with CUDA error {err}")
        return out
    return run


def capture_call(dll, text, query, cfg, rows, cell, tb=0):
    """A capture fill: ``band_capture_fill`` under linear gaps,
    ``band_capture_affine`` (with the top-edge open ``tb``) under affine
    ones.  Returns the captured rows, then the cell, then the F row."""
    m, n = text.numel(), query.numel()
    geom, keep, pipe_args = scratch(dll, n, m, cfg, cell)
    krows = list(rows) if rows and rows[-1] == n else list(rows) + [n]
    cap_rows = torch.tensor(krows, dtype=torch.int32).cuda()
    caps = torch.empty((len(krows), m + 1), dtype=torch.int32, device="cuda")
    found = torch.empty(3, dtype=torch.int32, device="cuda") if cell else None
    f_row = torch.empty(m + 1, dtype=torch.int32, device="cuda") if cfg.is_affine else None
    matrix = torch.zeros(1, dtype=torch.int32, device="cuda")
    head = (text.data_ptr(), m, query.data_ptr(), n, matrix.data_ptr(), 0, cfg.match,
            cfg.mismatch)
    flags = band._flags(cfg, (False, False, False, False))
    outs = (cap_rows.data_ptr(), len(krows), caps.data_ptr(), None,
            None if found is None else found.data_ptr())

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        extra = pipe_args()
        if cfg.is_affine:
            err = dll.band_capture_affine(*head, cfg.gap_open, cfg.gap_extend, tb, flags, *geom,
                                          *outs, f_row.data_ptr(), *extra, stream)
        else:
            err = dll.band_capture_fill(*head, cfg.gap, flags, *geom, *outs, *extra, stream)
        if err:
            raise RuntimeError(f"the capture fill's launch failed with CUDA error {err}")
        return torch.cat([caps.flatten()] + [t for t in (found, f_row) if t is not None])
    return run


def batch_call(dll, packed, cfg):
    """``band_batch_fill`` over a packed batch (the same ABI in every
    version): one block a pair, ``band.kernel_geometry`` of the longest
    query."""
    P = packed.offsets.shape[1]
    k, threads = band.kernel_geometry(packed.n_cap, band.max_k(cfg))
    boundary = torch.empty((P, 2, packed.m_cap + 1), dtype=torch.int32, device="cuda")
    out = torch.empty(P, dtype=torch.int32, device="cuda")
    matrix = torch.zeros(1, dtype=torch.int32, device="cuda")
    off, ln = packed.offsets, packed.lengths
    ends = band._ends_flags(cfg, False)

    def run():
        err = dll.band_batch_fill(packed.texts.data_ptr(), packed.queries.data_ptr(),
                                  off[0].data_ptr(), off[1].data_ptr(), ln[0].data_ptr(),
                                  ln[1].data_ptr(), P, packed.m_cap, matrix.data_ptr(), 0,
                                  cfg.match, cfg.mismatch, cfg.gap, cfg.gap_open or 0,
                                  cfg.gap_extend or 0, band._flags(cfg, ends), k, threads,
                                  boundary.data_ptr(), out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"band_batch_fill launch failed with CUDA error {err}")
        return out
    return run


def time_ms(run, runs):
    """Median CUDA-event time of ``runs`` runs after one warm-up, the runs,
    and the warm-up's result."""
    out = run()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), times, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("versions", nargs="+", help="label=path of a band_fill.cu")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--no-full", action="store_true", help="skip the 64gb-shape SW fill")
    ap.add_argument("--out", help="directory for the SASS of K6's SW kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    versions = [v.split("=", 1) for v in args.versions]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {smi.strip()}")

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, tmp, True)
    procs = [(label, build(label, src, tmp)) for label, src in versions]
    libs = {}
    for label, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            print(log)
            raise RuntimeError(f"nvcc failed for {label}")
        libs[label] = os.path.join(tmp, f"{label}.so")
        for name, regs, spill in ptxas(log, "ILi16E"):  # the 16-rows kernels
            print(f"[ptxas {label}] {name}: {regs} registers, {spill} bytes spilled")
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")

    first = None
    for label, lib in libs.items():
        kernels = sass(lib)
        for name, instrs in sorted(kernels.items()):
            if "ILi16E" in name:
                print(f"[sass {label}] {name}: {len(instrs)} instructions")
        for name in kernels:
            if args.out and SW_KERNEL in name:
                with open(os.path.join(args.out, f"{label}.{name}.sass"), "w") as f:
                    f.write("\n".join(kernels[name]) + "\n")
        # the batch kernel's instantiations by template arguments, against
        # the first version's (K6's and K7's SASS change with the pipeline)
        kb = {hit.group(1): instrs for name, instrs in kernels.items()
              if (hit := re.search(r"band_batch_kernelI(Li\d+E(?:Lb[01]E){3})", name))}
        if first is None:
            first = label, kb
            continue
        same = [key for key, instrs in kb.items() if first[1].get(key) == instrs]
        differ = sorted(set(kb) ^ set(first[1]) | (set(kb) - set(same)))
        print(f"[sass {label} vs {first[0]}] band_batch_kernel instantiations with the same "
              f"SASS: {len(same)} of {len(first[1])}; differing or missing: {differ}")
    dlls = {label: bind(lib, pipelined(src)) for (label, src), lib in
            zip(versions, libs.values())}

    rng = np.random.default_rng(20)
    a = torch.from_numpy(rng.integers(1, 5, 20000).astype(np.int8)).cuda()
    b = torch.from_numpy(rng.integers(1, 5, 20000).astype(np.int8)).cuda()
    cases = [(f"K6 {name} 20k", lambda d, c=cfg: score_call(d, a, b, c, band._ends_flags(c, False)))
             for name, cfg in SCORES.items()]
    rows20 = hirschberg._kway_rows(b.numel())
    cases += [("K7 SW locate 20k", lambda d: capture_call(d, a, b, SW, [], True)),
              ("K7 global 31 rows 20k", lambda d: capture_call(
                  d, a, b, ScoringConfig(match=2, mismatch=-1, gap=-2), rows20, False)),
              ("K7 affine global half 20k", lambda d: capture_call(
                  d, a, b[:10000], SCORES["affine NW"], [], False, tb=-5)),
              ("K7 affine SW locate 20k", lambda d: capture_call(
                  d, a, b, SCORES["affine SW"], [], True, tb=-5))]
    for tag, (texts, queries), cfg in (
            ("A SW", serve_pairs(), SW),
            ("B infix", read_pairs(), ScoringConfig(match=2, mismatch=-1, gap=-2,
                                                    mode=AlignMode.INFIX))):
        packed = pairs.pack_pairs(texts, queries, np.arange(len(texts))).to("cuda")
        cases.append((f"batch {tag}", lambda d, pk=packed, c=cfg: batch_call(d, pk, c)))
    if not args.no_full:
        g = np.random.default_rng(64)
        s1 = torch.from_numpy(g.integers(1, 5, 126440).astype(np.int8)).cuda()
        s2 = torch.from_numpy(g.integers(1, 5, 127240).astype(np.int8)).cuda()
        p = band.plan(s1.numel(), s2.numel(), SW)
        text, query = (s2, s1) if p.swapped else (s1, s2)
        half = s2[: s2.numel() // 2]
        cases += [("K6 SW 64gb shape", lambda d: score_call(d, text, query, p.cfg, p.ends)),
                  ("K7 SW locate 64gb shape", lambda d: capture_call(d, s1, s2, SW, [], True)),
                  ("K7 affine root forward fill 64gb shape", lambda d: capture_call(
                      d, s1, half, SCORES["affine NW"], [], False, tb=-5))]

    order = [label for label, _ in versions]
    order = order + order[::-1]
    results, firsts = {}, {}
    for case, make in cases:
        for label in order:
            dll = dlls[label]
            if case.startswith("K7") and not hasattr(dll, "band_capture_fill"):
                continue
            if case.startswith("K7 affine") and not hasattr(dll, "band_capture_affine"):
                continue
            if case.startswith("batch") and not hasattr(dll, "band_batch_fill"):
                continue
            ms, runs, out = time_ms(make(dll), args.runs)
            out = out.cpu()
            if case in firsts and not torch.equal(firsts[case], out):
                print(f"[differs] {case}: {label}'s result differs from the first version's")
                return 1
            firsts.setdefault(case, out)
            results.setdefault(case, {}).setdefault(label, []).append(ms)
            print(f"[time] {case} {label}: median {ms:.3f} ms (runs "
                  f"{', '.join(f'{t:.3f}' for t in runs)})")
    print(json.dumps({"card": smi.strip(), "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
