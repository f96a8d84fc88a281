"""Time K9's port (``diag_ckpt_fill``, the checkpointed fill on the strip
pipeline) on one card, after holding it against its plain version.

    python3 tools/bench_diag_ckpt.py [--runs 3] [--no-full] [--parent DIR]
        [--variant LABEL=DIR ...] [--strides K,K,...]

From the repo root on a machine with a card and ``nvcc``.  Builds the
port's kernels and prints ptxas's registers and spills for
``diag_ckpt_kernel``, then:

- holds ``pallas_diag.ckpt_fill`` word for word against ``ckpt_plain``
  (both on the card) on small shapes under NW, SW, positive-mismatch SW
  and positive-gap local at strides 8, 24 and 1,024 and geometries of one
  block, blocks past the strips and fewer blocks than strips;
- times it (CUDA-event medians of ``--runs`` after one warm-up) at
  20,000 x 20,000 and, unless ``--no-full``, at the 64gb shape (126,440
  columns x 127,240 rows, seed 64) under NW (1, 0, -1) and
  positive-mismatch SW (3, 1, -2), stride 1,024, over a grid of ``(k,
  threads)``, every run held word for word against one ``ckpt_plain`` run
  at that shape;
- with ``--parent DIR`` (a directory holding an earlier ``diag_ckpt.cu``
  with its headers, whose entry takes ``(..., K, threads, diag, cka, ckb,
  v, dbest, stream)``: the one-block wavefront) builds that
  version on its own and times it at the same shapes in the same call,
  parent, change, change, parent, its outputs word for word the change's;
- with ``--variant LABEL=DIR`` (a ``diag_ckpt.cu`` beside its
  ``band_fill.cuh`` whose entry takes this one's arguments) the same, at
  the planner's geometry and at 4 rows a thread, variant, change, change,
  variant;
- with ``--strides``, K9 NW at other strides at the 64gb shape (not held
  there: the plain version's checkpoints at a small stride take gigabytes)
  after a hold at 20,000 x 20,000 at each, at the planner's geometry and
  at 4 rows a thread: what the checkpoint stores cost.

Prints one JSON line of every time at the end.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import ab_band_fill  # noqa: E402
import chip_smoke  # noqa: E402
from tpualign_torch import _build  # noqa: E402
from tpualign_torch.config import AlignMode, ScoringConfig  # noqa: E402
from tpualign_torch.ops import band, pallas_diag  # noqa: E402

CFGS = {
    "NW": ScoringConfig(),
    "positive-mismatch SW": ScoringConfig(match=3, mismatch=1, gap=-2, mode=AlignMode.LOCAL),
}
SMALL_CFGS = dict(CFGS, SW=ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL),
                  **{"positive-gap local": ScoringConfig(match=1, mismatch=-3, gap=1,
                                                         mode=AlignMode.LOCAL)})
#: (m columns, n rows) and geometries of the small holds
SMALL_SHAPES = [(300, 200), (200, 300), (1, 400), (400, 1), (1500, 1037)]
SMALL_GEOMETRIES = [None, (1, 32, 1), (2, 32, 64), (1, 32, 3)]
GRID_64GB = [(2, 64), (2, 128), (4, 64), (4, 128), (8, 64), (8, 128), (16, 128)]
GRID_20K = [(2, 128), (4, 64), (4, 128), (8, 128)]
K = 1024


def cuda_ms(fn, runs):
    """Median of ``runs`` CUDA-event times of ``fn()`` after a warm-up:
    ``(median, times, last result)``."""
    times, out = [], None
    for i in range(runs + 1):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        if i:
            times.append(e0.elapsed_time(e1))
    return statistics.median(times), times, out


def same(got, want, where):
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            raise AssertionError(f"diag_ckpt_fill differs from ckpt_plain at {where}")


def parent_fill(lib, t, q, cfg):
    """One launch of the parent's one-block K9 (a thread a diagonal element,
    up to 1,024): its outputs as Checkpoints."""
    m, n = t.numel(), q.numel()
    groups = -(-(n + m) // K)
    diag = torch.empty((3, n + 1), dtype=torch.int32, device=t.device)
    ck = torch.empty((2, groups, n + 1), dtype=torch.int32, device=t.device)
    best = torch.empty((2, n + 1), dtype=torch.int32, device=t.device)
    err = lib.diag_ckpt_fill(t.data_ptr(), m, q.data_ptr(), n, cfg.match, cfg.mismatch, cfg.gap,
                             int(cfg.is_local), K, min(1024, -(-(n + 1) // 32) * 32),
                             diag.data_ptr(),
                             ck[0].data_ptr(), ck[1].data_ptr(), best[0].data_ptr(),
                             best[1].data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the parent's diag_ckpt_fill failed with CUDA error {err}")
    if cfg.is_local:
        return pallas_diag.Checkpoints(ck[0], ck[1], best[0], best[1])
    return pallas_diag.Checkpoints(ck[0], ck[1], None, None)


def variant_fill(lib, t, q, cfg, geometry, stride=K):
    """One launch of a variant built from other sources with this entry's
    arguments, planned and scratched as ``pallas_diag.ckpt_fill`` does."""
    m, n = t.numel(), q.numel()
    groups = -(-(n + m) // stride)
    ck = torch.empty((2, groups, n + 1), dtype=torch.int32, device=t.device)
    best = torch.empty((2, n + 1), dtype=torch.int32, device=t.device)
    plan = band.pipeline_plan(n, m, False, geometry, band.MAX_K, band.ring_budget())
    ring, sync, _ = band._pipe_scratch(plan, m, False, t.device, False)
    err = lib.diag_ckpt_fill(t.data_ptr(), m, q.data_ptr(), n, cfg.match, cfg.mismatch, cfg.gap,
                             int(cfg.is_local), stride, plan.k, plan.threads, plan.blocks,
                             band._ptr(ring), plan.depth, sync.data_ptr(), ck[0].data_ptr(),
                             ck[1].data_ptr(), best[0].data_ptr(), best[1].data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the variant's diag_ckpt_fill failed with CUDA error {err}")
    if cfg.is_local:
        return pallas_diag.Checkpoints(ck[0], ck[1], best[0], best[1])
    return pallas_diag.Checkpoints(ck[0], ck[1], None, None)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--no-full", action="store_true")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--strides", default="")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    tmp = tempfile.mkdtemp()
    parent = None
    procs = {label: ab_band_fill.build(label, os.path.join(path, "diag_ckpt.cu"), tmp)
             for label, path in [("parent", args.parent)] * bool(args.parent)
             + [v.split("=", 1) for v in args.variant]}
    lib_path = _build.library_path()
    _build.load()
    with open(lib_path + ".log") as f:
        for name, regs, spill in chip_smoke.ptxas_report(f.read()):
            if name.startswith("diag_ckpt_kernel"):
                print(f"[ptxas] {name}: {regs} registers, {spill} bytes spill stores")
    variants = {}
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for label, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        lib = ctypes.CDLL(os.path.join(tmp, f"{label}.so"))
        if label == "parent":
            parent = lib
            lib.diag_ckpt_fill.argtypes = [vp, i32, vp, i32] + [i32] * 6 + [vp] * 6
        else:
            variants[label] = lib
            lib.diag_ckpt_fill.argtypes = ([vp, i32, vp, i32] + [i32] * 8
                                           + [vp, i32, vp, vp, vp, vp, vp, vp])
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n_small = 0
    for (m, n), geometry, (name, cfg), stride in (
            (s, g, c, k) for s in SMALL_SHAPES for g in SMALL_GEOMETRIES
            for c in SMALL_CFGS.items() for k in (8, 24, 1024)):
        t = torch.from_numpy(rng.integers(0, 5, m).astype(np.int8)).to(dev)
        q = torch.from_numpy(rng.integers(0, 5, n).astype(np.int8)).to(dev)
        same(pallas_diag.ckpt_fill(t, q, cfg, stride, geometry),
             pallas_diag.ckpt_plain(t, q, cfg, stride),
             f"{name} {m} x {n}, {geometry}, K = {stride}")
        n_small += 1
    print(f"[diag_ckpt_fill vs plain] {n_small} small cases word for word")
    times = {}
    a, b = (rng.integers(1, 5, 20000, dtype=np.int8) for _ in range(2))
    shapes = [("20k", a, b, GRID_20K)]
    if not args.no_full:
        s1, s2, _ = chip_smoke.load_pair(None)
        shapes.append(("64gb", s1, s2, GRID_64GB))
    for tag, s1, s2, grid in shapes:
        t, q = torch.from_numpy(s1).to(dev), torch.from_numpy(s2).to(dev)
        m, n = t.numel(), q.numel()
        for name, cfg in CFGS.items():
            want = pallas_diag.ckpt_plain(t, q, cfg, K)
            rows = {}
            for geometry in [None] + grid:
                plan = band.pipeline_plan(n, m, False, geometry, band.MAX_K, band.ring_budget())
                ms, runs, out = cuda_ms(lambda: pallas_diag.ckpt_fill(t, q, cfg, K, geometry),
                                        args.runs)
                same(out, want, f"{tag} {name} at {plan}")
                del out
                key = "planner" if geometry is None else f"{plan.k}x{plan.threads}x{plan.blocks}"
                rows[key] = ms
                print(f"[time] {smi}: diag_ckpt_fill {name} {tag} ({n} rows x {m} columns), "
                      f"K = {K}, k = {plan.k}, {plan.threads} threads, {plan.blocks} blocks "
                      f"({plan.strips} strips, ring {plan.depth}): median {ms:.3f} ms "
                      f"({m * n / ms / 1e6:.2f} GCUPS; runs {', '.join(f'{x:.3f}' for x in runs)})")
            if parent is not None:  # parent, change, change, parent
                order = []
                for who in ("parent", "change", "change", "parent"):
                    if who == "parent":
                        ms, _, out = cuda_ms(lambda: parent_fill(parent, t, q, cfg), 1)
                    else:
                        ms, _, out = cuda_ms(lambda: pallas_diag.ckpt_fill(t, q, cfg, K), 1)
                    same(out, want, f"{tag} {name}, {who}")
                    del out
                    order.append(ms)
                rows["ab"] = order
                print(f"[ab] {smi}: diag_ckpt_fill {name} {tag}, parent (one block) against "
                      f"change, in the order parent change change parent: "
                      f"{', '.join(f'{x:.3f}' for x in order)} ms")
            for label, lib in variants.items():
                for geometry in (None, (4, 128)):
                    order = []
                    for who in ("variant", "change", "change", "variant"):
                        fill = ((lambda: variant_fill(lib, t, q, cfg, geometry)) if who == "variant"
                                else (lambda: pallas_diag.ckpt_fill(t, q, cfg, K, geometry)))
                        ms, _, out = cuda_ms(fill, args.runs)
                        same(out, want, f"{tag} {name}, {who} {label} at {geometry}")
                        del out
                        order.append(ms)
                    rows[f"{label} {geometry}"] = order
                    print(f"[ab] {smi}: diag_ckpt_fill {name} {tag} at {geometry or 'the planner'}"
                          f", variant {label} against change, medians of {args.runs} in the "
                          f"order variant change change variant: "
                          f"{', '.join(f'{x:.3f}' for x in order)} ms")
            times[f"{tag} {name}"] = rows
            del want
        for stride in (int(x) for x in args.strides.split(",") if x):
            cfg = CFGS["NW"]
            if tag == "20k":
                same(pallas_diag.ckpt_fill(t, q, cfg, stride),
                     pallas_diag.ckpt_plain(t, q, cfg, stride), f"20k NW, K = {stride}")
            for geometry in (None, (4, 128)):
                ms, runs, out = cuda_ms(lambda: pallas_diag.ckpt_fill(t, q, cfg, stride, geometry),
                                        args.runs)
                del out
                times[f"{tag} NW K = {stride} {geometry}"] = ms
                print(f"[stride] {smi}: diag_ckpt_fill NW {tag}, K = {stride}, "
                      f"{geometry or 'the planner'}: median {ms:.3f} ms (runs "
                      f"{', '.join(f'{x:.3f}' for x in runs)})")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, "ms": times}))


if __name__ == "__main__":
    main()
