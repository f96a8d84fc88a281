"""Smoke run of the PyTorch/CUDA port (``tpualign_torch``) on one NVIDIA GPU.

Builds the port's CUDA kernels from ``tpualign_torch/csrc`` with ``nvcc``
(``bitpal_fill``, the K1 port; ``bitpal_gfill`` and ``bitpal_capture_fill``,
the K2 and K4 ports), holds each against its plain PyTorch version on the
card at a range of shapes (and the scores and alignments against the port's
NumPy oracle), then drives the port's paths on a pair of the reference
corpus's largest shape, 64gb (126,440 x 127,240 bases, 16.09e9 DP cells),
each with the launch counts set to 0 just before it, and holds each path's
kernel against its plain version at that path's own shape:

- ``tpualign_torch.align_score`` at the default scoring (K1);
- ``tpualign_torch.align`` at the default scoring: the bit-parallel
  Hirschberg split over the capture kernel, then leaf walks on the host
  (this slice's main path);
- ``tpualign_torch.align_score`` under ``ScoringConfig(gap=-2)`` (K2).

    python3 chip_smoke.py [--corpus DIR]

With ``--corpus`` naming the reference's ``bdna`` directory the 64gb pair is
read from it and the score must be the reference's 73888; otherwise a random
pair of that shape (seed 64) is scored and must equal the plain version's
score on the card.  Each phase prints lines tagged with its name; a failure
raises and the exit code is non-zero.  The last two lines are the kernels'
JSON and the device JSON.  Exits non-zero without a CUDA device.  Imports
nothing of JAX or of the JAX package ``tpualign``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

PAIR_LENGTHS = (126440, 127240)  # bdna/64gb-{1,2}.bdna
PAIR_SEED = 64
KERNEL_SOURCE = "tpualign_torch/csrc/bitpal_fill.cu"
REPLACES = "tpualign/ops/bitpal.py:283"  # _bitpal_kernel_body_lean
GKERNEL_SOURCE = "tpualign_torch/csrc/bitpal_gfill.cu"
GREPLACES = {
    "bitpal_gfill": "tpualign/ops/bitpal.py:556",  # _g_kernel_body (K2)
    "bitpal_capture_fill": "tpualign/ops/bitpal.py:1038",  # _chunk_kernel_body (K4)
}
TIMING_SHAPE = (20000, 20000)  # K2 and K4 kernel and plain times


def read_bdna(path):
    """A ``.bdna`` file: one int8 base code (0..4) per byte."""
    seq = np.fromfile(path, dtype=np.int8)
    if seq.size and (seq.min() < 0 or seq.max() > 4):
        raise ValueError(f"{path}: byte outside the .bdna code range 0..4")
    return seq


def load_pair(corpus):
    """The 64gb pair from ``corpus``, else the random stand-in of its shape:
    codes 1..4 drawn as the JAX package's ``io.bdna.random_pair`` draws them
    (``bench.py`` scores the same pair)."""
    if corpus is None:
        rng = np.random.default_rng(PAIR_SEED)
        s1, s2 = (rng.integers(1, 5, size=n, dtype=np.int8) for n in PAIR_LENGTHS)
        return s1, s2, f"random pair, seed {PAIR_SEED}"
    p1, p2 = (os.path.join(corpus, f"64gb-{i}.bdna") for i in (1, 2))
    return read_bdna(p1), read_bdna(p2), f"corpus {p1}, {p2}"


def ptxas_report(log: str):
    """One ``(kernel<template args>, registers, spill store bytes)`` per
    instantiation in an ``nvcc -Xptxas -v`` log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"(bitpal_g?fill_kernel)I", mangled)
            args = re.search(r"kernelI(.*?)EEv", mangled)
            targs = re.findall(r"L[ib](\d+)E", args.group(1) + "E") if args else []
            name = f"{base.group(1) if base else mangled}<{','.join(targs)}>"
            spill = None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def alignment_ok(s1, s2, a1, a2, bases):
    """The aligned strings give back ``s1`` and ``s2`` once the gaps are
    stripped, and no column holds two gaps (codes 1..4 only: code 0 prints
    as the gap)."""
    table = np.frombuffer(bases.encode(), np.uint8)
    b1 = np.frombuffer(a1.encode(), np.uint8)
    b2 = np.frombuffer(a2.encode(), np.uint8)
    gap = ord("-")
    return (len(a1) == len(a2)
            and np.array_equal(b1[b1 != gap], table[s1])
            and np.array_equal(b2[b2 != gap], table[s2])
            and not ((b1 == gap) & (b2 == gap)).any())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", default=None,
                    help="directory holding 64gb-1.bdna and 64gb-2.bdna")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA device")

    import tpualign_torch
    from tpualign_torch import _build
    from tpualign_torch.config import ScoringConfig
    from tpualign_torch.ops import bitpal, hirschberg, oracle

    counted = (bitpal.fill, bitpal.fill_g, bitpal.capture_fill)

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    def read_counts():
        return {fn.__name__: fn.launches for fn in counted}

    def cuda_ms(fn, runs=5):
        """Median of ``runs`` CUDA-event times of ``fn()`` after one warm-up;
        returns ``(median ms, all ms, last result)``."""
        times = []
        for i in range(runs + 1):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn()
            e1.record()
            e1.synchronize()
            if i:
                times.append(e0.elapsed_time(e1))
        return statistics.median(times), times, out

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # phase 2: build the kernel from the checkout's sources
    t0 = time.perf_counter()
    lib_path = _build.library_path()
    _build.load()
    build_s = time.perf_counter() - t0
    with open(lib_path + ".log") as f:
        report = ptxas_report(f.read())
    print(f"[build] {os.path.relpath(lib_path)} in {build_s:.1f} s; "
          f"{len(report)} kernel instantiations")
    for name, regs, spill in report:  # phase (a): -Xptxas -v per instantiation
        print(f"[ptxas] {name}: {regs} registers, {spill} bytes spill stores")
    if len(report) != 5 + 30:
        raise AssertionError(f"expected 35 kernel instantiations, ptxas reported {len(report)}")

    # phase 3: kernel against its plain version (planes word for word), the
    # scores against the oracle (up to 300 x 300, and once at 20k x 20k)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def kernel_vs_plain(query, text):
        nq, mt = query.size, text.size
        q = torch.from_numpy(query).to(dev)
        t = torch.from_numpy(text).to(dev)
        eq = bitpal._eq_planes(q, nq)
        k0, k1 = bitpal.fill(t, eq, nq)
        p0, p1 = bitpal.fill_plain(t, eq, nq)
        torch.cuda.synchronize()
        if not (torch.equal(k0, p0) and torch.equal(k1, p1)):
            raise AssertionError(f"kernel planes differ from fill_plain at {nq} x {mt}")
        ks = int(bitpal._reduce_score((k0, k1), nq, mt))
        if ks != int(bitpal._reduce_score((p0, p1), nq, mt)):
            raise AssertionError(f"kernel score differs from fill_plain at {nq} x {mt}")
        return ks

    shapes = [(nq, mt, 1) for nq in (1, 63, 64, 65, 127, 128, 129, 1000) for mt in (1, 2, 300)]
    shapes += [(300, 300, 0), (2000, 3000, 0)]  # codes 0..4
    # past one word per thread: k = 2, 4, 8, 16 words per thread
    shapes += [(65600, 40, 1), (200000, 40, 1), (400000, 40, 1), (1000000, 40, 1)]
    n_oracle = 0
    for nq, mt, lo in shapes:
        query = rng.integers(lo, 5, nq).astype(np.int8)
        text = rng.integers(lo, 5, mt).astype(np.int8)
        ks = kernel_vs_plain(query, text)
        if nq <= 300 and mt <= 300:
            want = oracle.score(text, query)
            if ks != want:
                raise AssertionError(f"kernel score {ks} != oracle {want} at {nq} x {mt}")
            n_oracle += 1
    per_thread = sorted({bitpal.kernel_geometry(-(-nq // bitpal.WORD))[0] for nq, _, _ in shapes})
    print(f"[kernel vs plain] {len(shapes)} shapes equal word for word "
          f"(words per thread {per_thread}); {n_oracle} scores equal to the oracle")
    a = rng.integers(1, 5, 20000).astype(np.int8)
    b = rng.integers(1, 5, 20000).astype(np.int8)
    got, want = bitpal.score(a, b, device="cuda"), oracle.score(a, b)
    if got != want:
        raise AssertionError(f"20000 x 20000: kernel score {got} != oracle {want}")
    print(f"[kernel vs oracle] 20000 x 20000 score {got} equal to the oracle's")

    # phase 4: the main path, through the public entry point
    s1, s2, source = load_pair(args.corpus)
    m, n = s1.size, s2.size
    reset_counts()
    t0 = time.perf_counter()
    score = tpualign_torch.align_score(s1, s2)
    wall_s = time.perf_counter() - t0
    launches = bitpal.fill.launches
    if launches < 1:
        raise AssertionError("align_score did not launch the bitpal_fill kernel")

    # the same fill at the main path's shape, plain and kernel, outside the
    # counted run
    s1_is_query = bitpal._orientation(m, n)
    query, text = (s1, s2) if s1_is_query else (s2, s1)
    nq, mt = query.size, text.size
    q = torch.from_numpy(query).to(dev)
    t = torch.from_numpy(text).to(dev)
    eq = bitpal._eq_planes(q, nq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p0, p1 = bitpal.fill_plain(t, eq, nq)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_score = int(bitpal._reduce_score((p0, p1), nq, mt))  # unit scoring
    if args.corpus is not None and score != 73888:
        raise AssertionError(f"64gb corpus score {score} != the reference's 73888")
    if score != plain_score:
        raise AssertionError(f"align_score {score} != fill_plain's {plain_score}")
    print(f"[main path] align_score = {score} on {m} x {n} ({source}); "
          f"fill_plain on the card agrees; {launches} kernel launch(es); "
          f"wall {wall_s:.3f} s")

    # phase 5: the kernel's time at the main path's shape
    times = []
    for i in range(6):  # one warm-up, five timed
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        k0, k1 = bitpal.fill(t, eq, nq)
        e1.record()
        e1.synchronize()
        if i:
            times.append(e0.elapsed_time(e1))
    ms = statistics.median(times)
    err = (bitpal.row_deltas((k0, k1), nq) - bitpal.row_deltas((p0, p1), nq)).abs().max()
    max_abs_err = int(err)
    if max_abs_err != 0:
        raise AssertionError(f"timed kernel run differs from fill_plain by {max_abs_err}")
    cells = m * n
    print(f"[timing] {smi}: bitpal_fill median of 5 {ms:.3f} ms "
          f"({cells / ms / 1e6:.2f} GCUPS; runs {', '.join(f'{x:.3f}' for x in times)} ms); "
          f"fill_plain {plain_ms:.1f} ms ({cells / plain_ms / 1e6:.3f} GCUPS)")

    k1_shape = f"{nq}x{mt}"
    del p0, p1, k0, k1
    gk = {name: dict(max_abs_err=0) for name in GREPLACES}

    def hold_g(name, got, want, nq, g, where):
        """A g-kernel's ``(planes, caps)`` (caps None for ``bitpal_gfill``)
        against ``fill_g_plain``'s on the same inputs: planes word for word,
        captures byte for byte.  Records and returns the largest difference
        of a row delta or a captured enc."""
        (kp, kc), (pp, pc) = got, want
        torch.cuda.synchronize()
        err = int((bitpal.row_deltas(kp, nq, g) - bitpal.row_deltas(pp, nq, g)).abs().max())
        same = all(torch.equal(a, b) for a, b in zip(kp, pp))
        if kc is not None:
            if kc.numel():
                err = max(err, int((kc.long() - pc.long()).abs().max()))
            same = same and torch.equal(kc, pc)
        if err or not same:
            raise AssertionError(f"{name} differs from fill_g_plain at {where}, g = {g} "
                                 f"(max abs err {err})")
        gk[name]["max_abs_err"] = max(gk[name]["max_abs_err"], err)
        return err

    def g_vs_plain(query, text, g, rows):
        """Phase (b): both g-kernels against fill_g_plain on the same
        inputs, planes word for word and captures byte for byte."""
        nq = query.size
        q = torch.from_numpy(query).to(dev)
        t = torch.from_numpy(text).to(dev)
        eq = bitpal._eq_planes(q, nq)
        kp = bitpal.fill_g(t, eq, nq, g)
        cap = bitpal.capture_fill(t, eq, nq, g, rows)
        plain = bitpal.fill_g_plain(t, eq, nq, g, rows)
        where = f"{nq} x {text.size}, rows {rows}"
        hold_g("bitpal_gfill", (kp, None), plain, nq, g, where)
        hold_g("bitpal_capture_fill", cap, plain, nq, g, where)
        return bitpal.kernel_geometry(eq.shape[1])[0]

    def cap_rows_for(nq):
        """Rows at and off word bottoms (64(w+1)), the first and the last."""
        rows = {1, nq, (nq + 1) // 2, 63, 64, 65, 128, 129, 64 * (nq // 128)}
        return sorted(r for r in rows if 1 <= r <= nq)

    t0 = time.perf_counter()
    g_shapes = [(nq, mt, 1, g) for nq, mt in [(1, 1), (63, 2), (64, 300), (65, 300),
                                              (129, 77), (1000, 300)]
                for g in (1, 2, 3, 5, 7)]
    g_shapes += [(2000, 3000, 0, g) for g in (1, 2, 7)]  # codes 0..4
    # past one word per thread: k = 2, 4, 8, 16 words per thread
    g_shapes += [(65600, 40, 1, g) for g in (1, 2, 7)]
    g_shapes += [(200000, 40, 1, 5), (400000, 40, 1, 3)]
    g_shapes += [(1000000, 40, 1, g) for g in (1, 7)]
    ks, n_caps = set(), 0
    for nq, mt, lo, g in g_shapes:
        rows = cap_rows_for(nq)
        ks.add((g, g_vs_plain(rng.integers(lo, 5, nq).astype(np.int8),
                              rng.integers(lo, 5, mt).astype(np.int8), g, rows)))
        n_caps += len(rows)
    print(f"[g-kernels vs plain] bitpal_gfill and bitpal_capture_fill equal to "
          f"fill_g_plain at {len(g_shapes)} shapes, g in 1..7, (g, words per thread) "
          f"{sorted(ks)}; {n_caps} captured rows byte for byte; "
          f"{time.perf_counter() - t0:.1f} s")

    # phase (c): 20,000 x 20,000 against the port's oracle
    a = rng.integers(1, 5, 20000).astype(np.int8)
    b = rng.integers(1, 5, 20000).astype(np.int8)
    for g in (2, 7):
        cfg = ScoringConfig(gap=-g)
        got, want = bitpal.score(a, b, cfg, device="cuda"), oracle.score(a, b, cfg)
        if got != want:
            raise AssertionError(f"20000 x 20000, g = {g}: kernel score {got} != oracle {want}")
        print(f"[g-kernels vs oracle] 20000 x 20000 g = {g} score {got} equal to the oracle's")
    want = oracle.score(a, b)
    t0 = time.perf_counter()
    sc, a1, a2 = tpualign_torch.align(a, b)
    wall = time.perf_counter() - t0
    if not alignment_ok(a, b, a1, a2, oracle.BASES):
        raise AssertionError("20000 x 20000 alignment is not valid")
    if not sc == oracle.alignment_score(a1, a2) == want:
        raise AssertionError(f"20000 x 20000 alignment score {sc} != oracle {want}")
    print(f"[align vs oracle] 20000 x 20000 alignment valid, score {sc} equal to the "
          f"oracle's; wall {wall:.3f} s")

    # phase (d): the binary split alone, 6,000 x 6,000
    a6, b6 = a[:6000], b[:6000]
    reset_counts()
    sc, a1, a2 = tpualign_torch.align(a6, b6)
    counts = read_counts()
    want = oracle.score(a6, b6)
    if not alignment_ok(a6, b6, a1, a2, oracle.BASES) or sc != want:
        raise AssertionError(f"6000 x 6000 alignment invalid or score {sc} != oracle {want}")
    if counts["fill_g"] < 2 or counts["capture_fill"]:
        raise AssertionError(f"6000 x 6000 did not run the binary split alone: {counts}")
    print(f"[align binary split] 6000 x 6000 alignment valid, score {sc} equal to the "
          f"oracle's; launches {counts}")

    # phase (e): this slice's main path, align on the 64gb-shape pair
    reset_counts()
    t0 = time.perf_counter()
    sc, a1, a2 = tpualign_torch.align(s1, s2)
    align_wall = time.perf_counter() - t0
    align_counts = read_counts()
    if align_counts["capture_fill"] < 2:
        raise AssertionError(f"align did not launch bitpal_capture_fill twice: {align_counts}")
    if not alignment_ok(s1, s2, a1, a2, oracle.BASES):
        raise AssertionError("64gb-shape alignment is not valid")
    rescored = oracle.alignment_score(a1, a2)
    if not sc == rescored == score:
        raise AssertionError(f"64gb-shape alignment score {sc} (re-scored {rescored}) "
                             f"!= align_score's {score}")
    print(f"[main path: align] {m} x {n} ({source}): alignment valid, "
          f"{len(a1)} columns, score {sc} equal to align_score's; launches "
          f"{align_counts}; wall {align_wall:.3f} s")
    # the same call once more with the split recorded (host clock), and the
    # root's forward capture fill on its own (CUDA events), held against
    # fill_g_plain at this shape
    stats = {}
    hirschberg.align(s1, s2, device="cuda", stats=stats)
    rows = hirschberg._kway_rows(n)
    q, t = torch.from_numpy(s2).to(dev), torch.from_numpy(s1).to(dev)
    eq = bitpal._eq_planes(q, n)
    cap_ms, cap_runs, cap = cuda_ms(lambda: bitpal.capture_fill(t, eq, n, 1, rows))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = bitpal.fill_g_plain(t, eq, n, 1, rows)
    torch.cuda.synchronize()
    cap_plain_ms = (time.perf_counter() - t0) * 1e3
    cap_err = hold_g("bitpal_capture_fill", cap, plain, n, 1, f"{n} x {m}, {len(rows)} rows")
    gk["bitpal_capture_fill"].update(ms_64gb=cap_ms, plain_ms_64gb=cap_plain_ms,
                                     max_abs_err_64gb=cap_err)
    del cap, plain
    print(f"[main path split] {json.dumps(stats)}; root capture fill {cap_ms:.3f} ms "
          f"(median of 5, {len(rows)} rows; runs {', '.join(f'{x:.3f}' for x in cap_runs)}); "
          f"equal to fill_g_plain at {n} x {m} (planes word for word, captures byte for "
          f"byte, max abs err {cap_err}; plain {cap_plain_ms:.1f} ms)")

    # phase (f): align_score under (1, 0, -2) through K2 at the 64gb shape
    cfg2 = ScoringConfig(gap=-2)
    reset_counts()
    t0 = time.perf_counter()
    score2 = tpualign_torch.align_score(s1, s2, cfg2)
    wall2 = time.perf_counter() - t0
    g_counts = read_counts()
    if g_counts["fill_g"] < 1:
        raise AssertionError(f"align_score at g = 2 did not launch bitpal_gfill: {g_counts}")
    s1_is_query = bitpal._orientation(m, n)
    query, text = (s1, s2) if s1_is_query else (s2, s1)
    nq, mt = query.size, text.size
    qg, tg = torch.from_numpy(query).to(dev), torch.from_numpy(text).to(dev)
    eqg = bitpal._eq_planes(qg, nq)
    cplanes, _ = bitpal.capture_fill(tg, eqg, nq, 2, [nq])
    cscore = bitpal._from_unit(cfg2, m + n, int(bitpal._reduce_score(cplanes, nq, mt, 2)))
    if score2 != cscore:
        raise AssertionError(f"g = 2 score {score2} != the capture kernel's {cscore}")
    g_ms, g_runs, gplanes = cuda_ms(lambda: bitpal.fill_g(tg, eqg, nq, 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = bitpal.fill_g_plain(tg, eqg, nq, 2)
    torch.cuda.synchronize()
    g_plain_ms = (time.perf_counter() - t0) * 1e3
    g_err = hold_g("bitpal_gfill", (gplanes, None), plain, nq, 2, f"{nq} x {mt}")
    pscore = bitpal._from_unit(cfg2, m + n, int(bitpal._reduce_score(plain[0], nq, mt, 2)))
    if score2 != pscore:
        raise AssertionError(f"g = 2 score {score2} != fill_g_plain's {pscore}")
    gk["bitpal_gfill"].update(ms_64gb=g_ms, plain_ms_64gb=g_plain_ms, max_abs_err_64gb=g_err)
    del plain, gplanes
    print(f"[path: align_score g = 2] {m} x {n}: score {score2} equal to the capture "
          f"kernel's final column and to fill_g_plain's (planes word for word, max abs "
          f"err {g_err}; plain {g_plain_ms:.1f} ms); launches {g_counts}; wall {wall2:.3f} s; "
          f"bitpal_gfill {g_ms:.3f} ms (median of 5; runs "
          f"{', '.join(f'{x:.3f}' for x in g_runs)}), {m * n / g_ms / 1e6:.2f} GCUPS")

    # phase (g): kernel and plain times of K2 and K4 at 20,000 x 20,000
    nq_t, mt_t = TIMING_SHAPE
    qt, tt = torch.from_numpy(b).to(dev), torch.from_numpy(a).to(dev)
    eqt = bitpal._eq_planes(qt, nq_t)
    rows_t = hirschberg._kway_rows(nq_t)
    runs = {
        "bitpal_gfill": (2, None, lambda: bitpal.fill_g(tt, eqt, nq_t, 2)),
        "bitpal_capture_fill": (1, rows_t,
                                lambda: bitpal.capture_fill(tt, eqt, nq_t, 1, rows_t)),
    }
    for name, (g, rows, launch) in runs.items():
        kms, kruns, out = cuda_ms(launch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = bitpal.fill_g_plain(tt, eqt, nq_t, g, rows)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        hold_g(name, (out, None) if rows is None else out, plain, nq_t, g,
               f"{nq_t} x {mt_t} (timed run)")
        gk[name].update(ms=kms, plain_ms=pms)
        print(f"[timing] {smi}: {name} g = {g} at {nq_t} x {mt_t}"
              f"{'' if rows is None else f', {len(rows)} captured rows'}: median of 5 "
              f"{kms:.3f} ms ({nq_t * mt_t / kms / 1e6:.2f} GCUPS; runs "
              f"{', '.join(f'{x:.3f}' for x in kruns)} ms); fill_g_plain {pms:.1f} ms")

    for pkg in ("jax", "tpualign"):
        if pkg in sys.modules:
            raise AssertionError(f"the port imported {pkg}")
    glaunches = {"bitpal_gfill": g_counts["fill_g"],
                 "bitpal_capture_fill": align_counts["capture_fill"]}
    print(json.dumps({"kernels": [{
        "name": "bitpal_fill", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms, "shape": k1_shape,
    }] + [{
        "name": name, "route": "cuda", "source": GKERNEL_SOURCE,
        "replaces": GREPLACES[name], "launches": glaunches[name],
        "max_abs_err": gk[name]["max_abs_err"], "ms": gk[name]["ms"],
        "plain_ms": gk[name]["plain_ms"], "shape": f"{nq_t}x{mt_t}",
        "ms_64gb": gk[name]["ms_64gb"], "plain_ms_64gb": gk[name]["plain_ms_64gb"],
        "max_abs_err_64gb": gk[name]["max_abs_err_64gb"],
    } for name in GREPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
