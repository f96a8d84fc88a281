"""Smoke run of the PyTorch/CUDA port (``tpualign_torch``) on one NVIDIA GPU.

Builds the port's CUDA kernel from ``tpualign_torch/csrc`` with ``nvcc``,
holds it against its plain PyTorch version on the card at a range of shapes
(and the scores against the port's NumPy oracle, a plain row scan of the DP
table), then drives the port's main path once: ``tpualign_torch.align_score``
with the default engine and device on a pair of the reference corpus's
largest shape, 64gb (126,440 x 127,240 bases, 16.09e9 DP cells).

    python3 chip_smoke.py [--corpus DIR]

With ``--corpus`` naming the reference's ``bdna`` directory the 64gb pair is
read from it and the score must be the reference's 73888; otherwise a random
pair of that shape (seed 64) is scored and must equal the plain version's
score on the card.  Each phase prints one line; a failure raises and the
exit code is non-zero.  The last two lines are the kernels' JSON and the
device JSON.  Exits non-zero without a CUDA device.  Imports nothing of JAX
or of the JAX package ``tpualign``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

PAIR_LENGTHS = (126440, 127240)  # bdna/64gb-{1,2}.bdna
PAIR_SEED = 64
KERNEL_SOURCE = "tpualign_torch/csrc/bitpal_fill.cu"
REPLACES = "tpualign/ops/bitpal.py:283"  # _bitpal_kernel_body_lean


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
    from tpualign_torch.ops import bitpal, oracle

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
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    print(f"[build] {os.path.relpath(lib_path)} in {build_s:.1f} s; ptxas: "
          + " | ".join(ptxas))

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
        ks = int(bitpal._reduce_score(k0, k1, nq, mt))
        if ks != int(bitpal._reduce_score(p0, p1, nq, mt)):
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
    bitpal.fill.launches = 0
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
    plain_score = int(bitpal._reduce_score(p0, p1, nq, mt))  # unit scoring
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
    err = (bitpal.row_deltas(k0, k1, nq) - bitpal.row_deltas(p0, p1, nq)).abs().max()
    max_abs_err = int(err)
    if max_abs_err != 0:
        raise AssertionError(f"timed kernel run differs from fill_plain by {max_abs_err}")
    cells = m * n
    print(f"[timing] {smi}: bitpal_fill median of 5 {ms:.3f} ms "
          f"({cells / ms / 1e6:.2f} GCUPS; runs {', '.join(f'{x:.3f}' for x in times)} ms); "
          f"fill_plain {plain_ms:.1f} ms ({cells / plain_ms / 1e6:.3f} GCUPS)")

    for pkg in ("jax", "tpualign"):
        if pkg in sys.modules:
            raise AssertionError(f"the port imported {pkg}")
    print(json.dumps({"kernels": [{
        "name": "bitpal_fill", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
