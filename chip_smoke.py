"""Smoke run of the PyTorch/CUDA port (``tpualign_torch``) on one NVIDIA GPU.

Builds the port's CUDA kernels from ``tpualign_torch/csrc`` with ``nvcc``
(``bitpal_gfill``: K1's port at g = 1 and K2's at g >= 2;
``bitpal_capture_fill``, K4's; ``bitpal_rc_fill``, K3a's;
``bitpal_rc_chunk``, K3b's; ``bitpal_gfill_chunk``, K4's state in and
out; ``bitpal_batch_fill``, K5's; ``band_fill``,
K6's; ``band_capture_fill``, K7's, and ``band_batch_fill``, its batch
contract; ``diag_fill``, K8's; ``diag_ckpt_fill``, K9's), holds each against
its plain PyTorch version on
the card at a range of shapes (and the scores and alignments against the
port's NumPy oracle), then drives the port's paths through its public
entry points, each with the launch counts set to 0 just before it and read
just after, and holds each path's kernel against its plain version at that
path's shape:

- ``tpualign_torch.align_score`` at the default scoring on the 64gb-shape
  pair (126,440 x 127,240 bases, 16.09e9 DP cells; ``bitpal_gfill``, g = 1);
- ``tpualign_torch.align`` at the default scoring on that pair: the
  bit-parallel Hirschberg split over the capture kernel, then leaf walks
  on the host;
- ``tpualign_torch.align_score`` under ``ScoringConfig(gap=-2)`` on that
  pair (``bitpal_gfill``, g = 2);
- ``tpualign_torch.align_score`` under the CLI's Smith-Waterman scoring
  (2, -1, -2) on that pair (``band_fill``), and under ``impl="pallas"``
  (``diag_fill``, K8's port on the same strip pipeline), both held to one
  plain SW fill;
- ``tpualign_torch.align`` under that scoring on that pair: the locate,
  the anchored start locate and the core's split, all over
  ``band_capture_fill``, then leaf walks on the host;
- ``tpualign_torch.align`` under affine gaps (2, -1, open -5, extend -2),
  global and local, on that pair (this slice's main path): Myers-Miller
  over ``band_capture_fill``'s affine last rows (H, F), after the local
  locate and anchored start locate, then leaf walks on the host; each
  alignment scored against ``align_score``'s (``band_fill``), and the
  root's forward fill held against its plain version at its full shape;
- at 20,000 x 20,000, ``align_score`` under a DNA matrix (global),
  semiglobal, infix, affine (-5, -2) global and local, a positive-mismatch
  affine local (``band_fill``), and ``impl="pallas"`` global
  (``diag_fill``); ``align`` under the DNA matrix, semiglobal, infix, SW,
  positive-mismatch SW, ``impl="pallas"``, a family config that the
  bit-parallel split refuses, and affine global, local, positive-mismatch
  local, semiglobal, infix and with the DNA matrix (``band_capture_fill``);
- ``tpualign_torch.align_score_batch`` (this slice's main path) on the
  repo's serving demo (``examples/serve_batch.py``: 16 pairs of 5,000 to
  25,000 bases) under (1, 0, -1) and (1, 0, -2) (``bitpal_batch_fill``,
  K5's port) and under SW (2, -1, -2) and affine (2, -1, open -5,
  extend -2) (``band_batch_fill``, K7's batch contract), and on 8,192
  short-read candidate checks (a 150-base read against a 150- to 350-base
  window) under infix (2, -1, -2) and (1, 0, -1): one launch each, the
  kernel held against its batched plain version at that shape, every score
  against the port's per-pair ``align_score``; every batch instantiation
  against its plain version on small ragged batches (K5: short pairs as
  segments of a warp, every segment width, and long ones as one-warp bands
  with a ring a pair, one to five bands, at the planner's blocks, one
  block and fewer blocks than bands over rings of 2 rows);
- ``tpualign_torch.align_score`` (this slice's main path) on the family's
  short-query and long-text routes, which follow ``tpualign``'s rule:
  20,000 x 20,000 and 1,000,000 x 10,000 at (1, 0, -1) through
  ``bitpal_rc_fill`` (K3a's port, 4 columns a step), 4,000,000 x 2,000
  and 2,000,000 x 200 through ``bitpal_rc_chunk`` (K3b's, a launch a
  chunk), 2,000,000 x 100,000 at (1, 0, -2) through ``bitpal_gfill_chunk``
  (K4's state in and out); each held word for word against a kernel
  already held (K1's or K2's ``bitpal_gfill``, or one ``bitpal_rc_fill``
  launch), every instantiation of the three against its plain version on
  small shapes chunk by chunk, and K3a and K3b at 2,000 x 200,000 against
  one plain run.  K1's own 20,000 x 20,000 hold runs with
  ``cols_per_step=1``;
- the checkpointed fill ``diag_ckpt_fill`` (K9's port, on the band
  fills' strip pipeline; this slice's main path):
  ``traceback_diag.align_diag`` at (1, 0, -1) on the 64gb-shape pair,
  valid, re-scoring to ``align_score``'s and with the strings of
  ``align(..., EngineConfig(impl="xla"))`` (the checkpointed row-scan
  traceback), and ``tpualign_torch.align`` under positive-mismatch SW (3,
  1, -2) on that pair (one launch); the kernel held word for word against
  ``ckpt_plain`` (run on the card) at both, ``align_diag`` at 20,000 x
  20,000 under (1, 0, -1) and SW (2, -1, -2), every config (NW, SW,
  positive mismatch, positive gap) on small shapes at strides 8, 16, 24
  and 1024, and where races would show (one block, blocks past the
  strips, fewer blocks than strips over a ring of 2 rows, 20 launches
  each); a sweep of its geometry at the 64gb shape;
- the pipeline's ring budget, a share of the card's free memory
  (``band.ring_budget``): the planner's plans at 5,000 x 140,000,000
  (linear) and 5,000 x 70,000,000 (affine), and ``align_score`` under SW
  (2, -1, -2) of a 256-base query planted whole in a text of 134,217,728
  bases (2 ring rows past 1 GiB), one ``band_fill`` launch, score 512;
- the bit-parallel fill's pipeline (``bitpal_gfill``, ``bitpal_capture_fill``:
  one launch a fill, bands of words over many blocks of one warp, each
  band's bottom h_out stream handed down through a ring with progress
  flags): held word for word against ``fill_g_plain`` where races would
  show, at bands past the blocks, blocks past the bands, one block, rings
  of 2 rows, captured rows on the bands' first and last words, B = 2, 3
  and 4, 20 launches each (phase (l)); every fill above runs the
  planner's blocks (``bitpal.pipeline_plan``), and a sweep of the blocks
  prints at the 64gb shape;
- K6's and K7's strip pipeline (``band_fill``, ``band_capture_fill``,
  ``band_capture_affine``: one launch a fill, strips over many blocks,
  each strip's bottom row handed down through a ring with progress
  flags): held where races would show, at one block, blocks past the
  strips, fewer blocks than strips over a ring of 2 rows, a partial last
  strip and a table whose cells all tie, 20 launches each against one
  plain run (phase (a3)); every 64gb-shape fill above runs the planner's
  geometry (``band.pipeline_geometry``), and a small sweep of K6 SW's
  geometry (threads x blocks, the one-block schedule beside it) prints at
  the 64gb shape and at 20,000 x 20,000.

With ``--corpus`` naming the reference's ``bdna`` directory the 64gb pair is
read from it and the scores must be the reference's 73888 and the JAX
package's Smith-Waterman pin 119785; otherwise a random pair of that shape
(seed 64) is scored and must equal the plain versions' scores on the card.
Each phase prints lines tagged with its name; a failure raises and the exit
code is non-zero.  The last two lines are the kernels' JSON and the device
JSON.  Exits non-zero without a CUDA device.  Imports nothing of JAX or of
the JAX package ``tpualign``.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
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
SW_PIN = 119785  # tpualign/golden.py: the 64gb corpus pair under (2, -1, -2) local
GKERNEL_SOURCE = "tpualign_torch/csrc/bitpal_gfill.cu"
REPLACES = "tpualign/ops/bitpal.py:283"  # _bitpal_kernel_body_lean (K1)
GREPLACES = {
    "bitpal_gfill": "tpualign/ops/bitpal.py:556",  # _g_kernel_body (K2)
    "bitpal_capture_fill": "tpualign/ops/bitpal.py:1038",  # _chunk_kernel_body (K4)
}
#: K6's and K7's bodies: one fill template; entries in band_fill.cu and
#: band_capture_affine.cu
BAND_SOURCE = "tpualign_torch/csrc/band_fill.cuh"
BAND_REPLACES = "tpualign/ops/band.py:171"  # _band_kernel_body (K6)
DIAG_SOURCE = "tpualign_torch/csrc/diag_fill.cu"
DIAG_REPLACES = "tpualign/ops/pallas_diag.py:201"  # _diag_kernel_body (K8)
CAPTURE_REPLACES = "tpualign/ops/band_align.py:103"  # _strip_kernel_body (K7)
BATCH_SOURCE = "tpualign_torch/csrc/bitpal_batch.cu"
BATCH_REPLACES = "tpualign/ops/bitpal.py:773"  # _batch_kernel_body (K5)
BAND_BATCH_SOURCE = "tpualign_torch/csrc/band_batch.cu"
#: bitpal_gfill (1 word a lane at 2, 3 and 4 planes, 2 at 2 and 3, x
#: capture or not),
#: band_fill, band_capture_fill (40 linear, 36 affine: local
#: stops at 8 rows a thread), diag_fill (5 rows per thread x global,
#: local), bitpal_batch_fill (5 segment widths and the bands x 3 plane
#: counts), band_batch_fill (40 less local affine at 16
#: rows a thread), bitpal_rc_kernel (3 rc, one word a lane),
#: bitpal_chunk_kernel (rc 2..4 at 2 planes and rc 1 at 2..4 planes),
#: diag_ckpt_kernel (5 rows per thread x global, local)
N_INSTANTIATIONS = 6 + 40 + 76 + 10 + 18 + 38 + 3 + 6 + 10
#: the least time of a kernel's work: bytes over the HBM rate, operations
#: over the table's rate for 32-bit operations outside the tensor cores
#: (the float32 rate; the table lists no int32 rate), NVIDIA H100 SXM
HBM_BYTES_S = 3.35e12
OPS_S = 67e12


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
            base = re.search(r"((?:bitpal_g|band_|diag_)fill_kernel|(?:bitpal|band)_batch_kernel"
                             r"|bitpal_(?:rc|chunk)_kernel|diag_ckpt_kernel)", mangled)
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


def core_ok(s1, s2, a1, a2, bases):
    """A local or ends-free alignment: the aligned strings are two columns
    of equal length, no column holds two gaps, and, gaps stripped, each is
    a substring of its sequence (codes 1..4)."""
    gap = ord("-")
    b1 = np.frombuffer(a1.encode(), np.uint8)
    b2 = np.frombuffer(a2.encode(), np.uint8)
    t1 = "".join(bases[c] for c in s1)
    t2 = "".join(bases[c] for c in s2)
    return (len(a1) == len(a2) and not ((b1 == gap) & (b2 == gap)).any()
            and a1.replace("-", "") in t1 and a2.replace("-", "") in t2)


def bound(nbytes, ops):
    """``(bound_ms, bound_by)``: the larger of the bytes' time at the HBM
    rate and the operations' time at the card's rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, ops / OPS_S * 1e3
    return (by_bytes, "bytes") if by_bytes > by_ops else (by_ops, "operations")


def band_ops(cfg, cells, cell=False):
    """Integer operations of the strip recurrence over ``cells`` cells:
    linear H = max(diag + s, max(up, left) + g) is 4, affine (E, F and
    H) 9, the local floor 1 more, a located cell's compare 1 more."""
    per = (9 if cfg.is_affine else 4) + (1 if cfg.is_local else 0) + (1 if cell else 0)
    return per * cells


RC_SOURCE = "tpualign_torch/csrc/bitpal_rc.cu"
RC_REPLACES = {
    "bitpal_rc_fill": "tpualign/ops/bitpal.py:677",  # _rc_kernel_body (K3a)
    "bitpal_rc_chunk": "tpualign/ops/bitpal.py:1449",  # _rc_chunk_kernel_body (K3b)
    "bitpal_gfill_chunk": "tpualign/ops/bitpal.py:1038",  # _chunk_kernel_body (K4)
}
#: (text, query) lengths of the staggered fills' phase
RC_SHAPES = dict(moderate=(200000, 2000), k4_plain=(30000, 2000), k3a=(1000000, 10000),
                 k3b=(4000000, 2000), short=(2000000, 200), k4=(2000000, 100000))
#: the small holds' launches: (blocks, ring cut to 2 rows), the planner's
#: (a band a block) and blocks forced below the bands
RC_BLOCKS = [(None, False), (1, True), (2, True), (3, True)]


def rc_phase(ctx, shapes, a20, b20, want20):
    """The staggered fills of ``csrc/bitpal_rc.cu`` (K3a's port
    ``bitpal_rc_fill``, K3b's ``bitpal_rc_chunk``, K4's state in and out
    ``bitpal_gfill_chunk``): every instantiation against its plain version
    on small shapes, chunk by chunk at odd chunk lengths; K3a and K3b at a
    moderate shape and ``bitpal_gfill_chunk`` at a smaller one against one
    plain run; then ``align_score`` on each route that runs them, with the
    counts set to 0 just before it, its kernel held word for word against
    a kernel already held (K1's ``fill_g``, ``bitpal_rc_fill``, K2's
    ``fill_g``).  ``ctx``: the smoke's ``dev``, ``rng``, ``smi``,
    ``cuda_ms``, ``host_ms``, ``sync``, ``reset_counts``, ``read_counts``,
    ``only``.  Returns the kernels' entries of the ``kernels`` line."""
    import torch

    import tpualign_torch
    from tpualign_torch.config import ScoringConfig
    from tpualign_torch.ops import band, bitpal

    dev, rng, smi = ctx.dev, ctx.rng, ctx.smi
    t_phase = time.perf_counter()
    held = {name: dict(max_abs_err=0) for name in RC_REPLACES}
    cpu = torch.device("cpu")

    def hold(name, got, want, nq, g, where):
        """``(planes, hand)`` (hand None for final planes) word for word."""
        ctx.sync()
        gp, wp = [x.to(cpu) for x in got[0]], [x.to(cpu) for x in want[0]]
        err = int((bitpal.row_deltas(gp, nq, g) - bitpal.row_deltas(wp, nq, g)).abs().max())
        same = all(torch.equal(x, y) for x, y in zip(gp, wp))
        if got[1] is not None:
            gh, wh = got[1].to(cpu).long(), want[1].to(cpu).long()
            err = max(err, int((gh - wh).abs().max()))
            same = same and torch.equal(gh, wh)
        if err or not same:
            raise AssertionError(f"{name} differs at {where} (max abs err {err})")
        held[name]["max_abs_err"] = max(held[name]["max_abs_err"], err)

    def inputs(mt, nq, lo=1):
        text = rng.integers(lo, 5, mt).astype(np.int8)
        query = rng.integers(lo, 5, nq).astype(np.int8)
        t, q = torch.from_numpy(text).to(dev), torch.from_numpy(query).to(dev)
        return t, bitpal._eq_planes(q, nq), text, query

    def shallow_ring(steps):
        """``band.ring_budget`` cut to a ring of 2 rows of ``steps`` bytes;
        restore with ``band.ring_budget = ring_budget``."""
        band.ring_budget = lambda *a, **kw: 2 * steps

    def chunk_holds(t, eq, nq, g, rc, lengths, blocks=None, shallow=False):
        """The chunk entry chunk by chunk (chunk lengths cycled) from the
        boundary to the last step, each state held against the plain
        chunk's from the same state, each launch over ``blocks`` (and with
        ``shallow`` a ring of 2 rows); returns the plain's final state,
        the plain's host ms and the chunks."""
        name = "bitpal_rc_chunk" if rc > 1 else "bitpal_gfill_chunk"
        entry = bitpal.fill_rc_chunk if rc > 1 else bitpal.fill_g_chunk
        nw, mt = eq.shape[1], t.shape[0]
        tc, eqc = t.to(cpu), eq.to(cpu)
        edges, t0, i = [], 0, 0
        while t0 < bitpal.total_steps(mt, nw, rc):
            edges.append((t0, lengths[i % len(lengths)]))
            t0, i = t0 + lengths[i % len(lengths)], i + 1
        t1 = time.perf_counter()
        plain = [bitpal.init_state(nw, g, cpu)]
        for t0, steps in edges:
            plain.append(bitpal.chunk_plain(tc, eqc, nq, g, rc, t0, steps, plain[-1]))
        plain_ms = (time.perf_counter() - t1) * 1e3
        state = bitpal.init_state(nw, g, dev)
        ring_budget = band.ring_budget
        try:
            for (t0, steps), want in zip(edges, plain[1:]):
                if shallow:
                    shallow_ring(steps)
                state = (entry(t, eq, nq, rc, t0, steps, state, blocks) if rc > 1
                         else entry(t, eq, nq, g, t0, steps, state, blocks))
                hold(name, state, want, nq, g, f"{nq} x {mt}, steps {t0 + 1}..{t0 + steps}, "
                                              f"rc {rc}, g {g}, blocks {blocks}, ring of 2 "
                                              f"{shallow}")
        finally:
            band.ring_budget = ring_budget
        return plain[-1], plain_ms, len(edges)

    # small shapes: every instantiation of bitpal_rc_fill and bitpal_rc_chunk
    # (rc 2..4) and of bitpal_gfill_chunk (B = 2, 3, 4), at one band and at
    # five over the planner's blocks and over 1, 2 and 3 blocks with rings
    # of 2 rows; codes 0..4; chunk lengths 1, 31, 32 and 33 (edges inside the
    # bands' dead ramps, band b's first 32b steps) and odd ones
    n_small = 0
    for kind, (blocks, shallow), bands in itertools.product(
            ("rc", "g2", "g3", "g4"), RC_BLOCKS, (1, 5)):
        for sub in ((2, 3, 4) if kind == "rc" else (None,)):
            rc = sub or 1
            g = 1 if kind in ("rc", "g2") else int(rng.choice({"g3": (2, 3),
                                                                "g4": (4, 5, 6, 7)}[kind]))
            nw = int(rng.integers(32 * bands - 31, 32 * bands + 1))
            nq = 64 * nw - int(rng.integers(0, 64))
            t, eq, _, _ = inputs(int(rng.integers(30, 150)), nq, lo=0)
            lengths = [1, 31, 32, 33] + [2 * int(x) + 1 for x in rng.integers(0, 40, 2)]
            final, _, _ = chunk_holds(t, eq, nq, g, rc, lengths, blocks, shallow)
            if rc > 1:
                ring_budget = band.ring_budget
                if shallow:
                    shallow_ring(bitpal.total_steps(t.shape[0], nw, rc))
                try:
                    got = bitpal.fill_rc(t, eq, nq, rc, blocks)
                finally:
                    band.ring_budget = ring_budget
                hold("bitpal_rc_fill", (got, None), (final.planes, None), nq, 1,
                     f"{nq} x {t.shape[0]}, rc {rc}, blocks {blocks}, ring of 2 {shallow}")
            n_small += 1
    print(f"[staggered fills vs plain] {n_small} small cases: bitpal_rc_fill equal to the "
          f"plain fill and bitpal_rc_chunk and bitpal_gfill_chunk to chunk_plain chunk by "
          f"chunk (chunk lengths 1, 31, 32, 33 and odd; every rc and B; one band and five; "
          f"the planner's blocks and 1, 2 and 3 blocks over rings of 2 rows; codes 0..4); "
          f"{time.perf_counter() - t_phase:.1f} s")

    # moderate shapes: one plain run in chunks holds K3a's one launch and
    # K3b's chunks (rc 4), and K4's chunks at g = 2
    mt, nq = shapes["moderate"]
    t, eq, _, _ = inputs(mt, nq)
    nw = eq.shape[1]
    steps = -(-bitpal.total_steps(mt, nw, 4) // 4) | 1  # four chunks, odd length
    final, rc_plain_ms, n_chunks = chunk_holds(t, eq, nq, 1, 4, [steps])
    rc_mod_ms, rc_mod_runs, planes = ctx.cuda_ms(lambda: bitpal.fill_rc(t, eq, nq, 4))
    hold("bitpal_rc_fill", (planes, None), (final.planes, None), nq, 1, f"{nq} x {mt}")
    mt4, nq4 = shapes["k4_plain"]
    t4, eq4, _, _ = inputs(mt4, nq4)
    steps4 = -(-bitpal.total_steps(mt4, eq4.shape[1], 1) // 3) | 1
    final4, g_plain_ms, n4 = chunk_holds(t4, eq4, nq4, 2, 1, [steps4])
    hold("bitpal_gfill_chunk", (bitpal.fill_g(t4, eq4, nq4, 2), None), (final4.planes, None),
         nq4, 2, f"{nq4} x {mt4}, bitpal_gfill")
    print(f"[staggered fills, moderate] {nq} x {mt} rc 4: bitpal_rc_fill and {n_chunks} "
          f"bitpal_rc_chunk chunks of {steps} steps equal to one plain run (chunk_plain "
          f"{rc_plain_ms:.1f} ms); {nq4} x {mt4} g = 2: {n4} bitpal_gfill_chunk chunks equal "
          f"to chunk_plain ({g_plain_ms:.1f} ms), the last chunk's planes to bitpal_gfill's; "
          f"bitpal_rc_fill median of 5 {rc_mod_ms:.3f} ms (runs {', '.join(f'{x:.3f}' for x in rc_mod_runs)})")
    held["bitpal_rc_fill"].update(plain_ms=rc_plain_ms, plain_shape=f"{nq}x{mt}")
    held["bitpal_rc_chunk"].update(plain_ms=rc_plain_ms, plain_shape=f"{nq}x{mt}")
    held["bitpal_gfill_chunk"].update(plain_ms=g_plain_ms, plain_shape=f"{nq4}x{mt4}")

    def plan_of(wrapper):
        """The plan of the wrapper's last launch, as it ran."""
        plan = wrapper.last_plan
        return dict(blocks=plan.blocks, bands=plan.bands, depth=plan.depth)

    def words_bound(mt, nw, g, state_bytes=0):
        """Bytes: the text, the match planes, the final planes (and the
        chunks' states); operations: ~25 64-bit operations a word-column at
        g = 1 (50 at 3 or 4 planes), two 32-bit ones each."""
        B = bitpal.n_planes(g)
        return bound(mt + (bitpal.ALPHABET + B) * nw * 8 + state_bytes,
                     mt * nw * (25 if g == 1 else 50) * 2)

    def counted(name, s1, s2, cfg, kernel, launches=None):
        ctx.reset_counts()
        t0 = time.perf_counter()
        got = tpualign_torch.align_score(s1, s2, cfg)
        wall = time.perf_counter() - t0
        counts = ctx.read_counts()
        n = counts[kernel]
        if n < 1 or sum(counts.values()) != n or (launches is not None and n != launches):
            raise AssertionError(f"{name}: align_score did not run {kernel} alone "
                                 f"({launches} launches): {counts}")
        return got, counts, wall

    def on_route(s1, s2, cfg=None):
        kind, rc, s1q = bitpal.route(s1.size, s2.size, cfg or ScoringConfig())
        q, x = (s1, s2) if s1q else (s2, s1)
        qd, xd = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
        return kind, rc, xd, bitpal._eq_planes(qd, q.size), q.size, x.size

    def fmt(ms, cells):
        return f"{ms:.3f} ms ({cells / ms / 1e6:.2f} GCUPS)"

    # 20,000 x 20,000 through align_score: K3a's route now
    got, counts, wall = counted("20k", a20, b20, ScoringConfig(), "fill_rc", 1)
    if got != want20:
        raise AssertionError(f"{a20.size} x {b20.size} through K3a: {got} != oracle {want20}")
    kind, rc, x, eq, nq, mt = on_route(a20, b20)
    ms20, _, p20 = ctx.cuda_ms(lambda: bitpal.fill_rc(x, eq, nq, rc))
    k1_20, _, k1p = ctx.cuda_ms(lambda: bitpal.fill_g(x, eq, nq, 1))
    hold("bitpal_rc_fill", (p20, None), (k1p, None), nq, 1, f"{nq} x {mt} against fill_g")
    b20_ms, b20_by = words_bound(mt, eq.shape[1], 1)
    print(f"[path: align_score K3a] {mt} x {nq}: score {got} equal to the oracle's; "
          f"launches {counts}; wall {wall:.3f} s")
    print(f"[timing] {smi}: {nq} x {mt}: bitpal_rc_fill rc {rc} {fmt(ms20, mt * nq)}; "
          f"cols_per_step=1 (K1, bitpal_gfill g = 1) {fmt(k1_20, mt * nq)}; bound "
          f"{b20_ms:.4f} ms ({b20_by})")

    # 1,000,000 x 10,000 through align_score: K3a, 10k on the bit axis; its
    # planes against K1's on the same query and text
    mt, nq = shapes["k3a"]
    s1, s2 = (rng.integers(1, 5, k).astype(np.int8) for k in (mt, nq))
    got, counts3a, wall = counted("K3a", s1, s2, ScoringConfig(), "fill_rc", 1)
    kind, rc, x, eq, nq, mt = on_route(s1, s2)
    if kind != "rc":
        raise AssertionError(f"{s1.size} x {s2.size} took {kind}")
    rc_ms, rc_runs, planes = ctx.cuda_ms(lambda: bitpal.fill_rc(x, eq, nq, rc), runs=3)
    plan3a = plan_of(bitpal.fill_rc)
    k1_ms, _, k1p = ctx.cuda_ms(lambda: bitpal.fill_g(x, eq, nq, 1), runs=1)
    hold("bitpal_rc_fill", (planes, None), (k1p, None), nq, 1, f"{nq} x {mt} against fill_g")
    if got != int(bitpal._reduce_score(k1p, nq, mt)):
        raise AssertionError(f"{mt} x {nq}: align_score {got} != fill_g's score")
    block1_ms, _, wplanes = ctx.cuda_ms(lambda: bitpal.fill_rc(x, eq, nq, rc, 1), runs=3)
    hold("bitpal_rc_fill", (wplanes, None), (k1p, None), nq, 1, f"{nq} x {mt}, one block")
    del planes, wplanes, k1p
    # cols_per_step=1: K1 on the port's own orientation (1M on the bit axis)
    own = bitpal._orientation(s1.size, s2.size)
    q1, x1 = (s1, s2) if own else (s2, s1)
    xq = torch.from_numpy(x1).to(dev)
    eq1 = bitpal._eq_planes(torch.from_numpy(q1).to(dev), q1.size)
    own_ms, _, _ = ctx.cuda_ms(lambda: bitpal.fill_g(xq, eq1, q1.size, 1), runs=1)
    del eq1, xq
    b3a = words_bound(mt, eq.shape[1], 1)
    print(f"[path: align_score K3a] {mt} x {nq}: score {got} equal to fill_g's on the same "
          f"query and text, planes word for word; launches {counts3a}; wall {wall:.3f} s")
    print(f"[timing] {smi}: {nq} x {mt}: bitpal_rc_fill rc {rc} ({plan3a}) "
          f"median of 3 {fmt(rc_ms, mt * nq)} (runs {', '.join(f'{v:.3f}' for v in rc_runs)}); "
          f"one block (the bands in turn) {fmt(block1_ms, mt * nq)}; bitpal_gfill g = 1 on the same "
          f"orientation {fmt(k1_ms, mt * nq)}; cols_per_step=1 (K1 on the port's orientation, "
          f"{q1.size} rows) {fmt(own_ms, mt * nq)}; bound {b3a[0]:.4f} ms ({b3a[1]})")
    held["bitpal_rc_fill"].update(launches=counts3a["fill_rc"], ms=rc_ms, shape=f"{nq}x{mt}",
                                  bound_ms=b3a[0], bound_by=b3a[1], library_ms=None, **plan3a,
                                  one_block_ms=block1_ms, k1_same_orientation_ms=k1_ms,
                                  k1_own_orientation_ms=own_ms, ms_20k=ms20, k1_ms_20k=k1_20)

    # 4,000,000 x 2,000 through align_score: K3b's chunks; 3 chunks against
    # one bitpal_rc_fill launch, and the route's chunks timed against it
    mt, nq = shapes["k3b"]
    s1, s2 = (rng.integers(1, 5, k).astype(np.int8) for k in (mt, nq))
    kind, rc, x, eq, nq, mt = on_route(s1, s2)
    nw = eq.shape[1]
    t_steps = bitpal.chunk_steps(rc)
    n_route = -(-bitpal.total_steps(mt, nw, rc) // t_steps)
    got, counts3b, wall = counted("K3b", s1, s2, ScoringConfig(), "fill_rc_chunk", n_route)
    one_ms, _, one = ctx.cuda_ms(lambda: bitpal.fill_rc(x, eq, nq, rc), runs=3)
    three = -(-bitpal.total_steps(mt, nw, rc) // 3)
    hold("bitpal_rc_chunk", (bitpal.fill_chunked(x, eq, nq, 1, rc, three), None), (one, None),
         nq, 1, f"{nq} x {mt}, 3 chunks against one bitpal_rc_fill")
    ch_ms, ch_runs, chunked = ctx.cuda_ms(lambda: bitpal.fill_chunked(x, eq, nq, 1, rc, t_steps),
                                          runs=3)
    plan3b = plan_of(bitpal.fill_rc_chunk)
    hold("bitpal_rc_chunk", (chunked, None), (one, None), nq, 1,
         f"{nq} x {mt}, {n_route} chunks against one bitpal_rc_fill")
    if got != int(bitpal._reduce_score(one, nq, mt)):
        raise AssertionError(f"{mt} x {nq}: align_score {got} != bitpal_rc_fill's score")
    b3b = words_bound(mt, nw, 1, n_route * 2 * (2 * nw * 8 + nw))
    print(f"[path: align_score K3b] {mt} x {nq}: score {got} equal to one bitpal_rc_fill "
          f"launch's; launches {counts3b} ({n_route} chunks of {t_steps} steps); 3 chunks "
          f"and the route's {n_route} equal to one launch word for word; wall {wall:.3f} s")
    print(f"[timing] {smi}: {nq} x {mt}: {n_route} bitpal_rc_chunk chunks median of 3 "
          f"{fmt(ch_ms, mt * nq)} (runs {', '.join(f'{v:.3f}' for v in ch_runs)}); one "
          f"bitpal_rc_fill launch {fmt(one_ms, mt * nq)}; chunking costs "
          f"{ch_ms / one_ms - 1:+.4f}; bound {b3b[0]:.4f} ms ({b3b[1]})")
    held["bitpal_rc_chunk"].update(launches=counts3b["fill_rc_chunk"], ms=ch_ms,
                                   shape=f"{nq}x{mt}", bound_ms=b3b[0], bound_by=b3b[1],
                                   library_ms=None, one_launch_ms=one_ms,
                                   **plan3b)
    del one, chunked

    # 2,000,000 x 200 (ROADMAP item 5): K3b's chunks against K1
    mt, nq = shapes["short"]
    s1, s2 = (rng.integers(1, 5, k).astype(np.int8) for k in (mt, nq))
    kind, rc, x, eq, nq, mt = on_route(s1, s2)
    got, counts_s, wall = counted("2M x 200", s1, s2, ScoringConfig(), "fill_rc_chunk")
    k1p = bitpal.fill_g(x, eq, nq, 1)
    hold("bitpal_rc_chunk", (bitpal.fill_chunked(x, eq, nq, 1, rc, bitpal.chunk_steps(rc)), None),
         (k1p, None), nq, 1, f"{nq} x {mt} against fill_g")
    if got != int(bitpal._reduce_score(k1p, nq, mt)):
        raise AssertionError(f"{mt} x {nq}: align_score {got} != fill_g's score")
    print(f"[path: align_score K3b short query] {mt} x {nq}: score {got} equal to fill_g's, "
          f"planes word for word; launches {counts_s}; wall {wall:.3f} s")

    # 2,000,000 x 100,000 at (1, 0, -2) through align_score: K4's chunks
    # with their state, against one bitpal_gfill launch at g = 2
    mt, nq = shapes["k4"]
    cfg2 = ScoringConfig(gap=-2)
    s1, s2 = (rng.integers(1, 5, k).astype(np.int8) for k in (mt, nq))
    kind, rc, x, eq, nq, mt = on_route(s1, s2, cfg2)
    nw = eq.shape[1]
    t_steps = bitpal.chunk_steps(1)
    n_route = -(-bitpal.total_steps(mt, nw, 1) // t_steps)
    got, counts4, wall = counted("K4", s1, s2, cfg2, "fill_g_chunk", n_route)
    ch4_ms, _, chunked = ctx.cuda_ms(lambda: bitpal.fill_chunked(x, eq, nq, 2, 1, t_steps),
                                     runs=1)
    plan4 = plan_of(bitpal.fill_g_chunk)
    one4_ms, _, one = ctx.cuda_ms(lambda: bitpal.fill_g(x, eq, nq, 2), runs=1)
    hold("bitpal_gfill_chunk", (chunked, None), (one, None), nq, 2,
         f"{nq} x {mt}, {n_route} chunks against one bitpal_gfill")
    want = bitpal._from_unit(cfg2, mt + nq, int(bitpal._reduce_score(one, nq, mt, 2)))
    if got != want:
        raise AssertionError(f"{mt} x {nq} g = 2: align_score {got} != bitpal_gfill's {want}")
    b4 = words_bound(mt, nw, 2, n_route * 2 * (3 * nw * 8 + nw))
    print(f"[path: align_score K4 chunks] {mt} x {nq} (1, 0, -2): score {got} equal to one "
          f"bitpal_gfill launch's; launches {counts4} ({n_route} chunks of {t_steps} steps), "
          f"planes word for word; wall {wall:.3f} s")
    print(f"[timing] {smi}: {nq} x {mt} g = 2: {n_route} bitpal_gfill_chunk chunks "
          f"{fmt(ch4_ms, mt * nq)}; one bitpal_gfill launch {fmt(one4_ms, mt * nq)}; chunking "
          f"costs {ch4_ms / one4_ms - 1:+.4f}; bound {b4[0]:.4f} ms ({b4[1]})")
    held["bitpal_gfill_chunk"].update(launches=counts4["fill_g_chunk"], ms=ch4_ms,
                                      shape=f"{nq}x{mt}", bound_ms=b4[0], bound_by=b4[1],
                                      library_ms=None, one_launch_ms=one4_ms,
                                      **plan4)
    print(f"[phase i] {time.perf_counter() - t_phase:.1f} s")
    return [{"name": name, "route": "cuda", "source": RC_SOURCE, "replaces": RC_REPLACES[name],
             **held[name]} for name in RC_REPLACES]


CKPT_SOURCE = "tpualign_torch/csrc/diag_ckpt.cu"
CKPT_REPLACES = "tpualign/ops/pallas_diag.py:242"  # _diag_ckpt_kernel_body (K9)
#: (text, query) lengths and strides of phase (j)'s small holds: n < m,
#: n > m, one column, one row, n past 1024 threads (n < m, n > m)
CKPT_SHAPES = ((300, 200), (200, 300), (1, 400), (400, 1), (1500, 1100), (700, 1300))
CKPT_STRIDES = (8, 16, 24, 1024)
#: K9's race cases on the strip pipeline run PIPE_RACES at 1,500 columns x
#: 1,037 rows, stride 24
CKPT_RACE_SHAPE = (1500, 1037)
#: K9 NW's sweep at the 64gb shape (k, threads; the planner's blocks)
CKPT_SWEEP = [(4, 128), (8, 128), (16, 128)]


def ckpt_phase(ctx, s1, s2, score, a20, b20):
    """The checkpointed diagonal fill of ``csrc/diag_ckpt.cu`` (K9's port
    ``diag_ckpt_fill``) and the paths that run it: the kernel against
    ``ckpt_plain`` word for word (dead slots, ``v`` and ``dbest`` included)
    on small shapes under NW, SW, positive-mismatch SW and positive-gap
    local; ``align_diag`` at 20,000 x 20,000 under (1, 0, -1) and SW (2,
    -1, -2); at the 64gb shape ``align_diag`` at (1, 0, -1) and ``align``
    under positive-mismatch SW (3, 1, -2), each one launch, the kernel held
    against ``ckpt_plain`` at that shape (the plain version on the card),
    each alignment valid and against ``align_checkpointed``'s strings
    (``impl="xla"``) or a kernel's score.  ``ctx``: as ``rc_phase``'s.
    Returns the kernel's entry of the ``kernels`` line."""
    import torch

    import tpualign_torch
    from tpualign_torch.config import AlignMode, EngineConfig, ScoringConfig
    from tpualign_torch.ops import band, oracle, pallas_diag, traceback_diag

    dev, rng, smi = ctx.dev, ctx.rng, ctx.smi
    t_phase = time.perf_counter()
    held = dict(max_abs_err=0)

    def hold(got, want, where):
        """K9's outputs against ckpt_plain's, word for word."""
        torch.cuda.synchronize()
        err = 0
        for a, b in zip(got, want):
            if (a is None) != (b is None) or (a is not None and a.shape != b.shape):
                raise AssertionError(f"diag_ckpt_fill's outputs differ in shape at {where}")
            if a is not None:
                err = max(err, int((a.long() - b.long()).abs().max()))
        if err:
            raise AssertionError(f"diag_ckpt_fill differs from ckpt_plain at {where} "
                                 f"(max abs err {err})")
        held["max_abs_err"] = max(held["max_abs_err"], err)

    def timed_fill(t, q, cfg, K):
        """One kernel run, CUDA events: ``(ms, outputs)``."""
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = pallas_diag.ckpt_fill(t, q, cfg, K)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1), out

    nw = ScoringConfig()
    sw = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
    masked = ScoringConfig(match=3, mismatch=1, gap=-2, mode=AlignMode.LOCAL)
    cfgs = {"NW": ScoringConfig(match=2, mismatch=-1, gap=-2), "SW": sw,
            "positive-mismatch SW": masked,
            "positive-gap local": ScoringConfig(match=1, mismatch=-3, gap=1,
                                                mode=AlignMode.LOCAL)}
    n_small = 0
    for (m, n), K, (name, cfg) in itertools.product(CKPT_SHAPES, CKPT_STRIDES, cfgs.items()):
        t = torch.from_numpy(rng.integers(0, 5, m).astype(np.int8)).to(dev)
        q = torch.from_numpy(rng.integers(0, 5, n).astype(np.int8)).to(dev)
        hold(pallas_diag.ckpt_fill(t, q, cfg, K), pallas_diag.ckpt_plain(t, q, cfg, K),
             f"{name} {m} x {n}, K = {K}")
        n_small += 1
    print(f"[diag_ckpt_fill vs plain] {n_small} cases equal to ckpt_plain word for word "
          f"(checkpoints with their dead slots, v and dbest): NW, SW, positive-mismatch SW, "
          f"positive-gap local; {len(CKPT_SHAPES)} shapes (n < m, n > m, 1 x k, k x 1, n past "
          f"1024 threads) x strides {CKPT_STRIDES}; {time.perf_counter() - t_phase:.1f} s")

    # the strip pipeline where races would show: each geometry 20 launches,
    # word for word against one plain run
    t0 = time.perf_counter()
    n_race = 0
    (lm, ln), K = CKPT_RACE_SHAPE, 24
    for (geometry, shallow), name in itertools.product(PIPE_RACES, ("NW", "SW",
                                                                    "positive-mismatch SW")):
        cfg = cfgs[name]
        t = torch.from_numpy(rng.integers(1, 5, lm).astype(np.int8)).to(dev)
        q = torch.from_numpy(rng.integers(1, 5, ln).astype(np.int8)).to(dev)
        want = pallas_diag.ckpt_plain(t, q, cfg, K)
        ring_budget = band.ring_budget
        if shallow:  # room for 2 rows
            band.ring_budget = lambda *a, **kw: 2 * 4 * (lm + 1)
        try:
            plan = band.pipeline_plan(ln, lm, False, geometry, band.MAX_K, band.ring_budget())
            for _ in range(PIPE_REPEAT):
                hold(pallas_diag.ckpt_fill(t, q, cfg, K, geometry), want,
                     f"{name} {ln} x {lm}, K = {K}, {plan}")
                n_race += 1
        finally:
            band.ring_budget = ring_budget
        if shallow and plan.depth != 2:
            raise AssertionError(f"the ring was not cut to 2 rows: {plan}")
    print(f"[diag_ckpt_fill pipeline vs plain] {len(PIPE_RACES) * 3} cases x {PIPE_REPEAT} "
          f"launches ({n_race}), each word for word against one plain run: NW, SW, "
          f"positive-mismatch SW at {ln} x {lm}, K = {K}; one block, blocks past the strips, "
          f"fewer blocks than strips, a ring of 2 rows; {time.perf_counter() - t0:.1f} s")

    K = 1024
    timing = {}
    # 20,000 x 20,000: align_diag, one launch; its strings against the
    # checkpointed row scan's (impl="xla"); K9 against ckpt_plain there
    t20, q20 = torch.from_numpy(a20).to(dev), torch.from_numpy(b20).to(dev)
    for name, cfg in (("NW (1, 0, -1)", nw), ("SW (2, -1, -2)", sw)):
        ctx.reset_counts()
        stats = {}
        t0 = time.perf_counter()
        got = traceback_diag.align_diag(a20, b20, cfg, device="cuda", stats=stats)
        wall = time.perf_counter() - t0
        counts = ctx.read_counts()
        if not ctx.only(counts, "diag_ckpt_fill"):
            raise AssertionError(f"align_diag {name} did not run one diag_ckpt_fill: {counts}")
        t0 = time.perf_counter()
        want = tpualign_torch.align(a20, b20, cfg, EngineConfig(impl="xla"))
        xla_wall = time.perf_counter() - t0
        if got != want:
            raise AssertionError(f"align_diag {name} at 20k differs from align_checkpointed")
        ok = (core_ok if cfg.is_local else alignment_ok)(a20, b20, got[1], got[2],
                                                        oracle.BASES)
        witness = tpualign_torch.align_score(a20, b20, cfg)
        if not ok or not got[0] == oracle.alignment_score(got[1], got[2], cfg) == witness:
            raise AssertionError(f"align_diag {name} at 20k: valid {ok}, score {got[0]}, "
                                 f"align_score {witness}")
        k_ms, k_out = timed_fill(t20, q20, cfg, K)
        p_ms, p_out = ctx.host_ms(lambda: pallas_diag.ckpt_plain(t20, q20, cfg, K))
        hold(k_out, p_out, f"20000 x 20000 {name}")
        timing[f"20k {name}"] = (k_ms, p_ms)
        print(f"[path: align_diag {name}] {a20.size} x {b20.size}: alignment valid, score "
              f"{got[0]} equal to align_score's, strings equal to align_checkpointed's "
              f"(impl='xla', wall {xla_wall:.3f} s); launches {counts}; wall {wall:.3f} s; "
              f"split {json.dumps(stats)}")
        print(f"[timing] {smi}: diag_ckpt_fill {name} at {b20.size} x {a20.size}, K = {K}: "
              f"{k_ms:.3f} ms; equal to ckpt_plain word for word (plain {p_ms:.1f} ms)")
        del k_out, p_out

    # the 64gb shape: align_diag at (1, 0, -1), one launch; valid,
    # re-scoring to K1's align_score, its strings equal to the checkpointed
    # row scan's; K9 held against ckpt_plain (run on the card) at the shape
    m, n = s1.size, s2.size
    ts, qs = torch.from_numpy(s1).to(dev), torch.from_numpy(s2).to(dev)
    ctx.reset_counts()
    diag_stats = {}
    t0 = time.perf_counter()
    sc, a1, a2 = traceback_diag.align_diag(s1, s2, nw, device="cuda", stats=diag_stats)
    diag_wall = time.perf_counter() - t0
    diag_counts = ctx.read_counts()
    if not ctx.only(diag_counts, "diag_ckpt_fill"):
        raise AssertionError(f"align_diag did not run one diag_ckpt_fill: {diag_counts}")
    if not alignment_ok(s1, s2, a1, a2, oracle.BASES):
        raise AssertionError("64gb-shape align_diag alignment is not valid")
    rescored = oracle.alignment_score(a1, a2, nw)
    if not sc == rescored == score:
        raise AssertionError(f"64gb-shape align_diag score {sc} (re-scored {rescored}) != "
                             f"align_score's {score}")
    print(f"[main path: align_diag (1, 0, -1)] {m} x {n}: alignment valid, {len(a1)} columns, "
          f"score {sc} equal to align_score's (bitpal_gfill); launches {diag_counts}; wall "
          f"{diag_wall:.3f} s; split {json.dumps(diag_stats)}")
    k_ms, k_out = timed_fill(ts, qs, nw, K)
    p_ms, p_out = ctx.host_ms(lambda: pallas_diag.ckpt_plain(ts, qs, nw, K))
    hold(k_out, p_out, f"{m} x {n} NW")
    groups = k_out.cka.shape[0]
    ck_bytes = 2 * k_out.cka.numel() * 4
    plan = band.pipeline_plan(n, m, False, None, band.MAX_K, band.ring_budget())
    # K9 NW's geometry: each result word for word the planner's
    sweep = {}
    for geometry in CKPT_SWEEP:
        g_ms, g_runs, g_out = ctx.cuda_ms(lambda: pallas_diag.ckpt_fill(ts, qs, nw, K, geometry),
                                          runs=3)
        hold(g_out, p_out, f"{m} x {n} NW at {geometry}")
        g_plan = band.pipeline_plan(n, m, False, geometry, band.MAX_K, band.ring_budget())
        sweep[f"{g_plan.k}x{g_plan.threads}x{g_plan.blocks}"] = g_ms
        print(f"[sweep] {smi}: diag_ckpt_fill NW {n} x {m}, K = {K}, k = {g_plan.k}, "
              f"{g_plan.threads} threads, {g_plan.blocks} blocks ({g_plan.strips} strips, ring "
              f"{g_plan.depth}): median of 3 {g_ms:.3f} ms (runs "
              f"{', '.join(f'{x:.3f}' for x in g_runs)})")
        del g_out
    del k_out, p_out
    print(f"[timing] {smi}: diag_ckpt_fill NW at {n} x {m}, K = {K} ({groups} groups, "
          f"{ck_bytes} bytes of checkpoints; k = {plan.k}, {plan.threads} threads, "
          f"{plan.blocks} blocks, {plan.strips} strips, a ring of {plan.depth} rows): "
          f"{k_ms:.3f} ms ({m * n / k_ms / 1e6:.3f} GCUPS); the path's run "
          f"{diag_stats['fill_ms']:.3f} ms; equal to ckpt_plain word for word on the card "
          f"(plain {p_ms:.1f} ms)")
    ctx.reset_counts()
    xla_stats = {}
    t0 = time.perf_counter()
    want = tpualign_torch.align(s1, s2, nw, EngineConfig(impl="xla"), stats=xla_stats)
    xla_wall = time.perf_counter() - t0
    xla_counts = ctx.read_counts()
    if sum(xla_counts.values()) or want != (sc, a1, a2):
        raise AssertionError(f"align_checkpointed at the 64gb shape: launches {xla_counts}, "
                             f"strings equal {want == (sc, a1, a2)}")
    del want, a1, a2
    print(f"[path: align_checkpointed (1, 0, -1)] {m} x {n} (impl='xla'): strings equal to "
          f"align_diag's; launches {xla_counts}; wall {xla_wall:.3f} s; split "
          f"{json.dumps(xla_stats)}")

    # align under positive-mismatch SW (3, 1, -2) at the 64gb shape: the
    # diagonal-band traceback, one diag_ckpt_fill launch and nothing else
    ctx.reset_counts()
    sw_stats = {}
    t0 = time.perf_counter()
    sc, a1, a2 = tpualign_torch.align(s1, s2, masked, stats=sw_stats)
    sw_wall = time.perf_counter() - t0
    sw_counts = ctx.read_counts()
    if not ctx.only(sw_counts, "diag_ckpt_fill"):
        raise AssertionError(f"positive-mismatch SW align did not run one diag_ckpt_fill "
                             f"alone: {sw_counts}")
    witness = tpualign_torch.align_score(s1, s2, masked)
    valid = core_ok(s1, s2, a1, a2, oracle.BASES)
    if not valid or not sc == oracle.alignment_score(a1, a2, masked) == witness:
        raise AssertionError(f"positive-mismatch SW align: valid {valid}, score {sc}, "
                             f"align_score {witness}")
    print(f"[path: align positive-mismatch SW (3, 1, -2)] {m} x {n}: alignment valid, "
          f"{len(a1)} columns, score {sc} equal to align_score's (band_fill); launches "
          f"{sw_counts}; wall {sw_wall:.3f} s; split {json.dumps(sw_stats)}")
    del a1, a2
    sw_ms, k_out = timed_fill(ts, qs, masked, K)
    sw_plain_ms, p_out = ctx.host_ms(lambda: pallas_diag.ckpt_plain(ts, qs, masked, K))
    hold(k_out, p_out, f"{m} x {n} positive-mismatch SW")
    del k_out, p_out
    print(f"[timing] {smi}: diag_ckpt_fill positive-mismatch SW at {n} x {m}, K = {K}: "
          f"{sw_ms:.3f} ms ({m * n / sw_ms / 1e6:.3f} GCUPS); the path's run "
          f"{sw_stats['fill_ms']:.3f} ms; equal to ckpt_plain word for word, v and dbest "
          f"included (plain {sw_plain_ms:.1f} ms)")
    print(f"[phase j] {time.perf_counter() - t_phase:.1f} s")
    # the least time: inputs and checkpoints once; 4 operations a cell
    # (band_ops, linear), SW 6 (the floor and the row maximum's compare)
    b_ms, by = bound(m + n + ck_bytes, band_ops(nw, m * n))
    sw_b_ms, _ = bound(m + n + ck_bytes + 8 * (n + 1), band_ops(masked, m * n, cell=True))
    return {"name": "diag_ckpt_fill", "route": "cuda", "source": CKPT_SOURCE,
            "replaces": CKPT_REPLACES, "launches": diag_counts["diag_ckpt_fill"], **held,
            "ms": k_ms, "plain_ms": p_ms, "shape": f"{n}x{m}", "bound_ms": b_ms,
            "bound_by": by, "library_ms": None,
            "geometry": [plan.k, plan.threads, plan.blocks], "sweep_64gb": sweep,
            "race_launches": n_race,
            "sw": dict(launches=sw_counts["diag_ckpt_fill"], ms=sw_ms, plain_ms=sw_plain_ms,
                       bound_ms=sw_b_ms),
            "ms_20k": timing, "align_diag_s": diag_wall, "align_checkpointed_s": xla_wall,
            "align_sw_s": sw_wall}


#: the ring budget's phase: the planner's wide shapes (n, m, affine), and
#: a query planted whole in a text whose 2 ring rows pass 1 GiB
WIDE_PLANS = ((5000, 140_000_000, False), (5000, 70_000_000, True))
WIDE_TEXT, WIDE_QUERY, WIDE_SEED = 1 << 27, 256, 27


def wide_phase(ctx):
    """The pipeline's ring on the card's memory (``band.ring_budget``): the
    planner's plans at ``WIDE_PLANS``, then ``align_score`` under SW (2, -1,
    -2) of a ``WIDE_QUERY``-base query planted whole in a seeded text of
    ``WIDE_TEXT`` bases, one ``band_fill`` launch over 2 strips and a ring
    of 2 rows of 536,870,916 bytes each; the score must be 2 x 256, the
    best any local alignment of the query can reach.  Returns the fill's
    numbers for the ``kernels`` line."""
    import tpualign_torch
    from tpualign_torch.config import AlignMode, ScoringConfig
    from tpualign_torch.ops import band

    t0 = time.perf_counter()
    budget = band.ring_budget()
    for n, m, affine in WIDE_PLANS:
        plan = band.pipeline_plan(n, m, affine, budget=budget)
        ring_bytes = plan.depth * 4 * (2 if affine else 1) * (m + 1)
        if plan.depth < 2 or ring_bytes > budget:
            raise AssertionError(f"the planner at {n} x {m}: {plan} under a budget of {budget}")
        print(f"[planner] {ctx.smi}: {n} x {m}{' affine' if affine else ''} under the card's "
              f"budget of {budget} bytes: k = {plan.k}, {plan.threads} threads, {plan.blocks} "
              f"blocks, {plan.strips} strips, a ring of {plan.depth} rows ({ring_bytes} bytes)")
    rng = np.random.default_rng(WIDE_SEED)
    text = rng.integers(1, 5, WIDE_TEXT, dtype=np.int8)
    query = rng.integers(1, 5, WIDE_QUERY, dtype=np.int8)
    at = int(rng.integers(0, WIDE_TEXT - WIDE_QUERY))
    text[at:at + WIDE_QUERY] = query
    cfg = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
    ctx.reset_counts()
    t1 = time.perf_counter()
    score = tpualign_torch.align_score(text, query, cfg)
    wall = time.perf_counter() - t1
    counts = ctx.read_counts()
    plan = band.pipeline_plan(WIDE_QUERY, WIDE_TEXT, False, None, band.max_k(cfg),
                              band.ring_budget())
    if not ctx.only(counts, "band_fill") or score != 2 * WIDE_QUERY or plan.depth < 2:
        raise AssertionError(f"the planted SW score at {WIDE_QUERY} x {WIDE_TEXT}: {score} "
                             f"(want {2 * WIDE_QUERY}), launches {counts}, {plan}")
    print(f"[path: align_score SW, wide] {WIDE_TEXT} x {WIDE_QUERY}, the query planted at "
          f"{at}: score {score}; launches {counts}; wall {wall:.3f} s "
          f"({WIDE_TEXT * WIDE_QUERY / wall / 1e9:.2f} GCUPS); the planner's k = {plan.k}, "
          f"{plan.threads} threads, {plan.blocks} blocks, {plan.strips} strips, a ring of "
          f"{plan.depth} rows of {4 * (WIDE_TEXT + 1)} bytes (RING_BUDGET {band.RING_BUDGET}); "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(launches=counts["band_fill"], wall_s=wall, score=score,
                shape=f"{WIDE_QUERY}x{WIDE_TEXT}", depth=plan.depth)


#: the bit-parallel fill's pipeline where races would show: (query rows,
#: text columns, g, blocks (None: the planner's), ring cut to 2 rows);
#: B = 2 at g = 1, 3 at g = 2, 4 at g = 5 and 7
GFILL_RACES = [
    (300 * 64 - 17, 1500, 1, None, False),  # 10 bands, a block each
    (300 * 64 - 17, 1500, 1, 3, True),  # bands past the blocks, ring of 2
    (300 * 64 - 17, 1500, 2, 1, False),  # one block walks every band
    (300 * 64 - 17, 1500, 5, 2, True),
    (500 * 64, 1200, 2, None, True),  # every band its block, ring of 2
    (500 * 64, 1200, 1, 3, False),
    (200 * 64 + 1, 1000, 1, 200, False),  # blocks past the bands
    (700 * 64, 800, 7, None, True),
]
GFILL_REPEAT = 20
#: the pipelined fill's blocks at the 64gb shape (None: the planner's, a
#: band a block; 128: blocks past the bands)
GFILL_SWEEP = [None, 128, 32, 16]


def gfill_phase(ctx, hold_g):
    """The bit-parallel fill's pipeline (``bitpal_gfill``,
    ``bitpal_capture_fill``) where a race would show: each of
    ``GFILL_RACES`` ``GFILL_REPEAT`` times, planes word for word and
    captures (rows on band edges) byte for byte against one
    ``fill_g_plain`` run on the card.  ``hold_g``: main's hold of a
    g-kernel against ``fill_g_plain``."""
    import torch

    from tpualign_torch.ops import band, bitpal

    t0 = time.perf_counter()
    n_launch = 0
    plans = []
    for nq, mt, g, blocks, shallow in GFILL_RACES:
        q = torch.from_numpy(ctx.rng.integers(0, 5, nq).astype(np.int8)).to(ctx.dev)
        t = torch.from_numpy(ctx.rng.integers(0, 5, mt).astype(np.int8)).to(ctx.dev)
        eq = bitpal._eq_planes(q, nq)
        B = bitpal.n_planes(g)
        ring_budget = band.ring_budget
        if shallow:  # room for 2 rows
            band.ring_budget = lambda *a, **kw: 2 * mt
        try:
            plan = bitpal.pipeline_plan(eq.shape[1], mt, blocks, band.ring_budget())
            rows = bitpal.band_edge_rows(nq)
            want = bitpal.fill_g_plain(t, eq, nq, g, rows)
            where = f"{nq} x {mt}, B = {B}, {plan}"
            for _ in range(GFILL_REPEAT):
                hold_g("bitpal_gfill", (bitpal.fill_g(t, eq, nq, g, blocks), None), want,
                       nq, g, where)
                hold_g("bitpal_capture_fill", bitpal.capture_fill(t, eq, nq, g, rows, blocks),
                       want, nq, g, where)
                n_launch += 2
        finally:
            band.ring_budget = ring_budget
        if shallow and plan.depth != 2:
            raise AssertionError(f"the ring was not cut to 2 rows: {plan}")
        plans.append(f"{plan.blocks}:{plan.bands}/{plan.depth}")
    print(f"[gfill pipeline vs plain] {len(GFILL_RACES)} cases x {GFILL_REPEAT} launches of "
          f"bitpal_gfill and of bitpal_capture_fill ({n_launch} launches; blocks: bands / "
          f"ring rows {plans}), each word for word and byte for byte against one "
          f"fill_g_plain run: bands past the blocks, one block, blocks past the bands, "
          f"rings of 2 rows, captured rows on band edges, B = 2, 3 and 4; "
          f"{time.perf_counter() - t0:.1f} s")


def gfill_sweep(ctx, t, eq, nq, g, rows=None, runs=3):
    """The pipelined fill's time over ``GFILL_SWEEP``'s blocks at one shape
    (with ``rows``, the capture fill), every result word for word the
    first's; returns ``{"blocks": ms}``."""
    import torch

    from tpualign_torch.ops import band, bitpal

    mt, nw = t.numel(), eq.shape[1]
    out, first = {}, None
    name = "bitpal_gfill" if rows is None else "bitpal_capture_fill"
    for blocks in GFILL_SWEEP:
        plan = bitpal.pipeline_plan(nw, mt, blocks, band.ring_budget())
        if rows is None:
            fn = lambda: (bitpal.fill_g(t, eq, nq, g, blocks), None)  # noqa: E731
        else:
            fn = lambda: bitpal.capture_fill(t, eq, nq, g, rows, blocks)  # noqa: E731
        ms, _, (planes, caps) = ctx.cuda_ms(fn, runs=runs)
        res = (torch.stack(planes), caps)
        if first is not None and not (torch.equal(res[0], first[0]) and (
                caps is None or torch.equal(caps, first[1]))):
            raise AssertionError(f"{name} at {plan} differs from the sweep's first plan")
        first = first or res
        out[str(plan.blocks)] = ms
        print(f"[sweep] {ctx.smi}: {name} g = {g} {nq} x {mt}, one word a lane, one warp a "
              f"band, {plan.blocks} blocks ({plan.bands} bands, ring {plan.depth}): median of "
              f"{runs} {ms:.3f} ms")
    return out


#: the pipeline's race cases: (k, threads, blocks) of one block, blocks
#: past the strips, fewer blocks than strips, the planner's blocks; "ring
#: 2": fewer blocks than strips over a ring cut to 2 rows
PIPE_RACES = [((1, 32, 1), False), ((2, 32, 64), False), ((1, 32, 3), False),
              ((4, 64, 2), False), ((1, 64), False), ((1, 32, 3), True)]
PIPE_REPEAT = 20
#: K6 SW's sweep (k, threads, blocks; None: the planner's blocks)
K6_SWEEP_64GB = [(8, 64, None), (8, 128, None), (8, 256, None), (4, 128, None),
                 (16, 128, None), (8, 128, 62)]
K6_SWEEP_20K = [(4, 128, None), (8, 64, None), (8, 128, None), (16, 128, None), (8, 128, 10)]
#: K8's forced geometries in phase (b), (k, threads[, blocks]) and whether
#: the ring is cut to 2 rows: strips of 32 rows over 1 block, of 1,024 rows
#: over 2 blocks and a ring of 2 rows, of 32 rows over blocks past them
DIAG_GEOMETRIES = [((1, 32, 1), False), ((8, 128, 2), True), ((1, 32, 200), False)]
DIAG_REPEAT = 3
#: each of K5's small holds launches this many times against one plain run
K5_REPEAT = 3


def pipeline_phase(ctx, hold_capture):
    """The strip pipeline of K6 and K7 (``band_fill``, ``band_capture_fill``,
    ``band_capture_affine``) where a race would show: SW, positive-mismatch
    SW, affine global and local and global linear on 1,037 rows (a partial
    last strip) x 1,500 columns at each of ``PIPE_RACES``, and a table whose
    cells all tie at 0 (the located cell must be the first row's, across
    strips and blocks) over fewer blocks than strips and over a ring of 2
    rows.  Each launch ``PIPE_REPEAT`` times, word for word against one
    plain run (the score, and the captured rows at the strip edges, the
    last row and column, the located cell and F's last row)."""
    import torch

    from tpualign_torch.config import AlignMode, ScoringConfig
    from tpualign_torch.ops import band

    t0 = time.perf_counter()
    sw = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
    aff = ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2)
    tie = ScoringConfig(match=1, mismatch=-1, gap=-1, mode=AlignMode.LOCAL)
    cases = [(cfg, 1500, 1037, geometry, shallow)
             for cfg in (sw, ScoringConfig(match=3, mismatch=1, gap=-2, mode=AlignMode.LOCAL),
                         aff, aff.with_mode(AlignMode.LOCAL),
                         ScoringConfig(match=2, mismatch=-1, gap=-2))
             for geometry, shallow in PIPE_RACES]
    cases += [(tie, 900, 700, (1, 32, 5), False), (tie, 900, 700, (2, 32, 40), True)]
    n_launch = 0
    for cfg, lm, ln, geometry, shallow in cases:
        if cfg is tie:
            text, query = np.full(lm, 1, np.int8), np.full(ln, 2, np.int8)
        else:
            text, query = (ctx.rng.integers(1, 5, x).astype(np.int8) for x in (lm, ln))
        t, q = torch.from_numpy(text).to(ctx.dev), torch.from_numpy(query).to(ctx.dev)
        geometry = (min(geometry[0], band.max_k(cfg)),) + geometry[1:]
        R = geometry[0] * geometry[1]
        rows = sorted({1, R - 1, R, R + 1, 2 * R, ln - 1, ln} - {0})
        ring_budget = band.ring_budget
        if shallow:  # room for 2 rows of H (and F)
            band.ring_budget = lambda *a, **kw: 2 * 4 * (2 if cfg.is_affine else 1) * (lm + 1)
        try:
            plan = band.pipeline_plan(ln, lm, cfg.is_affine, geometry, band.max_k(cfg),
                                      band.ring_budget())
            ends = band._ends_flags(cfg, False)
            want = int(band.score_plain(t, q, cfg, ends))
            want_c = band.capture_plain(t, q, cfg, rows, col=True, cell=True)
            where = f"{cfg}, {ln} x {lm}, {plan}"
            for _ in range(PIPE_REPEAT):
                got = int(band.band_fill(t, q, cfg, ends, geometry))
                if got != want:
                    raise AssertionError(f"band_fill {got} != score_plain {want} at {where}")
                hold_capture(band.capture_fill(t, q, cfg, rows, col=True, cell=True,
                                               geometry=geometry), want_c, where)
                n_launch += 2
        finally:
            band.ring_budget = ring_budget
        if shallow and plan.depth != 2:
            raise AssertionError(f"the ring was not cut to 2 rows: {plan}")
    print(f"[pipeline vs plain] {len(cases)} cases x {PIPE_REPEAT} launches of band_fill and "
          f"of the capture fill ({n_launch} launches), each word for word against one plain "
          f"run: one block, blocks past the strips, fewer blocks than strips, a ring of 2 "
          f"rows, a partial last strip, captured rows at strip edges, every cell tied; "
          f"{time.perf_counter() - t0:.1f} s")


def k6_sweep(ctx, tag, text, query, cfg, ends, grid, runs=3):
    """K6's time over ``(k, threads, blocks)`` geometries (blocks None: the
    planner's), every result equal to the first's; returns ``{geometry: ms}``."""
    from tpualign_torch.ops import band

    n, m = query.numel(), text.numel()
    out, first = {}, None
    for geometry in grid:
        if geometry[2] is None:
            geometry = geometry[:2]
        plan = band.pipeline_plan(n, m, cfg.is_affine, geometry)
        ms, runs_ms, res = ctx.cuda_ms(lambda: band.band_fill(text, query, cfg, ends, geometry),
                                      runs=runs)
        res = int(res)
        if first is not None and res != first:
            raise AssertionError(f"{tag}: band_fill at {geometry} gave {res}, not {first}")
        first = res
        key = f"{plan.k}x{plan.threads}x{plan.blocks}"
        out[key] = ms
        print(f"[sweep] {ctx.smi}: band_fill {tag} {n} x {m}, k = {plan.k}, {plan.threads} "
              f"threads, {plan.blocks} blocks ({plan.strips} strips, ring {plan.depth}): median "
              f"of {runs} {ms:.3f} ms")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", default=None,
                    help="directory holding 64gb-1.bdna and 64gb-2.bdna")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA device")

    import tpualign_torch
    from tpualign_torch import _build, matrices
    from tpualign_torch.config import AlignMode, EngineConfig, ScoringConfig
    from tpualign_torch.ops import band, band_batch, bitpal, hirschberg, oracle, pallas_diag, xla
    from tpualign_torch.ops import pairs as packing
    from tpualign_torch.probe import read_pairs, serve_pairs

    counted = {"fill_g": bitpal.fill_g, "capture_fill": bitpal.capture_fill,
               "band_fill": band.band_fill, "diag_fill": pallas_diag.diag_fill,
               "band_capture_fill": band.capture_fill,
               "bitpal_batch_fill": bitpal.batch_fill, "band_batch_fill": band_batch.batch_fill,
               "fill_rc": bitpal.fill_rc, "fill_rc_chunk": bitpal.fill_rc_chunk,
               "fill_g_chunk": bitpal.fill_g_chunk, "diag_ckpt_fill": pallas_diag.ckpt_fill}

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counted.items()}

    def only(counts, name):
        """The run launched ``name`` exactly once and no other kernel."""
        return counts[name] == 1 and sum(counts.values()) == 1

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

    def host_ms(fn):
        """``(ms, result)`` of one call of ``fn`` on the host clock, closed
        by a synchronize."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def runs_str(times):
        return ", ".join(f"{x:.3f}" for x in times)

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    ctx = argparse.Namespace(dev=dev, rng=rng, smi=smi, cuda_ms=cuda_ms, host_ms=host_ms,
                             sync=torch.cuda.synchronize, reset_counts=reset_counts,
                             read_counts=read_counts, only=only)

    # phase 2: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    lib_path = _build.library_path()
    _build.load()
    build_s = time.perf_counter() - t0
    with open(lib_path + ".log") as f:
        report = ptxas_report(f.read())
    print(f"[build] {os.path.relpath(lib_path)} in {build_s:.1f} s; "
          f"{len(report)} kernel instantiations")
    for name, regs, spill in report:  # -Xptxas -v per instantiation
        print(f"[ptxas] {name}: {regs} registers, {spill} bytes spill stores")
    if len(report) != N_INSTANTIATIONS:
        raise AssertionError(f"expected {N_INSTANTIATIONS} kernel instantiations, "
                             f"ptxas reported {len(report)}")

    # phase 3: K1 (bitpal_gfill at g = 1) against fill_plain (planes word
    # for word), the scores against the oracle (up to 300 x 300, and once at
    # 20k x 20k)

    def kernel_vs_plain(query, text):
        nq, mt = query.size, text.size
        q = torch.from_numpy(query).to(dev)
        t = torch.from_numpy(text).to(dev)
        eq = bitpal._eq_planes(q, nq)
        k0, k1 = bitpal.fill_g(t, eq, nq, 1)
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
    # many bands: 33, 98, 196 and 489 bands of 32 words
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
    geoms = sorted({bitpal.pipeline_plan(-(-nq // bitpal.WORD), mt)[:2]
                    for nq, mt, _ in shapes})
    print(f"[K1 vs plain] bitpal_gfill g = 1: {len(shapes)} shapes equal to fill_plain word "
          f"for word (planned (blocks, bands) {geoms}); {n_oracle} scores equal to the "
          f"oracle")
    a = rng.integers(1, 5, 20000).astype(np.int8)
    b = rng.integers(1, 5, 20000).astype(np.int8)
    # pinned to K1 (cols_per_step=1): by tpualign's rule this pair takes K3a,
    # held in phase (i)
    reset_counts()
    got, want20 = bitpal.score(a, b, device="cuda", cols_per_step=1), oracle.score(a, b)
    if got != want20 or not only(read_counts(), "fill_g"):
        raise AssertionError(f"20000 x 20000: kernel score {got} != oracle {want20}, or not "
                             f"one bitpal_gfill launch: {read_counts()}")
    print(f"[K1 vs oracle] 20000 x 20000 score {got} (cols_per_step=1: one bitpal_gfill "
          f"launch) equal to the oracle's")

    # phase 4: align_score at the default scoring on the 64gb-shape pair
    s1, s2, source = load_pair(args.corpus)
    m, n = s1.size, s2.size
    reset_counts()
    t0 = time.perf_counter()
    score = tpualign_torch.align_score(s1, s2)
    wall_s = time.perf_counter() - t0
    k1_counts = read_counts()
    if not only(k1_counts, "fill_g"):
        raise AssertionError(f"align_score did not run one bitpal_gfill launch: {k1_counts}")
    launches = k1_counts["fill_g"]

    # the same fill at the path's shape, plain and kernel, outside the
    # counted run.  At this shape the score puts s2 on the rows, as align
    # does, so align's root capture fill (below) runs on the same query and
    # text: one plain fill with the root's rows gives fill_plain's planes
    # and the captures both holds need
    if bitpal._orientation(m, n):
        raise AssertionError(f"the score put s1 on the rows at {m} x {n}")
    q = torch.from_numpy(s2).to(dev)
    t = torch.from_numpy(s1).to(dev)
    eq = bitpal._eq_planes(q, n)
    root_rows = hirschberg._kway_rows(n)
    plain_ms, ((p0, p1), root_caps) = host_ms(
        lambda: bitpal.fill_g_plain(t, eq, n, 1, root_rows))
    plain_score = int(bitpal._reduce_score((p0, p1), n, m))  # unit scoring
    if args.corpus is not None and score != 73888:
        raise AssertionError(f"64gb corpus score {score} != the reference's 73888")
    if score != plain_score:
        raise AssertionError(f"align_score {score} != fill_plain's {plain_score}")
    print(f"[main path: align_score g = 1] align_score = {score} on {m} x {n} ({source}); "
          f"fill_plain on the card agrees; launches {k1_counts}; wall {wall_s:.3f} s")

    # phase 5: the kernel's time at that shape
    ms, times, (k0, k1) = cuda_ms(lambda: bitpal.fill_g(t, eq, n, 1))
    err = (bitpal.row_deltas((k0, k1), n) - bitpal.row_deltas((p0, p1), n)).abs().max()
    max_abs_err = int(err)
    if max_abs_err != 0 or not (torch.equal(k0, p0) and torch.equal(k1, p1)):
        raise AssertionError(f"timed kernel run differs from fill_plain (max abs err "
                             f"{max_abs_err})")
    cells = m * n

    # the planner's launch at the path's shape, the same for K1, K2 and K4's
    # captures: one word a lane, one warp a band
    pipe_plan = bitpal.pipeline_plan(eq.shape[1], m, None, band.ring_budget())
    pipe_geometry = dict(words_a_lane=1, warps_a_band=1, **pipe_plan._asdict())
    print(f"[timing] {smi}: bitpal_gfill g = 1 median of 5 {ms:.3f} ms "
          f"({cells / ms / 1e6:.2f} GCUPS; runs {runs_str(times)} ms; {pipe_plan}); fill_g_plain "
          f"g = 1 with align's {len(root_rows)} root rows (fill_plain's planes and the "
          f"captures) {plain_ms:.1f} ms ({cells / plain_ms / 1e6:.3f} GCUPS)")
    k1_sweep = gfill_sweep(ctx, t, eq, n, 1)

    k1_shape = f"{n}x{m}"
    root_plain = ((p0, p1), root_caps)
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
        """Both g-kernels against fill_g_plain on the same inputs, planes
        word for word and captures byte for byte."""
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
        return bitpal.pipeline_plan(eq.shape[1], text.size)[:2]

    def cap_rows_for(nq):
        """Rows at and off word bottoms (64(w+1)), the first and the last."""
        rows = {1, nq, (nq + 1) // 2, 63, 64, 65, 128, 129, 64 * (nq // 128)}
        return sorted(r for r in rows if 1 <= r <= nq)

    t0 = time.perf_counter()
    g_shapes = [(nq, mt, 1, g) for nq, mt in [(1, 1), (63, 2), (64, 300), (65, 300),
                                              (129, 77), (1000, 300)]
                for g in (1, 2, 3, 5, 7)]
    g_shapes += [(2000, 3000, 0, g) for g in (1, 2, 7)]  # codes 0..4
    # many bands: 33, 98, 196 and 489 bands of 32 words
    g_shapes += [(65600, 40, 1, g) for g in (1, 2, 7)]
    g_shapes += [(200000, 40, 1, 5), (400000, 40, 1, 3)]
    g_shapes += [(1000000, 40, 1, g) for g in (1, 7)]
    ks, n_caps = set(), 0
    for nq, mt, lo, g in g_shapes:
        rows = cap_rows_for(nq)
        ks.add(g_vs_plain(rng.integers(lo, 5, nq).astype(np.int8),
                          rng.integers(lo, 5, mt).astype(np.int8), g, rows))
        n_caps += len(rows)
    print(f"[g-kernels vs plain] bitpal_gfill and bitpal_capture_fill equal to "
          f"fill_g_plain at {len(g_shapes)} shapes, g in 1..7, planned (blocks, bands) "
          f"{sorted(ks)}; {n_caps} captured rows byte for byte; "
          f"{time.perf_counter() - t0:.1f} s")

    # phase (l): the pipelined fill where races would show
    gfill_phase(ctx, hold_g)

    # 20,000 x 20,000 against the port's oracle
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

    # the binary split alone, 6,000 x 6,000
    a6, b6 = a[:6000], b[:6000]
    reset_counts()
    sc, a1, a2 = tpualign_torch.align(a6, b6)
    counts = read_counts()
    want = oracle.score(a6, b6)
    if not alignment_ok(a6, b6, a1, a2, oracle.BASES) or sc != want:
        raise AssertionError(f"6000 x 6000 alignment invalid or score {sc} != oracle {want}")
    if counts["fill_g"] < 2 or sum(counts.values()) != counts["fill_g"]:
        raise AssertionError(f"6000 x 6000 did not run the binary split alone: {counts}")
    print(f"[align binary split] 6000 x 6000 alignment valid, score {sc} equal to the "
          f"oracle's; launches {counts}")

    # align on the 64gb-shape pair, its split recorded (host clock)
    reset_counts()
    stats = {}
    t0 = time.perf_counter()
    sc, a1, a2 = tpualign_torch.align(s1, s2, stats=stats)
    align_wall = time.perf_counter() - t0
    align_counts = read_counts()
    band_kernels = ("band_fill", "diag_fill", "band_capture_fill")
    if align_counts["capture_fill"] < 2 or sum(align_counts[k] for k in band_kernels):
        raise AssertionError(f"align did not launch bitpal_capture_fill twice: {align_counts}")
    if not alignment_ok(s1, s2, a1, a2, oracle.BASES):
        raise AssertionError("64gb-shape alignment is not valid")
    rescored = oracle.alignment_score(a1, a2)
    if not sc == rescored == score:
        raise AssertionError(f"64gb-shape alignment score {sc} (re-scored {rescored}) "
                             f"!= align_score's {score}")
    print(f"[path: align] {m} x {n} ({source}): alignment valid, "
          f"{len(a1)} columns, score {sc} equal to align_score's; launches "
          f"{align_counts}; wall {align_wall:.3f} s")
    # the root's forward capture fill on its own (CUDA events), held
    # against fill_g_plain at the path's shape
    cap_ms, cap_runs, cap = cuda_ms(lambda: bitpal.capture_fill(t, eq, n, 1, root_rows))
    cap_err = hold_g("bitpal_capture_fill", cap, root_plain, n, 1,
                     f"{n} x {m}, {len(root_rows)} rows")
    gk["bitpal_capture_fill"].update(ms=cap_ms, plain_ms=plain_ms, shape=f"{n}x{m}",
                                     geometry=pipe_geometry)
    del cap, root_plain
    print(f"[path split] {json.dumps(stats)}; root capture fill {cap_ms:.3f} ms "
          f"(median of 5, {len(root_rows)} rows; runs {runs_str(cap_runs)}; {pipe_plan}); "
          f"equal to "
          f"fill_g_plain at {n} x {m} (planes word for word, captures byte for byte, "
          f"max abs err {cap_err}; plain {plain_ms:.1f} ms, the g = 1 score's fill)")

    # align_score under (1, 0, -2) through K2 at the 64gb shape
    cfg2 = ScoringConfig(gap=-2)
    reset_counts()
    t0 = time.perf_counter()
    score2 = tpualign_torch.align_score(s1, s2, cfg2)
    wall2 = time.perf_counter() - t0
    g_counts = read_counts()
    if not only(g_counts, "fill_g"):
        raise AssertionError(f"align_score at g = 2 did not run one bitpal_gfill: {g_counts}")
    # the g = 1 score's orientation (s2 on the rows), query planes and text
    cplanes, _ = bitpal.capture_fill(t, eq, n, 2, [n])
    cscore = bitpal._from_unit(cfg2, m + n, int(bitpal._reduce_score(cplanes, n, m, 2)))
    g_ms, g_runs, gplanes = cuda_ms(lambda: bitpal.fill_g(t, eq, n, 2))
    g_plain_ms, plain = host_ms(lambda: bitpal.fill_g_plain(t, eq, n, 2))
    g_err = hold_g("bitpal_gfill", (gplanes, None), plain, n, 2, f"{n} x {m}")
    pscore = bitpal._from_unit(cfg2, m + n, int(bitpal._reduce_score(plain[0], n, m, 2)))
    if not score2 == pscore == cscore:
        raise AssertionError(f"g = 2 score {score2} != fill_g_plain's {pscore} or the "
                             f"capture kernel's {cscore}")
    gk["bitpal_gfill"].update(ms=g_ms, plain_ms=g_plain_ms, shape=f"{n}x{m}",
                              geometry=pipe_geometry)
    del plain, gplanes, cplanes
    print(f"[path: align_score g = 2] {m} x {n}: score {score2} equal to fill_g_plain's "
          f"on the card and to the capture kernel's final column; launches {g_counts}; "
          f"wall {wall2:.3f} s")
    print(f"[timing] {smi}: bitpal_gfill g = 2 at {n} x {m}: median of 5 {g_ms:.3f} ms "
          f"({m * n / g_ms / 1e6:.2f} GCUPS; runs {runs_str(g_runs)} ms; {pipe_plan}); "
          f"equal to "
          f"fill_g_plain (planes word for word, max abs err {g_err}; plain "
          f"{g_plain_ms:.1f} ms)")

    # phase (a): band_fill against score_plain, score for score
    asym = ((3, -1, -2, 0, 1), (-2, 2, -3, -1, 0), (0, -1, 4, -2, -1),
            (1, 0, -1, 3, -2), (-1, -2, 0, -3, 2))
    subs = {"pair": None, "dna": matrices.dna(2, -1, -3), "asym5": asym,
            "iupac": matrices.iupac()}
    bk = dict(max_abs_err=0)

    def band_case(s1c, s2c, cfg, geometry=None, as_is=False):
        """``band_fill`` against ``score_plain`` on the kernel arguments that
        ``band.score_fn`` gives ``(s1c, s2c)`` (``as_is``: ``s1c`` as the
        text and ``s2c`` as the query, whichever is shorter); returns the
        plain result."""
        p = band.plan(s1c.size, s2c.size, cfg)
        if as_is:
            p = p._replace(swapped=False, cfg=cfg, ends=band._ends_flags(cfg, False))
        text, query = (s2c, s1c) if p.swapped else (s1c, s2c)
        text, query = torch.from_numpy(text).to(dev), torch.from_numpy(query).to(dev)
        got = int(band.band_fill(text, query, p.cfg, p.ends, geometry))
        want = int(band.score_plain(text, query, p.cfg, p.ends))
        if got != want:
            raise AssertionError(f"band_fill {got} != score_plain {want}: {cfg}, "
                                 f"{s1c.size} x {s2c.size}, geometry {geometry}")
        return want

    t0 = time.perf_counter()
    n_band = 0
    for mode in AlignMode:
        for sub_name, mat in subs.items():
            for gaps in ({}, dict(gap_open=-5, gap_extend=-2)):
                for swap in (False, True):
                    kw = dict(match=2, mismatch=-1, gap=-2, mode=mode, **gaps)
                    if mat is not None:
                        kw["matrix"] = mat
                    cfg = ScoringConfig(**kw)
                    hi = len(mat) if mat is not None else 5
                    lm, ln = sorted(int(x) for x in rng.integers(1, 700, 2))
                    lm, ln = (ln, lm) if swap else (lm, ln)
                    band_case(rng.integers(0, hi, lm).astype(np.int8),
                              rng.integers(0, hi, ln).astype(np.int8), cfg)
                    n_band += 1
    # every instantiation <rows per thread, affine, matrix, local>, three
    # strips each (R = 32 k rows, the last strip partial)
    for k in (1, 2, 4, 8, 16):
        for gaps in ({}, dict(gap_open=-5, gap_extend=-2)):
            for mat in (None, matrices.dna(2, -1, -3)):
                for mode in (AlignMode.GLOBAL, AlignMode.LOCAL):
                    kw = dict(match=2, mismatch=-1, gap=-2, mode=mode, matrix=mat, **gaps)
                    band_case(rng.integers(0, 5, 96 * k + 50).astype(np.int8),
                              rng.integers(0, 5, 64 * k + 7).astype(np.int8),
                              ScoringConfig(**kw), (k, 32))
                    n_band += 1
    # strip edges at chosen geometries (R = k * threads rows a strip; the
    # query is the shorter sequence), a masked local (mismatch > 0), 1-row
    # and 1-column tables
    sw = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
    aff = ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2)
    masked = ScoringConfig(match=3, mismatch=1, gap=-2, mode=AlignMode.LOCAL)
    masked_aff = ScoringConfig(match=3, mismatch=1, gap_open=-5, gap_extend=-2,
                               mode=AlignMode.LOCAL)
    edge = [(masked_aff, 700, 600, None), (masked_aff, 600, 700, (2, 32)),
            (masked_aff, 3000, 2500, (8, 96)),(sw, 500, 31, (1, 32)), (sw, 500, 32, (1, 32)), (sw, 500, 33, (1, 32)),
            (aff, 400, 255, (4, 64)), (aff, 400, 256, (4, 64)), (aff, 400, 257, (4, 64)),
            (sw, 900, 5000, (16, 32)), (aff, 2000, 1700, (2, 96)),
            (ScoringConfig(mode=AlignMode.SEMIGLOBAL, gap=-2, matrix=asym), 333, 3000, (2, 64)),
            (masked, 700, 600, None), (masked, 700, 600, (2, 32)),
            (sw, 5000, 1, None), (aff, 1, 5000, None), (sw, 1, 1, None),
            (ScoringConfig(mode=AlignMode.INFIX, gap=-2), 4000, 1, None)]
    for cfg, lm, ln, geometry in edge:
        band_case(rng.integers(1, 5, lm).astype(np.int8),
                  rng.integers(1, 5, ln).astype(np.int8), cfg, geometry)
        n_band += 1
    for cfg in (sw, aff, masked, masked_aff, ScoringConfig(mode=AlignMode.SEMIGLOBAL, gap=-2)):
        band_case(rng.integers(1, 5, 1).astype(np.int8),  # one column, 3000 rows
                  rng.integers(1, 5, 3000).astype(np.int8), cfg, as_is=True)
        n_band += 1
    torch.cuda.synchronize()
    print(f"[band_fill vs plain] {n_band} cases equal to score_plain (every mode x pair, "
          f"dna, asym5, iupac x linear, affine, both orientations; all 40 instantiations "
          f"over several strips; strip edges at R = 32 and 256, multi-strip, masked "
          f"local linear and affine, 1-row and 1-column tables); "
          f"{time.perf_counter() - t0:.1f} s")

    # phase (b): diag_fill against score_plain: the planner's geometry (and
    # pallas_diag.score through it), then forced geometries with strip edges
    # at 31..33 and 1,023..1,025 rows: one block, fewer blocks than strips
    # over a ring of 2 rows, blocks past the strips; each forced launch
    # DIAG_REPEAT times
    dk = dict(max_abs_err=0)
    t0 = time.perf_counter()
    n_diag = n_launch = 0
    for short in (1, 31, 32, 33, 1023, 1024, 1025, 2047, 2048, 3000):
        for mode in (AlignMode.GLOBAL, AlignMode.LOCAL):
            cfg = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=mode)
            long_ = short + int(rng.integers(0, 500))
            x = rng.integers(0, 5, long_).astype(np.int8)
            y = rng.integers(0, 5, short).astype(np.int8)
            s1c, s2c = (x, y) if n_diag % 2 else (y, x)  # both orientations
            lng, sht = (s1c, s2c) if s1c.size >= s2c.size else (s2c, s1c)
            lt, st = torch.from_numpy(lng).to(dev), torch.from_numpy(sht).to(dev)
            got = int(pallas_diag.diag_fill(lt, st, cfg))
            want = int(pallas_diag.score_plain(lt, st, cfg))
            if got != want or pallas_diag.score(s1c, s2c, cfg, device="cuda") != want:
                raise AssertionError(f"diag_fill {got} != score_plain {want}: {cfg}, "
                                     f"{s1c.size} x {s2c.size}")
            for geometry, shallow in DIAG_GEOMETRIES:
                ring_budget = band.ring_budget
                if shallow:  # room for 2 rows
                    band.ring_budget = lambda *a, **kw: 2 * 4 * (lng.size + 1)
                try:
                    for _ in range(DIAG_REPEAT):
                        got = int(pallas_diag.diag_fill(lt, st, cfg, geometry))
                        if got != want:
                            raise AssertionError(
                                f"diag_fill {got} != score_plain {want}: {cfg}, {sht.size} x "
                                f"{lng.size}, {pallas_diag.diag_fill.last_plan}")
                        n_launch += 1
                finally:
                    band.ring_budget = ring_budget
                plan = pallas_diag.diag_fill.last_plan
                if shallow and plan.strips > 1 and plan.depth != 2:
                    raise AssertionError(f"the ring was not cut to 2 rows: {plan}")
            n_diag += 1
    print(f"[diag_fill vs plain] {n_diag} cases equal to score_plain (NW and SW, both "
          f"orientations, 1 to 3000 rows) at the planner's geometry and at "
          f"{[g for g, _ in DIAG_GEOMETRIES]} ({n_launch} launches: strip edges, one block, "
          f"fewer blocks than strips over a ring of 2 rows, blocks past the strips); "
          f"{time.perf_counter() - t0:.1f} s")

    # phase (a2): band_capture_fill against capture_plain, word for word:
    # every instantiation <rows per thread, matrix, local> over three strips
    # (R = 32 k rows, the last strip partial) with rows captured at the strip
    # edges, zero boundaries, both extraction sets (the located cell and the
    # last row and column), matrices of 5 and 16 codes, 1-row and 1-column
    # tables
    ck = dict(max_abs_err=0)

    def hold_capture(got, want, where):
        """A capture kernel's result against ``capture_plain``'s on the same
        inputs, every part word for word; records the largest difference."""
        torch.cuda.synchronize()
        err = 0
        for name, g, w in zip(band.Capture._fields, got, want):
            if (g is None) != (w is None):
                raise AssertionError(f"band_capture_fill {name} missing at {where}")
            if g is None:
                continue
            if g.shape != w.shape:
                raise AssertionError(f"band_capture_fill {name} shape {tuple(g.shape)} != "
                                     f"{tuple(w.shape)} at {where}")
            if g.numel():
                err = max(err, int((g.long() - w.long()).abs().max()))
        if err:
            raise AssertionError(f"band_capture_fill differs from capture_plain at {where} "
                                 f"(max abs err {err})")
        ck["max_abs_err"] = max(ck["max_abs_err"], err)

    def capture_case(text, query, cfg, rows, geometry=None, cell=True, **flags):
        t, q = torch.from_numpy(text).to(dev), torch.from_numpy(query).to(dev)
        got = band.capture_fill(t, q, cfg, rows, geometry=geometry, col=True, cell=cell, **flags)
        want = band.capture_plain(t, q, cfg, rows, col=True, cell=cell, **flags)
        hold_capture(got, want, f"{cfg}, {text.size} x {query.size}, rows {rows}, "
                                f"geometry {geometry}, {flags}")
        return got

    t0 = time.perf_counter()
    n_cap = 0
    for k, mat, mode, cell in itertools.product(
            (1, 2, 4, 8, 16), (None, matrices.dna(2, -1, -3), matrices.iupac()),
            (AlignMode.GLOBAL, AlignMode.LOCAL), (True, False)):
        cfg = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=mode, matrix=mat)
        hi = 16 if mat is not None and len(mat) == 16 else 5
        R, nq = 32 * k, 64 * k + 7
        rows = sorted({1, R - 1, R, R + 1, 2 * R, nq - 1, nq} - {0})
        flags = {} if mode is AlignMode.LOCAL else dict(zero_row=n_cap % 3 == 0,
                                                        zero_col=n_cap % 2 == 0)
        capture_case(rng.integers(0, hi, 96 * k + 50).astype(np.int8),
                     rng.integers(0, hi, nq).astype(np.int8), cfg, rows, (k, 32),
                     cell, **flags)
        n_cap += 1
    for cfg, lm, ln, rows, geometry in [
            (sw, 5000, 1, [1], None), (sw, 1, 3000, [1, 1500, 3000], None),
            (ScoringConfig(gap=-2), 1, 1, [1], None), (masked, 700, 600, [300, 600], None),
            (ScoringConfig(match=2, mismatch=-1, gap=-2), 3000, 2500, [1023, 1024, 1025, 2500],
             (4, 256)),
            (ScoringConfig(matrix=asym, gap=-2, mode=AlignMode.LOCAL), 900, 5000,
             [511, 512, 513, 4999], (16, 32))]:
        capture_case(rng.integers(1, 5, lm).astype(np.int8), rng.integers(1, 5, ln).astype(np.int8),
                     cfg, rows, geometry)
        n_cap += 1
    # the 36 affine instantiations <rows per thread, matrix, local, locate>
    # (local stops at 8 rows a thread), the top-edge open tb = gap_open and
    # the waived tb = 0 in turn; the last row of F besides
    n_aff = 0
    for k, mat, mode, cell in itertools.product(
            (1, 2, 4, 8, 16), (None, matrices.dna(2, -1, -3)),
            (AlignMode.GLOBAL, AlignMode.LOCAL), (True, False)):
        if mode is AlignMode.LOCAL and k > band.MAX_K_LOCAL_AFFINE:
            continue
        cfg = ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2, mode=mode,
                            matrix=mat)
        R, nq = 32 * k, 64 * k + 7
        rows = sorted({1, R - 1, R, R + 1, 2 * R, nq - 1, nq} - {0})
        flags = {} if mode is AlignMode.LOCAL else dict(
            zero_row=n_aff % 3 == 0, zero_col=n_aff % 2 == 0, tb=0 if n_aff % 4 < 2 else -5)
        capture_case(rng.integers(0, 5, 96 * k + 50).astype(np.int8),
                     rng.integers(0, 5, nq).astype(np.int8), cfg, rows, (k, 32), cell, **flags)
        n_aff += 1
    iupac_aff = ScoringConfig(matrix=matrices.iupac(), gap_open=-4, gap_extend=-1)
    for cfg, lm, ln, rows, geometry, flags in [
            (aff, 5000, 1, [1], None, dict(tb=0)), (aff, 1, 3000, [1, 1500, 3000], None, {}),
            (masked_aff, 1, 1, [1], None, {}), (masked_aff, 700, 600, [300, 600], None, {}),
            (aff, 3000, 2500, [1023, 1024, 1025, 2500], (4, 256), dict(tb=0)),
            (aff.with_mode(AlignMode.LOCAL), 900, 5000, [511, 512, 513, 4999], (8, 64), {}),
            (iupac_aff, 700, 900, [450], None, dict(tb=-2, zero_col=True))]:
        hi = 16 if cfg.has_matrix else 5
        capture_case(rng.integers(1, hi, lm).astype(np.int8),
                     rng.integers(1, hi, ln).astype(np.int8), cfg, rows, geometry, **flags)
        n_aff += 1
    print(f"[band_capture_fill vs plain] {n_cap} linear and {n_aff} affine cases equal to "
          f"capture_plain word for word (all 76 instantiations over three strips with rows "
          f"at the strip edges, zero boundaries, DNA and IUPAC matrices, masked local, affine "
          f"tb = gap_open and 0, 1-row and 1-column tables; captured rows, last row, last "
          f"column, located cell, last row of F); {time.perf_counter() - t0:.1f} s")

    # phase (a3): the strip pipeline where races would show
    pctx = argparse.Namespace(dev=dev, rng=rng, smi=smi, cuda_ms=cuda_ms)
    pipeline_phase(pctx, hold_capture)

    # phase (c): Smith-Waterman on the 64gb-shape pair, align_score (band_fill)
    cfg_sw = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
    reset_counts()
    t0 = time.perf_counter()
    score_sw = tpualign_torch.align_score(s1, s2, cfg_sw)
    sw_wall = time.perf_counter() - t0
    sw_counts = read_counts()
    if not only(sw_counts, "band_fill"):
        raise AssertionError(f"SW align_score did not run one band_fill launch: {sw_counts}")
    # one plain fill in align's orientation (s1 across the columns, s2 down
    # the rows) holds both kernels: the value of its located cell is the SW
    # score (band_fill's, in either orientation), the cell the forward
    # locate's (band_capture_fill)
    t1d, q2d = torch.from_numpy(s1).to(dev), torch.from_numpy(s2).to(dev)
    sw_plain_ms, sw_plain = host_ms(lambda: band.capture_plain(t1d, q2d, cfg_sw, cell=True))
    plain_cell = sw_plain.cell.tolist()
    if args.corpus is not None and score_sw != SW_PIN:
        raise AssertionError(f"64gb corpus SW score {score_sw} != the pin {SW_PIN}")
    if score_sw != plain_cell[0]:
        raise AssertionError(f"SW align_score {score_sw} != capture_plain's {plain_cell}")
    p = band.plan(m, n, cfg_sw)
    text, query = (s2, s1) if p.swapped else (s1, s2)
    tb, qb = torch.from_numpy(text).to(dev), torch.from_numpy(query).to(dev)
    sw_ms, sw_runs, sw_out = cuda_ms(lambda: band.band_fill(tb, qb, p.cfg, p.ends), runs=3)
    as_align = int(band.band_fill(t1d, q2d, cfg_sw, band._ends_flags(cfg_sw, False)))
    bk["max_abs_err"] = max(bk["max_abs_err"], abs(int(sw_out) - plain_cell[0]),
                            abs(as_align - plain_cell[0]))
    if bk["max_abs_err"]:
        raise AssertionError(f"band_fill differs from the plain SW score: {bk}")
    sw_plan = band.pipeline_plan(query.size, text.size, False, None, band.max_k(cfg_sw))
    print(f"[path: align_score SW] {m} x {n} ({source}), (2, -1, -2) local: score "
          f"{score_sw} equal to capture_plain's on the card (band_fill in both "
          f"orientations); launches {sw_counts}; wall {sw_wall:.3f} s; geometry k = "
          f"{sw_plan.k}, {sw_plan.threads} threads, {sw_plan.blocks} blocks, "
          f"{sw_plan.strips} strips, a ring of {sw_plan.depth} rows")
    print(f"[timing] {smi}: band_fill SW at {query.size} x {text.size}: median of 3 "
          f"{sw_ms:.3f} ms ({m * n / sw_ms / 1e6:.2f} GCUPS; runs {runs_str(sw_runs)} ms); "
          f"capture_plain with the located cell {sw_plain_ms:.1f} ms "
          f"({m * n / sw_plain_ms / 1e6:.3f} GCUPS)")
    bk.update(ms=sw_ms, plain_ms=sw_plain_ms, shape=f"{query.size}x{text.size}",
              geometry=[sw_plan.k, sw_plan.threads, sw_plan.blocks])
    # a small sweep of K6 SW's geometry (threads x blocks), the one-block
    # schedule beside it, at this shape and at 20,000 x 20,000
    bk["sweep_64gb"] = k6_sweep(pctx, "SW", tb, qb, p.cfg, p.ends, K6_SWEEP_64GB)
    bk["sweep_64gb"].update(k6_sweep(pctx, "SW one block", tb, qb, p.cfg, p.ends,
                                     [(16, 256, 1)], runs=1))
    ta, tq = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    bk["sweep_20k"] = k6_sweep(pctx, "SW", ta, tq, cfg_sw, band._ends_flags(cfg_sw, False),
                               K6_SWEEP_20K)
    del ta, tq
    loc_ms, loc_runs, loc = cuda_ms(lambda: band.capture_fill(t1d, q2d, cfg_sw, cell=True),
                                    runs=3)
    hold_capture(loc, sw_plain, f"the SW locate at {n} x {m}")
    del sw_plain, loc
    # K8 on the same pair under the same config, held to the same plain
    # value: align_score's pallas engine (one diag_fill launch, the shorter
    # sequence down the rows), then diag_fill timed alone
    reset_counts()
    t0 = time.perf_counter()
    score_pd = tpualign_torch.align_score(s1, s2, cfg_sw, EngineConfig(impl="pallas"))
    pd_wall = time.perf_counter() - t0
    pd_counts = read_counts()
    if not only(pd_counts, "diag_fill"):
        raise AssertionError(f"pallas SW align_score did not run one diag_fill: {pd_counts}")
    lng_d, sht_d = (q2d, t1d) if n >= m else (t1d, q2d)
    d64_ms, d64_runs, d64 = cuda_ms(lambda: pallas_diag.diag_fill(lng_d, sht_d, cfg_sw), runs=3)
    d64_plan = pallas_diag.diag_fill.last_plan
    d64_err = max(abs(int(d64) - plain_cell[0]), abs(score_pd - plain_cell[0]))
    dk["max_abs_err"] = max(dk["max_abs_err"], d64_err)
    if d64_err:
        raise AssertionError(f"diag_fill SW {int(d64)} (align_score {score_pd}) != the plain "
                             f"SW score {plain_cell[0]}")
    dk.update(ms_64gb_sw=d64_ms, shape_64gb_sw=f"{sht_d.numel()}x{lng_d.numel()}",
              launches_64gb_sw=pd_counts["diag_fill"],
              geometry_64gb_sw=[d64_plan.k, d64_plan.threads, d64_plan.blocks])
    print(f"[path: align_score pallas SW] {m} x {n}: score {score_pd} equal to capture_plain's "
          f"on the card; launches {pd_counts}; wall {pd_wall:.3f} s; {d64_plan}")
    print(f"[timing] {smi}: diag_fill SW at {sht_d.numel()} x {lng_d.numel()}: median of 3 "
          f"{d64_ms:.3f} ms ({m * n / d64_ms / 1e6:.2f} GCUPS; runs {runs_str(d64_runs)} ms); "
          f"its plain value the SW capture_plain's above ({sw_plain_ms:.1f} ms)")

    # phase (e): this slice's main path, align under Smith-Waterman on the
    # 64gb-shape pair: the locate, the anchored start locate, the core's
    # split over band_capture_fill, the leaf walks
    reset_counts()
    sw_stats = {}
    t0 = time.perf_counter()
    sc, a1, a2 = tpualign_torch.align(s1, s2, cfg_sw, stats=sw_stats)
    sw_align_wall = time.perf_counter() - t0
    sw_align_counts = read_counts()
    n_cap_launch = sw_align_counts["band_capture_fill"]
    if n_cap_launch < 3 or sum(sw_align_counts.values()) != n_cap_launch:
        raise AssertionError(f"SW align did not run band_capture_fill alone: {sw_align_counts}")
    if not core_ok(s1, s2, a1, a2, oracle.BASES):
        raise AssertionError("64gb-shape SW alignment is not valid")
    rescored = oracle.alignment_score(a1, a2, cfg_sw)
    if not sc == rescored == score_sw:
        raise AssertionError(f"64gb-shape SW alignment score {sc} (re-scored {rescored}) "
                             f"!= align_score's {score_sw}")
    print(f"[main path: align SW] {m} x {n} ({source}), (2, -1, -2) local: alignment valid, "
          f"{len(a1)} columns, score {sc} equal to align_score's; launches "
          f"{sw_align_counts}; wall {sw_align_wall:.3f} s")
    del a1, a2
    if sw_stats["route"] != "core" or tuple(sw_stats["end"]) != tuple(plain_cell[1:]):
        raise AssertionError(f"SW align took {sw_stats}, the plain locate {plain_cell}")
    (i_end, j_end), (i0, j0) = sw_stats["end"], sw_stats["start"]
    gsw = cfg_sw.with_mode(AlignMode.GLOBAL)
    rt = torch.from_numpy(s1[:j_end][::-1].copy()).to(dev)
    rq = torch.from_numpy(s2[:i_end][::-1].copy()).to(dev)
    anc_ms, anc_runs, _ = cuda_ms(lambda: band.capture_fill(rt, rq, gsw, cell=True), runs=3)
    del rt, rq
    # the core's root capture fill, held against capture_plain at its shape
    # (the global instantiation the anchored locate and the core share)
    ct = torch.from_numpy(s1[j0:j_end].copy()).to(dev)
    cq = torch.from_numpy(s2[i0:i_end].copy()).to(dev)
    core_rows = hirschberg._kway_rows(i_end - i0)
    core_plain_ms, core_plain = host_ms(
        lambda: band.capture_plain(ct, cq, gsw, core_rows, cell=True))
    core_ms, core_runs, core_k = cuda_ms(
        lambda: band.capture_fill(ct, cq, gsw, core_rows, cell=True), runs=3)
    hold_capture(core_k, core_plain, f"the SW core's root, {cq.numel()} x {ct.numel()}, "
                                     f"{len(core_rows)} rows")
    del core_k
    # the root's fill as the path runs it (captures, no located cell: the
    # instantiation of the root's forward and reverse fills), held against
    # the same plain fill without its cell
    bare_ms, bare_runs, bare = cuda_ms(lambda: band.capture_fill(ct, cq, gsw, core_rows), runs=3)
    hold_capture(bare, core_plain._replace(cell=None),
                 f"the SW core's root as the path fills it, {cq.numel()} x {ct.numel()}, "
                 f"{len(core_rows)} rows")
    del core_plain, bare, ct, cq
    print(f"[path split: align SW] {json.dumps(sw_stats)}")
    print(f"[timing] {smi}: band_capture_fill at the 64gb shape, median of 3: SW locate "
          f"{loc_ms:.3f} ms (runs {runs_str(loc_runs)}); anchored start locate "
          f"{i_end} x {j_end} {anc_ms:.3f} ms (runs {runs_str(anc_runs)}); the core's root "
          f"fill, {len(core_rows)} rows, {bare_ms:.3f} ms (runs {runs_str(bare_runs)}), "
          f"with the located cell {core_ms:.3f} ms (runs {runs_str(core_runs)}), both equal "
          f"to capture_plain word for word (plain {core_plain_ms:.1f} ms); the SW locate equal "
          f"to capture_plain's (plain {sw_plain_ms:.1f} ms)")
    ck.update(sw_locate_ms=loc_ms, sw_locate_plain_ms=sw_plain_ms, sw_shape=f"{n}x{m}",
              anchored_ms=anc_ms, core_root_ms=bare_ms, core_root_cell_ms=core_ms,
              core_root_plain_ms=core_plain_ms)

    # phase (g): this slice's main path, align under affine gaps (2, -1,
    # open -5, extend -2) on the 64gb-shape pair, global and local: Myers-
    # Miller over band_capture_fill, the leaf walks on the host; each scored
    # against align_score's (band_fill, K6: a second kernel as witness)
    cfg_aff = ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2)
    aff_paths = {}
    for name, cfg in (("global", cfg_aff), ("local", cfg_aff.with_mode(AlignMode.LOCAL))):
        witness = tpualign_torch.align_score(s1, s2, cfg)
        reset_counts()
        stats = {}
        t0 = time.perf_counter()
        sc, a1, a2 = tpualign_torch.align(s1, s2, cfg, stats=stats)
        wall = time.perf_counter() - t0
        counts = read_counts()
        n_launch = counts["band_capture_fill"]
        if n_launch < 2 or sum(counts.values()) != n_launch:
            raise AssertionError(f"affine {name} align did not run band_capture_fill alone: "
                                 f"{counts}")
        valid = (core_ok if cfg.is_local else alignment_ok)(s1, s2, a1, a2, oracle.BASES)
        rescored = oracle.alignment_score(a1, a2, cfg)
        if not valid or not sc == rescored == witness:
            raise AssertionError(f"64gb-shape affine {name} alignment valid {valid}, score {sc} "
                                 f"(re-scored {rescored}), align_score's {witness}")
        aff_paths[name] = dict(launches=n_launch, wall_s=wall, stats=stats)
        print(f"[main path: align affine {name}] {m} x {n} ({source}), (2, -1, open -5, "
              f"extend -2): alignment valid, {len(a1)} columns, score {sc} equal to "
              f"align_score's (band_fill); launches {counts}; wall {wall:.3f} s")
        print(f"[path split: align affine {name}] {json.dumps(stats)}")
        del a1, a2
    # the Myers-Miller root's forward fill (rows 1..n/2 under tb = gap_open:
    # the last rows H and F), held word for word against capture_plain at its
    # full shape
    mid = n // 2
    qh = q2d[:mid]
    root_plain_ms, root_plain = host_ms(lambda: band.capture_plain(t1d, qh, cfg_aff))
    root_ms, root_runs, root_k = cuda_ms(lambda: band.capture_fill(t1d, qh, cfg_aff), runs=3)
    hold_capture(root_k, root_plain, f"the affine root's forward fill, {mid} x {m}")
    del root_k, root_plain
    # the local path's locate (local affine, the located cell, 8 rows a
    # thread) on its own
    cfg_aff_sw = cfg_aff.with_mode(AlignMode.LOCAL)
    aloc_ms, aloc_runs, _ = cuda_ms(lambda: band.capture_fill(t1d, q2d, cfg_aff_sw, cell=True),
                                    runs=1)
    print(f"[timing] {smi}: band_capture_fill affine at the 64gb shape: the Myers-Miller "
          f"root's forward fill {mid} x {m} median of 3 {root_ms:.3f} ms "
          f"({m * mid / root_ms / 1e6:.2f} GCUPS; runs {runs_str(root_runs)}), equal to "
          f"capture_plain word for word (H and F, plain {root_plain_ms:.1f} ms); the local "
          f"locate {n} x {m} {aloc_ms:.3f} ms ({m * n / aloc_ms / 1e6:.2f} GCUPS; runs "
          f"{runs_str(aloc_runs)})")
    root_plan = band.pipeline_plan(mid, m, True, None, band.max_k(cfg_aff))
    ck.update(launches=aff_paths["global"]["launches"], ms=root_ms, plain_ms=root_plain_ms,
              shape=f"{mid}x{m}", geometry=[root_plan.k, root_plan.threads, root_plan.blocks],
              affine_local_launches=aff_paths["local"]["launches"],
              affine_local_locate_ms=aloc_ms, sw_align_launches=n_cap_launch)

    # phase (d): further paths at 20,000 x 20,000, each through align_score
    # and against the plain version
    further = [
        ("dna NW", ScoringConfig(matrix=matrices.dna(2, -1, -3), gap=-3), "auto"),
        ("semiglobal", ScoringConfig(match=2, mismatch=-1, gap=-2,
                                     mode=AlignMode.SEMIGLOBAL), "auto"),
        ("infix", ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.INFIX), "auto"),
        ("affine NW", ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2), "auto"),
        ("affine SW", ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2,
                                    mode=AlignMode.LOCAL), "auto"),
        ("masked affine SW", masked_aff, "auto"),
        ("pallas NW", ScoringConfig(match=2, mismatch=-1, gap=-2), "pallas"),
    ]
    a20, b20 = a, b
    further_ms = {}
    for name, cfg, impl in further:
        reset_counts()
        got = tpualign_torch.align_score(a20, b20, cfg, EngineConfig(impl=impl))
        counts = read_counts()
        kernel = "diag_fill" if impl == "pallas" else "band_fill"
        if not only(counts, kernel):
            raise AssertionError(f"{name}: align_score did not run one {kernel}: {counts}")
        if impl == "pallas":  # pallas_diag.score's orientation: s2 the shorter
            lng, sht = (a20, b20) if a20.size >= b20.size else (b20, a20)
            tl, ts = torch.from_numpy(lng).to(dev), torch.from_numpy(sht).to(dev)
            kms, kruns, out = cuda_ms(lambda: pallas_diag.diag_fill(tl, ts, cfg))
            pms, want = host_ms(lambda: int(pallas_diag.score_plain(tl, ts, cfg)))
            err = abs(int(out) - want)
            dk["max_abs_err"] = max(dk["max_abs_err"], err)
            dp = pallas_diag.diag_fill.last_plan
            dk.update(launches=counts["diag_fill"], ms=kms, plain_ms=pms,
                      shape=f"{sht.size}x{lng.size}", geometry=[dp.k, dp.threads, dp.blocks],
                      strips=dp.strips, depth=dp.depth)
            geometry = (f"k = {dp.k}, {dp.threads} threads, {dp.blocks} blocks, {dp.strips} "
                        f"strips, a ring of {dp.depth} rows")
        else:
            p = band.plan(a20.size, b20.size, cfg)
            text, query = (b20, a20) if p.swapped else (a20, b20)
            tt20, tq20 = torch.from_numpy(text).to(dev), torch.from_numpy(query).to(dev)
            kms, kruns, out = cuda_ms(lambda: band.band_fill(tt20, tq20, p.cfg, p.ends))
            pms, raw = host_ms(lambda: int(band.score_plain(tt20, tq20, p.cfg, p.ends)))
            err = abs(int(out) - raw)
            bk["max_abs_err"] = max(bk["max_abs_err"], err)
            want = max((raw,) + p.floor)
            further_ms[name] = (kms, pms)
            gp = band.pipeline_plan(query.size, text.size, cfg.is_affine, None, band.max_k(cfg))
            geometry = f"k = {gp.k}, {gp.threads} threads, {gp.blocks} blocks"
        if err or got != want:
            raise AssertionError(f"{name}: align_score {got}, kernel vs plain err {err}, "
                                 f"plain score {want}")
        print(f"[path: {name}] {a20.size} x {b20.size}: align_score {got} equal to the plain "
              f"version's on the card; launches {counts}; {kernel} ({geometry}) median of 5 "
              f"{kms:.3f} ms ({a20.size * b20.size / kms / 1e6:.2f} GCUPS; runs "
              f"{runs_str(kruns)}); plain {pms:.1f} ms")
    bk["ms_20k"] = further_ms

    # phase (f): align at 20,000 x 20,000 past the family, each through
    # band_capture_fill alone (positive-mismatch SW: one diag_ckpt_fill
    # launch), valid, and scoring the port's oracle's optimum
    aligns = [
        ("dna NW", ScoringConfig(matrix=matrices.dna(2, -1, -3), gap=-3), "auto"),
        ("semiglobal", ScoringConfig(match=2, mismatch=-1, gap=-2,
                                     mode=AlignMode.SEMIGLOBAL), "auto"),
        ("infix", ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.INFIX), "auto"),
        ("SW", cfg_sw, "auto"),
        ("positive-mismatch SW", masked, "auto"),
        ("pallas NW", ScoringConfig(match=2, mismatch=-1, gap=-2), "pallas"),
        ("family past the bit-parallel block", ScoringConfig(), "auto"),
        ("affine NW", cfg_aff, "auto"),
        ("affine SW", cfg_aff_sw, "auto"),
        ("positive-mismatch affine SW", masked_aff, "auto"),
        ("affine semiglobal", cfg_aff.with_mode(AlignMode.SEMIGLOBAL), "auto"),
        ("affine infix", cfg_aff.with_mode(AlignMode.INFIX), "auto"),
        ("affine dna", dataclasses.replace(cfg_aff, matrix=matrices.dna(2, -1, -3)), "auto"),
    ]
    for name, cfg, impl in aligns:
        # tpualign's route for a positive-mismatch SW: the diagonal-band
        # traceback over K9, one launch (phase (j) holds it)
        kernel = "diag_ckpt_fill" if name == "positive-mismatch SW" else "band_capture_fill"
        max_rows = hirschberg.MAX_QUERY_ROWS
        if name.startswith("family"):  # hirschberg refuses it: the band split takes it
            hirschberg.MAX_QUERY_ROWS = b20.size - 1
        reset_counts()
        t0 = time.perf_counter()
        try:
            sc, a1, a2 = tpualign_torch.align(a20, b20, cfg, EngineConfig(impl=impl))
        finally:
            hirschberg.MAX_QUERY_ROWS = max_rows
        wall = time.perf_counter() - t0
        counts = read_counts()
        if kernel == "diag_ckpt_fill":
            ran = only(counts, kernel)
        else:
            ran = counts[kernel] >= 2 and sum(counts.values()) == counts[kernel]
        if not ran:
            raise AssertionError(f"{name}: align did not run {kernel} alone: {counts}")
        whole = not (cfg.is_local or cfg.is_ends_free)
        valid = (alignment_ok(a20, b20, a1, a2, oracle.BASES) if whole
                 else core_ok(a20, b20, a1, a2, oracle.BASES))
        want = oracle.score(a20, b20, cfg)
        if not valid or not sc == oracle.alignment_score(a1, a2, cfg) == want:
            raise AssertionError(f"{name}: 20k alignment valid {valid}, score {sc}, oracle {want}")
        print(f"[path: align {name}] {a20.size} x {b20.size}: alignment valid, score {sc} equal "
              f"to the oracle's; launches {counts}; wall {wall:.3f} s")
    # the global capture instantiation with the located cell at 20k (the
    # anchored locate's and a core root's mode)
    g20 = ScoringConfig(match=2, mismatch=-1, gap=-2)
    ta20, tb20 = torch.from_numpy(a20).to(dev), torch.from_numpy(b20).to(dev)
    rows20 = hirschberg._kway_rows(b20.size)
    k20_ms, k20_runs, k20 = cuda_ms(lambda: band.capture_fill(ta20, tb20, g20, rows20, col=True,
                                                              cell=True))
    p20_ms, p20 = host_ms(lambda: band.capture_plain(ta20, tb20, g20, rows20, col=True, cell=True))
    hold_capture(k20, p20, f"20000 x 20000 global, {len(rows20)} rows")
    ck["ms_20k"] = (k20_ms, p20_ms)
    print(f"[timing] {smi}: band_capture_fill global at 20000 x 20000 with {len(rows20)} rows, "
          f"the last column and the located cell: median of 5 {k20_ms:.3f} ms (runs "
          f"{runs_str(k20_runs)}); equal to capture_plain word for word (plain {p20_ms:.1f} ms)")
    # the same under affine gaps, with the waived top-edge open (tb = 0) and
    # the last row of F
    a20_ms, a20_runs, ka20 = cuda_ms(lambda: band.capture_fill(ta20, tb20, cfg_aff, rows20,
                                                               col=True, cell=True, tb=0))
    pa20_ms, pa20 = host_ms(lambda: band.capture_plain(ta20, tb20, cfg_aff, rows20, col=True,
                                                       cell=True, tb=0))
    hold_capture(ka20, pa20, f"20000 x 20000 affine global, tb = 0, {len(rows20)} rows")
    ck["affine_ms_20k"] = (a20_ms, pa20_ms)
    print(f"[timing] {smi}: band_capture_fill affine global at 20000 x 20000, tb = 0, with "
          f"{len(rows20)} rows, the last column, the located cell and the last row of F: "
          f"median of 5 {a20_ms:.3f} ms (runs {runs_str(a20_runs)}); equal to capture_plain "
          f"word for word (plain {pa20_ms:.1f} ms)")

    # phase (h): this slice's main path, align_score_batch over the two
    # batch kernels.  Small cases first: every batch instantiation against
    # its plain version on ragged batches (1-base pairs, pairs past one
    # strip), and the entry with empty pairs mixed in against the per-pair
    # align_score
    t0 = time.perf_counter()
    k5 = dict(max_abs_err=0)  # bitpal_batch_fill
    kb = dict(max_abs_err=0)  # band_batch_fill
    shifts = torch.arange(bitpal.WORD, device=dev)

    def enc_rows(planes):
        """Every row's enc from ``(P, B, nw)`` planes."""
        return sum(((planes[:, b, :, None] >> shifts) & 1) << b for b in range(planes.shape[1]))

    def hold_k5(got, want, where):
        """``bitpal_batch_fill``'s planes against ``batch_fill_plain``'s, word
        for word; records the largest difference of a row's enc."""
        torch.cuda.synchronize()
        err = int((enc_rows(got) - enc_rows(want)).abs().max())
        if err or not torch.equal(got, want):
            raise AssertionError(f"bitpal_batch_fill differs from batch_fill_plain at {where} "
                                 f"(max abs err {err})")
        k5["max_abs_err"] = max(k5["max_abs_err"], err)

    def hold_band_batch(got, want, where):
        """``band_batch_fill``'s per-pair results against ``xla.score_batch``'s."""
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err:
            raise AssertionError(f"band_batch_fill differs from xla.score_batch at {where} "
                                 f"(max abs err {err})")
        kb["max_abs_err"] = max(kb["max_abs_err"], err)

    def ragged(count, tmax, qmax, lo=1):
        """``count`` pairs of random lengths, the first 1 x 1, the last with the
        longest query."""
        tl = rng.integers(1, tmax + 1, count)
        ql = rng.integers(1, qmax + 1, count)
        tl[0], ql[0], ql[-1] = 1, 1, qmax
        return ([rng.integers(lo, 5, int(x)).astype(np.int8) for x in tl],
                [rng.integers(lo, 5, int(x)).astype(np.int8) for x in ql])

    # K5: every segment width (1, 2, 3, 5, 8, 16 words) and one to five
    # bands (17, 32, 33, 65, 130 words; texts past 2,048 columns, where the
    # rows a band down stop saturating), g cycling 1..7, at the planner's
    # blocks, at one block, and at fewer blocks than a pair's bands over
    # rings of 2 rows, each launch K5_REPEAT times against one plain run
    n_k5 = n_k5_launch = 0
    for nw in (1, 2, 3, 5, 8, 16, 17, 32, 33, 65, 130):
        g = n_k5 % bitpal.MAX_G + 1
        wide = nw > bitpal.SEGMENT_MAX
        texts, queries = ragged(9, 2600 if wide else 300, nw * bitpal.WORD - 5, lo=0)
        packed = packing.pack_pairs(texts, queries, np.arange(9)).to(dev)
        tpad, mt, eq, _ = bitpal.batch_inputs(packed)
        want = bitpal.batch_fill_plain(tpad, mt, eq, packed.n_cap, g)
        bands = -(-nw // bitpal.BAND)
        for blocks, shallow in ((None, False), (1, False), (bands - 1 if bands > 2 else 2, True)):
            ring_budget = band.ring_budget
            if shallow:  # room for 2 rows a pair
                band.ring_budget = lambda *a, **kw: 2 * tpad.numel()
            try:
                for _ in range(K5_REPEAT):
                    plan = bitpal.batch_plan(9, nw, tpad.shape[1], blocks, band.ring_budget())
                    hold_k5(bitpal.batch_fill(tpad, mt, eq, packed.n_cap, g, blocks), want,
                            f"a ragged batch, nw = {nw}, g = {g}, {plan}")
                    n_k5_launch += 1
            finally:
                band.ring_budget = ring_budget
            if shallow and bands > 2 and bitpal.batch_fill.last_plan.depth != 2:
                raise AssertionError(f"the rings were not cut to 2 rows: {plan}")
        n_k5 += 1
    n_kb = 0
    for k, affine, mat, local in itertools.product(
            (1, 2, 4, 8, 16), (False, True), (None, matrices.dna(2, -1, -3)), (False, True)):
        if affine and local and k > band.MAX_K_LOCAL_AFFINE:
            continue
        mode = (AlignMode.LOCAL if local
                else (AlignMode.GLOBAL, AlignMode.SEMIGLOBAL, AlignMode.INFIX)[n_kb % 3])
        gaps = dict(gap_open=-5, gap_extend=-2) if affine else {}
        cfg = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=mode, matrix=mat, **gaps)
        texts, queries = ragged(5, 100, 64 * k + 7, lo=0)  # three strips at R = 32 k
        packed = packing.pack_pairs(texts, queries, np.arange(5)).to(dev)
        ends = band._ends_flags(cfg, False)
        hold_band_batch(band_batch.batch_fill(packed, cfg, ends, (k, 32)),
                        xla.score_batch(packed, cfg, ends), f"{cfg}, k = {k}")
        n_kb += 1
    n_entry = 0
    for cfg in (ScoringConfig(), ScoringConfig(gap=-3), cfg_sw, cfg_aff,
                ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.INFIX),
                ScoringConfig(matrix=matrices.dna(2, -1, -3), gap=-3), masked_aff):
        texts, queries = ragged(7, 300, 300)
        texts[2], queries[4], texts[5], queries[5] = (np.empty(0, np.int8),) * 4
        got = tpualign_torch.align_score_batch(texts, queries, cfg)
        want = [tpualign_torch.align_score(t, q, cfg) for t, q in zip(texts, queries)]
        if got.tolist() != want:
            raise AssertionError(f"align_score_batch {got.tolist()} != align_score's {want}: "
                                 f"{cfg}")
        n_entry += 1
    print(f"[batch kernels vs plain] bitpal_batch_fill equal to batch_fill_plain word for "
          f"word in {n_k5} ragged batches x 3 block counts x {K5_REPEAT} launches "
          f"({n_k5_launch}: every segment width, one to five bands, codes 0..4, 1-base pairs, "
          f"one block, fewer blocks than bands over rings of 2 rows); "
          f"band_batch_fill equal to xla.score_batch in {n_kb} ragged batches (all 38 "
          f"instantiations, global, semiglobal, infix and local, three strips at k x 32 "
          f"rows); align_score_batch with empty pairs mixed in equal to align_score in "
          f"{n_entry} configs; {time.perf_counter() - t0:.1f} s")

    # the main path at full width: mix (A), the repo's serving demo, and mix
    # (B), 8,192 short-read candidate checks.  Each align_score_batch runs
    # with the counts set to 0 just before it: one launch of its batch kernel
    # and nothing else; its scores against the port's per-pair align_score
    # (K1, K2 or K6: another kernel as witness), its kernel against the
    # batched plain version on the same inputs
    mixes = {"A": serve_pairs(), "B": read_pairs()}
    for name, (texts, queries) in mixes.items():
        tl = np.fromiter(map(len, texts), np.int64)
        ql = np.fromiter(map(len, queries), np.int64)
        print(f"[mix {name}] {len(texts)} pairs, texts {tl.min()}..{tl.max()} and queries "
              f"{ql.min()}..{ql.max()} bases, {int((tl * ql).sum())} DP cells")
    batch_phases = {}

    def drive_batch(tag, mix, cfg, kernel):
        """One counted ``align_score_batch`` of the mix under ``cfg``, a warm
        one, and the per-pair ``align_score`` loop over the same pairs."""
        texts, queries = mixes[mix]
        reset_counts()
        t0 = time.perf_counter()
        scores = tpualign_torch.align_score_batch(texts, queries, cfg)
        wall = time.perf_counter() - t0
        counts = read_counts()
        if not only(counts, kernel):
            raise AssertionError(f"{tag}: align_score_batch did not run one {kernel}: {counts}")
        t0 = time.perf_counter()
        again = tpualign_torch.align_score_batch(texts, queries, cfg)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        witness = np.asarray([tpualign_torch.align_score(t, q, cfg)
                              for t, q in zip(texts, queries)])
        loop = time.perf_counter() - t0
        bad = np.flatnonzero((scores != witness) | (again != witness))
        if bad.size:
            raise AssertionError(f"{tag}: {bad.size} batch scores differ from align_score's, "
                                 f"pair {bad[0]}: {scores[bad[0]]} != {witness[bad[0]]}")
        lens = [(t.size, q.size) for t, q in zip(texts, queries)]
        batch_phases[tag] = dict(launches=counts[kernel], wall_s=wall, warm_wall_s=warm,
                                 loop_s=loop, cells=sum(a * b for a, b in lens))
        return packing.pack_pairs(texts, queries, np.arange(len(texts))).to(dev), lens

    def time_k5(tag, mix, g, cfg):
        packed, lens = drive_batch(tag, mix, cfg, "bitpal_batch_fill")
        tpad, mt, eq, _ = bitpal.batch_inputs(packed)
        kms, kruns, got = cuda_ms(lambda: bitpal.batch_fill(tpad, mt, eq, packed.n_cap, g))
        pms, want = host_ms(lambda: bitpal.batch_fill_plain(tpad, mt, eq, packed.n_cap, g))
        hold_k5(got, want, f"mix {mix}, g = {g}")
        # the bit-parallel count (see the bounds below) over the words each
        # pair needs; bytes: texts, match planes and final planes
        P, nw = eq.shape[0], eq.shape[2]
        words = sum(m * -(-n // bitpal.WORD) for m, n in lens)
        nbytes = sum(m for m, _ in lens) + 8 * P + (bitpal.ALPHABET + bitpal.n_planes(g)) * P * nw * 8
        b_ms, by = bound(nbytes, words * (25 if g == 1 else 50) * 2)
        plan = bitpal.batch_fill.last_plan
        report_batch(tag, "bitpal_batch_fill", kms, kruns, pms, b_ms, by,
                     f"{plan.width} lanes a pair, {plan.bands} bands a pair, {plan.blocks} "
                     f"blocks of one warp, rings of {plan.depth} rows")

    def time_band(tag, mix, cfg):
        packed, lens = drive_batch(tag, mix, cfg, "band_batch_fill")
        ends = band._ends_flags(cfg, False)
        kms, kruns, got = cuda_ms(lambda: band_batch.batch_fill(packed, cfg, ends))
        pms, want = host_ms(lambda: xla.score_batch(packed, cfg, ends))
        hold_band_batch(got, want, f"mix {mix}, {cfg}")
        P = len(lens)
        nbytes = sum(m + n for m, n in lens) + 28 * P
        b_ms, by = bound(nbytes, band_ops(cfg, batch_phases[tag]["cells"]))
        k, threads = band.kernel_geometry(packed.n_cap, band.max_k(cfg))
        report_batch(tag, "band_batch_fill", kms, kruns, pms, b_ms, by,
                     f"k = {k}, {threads} threads, {P} blocks")

    def report_batch(tag, kernel, kms, kruns, pms, b_ms, by, geometry):
        ph = batch_phases[tag]
        ph.update(kernel=kernel, ms=kms, plain_ms=pms, bound_ms=b_ms, bound_by=by,
                  geometry=geometry)
        print(f"[main path: align_score_batch {tag}] {ph['cells']} cells: one {kernel} "
              f"launch ({geometry}); every score equal to align_score's; the kernel equal to "
              f"its plain version; align_score_batch wall {ph['wall_s'] * 1e3:.3f} ms "
              f"(warm {ph['warm_wall_s'] * 1e3:.3f} ms), per-pair align_score loop "
              f"{ph['loop_s'] * 1e3:.3f} ms")
        print(f"[timing] {smi}: {kernel} {tag}: median of 5 {kms:.3f} ms "
              f"({ph['cells'] / kms / 1e6:.2f} GCUPS aggregate; runs {runs_str(kruns)}); "
              f"plain {pms:.1f} ms; bound {b_ms:.4f} ms ({by})")

    time_k5("A (1, 0, -1)", "A", 1, ScoringConfig())
    time_k5("A (1, 0, -2)", "A", 2, ScoringConfig(gap=-2))
    time_band("A SW", "A", cfg_sw)
    time_band("A affine", "A", cfg_aff)
    time_band("B infix", "B", ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.INFIX))
    time_k5("B (1, 0, -1)", "B", 1, ScoringConfig())
    print(f"[phase h] {time.perf_counter() - t0:.1f} s")

    # phase (i): this slice's main path, align_score on the staggered fills'
    # routes (K3a, K3b, K4's chunks with their state)
    rc_kernels = rc_phase(ctx, RC_SHAPES, a20, b20, want20)

    # phase (j): this slice's main path, the checkpointed diagonal fill
    # (K9) under align_diag and align's positive-mismatch SW route
    ckpt_kernel = ckpt_phase(ctx, s1, s2, score, a20, b20)

    # phase (k): the ring's budget from the card's free memory: the
    # planner's wide plans and a fill whose ring passes 1 GiB
    bk["wide"] = wide_phase(ctx)

    for pkg in ("jax", "tpualign"):
        if pkg in sys.modules:
            raise AssertionError(f"the port imported {pkg}")
    # bounds from this run's shapes: the bit-parallel kernels do about 25
    # 64-bit operations (50 at 3 or 4 planes), each two 32-bit ones, per
    # word of 64 query rows and column; they read the text and the match
    # planes and write the final planes (and the captures)
    nw = -(-n // bitpal.WORD)
    plane_bytes = m + (bitpal.ALPHABET + 2) * nw * 8
    cells = m * n
    d_cells = a20.size * b20.size
    bounds = {
        "bitpal_gfill_g1": bound(plane_bytes, m * nw * 25 * 2),
        "bitpal_gfill": bound(plane_bytes, m * nw * 50 * 2),
        "bitpal_capture_fill": bound(plane_bytes + len(root_rows) * m, m * nw * 25 * 2),
        "band_fill": bound(m + n + 4, band_ops(cfg_sw, cells)),
        "band_capture_fill": bound(m + mid + 8 * (m + 1), band_ops(cfg_aff, m * mid)),
        "diag_fill": bound(2 * a20.size + 4, band_ops(g20, d_cells)),
    }

    # K8's SW hold at the 64gb shape does K6's SW work
    dk["bound_ms_64gb_sw"] = bounds["band_fill"][0]

    def extra(name):
        b_ms, by = bounds[name]
        return dict(bound_ms=b_ms, bound_by=by, library_ms=None)

    print(json.dumps({"kernels": [{
        "name": "bitpal_gfill_g1", "route": "cuda", "source": GKERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms, "shape": k1_shape, "geometry": pipe_geometry,
        "sweep_64gb": k1_sweep, **extra("bitpal_gfill_g1"),
    }] + [{
        "name": name, "route": "cuda", "source": GKERNEL_SOURCE,
        "replaces": GREPLACES[name],
        "launches": {"bitpal_gfill": g_counts["fill_g"],
                     "bitpal_capture_fill": align_counts["capture_fill"]}[name],
        **gk[name], **extra(name),
    } for name in GREPLACES] + [{
        "name": "band_fill", "route": "cuda", "source": BAND_SOURCE,
        "replaces": BAND_REPLACES, "launches": sw_counts["band_fill"], **bk,
        **extra("band_fill"),
    }, {
        "name": "band_capture_fill", "route": "cuda", "source": BAND_SOURCE,
        "replaces": CAPTURE_REPLACES, **ck,
        **extra("band_capture_fill"),
    }, {
        "name": "diag_fill", "route": "cuda", "source": DIAG_SOURCE,
        "replaces": DIAG_REPLACES, **dk, **extra("diag_fill"),
    }] + [{
        "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(ph["launches"] for ph in batch_phases.values()
                        if ph["kernel"] == kernel),
        **held, "ms": batch_phases[main]["ms"], "plain_ms": batch_phases[main]["plain_ms"],
        "shape": f"mix {main}", "bound_ms": batch_phases[main]["bound_ms"],
        "bound_by": batch_phases[main]["bound_by"], "library_ms": None,
        "phases": {tag: {key: ph[key] for key in ("launches", "ms", "plain_ms", "bound_ms",
                                                  "wall_s", "warm_wall_s", "loop_s",
                                                  "geometry")}
                   for tag, ph in batch_phases.items() if ph["kernel"] == kernel},
    } for kernel, source, replaces, held, main in (
        ("bitpal_batch_fill", BATCH_SOURCE, BATCH_REPLACES, k5, "A (1, 0, -1)"),
        ("band_batch_fill", BAND_BATCH_SOURCE, CAPTURE_REPLACES, kb, "A SW"))]
        + rc_kernels + [ckpt_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
