"""Run the port's CUDA kernels on the CPU, for a machine without ``nvcc``.

    python tools/rehearse_kernels.py [--cases N] [--seed S]

Compiles ``tpualign_torch/csrc/band_fill.cu`` (both entry points),
``band_capture_affine.cu``, ``band_batch.cu`` and ``diag_ckpt.cu`` (with
the template they share, ``band_fill.cuh``), ``diag_fill.cu`` (the same
template), and ``bitpal_gfill.cu``, ``bitpal_batch.cu`` and
``bitpal_rc.cu`` (with the step they share, ``bitpal_step.cuh``, the band
pieces of all three, ``bitpal_band.cuh``, and the band body of the first
two, ``bitpal_gband.cuh``) with
``g++`` as C++20 through a shim ``cuda_runtime.h``: one ``std::thread``
per CUDA thread of a block, the blocks of a grid one after another,
``__syncthreads`` as a ``std::barrier``, the warp shuffles (``up``, also
inside segments of a width, ``down`` and indexed) through a slot array
between two barriers,
``__shared__`` as ``static``, the DPX intrinsics as plain max, the
atomics, fences and ``cuda::atomic_ref`` (``<cuda/atomic>``) over
``std::atomic_ref``, ``__ldcg``/``__stcg`` as plain loads and stores,
and each ``<<<G, T, 0, s>>>`` launch rewritten into a call of the shim's
launcher.

Since the blocks run one after another, the first block of a pipelined
fill takes every strip (or band) from the ticket (the others find none
and only join the located cell's reduction): the shim checks the strip
arithmetic, the ring's slots and their wrap-around at every depth, the
progress flags' values and the reduction across blocks, not timing
across blocks, which only the card shows.  ``rehearse_concurrent(1)``
(an entry of the built library) runs a grid's blocks at once instead,
for kernels that keep no ``__shared__`` state across blocks (the
bit-parallel pipeline's blocks of one warp): a band then waits on the band
above through the flags as on the card, a spinning thread yields, and a
store through ``__stcg`` sleeps 50 us first, so that a flag published
before its bytes is read before them (a mutation check caught that
only so).  The kernels then run through
``ctypes`` on CPU buffers over random configs, shapes and geometries
(several strips, partial last strips, every rows- or words-per-thread
count, captured rows at the strip edges, ragged batches with 1 x 1 pairs
and pairs past one strip), and each result is held against the plain
version (``band.score_plain``, ``band.capture_plain``,
``xla.score_batch``, ``pallas_diag.score_plain``, ``pallas_diag.ckpt_plain``,
``bitpal.fill_g_plain`` (``bitpal_gfill`` and ``bitpal_capture_fill``
over forced block counts, captures on band edges, rings of 2 rows,
blocks at once), ``bitpal.batch_fill_plain``,
``bitpal.fill_rc_plain``, and ``bitpal.chunk_plain`` chunk by chunk).  Prints one line
per kernel and exits non-zero on the first mismatch.

A rehearsal of the kernels' logic before a card runs them, not a test of
the CUDA build: what only ``nvcc`` checks (types, intrinsics' signatures,
launch bounds, register use) shows first on the card.  The build goes to
``tpualign_torch/_build/rehearse/`` (git-ignored).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpualign_torch import _build, matrices  # noqa: E402
from tpualign_torch.config import AlignMode, ScoringConfig  # noqa: E402
from tpualign_torch.ops import band, bitpal, pairs, pallas_diag, xla  # noqa: E402

SHIM = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict
#define __shared__ static

struct dim3 { unsigned x = 1, y = 1, z = 1; };
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace shim {
// one block's barrier and shuffle slots; each thread points at its block's
struct Block {
  dim3 id;
  std::barrier<> bar;
  std::vector<long long> slots;
  Block(unsigned b, unsigned threads) : bar(threads), slots(threads) { id.x = b; }
};
inline thread_local dim3 tid;
inline thread_local Block* blk = nullptr;
inline dim3 dims, grid;
// concurrent: every block of a grid at once (kernels without __shared__
// state only: a __shared__ array is one static for all blocks); stores
// through __stcg then sleep first, so that a flag published before its
// bytes is read before them
inline bool concurrent = false;

// the blocks of the grid one after another (or all at once), each with a
// thread per CUDA thread: __shared__ arrays (static here) serve one block
// at a time
template <class F> void launch(unsigned blocks, unsigned threads, F body) {
  dims.x = threads;
  grid.x = blocks;
  std::vector<std::unique_ptr<Block>> bs;
  std::vector<std::thread> pool;
  for (unsigned b = 0; b < blocks; ++b) {
    bs.push_back(std::make_unique<Block>(b, threads));
    Block* mine = bs.back().get();
    for (unsigned t = 0; t < threads; ++t) {
      pool.emplace_back([t, mine, &body] { tid.x = t; blk = mine; body(); });
    }
    if (!concurrent) {
      for (auto& th : pool) th.join();
      pool.clear();
    }
  }
  for (auto& th : pool) th.join();
}
}  // namespace shim

extern "C" __attribute__((weak)) void rehearse_concurrent(int on) { shim::concurrent = on; }

#define threadIdx (shim::tid)
#define blockIdx (shim::blk->id)
#define blockDim (shim::dims)
#define gridDim (shim::grid)
inline void __syncthreads() { shim::blk->bar.arrive_and_wait(); }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int cur = a.load();
  while (cur < v && !a.compare_exchange_weak(cur, v)) {
  }
  return cur;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <class T> T __ldcg(const T* p) { return *p; }
template <class T> void __stcg(T* p, T v) {
  if (shim::concurrent) std::this_thread::sleep_for(std::chrono::microseconds(50));
  *p = v;
}
inline int max(int a, int b) { return a > b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int __viaddmax_s32(int a, int b, int c) { return max(a + b, c); }
inline int __vimax3_s32(int a, int b, int c) { return max(max(a, b), c); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int __vibmax_s32(int a, int b, bool* pred) { *pred = a >= b; return max(a, b); }

// lane src of the warp, every thread of the block passing here together
template <class T> T shuffle_from(T v, int src, bool valid) {
  const int t = threadIdx.x;
  auto& slots = shim::blk->slots;
  slots[t] = static_cast<long long>(v);
  __syncthreads();
  const T out = valid ? static_cast<T>(slots[(t & ~31) + src]) : v;
  __syncthreads();
  return out;
}
template <class T> T shuffle(T v, int src_offset) {
  const int src = (threadIdx.x & 31) + src_offset;
  return shuffle_from(v, src, src >= 0 && src < 32);
}
template <class T> T __shfl_sync(unsigned, T v, int src) { return shuffle_from(v, src & 31, true); }
template <class T> T __shfl_up_sync(unsigned, T v, int d) { return shuffle(v, -d); }
// inside segments of `width` lanes: a lane less than d into its segment keeps v
template <class T> T __shfl_up_sync(unsigned, T v, int d, int width) {
  const int lane = threadIdx.x & 31;
  return shuffle_from(v, lane - d, lane % width >= d);
}
template <class T> T __shfl_down_sync(unsigned, T v, int d) { return shuffle(v, d); }
"""

#: libcu++'s <cuda/atomic> as far as band_fill.cuh uses it
CUDA_ATOMIC = r"""
#pragma once
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include "cuda_runtime.h"
namespace cuda {
enum thread_scope { thread_scope_system, thread_scope_device, thread_scope_block };
// the blocks run one after another here, so a flag that a load finds
// unset is never set: a thread that spins on one aborts instead of hanging.
// Run concurrently, a spinning thread yields, and aborts after 60 s
template <class T, thread_scope S = thread_scope_system>
struct atomic_ref {
  ::std::atomic_ref<T> a;
  explicit atomic_ref(T& x) : a(x) {}
  T load(::std::memory_order order) const {
    static thread_local long loads = 0;
    static thread_local auto since = ::std::chrono::steady_clock::now();
    if (shim::concurrent) {
      ::std::this_thread::yield();
      if ((++loads & 1023) == 0 &&
          ::std::chrono::steady_clock::now() - since > ::std::chrono::seconds(60)) {
        ::std::fprintf(stderr, "rehearse: a thread spins on a flag for 60 s\n");
        ::std::abort();
      }
    } else if (++loads > (1L << 20)) {
      ::std::fprintf(stderr, "rehearse: a thread spins on a flag that is never set\n");
      ::std::abort();
    }
    return a.load(order);
  }
  void store(T v, ::std::memory_order order) const { a.store(v, order); }
};
namespace std {
using ::std::memory_order_acquire;
using ::std::memory_order_release;
}  // namespace std
}  // namespace cuda
"""

LAUNCH = re.compile(r"([\w:]+(?:<[^;<>]*>)?)<<<(\w+), (\w+), 0, ([^>]+)>>>\((.*?)\);", re.S)
SOURCES = ("band_fill.cu", "band_capture_affine.cu", "band_batch.cu", "diag_fill.cu",
           "diag_ckpt.cu", "bitpal_gfill.cu", "bitpal_batch.cu", "bitpal_rc.cu")
HEADERS = ("band_fill.cuh", "bitpal_step.cuh", "bitpal_band.cuh", "bitpal_gband.cuh")


def build(out_dir: Optional[str] = None, sources=SOURCES) -> ctypes.CDLL:
    """Compile ``sources`` (default every kernel source) with g++ through
    the shim into ``out_dir`` (default ``tpualign_torch/_build/rehearse``);
    return the library."""
    out_dir = out_dir or os.path.join(_build.BUILD_DIR, "rehearse")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cuda_runtime.h"), "w") as f:
        f.write(SHIM)
    os.makedirs(os.path.join(out_dir, "cuda"), exist_ok=True)
    with open(os.path.join(out_dir, "cuda", "atomic"), "w") as f:
        f.write(CUDA_ATOMIC)
    objs = []
    for name in tuple(sources) + HEADERS:  # the headers beside the sources that include them
        with open(os.path.join(_build.CSRC, name)) as f:
            src = LAUNCH.sub(r"shim::launch(\2, \3, [&] { \1(\5); });", f.read())
        path = os.path.join(out_dir, name if name in HEADERS else name + ".cpp")
        with open(path, "w") as f:
            f.write(src)
        if name in sources:
            objs.append(path)
    # one g++ per source, all started together, then the link
    procs = [subprocess.Popen(["g++", "-std=c++20", "-O1", "-fPIC", "-I", out_dir, "-c",
                               "-o", src + ".o", src]) for src in objs]
    if any(proc.wait() for proc in procs):
        raise RuntimeError("g++ failed on a kernel source through the shim")
    lib = os.path.join(out_dir, "librehearse.so")
    subprocess.run(["g++", "-shared", "-o", lib, *(src + ".o" for src in objs), "-lpthread"],
                   check=True)
    dll = ctypes.CDLL(lib)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    chunk = [vp, vp, i64] + [i32] * 3 + [vp, i32, vp, i64, i64] + [vp] * 5
    argtypes = {
        "band_fill": [vp, i32, vp, i32, vp] + [i32] * 10 + [vp, i32, vp, vp, vp],
        "band_capture_fill": ([vp, i32, vp, i32, vp] + [i32] * 8
                              + [vp, i32, vp, vp, vp, vp, i32, vp, vp, vp]),
        "band_capture_affine": ([vp, i32, vp, i32, vp] + [i32] * 10
                                + [vp, i32, vp, vp, vp, vp, vp, i32, vp, vp, vp]),
        "band_batch_fill": [vp] * 6 + [i32, i64, vp] + [i32] * 9 + [vp] * 3,
        "diag_fill": [vp, i32, vp, i32] + [i32] * 7 + [vp, i32, vp, vp, vp],
        "diag_ckpt_fill": [vp, i32, vp, i32] + [i32] * 8 + [vp, i32, vp, vp, vp, vp, vp, vp],
        "bitpal_gfill": [vp, vp, i64] + [i32] * 3 + [vp, i32, vp, vp, vp],
        "bitpal_capture_fill": ([vp, vp, i64] + [i32] * 3 + [vp, i32, vp, vp, i32]
                                + [vp, vp, vp]),
        "rehearse_concurrent": [i32],
        "bitpal_batch_fill": [vp, i64, vp, vp] + [i32] * 4 + [vp, i32, vp, vp, vp],
        "bitpal_rc_fill": [vp, vp, i64] + [i32] * 3 + [vp, i32, vp, vp, vp],
        "bitpal_rc_chunk": chunk,
        "bitpal_gfill_chunk": chunk,
    }
    for name, types in argtypes.items():
        if hasattr(dll, name):  # the entries of the sources built
            getattr(dll, name).argtypes = types
    return dll


def _pipe_scratch(rng, n, m, affine, geometry, max_k, cells):
    """A pipelined launch's plan and scratch: the ring and the blocks'
    cells as garbage (a slot read before it is written shows), the flags
    zeroed; at times the ring cut to 2 rows (the deepest backpressure)."""
    plan = band.pipeline_plan(n, m, affine, geometry, max_k)
    if plan.depth > 2 and rng.integers(0, 3) == 0:
        plan = plan._replace(depth=2)
    ring = rng.integers(-99, 99, (max(plan.depth, 1), 2 if affine else 1, m + 1)).astype(np.int32)
    sync = np.zeros(plan.strips + 2, np.int32)
    block_cells = rng.integers(-99, 99, (plan.blocks, 3)).astype(np.int32) if cells else None
    pipe = (ring.ctypes.data, plan.depth, sync.ctypes.data,
            None if block_cells is None else block_cells.ctypes.data)
    return plan, (ring, sync, block_cells), pipe


def _band_case(dll, rng, mode, matrix, affine, m, n, geometry):
    kw = dict(match=int(rng.integers(1, 4)), mismatch=int(rng.integers(-3, 2)),
              gap=int(rng.integers(-4, 0)))
    if matrix is not None:
        kw["matrix"] = matrix
    if affine:
        kw.update(gap_open=int(rng.integers(-6, 1)), gap_extend=int(rng.integers(-3, 0)))
    cfg = ScoringConfig(mode=mode, **kw)
    hi = len(matrix) if matrix is not None else 5
    text = torch.from_numpy(rng.integers(0, hi, m).astype(np.int8))
    query = torch.from_numpy(rng.integers(0, hi, n).astype(np.int8))
    ends = band._ends_flags(cfg, bool(rng.integers(0, 2)))
    plan, keep, pipe = _pipe_scratch(rng, n, m, affine, geometry, band.max_k(cfg), False)
    K = len(matrix) if matrix is not None else 0
    mat = np.ascontiguousarray(np.asarray(matrix if K else [0], np.int32).reshape(-1))
    out = np.full(1, 0 if cfg.is_local else band.NEG, np.int32)
    err = dll.band_fill(text.data_ptr(), m, query.data_ptr(), n, mat.ctypes.data, K,
                        cfg.match, cfg.mismatch, cfg.gap, cfg.gap_open or 0,
                        cfg.gap_extend or 0, band._flags(cfg, ends), plan.k, plan.threads,
                        plan.blocks, *pipe[:3], out.ctypes.data, None)
    want = int(band.score_plain(text, query, cfg, ends))
    ok = err == 0 and int(out[0]) == want and _flags_done(keep[1], plan, m)
    return ok, (cfg, ends, m, n, plan, int(out[0]), want)


def _flags_done(sync, plan, m):
    """Every strip took a ticket (one per block past them), and every strip
    but the last published its whole bottom row."""
    return (sync[0] == plan.strips + plan.blocks
            and all(int(x) == m + 1 for x in sync[2:plan.strips + 1]) and sync[-1] == 0)


def _capture_case(dll, rng, local, matrix, m, n, geometry, locate, affine=False):
    """``band_capture_fill`` against ``capture_plain``: the last row, rows
    around the strip edges, the last column, with ``locate`` the located
    cell, and with ``affine`` the last row of F under a top-edge open ``tb``
    of ``gap_open`` or 0."""
    kw = dict(match=int(rng.integers(1, 4)), mismatch=int(rng.integers(-3, 2)),
              gap=int(rng.integers(-4, 0)), mode=AlignMode.LOCAL if local else AlignMode.GLOBAL)
    if matrix is not None:
        kw["matrix"] = matrix
    if affine:
        kw.update(gap_open=int(rng.integers(-6, 1)), gap_extend=int(rng.integers(-3, 0)))
    cfg = ScoringConfig(**kw)
    tb = (cfg.gap_open if rng.integers(0, 2) else 0) if affine else None
    hi = len(matrix) if matrix is not None else 5
    text = torch.from_numpy(rng.integers(0, hi, m).astype(np.int8))
    query = torch.from_numpy(rng.integers(0, hi, n).astype(np.int8))
    zr, zc = (bool(x) for x in rng.integers(0, 2, 2))
    if geometry is not None:
        geometry = (min(geometry[0], band.max_k(cfg)),) + tuple(geometry[1:])
    plan, keep, pipe = _pipe_scratch(rng, n, m, affine, geometry, band.max_k(cfg), locate)
    R = plan.k * plan.threads
    rows = sorted({r for r in (1, R - 1, R, R + 1, 2 * R, n - 1, n,
                               int(rng.integers(1, n + 1))) if 1 <= r <= n})
    K = len(matrix) if matrix is not None else 0
    mat = np.ascontiguousarray(np.asarray(matrix if K else [0], np.int32).reshape(-1))
    cap_rows = np.asarray(rows, np.int32)  # row n among them: the last row
    caps = np.empty((len(rows), m + 1), np.int32)
    col, cell = np.empty(n + 1, np.int32), np.empty(3, np.int32)
    fout = np.empty(m + 1, np.int32)
    head = (text.data_ptr(), m, query.data_ptr(), n, mat.ctypes.data, K, cfg.match,
            cfg.mismatch)
    flags = band._flags(cfg, (zr, zc, False, False))
    outs = (cap_rows.ctypes.data, len(rows), caps.ctypes.data, col.ctypes.data,
            cell.ctypes.data if locate else None)
    geom = (plan.k, plan.threads, plan.blocks)
    if affine:
        err = dll.band_capture_affine(*head, cfg.gap_open, cfg.gap_extend, tb, flags, *geom,
                                      *outs, fout.ctypes.data, *pipe, None)
    else:
        err = dll.band_capture_fill(*head, cfg.gap, flags, *geom, *outs, *pipe, None)
    want = band.capture_plain(text, query, cfg, rows, zero_row=zr, zero_col=zc,
                              col=True, cell=locate, tb=tb)
    got = (caps[-1], caps, col, cell if locate else None, fout if affine else None)
    ok = err == 0 and all(a is b is None or np.array_equal(a, b.numpy())
                          for a, b in zip(got, want)) and _flags_done(keep[1], plan, m)
    return ok, (cfg, tb, zr, zc, m, n, plan, rows, cell, want.cell)


def _band_batch_case(dll, rng, c):
    """``band_batch_fill`` against ``xla.score_batch`` on a ragged batch:
    every (affine, matrix, local) combination in turn, each mode, 1 x 1
    pairs, pairs past one strip at small geometries."""
    affine, matrix, local = bool(c % 2), [None, matrices.dna(2, -1, -3)][(c // 2) % 2], \
        bool((c // 4) % 2)
    mode = AlignMode.LOCAL if local else list(AlignMode)[[0, 2, 3][(c // 8) % 3]]
    kw = dict(match=int(rng.integers(1, 4)), mismatch=int(rng.integers(-3, 2)),
              gap=int(rng.integers(-4, 0)), mode=mode, matrix=matrix)
    if affine:
        kw.update(gap_open=int(rng.integers(-6, 1)), gap_extend=int(rng.integers(-3, 0)))
    cfg = ScoringConfig(**kw)
    P = int(rng.integers(1, 7))
    lens = rng.integers(1, 80, (2, P))
    lens[:, rng.integers(0, P)] = 1 if c % 3 == 0 else lens[:, 0]  # a 1 x 1 pair
    texts = [rng.integers(0, 5, int(x)).astype(np.int8) for x in lens[0]]
    queries = [rng.integers(0, 5, int(x)).astype(np.int8) for x in lens[1]]
    packed = pairs.pack_pairs(texts, queries, np.arange(P))
    k = [1, 2, 4, 8, 16][c % 5]
    k = min(k, band.max_k(cfg))
    threads = 32 * int(rng.integers(1, 3))
    ends = band._ends_flags(cfg, False)
    K = len(matrix) if matrix is not None else 0
    mat = np.ascontiguousarray(np.asarray(matrix if K else [0], np.int32).reshape(-1))
    boundary = np.empty(P * 2 * (packed.m_cap + 1), np.int32)
    out = np.empty(P, np.int32)
    off, ln = packed.offsets, packed.lengths
    err = dll.band_batch_fill(packed.texts.data_ptr(), packed.queries.data_ptr(),
                              off[0].data_ptr(), off[1].data_ptr(), ln[0].data_ptr(),
                              ln[1].data_ptr(), P, packed.m_cap, mat.ctypes.data, K, cfg.match,
                              cfg.mismatch, cfg.gap, cfg.gap_open or 0, cfg.gap_extend or 0,
                              band._flags(cfg, ends), k, threads, boundary.ctypes.data,
                              out.ctypes.data, None)
    want = xla.score_batch(packed, cfg, ends).tolist()
    return err == 0 and out.tolist() == want, (cfg, lens.tolist(), k, threads, out, want)


def _flags_of(sync, plan, steps):
    """The flags after a pipelined launch: the ticket past every band and
    block, every band with a band below published all ``steps``."""
    return (int(sync[0]) == plan.bands + plan.blocks
            and sync[1:].tolist() == [steps] * (plan.bands - 1) + [0])


def gfill_case(dll, rng, nq, mt, g, blocks=None, rows=None, shallow=False,
               concurrent=False, lo=0):
    """``bitpal_gfill`` and, with ``rows``, ``bitpal_capture_fill`` against
    ``fill_g_plain``: planes word for word, captures byte for byte, the
    ring, planes and captures seeded with garbage (a byte read before it is
    written, or an output left unwritten, shows), the flags checked at the
    end.  ``blocks`` as ``bitpal.pipeline_plan`` takes it; ``shallow``
    cuts the ring to 2 rows; ``concurrent`` runs the grid's blocks at once.
    Returns ``(ok, where)``."""
    nw = -(-nq // bitpal.WORD)
    B = bitpal.n_planes(g)
    plan = bitpal.pipeline_plan(nw, mt, blocks)
    if shallow and plan.depth > 2:
        plan = plan._replace(depth=2)
    q = torch.from_numpy(rng.integers(lo, 5, nq).astype(np.int8))
    t = torch.from_numpy(rng.integers(lo, 5, mt).astype(np.int8))
    eq = bitpal._eq_planes(q, nq)
    ring = torch.from_numpy(rng.integers(0, 256, (max(plan.depth, 1), max(mt, 1)))
                            .astype(np.uint8))
    sync = torch.zeros(plan.bands + 1, dtype=torch.int32)
    planes = torch.from_numpy(rng.integers(-2**62, 2**62, (B, nw)))
    head = (t.data_ptr(), eq.data_ptr(), mt, nw, g, plan.blocks, ring.data_ptr(),
            plan.depth, sync.data_ptr())
    dll.rehearse_concurrent(int(concurrent))
    try:
        if rows is None:
            err = dll.bitpal_gfill(*head, planes.data_ptr(), None)
            caps = None
        else:
            cap_rows = torch.tensor(rows, dtype=torch.int32)
            caps = torch.from_numpy(rng.integers(-128, 128, (len(rows), mt)).astype(np.int8))
            err = dll.bitpal_capture_fill(*head, cap_rows.data_ptr(), len(rows),
                                          caps.data_ptr(), planes.data_ptr(), None)
    finally:
        dll.rehearse_concurrent(0)
    want_planes, want_caps = bitpal.fill_g_plain(t, eq, nq, g, rows)
    ok = (not err and torch.equal(planes, torch.stack(want_planes)) and _flags_of(sync, plan, mt)
          and (caps is None or torch.equal(caps, want_caps)))
    return ok, f"g {g}, {nq} x {mt}, {plan}, rows {rows}, concurrent {concurrent}"


def _gfill_cases(dll, rng, cases):
    """The pipelined fill against ``fill_g_plain`` over random block
    counts: g = 1..7 in turn, one band and many, bands past the blocks,
    rings of 2 rows, captured rows on band edges, codes 0..4, at times the
    blocks run at once."""
    for c in range(cases):
        g = c % 7 + 1
        blocks = [1, 2, 9, None][int(rng.integers(0, 4))]
        bands = int(rng.integers(1, 5))
        nq = int(rng.integers(1, bitpal.BAND * bands * bitpal.WORD + 1))
        mt = int(rng.integers(1, 90)) if c % 4 else int(rng.integers(90, 300))
        rows = bitpal.band_edge_rows(nq) if c % 2 else None
        ok, where = gfill_case(dll, rng, nq, mt, g, blocks, rows, shallow=c % 3 == 0,
                               concurrent=c % 5 == 0)
        if not ok:
            sys.exit(f"bitpal_gfill / bitpal_capture_fill differs from fill_g_plain: {where}")


def batch_case(dll, rng, nqs, mts, g, blocks=None, shallow=False, concurrent=False, lo=0):
    """``bitpal_batch_fill`` against ``batch_fill_plain`` on the pairs of
    query lengths ``nqs`` and text lengths ``mts``: planes word for word,
    the texts past each pair's length, the ring and the planes seeded with
    garbage (a column read past a pair's text, a byte read before it is
    written, or a word left unwritten, shows), the flags checked at the
    end.  ``blocks`` as ``bitpal.batch_plan`` takes it; ``shallow`` cuts the
    rings to 2 rows; ``concurrent`` runs the grid's blocks at once.
    Returns ``(ok, where)``."""
    P = len(nqs)
    nq, m_cap = int(max(nqs)), int(max(mts))
    nw = -(-nq // bitpal.WORD)
    plan = bitpal.batch_plan(P, nw, m_cap, blocks)
    if shallow and plan.depth > 2:
        plan = plan._replace(depth=2)
    texts = torch.from_numpy(rng.integers(-3, 8, (P, m_cap)).astype(np.int8))
    qpad = torch.full((P, nw * bitpal.WORD), -1, dtype=torch.int8)
    for p in range(P):
        texts[p, : mts[p]] = torch.from_numpy(rng.integers(lo, 5, mts[p]).astype(np.int8))
        qpad[p, : nqs[p]] = torch.from_numpy(rng.integers(lo, 5, nqs[p]).astype(np.int8))
    tlen = torch.tensor([int(x) for x in mts], dtype=torch.int64)
    eqb = bitpal._eq_planes_batch(qpad)
    B = bitpal.n_planes(g)
    planes = torch.from_numpy(rng.integers(-2**62, 2**62, (P, B, nw)))
    ring = torch.from_numpy(rng.integers(0, 256, (P, max(plan.depth, 1), m_cap)).astype(np.uint8))
    sync = torch.zeros(1 + P * plan.bands, dtype=torch.int32)
    dll.rehearse_concurrent(int(concurrent))
    try:
        err = dll.bitpal_batch_fill(texts.data_ptr(), m_cap, tlen.data_ptr(), eqb.data_ptr(), P,
                                    nw, g, plan.blocks, ring.data_ptr(), plan.depth,
                                    sync.data_ptr(), planes.data_ptr(), None)
    finally:
        dll.rehearse_concurrent(0)
    want = bitpal.batch_fill_plain(texts, tlen, eqb, nq, g)
    ok = not err and torch.equal(planes, want)
    if plan.width == bitpal.BAND:  # every band took a ticket, each pair's published its text
        progress = sync[1:].view(P, plan.bands)
        ok = ok and int(sync[0]) == P * plan.bands + plan.blocks and all(
            progress[p].tolist() == [int(mts[p])] * (plan.bands - 1) + [0] for p in range(P))
    return ok, (f"g {g}, queries {[int(x) for x in nqs]}, texts {[int(x) for x in mts]}, "
                f"{plan}, concurrent {concurrent}")


def _bitpal_cases(dll, rng, cases):
    """``bitpal_batch_fill`` against ``batch_fill_plain`` (``batch_case``):
    g = 1..7 in turn, every segment width and one band to three, forced
    block counts, rings of 2 rows, ragged batches with 1 x 1 pairs, at
    times the blocks at once."""
    for c in range(cases):
        g = c % 7 + 1
        P = int(rng.integers(1, 12))
        nq_max = [64, 128, 256, 512, 1024, 2048, 3 * 2048][c % 7]
        nqs = rng.integers(1, nq_max + 1, P)
        # at times texts past 2,048 columns, where the rows a band down
        # stop saturating and one pair's ring read for another's shows
        mts = rng.integers(1, 2600 if c % 4 == 3 else 90, P)
        if c % 3 == 0:
            nqs[0], mts[-1] = 1, 1
        blocks = [1, 2, 3, None][int(rng.integers(0, 4))]
        ok, where = batch_case(dll, rng, nqs, mts, g, blocks, shallow=c % 2 == 0,
                               concurrent=c % 5 == 0)
        if not ok:
            sys.exit(f"bitpal_batch_fill differs from batch_fill_plain: {where}")


def diag_case(dll, rng, cfg, m, n, geometry=None, shallow=False):
    """``diag_fill`` against ``score_plain``: ``s1`` (m) on the strips'
    columns, ``s2`` (n <= m) on their rows, at ``geometry`` (default the
    planner's; ``shallow``: the ring cut to 2 rows), ``out`` seeded with
    the max's identity as the wrapper seeds it, the flags checked at the
    end.  Returns ``(ok, where)``."""
    s1 = torch.from_numpy(rng.integers(0, 5, m).astype(np.int8))
    s2 = torch.from_numpy(rng.integers(0, 5, n).astype(np.int8))
    plan, keep, pipe = _pipe_scratch(rng, n, m, False, geometry, band.MAX_K, False)
    if shallow and plan.depth > 2:
        plan = plan._replace(depth=2)
        pipe = (pipe[0], 2) + pipe[2:]
    out = np.full(1, 0 if cfg.is_local else band.NEG, np.int32)
    err = dll.diag_fill(s1.data_ptr(), m, s2.data_ptr(), n, cfg.match, cfg.mismatch, cfg.gap,
                        int(cfg.is_local), plan.k, plan.threads, plan.blocks, *pipe[:3],
                        out.ctypes.data, None)
    want = int(pallas_diag.score_plain(s1, s2, cfg))
    ok = not err and int(out[0]) == want and _flags_done(keep[1], plan, m)
    return ok, f"{cfg} {m} x {n}, {plan}: {int(out[0])}, plain {want}"


def wave_case(dll, rng, nq, mt, g, rc, lengths, blocks=None, shallow=False,
              concurrent=False, lo=0, junk=False):
    """The staggered fills of ``bitpal_rc.cu`` on their pipeline:
    ``bitpal_rc_fill`` (rc > 1) against ``fill_rc_plain``, then the chunk
    entry (``bitpal_rc_chunk`` at rc > 1, ``bitpal_gfill_chunk`` at rc 1
    and g) chunk by chunk against ``chunk_plain``, chunk lengths cycled
    from ``lengths`` up to the last step or past it: planes and hand-offs
    word for word after every chunk, flags checked after every launch,
    and the last chunk's planes against the one-launch plain fill.  The
    chunks share one ring and one set of flags, zeroed before each launch,
    as ``bitpal.fill_chunked``'s do, so the ring holds the previous
    chunk's bytes; the ring and the outputs start as garbage.  ``junk``
    starts the chunks from a random state (planes and whole hand-off
    bytes).  ``blocks`` as ``bitpal.wave_plan`` takes it; ``shallow`` cuts
    the ring to 2 rows; ``concurrent`` runs the grid's blocks at once.
    Returns ``(ok, where)``."""
    nw = -(-nq // bitpal.WORD)
    gg = 1 if rc > 1 else g
    B = bitpal.n_planes(gg)
    q = torch.from_numpy(rng.integers(lo, 5, nq).astype(np.int8))
    t = torch.from_numpy(rng.integers(lo, 5, mt).astype(np.int8))
    eq = bitpal._eq_planes(q, nq)
    total = bitpal.total_steps(mt, nw, rc)
    where = f"rc {rc}, g {gg}, {nq} x {mt}, blocks {blocks}, ring of 2 {shallow}"

    def scratch(steps):
        plan = bitpal.wave_plan(nw, steps, blocks)
        if shallow and plan.depth > 2:
            plan = plan._replace(depth=2)
        ring = torch.from_numpy(rng.integers(0, 256, (max(plan.depth, 1), max(steps, 1)))
                                .astype(np.uint8))
        return plan, ring, torch.zeros(plan.bands + 1, dtype=torch.int32)

    dll.rehearse_concurrent(int(concurrent))
    try:
        if rc > 1:
            plan, ring, sync = scratch(total)
            planes = torch.from_numpy(rng.integers(-2**62, 2**62, (2, nw)))
            err = dll.bitpal_rc_fill(t.data_ptr(), eq.data_ptr(), mt, nw, rc, plan.blocks,
                                     ring.data_ptr(), plan.depth, sync.data_ptr(),
                                     planes.data_ptr(), None)
            want = torch.stack(bitpal.fill_rc_plain(t, eq, nq, rc))
            if err or not torch.equal(planes, want) or not _flags_of(sync, plan, total):
                return False, f"bitpal_rc_fill, {where}, {plan}"
        entry = dll.bitpal_rc_chunk if rc > 1 else dll.bitpal_gfill_chunk
        plan, ring, sync = scratch(max(lengths))
        if junk:
            state = bitpal.WaveState(
                tuple(torch.from_numpy(rng.integers(-2**63, 2**63 - 1, nw, dtype=np.int64))
                      for _ in range(B)),
                torch.from_numpy(rng.integers(0, 256, nw).astype(np.uint8)))
        else:
            state = bitpal.init_state(nw, gg, "cpu")
        t0, i = 0, 0
        while t0 < total:
            t_steps = lengths[i % len(lengths)]
            v_out = torch.from_numpy(rng.integers(-2**62, 2**62, (B, nw)))
            h_out = torch.from_numpy(rng.integers(0, 256, nw).astype(np.uint8))
            v_in = torch.stack(state.planes)
            sync.zero_()
            err = entry(t.data_ptr(), eq.data_ptr(), mt, nw, rc if rc > 1 else gg, plan.blocks,
                        ring.data_ptr(), plan.depth, sync.data_ptr(), t0, t_steps,
                        v_in.data_ptr(), state.hand.data_ptr(), v_out.data_ptr(),
                        h_out.data_ptr(), None)
            state = bitpal.chunk_plain(t, eq, nq, gg, rc, t0, t_steps, state)
            if err or not (torch.equal(v_out, torch.stack(state.planes))
                           and torch.equal(h_out, state.hand)
                           and _flags_of(sync, plan, t_steps)):
                return False, f"chunk at steps {t0 + 1}..{t0 + t_steps}, {where}, {plan}"
            t0, i = t0 + t_steps, i + 1
    finally:
        dll.rehearse_concurrent(0)
    want = bitpal.fill_g_plain(t, eq, nq, gg)[0] if rc == 1 else bitpal.fill_rc_plain(
        t, eq, nq, rc)
    if not junk and not all(torch.equal(a, b) for a, b in zip(state.planes, want)):
        return False, f"chunks in turn differ from one fill: {where}"
    return True, where


def _wave_cases(dll, rng, cases):
    """``bitpal_rc_fill`` against ``fill_rc_plain``, and ``bitpal_rc_chunk``
    and ``bitpal_gfill_chunk`` chunk by chunk against ``chunk_plain``
    (``wave_case``): rc 1..4 and g 1..7 in turn, one band and up to five,
    forced block counts, rings of 2 rows, chunk edges anywhere from the
    ramp to past the end, codes 0..4, at times the blocks at once or a
    random state in."""
    for c in range(cases):
        rc, g = 1 + c % 4, 1 + c % 7
        blocks = [1, 2, 3, None][int(rng.integers(0, 4))]
        bands = int(rng.integers(1, 6))
        nq = int(rng.integers(1, bitpal.BAND * bands * bitpal.WORD + 1))
        # short texts, and texts of whole steady chunks at every rc
        mt = int(rng.integers(1, 80)) if c % 3 else int(rng.integers(64 * rc, 128 * rc))
        lengths = ([int(x) for x in rng.integers(1, 40, 3)] if c % 2 else
                   [int(rng.integers(1, 34)), 32, 33])
        ok, where = wave_case(dll, rng, nq, mt, g, rc, lengths, blocks, shallow=c % 3 == 0,
                              concurrent=c % 5 == 0, junk=c % 7 == 3)
        if not ok:
            sys.exit(f"a staggered fill differs from its plain version: {where}")


def _ckpt_case(dll, rng, cfg, m, n, K, geometry=None, shallow=False):
    """diag_ckpt_fill against ckpt_plain word for word: both checkpoint
    arrays (dead slots included) and, local, v and dbest, ``s1`` (m) on the
    strips' columns and ``s2`` (n) on their rows, at ``geometry`` (default
    the planner's; ``shallow``: the ring cut to 2 rows).  The outputs start
    as garbage, so a slot the kernel leaves unwritten shows."""
    s1 = torch.from_numpy(rng.integers(0, 5, m).astype(np.int8))
    s2 = torch.from_numpy(rng.integers(0, 5, n).astype(np.int8))
    groups = -(-(n + m) // K)
    plan, keep, pipe = _pipe_scratch(rng, n, m, False, geometry, band.MAX_K, False)
    if shallow and plan.depth > 2:
        plan = plan._replace(depth=2)
        pipe = (pipe[0], 2) + pipe[2:]
    ck = rng.integers(-99, 99, (2, groups, n + 1)).astype(np.int32)
    best = rng.integers(-99, 99, (2, n + 1)).astype(np.int32)
    v, dbest = (best[0].ctypes.data, best[1].ctypes.data) if cfg.is_local else (None, None)
    err = dll.diag_ckpt_fill(s1.data_ptr(), m, s2.data_ptr(), n, cfg.match, cfg.mismatch,
                             cfg.gap, int(cfg.is_local), K, plan.k, plan.threads, plan.blocks,
                             *pipe[:3], ck[0].ctypes.data, ck[1].ctypes.data, v, dbest, None)
    want = pallas_diag.ckpt_plain(s1, s2, cfg, K)
    ok = (not err and np.array_equal(ck[0], want.cka.numpy())
          and np.array_equal(ck[1], want.ckb.numpy()) and _flags_done(keep[1], plan, m))
    if cfg.is_local:
        ok = ok and np.array_equal(best[0], want.v.numpy()) and np.array_equal(
            best[1], want.dbest.numpy())
    return ok, f"{cfg} {m} x {n}, K = {K}, {plan}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dll = build()
    rng = np.random.default_rng(args.seed)
    asym = ((3, -1, -2, 0, 1), (-2, 2, -3, -1, 0), (0, -1, 4, -2, -1),
            (1, 0, -1, 3, -2), (-1, -2, 0, -3, 2))
    mats = [None, matrices.dna(2, -1, -3), asym, matrices.iupac()]
    # (k, threads) with the planner's blocks, one block, blocks past the
    # strips, and fewer blocks than strips; and the planner's own
    geometries = [(1, 32), (2, 32), (4, 32), (8, 32), (16, 32), (1, 64), (2, 96), (1, 32, 1),
                  (2, 32, 1), (1, 32, 2), (2, 64, 3), (1, 32, 9), None]
    for c in range(args.cases):
        mode = list(AlignMode)[c % 4]
        matrix = mats[(c // 4) % 4]
        affine = bool((c // 16) % 2)
        geometry = geometries[int(rng.integers(0, len(geometries)))]
        m, n = (int(x) for x in rng.integers(1, 90, 2))
        n = int(rng.integers(90, 300)) if c % 3 == 0 else n  # up to 9 strips of 32 rows
        ok, info = _band_case(dll, rng, mode, matrix, affine, m, n, geometry)
        if not ok:
            sys.exit(f"band_fill differs from score_plain: {info}")
    print(f"[rehearse] band_fill equal to score_plain in {args.cases} cases")
    for c in range(2 * args.cases):
        geometry = geometries[int(rng.integers(0, len(geometries)))]
        m, n = (int(x) for x in rng.integers(1, 90, 2))
        n = int(rng.integers(90, 300)) if c % 3 == 0 else n
        m, n = (1 if c % 10 == 3 else m), (1 if c % 10 == 7 else n)  # 1-column, 1-row
        ok, info = _capture_case(dll, rng, bool(c % 2), mats[(c // 2) % 4], m, n, geometry,
                                 locate=c % 3 != 2, affine=c >= args.cases)
        if not ok:
            sys.exit(f"band_capture_fill differs from capture_plain: {info}")
    print(f"[rehearse] band_capture_fill equal to capture_plain in {args.cases} linear "
          f"and {args.cases} affine cases")
    for c in range(args.cases // 4):
        cfg = ScoringConfig(match=int(rng.integers(1, 4)), mismatch=int(rng.integers(-3, 1)),
                            gap=int(rng.integers(-4, 1)),
                            mode=AlignMode.LOCAL if c % 2 else AlignMode.GLOBAL)
        n, m = sorted(int(x) for x in rng.integers(1, 150, 2))
        if c % 3 == 0:  # up to 12 strips of 32 rows
            m = int(rng.integers(150, 400))
            n = int(rng.integers(90, m + 1))
        geometry = geometries[int(rng.integers(0, len(geometries)))]
        ok, info = diag_case(dll, rng, cfg, m, n, geometry, shallow=c % 5 == 0)
        if not ok:
            sys.exit(f"diag_fill differs from score_plain: {info}")
    print(f"[rehearse] diag_fill equal to score_plain in {args.cases // 4} cases")
    ckpt_cfgs = [ScoringConfig(), ScoringConfig(match=2, mismatch=-1, gap=-2,
                                                mode=AlignMode.LOCAL),
                 ScoringConfig(match=3, mismatch=1, gap=-2, mode=AlignMode.LOCAL),
                 ScoringConfig(match=1, mismatch=-3, gap=1, mode=AlignMode.LOCAL)]
    # 1 x k, k x 1, 1 x 1, more strips than blocks, a stride past the table;
    # (m, n, K, geometry, ring of 2)
    fixed = [(1, 30, 8, None, False), (30, 1, 8, None, False), (1, 1, 8, None, False),
             (40, 1100, 16, (1, 32, 9), True), (7, 7, 1024, None, False)]
    for c in range(args.cases // 2 + len(fixed)):
        cfg = ckpt_cfgs[c % 4]
        if c < len(fixed):
            m, n, K, geometry, shallow = fixed[c]
        else:  # n < m and n > m up to 9 strips, strides 8, 16, 24 and 32
            m, n = (int(x) for x in rng.integers(1, 150, 2))
            n = int(rng.integers(90, 300)) if c % 3 == 0 else n
            K = 8 * int(rng.integers(1, 5))
            geometry, shallow = geometries[int(rng.integers(0, len(geometries)))], c % 5 == 0
        ok, info = _ckpt_case(dll, rng, cfg, m, n, K, geometry, shallow)
        if not ok:
            sys.exit(f"diag_ckpt_fill differs from ckpt_plain: {info}")
    print(f"[rehearse] diag_ckpt_fill equal to ckpt_plain in {args.cases // 2 + len(fixed)} "
          f"cases (NW, SW, positive mismatch and gap local; 1 x k, k x 1, several strips, "
          f"one block, blocks past and below the strips, rings of 2 rows)")
    for c in range(args.cases):
        ok, info = _band_batch_case(dll, rng, c)
        if not ok:
            sys.exit(f"band_batch_fill differs from xla.score_batch: {info}")
    print(f"[rehearse] band_batch_fill equal to xla.score_batch in {args.cases} batches")
    _gfill_cases(dll, rng, args.cases // 2)
    print(f"[rehearse] bitpal_gfill and bitpal_capture_fill equal to fill_g_plain in "
          f"{args.cases // 2} cases (one band and many, bands past the blocks, rings of 2 "
          f"rows, captures on band edges, blocks at once)")
    _bitpal_cases(dll, rng, args.cases // 2)
    print(f"[rehearse] bitpal_batch_fill equal to batch_fill_plain in {args.cases // 2} cases "
          f"(every segment width, one band to three, forced blocks, rings of 2 rows, blocks at "
          f"once)")
    _wave_cases(dll, rng, args.cases // 2)
    print(f"[rehearse] bitpal_rc_fill equal to fill_rc_plain, bitpal_rc_chunk and "
          f"bitpal_gfill_chunk to chunk_plain chunk by chunk in {args.cases // 2} cases (one "
          f"band and many, forced blocks, rings of 2 rows, blocks at once, a random state)")


if __name__ == "__main__":
    main()
