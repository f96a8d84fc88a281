"""The port's host C++ (``tpualign_torch/native/bdna_tools.cpp``), built with
the system ``g++`` at first use and loaded with ctypes: the counterpart of
``tpualign/utils/native.py``, with the same return values and refusals.

- :func:`traceback`: the exact full-table walk of a linear-gap global or
  local config, pair scoring or a substitution matrix, string for string
  the oracle's (:func:`tpualign_torch.ops.oracle.traceback`: diag > up >
  left; local starts at the row-major first maximum and stops at the first
  zero).  ctypes releases the interpreter lock for the call, so the
  alignment trees walk their leaves on several threads
  (:data:`tpualign_torch.ops.hirschberg.NATIVE_LEAF_WORKERS`).
- :func:`score`: an independent row-scan scorer, every config (the CLI's
  ``bench --check native``).
- :func:`generate` and :func:`validate`: corpus tools.

The library is built into ``tpualign_torch/_build/`` (git-ignored), named by
a hash of the source, the flags, the compiler's version and the machine, so
an edited source builds anew, an unchanged one loads from the cache, and a
library built on another host is not taken for this one's.  The build writes
a temporary file and renames it, so that concurrent processes never load a
half-written library.  No ``-march=native``: the library must run on any
host of the machine type.  As for the CUDA kernels (``_build.py``), a failed
build raises with the compiler's output; no path falls back to NumPy.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ..config import AlignMode, ScoringConfig
from ..io.bdna import BASES

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "bdna_tools.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 300

#: :func:`traceback` fills an int32 table under pair scoring while every
#: cell's magnitude, at most ``(m + n) * max |weight|``, stays below this;
#: past it, and under a matrix, the int64 table of ``traceback_flex_native``
INT32_LIMIT = 1 << 31

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the port's host C++ builds with the system g++")
    return path


def library_file(src: str = SRC, build_dir: str = BUILD_DIR) -> str:
    """The path the library of ``src`` has in ``build_dir``, built or not."""
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
    digest = hashlib.sha256(" ".join(CXX_FLAGS + (platform.machine(), version)).encode())
    with open(src, "rb") as f:
        digest.update(f.read())
    return os.path.join(build_dir, f"libbdna_tools_{digest.hexdigest()[:16]}.so")


def library_path(src: str = SRC, build_dir: str = BUILD_DIR) -> str:
    """Path of the built library of ``src``, compiling it if the cache
    misses; RuntimeError with ``g++``'s output if the build fails."""
    out = library_file(src, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with exit code {proc.returncode} on {src}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    i64, i32, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    lib.bdna_generate.argtypes = [ctypes.c_uint64, i64, i8p]
    lib.bdna_generate.restype = None
    lib.bdna_validate.argtypes = [i8p, i64]
    lib.bdna_validate.restype = i64
    lib.align_score_native.argtypes = [i8p, i64, i8p, i64, i64, i64, i64, i32]
    lib.align_score_native.restype = i64
    lib.affine_score_native.argtypes = [i8p, i64, i8p, i64, i64, i64, i64, i64, i32]
    lib.affine_score_native.restype = i64
    lib.score_flex_native.argtypes = [i8p, i64, i8p, i64, vp, i64, i64, i64, i64, i64, i64,
                                      i32, i32]
    lib.score_flex_native.restype = i64
    lib.traceback_native.argtypes = [i8p, i64, i8p, i64, i64, i64, i64, i32, i64p, i8p]
    lib.traceback_native.restype = i64
    lib.traceback_flex_native.argtypes = [i8p, i64, i8p, i64, vp, i64, i64, i64, i64, i32,
                                          i64p, i8p]
    lib.traceback_flex_native.restype = i64
    return lib


def load(src: str | None = None, build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """The library, built and loaded once per process (``src``: another
    source, built and loaded at each call)."""
    global _lib
    with _lock:
        if src is not None:
            return _bind(ctypes.CDLL(library_path(src, build_dir)))
        if _lib is None:
            _lib = _bind(ctypes.CDLL(library_path(SRC, build_dir)))
        return _lib


def generate(length: int, seed: int = 0) -> np.ndarray:
    """``length`` random base codes 1..4 from ``seed`` (xoshiro256**)."""
    out = np.empty(length, dtype=np.int8)
    load().bdna_generate(seed, length, out)
    return out


def validate(seq: np.ndarray) -> int:
    """Index of the first byte outside the ``.bdna`` codes 0..4, or -1."""
    seq = np.ascontiguousarray(seq, dtype=np.int8)
    return int(load().bdna_validate(seq, seq.size))


def _matrix(cfg: ScoringConfig, s1: np.ndarray, s2: np.ndarray, error):
    """``(matrix, pointer, K)`` of a matrix config, or ``(None, None, 0)``;
    ``error`` for codes outside the matrix."""
    if not cfg.has_matrix:
        return None, None, 0
    mat = np.ascontiguousarray(np.asarray(cfg.matrix, dtype=np.int64))
    k = mat.shape[0]
    if (max(int(s1.max(initial=0)), int(s2.max(initial=0))) >= k
            or min(int(s1.min(initial=0)), int(s2.min(initial=0))) < 0):
        raise error("sequence codes outside the matrix alphabet")
    return mat, mat.ctypes.data_as(ctypes.c_void_p), k


def score(s1: np.ndarray, s2: np.ndarray, cfg: ScoringConfig | None = None) -> int:
    """The alignment score of ``s1`` (columns) against ``s2`` (rows) by an
    independent int64 row scan in O(len(s1)) memory, any config."""
    cfg = ScoringConfig() if cfg is None else cfg
    lib = load()
    s1 = np.ascontiguousarray(s1, dtype=np.int8)
    s2 = np.ascontiguousarray(s2, dtype=np.int8)
    if cfg.has_matrix or cfg.is_ends_free:
        mode = {AlignMode.GLOBAL: 0, AlignMode.LOCAL: 1,
                AlignMode.SEMIGLOBAL: 2, AlignMode.INFIX: 3}[cfg.mode]
        mat, ptr, k = _matrix(cfg, s1, s2, ValueError)
        return int(lib.score_flex_native(
            s1, s1.size, s2, s2.size, ptr, k, cfg.match, cfg.mismatch, cfg.gap,
            cfg.gap_open or 0, cfg.gap_extend or 0, 1 if cfg.is_affine else 0, mode))
    if cfg.is_affine:
        return int(lib.affine_score_native(
            s1, s1.size, s2, s2.size, cfg.match, cfg.mismatch, cfg.gap_open,
            cfg.gap_extend, 1 if cfg.is_local else 0))
    return int(lib.align_score_native(s1, s1.size, s2, s2.size, cfg.match, cfg.mismatch,
                                      cfg.gap, 1 if cfg.is_local else 0))


def walks(cfg: ScoringConfig) -> bool:
    """Whether :func:`traceback` serves ``cfg``: linear gaps, global or
    local, pair scoring or a matrix."""
    return not (cfg.is_affine or cfg.is_ends_free)


def traceback(s1: np.ndarray, s2: np.ndarray,
              cfg: ScoringConfig | None = None) -> Tuple[int, str, str]:
    """``(score, a1, a2)``: the full-table walk of ``s1`` (columns) against
    ``s2`` (rows) in C++, string for string
    :func:`tpualign_torch.ops.oracle.traceback`'s (module docstring).

    Pair scoring fills an int32 table while no cell can pass
    :data:`INT32_LIMIT`, an int64 one past it and under a matrix.
    RuntimeError for affine and ends-free configs, for codes outside the
    matrix, and for a table the walk cannot follow; ValueError for scores
    that could pass int64."""
    cfg = ScoringConfig() if cfg is None else cfg
    if cfg.is_affine:
        raise RuntimeError(
            "native traceback is linear-gap only; the oracle's three-state "
            "walk serves affine configs")
    if cfg.is_ends_free:
        raise RuntimeError(
            "native traceback covers global/local walks; the oracle walk "
            "serves the ends-free modes (their cores walk here as global)")
    lib = load()
    s1 = np.ascontiguousarray(s1, dtype=np.int8)
    s2 = np.ascontiguousarray(s2, dtype=np.int8)
    mat, ptr, k = _matrix(cfg, s1, s2, RuntimeError)
    lo, hi = cfg.sub_bounds()
    bound = (s1.size + s2.size) * max(abs(lo), abs(hi), abs(cfg.gap))
    if bound >= 1 << 63:
        raise ValueError(f"scores of up to {bound} pass int64")
    ops = np.empty(max(1, s1.size + s2.size), dtype=np.int8)
    out = np.zeros(3, dtype=np.int64)  # score, the start cell's row and column
    local = 1 if cfg.is_local else 0
    if mat is None and bound < INT32_LIMIT:
        ln = lib.traceback_native(s1, s1.size, s2, s2.size, cfg.match, cfg.mismatch, cfg.gap,
                                  local, out, ops)
    else:
        ln = lib.traceback_flex_native(s1, s1.size, s2, s2.size, ptr, k, cfg.match,
                                       cfg.mismatch, cfg.gap, local, out, ops)
    if ln < 0:
        raise RuntimeError("native traceback failed: no predecessor in its table")
    ops = ops[:ln][::-1]  # 0 = diag, 1 = up (gap in s1), 2 = left (gap in s2)
    # the strings from the path: a local path starts at the returned cell
    lut = np.frombuffer(BASES.encode(), dtype=np.uint8)

    def render(seq, take):
        if seq.size == 0:
            return np.zeros(take.size, np.int64)
        idx = np.maximum(np.cumsum(take) - 1, 0)
        return np.where(take, seq[idx], 0).astype(np.int64)

    a1 = lut[render(s1[int(out[2]):], ops != 1)].tobytes().decode()
    a2 = lut[render(s2[int(out[1]):], ops != 2)].tobytes().decode()
    return int(out[0]), a1, a2
