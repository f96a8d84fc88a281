"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` per source, all started together, and the objects link into one
shared library with a plain C interface, under ``tpualign_torch/_build/``
(git-ignored), named by a hash of the sources and the flags, so an edited
source builds anew and an unchanged one loads from the cache.  The same
build-on-first-use pattern as ``tpualign/utils/native.py``, except that a
failed build raises with the compiler's output instead of reporting the
library unavailable: a CUDA tensor has no other path to take.

Nothing here runs at import time; the CPU tests import the package without
a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

#: ``-Xptxas -v`` keeps each kernel's register, shared-memory and spill
#: report; :func:`library_path` stores it beside the library as ``.log``
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 900

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin on PATH"
    )


def library_path() -> str:
    """Path of the built kernel library, compiling it if the cache misses."""
    files = sorted(glob.glob(os.path.join(CSRC, "*")))
    sources = [path for path in files if path.endswith(".cu")]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in files:
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"libtpualign_torch_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    procs = []
    try:
        for src, obj in zip(sources, objs):
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [proc.communicate(timeout=BUILD_TIMEOUT_S)[0] for proc in procs]
        failed = [(src, proc.returncode, log)
                  for src, proc, log in zip(sources, procs, logs) if proc.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{src} (exit code {rc}):\n{log}" for src, rc, log in failed))
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp, *objs],
            capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed with exit code {link.returncode}:\n"
                               f"{link.stdout}{link.stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(out + ".log", "w") as f:
        f.write("".join(logs))
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(library_path())
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        # the pipelined bit-parallel fills (bitpal_gfill.cu, bitpal_rc.cu):
        # blocks, then the ring, its depth and the flags
        gfill = [vp, vp, i64, i32, i32, i32, vp, i32, vp]
        lib.bitpal_gfill.argtypes = gfill + [vp, vp]
        lib.bitpal_gfill.restype = i32
        lib.bitpal_capture_fill.argtypes = gfill + [vp, i32, vp, vp, vp]
        lib.bitpal_capture_fill.restype = i32
        lib.bitpal_rc_fill.argtypes = gfill + [vp, vp]
        lib.bitpal_rc_fill.restype = i32
        for entry in (lib.bitpal_rc_chunk, lib.bitpal_gfill_chunk):
            entry.argtypes = gfill + [i64, i64, vp, vp, vp, vp, vp]
            entry.restype = i32
        # the pipelined fills: geometry (k, threads, blocks), then the ring,
        # its depth, the flags and (capture entries) the blocks' cells
        lib.band_fill.argtypes = [vp, i32, vp, i32, vp] + [i32] * 10 + [vp, i32, vp, vp, vp]
        lib.band_fill.restype = i32
        lib.band_capture_fill.argtypes = ([vp, i32, vp, i32, vp] + [i32] * 8
                                          + [vp, i32, vp, vp, vp, vp, i32, vp, vp, vp])
        lib.band_capture_fill.restype = i32
        lib.band_capture_affine.argtypes = ([vp, i32, vp, i32, vp] + [i32] * 10
                                            + [vp, i32, vp, vp, vp, vp, vp, i32, vp, vp, vp])
        lib.band_capture_affine.restype = i32
        lib.diag_fill.argtypes = [vp, i32, vp, i32] + [i32] * 7 + [vp, i32, vp, vp, vp]
        lib.diag_fill.restype = i32
        lib.diag_ckpt_fill.argtypes = ([vp, i32, vp, i32] + [i32] * 8
                                       + [vp, i32, vp, vp, vp, vp, vp, vp])
        lib.diag_ckpt_fill.restype = i32
        lib.bitpal_batch_fill.argtypes = [vp, i64, vp, vp] + [i32] * 4 + [vp, i32, vp, vp, vp]
        lib.bitpal_batch_fill.restype = i32
        lib.band_batch_fill.argtypes = [
            vp, vp, vp, vp, vp, vp, i32, i64, vp, i32, i32, i32, i32, i32, i32, i32, i32,
            i32, vp, vp, vp]
        lib.band_batch_fill.restype = i32
        _lib = lib
    return _lib
