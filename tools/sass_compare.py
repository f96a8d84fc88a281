"""Compare the SASS of one kernel template's instantiations between versions
of the port's CUDA sources, on a machine with ``nvcc`` and ``cuobjdump``.

Usage, from the repo root:

    python3 tools/sass_compare.py bitpal_gfill_kernel \
        parent=OLD/bitpal_gfill.cu change=tpualign_torch/csrc/bitpal_gfill.cu

Several kernels, joined by commas, are compared from one build of each
version: ``bitpal_batch_kernel,bitpal_rc_kernel parent=...``.

A version is one source or several joined by ``+``, built into one library
with the port's flags (``tools/ab_band_fill.py:build``).  Each
instantiation of the named kernel is keyed by its template arguments (a
kernel that is no template has one) and compared instruction for
instruction with the first version's (addresses and encodings cut).  Prints the count of
instantiations with the same SASS and the ones that differ, per kernel; exits 1 if any
differs or a version lacks one.
"""

from __future__ import annotations

import argparse
import atexit
import os
import re
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import ab_band_fill  # noqa: E402


def compare(kernel: str, sass) -> bool:
    """Print and check one kernel's instantiations across the versions."""
    by_version = {}
    key = re.compile(re.escape(kernel) + r"(?:I(.*)E|E)")  # a template or a function
    for label, kernels in sass.items():
        by_version[label] = {hit.group(1) or "": instrs for name, instrs in kernels.items()
                             if (hit := key.search(name))}
        print(f"[sass {label}] {len(by_version[label])} instantiations of {kernel}, "
              f"{sum(map(len, by_version[label].values()))} instructions")
    first, *rest = by_version
    ok = True
    for label in rest:
        same = [k for k, v in by_version[label].items() if by_version[first].get(k) == v]
        differ = sorted(set(by_version[first]) ^ set(by_version[label])
                        | (set(by_version[label]) - set(same)))
        print(f"[sass {label} vs {first}] {kernel}: {len(same)} of "
              f"{len(by_version[first])} with the same SASS; differing or missing: {differ}")
        ok = ok and not differ and len(same) == len(by_version[first]) > 0
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", help="the kernel template's name, e.g. bitpal_gfill_kernel, "
                    "or several joined by commas")
    ap.add_argument("versions", nargs="+", help="label=source[+source...]")
    args = ap.parse_args()
    tmp = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, tmp, True)
    versions = [v.split("=", 1) for v in args.versions]
    procs = [(label, ab_band_fill.build(label, srcs, tmp)) for label, srcs in versions]
    sass = {}
    for label, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            print(log)
            raise RuntimeError(f"nvcc failed for {label}")
        sass[label] = ab_band_fill.sass(os.path.join(tmp, f"{label}.so"))
    ok = True
    for kernel in args.kernel.split(","):
        ok = compare(kernel, sass) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
