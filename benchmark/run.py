"""Run one cell of the benchmark once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (the program's import and its kernels'
build or load, the inputs made from the seed, one warm call an input), then
calls back to back for ``--seconds``, then the check against the plain
reference.  The last line of standard output is the result: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones and the device's activity; the numbers compared, each beside
its limit, come last in it and on standard error.  Without a CUDA device,
or with fewer cards than the cell asks for, it prints no result and exits
non-zero; so it does without the program, or once a forbidden module has
been loaded.
"""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the bytecode of every module the run imports (torch's thousands among
#: them), kept at a fixed place in the checkout so that only a checkout's
#: first run compiles it, also where PYTHONDONTWRITEBYTECODE is set
sys.pycache_prefix = os.path.join(REPO, "_bench_cache", "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)  # the checkout's packages before any installed ones
    from benchmark import harness, spec

    cell = spec.workload(spec.load(), args.workload)
    import torch

    parts = {"imports": time.perf_counter() - START}
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")  # the CUDA context
    parts["cuda_context"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        import tpualign_torch
    except ImportError as exc:
        print(f"run: the program does not import here: {exc}", file=sys.stderr)
        return 3
    parts["program_import"] = time.perf_counter() - t0
    traced = bool(args.trace)
    run = harness.measure(cell, harness.Port(tpualign_torch, cell.config, "cuda"),
                          seed=args.seed, seconds=args.seconds, traced=traced, device="cuda",
                          start=START, program=tpualign_torch)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    expected = harness.expected_scores(run, device="cuda")
    reference_s = time.perf_counter() - t0
    checks, at_fault = harness.judge(run, expected)
    found = harness.forbidden_modules()
    if found:
        print(f"run: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= harness.LIMITS[k] for k, v in checks.items()),
              "attempted": len(run.calls), "failed": at_fault,
              "metrics": harness.metrics(run, traced), "device": device}
    if traced:
        device.update(busy_s=run.trace.busy_s, window_s=run.window_s)
        result["breakdown"] = {"device_ops": [list(op) for op in run.trace.device_ops],
                               "idle_gaps": [list(gap) for gap in run.trace.idle_gaps]}
    result["power_limit"] = _power_limit()
    result["checks"] = {k: {"value": v, "limit": harness.LIMITS[k]} for k, v in checks.items()}
    errors = [c.error for c in run.calls if c.error]
    if errors:
        print(f"run: {len(errors)} calls raised; the first:\n{errors[0]}", file=sys.stderr)
    print(f"run: {args.workload} seed {args.seed}: {len(run.calls)} calls in "
          f"{run.window_s:.3f} s, set-up {run.setup_s:.3f} s, reference {reference_s:.3f} s, "
          f"{time.perf_counter() - START:.3f} s in all", file=sys.stderr)
    parts.update(run.setup_parts)
    print("run: set-up by part: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()),
          file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k}: {v} (limit {harness.LIMITS[k]})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
