"""The readings that the check's limits are set from, on the card.

    python3 benchmark/control.py --workload <name> --seeds 11,12,... \\
        --control-seeds 11,12,13 --seconds 3

For each of ``--seeds``, a short window of the program at the cell's size,
judged as a run judges it (the lower readings).  For each of
``--control-seeds``, the control in the program's place: the
configuration's plain reference computed in int16, the precision below the
int32 that the configurations' exact scores need, called once on each input of the pool
and judged the same way (the upper readings).  One JSON line a reading.
The benchmark's own runs never run the control.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from benchmark import harness, spec  # noqa: E402
from benchmark.traffic import make_pool  # noqa: E402


class Control:
    """The cell's plain reference in the program's place, computed in
    int16."""

    def __init__(self, cell: spec.Workload, device: str):
        self.cell = cell
        self.device = device

    def align_score_batch(self, texts, queries):
        return self.cell.reference.scores(texts, queries, self.cell.config, device=self.device,
                                          dtype=torch.int16)

    def align_score(self, s1, s2):
        return int(self.align_score_batch([s1], [s2])[0])

    def align(self, s1, s2, stats=None):
        return self.align_score(s1, s2), "", ""


def control_run(cell: spec.Workload, target, *, seed: int, device: str) -> harness.Run:
    """One call of ``target`` on each input of the pool of ``seed``."""
    entry = harness.ENTRIES[cell.traffic["entry"]]
    pool = make_pool(cell.traffic, cell.config, seed)
    calls = []
    for index, inp in enumerate(pool):
        t0 = time.perf_counter()
        answer, error = harness._one_call(entry, target, inp, None)
        calls.append(harness.Call(index, time.perf_counter() - t0, answer, error, None, {}))
    return harness.Run(cell, pool, calls, 0.0, sum(c.seconds for c in calls))


def reading(side: str, seed: int, run: harness.Run, device: str) -> dict:
    expected = harness.expected_scores(run, device=device)
    checks, at_fault = harness.judge(run, expected)
    return {"side": side, "seed": seed, "calls": len(run.calls), "at_fault": at_fault,
            "checks": checks, "scores": sorted({int(s) for e in expected for s in e})[:8]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    cell = spec.workload(spec.load(), args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    import tpualign_torch

    port = harness.Port(tpualign_torch, cell.config, "cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        run = harness.measure(cell, port, seed=seed, seconds=args.seconds, traced=False,
                              device="cuda", start=time.perf_counter())
        print(json.dumps(reading("program", seed, run, "cuda")), flush=True)
    control = Control(cell, "cuda")
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        run = control_run(cell, control, seed=seed, device="cuda")
        errors = [c.error for c in run.calls if c.error]
        if errors:
            print(errors[0], file=sys.stderr)
        print(json.dumps(reading("control", seed, run, "cuda")), flush=True)
    print(f"control: {time.perf_counter() - START:.1f} s; forbidden modules: "
          f"{harness.forbidden_modules() or 'none'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
