"""Where the time of the port's main path goes, on one CUDA device.

    python -m tpualign_torch.probe

Prints, each part on lines of its own:

1. the card: name, power limit, and the SM clock and power draw read while
   the kernel runs at the 64gb shape (126,440 x 127,240, random codes);
2. the kernel's per-step cost against its geometry: ``bitpal_gfill`` at
   g = 1 (K1's port) at ``mt = 20,000`` for queries of 1 to 16,384 words
   (1 to 1,024 threads, 1 to 16 words per thread), CUDA events, median of
   3 after a warm-up;
3. the score path at the 64gb shape on the host clock, split into match
   planes, fill and reduction with read-back, for the first call of the
   process and for a warm one;
4. device time by kernel for one warm call, from ``torch.profiler``;
5. one warm ``align`` of the same pair under ``torch.profiler`` (device
   activity only): its wall on the host clock beside the device time of
   each kernel inside it, the device's busy time (the union of its
   kernels and copies) and its idle share of the wall;
6. the same for one warm ``align_score`` of the pair under the
   Smith-Waterman scoring (2, -1, -2) (``band_fill``);
7. the same for one ``align`` of the pair under that scoring (the
   locate, the anchored start locate and the core's split over
   ``band_capture_fill``, then the leaf walks), with the host-clock split
   that the call records in ``stats``;
8. the same for one warm ``align_score_batch`` of the short-read mix
   (:func:`read_pairs`: 8,192 reads against their reference windows) under
   infix (2, -1, -2) (``band_batch_fill``), with its host-clock split into
   packing, the launch and the read-back.

:func:`serve_pairs` and :func:`read_pairs` are the two batches that
``chip_smoke.py`` drives ``align_score_batch`` with.

Nothing is compared here: ``chip_smoke.py`` checks the kernel.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import align, align_score, align_score_batch
from .config import AlignMode, ScoringConfig
from .ops import band, band_batch, bitpal, hirschberg, pairs

PAIR_LENGTHS = (126440, 127240)  # bdna/64gb-{1,2}.bdna
#: the short-read mix: a read mapper's candidate checks, each a read of
#: READ_LEN bases against a reference window of WINDOW bases that holds it
READS, READ_LEN, WINDOW = 8192, 150, (150, 350)
READ_SUBSTITUTIONS = 0.05
SWEEP_TEXT = 20000
SWEEP_ROWS = (64, 2048, 8192, 16384, 32768, 49152, 65536, 127240, 131072,
              262144, 524288, 1048576)


def serve_pairs():
    """``examples/serve_batch.py``'s batch, drawn as it draws it: 16 pairs,
    each length uniform in 5,000..24,999 from ``default_rng(0)``, codes
    1..4 from ``default_rng(i)`` as ``tpualign.io.bdna.random_pair`` draws
    them.  Returns ``(texts, queries)``."""
    rng = np.random.default_rng(0)
    texts, queries = [], []
    for i in range(16):
        m, n = int(rng.integers(5_000, 25_000)), int(rng.integers(5_000, 25_000))
        pair = np.random.default_rng(i)
        texts.append(pair.integers(1, 5, size=m, dtype=np.int8))
        queries.append(pair.integers(1, 5, size=n, dtype=np.int8))
    return texts, queries


def read_pairs(count: int = READS, seed: int = 0):
    """A read mapper's candidate checks: ``count`` reads of ``READ_LEN``
    bases (the queries), each cut from a random reference window of
    ``WINDOW`` bases (the texts) at a random offset, with
    ``READ_SUBSTITUTIONS`` of its bases changed to another base; codes
    1..4.  Returns ``(texts, queries)``, views of two arrays."""
    rng = np.random.default_rng(seed)
    lo, hi = WINDOW
    lengths = rng.integers(lo, hi + 1, count)
    windows = rng.integers(1, 5, (count, hi), dtype=np.int8)
    starts = (rng.random(count) * (lengths - READ_LEN + 1)).astype(np.int64)
    reads = np.take_along_axis(windows, starts[:, None] + np.arange(READ_LEN), axis=1)
    changed = rng.random((count, READ_LEN)) < READ_SUBSTITUTIONS
    other = (reads - 1 + rng.integers(1, 4, (count, READ_LEN), dtype=np.int8)) % 4 + 1
    reads = np.where(changed, other, reads).astype(np.int8)
    return [w[:k] for w, k in zip(windows, lengths)], list(reads)


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _planes(nq: int, mt: int, seed: int):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(1, 5, nq, dtype=np.int8)).cuda()
    t = torch.from_numpy(rng.integers(1, 5, mt, dtype=np.int8)).cuda()
    return t, bitpal._eq_planes(q, nq)


def _kernel_ms(t, eq, nq: int, runs: int = 3) -> float:
    times = []
    for i in range(runs + 1):  # one warm-up
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        bitpal.fill_g(t, eq, nq, 1)
        e1.record()
        e1.synchronize()
        if i:
            times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _host_split(q, t, nq: int, mt: int) -> str:
    """Match planes, fill and reduction with read-back, each closed by a
    synchronize, on the host clock."""
    marks = [time.perf_counter()]
    eq = bitpal._eq_planes(q, nq)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    planes = bitpal.fill_g(t, eq, nq, 1)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    score = int(bitpal._reduce_score(planes, nq, mt))
    marks.append(time.perf_counter())
    ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return (f"eq planes {ms[0]:.3f} ms, fill {ms[1]:.3f} ms, "
            f"reduce+readback {ms[2]:.3f} ms, unit score {score}")


def _busy_us(spans) -> float:
    """Length of the union of ``(start, end)`` spans."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe: torch.cuda.is_available() is false; this needs a CUDA device")
    print(_smi("name,power.limit"))
    bitpal.fill_g(*_planes(64, 1, 0), 64, 1)  # build and load the kernel

    # 3 first: the first reduction of the process pays the lazy CUDA set-up
    m, n = PAIR_LENGTHS
    rng = np.random.default_rng(64)
    s1, s2 = (rng.integers(1, 5, size=k, dtype=np.int8) for k in PAIR_LENGTHS)
    query, text = (s1, s2) if bitpal._orientation(m, n) else (s2, s1)
    nq, mt = query.size, text.size
    q, t = torch.from_numpy(query).cuda(), torch.from_numpy(text).cuda()
    for which in ("first call", "warm call"):
        print(f"[host clock, 64gb shape, {which}] {_host_split(q, t, nq, mt)}")

    # 1: clock and draw while 25 fills (about 3 s) are queued on the card
    eq = bitpal._eq_planes(q, nq)
    for _ in range(25):
        bitpal.fill_g(t, eq, nq, 1)
    time.sleep(1.0)
    print(f"[under load] sm clock, power draw: {_smi('clocks.sm,power.draw')}")
    torch.cuda.synchronize()

    # 2: the sweep
    for nq_s in SWEEP_ROWS:
        nw = -(-nq_s // bitpal.WORD)
        plan = bitpal.pipeline_plan(nw, SWEEP_TEXT)
        ms = _kernel_ms(*_planes(nq_s, SWEEP_TEXT, nq_s), nq_s)
        steps = SWEEP_TEXT + nw - 1  # the wavefront's path: the last word trails by nw - 1
        step_ns = ms * 1e6 / steps
        print(f"[sweep mt {SWEEP_TEXT}] nq {nq_s:7d} nw {nw:5d} blocks {plan.blocks:3d} "
              f"bands {plan.bands:3d}: {ms:9.3f} ms, {step_ns:8.1f} ns a step of the "
              f"wavefront's {steps}, {nq_s * SWEEP_TEXT / ms / 1e6:7.2f} GCUPS")

    # 4: device time by kernel, one warm score of the 64gb shape
    fn = bitpal.score_fn(m, n, device="cuda")
    d1, d2 = torch.from_numpy(s1).cuda(), torch.from_numpy(s2).cuda()
    int(fn(d1, d2))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        int(fn(d1, d2))
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=6,
                                    max_name_column_width=48))

    # 5: one warm align of the pair, unprofiled (host-clock split), then
    # once more with the device's activity traced
    stats = {}
    hirschberg.align(s1, s2, device="cuda", stats=stats)
    print(f"[align, warm, host clock] {stats}")
    _traced("align", lambda: hirschberg.align(s1, s2, device="cuda"))

    # 6: one warm Smith-Waterman score of the pair, traced
    sw = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
    align_score(s1, s2, sw)
    _traced("align_score SW", lambda: align_score(s1, s2, sw))

    # 7: one Smith-Waterman align of the pair, traced, its split on the
    # host clock
    stats = {}
    _traced("align SW", lambda: align(s1, s2, sw, stats=stats))
    print(f"[align SW, traced, host clock] {stats}")

    # 8: one warm align_score_batch of the short-read mix under infix,
    # traced, and its host-clock split
    texts, queries = read_pairs()
    infix = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.INFIX)
    align_score_batch(texts, queries, infix)
    _traced("align_score_batch reads infix",
            lambda: align_score_batch(texts, queries, infix))
    print(f"[align_score_batch reads infix, host clock] {_batch_split(texts, queries, infix)}")


def _batch_split(texts, queries, cfg) -> str:
    """``band_batch.score_batch``'s steps, each closed by a synchronize, on
    the host clock: packing on the host, the copy to the card, the launch,
    and the read-back with the closed-form floors."""
    marks = [time.perf_counter()]
    m, n = pairs.batch_lengths(texts, queries)
    live = (m > 0) & (n > 0)
    packed = pairs.pack_pairs(texts, queries, np.flatnonzero(live))
    marks.append(time.perf_counter())
    packed = packed.to("cuda")
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    raw = band_batch.batch_fill(packed, cfg, band._ends_flags(cfg, False))
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    scores, floor = raw.cpu().numpy(), band_batch.floors(cfg, m[live], n[live])
    scores = scores if floor is None else np.maximum(scores, floor)
    marks.append(time.perf_counter())
    ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return (f"pack {ms[0]:.3f} ms, copy {ms[1]:.3f} ms, kernel {ms[2]:.3f} ms, "
            f"read-back {ms[3]:.3f} ms; {len(scores)} pairs, score sum {int(scores.sum())}")


def _traced(tag: str, call) -> None:
    """Run ``call`` once with the device's activity traced; print device
    time by kernel, the busy union and the idle share of the wall."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in on_device:
        count, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, us + e.time_range.elapsed_us())
    for name, (count, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"[{tag}, profiled] {count:4d} x {name[:72]}: {us / 1e3:.3f} ms")
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in on_device])
    print(f"[{tag}, profiled] wall {wall_us / 1e6:.3f} s, {len(on_device)} device "
          f"events, device busy {busy / 1e6:.3f} s, idle share {1 - busy / wall_us:.4f}")


if __name__ == "__main__":
    main()
