"""The traced run's device activity, from ``torch.profiler``.

The harness labels its own spans (the window, each call, and what the
metrics' instruments wrap) with ``torch.profiler.record_function`` under
the prefix ``bench:``; the device's kernels, copies and sets come from the
profiler's CUDA activity.  From them: the device's busy time (the union of
its operations), the summed time of its kernels, the operations that took
most time, and the longest idle gaps, each named by the innermost span the
host was in.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

PREFIX = "bench:"
TOP = 10


@dataclasses.dataclass
class Trace:
    busy_s: float
    kernel_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _union(intervals) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _name_at(spans, t: float) -> str:
    """The innermost span that holds the time ``t``."""
    inside = [(a, name) for name, a, b in spans if a <= t <= b]
    return max(inside)[1] if inside else "between calls"


def read(prof: torch.profiler.profile) -> Trace:
    """The device's activity in ``prof``'s window, the ``bench:window``
    span."""
    device, spans = [], []
    for e in prof.events():
        name, a, b = e.name, e.time_range.start, e.time_range.end
        if name.startswith(PREFIX):
            if e.device_type == torch.autograd.DeviceType.CPU:
                spans.append((name[len(PREFIX):], a, b))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((name, a, b))
    windows = [(a, b) for name, a, b in spans if name == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans")
    w0, w1 = windows[0]
    spans = [s for s in spans if s[0] != "window"]
    device = [(name, max(a, w0), min(b, w1)) for name, a, b in device if b > w0 and a < w1]
    busy = _union((a, b) for _, a, b in device)
    by_name: Dict[str, float] = {}
    for name, a, b in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps.sort(key=lambda ab: ab[0] - ab[1])
    return Trace(
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernel_s=sum(s for name, s in by_name.items() if not is_copy(name)),
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=[(_name_at(spans, (a + b) / 2), (b - a) / 1e6) for a, b in gaps[:TOP]],
    )
