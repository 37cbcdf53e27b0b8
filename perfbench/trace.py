"""The traced span of a run: what ``torch.profiler`` saw, reduced to what
the per-layer metrics read.

The span is one ``record_function`` (``SPAN``) around whole units of
work (epochs of a ``train`` mix) that ends in a synchronise. Device activity is every
kernel, copy and set the profiler recorded on the card; the busy time is
the length of the union of their intervals inside the span (overlapping
activities count once), the idle gaps its complement, each labelled with
the innermost host operation that was running at the gap's midpoint.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPAN = "perfbench.span"
TOP = 10


def short_name(name: str) -> str:
    """A device activity's name without ``void``, anonymous namespaces,
    template arguments and parameter list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", name, maxsplit=1)[0].strip() or name


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


@dataclass
class Span:
    """One traced span, in seconds, and the work it covered."""

    kind: str                 # the traffic's kind ("train")
    cfg: dict                 # the configuration
    crystals: List[Tuple[int, int]]  # (nodes, edges) of each real crystal
    units: int                # steps in the span
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: Dict[str, float] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def seconds_of(self, names) -> float:
        """Device seconds of the activities with these short names."""
        return sum(self.kernel_s.get(n, 0.0) for n in names)

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:TOP]]}


def read_profile(prof, span: Span, on_cpu: bool = False) -> Span:
    """Fill ``span`` from a finished profile whose span was recorded under
    :data:`SPAN`. ``on_cpu`` (a run on the CPU, in the tests) takes the
    host's operations for the device's."""
    from torch.autograd import DeviceType

    kind = DeviceType.CPU if on_cpu else DeviceType.CUDA
    events = prof.events()
    marks = [e for e in events if e.name == SPAN]
    if not marks:
        raise RuntimeError("the profile holds no traced span")
    t0, t1 = marks[0].time_range.start, marks[0].time_range.end
    device, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.name == SPAN:
            continue
        if e.device_type == kind:
            start, end = max(start, t0), min(end, t1)
            if end > start:
                device.append((start, end, e.name))
        elif end > t0 and start < t1:
            host.append((start, end, e.name))
    if not device:
        raise RuntimeError("the profile recorded no device activity in "
                           "the span")
    busy = _union([(a, b) for a, b, _ in device])
    span.window_s = (t1 - t0) / 1e6
    span.busy_s = sum(b - a for a, b in busy) / 1e6
    for a, b, name in device:
        key = short_name(name)
        span.kernel_s[key] = span.kernel_s.get(key, 0.0) + (b - a) / 1e6
    gaps, last = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps[:TOP]:
        mid = (a + b) / 2
        inside = [(e - s, n) for s, e, n in host if s <= mid <= e]
        label = min(inside)[1] if inside else SPAN
        span.gaps.append((label, (b - a) / 1e6))
    return span
