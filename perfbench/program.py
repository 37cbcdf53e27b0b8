"""The program's own record of the traced span: the spans and counters that
``dostransformer_tpu_torch.tracing`` kept while the span was profiled, read
into the per-step numbers of the training loop's metrics.

A step (``train.step``) is tiled by its four phases (``step.input``,
``step.forward``, ``step.backward``, ``step.optimizer``); between two steps
of one epoch lies the loop's idle, from the first one's last event to the
next one's first. So the phases' and the idle's device milliseconds, summed
over the steps, tile each epoch's device interval from its first step's
start to its last step's end. Device times on the card come from the
program's CUDA events, on the CPU from its host clock.

A program without the tracing module, or whose record holds no step, reads
None: the metric is left out of the result line.
"""

from __future__ import annotations

from typing import Dict, List, Optional

PHASES = ("step.input", "step.forward", "step.backward", "step.optimizer")


def record():
    """The program's record, or None."""
    try:
        from dostransformer_tpu_torch import tracing
    except ImportError:
        return None
    rec = tracing.record()
    return rec if steps(rec) else None


def steps(rec) -> List:
    """The record's closed train steps, in order."""
    return [s for s in rec.spans if s.name == "train.step"
            and s.end is not None]


def phase_ms(name: str) -> Optional[float]:
    """Mean device ms of the phase ``name`` a step."""
    rec = record()
    if rec is None:
        return None
    spans = [rec.device_interval(s) for s in rec.spans if s.name == name]
    if not spans or None in spans:
        return None
    return sum(b - a for a, b in spans) / len(steps(rec))


def loop_idle_ms() -> Optional[float]:
    """Device ms from each step's end to the next step's start within an
    epoch, summed, over the steps."""
    rec = record()
    if rec is None:
        return None
    by_epoch: Dict[Optional[int], List] = {}
    for s in steps(rec):
        by_epoch.setdefault(s.parent, []).append(rec.device_interval(s))
    idle = 0.0
    for intervals in by_epoch.values():
        if None in intervals:
            return None
        idle += sum(b[0] - a[1] for a, b in zip(intervals, intervals[1:]))
    return idle / len(steps(rec))


def step_host_ms() -> Optional[float]:
    """Mean host ms of a step, from taking its rows to the end of its
    optimizer step."""
    rec = record()
    if rec is None:
        return None
    return sum(s.host_ms for s in steps(rec)) / len(steps(rec))


def counter(name: str) -> Optional[int]:
    """The record's counter ``name``, or None."""
    rec = record()
    return None if rec is None else rec.counters.get(name)
