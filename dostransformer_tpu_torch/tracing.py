"""Spans and counters of the port's training loop, for whoever profiles it.

Tracing is on while a ``torch.profiler`` profile is recording and off
otherwise; there is no switch of its own. Off, :func:`span` costs one check
of the profiler's flag and returns a shared no-op context, and
:func:`phase` returns at once: nothing is recorded, allocated or
synchronised.

On, a span records its name, the index of its parent (the innermost span
open when it began), the step it belongs to (``step``, inherited by its
children), small attributes, and its host start and end from
``time.time_ns()``. That is the profiler's own clock: the times of
``prof.events()`` are offsets from ``prof.profiler.kineto_results
.trace_start_ns()``, which counts the same wall-clock nanoseconds, so a span
can be set against the profiler's events. A span on a CUDA ``device`` also
records a ``torch.cuda.Event`` on the device's current stream at each
boundary (none while that stream is capturing a graph); the events come
from a pool, and their times are read only when the record is read, after
the caller's synchronise, so the traced loop gains no sync. On the CPU a
span's device interval is its host interval.

:func:`phase` divides the innermost open span into consecutive phases that
tile it: the first begins at the span's start, each next one where the one
before ended, the last ends at the span's end. So a train step of four
phases records five boundaries. Each phase is a span of the record whose
parent is the divided span.

The spans are not ``torch.profiler.record_function`` ranges: the profile
the profiler writes is the same with and without them.

Counters (:func:`count`) add host integers, always, whether tracing is on
or not; callers add them once per bucket and epoch, never from a device
value.

The record (:func:`record`) is cleared at the first span that finds
tracing on after one that found it off, so it holds the latest profiled
window (two windows with no span between them share one record: the
profiler tells nothing of where one ends; :meth:`Record.clear` separates
them), and it is read without being consumed. ``cli/common.py
--profile_dir`` writes it into the profiler's Chrome trace
(:func:`write_chrome_trace`).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


class Mark(NamedTuple):
    """One boundary: its host time, and its event on the card (None on the
    CPU, and on the card while the stream captures)."""
    host_ns: int
    event: Optional[Any]


@dataclass
class Span:
    """One recorded span; ``end`` is None while it is open."""
    name: str
    parent: Optional[int]
    step: Optional[Tuple[int, int]]
    attrs: Dict[str, Any]
    device: Optional[torch.device]
    start: Mark
    end: Optional[Mark] = None
    phase: Optional[int] = field(default=None, repr=False)  # the open one

    @property
    def host_ms(self) -> float:
        return (self.end.host_ns - self.start.host_ns) / 1e6


class Record:
    """The spans and counters of the latest profiled window."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.on = False      # whether the last span found tracing on
        self._open: List[int] = []
        self._pool: List[Any] = []   # timing events, free
        self._used: List[Any] = []   # and recorded in this window
        self._origin = None          # the window's first recorded event

    def clear(self) -> None:
        self.spans, self.counters, self._open = [], {}, []
        self._pool += self._used
        self._used, self._origin = [], None

    def _mark(self, device: Optional[torch.device]) -> Mark:
        event = None
        if (device is not None and device.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            event = (self._pool.pop() if self._pool
                     else torch.cuda.Event(enable_timing=True))
            event.record(torch.cuda.current_stream(device))
            self._used.append(event)
            if self._origin is None:
                self._origin = event
        return Mark(time.time_ns(), event)

    def open(self, name: str, step, device, attrs: Dict[str, Any]) -> int:
        if not self.on:
            self.clear()
            self.on = True
        parent = self._open[-1] if self._open else None
        if parent is not None:
            up = self.spans[parent]
            step = up.step if step is None else step
            device = up.device if device is None else device
        self.spans.append(Span(name, parent, step, attrs,
                               None if device is None
                               else torch.device(device),
                               self._mark(device)))
        self._open.append(len(self.spans) - 1)
        return len(self.spans) - 1

    def close(self, index: int) -> None:
        if not self._open or self._open[-1] != index:
            return  # the record was cleared while the span was open
        self._open.pop()
        s = self.spans[index]
        s.end = self._mark(s.device)
        if s.phase is not None:
            self.spans[s.phase].end = s.end

    def next_phase(self, name: str) -> None:
        if not self._open:
            return
        index = self._open[-1]
        up = self.spans[index]
        if up.phase is None:
            start = up.start
        else:
            start = self.spans[up.phase].end = self._mark(up.device)
        self.spans.append(Span(name, index, up.step, {}, up.device, start))
        up.phase = len(self.spans) - 1

    def device_ms(self, mark: Mark, span: Span) -> Optional[float]:
        """The boundary's device time in ms: on the card from the window's
        first event (None where no event was recorded), on the CPU from the
        first span's host start. Read it after a synchronise."""
        if span.device is not None and span.device.type == "cuda":
            if mark.event is None:
                return None
            return self._origin.elapsed_time(mark.event)
        return (mark.host_ns - self.spans[0].start.host_ns) / 1e6

    def device_interval(self, span: Span
                        ) -> Optional[Tuple[float, float]]:
        """(start, end) of ``span`` on the device, in ms, or None."""
        if span.end is None:
            return None
        a, b = self.device_ms(span.start, span), self.device_ms(span.end,
                                                                span)
        return None if a is None or b is None else (a, b)


_RECORD = Record()


class _Open:
    __slots__ = ("args", "index")

    def __init__(self, *args):
        self.args = args

    def __enter__(self):
        self.index = _RECORD.open(*self.args)
        return self

    def __exit__(self, *exc):
        _RECORD.close(self.index)
        return False


def span(name: str, step: Optional[Tuple[int, int]] = None,
         device=None, **attrs):
    """A context that records the span ``name`` while tracing is on.
    ``step`` (the step's identifier, ``(epoch, step)``) and ``device`` (whose
    stream the span's events go on; None: the host alone) default to the
    parent's."""
    if not _profiler._is_profiler_enabled:
        _RECORD.on = False
        return _OFF
    return _Open(name, step, device, attrs)


def phase(name: str) -> None:
    """End the open phase of the innermost open span, if any, and begin its
    phase ``name`` at the same boundary (see the module docstring)."""
    if _profiler._is_profiler_enabled:
        _RECORD.next_phase(name)


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to the counter ``name``."""
    _RECORD.counters[name] = _RECORD.counters.get(name, 0) + int(n)


def record() -> Record:
    """The record of the latest profiled window (not a copy)."""
    return _RECORD


def write_chrome_trace(path: str) -> None:
    """Add the record to the profiler's Chrome trace at ``path``: each
    closed span as a complete event on a row of its own, on the trace's
    time base (``baseTimeNanoseconds``), with its step, attributes and
    device milliseconds; and the counters as one counter event at the end
    of the last span."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid, tid = os.getpid(), 1
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": "dostransformer_tpu_torch spans"}})
    closed = [s for s in _RECORD.spans if s.end is not None]
    for s in closed:
        args = dict(s.attrs, step=s.step, parent=None if s.parent is None
                    else _RECORD.spans[s.parent].name)
        interval = _RECORD.device_interval(s)
        if interval is not None:
            args["device_ms"] = interval[1] - interval[0]
        events.append({"ph": "X", "name": s.name, "cat": "program",
                       "pid": pid, "tid": tid,
                       "ts": (s.start.host_ns - base) / 1e3,
                       "dur": (s.end.host_ns - s.start.host_ns) / 1e3,
                       "args": args})
    if _RECORD.counters and closed:
        last = max(s.end.host_ns for s in closed)
        events.append({"ph": "C", "name": "train counters", "pid": pid,
                       "tid": tid, "ts": (last - base) / 1e3,
                       "args": dict(_RECORD.counters)})
    with open(path, "w") as f:
        json.dump(trace, f)
