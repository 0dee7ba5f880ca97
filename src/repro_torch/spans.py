"""Stage spans and work counters of the search path, kept in memory while
a profiler runs.

The batched searchers mark their stages (routing, stream gather, tables or
sample bounds, sample and plan, scan, collection, second pass, selection)
and every host read that blocks on the device (``wait.<site>``):

    with spans.span("pq.scan"):
        ...

and count, at the same boundaries, the work they decide inside a call:

    spans.count("collect.widened", int(most > budget))
    spans.count("scan.pairs_probed", hist)

A span is recorded only while a torch profiler is recording in this thread
(``torch.autograd.profiler.profile`` or ``torch.profiler.profile``); at any
other time ``span`` returns one shared no-op context and records nothing.
A record holds the call id (shared by every span of one call: a span opened
with no span open starts a call, as ``SearchEngine.search``'s root span
does), its own id, its parent's id (0 for a root), its name, and its start
and end from ``time.time_ns()``, the clock the profiler's host events are
stamped on (``(t - prof.kineto_results.trace_start_ns()) / 1e3`` puts a
record on the profiler's microseconds).  The spans are not profiler events:
``record_function`` ranges would also appear on the device's timeline.

A counter is attached to the innermost open span: it holds that span's
call id and id, its name and its value (with no span open it records
nothing).  The value is a host int the caller already holds, or a small
tensor the call makes anyway, whose sum ``counters()`` reads after the
window: a counter adds no kernel, no allocation and no host read inside a
call.

Spans and counters go into one buffer of ``CAPACITY`` records; past it
they are dropped and counted (``RECORDER.dropped``).  ``records()``
returns a copy of the spans, ``counters()`` of the counters with every
value an int, ``clear()`` empties the buffer.  There is no exporter: a
reader takes the records from the process that made them.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch._C._autograd import _profiler_enabled

CAPACITY = 65536


class SpanRecord(NamedTuple):
    """One closed span; times in ``time.time_ns()`` nanoseconds."""
    call: int
    span: int
    parent: int
    name: str
    t0_ns: int
    t1_ns: int


class CountRecord(NamedTuple):
    """One counter, attached to span ``span`` of call ``call``."""
    call: int
    span: int
    name: str
    value: object        # an int; before ``counters()``, maybe a tensor


class Recorder:
    """A fixed-capacity buffer of closed spans and counters, and the open
    spans of each thread."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.dropped = 0
        self._records: list[SpanRecord] = []
        self._ids = itertools.count(1)
        self._open = threading.local()

    def span(self, name: str):
        """A context that records ``name`` while a profiler is recording,
        else the shared no-op context."""
        if not _profiler_enabled():
            return _OFF
        return _Span(self, name)

    def count(self, name: str, value) -> None:
        """Attach ``(name, value)``, an int or a tensor to be summed, to
        the innermost open span while a profiler is recording, else
        nothing."""
        if not _profiler_enabled():
            return
        stack = self._stack()
        if stack:
            top = stack[-1]
            self._keep(CountRecord(top.call, top.id, name, value))

    def records(self) -> list[SpanRecord]:
        return [r for r in self._records if type(r) is SpanRecord]

    def counters(self) -> list[CountRecord]:
        """The counters, each value an int.  A tensor's sum is read here,
        once, and kept in its place (which lets go of the tensor), so read
        this after the calls, never inside one."""
        out = []
        for i, r in enumerate(self._records):
            if type(r) is CountRecord:
                if isinstance(r.value, torch.Tensor):
                    r = self._records[i] = r._replace(
                        value=int(r.value.sum()))
                out.append(r)
        return out

    def clear(self) -> None:
        self._records.clear()
        self.dropped = 0

    def _stack(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def _keep(self, rec) -> None:
        if len(self._records) < self.capacity:
            self._records.append(rec)
        else:
            self.dropped += 1


class _Span:
    __slots__ = ("rec", "name", "call", "id", "parent", "t0")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = self.rec._stack()
        self.id = next(self.rec._ids)
        if stack:
            top = stack[-1]
            self.call, self.parent = top.call, top.id
        else:
            self.call, self.parent = self.id, 0
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.rec._stack().pop()
        self.rec._keep(SpanRecord(self.call, self.id, self.parent, self.name,
                                  self.t0, t1))
        return False


_OFF = contextlib.nullcontext()
RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
records = RECORDER.records
counters = RECORDER.counters
clear = RECORDER.clear
