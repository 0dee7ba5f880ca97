"""The measured window of a closed loop: one caller, who sends the next call
when the previous one has returned.

Queries come from ``Supply``: chunks of fresh queries made on the host from
the seed and the chunk's index, made ahead of the call that uses them and
outside every timed call.  Each call gets a host tensor, as a user's would,
so the copy to the card is part of the call.  A call is timed on the host
clock from before the program's entry to the end of a device synchronise.

A seeded reservoir keeps the answers of ``sample`` calls drawn uniformly
from all the window's calls (the same number in every run), in slots made
before the window, for the comparison with the reference once the window
has closed.  With tracing on,
the profiler records calls ``skip`` to ``skip + calls`` of the window.
"""
from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from portbench import profiling, synth


class Supply:
    """Fresh queries for the window: chunk ``c`` of the ``QUERIES`` stream,
    split into calls of ``per_call`` queries (``per_call`` 0: one (d,)
    query a call)."""

    def __init__(self, cfg: dict, x: np.ndarray, seed: int, per_call: int,
                 chunk: int, stream: int = synth.QUERIES):
        width = max(per_call, 1)
        if chunk % width:
            raise ValueError(f"chunk {chunk} is not a multiple of {width}")
        self.cfg, self.x, self.seed, self.stream = cfg, x, seed, stream
        self.per_call, self.chunk = per_call, chunk
        self._next_chunk, self._calls = 0, []

    def _fill(self) -> None:
        qs = synth.query_chunk(self.cfg, self.x, self.seed, self.stream,
                               self._next_chunk, self.chunk)
        self._next_chunk += 1
        if self.per_call:
            self._calls = [qs[i:i + self.per_call]
                           for i in range(0, len(qs), self.per_call)]
        else:
            self._calls = list(qs)
        self._calls.reverse()

    def call(self, index: int) -> np.ndarray:
        """The queries of call ``index``, made again from the seed."""
        width = max(self.per_call, 1)
        chunk, at = divmod(index * width, self.chunk)
        qs = synth.query_chunk(self.cfg, self.x, self.seed, self.stream,
                               chunk, self.chunk)
        return qs[at:at + self.per_call] if self.per_call else qs[at]

    def ready(self) -> None:
        """Make the next chunk now if the current one is spent."""
        if not self._calls:
            self._fill()

    def next(self) -> np.ndarray:
        self.ready()
        return self._calls.pop()


@dataclass
class CallRecord:
    """What a traced or sampled call leaves for the readers."""
    index: int
    queries: np.ndarray | None     # (b, d), (d,) for a single query; None
    result: object                 # the program's SearchResult


class Reservoir:
    """A uniform sample of ``size`` calls of the window (Algorithm R, drawn
    from ``rng``), each call's ids and distances copied on the device into
    slots made before the window, so that keeping a sample allocates
    nothing while it runs."""

    def __init__(self, size: int, like, rng: np.random.Generator):
        import torch
        self.size, self.rng, self.seen = size, rng, 0
        self.ids = torch.empty((size, *like.ids.shape), dtype=like.ids.dtype,
                               device=like.ids.device)
        self.dists = torch.empty((size, *like.dists.shape),
                                 dtype=like.dists.dtype,
                                 device=like.dists.device)
        self.calls: list[int] = []

    def offer(self, index: int, res) -> None:
        slot = self.seen if self.seen < self.size else int(
            self.rng.integers(0, self.seen + 1))
        self.seen += 1
        if slot >= self.size:
            return
        self.ids[slot].copy_(res.ids)
        self.dists[slot].copy_(res.dists)
        if slot == len(self.calls):
            self.calls.append(index)
        else:
            self.calls[slot] = index

    def records(self) -> list[CallRecord]:
        """The sampled calls in window order, with their answers (the
        queries are left to ``Supply.call``)."""
        out = [CallRecord(i, None, SimpleNamespace(ids=self.ids[s],
                                                   dists=self.dists[s]))
               for s, i in enumerate(self.calls)]
        return sorted(out, key=lambda r: r.index)


@dataclass
class Window:
    latencies: list[float] = field(default_factory=list)   # seconds
    queries: int = 0
    failed: int = 0
    seconds: float = 0.0
    sample: list[CallRecord] = field(default_factory=list)
    traced: list[CallRecord] = field(default_factory=list)
    profiler: object = None


def closed_loop(search, supply: Supply, seconds: float, sync,
                reservoir: Reservoir, trace: dict | None = None,
                profiler_factory=None) -> Window:
    """Call ``search`` back to back for ``seconds``; ``sync`` waits for the
    device.  ``reservoir`` keeps the sample; ``trace`` ({"skip": s,
    "calls": c}) records calls s..s+c-1 with the profiler that
    ``profiler_factory()`` makes."""
    from torch.autograd.profiler import record_function

    win = Window()
    prof, span = None, contextlib.nullcontext
    first = last = -1
    if trace:
        first, last = trace["skip"], trace["skip"] + trace["calls"]
    supply.ready()
    t_start = t_last = time.perf_counter()
    t_end = t_start + seconds
    i = 0
    while time.perf_counter() < t_end:
        q = supply.next()
        if i == first:
            prof = profiler_factory()
            prof.__enter__()
            span = record_function
        n_q = q.shape[0] if q.ndim == 2 else 1
        t0 = time.perf_counter()
        try:
            with span(profiling.CALL):
                with span(profiling.SEARCH):
                    res = search(torch.from_numpy(q))
                sync()
        except RuntimeError as exc:       # a failed call is counted
            res = None
            if not win.failed:
                print(f"portbench: call {i} failed: {exc!r}", file=sys.stderr,
                      flush=True)
            win.failed += n_q
        t_last = time.perf_counter()
        win.latencies.append(t_last - t0)
        win.queries += n_q
        if res is not None:
            reservoir.offer(i, res)
            if prof is not None:       # the counters only
                win.traced.append(CallRecord(
                    i, q, res._replace(dists=None, ids=None)))
        i += 1
        if prof is not None and i == last:
            prof.__exit__(None, None, None)
            win.profiler, prof, span = prof, None, contextlib.nullcontext
        supply.ready()
    win.seconds = t_last - t_start
    if prof is not None:
        prof.__exit__(None, None, None)
        win.profiler = prof
    win.sample = reservoir.records()
    return win
