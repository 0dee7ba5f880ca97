"""The program's work counters over the traced slice (``repro_torch.spans``).

Beside its stage spans, the program counts what it decides inside a call,
each counter attached to the stage that decided it:

- ``scan.pairs_passed``: the (query, lane) pairs the fused scan's grid
  covers;
- ``scan.pairs_probed``: those of them the routing probed, the set bits of
  the lane mask (the scan's histogram counts each once);
- ``collect.widened`` (the survivors outgrew the collector's budget, so
  the compaction ran at the widest row's count), ``rerank.dense_stragglers``
  (the exact pass over every lane) and ``select.full_width`` (the sort over
  every lane): 1 where the call took that fall-back from its budgeted path
  (the first two also count 0 where it did not).

``read(ctx)`` takes them once per run (cached on ``ctx``), after the
window, keeps those of the calls whose root span lies inside a counted
``portbench.call`` (the calls ``stages`` keeps), sums them by name, and
prints one stderr line with the sums and the recorder's dropped records.
It reads the stage times first, so the ``stages`` line prints in every
traced run too.  A program without counters (no ``spans.counters``, or
none in the kept calls) gives None, and its metrics are left out.
"""
from __future__ import annotations

import sys
from collections import defaultdict
from dataclasses import dataclass, field

from portbench import stages

PROBED, PASSED = "scan.pairs_probed", "scan.pairs_passed"
FULL_WIDTH = ("collect.widened", "rerank.dense_stragglers",
              "select.full_width")


@dataclass
class Counts:
    """The counters of the kept calls."""
    calls: int = 0                  # kept calls with a counter
    totals: dict = field(default_factory=dict)       # name -> sum
    full_width_calls: int = 0       # calls where a FULL_WIDTH counter fired
    dropped: int = 0                # the recorder's dropped records


def read(ctx) -> Counts | None:
    """The run's counters, made once and kept on ``ctx``."""
    if not hasattr(ctx, "counts"):
        stages.read(ctx)
        ctx.counts = _make(ctx)
    return ctx.counts


def _make(ctx) -> Counts | None:
    tr, win = ctx.profile, ctx.window
    if tr is None or not tr.n_calls or win is None or win.profiler is None:
        return None
    try:
        from repro_torch import spans
    except ImportError:             # a program without stage spans
        return None
    if not hasattr(spans, "counters"):
        return None
    base = win.profiler.kineto_results.trace_start_ns()
    out = tally(spans.records(), spans.counters(), base, tr.calls,
                spans.RECORDER.dropped)
    if out is not None:
        print(summary(out), file=sys.stderr, flush=True)
    return out


def tally(records, counters, base_ns: int, counted: list,
          dropped: int = 0) -> Counts | None:
    """The ``counters`` of the calls of ``records`` whose root span lies
    inside a ``counted`` call interval (profiler us, from ``base_ns``)."""
    kept = {s[3] for c in stages._calls(records, base_ns, counted)
            for s in c.spans if s[4] == 0}
    per_call = defaultdict(lambda: defaultdict(int))
    for c in counters:
        if c.call in kept:
            per_call[c.call][c.name] += c.value
    if not per_call:
        return None
    totals = defaultdict(int)
    for by_name in per_call.values():
        for name, v in by_name.items():
            totals[name] += v
    fired = sum(any(by_name.get(n, 0) > 0 for n in FULL_WIDTH)
                for by_name in per_call.values())
    return Counts(calls=len(per_call), totals=dict(totals),
                  full_width_calls=fired, dropped=dropped)


def summary(c: Counts) -> str:
    """One stderr line: each counter's sum and its mean a call."""
    n = max(c.calls, 1)
    rows = ", ".join(f"{name} {v} ({v / n:.2f} a call)"
                     for name, v in sorted(c.totals.items()))
    return (f"portbench: counters over {c.calls} calls: {rows}; full-width "
            f"calls {c.full_width_calls}; recorder dropped {c.dropped}")
