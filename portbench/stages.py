"""The program's stage spans over the traced slice (``repro_torch.spans``).

The searchers record their stages and their blocking host reads
(``wait.<site>``) in memory while a profiler runs, stamped with
``time.time_ns()``, the clock of the profiler's host events.  ``read(ctx)``
takes them once per run (cached on ``ctx``), puts them on the profiler's
microseconds, keeps the calls whose root span (``engine.search``) lies
inside a counted ``portbench.call``, and gives each stage of each call:

- its host self time: the span less its child spans;
- the device's idle time inside that self time (``Trace.idle_gaps``);
- the device time of the operations launched from it: each device event's
  launch is the CUDA runtime call of the same correlation id (else the host
  event its ``linked_correlation_id`` names), and the stage is the innermost
  span open at that instant, a ``wait.*`` span counting for the stage that
  holds it;
- the time of its ``wait.*`` children.

The per-layer readers in ``metrics/`` sum these over the stages of their
layer.  A program without the spans (no ``repro_torch.spans``, or no record
in the counted calls) gives None, and its metrics are left out.
"""
from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from dataclasses import dataclass, field

from portbench import profiling

ROOT = "engine.search"
WAIT = "wait."
# the scan kernels' device time stays with the CUDA kernels layer
SCAN_KERNELS = ("fused_scan_kernel", "rabitq_fused_kernel")
SEARCHER = ("engine.", "pq.", "rabitq.route", "rabitq.sample",
            "rabitq.scan")
COLLECTOR = ("collect", "rabitq.band", "rerank.", "select")


def layer_of(name: str) -> str | None:
    """"searcher", "collector" or "wait" for a stage name, else None."""
    if name.startswith(WAIT):
        return "wait"
    if name.startswith(SEARCHER):
        return "searcher"
    if name.startswith(COLLECTOR):
        return "collector"
    return None


@dataclass
class StageTimes:
    """Per stage name, summed over the kept calls (us)."""
    calls: int = 0
    self_us: dict = field(default_factory=lambda: defaultdict(float))
    idle_us: dict = field(default_factory=lambda: defaultdict(float))
    device_us: dict = field(default_factory=lambda: defaultdict(float))
    wait_us: dict = field(default_factory=lambda: defaultdict(float))
    scan_us: float = 0.0           # the scan kernels, launched in any stage
    device_total_us: float = 0.0   # device time launched in the kept calls
    unplaced_us: float = 0.0       # device time with no launch found
    syncs_outside_waits: int = 0   # blocking runtime calls in no wait span
    clock_slack_us: tuple = (0.0, 0.0)   # widest root-to-portbench.search

    def per_call_ms(self, table: dict, layer: str) -> float | None:
        if not self.calls:
            return None
        return sum(v for k, v in table.items()
                   if layer_of(k) == layer) / self.calls / 1e3


def read(ctx) -> StageTimes | None:
    """The run's stage times, made once and kept on ``ctx``."""
    if not hasattr(ctx, "stage_times"):
        ctx.stage_times = _make(ctx)
    return ctx.stage_times


def _make(ctx) -> StageTimes | None:
    tr, win = ctx.profile, ctx.window
    if tr is None or not tr.n_calls or win is None or win.profiler is None:
        return None
    try:
        from repro_torch import spans
    except ImportError:             # a program without stage spans
        return None
    import torch
    prof = win.profiler
    out = assign(spans.records(), prof.kineto_results.trace_start_ns(),
                 tr, prof.function_events, torch.autograd.DeviceType.CUDA)
    if out is not None:
        print(summary(out), file=sys.stderr, flush=True)
    return out


class _Call:
    """One kept call's spans on the profiler's clock: (t0, t1, name, id,
    parent), the root first."""

    def __init__(self, spans_us: list):
        self.spans = sorted(spans_us, key=lambda s: (s[0], -s[1]))
        self.t0, self.t1 = self.spans[0][0], self.spans[0][1]
        self.by_id = {s[3]: s for s in self.spans}

    def stage_at(self, t: float):
        """The innermost span open at ``t`` (spans of one call nest)."""
        best = None
        for s in self.spans:
            if s[0] > t:
                break
            if s[1] >= t:
                best = s
        return best

    def owner(self, s):
        """``s``, or for a wait span the span that holds it."""
        while s[2].startswith(WAIT) and s[4] in self.by_id:
            s = self.by_id[s[4]]
        return s


def _calls(records, base_ns: int, counted: list) -> list[_Call]:
    """The calls whose root span lies inside a counted call interval."""
    groups = defaultdict(list)
    for r in records:
        groups[r.call].append(((r.t0_ns - base_ns) / 1e3,
                               (r.t1_ns - base_ns) / 1e3, r.name, r.span,
                               r.parent))
    starts = [c[0] for c in counted]
    kept = []
    for spans_us in groups.values():
        roots = [s for s in spans_us if s[4] == 0 and s[2] == ROOT]
        if len(roots) != 1:
            continue
        s0, s1 = roots[0][0], roots[0][1]
        i = bisect.bisect_right(starts, s0) - 1
        if i >= 0 and s1 <= counted[i][1]:
            kept.append(_Call(spans_us))
    kept.sort(key=lambda c: c.t0)
    return kept


def _self_intervals(call: _Call, s) -> list[tuple[float, float]]:
    """``s``'s interval less its children's."""
    kids = sorted((c[0], c[1]) for c in call.spans if c[4] == s[3])
    out, cur = [], s[0]
    for a, b in kids:
        if a > cur:
            out.append((cur, min(a, s[1])))
        cur = max(cur, b)
    if s[1] > cur:
        out.append((cur, s[1]))
    return out


def _overlap(intervals, gaps, gap_ends) -> float:
    total = 0.0
    for a, b in intervals:
        j = bisect.bisect_right(gap_ends, a)
        while j < len(gaps) and gaps[j][0] < b:
            total += max(0.0, min(b, gaps[j][1]) - max(a, gaps[j][0]))
            j += 1
    return total


def _launches(events, device_type):
    """Host start of each runtime call by correlation id, and of every
    other host event by its id."""
    runtime, frontend = {}, {}
    for e in events:
        if e.device_type == device_type:
            continue
        table = runtime if e.name.startswith("cu") else frontend
        table.setdefault(e.id, float(e.time_range.start))
    return runtime, frontend


def assign(records, base_ns: int, tr, events,
           device_type) -> StageTimes | None:
    """Stage times of the calls of ``records`` that lie inside ``tr``'s
    counted calls (a ``profiling.Trace``), with ``events`` the profiler's
    function events and ``base_ns`` its trace start."""
    calls = _calls(records, base_ns, tr.calls)
    if not calls:
        return None
    out = StageTimes(calls=len(calls))
    gaps = tr.idle_gaps()
    gap_ends = [g[1] for g in gaps]
    for call in calls:
        for s in call.spans:
            own = _self_intervals(call, s)
            out.self_us[s[2]] += sum(b - a for a, b in own)
            out.idle_us[s[2]] += _overlap(own, gaps, gap_ends)
            if s[2].startswith(WAIT):
                out.wait_us[call.owner(s)[2]] += s[1] - s[0]

    runtime, frontend = _launches(events, device_type)
    t_lo, t_hi = tr.calls[0][0], tr.calls[-1][1]
    starts = [c.t0 for c in calls]
    for e in events:
        if e.device_type != device_type or e.name.startswith("portbench."):
            continue
        s, t = float(e.time_range.start), float(e.time_range.end)
        if t <= t_lo or s >= t_hi:
            continue
        dur = min(t, t_hi) - max(s, t_lo)
        at = runtime.get(e.id)
        if at is None:
            at = frontend.get(getattr(e, "linked_correlation_id", 0) or -1)
        i = bisect.bisect_right(starts, at) - 1 if at is not None else -1
        stage = calls[i].stage_at(at) if i >= 0 else None
        if stage is None:
            if at is None:
                out.unplaced_us += dur
            continue
        out.device_total_us += dur
        if any(k in e.name for k in SCAN_KERNELS):
            out.scan_us += dur
        else:
            out.device_us[calls[i].owner(stage)[2]] += dur

    waits = [(s[0], s[1]) for c in calls for s in c.spans
             if s[2].startswith(WAIT)]
    waits.sort()
    wait_starts = [w[0] for w in waits]
    for s, _, name in tr.host:
        if name in profiling.SYNCS and tr.in_search(s):
            j = bisect.bisect_right(wait_starts, s) - 1
            if j < 0 or waits[j][1] < s:
                out.syncs_outside_waits += 1
    lead = lag = 0.0
    for c in calls:
        j = bisect.bisect_right(tr.searches, (c.t0, float("inf"))) - 1
        if j >= 0 and tr.searches[j][1] >= c.t1:
            lead = max(lead, c.t0 - tr.searches[j][0])
            lag = max(lag, tr.searches[j][1] - c.t1)
        else:                       # the clocks disagree
            lead = lag = float("inf")
    out.clock_slack_us = (lead, lag)
    return out


def summary(st: StageTimes) -> str:
    """One stderr line: per stage, ms a call of host self time, device
    idle, device time launched and waits, then the checks."""
    n = max(st.calls, 1)
    rows = []
    for name in sorted(st.self_us, key=lambda k: -st.self_us[k]):
        rows.append(f"{name} {st.self_us[name] / n / 1e3:.3f}/"
                    f"{st.idle_us[name] / n / 1e3:.3f}/"
                    f"{st.device_us.get(name, 0.0) / n / 1e3:.3f}/"
                    f"{st.wait_us.get(name, 0.0) / n / 1e3:.3f}")
    lead, lag = st.clock_slack_us
    return (f"portbench: stages over {st.calls} calls, ms a call "
            f"(self/idle/device/wait): " + ", ".join(rows) +
            f"; scan kernels {st.scan_us / n / 1e3:.3f}, device launched "
            f"{st.device_total_us / n / 1e3:.3f}, unplaced "
            f"{st.unplaced_us / n / 1e3:.3f}; syncs outside waits "
            f"{st.syncs_outside_waits}; root inside portbench.search by "
            f"{lead:.1f}/{lag:.1f} us at most")
