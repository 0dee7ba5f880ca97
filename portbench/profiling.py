"""Reading a ``torch.profiler`` trace of the window's traced slice.

The harness wraps every call of the slice in a ``portbench.call`` span and
the program's entry inside it in a ``portbench.search`` span (both
``record_function``).  ``Trace`` keeps, on the profiler's clock (us):

- the spans of the calls it counts (the slice's first ``skip`` calls, which
  pay the profiler's own start, are left out);
- the device's operations (kernels, copies, sets) inside those calls;
- the host's events (operators, CUDA runtime calls, the spans);

and derives what the per-layer readers and the ``breakdown`` need: device
busy time, idle gaps named by the host event that was running, kernels and
blocking runtime calls per call, device time by operation.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

CALL, SEARCH = "portbench.call", "portbench.search"
# CUDA runtime calls that hold the host until the device has got somewhere
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")
COPIES = ("Memcpy", "Memset")


def _span(ev) -> tuple[float, float]:
    return float(ev.time_range.start), float(ev.time_range.end)


@dataclass
class Trace:
    """The counted calls of one traced slice."""
    calls: list[tuple[float, float]]
    searches: list[tuple[float, float]]
    device: list[tuple[float, float, str]]
    host: list[tuple[float, float, str]]
    _host_starts: list[float] = field(default_factory=list, repr=False)

    def __post_init__(self):
        # outer events before the events they hold
        self.host.sort(key=lambda h: (h[0], -h[1]))
        self.device.sort()
        self._host_starts = [h[0] for h in self.host]

    @classmethod
    def from_events(cls, events, device_type, skip: int = 2) -> "Trace":
        spans = sorted(_span(e) for e in events
                       if e.name == CALL and e.device_type != device_type)
        calls = spans[skip:] if len(spans) > skip else []
        if not calls:
            return cls([], [], [], [])
        t0, t1 = calls[0][0], calls[-1][1]
        searches = sorted(
            _span(e) for e in events if e.name == SEARCH
            and e.device_type != device_type and t0 <= _span(e)[0] <= t1)
        device, host = [], []
        for e in events:
            s, t = _span(e)
            if e.device_type == device_type:
                if e.name.startswith("portbench.") or t <= t0 or s >= t1:
                    continue
                device.append((max(s, t0), min(t, t1), e.name))
            elif s <= t1 and t >= t0:
                host.append((s, t, e.name))
        return cls(calls, searches, device, host)

    @property
    def n_calls(self) -> int:
        return len(self.calls)

    @property
    def window_us(self) -> float:
        return self.calls[-1][1] - self.calls[0][0] if self.calls else 0.0

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device's operations, merged."""
        out: list[list[float]] = []
        for s, t, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    def busy_us(self) -> float:
        return sum(t - s for s, t in self.busy_intervals())

    def idle_gaps(self) -> list[tuple[float, float]]:
        """Stretches of the counted window with nothing on the device."""
        if not self.calls:
            return []
        gaps, cur = [], self.calls[0][0]
        for s, t in self.busy_intervals():
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, t)
        if self.calls[-1][1] > cur:
            gaps.append((cur, self.calls[-1][1]))
        return gaps

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost host event open
        then, with the operator around it where that is a runtime call."""
        i = bisect.bisect_right(self._host_starts, t)
        open_ = []
        for s, e, name in reversed(self.host[max(0, i - 4000):i]):
            if e >= t:
                open_.append(name)
                if not name.startswith("cuda") or len(open_) == 2:
                    break
        if not open_:
            return "(between calls)"
        if open_[0].startswith("cuda") and len(open_) == 2:
            return f"{open_[1]} / {open_[0]}"
        return open_[0]

    def kernels(self) -> list[tuple[float, float, str]]:
        return [d for d in self.device if not d[2].startswith(COPIES)]

    def in_search(self, t: float) -> bool:
        i = bisect.bisect_right(self.searches, (t, float("inf"))) - 1
        return i >= 0 and self.searches[i][0] <= t <= self.searches[i][1]

    def syncs(self) -> int:
        """Blocking runtime calls made inside the program's entry."""
        return sum(1 for s, _, name in self.host
                   if name in SYNCS and self.in_search(s))

    def device_time_by_name(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for s, t, name in self.device:
            out[name] += t - s
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle time by
        what the host was doing, in seconds per call."""
        n = max(self.n_calls, 1)
        ops = sorted(self.device_time_by_name().items(), key=lambda r: -r[1])
        idle: dict[str, float] = defaultdict(float)
        for s, t in self.idle_gaps():
            idle[self.host_at(0.5 * (s + t))] += t - s
        gaps = sorted(idle.items(), key=lambda r: -r[1])
        return {"device_ops": [[k[:200], v * 1e-6 / n] for k, v in ops[:top]],
                "idle_gaps": [[k[:200], v * 1e-6 / n]
                              for k, v in gaps[:top]]}
