"""Injectable monotonic clocks for the serving tier.

Every serving component is written against an explicit ``now`` so the
discrete-event tests own the timeline.  A front end on wall time (the
socket tier, ``repro_torch.transport``) must share the exact code paths the discrete-event tests exercise, so
instead of scattering ``time.time()`` through the loop, time comes from
ONE injected clock object:

* :class:`SystemClock` — wraps ``time.monotonic`` (never ``time.time``:
  wall time can step backwards under NTP, which would corrupt heartbeat
  ages and timer deadlines);
* :class:`ManualClock` — an advance-by-hand clock for tests and for the
  replay driver, which sets it to each recorded event's timestamp.

Components that accept a clock take an explicit ``now`` argument
everywhere and only fall back to ``clock.now()`` when the caller omits
it, so the discrete-event users are unchanged and the wall-clock users
never touch a time module directly.
"""
from __future__ import annotations

import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """Anything with a monotonic ``now() -> float`` (seconds)."""

    def now(self) -> float:  # pragma: no cover - protocol stub
        ...


class SystemClock:
    """Wall-clock time from ``time.monotonic`` (steady, never steps back)."""

    def now(self) -> float:
        return time.monotonic()


class ManualClock:
    """Test / replay clock: advances only when told to.

    ``set`` enforces monotonicity (a replay transcript with out-of-order
    timestamps is corrupt and must fail loudly, not silently reorder the
    health view's beat ages).
    """

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a monotonic clock by {dt}")
        self._t += float(dt)
        return self._t

    def set(self, t: float) -> float:
        if t < self._t:
            raise ValueError(
                f"monotonic clock cannot step back: {t} < {self._t}")
        self._t = float(t)
        return self._t
