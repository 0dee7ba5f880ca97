"""Replica health: heartbeat liveness + service-time anomaly detection.

The router must not route to a replica that is dead or limping, but it can
only know what is OBSERVABLE from outside the service boundary:

* **heartbeats** — each replica beats every ``hb_interval`` while its
  process is making progress (completions also count as beats).  A crash
  stops the beats; a stall suppresses them for the stall window.  A replica
  whose last beat is older than ``miss_factor`` intervals is ``DOWN``.
* **service-time anomalies** — per-replica EMA of the ratio
  ``measured_service / pool_baseline`` for each completed batch, where the
  baseline is the shared per-bucket service EMA the admission controller
  and batcher already use.  A healthy replica hovers near 1.0; a replica
  under a ``slow`` fault (or a noisy neighbor) drifts to its slowdown
  factor and is marked ``SUSPECT`` when the EMA exceeds
  ``anomaly_factor`` — still alive, deprioritized for routing, eligible
  for brownout serving.

``status`` is a pure function of the recorded observations and ``now``, so
seeded fault runs replay the exact same health transitions.

Time handling: every method takes an explicit ``now`` — the discrete-event
loops own their timeline.  Wall-clock callers (the socket front end,
``repro_torch.transport``) instead inject a monotonic
:class:`~.clock.Clock` at construction and omit ``now``; the two never
mix inside one view, so the identical code path serves both regimes
without a single direct ``time.time()`` call.  The port's copy of the
reference's module, on the port's own clock.
"""
from __future__ import annotations

from repro_torch.serving.clock import Clock

HEALTHY = "healthy"
SUSPECT = "suspect"
DOWN = "down"


class HealthView:
    """What the router knows about each replica, from observations only."""

    def __init__(self, n_replicas: int, *, hb_interval: float = 0.05,
                 miss_factor: float = 3.0, anomaly_factor: float = 3.0,
                 anomaly_decay: float = 0.5, clock: Clock | None = None):
        if n_replicas < 1:
            raise ValueError(f"need >= 1 replica, got {n_replicas}")
        if miss_factor <= 1.0:
            raise ValueError("miss_factor must exceed 1 heartbeat interval")
        self.n_replicas = int(n_replicas)
        self.hb_interval = float(hb_interval)
        self.miss_factor = float(miss_factor)
        self.anomaly_factor = float(anomaly_factor)
        self.anomaly_decay = float(anomaly_decay)
        self.clock = clock
        self._last_beat = [0.0] * n_replicas
        self._ratio: list[float | None] = [None] * n_replicas

    def _now(self, now: float | None) -> float:
        if now is not None:
            return now
        if self.clock is None:
            raise ValueError(
                "HealthView needs an explicit `now` unless a clock was "
                "injected at construction")
        return self.clock.now()

    # -- observations --------------------------------------------------------

    def start(self, now: float | None = None) -> None:
        """Mark every replica as freshly alive (server start)."""
        self._last_beat = [self._now(now)] * self.n_replicas

    def beat(self, rid: int, now: float | None = None) -> None:
        self._last_beat[rid] = max(self._last_beat[rid], self._now(now))

    def observe(self, rid: int, seconds: float, baseline: float) -> None:
        """Fold one completed batch's measured service time into the
        replica's anomaly ratio (``baseline`` = the shared per-bucket EMA
        estimate at completion time)."""
        ratio = seconds / max(baseline, 1e-9)
        prev = self._ratio[rid]
        self._ratio[rid] = ratio if prev is None else \
            self.anomaly_decay * prev + (1 - self.anomaly_decay) * ratio

    def reset(self, rid: int, now: float | None = None) -> None:
        """Respawn: the replica is a fresh process — history is gone."""
        self._last_beat[rid] = self._now(now)
        self._ratio[rid] = None

    # -- the view ------------------------------------------------------------

    def beat_age(self, rid: int, now: float | None = None) -> float:
        return self._now(now) - self._last_beat[rid]

    def anomaly(self, rid: int) -> float:
        """Current service-time ratio EMA (1.0 until first observation)."""
        r = self._ratio[rid]
        return 1.0 if r is None else r

    def status(self, rid: int, now: float | None = None) -> str:
        now = self._now(now)
        if self.beat_age(rid, now) > self.miss_factor * self.hb_interval:
            return DOWN
        if self.anomaly(rid) > self.anomaly_factor:
            return SUSPECT
        return HEALTHY

    def healthy(self, now: float | None = None) -> list[int]:
        now = self._now(now)
        return [r for r in range(self.n_replicas)
                if self.status(r, now) == HEALTHY]

    def alive(self, now: float | None = None) -> list[int]:
        """Replicas not conclusively dead — the brownout candidate set."""
        now = self._now(now)
        return [r for r in range(self.n_replicas)
                if self.status(r, now) != DOWN]
