"""Admission control: per-shape-bucket service-time EMA + shed / k-cap.

An open-loop arrival stream can exceed the engine's capacity; without
admission control the queue grows without bound and EVERY request blows its
deadline.  The controller keeps the served set feasible by rejecting work at
enqueue time, using the only two facts it can know cheaply:

* a per-bucket **service-time EMA** (`ServiceEMA`) fed by the measured wall
  time of every completed batch — the same estimate the batcher's
  fire-on-slack rule uses, so scheduling and admission agree on capacity;
* the current **queue depth** per bucket, read from the batcher;
* the **in-flight batch**'s remaining EMA service time (``in_flight``):
  a request that arrives mid-batch cannot start before the executor frees
  up, so the server folds the currently-executing batch's estimated
  remainder into the wait — decided at ARRIVAL time with what a live
  server would know (the EMA estimate, not the eventually-measured time).

For a request whose deadline is unmeetable at its own bucket the controller
first tries to **degrade** it — cap ``k`` to a smaller bucket ceiling whose
(cheaper) service estimate fits the deadline; the caller gets fewer results,
flagged, never wrong ones — and only **sheds** when no ladder rung fits.
Shedding returns nothing for that request: absent, not incorrect.

``decide`` is a pure function of (request, now, queue depths, EMA state), so
a seeded trace with a fixed service model replays the exact same admission
decisions — the determinism tests in ``tests/test_torch_serving.py`` rely
on it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

from repro_torch.serving.batcher import ShapeBucket, bucket_of
from repro_torch.serving.queue import Request

ACCEPT = "accept"
DEGRADE = "degrade"
SHED = "shed"


class ServiceEMA:
    """Exponential moving average of measured batch service seconds,
    per shape bucket.  ``cold`` is the optimistic prior returned before the
    first observation of a bucket (optimistic on purpose: a cold server
    should try to serve, not shed — the EMA corrects within a few batches).
    """

    def __init__(self, decay: float = 0.6, cold: float = 0.02):
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        self.decay = float(decay)
        self.cold = float(cold)
        self._ema: dict[ShapeBucket, float] = {}

    def observe(self, bucket: ShapeBucket, seconds: float) -> None:
        prev = self._ema.get(bucket)
        self._ema[bucket] = (seconds if prev is None else
                             self.decay * prev + (1 - self.decay) * seconds)

    def estimate(self, bucket: ShapeBucket) -> float:
        return self._ema.get(bucket, self.cold)

    def observed(self, bucket: ShapeBucket) -> bool:
        return bucket in self._ema


@dataclass(frozen=True)
class Decision:
    """Admission verdict for one request."""

    action: str                      # ACCEPT | DEGRADE | SHED
    bucket: ShapeBucket | None       # bucket to run in (None when shed)
    k: int                           # effective k (== request k on accept)
    finish_est: float                # estimated completion time


@dataclass(frozen=True)
class DegradeLadder:
    """Capacity-pressure degradation rungs for the multi-replica tier.

    When healthy capacity drops below offered load (replicas crashed or
    stalled), the serving tier should slide DOWN the recall/latency frontier
    — lower recall target, narrower n_probe, smaller k — before it starts
    shedding: fewer/coarser results beat no results.  Each rung is
    ``(load_factor, k_cap, n_probe_cap, recall_target)``: at
    ``offered/capacity >= load_factor`` requests are capped to ``k_cap`` /
    ``n_probe_cap`` and their recall target lowered to ``recall_target``
    (None leaves that knob alone; legacy 3-tuple rungs without the recall
    entry are accepted and padded).  Rungs are evaluated in ascending
    ``load_factor`` order and the LAST matching rung wins, so deeper
    overload degrades harder.  ``caps`` is a pure function of its argument
    — seeded fault runs replay identically.

    ``from_frontier`` builds the rungs from a TUNED recall/cost frontier
    (``tuning.points.PointStore.frontier``) instead of hand-picked caps:
    each successively deeper overload rung serves the next cheaper tuned
    operating point, so degradation walks the measured recall/latency
    frontier rather than blunt k-capping.  The multi-replica tier
    (``serving.router.ReplicaServer``, ``serve --replicas``) applies it.
    """

    rungs: tuple = ()   # ((load_factor, k_cap, np_cap[, recall_target]), …)

    def __post_init__(self):
        norm = tuple((r[0],) + tuple(r[1:]) + (None,) * (4 - len(r))
                     for r in self.rungs)
        if any(len(r) != 4 for r in norm):
            raise ValueError(f"rungs must be 3- or 4-tuples: {self.rungs}")
        object.__setattr__(self, "rungs", norm)
        thresholds = [r[0] for r in norm]
        if thresholds != sorted(thresholds):
            raise ValueError(
                f"ladder rungs must be sorted by load factor: {self.rungs}")
        targets = [r[3] for r in norm if r[3] is not None]
        if targets != sorted(targets, reverse=True):
            raise ValueError(
                "rung recall targets must be non-increasing (deeper "
                f"overload must not promise MORE recall): {self.rungs}")

    @classmethod
    def from_frontier(cls, frontier,
                      load_factors=(1.0, 1.5, 2.5)) -> "DegradeLadder":
        """Ladder whose rungs are tuned operating points.

        ``frontier`` is a recall-descending sequence of operating points
        (anything with ``.knobs.n_probe`` and ``.recall_target``); the
        FIRST entry is the healthy serving point (no rung — it is what
        un-degraded traffic already gets) and each subsequent, cheaper
        point becomes one rung at the next ``load_factors`` threshold:
        the rung caps ``n_probe`` to the point's tuned routing width and
        lowers the request's recall target to the point's target.  ``k``
        is left alone — the tuned frontier trades recall for work at
        constant k, which is exactly the "degrade along the frontier, not
        blunt k-capping" contract.
        """
        rungs = []
        for lf, point in zip(load_factors, list(frontier)[1:]):
            rungs.append((float(lf), None, int(point.knobs.n_probe),
                          float(point.recall_target)))
        return cls(tuple(rungs))

    def caps(self, load_factor: float
             ) -> tuple[int | None, int | None, float | None]:
        k_cap = n_probe_cap = recall_target = None
        for threshold, kc, nc, rt in self.rungs:
            if load_factor >= threshold:
                k_cap, n_probe_cap, recall_target = kc, nc, rt
        return k_cap, n_probe_cap, recall_target

    def apply(self, req: Request, load_factor: float) -> Request:
        """Cap a request per the rung the current overload selects; the
        capped request is flagged (``k_requested`` / ``n_probe_requested``
        / ``recall_requested``) so its outcome reports ``degraded``."""
        k_cap, n_probe_cap, recall_target = self.caps(load_factor)
        if k_cap is not None:
            req = req.k_capped(k_cap)
        if n_probe_cap is not None:
            req = req.n_probe_capped(n_probe_cap)
        if recall_target is not None:
            req = req.recall_capped(recall_target)
        return req


class AdmissionController:
    """Shed-or-degrade admission over the bucket ladder."""

    def __init__(self, service: ServiceEMA, ceilings: Sequence[int],
                 batch: int, allow_degrade: bool = True,
                 slack_margin: float = 0.0):
        self.service = service
        self.ceilings = tuple(sorted(ceilings))
        self.batch = int(batch)
        self.allow_degrade = bool(allow_degrade)
        self.slack_margin = float(slack_margin)

    def _backlog(self, depths: Mapping[ShapeBucket, int]) -> float:
        """Estimated seconds to drain everything already queued: the
        executor serves one batch at a time, so the wait is the sum over
        buckets of (whole batches queued) x (that bucket's service EMA)."""
        return sum(-(-depth // b.batch) * self.service.estimate(b)
                   for b, depth in depths.items() if depth > 0)

    def decide(self, req: Request, now: float,
               depths: Mapping[ShapeBucket, int],
               in_flight: float = 0.0) -> Decision:
        """Admission verdict at time ``now``.  ``in_flight`` is the
        estimated remaining service time of the batch occupying the
        executor (0 when idle); it delays every queued batch, so it adds
        to the backlog wait.  Still a pure function of its arguments —
        seeded traces with a fixed service model replay identically."""
        wait = in_flight + self._backlog(depths)
        # own bucket first; then (k-cap) smaller ceilings, largest first,
        # so a degraded request keeps as much of its k as the deadline allows
        ladder = [c for c in self.ceilings if c >= req.k] or \
                 [self.ceilings[-1]]
        candidates = ladder[:1]
        if self.allow_degrade:
            candidates += [c for c in reversed(self.ceilings) if c < req.k]
        for i, ceil in enumerate(candidates):
            bucket = bucket_of(min(req.k, ceil), req.n_probe,
                               self.ceilings, self.batch)
            finish = now + wait + self.service.estimate(bucket)
            if finish <= req.deadline - self.slack_margin:
                action = ACCEPT if i == 0 and ceil >= req.k else DEGRADE
                return Decision(action=action, bucket=bucket,
                                k=min(req.k, ceil), finish_est=finish)
        return Decision(action=SHED, bucket=None, k=req.k,
                        finish_est=now + wait)
