"""Fault-tolerant multi-replica router: affinity routing, health-checked
dispatch, timeouts + capped-backoff retries, hedged sends, and graceful
degradation — as one deterministic discrete-event loop.

``ReplicaServer`` generalizes the single-engine ``server.Server`` event loop
to a :class:`~.replica.ReplicaPool`: every replica is its own
executor (one batch in flight at a time) with its own micro-batcher lanes,
and the router decides — from OBSERVABLE state only — where each admitted
request goes:

1. **affinity** — the replica whose decayed probed-centroid working set
   best overlaps the query's top coarse centroids (warm caches, warm
   per-bucket tau predictor), among replicas the health view calls healthy;
2. **least-loaded** — when no healthy replica has observed the query's
   centroids, the healthy replica with the fewest queued + in-flight
   requests (ties to the lowest replica id, so routing is deterministic);
3. **brownout** — when NO replica is healthy, the least-loaded replica
   that is merely *alive* (heartbeating but anomaly-flagged) serves the
   request and its outcome is marked ``degraded``: stale-but-alive beats
   unavailable.

Failure recovery is attempt-based.  Every dispatched attempt carries a
timeout (``deadline + timeout_mult x service_est``); an attempt that times
out, crashes with its replica, or fails response checksum verification is
marked dead, and when a request has no live attempts left it is re-routed
to a different replica after a capped exponential backoff — up to
``RetryPolicy.max_retries`` times, after which the request terminates
``FAILED`` (counted, never silently dropped).  Requests with enough slack
also schedule one **hedged** duplicate (``HedgePolicy``): if the primary
has not answered by ``deadline - slack_mult x est``, a second replica gets
the same request and the first response wins; the loser is withdrawn from
its lane when possible and ignored otherwise (counted as wasted work).

A supervisor monitor watches the health view: a replica that stops
heartbeating (crash, or a stall longer than the miss window) is respawned
after ``respawn_delay`` through ``ReplicaPool.respawn`` — fresh process,
checksummed predictor-state checkpoint restore, stranded lane requests
recovered by their attempts' timeouts.

Everything is driven by one ``heapq`` event queue keyed ``(t, seq)``; all
tie-breaks are explicit and all per-replica iteration is sorted, so a
seeded trace + seeded :class:`~.faults.FaultSchedule` + fixed
service model replays to byte-identical outcome summaries
(:func:`outcome_digest` is the replay contract's fingerprint).

The port of the JAX package's ``repro.serving.router``.  Everything the
router decides is computed on the host in numpy, as in the reference (the
routing centroids are a host copy, summed in float32 and ordered by a
stable argsort), so on the same trace, schedule, service model and result
ids the port's decisions and its ``outcome_digest`` equal the reference's
byte for byte.
"""
from __future__ import annotations

import hashlib
import heapq
import itertools
import json
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from repro_torch.serving import admission as adm
from repro_torch.serving import faults as flt
from repro_torch.serving import health as hlt
from repro_torch.serving import server as srv
from repro_torch.serving.batcher import Batch, ShapeBucket, assemble, bucket_of
from repro_torch.serving.queue import Request
from repro_torch.serving.replica import ReplicaPool, ReplicaResponse
from repro_torch.serving.state import ServingState


@dataclass(frozen=True)
class RetryPolicy:
    """Timeout + capped-exponential-backoff retry knobs.

    Two timeout regimes share the policy:

    * ``relative=False`` (the discrete-event tier's default) — an attempt
      times out at ``deadline + timeout_mult * est``: the micro-batcher may
      legitimately hold a request until just before its deadline, so only
      overshooting the deadline itself is evidence of failure.
    * ``relative=True`` (the socket front-end) — an attempt times out at
      ``now + timeout_mult * est``, TCP-RTO style: transport dispatch is
      immediate (no lane wait), so a response more than a few service times
      late means the frame was dropped or the worker is gone, and waiting
      for the deadline would let one lost frame eat the whole budget.

    ``clock`` is the optional injected monotonic clock for wall-clock
    callers that omit ``now`` (``compare=False``: two policies with the
    same knobs are the same policy regardless of who tells them the time).
    """

    max_retries: int = 2        # re-dispatches after the primary attempt
    timeout_mult: float = 4.0   # attempt times out at deadline + mult * est
    backoff_base: float = 0.01  # first retry delay (seconds)
    backoff_cap: float = 0.25   # exponential backoff ceiling (seconds)
    relative: bool = False      # time out relative to dispatch, not deadline
    clock: "object | None" = field(default=None, compare=False)

    def _now(self, now: float | None) -> float:
        if now is not None:
            return now
        if self.clock is None:
            raise ValueError(
                "RetryPolicy needs an explicit `now` unless a clock was "
                "injected at construction")
        return self.clock.now()

    def timeout_at(self, now: float | None, deadline: float,
                   est: float) -> float:
        now = self._now(now)
        base = now if self.relative else max(now, deadline)
        return base + self.timeout_mult * max(est, 1e-6)

    def backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based), capped exponential."""
        return min(self.backoff_base * (2.0 ** (attempt - 1)),
                   self.backoff_cap)


@dataclass(frozen=True)
class HedgePolicy:
    """Hedged-send knobs: a duplicate fires when remaining slack falls to
    ``slack_mult`` estimated service times and the primary is still out."""

    enabled: bool = True
    slack_mult: float = 2.0


@dataclass(frozen=True)
class RouteDecision:
    """Where one attempt goes and why (``reason`` feeds the assignment log
    the determinism property-tests replay)."""

    replica: int
    brownout: bool
    reason: str                 # "affinity" | "least-loaded" | "brownout"


class Router:
    """Centroid-affinity routing over the health view's candidate sets."""

    def __init__(self, pool: ReplicaPool, health: hlt.HealthView,
                 centroids: np.ndarray, *, top_c: int = 4):
        self.pool = pool
        self.health = health
        self.centroids = np.asarray(centroids, np.float32)
        self.top_c = int(min(top_c, len(self.centroids)))

    def top_centroids(self, q: np.ndarray) -> np.ndarray:
        """The query's ``top_c`` nearest coarse centroids — the working-set
        overlap key (argsort, not argpartition: stable ties by centroid id
        keep routing deterministic)."""
        d = ((self.centroids - np.asarray(q, np.float32)[None]) ** 2).sum(1)
        return np.argsort(d, kind="stable")[: self.top_c]

    def _least_loaded(self, cands: Sequence[int]) -> int:
        return min(cands, key=lambda r: (self.pool[r].load(), r))

    def route(self, req: Request, now: float,
              exclude: frozenset[int] = frozenset()) -> RouteDecision | None:
        """Pick a replica for one attempt; None when nothing is alive.

        ``exclude`` holds replicas this request already failed on (and any
        it currently has a live attempt on — a hedge must diversify).  When
        exclusion empties the alive set the last resort is a brownout on
        ANY alive replica: a possibly-repeat replica beats a guaranteed
        FAILED."""
        healthy = [r for r in self.health.healthy(now) if r not in exclude]
        if healthy:
            top = self.top_centroids(req.q)
            scores = [(self.pool[r].affinity(top, now), r) for r in healthy]
            best, rid = max(scores, key=lambda sr: (sr[0], -sr[1]))
            if best > 0.0:
                return RouteDecision(rid, brownout=False, reason="affinity")
            return RouteDecision(self._least_loaded(healthy), brownout=False,
                                 reason="least-loaded")
        alive = [r for r in self.health.alive(now) if r not in exclude]
        if not alive:
            alive = self.health.alive(now)     # last resort: relax exclude
        if not alive:
            return None
        return RouteDecision(self._least_loaded(alive), brownout=True,
                             reason="brownout")


def outcome_digest(outcomes: Sequence[srv.Outcome]) -> str:
    """Replay fingerprint: sha256 over every outcome's terminal facts, in
    rid order.  Two runs of the same seeded trace + fault schedule + service
    model must produce equal digests (the byte-identical replay gate), and
    the reference's function gives the same digest on the same outcomes."""
    rows = [[o.request.rid, o.status, o.replica, o.retries, bool(o.hedged),
             round(o.t_done, 9), o.k_effective,
             None if o.ids is None else [int(i) for i in o.ids]]
            for o in sorted(outcomes, key=lambda o: o.request.rid)]
    return hashlib.sha256(
        json.dumps(rows, sort_keys=True).encode()).hexdigest()


# -- per-request attempt bookkeeping ----------------------------------------


@dataclass
class _Attempt:
    aid: int
    replica: int
    brownout: bool
    bucket: ShapeBucket
    kind: str                   # "primary" | "retry" | "hedge"
    dead: bool = False          # timed out / crashed / corrupt-rejected


@dataclass
class _Track:
    req: Request                # post-admission (possibly capped) request
    attempts: dict[int, _Attempt] = field(default_factory=dict)
    retries_used: int = 0
    hedged: bool = False
    hedge_scheduled: bool = False
    done: bool = False

    def live(self) -> list[_Attempt]:
        return [a for a in self.attempts.values() if not a.dead]

    def exclude(self) -> frozenset[int]:
        return frozenset(a.replica for a in self.attempts.values())

    def attempt_on(self, rid: int) -> _Attempt | None:
        """Latest attempt dispatched to ``rid`` (dead ones included —
        first-response-wins accepts a completion from a timed-out attempt)."""
        mine = [a for a in self.attempts.values() if a.replica == rid]
        return max(mine, key=lambda a: a.aid) if mine else None


class ReplicaServer:
    """The fault-tolerant serving tier's composition root."""

    def __init__(self, state: ServingState, n_replicas: int,
                 ceilings: Sequence[int], batch: int, *,
                 retry: RetryPolicy = RetryPolicy(),
                 hedge: HedgePolicy = HedgePolicy(),
                 ladder: adm.DegradeLadder | None = None,
                 faults: flt.FaultSchedule | None = None,
                 service_time_fn: Callable[[ShapeBucket], float]
                 | None = None,
                 slack_margin: float = 0.0, max_wait: float | None = None,
                 service_decay: float = 0.6, service_cold: float = 0.02,
                 hb_interval: float = 0.05, miss_factor: float = 3.0,
                 anomaly_factor: float = 3.0, respawn_delay: float = 0.1,
                 ws_decay: float = 2.0, top_c: int = 4,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 4):
        self.state = state
        self.retry = retry
        self.hedge = hedge
        self.ladder = ladder or adm.DegradeLadder()
        self.faults = faults or flt.FaultSchedule()
        self.service_time_fn = service_time_fn
        self.respawn_delay = float(respawn_delay)
        self.service = adm.ServiceEMA(decay=service_decay,
                                      cold=service_cold)
        self.pool = ReplicaPool(state, n_replicas, ceilings, batch,
                                service_est=self.service.estimate,
                                slack_margin=slack_margin,
                                max_wait=max_wait, ws_decay=ws_decay,
                                checkpoint_dir=checkpoint_dir,
                                checkpoint_every=checkpoint_every)
        self.health = hlt.HealthView(n_replicas, hb_interval=hb_interval,
                                     miss_factor=miss_factor,
                                     anomaly_factor=anomaly_factor)
        self.router = Router(self.pool, self.health, state.centroids,
                             top_c=top_c)
        self.admission = adm.AdmissionController(
            self.service, self.pool[0].batcher.ceilings, batch,
            allow_degrade=True, slack_margin=slack_margin)
        self.batch = int(batch)
        # fresh per run_trace
        self._events: list = []
        self._seq = itertools.count()
        self._aid = itertools.count()
        self._tracks: dict[int, _Track] = {}
        self._outcomes: dict[int, srv.Outcome] = {}
        self._epoch = [0] * n_replicas
        self._fire_at = [np.inf] * n_replicas
        self._respawn_pending: set[int] = set()
        self.assignments: list[tuple] = []     # (rid, aid, replica, kind)
        self.stats = {k: 0 for k in (
            "dispatched", "retries_sent", "hedges_sent", "hedges_won",
            "hedges_wasted", "timeouts", "corrupt_detected", "withdrawn",
            "respawns", "stranded_cleared", "late_ignored", "brownouts")}

    # -- event plumbing -----------------------------------------------------

    def _push(self, t: float, kind: str, data=None) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, data))

    def _schedule_fire(self, rid: int, now: float) -> None:
        """(Re)arm the fire event for one replica's batcher: immediately if
        any lane is full, else at the earliest slack-expiry instant.  The
        ``_fire_at`` latch keeps duplicate submits from stacking duplicate
        event chains."""
        b = self.pool[rid].batcher
        full = any(d >= bucket.batch for bucket, d in b.depths().items())
        due = now if full else b.next_fire_time(now)
        if due is not None and due < self._fire_at[rid]:
            self._fire_at[rid] = due
            self._push(due, "fire", rid)

    # -- warmup -------------------------------------------------------------

    def _trace_buckets(self, trace: Sequence[Request]) -> list[ShapeBucket]:
        """Every shape bucket the trace can hit: its own (k, n_probe)
        grid plus the degrade ladder's capped variants (a rung engaging
        mid-run must not trigger a cold engine build on the timeline)."""
        ceilings = self.pool[0].batcher.ceilings
        caps = [(None, None)] + [(kc, nc)
                                 for _, kc, nc, _rt in self.ladder.rungs]
        buckets = set()
        for r in trace:
            for k_cap, np_cap in caps:
                k = min(r.k, k_cap) if k_cap else r.k
                n_probe = min(r.n_probe, np_cap) if np_cap else r.n_probe
                buckets.add(bucket_of(min(k, ceilings[-1]), n_probe,
                                      ceilings, self.batch))
        return sorted(buckets)

    def warmup(self, trace: Sequence[Request]) -> "ReplicaServer":
        """Off-timeline engine builds and kernel warm-up + service-EMA
        seeding for every bucket the trace (and the degrade ladder) can
        reach.  Engine builds land in
        the pool-shared cache, so one warmup covers every replica."""
        buckets = self._trace_buckets(trace)
        self.state.warmup(buckets)
        by_bucket = {}
        ceilings = self.pool[0].batcher.ceilings
        for r in trace:
            by_bucket.setdefault(
                bucket_of(min(r.k, ceilings[-1]), r.n_probe, ceilings,
                          self.batch), []).append(r)
        for bucket in buckets:
            if self.service_time_fn is not None:
                self.service.observe(bucket, self.service_time_fn(bucket))
                continue
            reqs = by_bucket.get(bucket)
            if not reqs:       # ladder-only variant: seed from the model
                continue       # bucket of an actual request measures below
            t_done, _ = self.pool[0].serve(
                assemble(bucket, reqs[: self.batch]), 0.0)
            self.service.observe(bucket, t_done)
        return self

    # -- admission + dispatch -----------------------------------------------

    def _load_factor(self, now: float) -> float:
        alive = self.health.alive(now)
        if not alive:
            return np.inf
        queued = sum(self.pool[r].load() for r in alive)
        return queued / (len(alive) * self.batch)

    def _wait_estimate(self, now: float) -> float:
        """What a new request would wait before service starts: the best
        (minimum) over alive replicas of in-flight remainder + lane
        backlog, at EMA estimates — observable state only."""
        alive = self.health.alive(now)
        if not alive:
            return np.inf
        waits = []
        for r in alive:
            rep = self.pool[r]
            w = max(0.0, rep.busy_until_est - now)
            w += sum(self.service.estimate(b.bucket) for b in rep.fired)
            w += sum(-(-d // b.batch) * self.service.estimate(b)
                     for b, d in rep.batcher.depths().items())
            waits.append(w)
        return min(waits)

    def _admit(self, req: Request, now: float) -> None:
        """Arrival: degrade ladder -> admission -> first dispatch."""
        req = self.ladder.apply(req, self._load_factor(now))
        dec = self.admission.decide(req, now, {},
                                    in_flight=self._wait_estimate(now))
        if dec.action == adm.SHED:
            self._terminal(req, srv.SHED, now)
            return
        req = req.k_capped(dec.k)
        track = _Track(req=req)
        self._tracks[req.rid] = track
        if not self._dispatch(track, now, kind="primary"):
            self._retry_or_fail(track, now)

    def _dispatch(self, track: _Track, now: float, kind: str) -> bool:
        req = track.req
        exclude = track.exclude() if kind != "primary" else frozenset()
        decision = self.router.route(req, now, exclude)
        if decision is None:
            return False
        rid = decision.replica
        bucket = self.pool[rid].batcher.submit(req)
        aid = next(self._aid)
        track.attempts[aid] = _Attempt(aid=aid, replica=rid,
                                       brownout=decision.brownout,
                                       bucket=bucket, kind=kind)
        self.assignments.append((req.rid, aid, rid, kind, decision.reason))
        self.stats["dispatched"] += 1
        if decision.brownout:
            self.stats["brownouts"] += 1
        est = self.service.estimate(bucket)
        self._push(self.retry.timeout_at(now, req.deadline, est),
                   "timeout", (req.rid, aid))
        if kind == "primary" and self.hedge.enabled and \
                not track.hedge_scheduled:
            t_h = req.deadline - self.hedge.slack_mult * est
            if t_h > now:
                track.hedge_scheduled = True
                self._push(t_h, "hedge", req.rid)
        self._schedule_fire(rid, now)
        return True

    def _retry_or_fail(self, track: _Track, now: float) -> None:
        """No live attempts left: back off and re-route, or terminate."""
        if track.done:
            return
        if track.retries_used >= self.retry.max_retries:
            self._terminal(track.req, srv.FAILED, now, track=track)
            return
        track.retries_used += 1
        self._push(now + self.retry.backoff(track.retries_used),
                   "retry", track.req.rid)

    def _terminal(self, req: Request, status: str, now: float,
                  track: _Track | None = None) -> None:
        if track is not None:
            track.done = True
        self._outcomes[req.rid] = srv.Outcome(
            request=req, status=status, bucket=None, ids=None, dists=None,
            t_done=now, k_effective=0,
            retries=track.retries_used if track else 0,
            hedged=track.hedged if track else False)

    # -- executor -----------------------------------------------------------

    def _start_next(self, rid: int, now: float) -> None:
        rep = self.pool[rid]
        if rep.in_flight is not None or not rep.fired:
            return
        batch = rep.fired.popleft()
        rep.in_flight = batch
        est = self.service.estimate(batch.bucket)
        rep.busy_until_est = now + est
        t_done, resp = rep.serve(batch, now, self.faults,
                                 self.service_time_fn)
        if t_done is None:
            return     # crash mid-service: the batch never completes
        self._push(t_done, "done",
                   (rid, self._epoch[rid], batch, resp, now, est))

    def _on_done(self, rid: int, epoch: int, batch: Batch,
                 resp: ReplicaResponse, t_start: float, est: float,
                 now: float) -> None:
        if epoch != self._epoch[rid]:
            return     # completion from a pre-respawn process: discard
        rep = self.pool[rid]
        rep.in_flight = None
        dt = now - t_start
        self.health.beat(rid, now)                    # progress == liveness
        self.health.observe(rid, dt, baseline=est)    # anomaly ratio
        self.service.observe(batch.bucket, dt)
        ok = resp.verified()
        if not ok:
            self.stats["corrupt_detected"] += 1
        for j, req in enumerate(batch.requests):
            track = self._tracks.get(req.rid)
            if track is None or track.done:
                self.stats["late_ignored"] += 1
                continue
            att = track.attempt_on(rid)
            if not ok:
                if att is not None and not att.dead:
                    att.dead = True
                if not track.live():
                    self._retry_or_fail(track, now)
                continue
            self._accept(track, att, rid, batch, resp, j, now)
        for q_top in [self.router.top_centroids(r.q)
                      for r in batch.requests]:
            rep.note_probed(q_top, now)
        self.pool.maybe_checkpoint(rid)
        self._schedule_fire(rid, now)
        self._start_next(rid, now)

    def _accept(self, track: _Track, att: _Attempt | None, rid: int,
                batch: Batch, resp: ReplicaResponse, j: int,
                now: float) -> None:
        """First response wins: emit the outcome, withdraw or write off
        every other attempt."""
        track.done = True
        req = track.req
        d_j, i_j = srv.trim_topk(resp.dists[j], resp.ids[j], req.k)
        brownout = bool(att.brownout) if att is not None else False
        status = srv.DEGRADED if (req.degraded or brownout) else srv.OK
        won_hedge = att is not None and att.kind == "hedge"
        if won_hedge:
            self.stats["hedges_won"] += 1
        self._outcomes[req.rid] = srv.Outcome(
            request=req, status=status, bucket=batch.bucket,
            ids=i_j.copy(), dists=d_j.copy(), t_done=now,
            k_effective=req.k, replica=rid,
            retries=track.retries_used, hedged=track.hedged)
        for other in track.live():
            if other is att:
                continue
            if self.pool[other.replica].batcher.withdraw(req.rid) \
                    is not None:
                self.stats["withdrawn"] += 1
            other.dead = True
            if other.kind == "hedge" or won_hedge:
                self.stats["hedges_wasted"] += 1

    # -- failure-path handlers ----------------------------------------------

    def _on_timeout(self, rid_req: int, aid: int, now: float) -> None:
        track = self._tracks.get(rid_req)
        if track is None or track.done:
            return
        att = track.attempts.get(aid)
        if att is None or att.dead:
            return
        att.dead = True
        self.stats["timeouts"] += 1
        if self.pool[att.replica].batcher.withdraw(rid_req) is not None:
            self.stats["withdrawn"] += 1
        if not track.live():
            self._retry_or_fail(track, now)

    def _on_retry(self, rid_req: int, now: float) -> None:
        track = self._tracks.get(rid_req)
        if track is None or track.done:
            return
        self.stats["retries_sent"] += 1
        if not self._dispatch(track, now, kind="retry"):
            self._retry_or_fail(track, now)

    def _on_hedge(self, rid_req: int, now: float) -> None:
        track = self._tracks.get(rid_req)
        if track is None or track.done or len(track.live()) != 1:
            return     # already answered, or already on the retry path
        if self._dispatch(track, now, kind="hedge"):
            track.hedged = True
            self.stats["hedges_sent"] += 1

    # -- supervisor ---------------------------------------------------------

    def _on_heartbeat(self, rid: int, now: float) -> None:
        since = self.pool[rid].respawned_at
        if self.faults.crashed(rid, now, since=since):
            return     # dead process: beats stop until the respawn
        if not self.faults.stalled(rid, now, since=since):
            self.health.beat(rid, now)
        self._push(now + self.health.hb_interval, "hb", rid)

    def _on_monitor(self, now: float) -> None:
        """Supervisor sweep: respawn replicas the health view declares DOWN
        (crashed, or hung past the heartbeat-miss window)."""
        for rid in range(len(self.pool)):
            if rid in self._respawn_pending:
                continue
            if self.health.status(rid, now) == hlt.DOWN:
                self._respawn_pending.add(rid)
                self._push(now + self.respawn_delay, "respawn", rid)
        self._push(now + self.health.hb_interval * self.health.miss_factor,
                   "monitor", None)

    def _on_respawn(self, rid: int, now: float) -> None:
        self._respawn_pending.discard(rid)
        self.stats["respawns"] += 1
        stranded = self.pool[rid].batcher.pending()
        self.stats["stranded_cleared"] += stranded
        self.pool.respawn(rid, now)
        self._epoch[rid] += 1
        self._fire_at[rid] = np.inf
        self.health.reset(rid, now)
        self._push(now + self.health.hb_interval, "hb", rid)

    # -- the loop -----------------------------------------------------------

    def run_trace(self, trace: Sequence[Request],
                  warmup: bool = True) -> list[srv.Outcome]:
        """Serve a whole seeded trace through the pool; returns outcomes in
        rid order, one per offered request (conservation by construction:
        every request terminates OK, DEGRADED, SHED, or FAILED)."""
        trace = sorted(trace, key=lambda r: (r.arrival, r.rid))
        if warmup and trace:
            self.warmup(trace)
        self._events = []
        self._seq = itertools.count()
        self._aid = itertools.count()
        self._tracks = {}
        self._outcomes = {}
        self._epoch = [0] * len(self.pool)
        self._fire_at = [np.inf] * len(self.pool)
        self._respawn_pending = set()
        self.assignments = []
        t0 = trace[0].arrival if trace else 0.0
        self.health.start(t0)
        for rep in self.pool:
            rep.reset(rep.state, t0)
            rep.respawned_at = -np.inf
        for req in trace:
            self._push(req.arrival, "arrive", req)
        for rid in range(len(self.pool)):
            self._push(t0 + self.health.hb_interval, "hb", rid)
        self._push(t0 + self.health.hb_interval * self.health.miss_factor,
                   "monitor", None)

        while self._events and len(self._outcomes) < len(trace):
            t, _, kind, data = heapq.heappop(self._events)
            if kind == "arrive":
                self._admit(data, t)
            elif kind == "fire":
                rid = data
                self._fire_at[rid] = np.inf
                if self.faults.crashed(rid, t,
                                       since=self.pool[rid].respawned_at):
                    continue     # dead process: lanes strand until respawn
                self.pool[rid].fired.extend(
                    self.pool[rid].batcher.fire_ready(t))
                self._schedule_fire(rid, t)
                self._start_next(rid, t)
            elif kind == "done":
                rid, epoch, batch, resp, t_start, est = data
                self._on_done(rid, epoch, batch, resp, t_start, est, t)
            elif kind == "timeout":
                self._on_timeout(data[0], data[1], t)
            elif kind == "retry":
                self._on_retry(data, t)
            elif kind == "hedge":
                self._on_hedge(data, t)
            elif kind == "hb":
                self._on_heartbeat(data, t)
            elif kind == "monitor":
                self._on_monitor(t)
            elif kind == "respawn":
                self._on_respawn(data, t)

        # safety net: anything still untracked terminates FAILED (the event
        # queue draining early would otherwise drop requests silently and
        # break the conservation gate)
        t_end = max((o.t_done for o in self._outcomes.values()), default=t0)
        for req in trace:
            if req.rid not in self._outcomes:
                self._terminal(req, srv.FAILED, t_end,
                               track=self._tracks.get(req.rid))
        return [self._outcomes[r.rid]
                for r in sorted(trace, key=lambda r: r.rid)]
