"""The master's brain: a pure, event-driven state machine.

``MasterCore`` is the transport tier's policy engine — admission with
bounded queues and 429-style backpressure, the replica tier's ``Router`` /
``HealthView`` / ``DegradeLadder``, per-attempt timeouts with
capped-backoff retries, the exact-key result/routing caches — written so
that *everything it decides is a function of the events it is handed*:

* every event carries its timestamp ``t``; the core NEVER reads a clock;
* timers are requested as actions (``("timer", t_at, event)``) and come
  back as ordinary events when the driver fires them;
* randomness does not exist here (wire-fault decisions happen in the
  driver's shim and are themselves seeded).

That purity is the record/replay contract's foundation: the live socket
driver records the exact event sequence it processed (timestamps, frame
facts, fault decisions), and the replay driver feeds the same sequence
into a fresh core — same events in, same outcomes out, byte-identical
``outcome_digest``.  The wall-clock drivers own wall-clock concerns
(sockets, subprocesses, partial reads); the core owns meaning.

Worker-facing protocol: workers execute singleton (B=1) requests at their
shape-bucket ceiling and return payloads trimmed to the request's ``k``
with an integrity checksum.  The master verifies the checksum (a corrupt
or truncated-but-parseable payload surfaces here) and emits
``serving.server.Outcome`` rows compatible with every existing summary /
parity / digest tool.

The port's copy of the JAX package's ``transport/core.py`` over
``repro_torch.serving``: the same events give the same actions, outcomes,
stats and ``outcome_digest`` as the reference's core.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serving import admission as adm
from repro_torch.serving import faults as flt
from repro_torch.serving import health as hlt
from repro_torch.serving import server as srv
from repro_torch.serving.batcher import ShapeBucket, bucket_of
from repro_torch.serving.queue import Request
from repro_torch.serving.replica import WorkingSet
from repro_torch.serving.router import RetryPolicy, Router
from repro_torch.transport import frames
from repro_torch.transport.cache import ResultCache, RouteMemo


@dataclass
class WorkerView:
    """What the master knows about one worker — observable facts only."""

    wid: int
    ws: WorkingSet
    connected: bool = False
    epoch: int = 0                       # bumps on every (re)connect
    inflight: dict[int, int] = field(default_factory=dict)  # aid -> rid

    # Router duck-typing (it scores pool entries by load + affinity)
    def load(self) -> int:
        return len(self.inflight)

    def affinity(self, cluster_ids: np.ndarray, now: float) -> float:
        return self.ws.score(cluster_ids, now)


@dataclass
class _Attempt:
    aid: int
    wid: int
    kind: str                   # "primary" | "retry" | "queued"
    brownout: bool
    sent_at: float
    dead: bool = False


@dataclass
class _Track:
    req: Request
    conn: int                   # client connection the reply goes to
    crid: int                   # client-side request id (echoed in replies)
    attempts: dict[int, _Attempt] = field(default_factory=dict)
    retries_used: int = 0
    queued: bool = False        # sitting in the bounded pending queue
    done: bool = False

    def live(self) -> list[_Attempt]:
        return [a for a in self.attempts.values() if not a.dead]

    def exclude(self) -> frozenset[int]:
        return frozenset(a.wid for a in self.attempts.values())

    def attempt_on(self, wid: int) -> _Attempt | None:
        mine = [a for a in self.attempts.values() if a.wid == wid]
        return max(mine, key=lambda a: a.aid) if mine else None


@dataclass(frozen=True)
class MasterConfig:
    """Everything the master's policy depends on (drivers add mechanism
    knobs — socket paths, reconnect backoff — on top)."""

    n_workers: int
    ceilings: tuple[int, ...]
    lane_depth: int = 4             # in-flight requests per worker (bound)
    max_pending: int = 64           # master-side wait queue (bound)
    hb_interval: float = 0.05
    miss_factor: float = 4.0
    anomaly_factor: float = 3.0
    top_c: int = 4
    ws_decay: float = 2.0
    cache_size: int = 0             # 0 = result cache off
    route_memo_size: int = 1024
    service_decay: float = 0.6
    service_cold: float = 0.02
    retry_after_s: float = 0.05     # suggested client backoff on REJECTED
    retry: RetryPolicy = RetryPolicy(relative=True, timeout_mult=6.0,
                                     max_retries=2, backoff_base=0.005,
                                     backoff_cap=0.1)
    ladder: adm.DegradeLadder | None = None

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"need >= 1 worker, got {self.n_workers}")
        if self.lane_depth < 1 or self.max_pending < 0:
            raise ValueError("lane_depth must be >= 1, max_pending >= 0")
        if not self.retry.relative:
            raise ValueError(
                "transport retries must use attempt-relative timeouts "
                "(RetryPolicy(relative=True)): dispatch is immediate, so "
                "deadline-anchored timeouts would let one dropped frame "
                "stall a request for its whole budget")


class MasterCore:
    """Event-driven master state machine (see module docstring)."""

    def __init__(self, cfg: MasterConfig, centroids: np.ndarray):
        self.cfg = cfg
        self.workers = [WorkerView(w, WorkingSet(decay=cfg.ws_decay))
                        for w in range(cfg.n_workers)]
        self.health = hlt.HealthView(
            cfg.n_workers, hb_interval=cfg.hb_interval,
            miss_factor=cfg.miss_factor, anomaly_factor=cfg.anomaly_factor)
        self.router = Router(self.workers, self.health, centroids,
                             top_c=cfg.top_c)
        self.service = adm.ServiceEMA(decay=cfg.service_decay,
                                      cold=cfg.service_cold)
        self.ladder = cfg.ladder or adm.DegradeLadder()
        self.results = ResultCache(cfg.cache_size) if cfg.cache_size else None
        self.route_memo = RouteMemo(cfg.route_memo_size)
        self.draining = False
        self.outcomes: dict[int, srv.Outcome] = {}
        self.assignments: list[tuple] = []   # (rid, aid, wid, kind, reason)
        self._tracks: dict[int, _Track] = {}
        self._pending: deque[int] = deque()  # rids waiting for a free slot
        self._rid = itertools.count()
        self._aid = itertools.count()
        self.stats = {k: 0 for k in (
            "offered", "dispatched", "retries_sent", "timeouts",
            "rejected_backpressure", "rejected_draining", "shed_expired",
            "cache_hits", "corrupt_detected", "late_ignored", "malformed",
            "worker_errors", "worker_lost", "respawns", "brownouts",
            "queued")}

    # -- helpers -------------------------------------------------------------

    def _bucket(self, req: Request) -> ShapeBucket:
        return bucket_of(req.k, req.n_probe, self.cfg.ceilings, 1)

    def start(self, t0: float) -> None:
        self.health.start(t0)

    def idle(self) -> bool:
        """No request is open — the drain-complete condition."""
        return not self._pending and \
            all(tr.done for tr in self._tracks.values())

    def open_requests(self) -> int:
        return sum(not tr.done for tr in self._tracks.values())

    def _available(self, wid: int, t: float) -> bool:
        w = self.workers[wid]
        return w.connected and len(w.inflight) < self.cfg.lane_depth and \
            self.health.status(wid, t) != hlt.DOWN

    def _load_factor(self, t: float) -> float:
        up = [w for w in self.workers if w.connected]
        if not up:
            return np.inf
        inflight = sum(len(w.inflight) for w in up)
        return (inflight + len(self._pending)) / \
            (len(up) * self.cfg.lane_depth)

    # -- event entry point ----------------------------------------------------

    def handle(self, ev: dict) -> list[tuple]:
        """Process one timestamped event; returns the driver's to-do list:
        ``("send", wid, frame)`` / ``("reply", conn, frame)`` /
        ``("timer", t_at, event)``.  Frames carry ndarrays; the driver
        packs them for the wire (the sim/replay drivers never do)."""
        kind = ev["ev"]
        t = ev["t"]
        if kind == "req":
            return self._on_req(ev, t)
        if kind == "resp":
            return self._on_resp(ev, t)
        if kind == "werr":
            return self._on_werr(ev, t)
        if kind == "hb":
            wid = ev["wid"]
            if self.workers[wid].connected:
                self.health.beat(wid, t)
            return []
        if kind == "timeout":
            return self._on_timeout(ev["rid"], ev["aid"], t)
        if kind == "retry":
            return self._on_retry(ev["rid"], t)
        if kind == "expire":
            return self._on_expire(ev["rid"], t)
        if kind == "lost":
            return self._on_lost(ev["wid"], t)
        if kind == "up":
            return self._on_up(ev, t)
        if kind == "drain":
            self.draining = True
            return []
        raise ValueError(f"unknown event kind {kind!r}")

    # -- request intake -------------------------------------------------------

    def _reject(self, req: Request, track_conn: int, crid: int, t: float,
                reason: str) -> list[tuple]:
        self.stats[f"rejected_{reason}"] += 1
        self.outcomes[req.rid] = srv.Outcome(
            request=req, status=srv.REJECTED, bucket=None, ids=None,
            dists=None, t_done=t, k_effective=0)
        return [("reply", track_conn,
                 {"kind": frames.RETRY_AFTER, "rid": crid,
                  "delay_s": self.cfg.retry_after_s, "reason": reason})]

    def _on_req(self, ev: dict, t: float) -> list[tuple]:
        conn, crid = ev["conn"], ev["crid"]
        try:
            rid = next(self._rid)
            req = Request(rid=rid, q=np.asarray(ev["q"]), k=int(ev["k"]),
                          n_probe=int(ev["n_probe"]), arrival=t,
                          deadline=t + float(ev["deadline_s"]))
        except (ValueError, TypeError, KeyError) as e:
            self.stats["malformed"] += 1
            return [("reply", conn,
                     {"kind": frames.ERR, "rid": crid,
                      "code": "bad_request", "detail": str(e)})]
        self.stats["offered"] += 1
        if self.draining:
            return self._reject(req, conn, crid, t, "draining")
        req = req.k_capped(self.cfg.ceilings[-1])
        req = self.ladder.apply(req, self._load_factor(t))
        track = _Track(req=req, conn=conn, crid=crid)
        self._tracks[rid] = track
        if self.results is not None:
            hit = self.results.get(req.q, req.k, req.n_probe)
            if hit is not None:
                self.stats["cache_hits"] += 1
                track.done = True
                dists, ids = hit
                return self._complete(track, dists, ids, wid=None, t=t,
                                      cached=True)
        acts = self._dispatch(track, t, kind="primary")
        if acts is None:
            return self._enqueue(track, t)
        return acts

    def _enqueue(self, track: _Track, t: float) -> list[tuple]:
        """No worker has a free slot: bounded wait queue or 429."""
        if len(self._pending) >= self.cfg.max_pending:
            reason = "backpressure"
            track.done = True
            return self._reject(track.req, track.conn, track.crid, t, reason)
        self._pending.append(track.req.rid)
        track.queued = True
        self.stats["queued"] += 1
        # the queue's only exit guarantees: a slot frees (dispatch below)
        # or the deadline passes (this timer -> SHED)
        return [("timer", track.req.deadline,
                 {"ev": "expire", "rid": track.req.rid})]

    # -- dispatch -------------------------------------------------------------

    def _dispatch(self, track: _Track, t: float,
                  kind: str) -> list[tuple] | None:
        """Route + send one attempt; None when no available worker (caller
        queues or fails)."""
        req = track.req
        tried = set(track.exclude()) if kind != "primary" else set()
        chosen, reason, brownout = None, "", False
        hint = self.route_memo.get(req.q) if kind == "primary" else None
        if hint is not None and hint not in tried and \
                self._available(hint, t):
            chosen, reason = hint, "cache-route"
        while chosen is None:
            decision = self.router.route(req, t, frozenset(tried))
            if decision is None:
                return None
            if self._available(decision.replica, t):
                chosen = decision.replica
                reason, brownout = decision.reason, decision.brownout
                break
            if decision.replica in tried:
                return None     # route's relax-exclude fallback repeated
            tried.add(decision.replica)
            if len(tried) >= self.cfg.n_workers:
                return None
        aid = next(self._aid)
        track.attempts[aid] = _Attempt(aid=aid, wid=chosen, kind=kind,
                                       brownout=brownout, sent_at=t)
        self.workers[chosen].inflight[aid] = req.rid
        self.assignments.append((req.rid, aid, chosen, kind, reason))
        self.stats["dispatched"] += 1
        if brownout:
            self.stats["brownouts"] += 1
        est = self.service.estimate(self._bucket(req))
        return [
            ("send", chosen, {"kind": frames.REQ, "rid": req.rid,
                              "q": req.q, "k": req.k,
                              "n_probe": req.n_probe}),
            ("timer", self.cfg.retry.timeout_at(t, req.deadline, est),
             {"ev": "timeout", "rid": req.rid, "aid": aid}),
        ]

    def _drain_pending(self, t: float) -> list[tuple]:
        """A slot freed (response, reconnect): dispatch waiting requests."""
        acts: list[tuple] = []
        while self._pending:
            rid = self._pending[0]
            track = self._tracks.get(rid)
            if track is None or track.done:
                self._pending.popleft()
                continue
            sub = self._dispatch(track, t, kind="queued")
            if sub is None:
                break
            self._pending.popleft()
            track.queued = False
            acts.extend(sub)
        return acts

    # -- completion paths -----------------------------------------------------

    def _complete(self, track: _Track, dists: np.ndarray, ids: np.ndarray,
                  wid: int | None, t: float,
                  cached: bool = False) -> list[tuple]:
        req = track.req
        att = track.attempt_on(wid) if wid is not None else None
        brownout = bool(att.brownout) if att is not None else False
        status = srv.DEGRADED if (req.degraded or brownout) else srv.OK
        self.outcomes[req.rid] = srv.Outcome(
            request=req, status=status, bucket=self._bucket(req),
            ids=np.asarray(ids).copy(), dists=np.asarray(dists).copy(),
            t_done=t, k_effective=req.k, replica=wid,
            retries=track.retries_used)
        for other in track.live():      # late twins are ignored, not retried
            other.dead = True
        return [("reply", track.conn,
                 {"kind": frames.RESP, "rid": track.crid, "status": status,
                  "k": req.k, "dists": np.asarray(dists),
                  "ids": np.asarray(ids), "cached": cached})]

    def _terminal(self, track: _Track, status: str, t: float,
                  code: str) -> list[tuple]:
        track.done = True
        req = track.req
        self.outcomes[req.rid] = srv.Outcome(
            request=req, status=status, bucket=None, ids=None, dists=None,
            t_done=t, k_effective=0, retries=track.retries_used)
        return [("reply", track.conn,
                 {"kind": frames.ERR, "rid": track.crid, "code": code,
                  "detail": f"request {req.rid} terminated {status}"})]

    def _on_resp(self, ev: dict, t: float) -> list[tuple]:
        wid, rid = ev["wid"], ev["rid"]
        w = self.workers[wid]
        self.health.beat(wid, t)
        track = self._tracks.get(rid)
        att = track.attempt_on(wid) if track is not None else None
        if att is not None:
            w.inflight.pop(att.aid, None)
        else:                           # duplicate delivery / pre-lost aid
            for aid, r in list(w.inflight.items()):
                if r == rid:
                    del w.inflight[aid]
                    break
        acts: list[tuple] = []
        if track is None or track.done:
            self.stats["late_ignored"] += 1
            return self._drain_pending(t)
        dists = np.asarray(ev["dists"])
        ids = np.asarray(ev["ids"])
        if flt.payload_checksum(dists, ids) != int(ev["checksum"]) or \
                len(ids) != track.req.k:
            self.stats["corrupt_detected"] += 1
            if att is not None:
                att.dead = True
            if not track.live():
                acts.extend(self._retry_or_fail(track, t))
            acts.extend(self._drain_pending(t))
            return acts
        if att is not None:
            bucket = self._bucket(track.req)
            est = self.service.estimate(bucket)
            dt = t - att.sent_at
            self.service.observe(bucket, dt)
            self.health.observe(wid, dt, baseline=est)
        track.done = True
        if self.results is not None:
            self.results.put(track.req.q, track.req.k, track.req.n_probe,
                             dists, ids)
        self.route_memo.put(track.req.q, wid)
        w.ws.note(self.router.top_centroids(track.req.q), t)
        acts.extend(self._complete(track, dists, ids, wid, t))
        acts.extend(self._drain_pending(t))
        return acts

    # -- failure paths --------------------------------------------------------

    def _retry_or_fail(self, track: _Track, t: float) -> list[tuple]:
        if track.done:
            return []
        if track.retries_used >= self.cfg.retry.max_retries:
            return self._terminal(track, srv.FAILED, t, code="failed")
        track.retries_used += 1
        return [("timer", t + self.cfg.retry.backoff(track.retries_used),
                 {"ev": "retry", "rid": track.req.rid})]

    def _on_timeout(self, rid: int, aid: int, t: float) -> list[tuple]:
        track = self._tracks.get(rid)
        if track is None or track.done:
            return []
        att = track.attempts.get(aid)
        if att is None or att.dead:
            return []
        att.dead = True
        self.stats["timeouts"] += 1
        self.workers[att.wid].inflight.pop(aid, None)
        acts: list[tuple] = []
        if not track.live():
            acts.extend(self._retry_or_fail(track, t))
        acts.extend(self._drain_pending(t))
        return acts

    def _on_retry(self, rid: int, t: float) -> list[tuple]:
        track = self._tracks.get(rid)
        if track is None or track.done:
            return []
        self.stats["retries_sent"] += 1
        acts = self._dispatch(track, t, kind="retry")
        if acts is None:
            return self._enqueue(track, t)
        return acts

    def _on_expire(self, rid: int, t: float) -> list[tuple]:
        track = self._tracks.get(rid)
        if track is None or track.done or not track.queued:
            return []
        track.queued = False
        try:
            self._pending.remove(rid)
        except ValueError:
            pass
        self.stats["shed_expired"] += 1
        return self._terminal(track, srv.SHED, t, code="shed")

    def _on_werr(self, ev: dict, t: float) -> list[tuple]:
        wid, rid = ev["wid"], ev["rid"]
        self.stats["worker_errors"] += 1
        self.health.beat(wid, t)        # an error reply is still liveness
        track = self._tracks.get(rid)
        att = track.attempt_on(wid) if track is not None else None
        if att is not None:
            self.workers[wid].inflight.pop(att.aid, None)
            att.dead = True
        acts: list[tuple] = []
        if track is not None and not track.done and not track.live():
            acts.extend(self._retry_or_fail(track, t))
        acts.extend(self._drain_pending(t))
        return acts

    # -- worker lifecycle -----------------------------------------------------

    def _on_lost(self, wid: int, t: float) -> list[tuple]:
        w = self.workers[wid]
        w.connected = False
        self.stats["worker_lost"] += 1
        acts: list[tuple] = []
        for aid in sorted(w.inflight):
            rid = w.inflight[aid]
            track = self._tracks.get(rid)
            if track is None:
                continue
            att = track.attempts.get(aid)
            if att is not None:
                att.dead = True
            if not track.done and not track.live():
                acts.extend(self._retry_or_fail(track, t))
        w.inflight.clear()
        return acts

    def _on_up(self, ev: dict, t: float) -> list[tuple]:
        wid = ev["wid"]
        w = self.workers[wid]
        w.connected = True
        w.epoch += 1
        w.inflight.clear()
        self.health.reset(wid, t)
        if ev.get("respawned"):
            self.stats["respawns"] += 1
            w.ws.reset(t)
        # seed the service EMA from the worker's measured warmup times, so
        # the first attempt timeouts are sized from evidence, not the cold
        # default (the ready frame carries {"k,n_probe": seconds})
        for key, dt in sorted((ev.get("svc") or {}).items()):
            k_s, np_s = str(key).split(",")
            self.service.observe(
                ShapeBucket(k=int(k_s), batch=1, n_probe=int(np_s)),
                float(dt))
        return self._drain_pending(t)

    # -- reporting ------------------------------------------------------------

    def outcome_list(self) -> list[srv.Outcome]:
        return [self.outcomes[rid] for rid in sorted(self.outcomes)]

    def cache_stats(self) -> dict:
        return {"results": self.results.stats() if self.results else None,
                "route_memo": self.route_memo.stats()}
