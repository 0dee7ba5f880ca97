"""Composition root: the async serving loop (trace in, outcomes out).

``Server`` wires queue -> admission -> micro-batcher -> engine into one
discrete-event loop.  Time is explicit: arrivals come from the (sorted)
request trace, service time is either measured around the real engine call
(production, ``chip_smoke.py``) or injected via ``service_time_fn``
(deterministic tests), and the loop advances the clock to the next arrival
or the next slack-expiry fire when nothing is runnable.  A single executor
is modeled: batches serve one at a time and the clock advances by each
batch's service time, so queueing delay, deadline misses, and shed
decisions all emerge from the same timeline the latency percentiles are
computed on.  With the same trace and the same ``service_time_fn`` the
loop makes the JAX package's decisions, request for request.

Correctness contract: a completed request's ids are EXACTLY the ids a
direct engine call at its bucket — a singleton batch through
``SearchEngine.search_batch``, the entry point serving drives — would
return, trimmed to its (possibly k-capped) ``k``: padding, batch
composition, and scheduling never change results.  (The single-query
RaBitQ searcher evaluates differently from the batched band evaluation
and can legitimately differ near the k-th boundary, which is why the
contract is stated against the batched entry point.)  Shed requests
return nothing (``ids is None``): absent, never incorrect.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.serving import admission as adm
from repro_torch.serving.batcher import Batch, MicroBatcher, ShapeBucket, \
    assemble, bucket_of
from repro_torch.serving.queue import Request
from repro_torch.serving.state import ServingState

OK = "ok"
DEGRADED = "degraded"
SHED = "shed"
# terminal failure and front-door refusal: only the reference's replica
# tier and socket front end emit them (ROADMAP.md queue 1, items 12 and
# 13); the single-engine Server never does.  Like SHED they carry no
# results, and ``summarize`` counts them so that completed + shed + failed
# + rejected == offered stays checkable.
FAILED = "failed"
REJECTED = "rejected"


def trim_topk(dists: np.ndarray, ids: np.ndarray,
              k: int) -> tuple[np.ndarray, np.ndarray]:
    """Trim one bucket-ceiling result row to its request's ``k``.

    Rows are sorted by reported distance first: a no-op for the IVF / PQ
    paths (their rows come back ascending, so the prefix of a top-bucket.k
    selection IS the top-k), and for RaBitQ — whose rows interleave
    bound-certified members (reporting estimates) with re-ranked members
    (reporting exact distances) — it makes the prefix the method's best-k
    by reported distance.  Every consumer (the server, the parity check of
    ``serve --check-parity``, the tests) trims through this one helper so
    "served result" and "direct engine call" always mean the same rows.
    """
    order = np.argsort(dists, kind="stable")[:k]
    return dists[order], ids[order]


def parity_vs_direct(state: ServingState,
                     outcomes: Sequence["Outcome"]) -> tuple[float, int]:
    """Fraction of completed outcomes whose ids exactly match a direct
    engine call at their bucket — a singleton batch through the same
    ``search_batch`` entry point serving drives, trimmed through
    ``trim_topk`` — plus the count checked.  This is THE correctness
    contract; ``serve --check-parity`` and ``chip_smoke.py`` call it so
    "parity" cannot drift between them.  Callers must treat a zero count as
    a failure, not a pass: an all-shed run verified nothing."""
    done = [o for o in outcomes if o.ids is not None]
    bad = 0
    for o in done:
        direct = state.engine(o.bucket).search_batch(
            torch.from_numpy(np.asarray(o.request.q, np.float32))[None])
        _, want = trim_topk(direct.dists[0].cpu().numpy(),
                            direct.ids[0].cpu().numpy(), o.k_effective)
        if set(want.tolist()) != set(o.ids.tolist()):
            bad += 1
    return (1.0 - bad / max(len(done), 1)), len(done)


@dataclass(frozen=True, eq=False)
class Outcome:
    """Terminal record for one request."""

    request: Request
    status: str                     # OK | DEGRADED | SHED | FAILED | REJECTED
    bucket: ShapeBucket | None
    ids: np.ndarray | None          # (k_effective,) — None when shed/failed
    dists: np.ndarray | None
    t_done: float
    k_effective: int
    # multi-replica provenance (None / zero on the single-engine Server)
    replica: int | None = None      # replica whose response won
    retries: int = 0                # retry attempts consumed
    hedged: bool = False            # a hedged duplicate was sent

    @property
    def latency(self) -> float:
        return self.t_done - self.request.arrival

    @property
    def completed(self) -> bool:
        return self.status in (OK, DEGRADED)

    @property
    def deadline_met(self) -> bool:
        return self.completed and self.t_done <= self.request.deadline


class Server:
    """Deadline-aware micro-batching server over a ``ServingState``."""

    def __init__(self, state: ServingState, ceilings: Sequence[int],
                 batch: int, *, admission: bool = True,
                 allow_degrade: bool = True, slack_margin: float = 0.0,
                 max_wait: float | None = None,
                 service_decay: float = 0.6, service_cold: float = 0.02,
                 service_time_fn: Callable[[ShapeBucket], float]
                 | None = None, overlap: bool = True):
        self.state = state
        # double-buffer host batch assembly against device execution: while
        # batch j runs on the device, batch j+1's padded query array is
        # assembled on the host (inside _serve's dispatch->sync window).
        # Outcomes are identical either way — assembly is pure and the
        # event-loop clock advances by the same measured dt — only the
        # host-side critical path shrinks.
        self.overlap = bool(overlap)
        self.service = adm.ServiceEMA(decay=service_decay, cold=service_cold)
        self.batcher = MicroBatcher(ceilings, batch,
                                    service_est=self.service.estimate,
                                    slack_margin=slack_margin,
                                    max_wait=max_wait)
        self.admission = adm.AdmissionController(
            self.service, self.batcher.ceilings, batch,
            allow_degrade=allow_degrade, slack_margin=slack_margin) \
            if admission else None
        self.service_time_fn = service_time_fn

    # -- engine execution ---------------------------------------------------

    def _serve(self, batch: Batch,
               overlap_fn: Callable[[], None] | None = None):
        t0 = time.perf_counter()
        res = self.state.run(batch)
        if overlap_fn is not None:
            # CUDA launches are asynchronous: the card may still be running
            # this batch's tail; spend that window on host work (the next
            # batch's assembly) instead of waiting idle
            overlap_fn()
        self.state.synchronize()
        dt = time.perf_counter() - t0
        if self.service_time_fn is not None:
            dt = self.service_time_fn(batch.bucket)
        return dt, res

    def warmup(self, trace: Sequence[Request]) -> "Server":
        """AOT warmup off the serving timeline: precompile every shape
        bucket the trace will hit (`ServingState.warmup` ->
        `SearchEngine.warmup`), then seed the service-time EMA with one
        measured post-compile batch per bucket so the first admission
        decisions already see realistic service estimates."""
        buckets = sorted({
            bucket_of(min(r.k, self.batcher.ceilings[-1]), r.n_probe,
                      self.batcher.ceilings, self.batcher.batch)
            for r in trace})
        self.state.warmup(buckets)
        for bucket in buckets:
            reqs = [r for r in trace
                    if bucket_of(min(r.k, self.batcher.ceilings[-1]),
                                 r.n_probe, self.batcher.ceilings,
                                 self.batcher.batch) == bucket]
            dt, _ = self._serve(assemble(bucket, reqs[:bucket.batch]))
            self.service.observe(bucket, dt)
        return self

    # -- the event loop -----------------------------------------------------

    def _admit(self, req: Request, now: float,
               outcomes: dict[int, Outcome], in_flight: float = 0.0) -> None:
        """Run one request through admission (or straight to the batcher
        when admission is off).  ``in_flight`` carries the estimated
        remaining service time of the batch occupying the executor — a
        request arriving mid-batch is decided at its ARRIVAL time with
        that estimate folded into its deadline feasibility."""
        if self.admission is None:
            self.batcher.submit(req.k_capped(self.batcher.ceilings[-1]))
            return
        dec = self.admission.decide(req, now, self.batcher.depths(),
                                    in_flight=in_flight)
        if dec.action == adm.SHED:
            outcomes[req.rid] = Outcome(
                request=req, status=SHED, bucket=None, ids=None,
                dists=None, t_done=now, k_effective=0)
        else:
            self.batcher.submit(req.k_capped(dec.k))

    def _finish(self, batch: Batch, res, t_done: float,
                outcomes: dict[int, Outcome]) -> None:
        ids = res.ids.cpu().numpy()
        dists = res.dists.cpu().numpy()
        for j, req in enumerate(batch.requests):
            status = DEGRADED if req.k_requested is not None else OK
            d_j, i_j = trim_topk(dists[j], ids[j], req.k)
            outcomes[req.rid] = Outcome(
                request=req, status=status, bucket=batch.bucket,
                ids=i_j.copy(), dists=d_j.copy(),
                t_done=t_done, k_effective=req.k)

    def run_trace(self, trace: Sequence[Request],
                  warmup: bool = True) -> list[Outcome]:
        """Serve a whole (seeded) trace; returns outcomes in rid order."""
        trace = sorted(trace, key=lambda r: (r.arrival, r.rid))
        if warmup and trace:
            self.warmup(trace)
        outcomes: dict[int, Outcome] = {}
        t = trace[0].arrival if trace else 0.0
        i = 0
        while True:
            # ingest every arrival at or before now, through admission
            while i < len(trace) and trace[i].arrival <= t:
                req = trace[i]
                i += 1
                self._admit(req, t, outcomes)

            ready = self.batcher.pop_ready(t)
            if ready:
                # slot-based double buffer: batch j+1 is assembled while
                # batch j occupies the device (overlap on), or right after
                # it completes (overlap off); either way exactly one
                # assembled batch is in flight at a time
                slot: list[Batch | None] = [assemble(*ready[0])]
                for j in range(len(ready)):
                    batch = slot[0]
                    t0 = t
                    # what a live server knows while the batch runs: its
                    # EMA estimate, frozen before the measurement lands —
                    # plus the estimates of batches already fired behind it
                    # (popped from the queue, so invisible to depths())
                    est = self.service.estimate(batch.bucket)
                    pending = sum(self.service.estimate(b2)
                                  for b2, _ in ready[j + 1:])

                    def _prep_next():
                        slot[0] = assemble(*ready[j + 1]) \
                            if j + 1 < len(ready) else None

                    dt, res = self._serve(
                        batch, overlap_fn=_prep_next if self.overlap
                        else None)
                    if not self.overlap:
                        _prep_next()
                    t = t0 + dt
                    # requests that arrived DURING this batch's service are
                    # decided at their arrival instant, with the executor's
                    # estimated remainder folded into the wait
                    while i < len(trace) and trace[i].arrival <= t:
                        req = trace[i]
                        i += 1
                        remaining = max(0.0, (t0 + est) - req.arrival)
                        self._admit(req, req.arrival, outcomes,
                                    in_flight=remaining + pending)
                    self.service.observe(batch.bucket, dt)
                    self._finish(batch, res, t, outcomes)
                continue   # service time passed: re-check arrivals first

            # idle: jump to the next arrival or the next slack-expiry fire
            nxt = []
            if i < len(trace):
                nxt.append(trace[i].arrival)
            fire_at = self.batcher.next_fire_time(t)
            if fire_at is not None:
                nxt.append(fire_at)
            if not nxt:
                break
            t = max(t, min(nxt))
        return [outcomes[r.rid] for r in sorted(trace, key=lambda r: r.rid)]


def _pctiles(sub: Sequence[Outcome]) -> dict:
    lat = np.array([o.latency for o in sub])
    return {
        "count": len(sub),
        # null, not a fabricated 0.0, when nothing completed
        "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3)
        if len(sub) else None,
        "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3)
        if len(sub) else None,
    }


def summarize(outcomes: Sequence[Outcome],
              state: ServingState | None = None) -> dict:
    """Aggregate serving metrics for reporting: QPS over the busy span,
    latency percentiles over completed requests, per-outcome counts AND
    per-outcome p50/p99 (``by_status``), shed / degrade / failure /
    deadline-met rates, retry / hedge counts, and the request-conservation
    check (completed + shed + failed + rejected == offered — zero
    unaccounted requests); the reference's keys.  Degraded traffic is
    surfaced explicitly instead of hiding inside the headline QPS number.
    Passing the ``state`` that served the trace adds ``operating_points``:
    where each engine bucket's knobs came from."""
    n = len(outcomes)
    done = [o for o in outcomes if o.completed]
    shed = [o for o in outcomes if o.status == SHED]
    failed = [o for o in outcomes if o.status == FAILED]
    rejected = [o for o in outcomes if o.status == REJECTED]
    t0 = min(o.request.arrival for o in outcomes) if outcomes else 0.0
    t1 = max(o.t_done for o in done) if done else t0
    span = max(t1 - t0, 1e-9)
    extra = {"operating_points": state.operating_points()} \
        if state is not None else {}
    return {
        **extra,
        "requests": n,
        "completed": len(done),
        "shed": len(shed),
        "failed": len(failed),
        "rejected": len(rejected),
        "degraded": sum(o.status == DEGRADED for o in outcomes),
        "retried": sum(o.retries > 0 for o in outcomes),
        "hedged": sum(o.hedged for o in outcomes),
        # zero unaccounted requests: every offered request is terminal
        "conserved": bool(len(done) + len(shed) + len(failed)
                          + len(rejected) == n),
        "qps": round(len(done) / span, 2),
        "p50_ms": _pctiles(done)["p50_ms"],
        "p99_ms": _pctiles(done)["p99_ms"],
        "by_status": {
            status: _pctiles([o for o in done if o.status == status])
            for status in (OK, DEGRADED)
        },
        "shed_rate": round(len(shed) / max(n, 1), 4),
        "failed_rate": round(len(failed) / max(n, 1), 4),
        "rejected_rate": round(len(rejected) / max(n, 1), 4),
        "degraded_rate": round(
            sum(o.status == DEGRADED for o in outcomes) / max(n, 1), 4),
        "deadline_met_rate": round(
            sum(o.deadline_met for o in outcomes) / max(n, 1), 4),
    }
