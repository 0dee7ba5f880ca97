"""Deadline-aware micro-batcher over a small set of padded (B, k) shapes.

Real traffic has heterogeneous ``k``.  The batcher quantizes requests onto
a small grid of **shape buckets** — a fixed batch width ``B`` times a short
ladder of ``k`` ceilings — and serves every request at its bucket ceiling,
so one engine (one layout, one predictor state, one set of kernel launch
plans) serves each bucket and every batch has one shape.  (The reference
buckets for its jit cache; the port runs eagerly but keeps the same
buckets, so its batches, admission decisions and results follow the
reference's on the same trace.)

* a request with ``k <= bucket.k`` runs at ``bucket.k`` and the result is
  trimmed post-hoc to the first ``k`` rows (results come back sorted by
  distance, so the trim is exact: the top-k prefix of a top-``bucket.k``
  selection IS the top-k);
* a partial batch is padded to ``B`` rows by cycling the real queries (pad
  lanes are discarded at trim time; cycling real queries rather than zeros
  keeps the per-batch bucket histograms — which feed the cross-batch tau
  predictor — drawn from the live query distribution).

Batches fire under two rules (whichever comes first):

* **fill** — a bucket lane reaches ``B`` waiting requests;
* **slack expiry** — the oldest waiting request's remaining slack no longer
  covers one estimated service time for its bucket (waiting any longer
  would blow its deadline), where the estimate comes from the admission
  controller's per-bucket service-time EMA.

All methods take ``now`` explicitly — the batcher never reads a wall clock,
so the discrete-event server loop and the deterministic tests drive it with
whatever clock they own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch.serving.queue import Request


@dataclass(frozen=True, order=True)
class ShapeBucket:
    """One padded compile shape: (batch, k) plus the routing width."""

    k: int
    batch: int
    n_probe: int


def k_ceilings(ks: Iterable[int]) -> tuple[int, ...]:
    """Sorted unique k ceilings for a bucket ladder."""
    out = tuple(sorted({int(k) for k in ks}))
    if not out or out[0] < 1:
        raise ValueError(f"k ceilings must be positive, got {out}")
    return out


def bucket_of(k: int, n_probe: int, ceilings: Sequence[int],
              batch: int) -> ShapeBucket:
    """Smallest ladder ceiling that covers ``k`` (KeyError if none does —
    admission decides whether an oversized request is k-capped or shed)."""
    for c in ceilings:
        if k <= c:
            return ShapeBucket(k=int(c), batch=int(batch),
                               n_probe=int(n_probe))
    raise KeyError(
        f"k={k} exceeds the largest bucket ceiling {max(ceilings)}")


@dataclass(frozen=True, eq=False)
class Batch:
    """An assembled, padded batch ready for one engine call."""

    bucket: ShapeBucket
    requests: tuple[Request, ...]       # the real (unpadded) requests
    queries: np.ndarray                 # (bucket.batch, d), padded

    @property
    def n_real(self) -> int:
        return len(self.requests)


def assemble(bucket: ShapeBucket, requests: Sequence[Request]) -> Batch:
    """Stack request queries into the bucket's (B, d) shape, cycling real
    queries into the pad lanes."""
    if not 0 < len(requests) <= bucket.batch:
        raise ValueError(
            f"got {len(requests)} requests for a B={bucket.batch} bucket")
    rows = [np.asarray(r.q) for r in requests]
    for i in range(bucket.batch - len(rows)):
        rows.append(rows[i % len(requests)])
    return Batch(bucket=bucket, requests=tuple(requests),
                 queries=np.stack(rows))


class MicroBatcher:
    """Continuous batch assembly over per-bucket FIFO lanes."""

    def __init__(self, ceilings: Sequence[int], batch: int,
                 service_est: Callable[[ShapeBucket], float],
                 slack_margin: float = 0.0,
                 max_wait: float | None = None):
        self.ceilings = k_ceilings(ceilings)
        self.batch = int(batch)
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.service_est = service_est
        self.slack_margin = float(slack_margin)
        # optional cap on queueing wait: with a loose deadline a partial
        # batch would otherwise sit until its slack expires, so tail latency
        # under LOW load would equal the deadline; max_wait bounds it
        self.max_wait = None if max_wait is None else float(max_wait)
        self._lanes: dict[ShapeBucket, list[Request]] = {}

    # -- intake -------------------------------------------------------------

    def submit(self, req: Request) -> ShapeBucket:
        bucket = bucket_of(req.k, req.n_probe, self.ceilings, self.batch)
        self._lanes.setdefault(bucket, []).append(req)
        return bucket

    # -- introspection (admission reads these) ------------------------------

    def depth(self, bucket: ShapeBucket) -> int:
        return len(self._lanes.get(bucket, ()))

    def depths(self) -> dict[ShapeBucket, int]:
        return {b: len(lane) for b, lane in self._lanes.items() if lane}

    def pending(self) -> int:
        return sum(len(lane) for lane in self._lanes.values())

    # -- withdrawal (the retry path pulls timed-out requests back) -----------

    def withdraw(self, rid: int) -> Request | None:
        """Remove and return a queued (not yet fired) request by id, or
        None when it is not waiting here.  The multi-replica retry path
        uses this to pull a timed-out request out of a dead or stalled
        replica's lane before re-dispatching it elsewhere — without it the
        request could complete twice from one attempt."""
        for bucket in sorted(self._lanes):
            lane = self._lanes[bucket]
            for i, r in enumerate(lane):
                if r.rid == rid:
                    return lane.pop(i)
        return None

    def clear(self) -> int:
        """Drop every queued request (crash respawn: a restarted replica
        process has lost its queue; the requests are recovered by their
        timeouts).  Returns the number dropped."""
        n = self.pending()
        self._lanes.clear()
        return n

    # -- firing -------------------------------------------------------------

    # float jitter guard: next_fire_time's "due" instant must round-trip
    # through _slack_expired as expired, or the event loop would spin
    _EPS = 1e-9

    def _slack_expired(self, bucket: ShapeBucket, req: Request,
                       now: float) -> bool:
        est = self.service_est(bucket)
        if req.slack(now) <= est + self.slack_margin + self._EPS:
            return True
        return self.max_wait is not None and \
            now - req.arrival >= self.max_wait - self._EPS

    def pop_ready(self, now: float) -> list[tuple[ShapeBucket,
                                                  tuple[Request, ...]]]:
        """Pop every batch that must fire at ``now`` — full lanes first,
        then partial lanes whose oldest request's slack no longer covers
        one estimated service time — WITHOUT assembling the padded query
        arrays.  Buckets are visited in sorted order so firing is
        deterministic.  The double-buffered server loop assembles each
        popped batch inside the previous batch's device window
        (``Server._serve``'s overlap hook); ``fire_ready`` keeps the eager
        assemble-on-pop contract for consumers that want finished batches.
        """
        out: list[tuple[ShapeBucket, tuple[Request, ...]]] = []
        for bucket in sorted(self._lanes):
            lane = self._lanes[bucket]
            while len(lane) >= bucket.batch:
                out.append((bucket, tuple(lane[:bucket.batch])))
                del lane[:bucket.batch]
            if lane and self._slack_expired(bucket, lane[0], now):
                out.append((bucket, tuple(lane)))
                lane.clear()
        return out

    def fire_ready(self, now: float) -> list[Batch]:
        """``pop_ready`` with eager assembly: every due batch, padded and
        ready for the engine."""
        return [assemble(bucket, reqs)
                for bucket, reqs in self.pop_ready(now)]

    def next_fire_time(self, now: float) -> float | None:
        """Earliest future instant a slack-expiry fire is due (None when no
        requests wait).  Full lanes fire immediately via fire_ready, so only
        partial lanes contribute."""
        times = []
        for bucket, lane in self._lanes.items():
            if not lane:
                continue
            due = lane[0].deadline - self.service_est(bucket) - \
                self.slack_margin
            if self.max_wait is not None:
                due = min(due, lane[0].arrival + self.max_wait)
            times.append(due)
        if not times:
            return None
        return max(min(times), now)
