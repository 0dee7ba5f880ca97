"""Request queue + synthetic arrival traces for the async serving subsystem.

A serving request is one query vector plus the retrieval parameters the
paper's workload varies per caller (``k``, ``n_probe``) and the timing facts
the scheduler reasons about (arrival time, absolute deadline).  The queue is
a plain arrival-ordered FIFO: scheduling intelligence lives in ``batcher``
(shape-bucketed assembly) and ``admission`` (shed / k-cap) — the queue only
owns ordering, validation, and O(1) peeks at the oldest entry, which is what
the fire-on-slack rule needs.

Synthetic traces model the two open-loop arrival regimes the serving
benchmarks exercise: ``poisson`` (memoryless traffic at a target mean rate)
and ``bursty`` (the same mean rate arriving in fixed-size bursts — the worst
case for a fixed-batch loop and the motivating case for deadline-aware
micro-batching).  Both are fully determined by the caller's ``rng``, so a
seeded trace replays identically (the admission tests rely on this), and
the same numpy generator and seed give the JAX package's trace element by
element: the draws are the same calls in the same order.  Queries stay
numpy arrays until the serving state moves a batch to its device.

``make_zipf_trace`` draws a head-heavy stream over a pool of distinct
queries, the traffic the socket front end's result cache is for
(``repro_torch.transport``).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, replace
from typing import Iterable, Sequence

import numpy as np


@dataclass(frozen=True, eq=False)
class Request:
    """One retrieval request.

    ``deadline`` is absolute, on the same clock as ``arrival``.  When
    admission k-caps a request, ``k`` holds the effective value the engine
    will run and ``k_requested`` records what the caller asked for.

    ``recall_target`` is the caller's recall@k requirement (None = no
    stated requirement) — the DegradeLadder may lower it under overload
    (``recall_capped``), serving the request at a cheaper tuned operating
    point; ``recall_requested`` records the original so the outcome is
    flagged ``degraded``, never silently coarser.
    """

    rid: int
    q: np.ndarray            # (d,) query vector
    k: int
    n_probe: int
    arrival: float
    deadline: float
    k_requested: int | None = None
    n_probe_requested: int | None = None
    recall_target: float | None = None
    recall_requested: float | None = None

    def __post_init__(self):
        # Validate at construction, not only at queue intake: the fault /
        # retry layer synthesizes requests (k-caps, n_probe-caps, hedged
        # duplicates) that never pass through RequestQueue.push, and a
        # malformed retry must fail loudly instead of corrupting the
        # scheduler's timeline.
        if self.k <= 0:
            raise ValueError(
                f"request {self.rid}: k must be >= 1, got {self.k}")
        # the embedding itself is untrusted input at the transport boundary:
        # a NaN/Inf query poisons every distance it touches (NaN propagates
        # through the whole top-k selection), so it must die here with a
        # typed error instead of surfacing as garbage results downstream
        q = np.asarray(self.q)
        if q.ndim != 1 or q.size == 0:
            raise ValueError(
                f"request {self.rid}: q must be a non-empty 1-D vector, "
                f"got shape {q.shape}")
        if not np.issubdtype(q.dtype, np.floating) and \
                not np.issubdtype(q.dtype, np.integer):
            raise ValueError(
                f"request {self.rid}: q must be numeric, got dtype {q.dtype}")
        if not np.all(np.isfinite(q)):
            raise ValueError(
                f"request {self.rid}: q must be finite (no NaN/Inf)")
        if self.n_probe <= 0:
            raise ValueError(
                f"request {self.rid}: n_probe must be >= 1, "
                f"got {self.n_probe}")
        if not np.isfinite(self.deadline) or self.deadline < 0:
            raise ValueError(
                f"request {self.rid}: deadline must be finite and "
                f">= 0, got {self.deadline}")
        if not np.isfinite(self.arrival):
            raise ValueError(
                f"request {self.rid}: arrival must be finite, "
                f"got {self.arrival}")
        for label, rt in (("recall_target", self.recall_target),
                          ("recall_requested", self.recall_requested)):
            if rt is not None and not (np.isfinite(rt) and 0.0 < rt <= 1.0):
                raise ValueError(
                    f"request {self.rid}: {label} must be in (0, 1], "
                    f"got {rt}")

    def slack(self, now: float) -> float:
        return self.deadline - now

    def k_capped(self, k: int) -> "Request":
        if k >= self.k:
            return self
        return replace(self, k=k,
                       k_requested=self.k_requested or self.k)

    def n_probe_capped(self, n_probe: int) -> "Request":
        """Degrade the routing width (capacity-ladder brownout rung);
        ``n_probe_requested`` records the original so the outcome is
        flagged ``degraded``, never silently narrower."""
        if n_probe >= self.n_probe:
            return self
        return replace(self, n_probe=n_probe,
                       n_probe_requested=self.n_probe_requested
                       or self.n_probe)

    def recall_capped(self, target: float) -> "Request":
        """Lower the recall target (the tuned-frontier brownout rung);
        ``recall_requested`` records the original.  A request with no
        stated target adopts the rung's target un-flagged — it never
        promised more."""
        if self.recall_target is None:
            return replace(self, recall_target=target)
        if target >= self.recall_target:
            return self
        return replace(self, recall_target=target,
                       recall_requested=self.recall_requested
                       or self.recall_target)

    @property
    def degraded(self) -> bool:
        return self.k_requested is not None or \
            self.n_probe_requested is not None or \
            self.recall_requested is not None


class RequestQueue:
    """Arrival-ordered FIFO of :class:`Request`."""

    def __init__(self, requests: Iterable[Request] = ()):  # noqa: D107
        self._q: deque[Request] = deque()
        for r in requests:
            self.push(r)

    def push(self, req: Request) -> None:
        if req.k < 1:
            raise ValueError(f"request {req.rid}: k must be >= 1, got {req.k}")
        if req.n_probe < 1:
            raise ValueError(f"request {req.rid}: n_probe must be >= 1")
        if req.deadline < req.arrival:
            raise ValueError(
                f"request {req.rid}: deadline {req.deadline} precedes "
                f"arrival {req.arrival}")
        if self._q and req.arrival < self._q[-1].arrival:
            raise ValueError(
                f"request {req.rid}: arrivals must be non-decreasing")
        self._q.append(req)

    def pop(self) -> Request:
        return self._q.popleft()

    def peek(self) -> Request | None:
        return self._q[0] if self._q else None

    def drain_arrived(self, now: float) -> list[Request]:
        """Pop every request whose arrival time is at or before ``now``."""
        out = []
        while self._q and self._q[0].arrival <= now:
            out.append(self._q.popleft())
        return out

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


# --------------------------------------------------------------------------
# Synthetic arrival traces
# --------------------------------------------------------------------------

def poisson_arrivals(rng: np.random.Generator, n: int, rate: float,
                     t0: float = 0.0) -> np.ndarray:
    """``n`` arrival times of a Poisson process with mean ``rate`` (1/s)."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    return t0 + np.cumsum(rng.exponential(1.0 / rate, n))


def bursty_arrivals(rng: np.random.Generator, n: int, rate: float,
                    burst: int = 8, spread: float = 1e-4,
                    t0: float = 0.0) -> np.ndarray:
    """``n`` arrivals at the same mean ``rate`` but in bursts of ``burst``
    (burst epochs are Poisson at rate/burst; within-burst jitter ``spread``
    keeps arrivals strictly ordered without changing the regime)."""
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    n_bursts = -(-n // burst)
    epochs = poisson_arrivals(rng, n_bursts, rate / burst, t0)
    offsets = np.arange(burst) * spread
    times = (epochs[:, None] + offsets[None, :]).reshape(-1)[:n]
    # a short Poisson epoch gap can undercut the within-burst window;
    # sorting restores the monotone-arrivals contract RequestQueue enforces
    return np.sort(times)


def make_trace(
    rng: np.random.Generator,
    queries: np.ndarray,            # (n, d)
    ks: int | Sequence[int],
    *,
    rate: float,
    deadline: float,                # relative to each arrival, seconds
    n_probe: int,
    pattern: str = "poisson",
    burst: int = 8,
    t0: float = 0.0,
    recall_target: float | None = None,
) -> list[Request]:
    """Seeded synthetic request trace: one request per query row, arrival
    times from ``pattern``, per-request ``k`` sampled uniformly from ``ks``
    (heterogeneous-k traffic when a sequence is given); ``recall_target``
    stamps every request with the caller's recall requirement (the knob
    the DegradeLadder trades away under overload)."""
    n = len(queries)
    if pattern == "poisson":
        times = poisson_arrivals(rng, n, rate, t0)
    elif pattern == "bursty":
        times = bursty_arrivals(rng, n, rate, burst=burst, t0=t0)
    else:
        raise ValueError(f"unknown arrival pattern {pattern!r}")
    ks_arr = (np.full(n, ks, np.int64) if np.isscalar(ks)
              else np.asarray(rng.choice(np.asarray(ks, np.int64), n)))
    return [
        Request(rid=i, q=np.asarray(queries[i]), k=int(ks_arr[i]),
                n_probe=n_probe, arrival=float(times[i]),
                deadline=float(times[i]) + deadline,
                recall_target=recall_target)
        for i in range(n)
    ]


def zipf_query_ids(rng: np.random.Generator, n: int, pool: int,
                   alpha: float = 1.1) -> np.ndarray:
    """``n`` draws from a Zipf(``alpha``) distribution over a pool of
    ``pool`` distinct queries (rank-frequency, rank 0 hottest), by explicit
    inverse CDF over the truncated support (not ``rng.zipf``, whose support
    is unbounded), so identical (seed, n, pool, alpha) give an identical
    stream."""
    if pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    weights = 1.0 / np.power(np.arange(1, pool + 1, dtype=np.float64), alpha)
    cdf = np.cumsum(weights / weights.sum())
    return np.searchsorted(cdf, rng.random(n), side="right").astype(np.int64)


def make_zipf_trace(
    rng: np.random.Generator,
    pool_queries: np.ndarray,       # (pool, d) distinct query vectors
    n: int,
    ks: int | Sequence[int],
    *,
    rate: float,
    deadline: float,
    n_probe: int,
    alpha: float = 1.1,
    t0: float = 0.0,
) -> list[Request]:
    """Seeded head-heavy trace: ``n`` Poisson arrivals whose query vectors
    repeat from ``pool_queries`` with Zipf(``alpha``) rank-frequency.  ``k``
    is sampled per pool entry (not per request), so a repeated query
    repeats with the same retrieval parameters: the exact-key regime a
    result cache can serve."""
    pool = len(pool_queries)
    picks = zipf_query_ids(rng, n, pool, alpha)
    times = poisson_arrivals(rng, n, rate, t0)
    ks_pool = (np.full(pool, ks, np.int64) if np.isscalar(ks)
               else np.asarray(rng.choice(np.asarray(ks, np.int64), pool)))
    return [
        Request(rid=i, q=np.asarray(pool_queries[picks[i]]),
                k=int(ks_pool[picks[i]]), n_probe=n_probe,
                arrival=float(times[i]),
                deadline=float(times[i]) + deadline)
        for i in range(n)
    ]
