"""Deterministic fault injection at the replica service boundary.

The port's copy of the JAX package's ``repro.serving.faults``: pure numpy,
the same schedules, the same decisions, the same checksum.

The multi-replica tier is only production-shaped if it survives replicas
that stall, crash, or lie — and a fault run is only debuggable if it
REPLAYS.  This module therefore models faults as a static, fully seeded
:class:`FaultSchedule`: a sorted tuple of :class:`Fault` records, each
pinned to (replica, time).  The schedule is consulted exclusively inside
``Replica.serve`` and the replica-side heartbeat — the service boundary —
so the router sees only the observable consequences (missed heartbeats,
overdue batches, checksum mismatches) and cannot cheat by peeking at the
schedule.

Fault taxonomy:

=========  ===============================================================
kind       effect at the service boundary
=========  ===============================================================
crash      the replica dies at ``t``: an in-flight batch never completes,
           queued work is stranded, heartbeats stop.  One-shot; a
           supervisor may respawn the replica after a delay (the respawn
           consumes the crash).
stall      for ``duration`` seconds from ``t`` the replica makes no
           progress: any batch whose service overlaps the window finishes
           ``duration`` late, and heartbeats inside the window are
           suppressed (so the health view sees the stall).
slow       batches STARTED inside ``[t, t + duration)`` take ``factor``
           times their normal service time (e.g. a noisy neighbor); the
           health view's service-time anomaly detector is the defense.
corrupt    responses to batches started inside the window have their
           payload corrupted AFTER the integrity checksum is computed —
           the router's checksum verification must catch it and retry.
=========  ===============================================================

Schedules come from either a spec string (``--faults`` on the serving CLI;
see :meth:`FaultSchedule.parse`) or a seeded generator
(:meth:`FaultSchedule.seeded`).  Both are pure data: identical spec/seed ⇒
identical schedule ⇒ (with a fixed service model) byte-identical outcome
summaries — the deterministic replay contract the replica tests and
``chip_smoke.py`` phase 15 gate on.
"""
from __future__ import annotations

import hashlib
import zlib
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

CRASH = "crash"
STALL = "stall"
SLOW = "slow"
CORRUPT = "corrupt"
KINDS = (CRASH, STALL, SLOW, CORRUPT)

# -- wire-fault taxonomy (the transport tier's failure surface) --------------
#
# Process faults above model what a REPLICA does wrong; these model what the
# NETWORK does wrong, applied per frame at the proxy shim between the master
# and each worker connection (``repro_torch.transport``'s ``WireShim``):
#
# ==========  ==============================================================
# kind        effect at the shim
# ==========  ==============================================================
# drop        the frame silently never arrives (attempt timeouts recover it)
# dup         the frame is delivered twice (receivers must be idempotent;
#             the duplicate response is counted, never double-completed)
# slow        delivery is delayed by base + jitter seconds (slow network;
#             the per-attempt timeout and p99 gates are the defense)
# truncate    outbound only: a partial prefix of the frame's bytes is
#             written and the connection closed — the peer's frame reader
#             sees EOF mid-frame (the partial-write case)
# disconnect  the connection closes before the frame is delivered
#             (disconnect-mid-response when it hits a response frame)
# ==========  ==============================================================
WIRE_DROP = "drop"
WIRE_DUP = "dup"
WIRE_SLOW = "slow"
WIRE_TRUNCATE = "truncate"
WIRE_DISCONNECT = "disconnect"
WIRE_KINDS = (WIRE_DROP, WIRE_DUP, WIRE_SLOW, WIRE_TRUNCATE, WIRE_DISCONNECT)


@dataclass(frozen=True, order=True)
class Fault:
    """One injected fault, pinned to (time, replica)."""

    t: float                 # injection instant (trace clock, seconds)
    replica: int             # target replica id
    kind: str                # CRASH | STALL | SLOW | CORRUPT
    duration: float = 0.0    # window length (stall/slow/corrupt)
    factor: float = 1.0      # service-time multiplier (slow)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.kind != CRASH and self.duration <= 0:
            raise ValueError(f"{self.kind} fault needs duration > 0")
        if self.kind == SLOW and self.factor <= 1.0:
            raise ValueError(f"slow fault needs factor > 1, "
                             f"got {self.factor}")

    def active(self, now: float) -> bool:
        return self.t <= now < self.t + self.duration


class FaultSchedule:
    """Immutable, sorted set of faults with boundary-side query helpers."""

    def __init__(self, faults: Iterable[Fault] = ()):
        self.faults = tuple(sorted(faults))

    def __len__(self) -> int:
        return len(self.faults)

    def __bool__(self) -> bool:
        return bool(self.faults)

    def for_replica(self, rid: int) -> tuple[Fault, ...]:
        return tuple(f for f in self.faults if f.replica == rid)

    # -- construction -------------------------------------------------------

    @staticmethod
    def parse(spec: str) -> "FaultSchedule":
        """Parse a ``--faults`` spec string.

        Grammar: ``kind@replica:key=val[,key=val…]`` joined by ``;`` —
        e.g. ``crash@1:t=0.5;stall@2:t=1.0,dur=0.4;``
        ``slow@0:t=0.2,dur=1.0,factor=4;corrupt@3:t=0.8,dur=0.3``.
        """
        faults = []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            try:
                head, params = part.split(":", 1)
                kind, rid = head.split("@", 1)
                kv = dict(item.split("=", 1)
                          for item in params.split(",") if item)
                faults.append(Fault(
                    t=float(kv.pop("t")), replica=int(rid),
                    kind=kind.strip(),
                    duration=float(kv.pop("dur", 0.0)),
                    factor=float(kv.pop("factor", 1.0))))
                if kv:
                    raise ValueError(f"unknown keys {sorted(kv)}")
            except (KeyError, ValueError) as e:
                raise ValueError(
                    f"bad fault spec {part!r}: {e} — expected "
                    f"kind@replica:t=SECONDS[,dur=S][,factor=F]") from e
        return FaultSchedule(faults)

    @staticmethod
    def seeded(rng: np.random.Generator, n_replicas: int, horizon: float,
               n_faults: int = 4,
               kinds: Sequence[str] = KINDS) -> "FaultSchedule":
        """Seeded random schedule: ``n_faults`` faults uniform over the
        middle 80% of ``[0, horizon]`` (faults at the very edges are
        uninteresting — nothing in flight), kinds and replicas drawn from
        the rng.  Identical (seed, args) ⇒ identical schedule."""
        faults = []
        for _ in range(n_faults):
            kind = str(rng.choice(list(kinds)))
            faults.append(Fault(
                t=float(rng.uniform(0.1, 0.9)) * horizon,
                replica=int(rng.integers(n_replicas)),
                kind=kind,
                duration=(0.0 if kind == CRASH
                          else float(rng.uniform(0.05, 0.25)) * horizon),
                factor=(float(rng.choice([2.0, 4.0, 8.0]))
                        if kind == SLOW else 1.0)))
        return FaultSchedule(faults)

    # -- boundary-side queries ----------------------------------------------
    #
    # ``since`` is the replica's last respawn time: a supervisor restart
    # consumes every fault at or before it, so a respawned replica is only
    # subject to faults injected AFTER it came back.

    def crashed(self, rid: int, now: float, since: float = -np.inf) -> bool:
        return any(f.kind == CRASH and since < f.t <= now
                   for f in self.faults if f.replica == rid)

    def crash_times(self, rid: int) -> tuple[float, ...]:
        return tuple(f.t for f in self.faults
                     if f.replica == rid and f.kind == CRASH)

    def stalled(self, rid: int, now: float,
                since: float = -np.inf) -> bool:
        """True while a stall window covers ``now`` (heartbeats suppressed)."""
        return any(f.kind == STALL and f.t > since and f.active(now)
                   for f in self.faults if f.replica == rid)

    def corrupts(self, rid: int, t_start: float,
                 since: float = -np.inf) -> bool:
        """True when a batch STARTED at ``t_start`` gets a corrupt response."""
        return any(f.kind == CORRUPT and f.t > since and f.active(t_start)
                   for f in self.faults if f.replica == rid)

    def perturb(self, rid: int, t_start: float, dt: float,
                since: float = -np.inf) -> tuple[float, bool]:
        """Fault-adjusted service time for a batch started at ``t_start``.

        Returns ``(dt_adjusted, completes)``: slow faults active at the
        start multiply ``dt``, stall windows intersecting the (stretched)
        service interval add their full duration, and a crash anywhere in
        ``(since, t_start + dt_adjusted]`` means the batch NEVER completes
        (``completes=False`` — its requests are recovered by timeouts)."""
        out = float(dt)
        mine = [f for f in self.faults if f.replica == rid and f.t > since]
        for f in mine:
            if f.kind == SLOW and f.active(t_start):
                out *= f.factor
        for f in mine:     # stalls extend the already-stretched interval
            if f.kind == STALL and f.t < t_start + out and \
                    f.t + f.duration > t_start:
                out += f.duration
        for f in mine:
            if f.kind == CRASH and f.t <= t_start + out:
                return out, False
        return out, True


# --------------------------------------------------------------------------
# Response integrity (the corrupt fault's detection surface)
# --------------------------------------------------------------------------

def payload_checksum(dists: np.ndarray, ids: np.ndarray) -> int:
    """CRC over the result payload.  The replica computes it over the TRUE
    payload before the fault layer touches anything; the router recomputes
    it over what it received — a corrupt fault therefore surfaces as a
    checksum mismatch, exactly like a wire-level integrity check would.
    Host numpy arrays only: the port's replicas copy their results off the
    card first (and the checksum is only ever compared within one run)."""
    crc = zlib.crc32(np.ascontiguousarray(dists).tobytes())
    return zlib.crc32(np.ascontiguousarray(ids).tobytes(), crc)


def corrupt_payload(ids: np.ndarray) -> np.ndarray:
    """Deterministic payload corruption: flip the low bit of every id —
    plausible-looking, definitely-wrong results (the worst case for a
    router that trusts payloads)."""
    return np.asarray(ids) ^ 1


# --------------------------------------------------------------------------
# Wire faults (the transport shim's schedule)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WireDecision:
    """The shim's verdict for one frame: a fault kind (or None = deliver
    cleanly) plus the injected delay for ``slow``."""

    kind: str | None = None
    delay: float = 0.0


class WireSchedule:
    """Seeded per-frame wire-fault decisions, independent of wall time.

    A decision is a pure hash of ``(seed, worker, direction, seq)`` where
    ``seq`` is the per-(worker, direction) frame counter — NOT the clock —
    so the schedule commits to "the 7th frame up to worker 2 is dropped"
    before the run starts.  Two live runs under real-time jitter make the
    same per-frame calls, and the transcript a live run records needs to
    store only the decisions actually taken; nothing about the schedule
    depends on when a frame happened to be ready.

    Rates are independent probabilities per kind (their sum must stay
    <= 1; the remainder is clean delivery).  ``slow`` delays by
    ``slow_base + u * slow_jitter`` with ``u`` from the same hash, giving
    seeded latency jitter.
    """

    def __init__(self, *, seed: int = 0, drop: float = 0.0, dup: float = 0.0,
                 slow: float = 0.0, truncate: float = 0.0,
                 disconnect: float = 0.0, slow_base: float = 0.002,
                 slow_jitter: float = 0.004):
        rates = {WIRE_DROP: float(drop), WIRE_DUP: float(dup),
                 WIRE_SLOW: float(slow), WIRE_TRUNCATE: float(truncate),
                 WIRE_DISCONNECT: float(disconnect)}
        for kind, p in rates.items():
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{kind} rate must be in [0, 1], got {p}")
        if sum(rates.values()) > 1.0:
            raise ValueError(
                f"wire-fault rates must sum to <= 1, got {rates}")
        if slow_base < 0 or slow_jitter < 0:
            raise ValueError("slow_base / slow_jitter must be >= 0")
        self.seed = int(seed)
        self.rates = rates
        self.slow_base = float(slow_base)
        self.slow_jitter = float(slow_jitter)

    def __bool__(self) -> bool:
        return any(p > 0 for p in self.rates.values())

    def _uniforms(self, worker: int, direction: str,
                  seq: int) -> tuple[float, float]:
        h = hashlib.sha256(
            f"{self.seed}|{worker}|{direction}|{seq}".encode()).digest()
        u1 = int.from_bytes(h[:8], "big") / 2.0 ** 64
        u2 = int.from_bytes(h[8:16], "big") / 2.0 ** 64
        return u1, u2

    def decide(self, worker: int, direction: str, seq: int) -> WireDecision:
        """Fault verdict for frame ``seq`` in ``direction`` ("up" =
        master->worker, "down" = worker->master) on ``worker``'s link."""
        if direction not in ("up", "down"):
            raise ValueError(f"direction must be 'up' or 'down', "
                             f"got {direction!r}")
        u1, u2 = self._uniforms(worker, direction, seq)
        acc = 0.0
        for kind in WIRE_KINDS:
            acc += self.rates[kind]
            if u1 < acc:
                delay = (self.slow_base + u2 * self.slow_jitter
                         if kind == WIRE_SLOW else 0.0)
                return WireDecision(kind=kind, delay=delay)
        return WireDecision()

    # -- construction / reporting -------------------------------------------

    @staticmethod
    def parse(spec: str) -> "WireSchedule":
        """Parse a ``--wire-faults`` spec string.

        Grammar: comma-separated ``key=value`` — rate keys are the kinds
        (``drop=0.02,slow=0.1,disconnect=0.01``), ``slow_ms=BASE:JITTER``
        sets the slow-delay model in milliseconds, ``seed=N`` the decision
        seed.  Empty spec = no wire faults."""
        kw: dict = {}
        for item in filter(None, (p.strip() for p in spec.split(","))):
            try:
                key, val = item.split("=", 1)
            except ValueError as e:
                raise ValueError(
                    f"bad wire-fault item {item!r}: expected key=value") \
                    from e
            key = key.strip()
            if key == "seed":
                kw["seed"] = int(val)
            elif key == "slow_ms":
                base, _, jitter = val.partition(":")
                kw["slow_base"] = float(base) * 1e-3
                kw["slow_jitter"] = float(jitter or 0.0) * 1e-3
            elif key in WIRE_KINDS:
                kw[key] = float(val)
            else:
                raise ValueError(
                    f"unknown wire-fault key {key!r}; expected one of "
                    f"{WIRE_KINDS + ('slow_ms', 'seed')}")
        return WireSchedule(**kw)

    def to_dict(self) -> dict:
        """Transcript-header form: everything needed to reconstruct the
        schedule (replay never re-decides, but the header documents what
        the live run was subjected to)."""
        return {"seed": self.seed, **self.rates,
                "slow_base": self.slow_base, "slow_jitter": self.slow_jitter}
