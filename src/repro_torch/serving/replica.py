"""Replica: one engine-wrapping serving unit inside the multi-replica tier.

Each replica owns a ``ServingState`` FORK: the (immutable) built engines
are shared pool-wide via ``ServingState.fork()``, but every replica holds
its own per-bucket ``PredictorState``s, so the tau predictor self-tunes on
the traffic slice the affinity router sends THIS replica; plus its own
``MicroBatcher`` lanes, a single-executor service model (one batch in
flight at a time) and a decayed **probed-centroid working set** the router
scores affinity against.

Fault injection happens HERE, at the service boundary (``Replica.serve``):
the replica consults the ``FaultSchedule`` for slowdowns, stalls, crashes
and payload corruption, and the router upstream sees only observable
consequences.  Responses carry an integrity checksum computed over the
true payload (host numpy copies of the engine's result) BEFORE corruption
is applied, so a corrupt fault is detectable the way a wire checksum would
make it.

``ReplicaPool`` owns construction, crash respawn (a respawned replica is a
fresh process: new ``ServingState`` fork via ``SearchEngine.replica_clone``,
cleared queue, cold health) and the predictor-state checkpoint loop: when a
checkpoint directory is configured, each replica's per-bucket predictor
states are saved through ``checkpoint.manager.CheckpointManager`` (content
checksummed) and a respawn restores the latest verified checkpoint,
falling back to cold states on ``CorruptCheckpointError`` instead of
resuming from garbage.

The port of the JAX package's ``repro.serving.replica``; the engine call
is asynchronous on the card, so ``serve`` waits for it before it reads the
host clock or the result.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import (CheckpointManager,
                                            CorruptCheckpointError)
from repro_torch.core import rerank
from repro_torch.ingest import drift as drift_mod
from repro_torch.serving import faults as flt
from repro_torch.serving.batcher import Batch, MicroBatcher, ShapeBucket
from repro_torch.serving.state import ServingState


class ReplicaResponse(NamedTuple):
    """One batch response as received by the router."""

    dists: np.ndarray        # (B, bucket.k)
    ids: np.ndarray          # (B, bucket.k)
    checksum: int            # computed replica-side over the TRUE payload

    def verified(self) -> bool:
        return flt.payload_checksum(self.dists, self.ids) == self.checksum


def _pred_key(bucket: ShapeBucket) -> str:
    return f"k{bucket.k}_b{bucket.batch}_np{bucket.n_probe}"


def _wait(res) -> None:
    """Block until a result's tensors are computed (a no-op for host
    arrays and CPU tensors)."""
    for t in (res.dists, res.ids):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class WorkingSet:
    """Decayed probed-centroid working set: what is warm in one serving
    unit's caches and predictor.

    The reference shares it between its in-process :class:`Replica` and
    its transport tier's worker handles, so routing behaves identically
    whether the serving unit is a thread-on-a-timeline or a
    process-on-a-socket.  Weights decay exponentially with time constant
    ``decay`` seconds; entries below 1e-4 are dropped."""

    def __init__(self, decay: float = 2.0, t0: float = 0.0):
        self.decay = float(decay)
        self._ws: dict[int, float] = {}     # centroid id -> decayed weight
        self._t = float(t0)

    def _decay_to(self, now: float) -> None:
        dt = now - self._t
        if dt > 0:
            f = float(np.exp(-dt / max(self.decay, 1e-9)))
            self._ws = {c: w * f for c, w in self._ws.items() if w * f > 1e-4}
        self._t = now

    def note(self, cluster_ids: np.ndarray, now: float) -> None:
        """Fold a completed request/batch's probed centroids in."""
        self._decay_to(now)
        for c in np.asarray(cluster_ids).reshape(-1).tolist():
            self._ws[int(c)] = self._ws.get(int(c), 0.0) + 1.0

    def score(self, cluster_ids: np.ndarray, now: float) -> float:
        """Overlap between a query's top routed centroids and this set."""
        self._decay_to(now)
        return float(sum(self._ws.get(int(c), 0.0)
                         for c in np.asarray(cluster_ids).reshape(-1)))

    def reset(self, now: float) -> None:
        """Fresh process: the working set is gone."""
        self._ws = {}
        self._t = now


class Replica:
    """One serving replica: state fork + batcher lanes + working set."""

    def __init__(self, rid: int, state: ServingState, batcher: MicroBatcher,
                 *, ws_decay: float = 2.0):
        self.rid = rid
        self.state = state
        self.batcher = batcher
        self.ws_decay = float(ws_decay)     # working-set half-life-ish (s)
        self.fired: deque[Batch] = deque()  # assembled, waiting for executor
        self.in_flight: Batch | None = None
        self.busy_until_est = 0.0           # EMA-estimated completion time
        self.respawned_at = -np.inf         # last supervisor restart
        self.served_batches = 0
        self.ws = WorkingSet(decay=ws_decay)

    # -- the service boundary (fault injection lives here) -------------------

    def serve(self, batch: Batch, t_start: float,
              schedule: flt.FaultSchedule | None = None,
              service_time_fn: Callable[[ShapeBucket], float] | None = None,
              ) -> tuple[float | None, ReplicaResponse | None]:
        """Execute one batch; returns ``(t_done, response)``.

        ``t_done`` is the fault-adjusted completion instant, or None when a
        crash fault lands during service: the batch then never completes
        and its response is never materialized (the engine call is skipped
        when the service model makes the crash predictable up front).  A
        corrupt fault rewrites the payload AFTER the checksum is computed.
        Without ``service_time_fn`` the service time is the host clock
        around the engine call and the wait for the card to finish it."""
        if service_time_fn is not None:
            dt = service_time_fn(batch.bucket)
            if schedule is not None:
                dt, completes = schedule.perturb(
                    self.rid, t_start, dt, since=self.respawned_at)
                if not completes:
                    return None, None
            res = self.state.run(batch)
            _wait(res)
        else:
            w0 = time.perf_counter()
            res = self.state.run(batch)
            _wait(res)
            dt = time.perf_counter() - w0
            if schedule is not None:
                dt, completes = schedule.perturb(
                    self.rid, t_start, dt, since=self.respawned_at)
                if not completes:
                    return None, None
        dists = _host(res.dists)
        ids = _host(res.ids)
        resp = ReplicaResponse(dists=dists, ids=ids,
                               checksum=flt.payload_checksum(dists, ids))
        if schedule is not None and \
                schedule.corrupts(self.rid, t_start, since=self.respawned_at):
            resp = ReplicaResponse(dists=resp.dists,
                                   ids=flt.corrupt_payload(resp.ids),
                                   checksum=resp.checksum)
        self.served_batches += 1
        return t_start + dt, resp

    # -- load / affinity introspection (the router reads these) --------------

    def load(self) -> int:
        """Requests queued, fired-but-waiting, or in flight."""
        waiting = sum(b.n_real for b in self.fired)
        running = self.in_flight.n_real if self.in_flight else 0
        return self.batcher.pending() + waiting + running

    def note_probed(self, cluster_ids: np.ndarray, now: float) -> None:
        """Fold a completed batch's probed centroids into the decayed
        working set (what is warm in this replica's caches and predictor)."""
        self.ws.note(cluster_ids, now)

    def affinity(self, cluster_ids: np.ndarray, now: float) -> float:
        """Overlap score between a query's top routed centroids and this
        replica's recent working set."""
        return self.ws.score(cluster_ids, now)

    @property
    def generation(self) -> int:
        """Index generation this replica currently serves."""
        return self.state.generation

    def swap_state(self, state: ServingState) -> None:
        """Zero-downtime engine swap: re-point ONLY the state fork.

        Unlike ``reset`` (crash respawn), the batcher lanes, fired batches,
        the in-flight batch and the affinity working set all survive:
        requests queued before the swap execute against the new
        generation's engines on their normal schedule, so the roll sheds
        and fails nothing.  (The OLD state fork keeps the old generation's
        engine cache alive by reference until the last holder drops it:
        the copy-on-swap contract in ``ServingState.swap``.)"""
        self.state = state

    def reset(self, state: ServingState, now: float) -> None:
        """Crash respawn: fresh process; queue, executor and working set
        are gone; the (new) state fork carries whatever predictor states
        the checkpoint restore recovered."""
        self.state = state
        self.batcher.clear()
        self.fired.clear()
        self.in_flight = None
        self.busy_until_est = now
        self.respawned_at = now
        self.ws.reset(now)


def _release(state) -> None:
    """Drop a fork the pool replaced; a state without the hook (the
    reference's duck-typed contract) needs nothing."""
    release = getattr(state, "release", None)
    if release is not None:
        release()


class ReplicaPool:
    """N replicas over one shared engine-build cache, plus respawn."""

    def __init__(self, base: ServingState, n_replicas: int,
                 ceilings, batch: int, *,
                 service_est: Callable[[ShapeBucket], float],
                 slack_margin: float = 0.0, max_wait: float | None = None,
                 ws_decay: float = 2.0,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 1):
        if n_replicas < 1:
            raise ValueError(f"need >= 1 replica, got {n_replicas}")
        self.base = base
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self._ckpt_dir = checkpoint_dir
        self._managers: dict[int, CheckpointManager] = {}
        self._steps: dict[int, int] = {}
        # bucket-key registry so a respawn can rebuild {key: bucket} maps
        self._buckets: dict[str, ShapeBucket] = {}
        self.replicas = [
            Replica(rid, base.fork(),
                    MicroBatcher(ceilings, batch, service_est=service_est,
                                 slack_margin=slack_margin,
                                 max_wait=max_wait),
                    ws_decay=ws_decay)
            for rid in range(n_replicas)
        ]

    def __len__(self) -> int:
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    def __getitem__(self, rid: int) -> Replica:
        return self.replicas[rid]

    # -- predictor-state checkpointing ---------------------------------------

    def _manager(self, rid: int) -> CheckpointManager | None:
        if self._ckpt_dir is None:
            return None
        mgr = self._managers.get(rid)
        if mgr is None:
            mgr = CheckpointManager(
                os.path.join(self._ckpt_dir, f"replica_{rid}"), keep_last=2)
            self._managers[rid] = mgr
        return mgr

    def maybe_checkpoint(self, rid: int) -> bool:
        """Save replica ``rid``'s per-bucket predictor states every
        ``checkpoint_every`` completed batches (no-op without a configured
        directory).  Returns True when a checkpoint was written."""
        mgr = self._manager(rid)
        replica = self.replicas[rid]
        if mgr is None or \
                replica.served_batches % self.checkpoint_every != 0:
            return False
        states = replica.state.pred_states()
        for bucket in states:
            self._buckets[_pred_key(bucket)] = bucket
        tree = {_pred_key(b): s for b, s in states.items()}
        step = self._steps.get(rid, 0) + 1
        self._steps[rid] = step
        mgr.save(step, tree)
        return True

    def _restore_pred(self, rid: int) -> dict[ShapeBucket, object]:
        """Latest verified predictor checkpoint for ``rid`` as a
        {bucket: PredictorState} dict, on the base state's device; empty
        (cold) when there is no checkpoint or the checkpoint fails its
        content checksum."""
        mgr = self._manager(rid)
        if mgr is None or mgr.latest_step() is None:
            return {}
        device = getattr(self.base, "device", "cpu")
        like = {key: rerank.predictor_init(self.base.m, device)
                for key in sorted(self._buckets)}
        if not like:
            return {}
        try:
            tree, _ = mgr.restore(like)
        except (CorruptCheckpointError, KeyError, ValueError):
            # verified-or-cold: never resume from garbage
            return {}
        return {self._buckets[key]: state for key, state in tree.items()}

    # -- streaming-ingest rolling swap ---------------------------------------

    def rolling_swap(self, index, *, vectors=None, live=None, probe_qs=None,
                     drift_threshold: float = 0.25, warm_buckets=None,
                     on_step=None) -> dict[tuple[int, int], dict]:
        """Roll a rebuilt index through the pool one replica at a time with
        zero shed requests.

        ``base.swap`` replaces the shared engine-build cache with a NEW dict
        (copy-on-swap), so every replica's existing fork keeps serving the
        old generation untouched; each roll step then takes a fresh fork
        (sharing the new cache) and re-points exactly one replica via
        ``Replica.swap_state``: queues, fired batches and working sets
        survive, so nothing in flight is shed or failed.  ``warm_buckets``
        builds and warms the new generation's serving shapes BEFORE the
        first replica moves.

        Predictor warmth is tested per replica: warm states live in the
        REPLICA forks, so the pool probes each warm bucket once through the
        NEW engine (the probe histogram depends on the engine, not the
        replica) and runs the drift test against every replica's own EMA.
        Carried states move into the replica's new fork; drifted ones
        cold-reset.  ``on_step(rid)`` (when given) runs after each replica
        flips.  Returns the aggregate drift report ``{(k, n_probe): {"tv":
        max over replicas, "carried": all replicas, "replicas": [...]}}``."""
        self.base.swap(index, vectors=vectors, live=live, probe_qs=probe_qs,
                       drift_threshold=drift_threshold)
        if warm_buckets:
            self.base.warmup(warm_buckets)
        fresh: dict[tuple[int, int], object] = {}
        if self.base.tau_pred and probe_qs is not None:
            qs = torch.as_tensor(probe_qs, dtype=torch.float32).to(
                self.base.device)
            buckets = {b for r in self.replicas for b in r.state.pred_states()}
            for bucket in sorted(buckets):
                fresh[(bucket.k, bucket.n_probe)] = \
                    drift_mod.probe_histogram(self.base.engine(bucket), qs)
        report: dict[tuple[int, int], dict] = {}
        for rid, replica in enumerate(self.replicas):
            old_states = replica.state.pred_states()
            carried = {}
            for bucket, st in old_states.items():
                key = (bucket.k, bucket.n_probe)
                probe = fresh.get(key)
                if probe is None:
                    carried[bucket] = st     # no probe signal: keep warm
                    continue
                kept, tv, ok = drift_mod.carry_state(st, probe,
                                                     drift_threshold)
                carried[bucket] = kept
                entry = report.setdefault(
                    key, {"tv": 0.0, "carried": True, "replicas": []})
                entry["tv"] = max(entry["tv"], tv)
                entry["carried"] = entry["carried"] and ok
                entry["replicas"].append(
                    {"rid": rid, "tv": tv, "carried": ok})
            old = replica.state
            replica.swap_state(self.base.fork(pred_states=carried))
            _release(old)
            if on_step is not None:
                on_step(rid)
        self.base.drift_report = report
        return report

    # -- respawn -------------------------------------------------------------

    def respawn(self, rid: int, now: float) -> Replica:
        """Supervisor restart after a crash fault: fresh state fork (shared
        build artifacts via ``SearchEngine.replica_clone``), predictor
        states restored through the checksummed checkpoint path."""
        old = self.replicas[rid].state
        state = self.base.fork(clone_engines=True,
                               pred_states=self._restore_pred(rid))
        self.replicas[rid].reset(state, now)
        _release(old)
        return self.replicas[rid]
