"""The port's replica tier (``repro_torch.serving.faults``, ``health``,
``replica``, ``router``) against the JAX package's on the CPU.

Framework-free first: every case of the reference's ``tests/test_replica.py``
that does not test the checkpoint manager (``test_torch_checkpoint.py``
holds that one), on the reference test's numpy stub state with a FIXED
service-time model.  Then the port against the reference: both
``ReplicaServer``s run the same stub, trace, fault schedule and service
model, and their ``outcome_digest``s, assignment logs, stats and summaries
are byte-identical (no faults, each fault kind, all replicas dead, hedges
on and off, three seeded schedules); fault schedules and wire schedules
decide alike.  Then real engines: the reference's ``ServingState`` on its
own IVF+PQ+BBC index (4000 x 32) and the port's on that index carried
across by ``convert``: every outcome's rid, status, replica, retries,
hedged, finish time and k are equal and every id set is equal.  Respawn
restores the reference's predictor states from a verified checkpoint (each
package's pool reads the other's) and comes back cold from a corrupt one.
Last, the CLI.
"""
import copy
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import rerank as jrerank  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro.serving import admission as jadm  # noqa: E402
from repro.serving import batcher as jbt  # noqa: E402
from repro.serving import faults as jflt  # noqa: E402
from repro.serving import health as jhlt  # noqa: E402
from repro.serving import queue as jrq  # noqa: E402
from repro.serving import replica as jreplica  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro.serving import server as jsv  # noqa: E402
from repro.serving.state import ServingState as JServingState  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import rerank  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import admission as adm  # noqa: E402
from repro_torch.serving import batcher as bt  # noqa: E402
from repro_torch.serving import faults as flt  # noqa: E402
from repro_torch.serving import health as hlt  # noqa: E402
from repro_torch.serving import queue as rq  # noqa: E402
from repro_torch.serving import replica as replica_mod  # noqa: E402
from repro_torch.serving import router  # noqa: E402
from repro_torch.serving import server as sv  # noqa: E402
from repro_torch.serving.state import ServingState  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
D = 8
SVC = 0.01      # fixed per-batch service model (seconds)

PORT = SimpleNamespace(rq=rq, flt=flt, adm=adm, router=router,
                       replica=replica_mod, sv=sv, rerank=rerank)
REF = SimpleNamespace(rq=jrq, flt=jflt, adm=jadm, router=jrouter,
                      replica=jreplica, sv=jsv, rerank=jrerank)


def req(rid, k=16, arrival=0.0, deadline=None, n_probe=4, seed=None,
        pkg=PORT):
    rng = np.random.default_rng(rid if seed is None else seed)
    return pkg.rq.Request(rid=rid, q=rng.standard_normal(D).astype(np.float32),
                          k=k, n_probe=n_probe, arrival=arrival,
                          deadline=(arrival + 12 * SVC if deadline is None
                                    else deadline))


class _Result:
    def __init__(self, dists, ids):
        self.dists, self.ids = dists, ids


class _StubState:
    """Engine-free ServingState (the reference test's): deterministic ids
    from each row's query, ascending distances; numpy only, so both
    packages' replica tiers run it."""

    def __init__(self, n_centroids=16, m=8):
        rng = np.random.default_rng(0)
        self._cents = rng.standard_normal((n_centroids, D)) \
            .astype(np.float32)
        self.m = m
        self._pred = {}

    @property
    def centroids(self):
        return self._cents

    def fork(self, clone_engines=False, pred_states=None):
        twin = copy.copy(self)
        twin._pred = dict(pred_states or {})
        return twin

    def warmup(self, buckets):
        return self

    def pred_states(self):
        return dict(self._pred)

    @staticmethod
    def ids_for(q, k):
        base = int(abs(float(np.sum(q))) * 1e4) % 100_000
        return base + np.arange(k, dtype=np.int64)

    def run(self, batch):
        k = batch.bucket.k
        ids = np.stack([self.ids_for(q, k) for q in batch.queries])
        dists = np.tile(np.arange(k, dtype=np.float32), (len(ids), 1))
        return _Result(dists, ids)


def make_server(n_replicas=3, faults=None, ladder=None, batch=4,
                ceilings=(16, 32), hedge=True, retry=None, pkg=PORT, **kw):
    kw.setdefault("hb_interval", 0.005)
    kw.setdefault("respawn_delay", 0.02)
    kw.setdefault("max_wait", 4 * SVC)
    return pkg.router.ReplicaServer(
        _StubState(), n_replicas, ceilings, batch,
        retry=retry or pkg.router.RetryPolicy(timeout_mult=2.0),
        hedge=pkg.router.HedgePolicy(enabled=hedge, slack_mult=6.0),
        ladder=ladder, faults=faults,
        service_time_fn=lambda bucket: SVC, **kw)


def make_trace(n, rate=200.0, seed=5, pkg=PORT, **kw):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate, n))
    return [req(i, arrival=float(times[i]), pkg=pkg, **kw) for i in range(n)]


def conserved(outcomes, trace):
    assert len(outcomes) == len(trace)
    assert [o.request.rid for o in outcomes] == \
        sorted(r.rid for r in trace)
    s = sv.summarize(outcomes)
    assert s["conserved"], s
    return s


# ------------------------- request validation -------------------------------

@pytest.mark.parametrize("kw", [
    dict(k=0), dict(k=-3), dict(n_probe=0), dict(n_probe=-1),
    dict(deadline=float("nan")), dict(deadline=float("inf")),
    dict(deadline=-0.5), dict(arrival=float("nan")),
])
def test_request_validates_at_construction(kw):
    with pytest.raises(ValueError):
        req(0, **kw)


def test_request_degraded_flags():
    r = req(0, k=32, n_probe=8)
    assert not r.degraded
    assert r.k_capped(64) is r and r.n_probe_capped(8) is r
    capped = r.k_capped(16).n_probe_capped(4)
    assert (capped.k, capped.n_probe) == (16, 4)
    assert (capped.k_requested, capped.n_probe_requested) == (32, 8)
    assert capped.degraded
    assert capped.k_capped(8).k_requested == 32


# ------------------------------ fault taxonomy ------------------------------

def test_fault_spec_parse_and_validation():
    sched = flt.FaultSchedule.parse(
        "crash@1:t=0.5; stall@2:t=1.0,dur=0.4;"
        "slow@0:t=0.2,dur=1.0,factor=4;corrupt@3:t=0.8,dur=0.3")
    assert [f.kind for f in sched.faults] == \
        ["slow", "crash", "corrupt", "stall"]       # sorted by time
    assert sched.crashed(1, now=0.6) and not sched.crashed(1, now=0.4)
    for bad in ("crash@1", "nap@1:t=0.5", "stall@1:t=1.0",
                "slow@0:t=0.2,dur=1.0,factor=0.5",
                "crash@1:t=0.5,bogus=2"):
        with pytest.raises(ValueError):
            flt.FaultSchedule.parse(bad)


def test_fault_seeded_is_deterministic():
    a = flt.FaultSchedule.seeded(np.random.default_rng(3), 4, 10.0, 6)
    b = flt.FaultSchedule.seeded(np.random.default_rng(3), 4, 10.0, 6)
    assert a.faults == b.faults and len(a) == 6


def test_perturb_semantics():
    sched = flt.FaultSchedule([
        flt.Fault(t=1.0, replica=0, kind=flt.SLOW, duration=1.0, factor=4.0),
        flt.Fault(t=5.0, replica=0, kind=flt.STALL, duration=0.5),
        flt.Fault(t=9.0, replica=0, kind=flt.CRASH),
    ])
    assert sched.perturb(0, 1.5, 0.1) == (0.4, True)     # slow: 4x
    assert sched.perturb(0, 3.0, 0.1) == (0.1, True)     # outside window
    dt, ok = sched.perturb(0, 4.8, 0.4)                  # stall overlaps
    assert ok and dt == pytest.approx(0.9)
    assert sched.perturb(0, 8.95, 0.2)[1] is False       # crash mid-service
    assert sched.perturb(1, 8.95, 0.2) == (0.2, True)    # other replica
    # a respawn consumes every fault at or before it
    assert sched.perturb(0, 8.95, 0.2, since=9.0) == (0.2, True)
    assert sched.crashed(0, 9.5, since=9.0) is False


def test_payload_checksum_catches_corruption():
    dists = np.arange(8, dtype=np.float32).reshape(2, 4)
    ids = np.arange(8, dtype=np.int64).reshape(2, 4)
    resp = replica_mod.ReplicaResponse(dists, ids,
                                       flt.payload_checksum(dists, ids))
    assert resp.verified()
    bad = replica_mod.ReplicaResponse(dists, flt.corrupt_payload(ids),
                                      resp.checksum)
    assert not bad.verified()
    assert not np.array_equal(bad.ids, ids)
    # the same CRC as the reference's over the same host arrays
    assert resp.checksum == jflt.payload_checksum(dists, ids)


# --------------------------------- health -----------------------------------

def test_health_transitions():
    hv = hlt.HealthView(2, hb_interval=0.1, miss_factor=3.0,
                        anomaly_factor=3.0)
    hv.start(0.0)
    assert hv.status(0, 0.2) == hlt.HEALTHY
    assert hv.status(0, 0.31) == hlt.DOWN                # missed 3 beats
    hv.beat(0, 0.5)
    assert hv.status(0, 0.6) == hlt.HEALTHY
    for _ in range(6):                                   # anomaly EMA -> 8x
        hv.observe(1, 8 * SVC, baseline=SVC)
    hv.beat(1, 0.5)
    assert hv.status(1, 0.55) == hlt.SUSPECT
    assert hv.healthy(0.55) == [0] and hv.alive(0.55) == [0, 1]
    hv.reset(1, 0.6)                                     # respawn: history gone
    assert hv.status(1, 0.65) == hlt.HEALTHY


def test_health_on_an_injected_clock_equals_reference():
    """The wall-clock form (no ``now``, the port's own clock) walks the
    reference's transitions on the reference's clock."""
    from repro.serving.clock import ManualClock as JClock
    from repro_torch.serving.clock import ManualClock
    views = []
    for h, clock in ((hlt, ManualClock()), (jhlt, JClock())):
        hv = h.HealthView(3, hb_interval=0.05, clock=clock)
        hv.start()
        seen = []
        for step in range(12):
            clock.advance(0.03)
            if step % 3:
                hv.beat(step % 3)
            hv.observe(2, (1 + step) * SVC, SVC)
            seen.append((hv.healthy(), hv.alive(), hv.anomaly(2)))
        views.append(seen)
    assert views[0] == views[1]


# ------------------------------ respawn + checkpoints -----------------------

def _flip_last_byte(path):
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        byte = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0xFF]))


def _latest_leaf(ckpt_root):
    step_dir = os.path.join(ckpt_root, sorted(os.listdir(ckpt_root))[-1])
    leaf = sorted(p for p in os.listdir(step_dir) if p.endswith(".npy"))[0]
    return os.path.join(step_dir, leaf)


def test_respawn_restores_pred_state_and_falls_back_cold(tmp_path):
    bucket = bt.ShapeBucket(k=16, batch=4, n_probe=4)
    pool = replica_mod.ReplicaPool(_StubState(), 2, (16, 32), 4,
                                   service_est=lambda b: SVC,
                                   checkpoint_dir=str(tmp_path),
                                   checkpoint_every=1)
    state = rerank.predictor_init(8)
    state = state._replace(ema=state.ema + 3.5)
    pool[0].state._pred[bucket] = state
    pool[0].served_batches = 1
    assert pool.maybe_checkpoint(0)
    # intact checkpoint: the respawned replica resumes the warmed state
    rep = pool.respawn(0, now=1.0)
    assert rep.respawned_at == 1.0 and rep.batcher.pending() == 0
    got = rep.state._pred[bucket]
    assert torch.equal(got.ema, state.ema)
    # corrupt the leaf: the next respawn must come up cold, not garbled
    _flip_last_byte(_latest_leaf(os.path.join(str(tmp_path), "replica_0")))
    rep = pool.respawn(0, now=2.0)
    assert rep.state._pred == {}


def test_respawn_checkpoints_equal_reference_both_ways(tmp_path):
    """The same warmed predictor states in both packages' pools: each
    respawn restores them bit for bit, from its own checkpoint and from the
    other package's (the files and checksums are the same), and a flipped
    byte sends both back cold."""
    buckets = [bt.ShapeBucket(k=16, batch=4, n_probe=4),
               bt.ShapeBucket(k=32, batch=4, n_probe=4)]
    jbuckets = [jbt.ShapeBucket(k=b.k, batch=b.batch, n_probe=b.n_probe)
                for b in buckets]
    rng = np.random.default_rng(7)
    emas = [rng.random(9).astype(np.float32) for _ in buckets]
    weights = [np.float32(0.36), np.float32(0.8)]
    pools = {}
    for name, pkg, bks in (("port", PORT, buckets), ("ref", REF, jbuckets)):
        pool = pkg.replica.ReplicaPool(
            _StubState(), 2, (16, 32), 4, service_est=lambda b: SVC,
            checkpoint_dir=str(tmp_path / name), checkpoint_every=1)
        for b, e, w in zip(bks, emas, weights):
            if pkg is PORT:
                st = rerank.PredictorState(torch.from_numpy(e.copy()),
                                           torch.tensor(w))
            else:
                st = jrerank.PredictorState(jnp.asarray(e), jnp.asarray(w))
            pool[1].state._pred[b] = st
        pool[1].served_batches = 1
        assert pool.maybe_checkpoint(1)
        pools[name] = pool

    def restored(pool):
        got = pool.respawn(1, now=1.0).state._pred
        return {(b.k, b.n_probe): (np.asarray(s.ema), np.asarray(s.weight))
                for b, s in got.items()}

    want = restored(pools["ref"])
    assert len(want) == 2
    for name in ("port", "ref"):
        # each pool reads the other package's checkpoint directory too
        for src in ("port", "ref"):
            pools[name]._ckpt_dir = str(tmp_path / src)
            pools[name]._managers = {}
            got = restored(pools[name])
            assert got.keys() == want.keys()
            for key in want:
                for a, b in zip(got[key], want[key]):
                    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    _flip_last_byte(_latest_leaf(str(tmp_path / "port" / "replica_1")))
    for name in ("port", "ref"):
        pools[name]._ckpt_dir = str(tmp_path / "port")
        pools[name]._managers = {}
        assert pools[name].respawn(1, now=2.0).state._pred == {}


# --------------------------------- routing ----------------------------------

def test_router_affinity_prefers_warm_working_set():
    srv = make_server(n_replicas=3)
    srv.health.start(0.0)
    r0 = req(0)
    top = srv.router.top_centroids(r0.q)
    srv.pool[2].note_probed(top, 0.0)
    dec = srv.router.route(r0, 0.001)
    assert (dec.replica, dec.reason) == (2, "affinity")
    # cold working sets everywhere: deterministic least-loaded (lowest rid)
    dec = srv.router.route(req(1, seed=99), 0.001)
    assert dec.reason == "least-loaded" and dec.replica == 0


def test_router_brownout_when_nothing_healthy():
    srv = make_server(n_replicas=2, hb_interval=0.1)
    srv.health.start(0.0)
    for _ in range(6):                  # both replicas anomaly-flagged
        srv.health.observe(0, 8 * SVC, SVC)
        srv.health.observe(1, 8 * SVC, SVC)
    dec = srv.router.route(req(0), 0.05)
    assert dec.brownout and dec.reason == "brownout"
    # nothing alive at all: route declines
    srv2 = make_server(n_replicas=2, hb_interval=0.001)
    srv2.health.start(0.0)
    assert srv2.router.route(req(0), 10.0) is None


def test_top_centroids_equal_reference():
    """Routing keys: the same float32 sums and stable argsort as the
    reference, ties included (duplicate centroids)."""
    rng = np.random.default_rng(11)
    cents = rng.standard_normal((40, D)).astype(np.float32)
    cents[7] = cents[3]                                  # an exact tie
    a, b = make_server(), make_server(pkg=REF)
    a.router.centroids = b.router.centroids = cents
    for i in range(64):
        q = (cents[3] if i == 0 else
             rng.standard_normal(D).astype(np.float32))
        assert np.array_equal(a.router.top_centroids(q),
                              b.router.top_centroids(q))


# ------------------------- end-to-end fault scenarios -----------------------

def test_fault_free_pool_serves_everything():
    srv = make_server(n_replicas=3)
    trace = make_trace(24)
    out = srv.run_trace(trace)
    s = conserved(out, trace)
    assert s["completed"] == 24 and s["failed"] == 0 and s["shed"] == 0
    for o in out:
        want = _StubState.ids_for(o.request.q, o.bucket.k)[: o.k_effective]
        got = np.sort(o.ids)
        np.testing.assert_array_equal(got, np.sort(want))


def test_crash_fault_recovers_without_losing_requests():
    trace = make_trace(32)
    horizon = max(r.arrival for r in trace)
    faults = flt.FaultSchedule(
        [flt.Fault(t=0.4 * horizon, replica=1, kind=flt.CRASH)])
    srv = make_server(n_replicas=3, faults=faults)
    out = srv.run_trace(trace)
    s = conserved(out, trace)
    assert s["completed"] == 32 and s["failed"] == 0
    assert s["retried"] + s["hedged"] > 0        # recovery actually happened
    assert srv.stats["respawns"] >= 1


def test_corrupt_fault_is_detected_and_retried():
    trace = make_trace(16, rate=400.0)
    horizon = max(r.arrival for r in trace)
    faults = flt.FaultSchedule([flt.Fault(
        t=0.0, replica=0, kind=flt.CORRUPT, duration=2 * horizon + 1.0)])
    srv = make_server(n_replicas=2, faults=faults, hedge=False)
    out = srv.run_trace(trace)
    s = conserved(out, trace)
    assert srv.stats["corrupt_detected"] > 0
    assert s["completed"] == 16 and s["failed"] == 0
    # every completion came from the clean replica with TRUE ids
    for o in out:
        assert o.replica == 1
        want = _StubState.ids_for(o.request.q, o.bucket.k)[: o.k_effective]
        np.testing.assert_array_equal(np.sort(o.ids), np.sort(want))


def test_all_replicas_dead_terminates_failed_not_hung():
    trace = make_trace(8, rate=400.0)
    faults = flt.FaultSchedule(
        [flt.Fault(t=0.0, replica=r, kind=flt.CRASH) for r in range(2)])
    srv = make_server(n_replicas=2, faults=faults, respawn_delay=999.0)
    out = srv.run_trace(trace)
    s = conserved(out, trace)
    assert s["failed"] == 8 and s["completed"] == 0
    assert all(o.ids is None for o in out)


def test_degrade_ladder_caps_under_overload():
    ladder = adm.DegradeLadder(((1.0, 16, None), (2.5, 16, 2)))
    srv = make_server(n_replicas=2, ladder=ladder, batch=4)
    trace = [req(i, k=32, arrival=i * 1e-6, deadline=0.5)
             for i in range(40)]
    out = srv.run_trace(trace)
    s = conserved(out, trace)
    degraded = [o for o in out if o.status == sv.DEGRADED]
    assert degraded, s
    assert all(o.request.k_requested == 32 and o.k_effective == 16
               for o in degraded if o.request.k_requested)
    narrowed = [o for o in degraded if o.request.n_probe_requested]
    assert all(o.request.n_probe == 2 for o in narrowed)


def test_stall_marks_suspect_and_brownout_still_serves():
    trace = make_trace(24, rate=300.0)
    horizon = max(r.arrival for r in trace)
    # both replicas slowed 8x for the whole run: anomaly EMAs cross the
    # 3x threshold, nothing is healthy, yet brownout keeps serving
    faults = flt.FaultSchedule([
        flt.Fault(t=0.0, replica=r, kind=flt.SLOW,
                  duration=horizon + 10.0, factor=8.0)
        for r in range(2)])
    srv = make_server(n_replicas=2, faults=faults, respawn_delay=999.0,
                      hb_interval=0.05)
    out = srv.run_trace(trace)
    s = conserved(out, trace)
    assert s["completed"] == 24
    assert srv.stats["brownouts"] > 0
    assert any(o.status == sv.DEGRADED for o in out)     # brownout flag


def test_hedge_fires_and_first_response_wins():
    trace = make_trace(12, rate=50.0)
    horizon = max(r.arrival for r in trace)
    # replica 0 stalls hard mid-run: requests stuck there are recovered by
    # hedges to replica 1 well before their timeouts
    faults = flt.FaultSchedule([flt.Fault(
        t=0.0, replica=0, kind=flt.STALL, duration=horizon + 5.0)])
    srv = make_server(n_replicas=2, faults=faults, respawn_delay=999.0,
                      hb_interval=0.2)    # liveness never flags: hedges only
    out = srv.run_trace(trace)
    s = conserved(out, trace)
    assert s["completed"] == 12 and s["failed"] == 0
    assert srv.stats["hedges_sent"] > 0 and srv.stats["hedges_won"] > 0
    assert all(o.replica == 1 for o in out if o.hedged)


def _digest_run(seed, n_replicas, n_req, fault_seed, pkg=PORT):
    trace = make_trace(n_req, seed=seed, pkg=pkg)
    horizon = max(r.arrival for r in trace)
    faults = pkg.flt.FaultSchedule.seeded(
        np.random.default_rng(fault_seed), n_replicas, horizon, n_faults=3)
    srv = make_server(n_replicas=n_replicas, faults=faults, pkg=pkg)
    out = srv.run_trace(trace)
    return out, srv, trace


def test_seeded_fault_run_replays_byte_identical():
    o1, s1, trace = _digest_run(5, 3, 24, 11)
    o2, s2, _ = _digest_run(5, 3, 24, 11)
    assert router.outcome_digest(o1) == router.outcome_digest(o2)
    assert s1.assignments == s2.assignments
    assert json.dumps(sv.summarize(o1), sort_keys=True) == \
        json.dumps(sv.summarize(o2), sort_keys=True)
    conserved(o1, trace)


# ------------------- the port against the reference (stub) ------------------

def _schedule(name, pkg, horizon, n_replicas):
    F = pkg.flt
    if name == "none":
        return None
    if name == "crash":
        return F.FaultSchedule([F.Fault(t=0.4 * horizon, replica=1,
                                        kind=F.CRASH)])
    if name == "corrupt":
        return F.FaultSchedule([F.Fault(t=0.0, replica=0, kind=F.CORRUPT,
                                        duration=2 * horizon + 1.0)])
    if name == "stall":
        return F.FaultSchedule([F.Fault(t=0.2 * horizon, replica=0,
                                        kind=F.STALL,
                                        duration=horizon + 5.0)])
    if name == "slow":
        return F.FaultSchedule([F.Fault(t=0.0, replica=r, kind=F.SLOW,
                                        duration=horizon + 10.0, factor=8.0)
                                for r in range(n_replicas)])
    if name == "all_dead":
        return F.FaultSchedule([F.Fault(t=0.0, replica=r, kind=F.CRASH)
                                for r in range(n_replicas)])
    if name.startswith("hedge"):
        return F.FaultSchedule.parse(
            f"stall@0:t=0.0,dur={horizon + 5.0};"
            f"crash@2:t={0.5 * horizon};"
            f"corrupt@1:t={0.3 * horizon},dur={0.2 * horizon}")
    seed = int(name.removeprefix("seeded"))
    return F.FaultSchedule.seeded(np.random.default_rng(seed), n_replicas,
                                  horizon, n_faults=4)


def _run_both(name, n_req=28, n_replicas=3, **kw):
    out = {}
    for pkg in (PORT, REF):
        trace = make_trace(n_req, seed=9, pkg=pkg, rate=300.0)
        horizon = max(r.arrival for r in trace)
        faults = _schedule(name, pkg, horizon, n_replicas)
        extra = dict(kw)
        if name == "all_dead":
            extra["respawn_delay"] = 999.0
        if name.startswith("hedge"):
            extra.update(hedge=name == "hedge_on", hb_interval=0.2)
        srv = make_server(n_replicas=n_replicas, faults=faults, pkg=pkg,
                          **extra)
        out[pkg is PORT] = (srv, srv.run_trace(trace), trace)
    return out[True], out[False]


@pytest.mark.parametrize("name", ["none", "crash", "corrupt", "stall",
                                  "slow", "all_dead", "hedge_on",
                                  "hedge_off", "seeded3", "seeded11",
                                  "seeded29"])
def test_outcome_digest_equals_reference(name):
    """Same stub, trace, fault schedule and service model: the port's
    decisions are the reference's, byte for byte (digest, assignment log,
    stats, summary), and either package's digest function reads the
    other's outcomes alike."""
    (ps, po, ptrace), (js, jo, _) = _run_both(name)
    conserved(po, ptrace)
    assert router.outcome_digest(po) == jrouter.outcome_digest(jo)
    assert jrouter.outcome_digest(po) == router.outcome_digest(po)
    assert ps.assignments == js.assignments
    assert ps.stats == js.stats
    assert json.dumps(sv.summarize(po), sort_keys=True) == \
        json.dumps(jsv.summarize(jo), sort_keys=True)
    if name == "corrupt":
        assert ps.stats["corrupt_detected"] > 0
    if name == "crash":
        assert ps.stats["respawns"] >= 1
    if name == "hedge_on":
        assert ps.stats["hedges_sent"] > 0
    if name == "hedge_off":
        assert ps.stats["hedges_sent"] == 0


SPECS = ["crash@1:t=0.5", "stall@2:t=1.0,dur=0.4",
         "crash@1:t=0.5; stall@2:t=1.0,dur=0.4;"
         "slow@0:t=0.2,dur=1.0,factor=4;corrupt@3:t=0.8,dur=0.3",
         "crash@1:t=0.1;corrupt@2:t=0.05,dur=0.2;slow@3:t=0.0,dur=1.0,"
         "factor=4", "corrupt@0:t=0,dur=5;crash@0:t=2;stall@0:t=1,dur=0.5"]


def _facts(sched):
    return [(f.t, f.replica, f.kind, f.duration, f.factor)
            for f in sched.faults]


@pytest.mark.parametrize("spec", SPECS + [f"seeded{s}" for s in range(4)])
def test_fault_schedule_equals_reference(spec):
    """``parse``/``seeded`` build the reference's schedule, and every
    boundary query (``perturb``, ``crashed``, ``stalled``, ``corrupts``)
    answers alike over a grid of replicas, instants, service times and
    respawn times."""
    if spec.startswith("seeded"):
        seed = int(spec.removeprefix("seeded"))
        mine = flt.FaultSchedule.seeded(np.random.default_rng(seed), 4, 3.0,
                                        n_faults=6)
        ref = jflt.FaultSchedule.seeded(np.random.default_rng(seed), 4, 3.0,
                                        n_faults=6)
    else:
        mine, ref = flt.FaultSchedule.parse(spec), \
            jflt.FaultSchedule.parse(spec)
    assert _facts(mine) == _facts(ref)
    for rid in range(4):
        assert mine.crash_times(rid) == ref.crash_times(rid)
        for t in np.linspace(0.0, 3.0, 31):
            for since in (-np.inf, 0.5, 1.5):
                assert mine.crashed(rid, t, since) == ref.crashed(rid, t,
                                                                  since)
                assert mine.stalled(rid, t, since) == ref.stalled(rid, t,
                                                                  since)
                assert mine.corrupts(rid, t, since) == ref.corrupts(rid, t,
                                                                    since)
                for dt in (0.01, 0.3):
                    assert mine.perturb(rid, t, dt, since) == \
                        ref.perturb(rid, t, dt, since)


@pytest.mark.parametrize("spec", ["", "drop=0.1", "seed=3,drop=0.02,dup=0.01,"
                                  "slow=0.2,slow_ms=2:8,truncate=0.03,"
                                  "disconnect=0.02", "seed=11,slow=0.5"])
def test_wire_schedule_equals_reference(spec):
    mine, ref = flt.WireSchedule.parse(spec), jflt.WireSchedule.parse(spec)
    assert mine.to_dict() == ref.to_dict() and bool(mine) == bool(ref)
    for worker in range(3):
        for direction in ("up", "down"):
            for seq in range(200):
                a = mine.decide(worker, direction, seq)
                b = ref.decide(worker, direction, seq)
                assert (a.kind, a.delay) == (b.kind, b.delay)
    for bad in ("drop=1.5", "drop=0.7,dup=0.6", "bogus=1", "drop"):
        with pytest.raises(ValueError):
            flt.WireSchedule.parse(bad)


# ----------------------------- real engines ---------------------------------

N, DR = 4000, 32
CEILS = (64, 128)
BATCH = 4
N_PROBE = 8
REAL_SPEC = ("crash@1:t=0.06;corrupt@2:t=0.0,dur=0.4;"
             "slow@0:t=0.0,dur=1.0,factor=3")


@pytest.fixture(scope="module")
def real():
    rng = np.random.default_rng(0)
    x = synthetic.clustered(rng, N, DR, n_centers=32)
    qs = synthetic.queries_from(rng, x, 32)
    jpq = jsearch.build_pq_index(jax.random.key(0), jnp.asarray(x), 32,
                                 n_iter=3)
    tpq, _ = convert.pq_index_from_numpy({
        "ivf_centroids": np.asarray(jpq.ivf.centroids),
        "member_ids": np.asarray(jpq.ivf.member_ids),
        "member_valid": np.asarray(jpq.ivf.member_valid),
        "cluster_sizes": np.asarray(jpq.ivf.cluster_sizes),
        "vectors": np.asarray(jpq.vectors),
        "pq_centroids": np.asarray(jpq.pq.centroids),
        "codes": np.asarray(jpq.codes)}, device="cpu")
    return dict(x=x, qs=qs, jpq=jpq, tpq=tpq)


def _real_run(real, pkg, spec=REAL_SPEC, device="cpu", state=None):
    if state is None:
        state = (ServingState(real["tpq"], device=device) if pkg is PORT
                 else JServingState(real["jpq"]))
    trace = pkg.rq.make_trace(np.random.default_rng(4), real["qs"],
                              (50, 120), rate=200.0, deadline=0.3,
                              n_probe=N_PROBE)
    srv = pkg.router.ReplicaServer(
        state, 3, CEILS, BATCH, faults=pkg.flt.FaultSchedule.parse(spec),
        service_time_fn=lambda b: 0.004 + b.k * 1e-5, max_wait=0.03,
        hb_interval=0.01, respawn_delay=0.02)
    return srv, srv.run_trace(trace), state


def _rows(outcomes):
    return [(o.request.rid, o.status, o.replica, o.retries, bool(o.hedged),
             round(o.t_done, 9), o.k_effective) for o in outcomes]


def test_real_engines_match_reference(real):
    """Both packages' tiers over the same IVF+PQ+BBC index, trace, fault
    schedule and service model: the same outcomes (rid, status, replica,
    retries, hedged, finish time, k) and the same id set per request;
    each completed request's ids are a direct engine call's (parity)."""
    ps, po, pstate = _real_run(real, PORT)
    js, jo, _ = _real_run(real, REF)
    assert _rows(po) == _rows(jo)
    assert ps.assignments == js.assignments and ps.stats == js.stats
    assert ps.stats["corrupt_detected"] > 0 and ps.stats["respawns"] >= 1
    assert ps.stats["retries_sent"] + ps.stats["hedges_sent"] > 0
    for a, b in zip(po, jo):
        assert (a.ids is None) == (b.ids is None)
        if a.ids is not None:
            assert set(a.ids.tolist()) == set(np.asarray(b.ids).tolist())
    assert sv.summarize(po)["conserved"]
    parity, checked = sv.parity_vs_direct(pstate, po)
    assert parity == 1.0 and checked == sum(o.completed for o in po)


def test_real_engines_replay_identical(real):
    """Two runs of the port on the same inputs give the same digest, and a
    respawned replica's engines are new objects over the same tensors."""
    s1, o1, state = _real_run(real, PORT)
    _, o2, _ = _real_run(real, PORT)
    assert router.outcome_digest(o1) == router.outcome_digest(o2)
    respawned = s1.pool[1].state
    assert respawned._engines is not state._engines
    for key, eng in respawned._engines.items():
        base = state._engines[key]
        assert eng is not base and eng.layout is base.layout


@pytest.mark.cuda
def test_cuda_replica_digest_equals_cpu(real):
    """On a card: the same run over the card's engines gives the CPU's
    outcome digest (the estimates, and so the ids, agree to the bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    _, oc, _ = _real_run(real, PORT)
    _, og, _ = _real_run(real, PORT, device="cuda")
    assert router.outcome_digest(og) == router.outcome_digest(oc)


# ---------------------------------- the CLI ---------------------------------

SMALL = ["--n", "4000", "--d", "32", "--n-clusters", "32", "--n-probe", "8",
         "--queries", "24", "--k-choices", "50,120", "--max-batch", "4",
         "--mode", "async"]
FAULTS = ["--replicas", "3", "--faults", "crash@1:t=0.05"]


def test_cli_replicas_prints_the_reference_summary(capsys, tmp_path):
    """``serve --device cpu --mode async --replicas 3 --faults ...``: the
    JAX CLI's summary keys (plus ``device``), conserved, parity 1.0, a
    respawn in the fault stats and the hand-tuned provenance when no point
    store exists."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"),
               REPRO_TUNED_POINTS=str(tmp_path / "none.json"))
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.serve", *SMALL, *FAULTS,
         "--check-parity"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=600)
    assert ref.returncode == 0, ref.stderr[-2000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    os.environ["REPRO_TORCH_TUNED_POINTS"] = str(tmp_path / "none.json")
    try:
        assert serve.main(["--device", "cpu", *SMALL, *FAULTS,
                           "--check-parity"]) == 0
    finally:
        del os.environ["REPRO_TORCH_TUNED_POINTS"]
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want) + ["device"]
    assert got["conserved"] and got["requests"] == 24
    assert got["parity"] == 1.0 and got["parity_checked"] > 0
    assert got["replicas"] == 3 and got["faults"] == "crash@1:t=0.05"
    assert got["fault_stats"]["respawns"] >= 1
    assert set(got["fault_stats"]) == set(want["fault_stats"])
    assert set(got["operating_points"].values()) == {"hand-tuned fallback"}


def test_cli_faults_need_replicas():
    with pytest.raises(SystemExit, match="requires --replicas"):
        serve.main(["--device", "cpu", *SMALL, "--faults", "crash@1:t=0.05"])
