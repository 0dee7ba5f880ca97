"""The port's single-process async serving (``repro_torch.serving`` and
``serve --mode async``) against the JAX package's on the CPU.

Config: the JAX package's serving test (``tests/test_serving.py``: N=4000,
D=32, 32 clusters, ceilings (64, 128), B=4, n_probe=8).  Scheduling is
held on seeded traces with a fixed service-time model, so it is exact: the
port's traces equal the reference's element by element, and on the same
trace the port's ``Server`` makes the reference's decisions request for
request (status, k, bucket, batch, finish time, shed set).  Results: each
completed request's id set equals the reference's on the same index
(carried across with ``convert``; PQ and IVF) and the port's own direct
engine call at its bucket (every method).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro.serving import queue as jqueue  # noqa: E402
from repro.serving import server as jserver  # noqa: E402
from repro.serving.state import ServingState as JServingState  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import rerank  # noqa: E402
from repro_torch.index import engine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import admission as adm  # noqa: E402
from repro_torch.serving import batcher as bt  # noqa: E402
from repro_torch.serving import clock  # noqa: E402
from repro_torch.serving import queue as rq  # noqa: E402
from repro_torch.serving import server as sv  # noqa: E402
from repro_torch.serving.state import ServingState  # noqa: E402

torch.set_num_threads(2)

N, D = 4000, 32
CEILS = (64, 128)
BATCH = 4
N_PROBE = 8


def req(rid, k=50, arrival=0.0, deadline=10.0, n_probe=N_PROBE, d=D):
    rng = np.random.default_rng(rid)
    return rq.Request(rid=rid, q=rng.standard_normal(d).astype(np.float32),
                      k=k, n_probe=n_probe, arrival=arrival,
                      deadline=deadline)


def _ivf_arrays(ji):
    return {"ivf_centroids": ji.ivf.centroids,
            "member_ids": ji.ivf.member_ids,
            "member_valid": ji.ivf.member_valid,
            "cluster_sizes": ji.ivf.cluster_sizes, "vectors": ji.vectors}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = synthetic.clustered(rng, N, D, n_centers=32)
    qs = synthetic.queries_from(rng, x, 48)
    jx = jnp.asarray(x)
    jpq = jsearch.build_pq_index(jax.random.key(0), jx, 32, n_iter=3)
    jrq = jsearch.build_rabitq_index(jax.random.key(0), jx, 32, n_iter=3)
    tpq, _ = convert.pq_index_from_numpy({k: np.asarray(v) for k, v in dict(
        _ivf_arrays(jpq), pq_centroids=jpq.pq.centroids,
        codes=jpq.codes).items()}, device="cpu")
    trq, _ = convert.rabitq_index_from_numpy({
        k: np.asarray(v) for k, v in dict(
            _ivf_arrays(jrq), rot=jrq.rq.rot, codes=jrq.rq.codes,
            norm_o=jrq.rq.norm_o, f_o=jrq.rq.f_o).items()}, device="cpu")
    return dict(x=x, qs=qs, jx=jx, jpq=jpq, jrq=jrq, tpq=tpq, trq=trq)


def _states(data, kind, **kw):
    """(JAX state, port state) over the same index of ``kind``."""
    if kind == "ivfpq":
        return (JServingState(data["jpq"], **kw),
                ServingState(data["tpq"], device="cpu", **kw))
    if kind == "ivf":
        return (JServingState(data["jpq"].ivf, vectors=data["jx"], **kw),
                ServingState(data["tpq"].ivf, vectors=data["x"],
                             device="cpu", **kw))
    return (JServingState(data["jrq"], **kw),
            ServingState(data["trq"], device="cpu", **kw))


def _direct_ids(state, o):
    direct = state.engine(o.bucket).search_batch(
        torch.from_numpy(np.asarray(o.request.q))[None])
    return sv.trim_topk(direct.dists[0].numpy(), direct.ids[0].numpy(),
                        o.k_effective)[1]


def _timeline(outcomes):
    return [(o.request.rid, o.status, o.k_effective,
             None if o.bucket is None else (o.bucket.k, o.bucket.batch,
                                            o.bucket.n_probe), o.t_done)
            for o in outcomes]


# ---------------------------- queue + traces --------------------------------

def test_queue_validates_and_drains():
    q = rq.RequestQueue()
    with pytest.raises(ValueError):
        q.push(req(0, k=0))
    with pytest.raises(ValueError):
        q.push(req(0, arrival=2.0, deadline=1.0))
    q.push(req(0, arrival=0.0))
    q.push(req(1, arrival=1.0, deadline=11.0))
    with pytest.raises(ValueError):           # arrivals must be ordered
        q.push(req(2, arrival=0.5, deadline=10.5))
    got = q.drain_arrived(0.5)
    assert [r.rid for r in got] == [0] and len(q) == 1
    assert q.peek().rid == 1 and q.pop().rid == 1 and not q


@pytest.mark.parametrize("bad", [dict(q=np.array([1.0, np.nan])),
                                 dict(q=np.zeros((2, 2))),
                                 dict(n_probe=0), dict(deadline=np.inf),
                                 dict(recall_target=1.5)])
def test_request_rejects_malformed_fields(bad):
    kw = dict(rid=0, q=np.ones(4, np.float32), k=5, n_probe=2, arrival=0.0,
              deadline=1.0)
    kw.update(bad)
    with pytest.raises(ValueError):
        rq.Request(**kw)


@pytest.mark.parametrize("pattern", ["poisson", "bursty"])
@pytest.mark.parametrize("ks", [(50, 120), 64])
def test_traces_equal_the_reference(pattern, ks):
    """Same numpy generator and seed: the reference's trace, element by
    element (arrival, deadline, k, query, recall target)."""
    qs = np.random.default_rng(3).standard_normal((64, D)).astype(np.float32)
    kw = dict(rate=100.0, deadline=0.5, n_probe=N_PROBE, pattern=pattern,
              recall_target=0.9)
    got = rq.make_trace(np.random.default_rng(7), qs, ks, **kw)
    want = jqueue.make_trace(np.random.default_rng(7), qs, ks, **kw)
    assert len(got) == len(want) == 64
    for g, w in zip(got, want):
        assert (g.rid, g.k, g.n_probe, g.arrival, g.deadline,
                g.recall_target) == (w.rid, w.k, w.n_probe, w.arrival,
                                     w.deadline, w.recall_target)
        np.testing.assert_array_equal(g.q, w.q)
    arr = np.array([r.arrival for r in got])
    assert np.all(np.diff(arr) >= 0)
    rq.RequestQueue(got)                      # ordered: the queue takes it


@pytest.mark.parametrize("seed", range(5))
def test_bursty_arrivals_stay_ordered(seed):
    t = rq.bursty_arrivals(np.random.default_rng(seed), 200, 300.0, burst=8)
    assert np.all(np.diff(t) >= 0)
    np.testing.assert_array_equal(t, jqueue.bursty_arrivals(
        np.random.default_rng(seed), 200, 300.0, burst=8))


def test_manual_clock_is_monotonic():
    c = clock.ManualClock(1.0)
    assert c.advance(0.5) == 1.5 and c.set(2.0) == 2.0 and c.now() == 2.0
    with pytest.raises(ValueError):
        c.set(1.0)
    with pytest.raises(ValueError):
        c.advance(-1.0)
    assert isinstance(clock.SystemClock(), clock.Clock)


# ---------------------------- shape buckets ---------------------------------

@pytest.mark.parametrize("k,ceiling", [(50, 64), (64, 64), (65, 128),
                                       (128, 128), (200, None)])
def test_bucket_of_picks_smallest_ceiling(k, ceiling):
    if ceiling is None:
        with pytest.raises(KeyError):
            bt.bucket_of(k, N_PROBE, CEILS, BATCH)
    else:
        assert bt.bucket_of(k, N_PROBE, CEILS, BATCH).k == ceiling


def test_batcher_fires_on_fill():
    b = bt.MicroBatcher(CEILS, BATCH, service_est=lambda _: 0.01)
    for i in range(BATCH - 1):
        b.submit(req(i))
    assert b.fire_ready(0.0) == []            # not full, slack ample
    b.submit(req(BATCH - 1))
    fired = b.fire_ready(0.0)
    assert len(fired) == 1 and fired[0].n_real == BATCH
    assert fired[0].queries.shape == (BATCH, D)
    assert b.pending() == 0


def test_batcher_fires_on_deadline_slack():
    est = 0.5
    b = bt.MicroBatcher(CEILS, BATCH, service_est=lambda _: est)
    b.submit(req(0, deadline=2.0))
    assert b.fire_ready(0.0) == []            # slack 2.0 > est 0.5
    due = b.next_fire_time(0.0)
    assert due == pytest.approx(2.0 - est)
    assert b.fire_ready(due - 1e-6) == []
    fired = b.fire_ready(due)
    assert len(fired) == 1 and fired[0].n_real == 1
    # pad lanes cycle the real query
    assert np.array_equal(fired[0].queries[0], fired[0].queries[1])
    assert fired[0].queries.shape == (BATCH, D)


def test_batcher_max_wait_bounds_idle_latency():
    b = bt.MicroBatcher(CEILS, BATCH, service_est=lambda _: 0.01,
                        max_wait=0.1)
    b.submit(req(0, arrival=1.0, deadline=100.0))
    assert b.next_fire_time(1.0) == pytest.approx(1.1)
    assert b.fire_ready(1.05) == []
    assert len(b.fire_ready(1.1)) == 1


def test_batcher_withdraw_and_clear():
    b = bt.MicroBatcher(CEILS, BATCH, service_est=lambda _: 0.01)
    for i in range(3):
        b.submit(req(i, k=50 if i < 2 else 100))
    assert b.depths() == {bt.ShapeBucket(64, BATCH, N_PROBE): 2,
                          bt.ShapeBucket(128, BATCH, N_PROBE): 1}
    assert b.withdraw(1).rid == 1 and b.withdraw(7) is None
    assert b.clear() == 2 and b.pending() == 0


# ---------------------------- admission -------------------------------------

def _seeded_service(vals):
    s = adm.ServiceEMA()
    for (k, npb), sec in vals.items():
        s.observe(bt.ShapeBucket(k=k, batch=BATCH, n_probe=npb), sec)
    return s


@pytest.mark.parametrize("case", ["accept", "degrade", "degrade_off",
                                  "backlog", "oversized"])
def test_admission_decisions(case):
    svc = {"accept": {64: 0.1, 128: 0.2}, "degrade": {64: 0.05, 128: 5.0},
           "degrade_off": {64: 0.05, 128: 5.0}, "backlog": {64: 0.4, 128: 0.4},
           "oversized": {64: 0.01, 128: 0.01}}[case]
    ac = adm.AdmissionController(
        _seeded_service({(k, N_PROBE): s for k, s in svc.items()}), CEILS,
        BATCH, allow_degrade=case != "degrade_off")
    k = {"accept": 50, "backlog": 50, "oversized": 500}.get(case, 120)
    depths = {bt.ShapeBucket(k=64, batch=BATCH, n_probe=N_PROBE):
              8 * BATCH} if case == "backlog" else {}
    d = ac.decide(req(0, k=k, deadline=1.0), 0.0, depths)
    want = {"accept": (adm.ACCEPT, 64, 50), "degrade": (adm.DEGRADE, 64, 64),
            "degrade_off": (adm.SHED, None, 120),
            "backlog": (adm.SHED, None, 50),
            "oversized": (adm.DEGRADE, 128, 128)}[case]
    assert (d.action, None if d.bucket is None else d.bucket.k, d.k) == want


def test_admission_folds_in_flight_remainder():
    svc = _seeded_service({(64, N_PROBE): 0.4, (128, N_PROBE): 0.4})
    ac = adm.AdmissionController(svc, CEILS, BATCH, allow_degrade=False)
    r = req(0, k=50, deadline=1.0)
    assert ac.decide(r, 0.0, {}).action == adm.ACCEPT
    assert ac.decide(r, 0.0, {}, in_flight=0.4).action == adm.ACCEPT
    assert ac.decide(r, 0.0, {}, in_flight=0.7).action == adm.SHED
    depths = {bt.ShapeBucket(k=64, batch=BATCH, n_probe=N_PROBE): BATCH}
    assert ac.decide(r, 0.0, depths, in_flight=0.3).action == adm.SHED
    assert ac.decide(r, 0.0, depths, in_flight=0.3) == \
        ac.decide(r, 0.0, depths, in_flight=0.3)


def test_degrade_ladder_caps_and_flags():
    ladder = adm.DegradeLadder(((1.0, 64, None), (2.0, 32, 4, 0.8)))
    r = req(0, k=100)
    assert ladder.apply(r, 0.5) is r
    one = ladder.apply(r, 1.2)
    assert one.k == 64 and one.k_requested == 100 and one.degraded
    two = ladder.apply(r, 3.0)
    assert (two.k, two.n_probe, two.recall_target) == (32, 4, 0.8)
    with pytest.raises(ValueError):
        adm.DegradeLadder(((2.0, 1, 1), (1.0, 1, 1)))


# ---------------------------- the server against the reference --------------

@pytest.mark.parametrize("kind", ["ivfpq", "ivf", "ivfrabitq"])
def test_server_matches_the_reference(data, kind):
    """One seeded mixed-k trace, one fixed service model: the port's Server
    and the reference's make the same decisions request for request
    (status, k, bucket, batch, finish time); the id sets equal the
    reference's (PQ, IVF; RaBitQ's batched CPU branch differs in the
    reference, see ROADMAP.md) and the port's own direct engine call at
    each request's bucket (every method)."""
    qs = data["qs"] if kind == "ivfpq" else data["qs"][:16]
    trace_j = jqueue.make_trace(np.random.default_rng(5), qs, (50, 120),
                                rate=500.0, deadline=30.0, n_probe=N_PROBE)
    trace_t = rq.make_trace(np.random.default_rng(5), qs, (50, 120),
                            rate=500.0, deadline=30.0, n_probe=N_PROBE)
    jstate, tstate = _states(data, kind, use_bbc=True)
    want = jserver.Server(jstate, CEILS, BATCH,
                          service_time_fn=lambda b: 0.01).run_trace(trace_j)
    got = sv.Server(tstate, CEILS, BATCH,
                    service_time_fn=lambda b: 0.01).run_trace(trace_t)
    assert _timeline(got) == _timeline(want)
    assert all(o.status == sv.OK for o in got)
    for g, w in zip(got, want):
        assert len(g.ids) == g.k_effective == g.request.k
        assert np.all(np.diff(g.dists) >= 0)
        assert set(_direct_ids(tstate, g).tolist()) == set(g.ids.tolist())
        if kind != "ivfrabitq":
            assert set(g.ids.tolist()) == set(np.asarray(w.ids).tolist())
            np.testing.assert_allclose(np.sort(g.dists),
                                       np.sort(np.asarray(w.dists)),
                                       rtol=1e-4, atol=1e-4)
    assert sv.parity_vs_direct(tstate, got) == (1.0, len(got))


def test_overlapped_assembly_outcomes_identical(data):
    """Assembling the next batch inside the current batch's service window
    changes WHEN the padded array is built, never WHAT is served."""
    trace = rq.make_trace(np.random.default_rng(7), data["qs"], (50, 120),
                          rate=800.0, deadline=30.0, n_probe=N_PROBE)
    runs = {}
    for overlap in (False, True):
        state = ServingState(data["tpq"], use_bbc=True, device="cpu")
        runs[overlap] = sv.Server(state, CEILS, BATCH,
                                  service_time_fn=lambda b: 0.01,
                                  overlap=overlap).run_trace(trace)
    assert _timeline(runs[False]) == _timeline(runs[True])
    for a, b in zip(runs[False], runs[True]):
        np.testing.assert_array_equal(a.ids, b.ids)


def test_shedding_replays_the_reference(data):
    """An overload trace with a fixed service model: the shed set replays
    exactly, equals the reference's, sheds really happen, shed outcomes
    carry no results, and every completed one matches the direct call."""
    qs = data["qs"]

    def trace(mod):
        return mod.make_trace(np.random.default_rng(9), qs, (50, 120),
                              rate=300.0, deadline=0.08, n_probe=N_PROBE,
                              pattern="bursty")

    jstate, _ = _states(data, "ivfpq", use_bbc=True)
    want = jserver.Server(jstate, CEILS, BATCH,
                          service_time_fn=lambda b: 0.05).run_trace(
                              trace(jqueue))
    runs = []
    for _ in range(2):
        state = ServingState(data["tpq"], use_bbc=True, device="cpu")
        runs.append((state, sv.Server(state, CEILS, BATCH,
                                      service_time_fn=lambda b: 0.05
                                      ).run_trace(trace(rq))))
    (state, o1), (_, o2) = runs
    shed = [o.request.rid for o in o1 if o.status == sv.SHED]
    assert shed == [o.request.rid for o in o2 if o.status == sv.SHED]
    assert shed == [o.request.rid for o in want if o.status == jserver.SHED]
    assert _timeline(o1) == _timeline(want)
    assert 0 < len(shed) < len(o1)
    for o in o1:
        if o.status == sv.SHED:
            assert o.ids is None and o.dists is None and not o.deadline_met
    parity, n_checked = sv.parity_vs_direct(state, o1)
    assert parity == 1.0 and n_checked == len(o1) - len(shed)
    # the vacuous case reports zero checked: callers must fail it
    assert sv.parity_vs_direct(
        state, [o for o in o1 if o.status == sv.SHED]) == (1.0, 0)
    s = sv.summarize(o1, state=state)
    assert s["conserved"] and s["shed"] == len(shed)
    assert set(s) == set(jserver.summarize(want, state=jstate))


def test_mid_batch_arrivals_are_decided_at_arrival(data):
    """A request arriving while a 2 s batch runs is shed at its arrival
    instant when its deadline falls inside that window, as in the
    reference."""
    qs = data["qs"]
    reqs = [rq.Request(rid=0, q=qs[0], k=50, n_probe=N_PROBE, arrival=0.0,
                       deadline=10.0),
            rq.Request(rid=1, q=qs[1], k=50, n_probe=N_PROBE, arrival=0.5,
                       deadline=1.0),
            rq.Request(rid=2, q=qs[2], k=50, n_probe=N_PROBE, arrival=0.5,
                       deadline=30.0)]
    state = ServingState(data["tpq"], use_bbc=True, device="cpu")
    srv = sv.Server(state, CEILS, BATCH, allow_degrade=False,
                    service_time_fn=lambda b: 2.0, service_cold=2.0)
    by_rid = {o.request.rid: o for o in srv.run_trace(reqs, warmup=False)}
    assert [by_rid[i].status for i in range(3)] == [sv.OK, sv.SHED, sv.OK]
    assert by_rid[1].t_done == pytest.approx(0.5)


def test_predictor_state_per_bucket(data):
    """tau_pred serving: each shape bucket owns its own predictor, warm
    from its first batch on."""
    qs = data["qs"]
    state = ServingState(data["tpq"], use_bbc=True, tau_pred=True,
                         device="cpu")
    buckets = [bt.bucket_of(k, N_PROBE, CEILS, BATCH) for k in (50, 120)]
    taus = {b: [] for b in buckets}
    for step in range(4):
        for b in buckets:
            rows = qs[4 * step:4 * step + 4]
            state.run(bt.assemble(b, [
                rq.Request(rid=step * 10 + j, q=rows[j], k=b.k,
                           n_probe=N_PROBE, arrival=0.0, deadline=1.0)
                for j in range(4)]))
            taus[b].append(int(rerank.predict_tau(
                state.pred_state(b), state.engine(b).pred_count)))
    assert len(state.pred_states()) == 2
    for b in buckets:
        assert float(state.pred_state(b).weight) > 0.0
        assert all(t >= 0 for t in taus[b])
    s64, s128 = (state.pred_state(b) for b in buckets)
    assert not torch.allclose(s64.ema, s128.ema)
    fork = state.fork()
    assert fork.pred_states() == {} and fork._engines is state._engines


@pytest.mark.parametrize("kind", ["ivfpq", "ivf", "ivfrabitq"])
def test_bucket_engines_share_one_layout_and_stream(data, kind):
    """Two (k, n_probe) buckets over one index: the second bucket's engine
    shares the first's index, layout and stream objects, and has the
    knobs, ids, distances and counters of its own ``SearchEngine.build``."""
    state = _states(data, kind)[1]
    first = state.engine(bt.bucket_of(50, N_PROBE, CEILS, BATCH))
    bucket = bt.bucket_of(120, N_PROBE + 2, CEILS, BATCH)
    eng = state.engine(bucket)
    assert (eng.k, eng.n_probe) == (128, N_PROBE + 2) != \
        (first.k, first.n_probe)
    assert eng.index is first.index and eng.layout is first.layout
    assert eng.stream is first.stream
    built = engine.SearchEngine.build(state.index, k=bucket.k,
                                      n_probe=bucket.n_probe,
                                      vectors=state.vectors, device="cpu")
    for knob in ("kind", "n_cand", "pred_count", "fused", "use_bbc", "m",
                 "generation", "tuned_from"):
        assert getattr(eng, knob) == getattr(built, knob), knob
    qs = torch.from_numpy(data["qs"][:BATCH])
    for got, want in zip(eng.search_batch(qs), built.search_batch(qs)):
        assert torch.equal(got, want)


def test_engine_warmup_serves_the_bucket_shape(data):
    eng = engine.SearchEngine.build(data["tpq"], k=64, n_probe=N_PROBE,
                                    device="cpu")
    assert eng.warmup(batch_sizes=(1, BATCH), predictive=True) is eng
    assert eng.search_batch(torch.zeros(BATCH, D)).ids.shape == (BATCH, 64)
    with pytest.raises(ValueError):
        eng.warmup(batch_sizes=(0,))


@pytest.mark.parametrize("what,item", [("tuned", "item 11"),
                                       ("mesh", "item 9b"),
                                       ("swap", "item 10"),
                                       ("live", "item 10"),
                                       ("fork", "item 12")])
def test_unported_state_paths_raise(data, what, item):
    """Every path once refused here is ported and must no longer raise:
    the sharded state (9b), the swap and the tombstone mask (10), tuned
    operating points (11: each bucket engine resolves its knobs from the
    store and reports the point) and forks with cloned engines (12: new
    engine objects over the same tensors)."""
    bucket = bt.bucket_of(50, N_PROBE, CEILS, BATCH)
    if what == "tuned":
        from repro_torch.tuning import knobs as tkn
        from repro_torch.tuning import points as tpts
        point = tpts.OperatingPoint(
            method="ivfpq", k=128, recall_target=0.95,
            knobs=tkn.KnobConfig(n_probe=4, n_cand=600), recall=1.0,
            cost_units=1.0, feasible=True)
        state = ServingState(data["tpq"], device="cpu",
                             tuned=tpts.PointStore([point]))
        eng = state.engine(bucket)
        assert eng.n_probe == N_PROBE and eng.n_cand == 600
        assert state.operating_points() == {
            f"k{bucket.k}/np{N_PROBE}": f"{point.name} (tuned)"}
        return
    if what == "fork":
        state = ServingState(data["tpq"], device="cpu")
        eng = state.engine(bucket)
        twin = state.fork(clone_engines=True)
        clone = twin.engine(bucket)
        assert clone is not eng and clone.layout is eng.layout
        assert clone.index is eng.index and twin._engines is not \
            state._engines and twin.pred_states() == {}
        return
    if what == "mesh":
        import tempfile

        import torch.distributed as tdist
        from repro_torch.core import distributed
        with tempfile.TemporaryDirectory() as tmp:
            tdist.init_process_group("gloo", init_method=f"file://{tmp}/s",
                                     rank=0, world_size=1)
            try:
                state = ServingState(data["tpq"],
                                     mesh=distributed.make_mesh((1,)))
                assert state.engine(bucket).mesh is state.mesh
                # one block stream per rank, shared across the buckets
                other = state.engine(bt.bucket_of(120, N_PROBE, CEILS,
                                                  BATCH))
                assert other.k == 128 and other.mesh is state.mesh
                assert other.stream is state.engine(bucket).stream
                assert other.shard_layout is state.engine(
                    bucket).shard_layout
            finally:
                tdist.destroy_process_group()
        return
    state = ServingState(data["tpq"], device="cpu")
    if what == "swap":
        state.swap(data["tpq"])
        assert state.generation == 1
        assert state.engine(bucket).generation == 1
    else:
        state.live = torch.ones(N, dtype=torch.bool)
        assert state.engine(bucket).live is not None


# ---------------------------- the CLI ---------------------------------------

SMALL = ["--device", "cpu", "--n", "4000", "--d", "32", "--n-clusters", "32",
         "--n-probe", "8", "--queries", "16", "--k-choices", "50,120",
         "--max-batch", "4", "--deadline-ms", "30000"]


def test_cli_async_checks_parity(capsys):
    assert serve.main(["--mode", "async", *SMALL, "--check-parity"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["parity"] == 1.0 and summary["parity_checked"] > 0
    assert summary["completed"] + summary["shed"] == 16
    assert summary["device"] == "cpu" and summary["mode"] == "async"
    assert summary["k_choices"] == [50, 120] and summary["conserved"]
    assert any(line.startswith("[serve]") and "batches served" in line
               for line in out)


@pytest.mark.parametrize("argv,exc,match", [
    # the replica tier over shards (item 12b) serves: rank 0's pool drives
    # the other gloo ranks in lock step
    (["--replicas", "2", "--shards", "3"], None, None),
    (["--faults", "crash@1:t=0.02", "--replicas", "2", "--shards", "2"],
     None, None),
    (["--shards", "2", "--replicas", "2"], None, None),
    (["--tau-pred", "on", "--check-parity"], SystemExit, "tau-pred"),
    (["--method", "flat"], SystemExit, "flat")])
def test_cli_async_refusals(argv, exc, match, capfd):
    """The async mode's flag refusals raise before any work; the
    compositions that once raised (``--replicas`` with ``--shards``) now
    serve with parity 1.0 (the name is kept so the test's history stays
    one line)."""
    if exc is None:
        assert serve.main(["--mode", "async", *SMALL, *argv,
                           "--check-parity"]) == 0
        out = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
        assert out["shards"] == int(argv[argv.index("--shards") + 1])
        assert out["replicas"] == 2 and out["conserved"]
        assert out["parity"] == 1.0 and out["parity_checked"] == 16
        assert out["faults"] == (argv[1] if "--faults" in argv else "")
        return
    with pytest.raises(exc, match=match):
        serve.main(["--mode", "async", *SMALL, *argv])


def test_cli_net_mode_names_its_item(capsys):
    """``--mode net`` (ROADMAP.md queue 1, item 13) serves: one worker
    process on the CPU, a short Zipf trace, the replay identical, and the
    summary carries the reference's keys (its ``summarize`` keys and its
    net keys) plus ``device`` and the workers' card launches (none here).
    The name dates from when the mode raised naming its item; it is kept
    so the test's history stays one line."""
    rc = serve.main(["--mode", "net", *SMALL, "--workers", "1",
                     "--requests", "16", "--check-replay"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["replay_identical"] and out["conserved"]
    assert out["requests"] == 16 and out["client_completed"] == 16
    want = set(jserver.summarize([])) | {
        "mode", "workers", "k_choices", "rate", "wire_faults",
        "outcome_digest", "net_stats", "cache", "client_completed",
        "client_p99_ms", "replay_digest", "replay_identical"}
    assert want <= set(out) and out["device"] == "cpu"
    assert out["worker_launches"] == {}
    assert out["mode"] == "net" and out["k_choices"] == [50, 120]
