"""Hypothesis properties of the port's replica tier (the reference's
``tests/test_replica_properties.py`` router properties), on the numpy stub
state with a fixed service model, over random traces x seeded fault
schedules:

* **router determinism**: an identical trace plus an identical
  ``FaultSchedule`` seed replays to identical outcomes, assignments, stats
  and summaries, and to the reference's, byte for byte;
* **request conservation**: retries and hedges never duplicate or drop a
  request id: every offered rid terminates exactly once, with completed +
  shed + failed == offered, and results only on completions.

And the transport tier's (the reference file's wire properties), through
the port's virtual-clock ``LoopbackSim`` over random traces x seeded wire
schedules and a worker kill:

* **conservation under wire faults**: every offered request terminates
  exactly once, completed + shed + failed + rejected == offered, with the
  stub's exact answer on every completion and no payload otherwise;
* **determinism**: the same trace and wire seed give the same digest,
  assignments and stats, and the reference's, byte for byte.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.serving import router as jrouter  # noqa: E402
from repro.serving import server as jsv  # noqa: E402
from repro_torch.serving import server as sv  # noqa: E402
from repro_torch.serving.router import outcome_digest  # noqa: E402
from test_torch_replica import (PORT, REF, make_server,  # noqa: E402
                                make_trace)


def _run(trace_seed, fault_seed, n_replicas, n_req, n_faults, pkg=PORT):
    trace = make_trace(n_req, seed=trace_seed, pkg=pkg)
    horizon = max(r.arrival for r in trace)
    faults = pkg.flt.FaultSchedule.seeded(
        np.random.default_rng(fault_seed), n_replicas, horizon,
        n_faults=n_faults)
    srv = make_server(n_replicas=n_replicas, faults=faults, pkg=pkg)
    outcomes = srv.run_trace(trace)
    return trace, srv, outcomes


@settings(max_examples=12, deadline=None)
@given(
    trace_seed=st.integers(0, 2**31 - 1),
    fault_seed=st.integers(0, 2**31 - 1),
    n_replicas=st.integers(2, 4),
    n_req=st.integers(6, 28),
    n_faults=st.integers(0, 4),
)
def test_property_router_determinism(trace_seed, fault_seed, n_replicas,
                                     n_req, n_faults):
    """Identical trace + identical fault seed => identical outcomes,
    assignments, stats and summaries, and the reference's."""
    args = (trace_seed, fault_seed, n_replicas, n_req, n_faults)
    _, s1, o1 = _run(*args)
    _, s2, o2 = _run(*args)
    _, sj, oj = _run(*args, pkg=REF)
    assert outcome_digest(o1) == outcome_digest(o2) == \
        jrouter.outcome_digest(oj)
    assert s1.assignments == s2.assignments == sj.assignments
    assert s1.stats == s2.stats == sj.stats
    assert json.dumps(sv.summarize(o1), sort_keys=True) == \
        json.dumps(sv.summarize(o2), sort_keys=True) == \
        json.dumps(jsv.summarize(oj), sort_keys=True)


@settings(max_examples=12, deadline=None)
@given(
    trace_seed=st.integers(0, 2**31 - 1),
    fault_seed=st.integers(0, 2**31 - 1),
    n_replicas=st.integers(2, 4),
    n_req=st.integers(6, 28),
    n_faults=st.integers(0, 5),
)
def test_property_retry_hedge_conserves_request_ids(
        trace_seed, fault_seed, n_replicas, n_req, n_faults):
    """No duplicated or dropped rids, whatever the fault schedule throws:
    every offered request terminates exactly once and the summary's
    conservation invariant holds."""
    trace, srv, outcomes = _run(trace_seed, fault_seed, n_replicas, n_req,
                                n_faults)
    rids = [o.request.rid for o in outcomes]
    assert rids == sorted(r.rid for r in trace)      # once each, in order
    assert len(set(rids)) == len(trace)
    s = sv.summarize(outcomes)
    assert s["conserved"], s
    assert s["completed"] + s["shed"] + s["failed"] == len(trace)
    # results only on completions; absent (never wrong) otherwise
    for o in outcomes:
        if o.status in (sv.OK, sv.DEGRADED):
            assert o.ids is not None and len(o.ids) == o.k_effective
        else:
            assert o.ids is None and o.dists is None


# -------------------- the transport tier: wire faults -----------------------

from repro.serving import faults as jflt  # noqa: E402
from repro.serving import queue as jrq  # noqa: E402
from repro.transport import core as jcore  # noqa: E402
from repro.transport import sim as jsim  # noqa: E402
from repro_torch.serving import faults as flt  # noqa: E402
from repro_torch.serving import queue as rq  # noqa: E402
from repro_torch.serving.batcher import k_ceilings  # noqa: E402
from repro_torch.transport import core as tcore  # noqa: E402
from repro_torch.transport import sim as tsim  # noqa: E402

_T_KS = (10, 100)
_T_PORT = (rq, flt, tcore, tsim)
_T_REF = (jrq, jflt, jcore, jsim)


def _t_exec(q, k, n_probe):
    h = int(np.abs(np.asarray(q, dtype=np.float64)).sum() * 1e3) % 997
    return (np.arange(k, dtype=np.float32) * 0.01 + h % 7,
            np.arange(k, dtype=np.int64) + h)


def _t_run(trace_seed, wire_seed, n_workers, n_req, drop, dup, slow,
           truncate, disconnect, kill, pkg=_T_PORT):
    queue, faults, core, sim = pkg
    rng = np.random.default_rng(trace_seed)
    centroids = rng.standard_normal((16, 8)).astype(np.float32)
    pool = rng.standard_normal((24, 8)).astype(np.float32)
    trace = queue.make_zipf_trace(rng, pool, n_req, _T_KS, rate=400.0,
                                  deadline=0.5, n_probe=4)
    wire = faults.WireSchedule(seed=wire_seed, drop=drop, dup=dup,
                               slow=slow, truncate=truncate,
                               disconnect=disconnect)
    mcore = core.MasterCore(core.MasterConfig(
        n_workers=n_workers, ceilings=k_ceilings(_T_KS)), centroids)
    run = sim.LoopbackSim(mcore, _t_exec, lambda b: 0.001 + b.k * 1e-6,
                          wire=wire, kill_at={0: 0.05} if kill else None)
    return trace, mcore, run.run(trace)


@settings(max_examples=12, deadline=None)
@given(
    trace_seed=st.integers(0, 2**31 - 1),
    wire_seed=st.integers(0, 2**31 - 1),
    n_workers=st.integers(1, 4),
    n_req=st.integers(8, 60),
    drop=st.floats(0.0, 0.1),
    dup=st.floats(0.0, 0.05),
    slow=st.floats(0.0, 0.2),
    truncate=st.floats(0.0, 0.03),
    disconnect=st.floats(0.0, 0.03),
    kill=st.booleans(),
)
def test_property_transport_conserves_under_wire_faults(
        trace_seed, wire_seed, n_workers, n_req, drop, dup, slow,
        truncate, disconnect, kill):
    """Whatever the wire does (drops, duplicates, latency jitter,
    truncations, disconnects, a worker kill), every offered request
    terminates exactly once, as in the reference."""
    args = (trace_seed, wire_seed, n_workers, n_req, drop, dup, slow,
            truncate, disconnect, kill)
    trace, mcore, outcomes = _t_run(*args)
    rids = [o.request.rid for o in outcomes]
    assert len(rids) == len(set(rids)) == len(trace)
    s = sv.summarize(outcomes)
    assert s["conserved"], s
    assert s["completed"] + s["shed"] + s["failed"] + s["rejected"] \
        == len(trace)
    assert mcore.stats["offered"] == len(trace)
    for o in outcomes:
        if o.status in (sv.OK, sv.DEGRADED):
            _, ids = _t_exec(o.request.q, o.request.k, o.request.n_probe)
            np.testing.assert_array_equal(o.ids, ids)
        else:
            assert o.ids is None and o.dists is None
    _, jcore_run, joutcomes = _t_run(*args, pkg=_T_REF)
    assert outcome_digest(outcomes) == jrouter.outcome_digest(joutcomes)
    assert mcore.stats == jcore_run.stats


@settings(max_examples=8, deadline=None)
@given(
    trace_seed=st.integers(0, 2**31 - 1),
    wire_seed=st.integers(0, 2**31 - 1),
    n_req=st.integers(8, 40),
)
def test_property_transport_faulted_run_is_deterministic(
        trace_seed, wire_seed, n_req):
    """Same trace + same wire seed => byte-identical digest, decision log
    and stats, faults and all, and the reference's."""
    args = (trace_seed, wire_seed, 3, n_req, 0.05, 0.02, 0.1, 0.02, 0.02,
            True)
    a, b, j = _t_run(*args), _t_run(*args), _t_run(*args, pkg=_T_REF)
    assert outcome_digest(a[2]) == outcome_digest(b[2]) == \
        jrouter.outcome_digest(j[2])
    assert a[1].assignments == b[1].assignments == j[1].assignments
    assert a[1].stats == b[1].stats == j[1].stats
