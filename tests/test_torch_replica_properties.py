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

The transport tier's wire properties come with the transport (ROADMAP.md
queue 1, item 13).
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
