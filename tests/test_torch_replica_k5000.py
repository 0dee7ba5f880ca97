"""The replica tier's sharded and mesh-less runs at k=5000, in both
packages: where the sharded engine's ids part from the batched engine's,
the reference's part the same way.

Config: chip_smoke phase 18's twin run (the serve CLI's IVF+PQ+BBC index
over 316 clusters at d=96, n_probe=64, 64 queries at k=5000 with a 0.95
recall target, 4 replicas, its crash/corrupt/slow schedule, a fixed 15 ms
service model, predictor checkpoints) with the corpus cut from 100,000 to
60,000 rows.  Four runs: each package over its single-device state and
over a one-device mesh (the port's on a one-rank gloo group), on the
reference's index carried across.  All four give the same schedule,
assignment log and stats, and in each mode the port's id sets are the
reference's, so the port reproduces the reference's sharded-vs-batched
overlap exactly.  With the tau predictor on, that overlap is below 1 at
this size (the sharded engine predicts on its own pool); with it off it is
1.  The overlaps are printed (``pytest -rP``).
"""
import json
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro.serving import batcher as jbt  # noqa: E402
from repro.serving import faults as jflt  # noqa: E402
from repro.serving import queue as jrq  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro.serving.state import ServingState as JServingState  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.serving import batcher as bt  # noqa: E402
from repro_torch.serving import faults as flt  # noqa: E402
from repro_torch.serving import queue as rq  # noqa: E402
from repro_torch.serving import router  # noqa: E402
from repro_torch.serving.state import ServingState  # noqa: E402

torch.set_num_threads(2)

N, D, C, NQ, K, N_PROBE = 60_000, 96, 316, 64, 5000, 64
FAULTS = ("crash@1:t=0.1;corrupt@2:t=0.05,dur=0.2;"
          "slow@3:t=0.0,dur=1.0,factor=4")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    x = synthetic.clustered(rng, N, D)
    qs = synthetic.queries_from(rng, x, NQ)
    jpq = jsearch.build_pq_index(jax.random.key(0), jnp.asarray(x), C)
    tpq, _ = convert.pq_index_from_numpy({
        "ivf_centroids": np.asarray(jpq.ivf.centroids),
        "member_ids": np.asarray(jpq.ivf.member_ids),
        "member_valid": np.asarray(jpq.ivf.member_valid),
        "cluster_sizes": np.asarray(jpq.ivf.cluster_sizes),
        "vectors": np.asarray(jpq.vectors),
        "pq_centroids": np.asarray(jpq.pq.centroids),
        "codes": np.asarray(jpq.codes)}, device="cpu")
    return qs, jpq, tpq


def _twin(pkg, state, qs, ckpt):
    """Phase 18's twin run of one package's tier over ``state``."""
    queue, batcher, faults, rtr = pkg
    trace = queue.make_trace(np.random.default_rng(0), qs, (K,), rate=200.0,
                             deadline=0.5, n_probe=N_PROBE,
                             recall_target=0.95)
    srv = rtr.ReplicaServer(
        state, 4, ceilings=batcher.k_ceilings((K,)), batch=16,
        faults=faults.FaultSchedule.parse(FAULTS),
        service_time_fn=lambda b: 0.015, max_wait=0.04, hb_interval=0.02,
        respawn_delay=0.05, checkpoint_dir=ckpt, checkpoint_every=1)
    outcomes = sorted(srv.run_trace(trace), key=lambda o: o.request.rid)
    return {"schedule": [(o.request.rid, o.status, o.replica, o.retries,
                          bool(o.hedged), round(o.t_done, 9),
                          o.k_effective) for o in outcomes],
            "log": [list(a) for a in srv.assignments],
            "stats": dict(sorted(srv.stats.items())),
            "ids": [None if o.ids is None else
                    set(np.asarray(o.ids).tolist()) for o in outcomes]}


def _overlap(a, b):
    got = [len(p & q) / len(q) for p, q in zip(a["ids"], b["ids"])
           if p is not None and q is not None]
    return {"min": min(got), "mean": sum(got) / len(got)}


@pytest.mark.parametrize("tau", [False, True], ids=["static", "tau"])
def test_sharded_parts_from_batched_as_the_reference_does(corpus, tau,
                                                          tmp_path):
    import torch.distributed as tdist
    qs, jpq, tpq = corpus
    ref = (jrq, jbt, jflt, jrouter)
    port = (rq, bt, flt, router)
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                             rank=0, world_size=1)
    try:
        runs = {
            "ref": _twin(ref, JServingState(jpq, tau_pred=tau), qs,
                         tempfile.mkdtemp(dir=tmp_path)),
            "ref mesh": _twin(ref, JServingState(
                jpq, tau_pred=tau, mesh=jax.make_mesh((1,), ("model",))),
                qs, tempfile.mkdtemp(dir=tmp_path)),
            "port": _twin(port, ServingState(tpq, tau_pred=tau,
                                             device="cpu"),
                          qs, tempfile.mkdtemp(dir=tmp_path)),
            "port mesh": _twin(port, ServingState(
                tpq, tau_pred=tau, mesh=distributed.make_mesh((1,))),
                qs, tempfile.mkdtemp(dir=tmp_path))}
    finally:
        tdist.destroy_process_group()
    want = runs["ref"]
    for name, run in runs.items():
        for what in ("schedule", "log", "stats"):
            assert run[what] == want[what], (name, what)
    assert runs["ref"]["stats"]["respawns"] >= 1
    # in each mode the port's id sets are the reference's
    assert runs["port"]["ids"] == runs["ref"]["ids"]
    assert runs["port mesh"]["ids"] == runs["ref mesh"]["ids"]
    parted = {"ref": _overlap(runs["ref mesh"], runs["ref"]),
              "port": _overlap(runs["port mesh"], runs["port"])}
    print(json.dumps({"n": N, "k": K, "tau_pred": tau,
                      "sharded_vs_batched_overlap": parted}))
    assert parted["port"] == parted["ref"]
    if not tau:
        assert parted["ref"] == {"min": 1.0, "mean": 1.0}
