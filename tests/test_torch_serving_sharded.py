"""Sharded async serving in the port: rank 0's ``Server`` over a
``serving.lockstep.LockstepState``, the other ranks following it, on 2
and 4 gloo ranks, against the single-device async run.

Config: the serving tests' (N=4000, D=32, 32 clusters, ceilings (64, 128),
B=4, n_probe=8) with one seeded mixed-k trace and a fixed service model,
so the schedule is exact.  For IVF+PQ and IVF the outcomes (status, k,
bucket, finish time) equal the single-device run's request for request
and the id sets too (the sharded engine returns the batched engine's id
sets); for all three methods every completed request equals a direct
sharded engine call at its bucket (parity 1.0).  Under ``tau_pred`` each
rank threads its own per-bucket predictor state, and the states are equal
on every rank after the run.  The index is built once in the test process
and carried to the ranks as numpy arrays.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import synthetic  # noqa: E402
from repro_torch.index import search  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import lockstep  # noqa: E402
from repro_torch.serving import queue as rq  # noqa: E402
from repro_torch.serving import server as sv  # noqa: E402
from repro_torch.serving.batcher import ShapeBucket  # noqa: E402
from repro_torch.serving.state import ServingState  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, C, NQ = 4000, 32, 32, 24
CEILS, BATCH, N_PROBE = (64, 128), 4, 8
RUNS = [("ivfpq", False), ("ivf", False), ("ivfrabitq", False),
        ("ivfpq", True), ("ivfrabitq", True)]

RANK_SCRIPT = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as tdist
    import torch.multiprocessing as mp

    CEILS, BATCH, N_PROBE = (64, 128), 4, 8


    def rank_main(rank, world, src, dst, store):
        torch.set_num_threads(1)
        tdist.init_process_group("gloo", init_method=f"file://{store}",
                                 rank=rank, world_size=world)
        from repro_torch import convert
        from repro_torch.core import distributed as dist
        from repro_torch.serving import lockstep
        from repro_torch.serving import queue as rq
        from repro_torch.serving import server as sv
        from repro_torch.serving.state import ServingState
        a = dict(np.load(src))
        common = {k: a[k] for k in ("ivf_centroids", "member_ids",
                                    "member_valid", "cluster_sizes")}
        pq, _ = convert.pq_index_from_numpy(
            dict(common, vectors=a["x"], pq_centroids=a["pq_centroids"],
                 codes=a["codes"]), device="cpu")
        rqx, _ = convert.rabitq_index_from_numpy(
            {"ivf_centroids": a["rq_ivf_centroids"],
             "member_ids": a["rq_member_ids"],
             "member_valid": a["rq_member_valid"],
             "cluster_sizes": a["rq_cluster_sizes"], "vectors": a["x"],
             "rot": a["rot"], "codes": a["rq_codes"],
             "norm_o": a["norm_o"], "f_o": a["f_o"]}, device="cpu")
        mesh = dist.make_mesh((world,), ("model",))
        out = {}
        for kind, tau in json.loads(a["runs"].item()):
            ix = {"ivfpq": pq, "ivf": pq.ivf, "ivfrabitq": rqx}[kind]
            kw = dict(use_bbc=True, tau_pred=tau, mesh=mesh,
                      vectors=a["x"] if kind == "ivf" else None)
            name = f"{kind}:{tau}"
            if rank == 0:
                state = lockstep.LockstepState(ix, **kw)
                trace = rq.make_trace(np.random.default_rng(5), a["qs"],
                                      (50, 120), rate=500.0, deadline=30.0,
                                      n_probe=N_PROBE)
                got = sv.Server(state, CEILS, BATCH,
                                service_time_fn=lambda b: 0.01
                                ).run_trace(trace)
                parity = None if tau else sv.parity_vs_direct(state, got)
                state.stop()
                out[name] = {
                    "timeline": [[o.request.rid, o.status, o.k_effective,
                                  [o.bucket.k, o.bucket.batch,
                                   o.bucket.n_probe], o.t_done]
                                 for o in got],
                    "ids": [o.ids.tolist() for o in got],
                    "parity": parity}
            else:
                state = ServingState(ix, **kw)
                calls = lockstep.follow(state)
                assert calls > 0
            # every rank's per-bucket predictor states, gathered on rank 0
            mine = {f"{b.k}/{b.batch}/{b.n_probe}":
                    (s.ema.tolist(), float(s.weight))
                    for b, s in sorted(state.pred_states().items(),
                                       key=lambda kv: kv[0].k)}
            every = [None] * world
            tdist.all_gather_object(every, mine)
            if rank == 0:
                out[name]["pred_states"] = every
        if rank == 0:
            with open(dst, "w") as f:
                json.dump(out, f)
        tdist.barrier()
        tdist.destroy_process_group()


    if __name__ == "__main__":
        world = int(sys.argv[1])
        mp.spawn(rank_main, args=(world, *sys.argv[2:5]), nprocs=world,
                 join=True)
        print("LOCKSTEP_OK")
    """
)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = synthetic.clustered(rng, N, D, n_centers=32)
    qs = synthetic.queries_from(rng, x, NQ)
    pq = search.build_pq_index(x, C, n_iter=3, device="cpu")
    rqx = search.build_rabitq_index(x, C, n_iter=3, device="cpu")
    tmp = tmp_path_factory.mktemp("serving_sharded")
    src = tmp / "index.npz"
    ivf = lambda i: {  # noqa: E731
        "ivf_centroids": i.centroids, "member_ids": i.member_ids,
        "member_valid": i.member_valid, "cluster_sizes": i.cluster_sizes}
    arrays = dict(ivf(pq.ivf), pq_centroids=pq.pq.centroids,
                  codes=pq.codes, rot=rqx.rq.rot, rq_codes=rqx.rq.codes,
                  norm_o=rqx.rq.norm_o, f_o=rqx.rq.f_o,
                  **{f"rq_{k}": v for k, v in ivf(rqx.ivf).items()})
    np.savez(src, x=x, qs=qs, runs=np.array(json.dumps(RUNS)),
             **{k: v.numpy() for k, v in arrays.items()})
    return dict(x=x, qs=qs, pq=pq, rq=rqx, src=src, tmp=tmp)


def _single_device(setup, kind, tau):
    ix = {"ivfpq": setup["pq"], "ivf": setup["pq"].ivf,
          "ivfrabitq": setup["rq"]}[kind]
    state = ServingState(ix, use_bbc=True, tau_pred=tau, device="cpu",
                         vectors=setup["x"] if kind == "ivf" else None)
    trace = rq.make_trace(np.random.default_rng(5), setup["qs"], (50, 120),
                          rate=500.0, deadline=30.0, n_probe=N_PROBE)
    return state, sv.Server(state, CEILS, BATCH,
                            service_time_fn=lambda b: 0.01).run_trace(trace)


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, setup):
    world = request.param
    script = setup["tmp"] / "ranks.py"
    script.write_text(RANK_SCRIPT)
    dst = setup["tmp"] / f"out{world}.json"
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run(
        [sys.executable, str(script), str(world), str(setup["src"]),
         str(dst), str(setup["tmp"] / f"store{world}")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert "LOCKSTEP_OK" in out.stdout, out.stderr[-3000:]
    return world, json.loads(dst.read_text())


@pytest.mark.multidevice
@pytest.mark.parametrize("kind,tau", RUNS)
def test_sharded_async_equals_single_device(setup, ranks, kind, tau):
    world, out = ranks
    got = out[f"{kind}:{tau}"]
    state, want = _single_device(setup, kind, tau)
    timeline = [[o.request.rid, o.status, o.k_effective,
                 [o.bucket.k, o.bucket.batch, o.bucket.n_probe], o.t_done]
                for o in want]
    assert got["timeline"] == timeline
    assert all(o.status == sv.OK for o in want)
    if not tau:
        assert got["parity"] == [1.0, len(want)]
    if kind != "ivfrabitq":
        for g, w in zip(got["ids"], want):
            assert set(g) == set(w.ids.tolist())
    # each rank threaded its own predictor states, and they are equal
    states = got["pred_states"]
    assert len(states) == world and all(s == states[0] for s in states)
    assert bool(states[0]) == tau
    if tau:
        for key, (ema, weight) in states[0].items():
            k, b, n_probe = (int(v) for v in key.split("/"))
            mine = state.pred_states()[ShapeBucket(k=k, batch=b,
                                                   n_probe=n_probe)]
            assert weight == float(mine.weight) > 0
            if kind == "ivfpq":     # the summed histogram is the batched one
                np.testing.assert_array_equal(np.float32(ema),
                                              mine.ema.numpy())


def test_lockstep_refuses_misuse(setup, tmp_path):
    """The leader needs a mesh and rank 0 and threads only each bucket's
    own predictor state (or a cold one, a drift probe's); a follower needs
    a mesh.  A swap, which the leader once refused, is made (on a one-rank
    mesh nobody follows) and returns the new generation."""
    import torch.distributed as tdist
    from repro_torch.core import distributed
    with pytest.raises(ValueError, match="mesh"):
        lockstep.follow(ServingState(setup["pq"], device="cpu"))
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                             rank=0, world_size=1)
    try:
        mesh = distributed.make_mesh((1,))
        with pytest.raises(ValueError, match="mesh"):
            lockstep.LockstepState(setup["pq"], mesh=None)
        state = lockstep.LockstepState(setup["pq"], mesh=mesh, use_bbc=True,
                                       tau_pred=True)
        bucket = ShapeBucket(k=64, batch=BATCH, n_probe=N_PROBE)
        eng = state.engine(bucket)
        assert eng.k == 64 and eng.mesh is mesh
        cold = eng.predictor_init()
        with pytest.raises(ValueError, match="own predictor"):
            eng.search_batch(setup["qs"][:BATCH], pred_state=cold._replace(
                weight=cold.weight + 1))
        _, warm = eng.search_batch(setup["qs"][:BATCH], pred_state=cold)
        assert float(warm.weight) > 0
        assert state.swap(setup["pq"]) == {} and state.generation == 1
        eng = state.engine(bucket)
        assert eng.generation == 1
        res = eng.search_batch(setup["qs"][:BATCH])
        assert res.ids.shape == (BATCH, 64)
        state.stop()
    finally:
        tdist.destroy_process_group()


@pytest.mark.multidevice
@pytest.mark.parametrize("method", ["ivfpq_bbc", "ivfrabitq_bbc"])
def test_cli_async_two_shards(method):
    """``serve --mode async --shards 2`` spawns two gloo ranks; rank 0
    prints the summary with parity 1.0 and the exit code is 0."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
         "async", "--device", "cpu", "--shards", "2", "--n", "4000", "--d",
         "32", "--n-clusters", "32", "--n-probe", "8", "--queries", "16",
         "--k-choices", "50,120", "--max-batch", "4", "--deadline-ms",
         "30000", "--check-parity", "--method", method],
        capture_output=True, text=True, env=dict(os.environ,
                                                 PYTHONPATH="src"),
        cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["shards"] == 2 and summary["parity"] == 1.0
    assert summary["parity_checked"] == 16 and summary["conserved"]
    assert sum(line.startswith("{") for line in lines) == 1


def test_cli_async_sharded_flag_checks_run_before_any_rank(capfd):
    """A refused flag exits before any rank starts; ``--replicas`` with
    ``--shards`` (item 12b), which once raised here, serves: rank 0's
    replica pool over the two gloo ranks, parity 1.0."""
    with pytest.raises(SystemExit, match="flat"):
        serve.main(["--mode", "async", "--device", "cpu", "--shards", "2",
                    "--method", "flat"])
    assert serve.main(["--mode", "async", "--device", "cpu", "--shards", "2",
                       "--replicas", "2", "--n", "3000", "--d", "16",
                       "--n-clusters", "16", "--n-probe", "4", "--queries",
                       "12", "--k-choices", "20,60", "--max-batch", "4",
                       "--deadline-ms", "30000", "--check-parity"]) == 0
    out = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert out["shards"] == 2 and out["replicas"] == 2
    assert out["parity"] == 1.0 and out["conserved"]
