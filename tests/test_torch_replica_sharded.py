"""The replica tier over a sharded deployment: rank 0's ``ReplicaServer``
over a ``serving.lockstep.LockstepState``, the other ranks following it,
on 2 and 4 gloo ranks, against the JAX package's single-device replica
run (its ``ReplicaServer`` over its ``ServingState``, the JAX CLI's
composition) on the same index.

Config: the sharded serving tests' (N=4000, D=32, 32 clusters, IVF+PQ+BBC,
ceilings (64, 128), B=4, n_probe=8), 3 replicas, one seeded mixed-k trace
and a fixed service model, so the schedule is exact.  The indexes are built
once by the reference and carried to the port (and to the ranks) as numpy
arrays.  For each fault schedule (none, a crash with its respawn, a
corrupt-response window) the outcome digest, the assignment log and the
stats of the ranks' run and of the port's single-device run equal the
reference's, and every completed request equals a direct sharded engine
call (parity 1.0).  With the tau predictor on and predictor checkpoints, a
crash respawns replica 1 from its checkpoint: the digest equals the
reference's, and every state (the base and each fork, by sid) holds equal
predictor states on every rank.  After the fault-free run and the tau run,
a rolling swap of the sharded pool onto a second index (its tensors
broadcast from rank 0, the drift probes run on every rank, the carried
predictor states sent), then the trace again, equals the reference pool's
swap and run; so does a plain-IVF run (the corpus vectors served) swapped
onto the second index's IVF with 5% of the rows tombstoned (the vectors and
the mask broadcast too).  Every fork the pool replaces (a respawn, a swap)
is released on every rank: each rank holds as many states as rank 0.
"""
import json
import os
import subprocess
import sys
import textwrap

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
from repro_torch.serving import server as sv  # noqa: E402
from repro_torch.serving.state import ServingState  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, C, NQ, REPLICAS = 4000, 32, 32, 24, 3
RUNS = [("none", "", False), ("crash", "crash@1:t=0.05", False),
        ("corrupt", "corrupt@2:t=0.0,dur=0.2", False),
        ("crash_tau", "crash@1:t=0.05", True),
        ("ivf", "crash@2:t=0.05", False)]

COMMON = textwrap.dedent(
    """
    import numpy as np

    from repro_torch import convert
    from repro_torch.serving import queue as rq
    from repro_torch.serving.batcher import k_ceilings
    from repro_torch.serving.faults import FaultSchedule
    from repro_torch.serving.router import ReplicaServer, outcome_digest

    KS, BATCH, N_PROBE, REPLICAS = (50, 120), 4, 8, 3
    # the runs followed by a rolling swap onto the second index
    SWAPPED = ("none", "crash_tau", "ivf")


    # the index a run serves and its state's extra arguments: the
    # plain-IVF run serves the corpus vectors
    def state_args(ix, a, name):
        if name == "ivf":
            return ix["pq"].ivf, {"vectors": a["x"]}
        return ix["pq"], {}


    # what a run's rolling swap moves to: the plain-IVF run takes the
    # second index's IVF with the vectors and 5% of the rows tombstoned,
    # the others the second PQ index with a drift probe
    def swap_args(ix, a, name):
        if name == "ivf":
            return ix["pq2"].ivf, {"vectors": a["x"], "live": a["live"]}
        return ix["pq2"], {"probe_qs": a["qs"][:4]}


    def load(src):
        a = dict(np.load(src))
        out = {}
        for tag in ("pq", "pq2"):
            out[tag], _ = convert.pq_index_from_numpy(
                {"ivf_centroids": a[f"{tag}_ivf_centroids"],
                 "member_ids": a[f"{tag}_member_ids"],
                 "member_valid": a[f"{tag}_member_valid"],
                 "cluster_sizes": a[f"{tag}_cluster_sizes"],
                 "vectors": a["x"],
                 "pq_centroids": a[f"{tag}_pq_centroids"],
                 "codes": a[f"{tag}_codes"]}, device="cpu")
        return a, out


    def serve(state, qs, spec, ckpt=None):
        trace = rq.make_trace(np.random.default_rng(5), qs, KS, rate=500.0,
                              deadline=30.0, n_probe=N_PROBE)
        srv = ReplicaServer(
            state, REPLICAS, ceilings=k_ceilings(KS), batch=BATCH,
            faults=FaultSchedule.parse(spec) if spec else None,
            service_time_fn=lambda b: 0.01, checkpoint_dir=ckpt,
            checkpoint_every=1)
        return srv, trace, srv.run_trace(trace)


    def record(srv, outcomes):
        return {"digest": outcome_digest(outcomes),
                "assignments": [list(a) for a in srv.assignments],
                "stats": dict(sorted(srv.stats.items()))}
    """
)

RANK_SCRIPT = COMMON + textwrap.dedent(
    """
    import json, sys
    import torch
    import torch.distributed as tdist
    import torch.multiprocessing as mp


    def pred_table(states):
        return [{f"{b.k}/{b.batch}/{b.n_probe}": (s.ema.tolist(),
                                                  float(s.weight))
                 for b, s in st.pred_states().items()} for st in states]


    def rank_main(rank, world, src, dst, store, ckpt):
        torch.set_num_threads(1)
        tdist.init_process_group("gloo", init_method=f"file://{store}",
                                 rank=rank, world_size=world)
        from repro_torch.core import distributed as dist
        from repro_torch.serving import lockstep
        from repro_torch.serving import server as sv
        from repro_torch.serving.state import ServingState
        a, ix = load(src)
        mesh = dist.make_mesh((world,), ("model",))
        out = {}
        for name, spec, tau in json.loads(a["runs"].item()):
            # every state of this rank, in the order made: the base, then
            # each fork (the same order on every rank: the sids)
            made = []
            base = lockstep.LockstepState if rank == 0 else ServingState

            class Recorded(base):
                released = False

                def fork(self, *args, **kw):
                    twin = super().fork(*args, **kw)
                    made.append(twin)
                    return twin

                def release(self):
                    super().release()
                    self.released = True

            index, kw = state_args(ix, a, name)
            state = Recorded(index, use_bbc=True, tau_pred=tau, mesh=mesh,
                             **kw)
            made.append(state)
            if rank == 0:
                srv, trace, got = serve(state, a["qs"], spec,
                                        ckpt=f"{ckpt}/{name}" if tau
                                        else None)
                out[name] = record(srv, got)
                if not tau:
                    out[name]["parity"] = sv.parity_vs_direct(state, got)
                if name in SWAPPED:
                    index, kw = swap_args(ix, a, name)
                    srv.pool.rolling_swap(index, **kw)
                    got = srv.run_trace(trace)
                    key = f"{name}+swap"
                    out[key] = record(srv, got)
                    if not tau:
                        out[key]["parity"] = sv.parity_vs_direct(state, got)
                    out[key]["generation"] = [r.generation for r in srv.pool]
                state.stop()
            else:
                assert lockstep.follow(state) > 0
            every = [None] * world
            tdist.all_gather_object(every, pred_table(made))
            released = [None] * world
            tdist.all_gather_object(released, [st.released for st in made])
            if rank == 0:
                out[name]["pred_states"] = every
                out[name]["released"] = released
        if rank == 0:
            with open(dst, "w") as f:
                json.dump(out, f)
        tdist.barrier()
        tdist.destroy_process_group()


    if __name__ == "__main__":
        world = int(sys.argv[1])
        mp.spawn(rank_main, args=(world, *sys.argv[2:6]), nprocs=world,
                 join=True)
        print("LOCKSTEP_OK")
    """
)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = synthetic.clustered(rng, N, D, n_centers=32)
    qs = synthetic.queries_from(rng, x, NQ)
    jx = jnp.asarray(x)
    jix = {"pq": jsearch.build_pq_index(jax.random.key(0), jx, C, n_iter=3),
           "pq2": jsearch.build_pq_index(jax.random.key(1), jx, C,
                                         n_iter=5)}
    assert np.array_equal(np.asarray(jix["pq"].vectors), x)
    tmp = tmp_path_factory.mktemp("replica_sharded")
    arrays = {}
    for tag, ix in jix.items():
        arrays.update({
            f"{tag}_ivf_centroids": ix.ivf.centroids,
            f"{tag}_member_ids": ix.ivf.member_ids,
            f"{tag}_member_valid": ix.ivf.member_valid,
            f"{tag}_cluster_sizes": ix.ivf.cluster_sizes,
            f"{tag}_pq_centroids": ix.pq.centroids, f"{tag}_codes": ix.codes})
    src = tmp / "index.npz"
    live = np.ones(N, bool)
    live[rng.choice(N, N // 20, replace=False)] = False
    np.savez(src, x=x, qs=qs, live=live, runs=np.array(json.dumps(RUNS)),
             **{k: np.asarray(v) for k, v in arrays.items()})
    ns: dict = {}
    exec(COMMON, ns)
    a, ix = ns["load"](src)
    return dict(x=x, qs=qs, src=src, tmp=tmp, ns=ns, ix=ix, jix=jix, a=a)


def _reference(setup, name, spec, tau, tmp_path):
    """The JAX package's single-device replica run: its ``ReplicaServer``
    over its ``ServingState`` on its own index, with the same trace, fault
    schedule, service model, checkpoints and rolling swap as the ranks'."""
    ns, jix = setup["ns"], setup["jix"]
    jx = jnp.asarray(setup["x"])
    index, kw = (jix["pq"].ivf, {"vectors": jx}) if name == "ivf" \
        else (jix["pq"], {})
    state = JServingState(index, use_bbc=True, tau_pred=tau, **kw)
    trace = jrq.make_trace(np.random.default_rng(5), setup["qs"], ns["KS"],
                           rate=500.0, deadline=30.0, n_probe=ns["N_PROBE"])
    srv = jrouter.ReplicaServer(
        state, REPLICAS, ceilings=jbt.k_ceilings(ns["KS"]),
        batch=ns["BATCH"],
        faults=jflt.FaultSchedule.parse(spec) if spec else None,
        service_time_fn=lambda b: 0.01,
        checkpoint_dir=str(tmp_path / f"ref_{name}") if tau else None,
        checkpoint_every=1)

    def record(outcomes):
        return {"digest": jrouter.outcome_digest(outcomes),
                "assignments": [list(a) for a in srv.assignments],
                "stats": dict(sorted(srv.stats.items()))}

    want = {name: record(srv.run_trace(trace))}
    if name in ns["SWAPPED"]:
        if name == "ivf":
            srv.pool.rolling_swap(jix["pq2"].ivf, vectors=jx,
                                  live=jnp.asarray(setup["a"]["live"]))
        else:
            srv.pool.rolling_swap(jix["pq2"],
                                  probe_qs=jnp.asarray(setup["qs"][:4]))
        want[f"{name}+swap"] = record(srv.run_trace(trace))
    return want


def _single_device(setup, name, spec, tau, tmp_path):
    """The port's single-device replica run on the carried index."""
    ns = setup["ns"]
    index, kw = ns["state_args"](setup["ix"], setup["a"], name)
    state = ServingState(index, use_bbc=True, tau_pred=tau, device="cpu",
                         **kw)
    srv, trace, got = ns["serve"](state, setup["qs"], spec,
                                  ckpt=str(tmp_path / name) if tau else None)
    port = {name: ns["record"](srv, got)}
    if name in ns["SWAPPED"]:
        index, kw = ns["swap_args"](setup["ix"], setup["a"], name)
        srv.pool.rolling_swap(index, **kw)
        port[f"{name}+swap"] = ns["record"](srv, srv.run_trace(trace))
    return port, got


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, setup):
    world = request.param
    script = setup["tmp"] / "ranks.py"
    script.write_text(RANK_SCRIPT)
    dst = setup["tmp"] / f"out{world}.json"
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run(
        [sys.executable, str(script), str(world), str(setup["src"]),
         str(dst), str(setup["tmp"] / f"store{world}"),
         str(setup["tmp"] / f"ckpt{world}")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert "LOCKSTEP_OK" in out.stdout, out.stderr[-3000:]
    return world, json.loads(dst.read_text())


@pytest.mark.multidevice
@pytest.mark.parametrize("name,spec,tau", RUNS,
                         ids=[r[0] for r in RUNS])
def test_sharded_replica_tier_equals_reference(setup, ranks, name, spec,
                                               tau, tmp_path):
    world, out = ranks
    want = _reference(setup, name, spec, tau, tmp_path)
    port, outcomes = _single_device(setup, name, spec, tau, tmp_path)
    assert port == want
    for key in want:
        got = out[key]
        assert got["digest"] == want[key]["digest"], key
        assert got["assignments"] == want[key]["assignments"], key
        assert got["stats"] == want[key]["stats"], key
        if not tau:
            assert got["parity"] == [1.0, len(outcomes)], key
        if key.endswith("+swap"):
            assert got["generation"] == [1] * REPLICAS
    assert len(outcomes) == NQ and all(o.status == sv.OK for o in outcomes)
    if "crash" in spec:
        assert out[name]["stats"]["respawns"] == 1
    if name == "corrupt":
        assert out[name]["stats"]["corrupt_detected"] > 0
    # every rank threads the same predictor states in every state: the
    # base, the replicas' forks and the respawned replica's, by sid
    states = out[name]["pred_states"]
    assert len(states) == world and all(s == states[0] for s in states)
    # each run forks a state per replica and one per respawn
    runs = 1 + (name in setup["ns"]["SWAPPED"])
    forks = runs * (REPLICAS + ("crash" in spec))
    assert len(states[0]) == 1 + forks
    assert any(states[0]) == tau
    # every fork the pool replaced was released on every rank: each holds
    # rank 0's live states, the base and one per replica
    released = out[name]["released"]
    assert all(r == released[0] for r in released)
    assert released[0].count(False) == 1 + REPLICAS


def test_respawn_restores_the_checkpoint_on_every_rank(setup, ranks):
    """The respawned replica's fork starts from replica 1's latest verified
    checkpoint, on rank 0 and on every following rank: not cold, and not
    its state before the crash."""
    world, out = ranks
    table = out["crash_tau"]["pred_states"]
    respawned = table[0][-1]
    assert respawned and all(t[-1] == respawned for t in table)
    assert all(w > 0 for _, w in respawned.values())


def test_lockstep_swap_and_fork_on_one_rank(setup, tmp_path):
    """On a one-rank mesh (nobody follows) ``swap`` returns the new
    generation with the reference's drift report, ``fork`` gives each
    fork its own sid over the shared engines, and a fork is released while
    the base is kept until ``stop``."""
    import torch.distributed as tdist
    from repro_torch.core import distributed
    from repro_torch.serving import lockstep
    from repro_torch.serving.batcher import Batch, ShapeBucket
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                             rank=0, world_size=1)
    try:
        mesh = distributed.make_mesh((1,))
        state = lockstep.LockstepState(setup["ix"]["pq"], mesh=mesh,
                                       use_bbc=True, tau_pred=True)
        bucket = ShapeBucket(k=64, batch=4, n_probe=8)
        state.run(Batch(bucket=bucket, requests=(),
                        queries=setup["qs"][:4]))
        twin = state.fork()
        assert (twin.sid, state.sid) == (1, 0)
        assert twin._engines is state._engines and twin.pred_states() == {}
        respawn = state.fork(clone_engines=True,
                             pred_states=state.pred_states())
        assert respawn.sid == 2 and respawn._engines is not state._engines
        assert respawn.pred_states() == state.pred_states()
        report = state.swap(setup["ix"]["pq2"], probe_qs=setup["qs"][4:8])
        assert state.generation == 1 and set(report) == {(64, 8)}
        assert state.engine(bucket).generation == 1
        assert twin.generation == 0
        respawn.release()
        with pytest.raises(ValueError, match="sid 0"):
            state.release()
        state.stop()
    finally:
        tdist.destroy_process_group()
