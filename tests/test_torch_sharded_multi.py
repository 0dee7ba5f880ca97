"""The port's sharded searchers on 4 gloo ranks against the JAX package's
on 4 forced host devices, on the same index and the same meshes: (4,) and
the 2-D (2, 2) ("host", "model") mesh of the hierarchical schedule.

A JAX subprocess builds the indexes, runs the three sharded searchers and
writes the index arrays and the results to an npz; a second subprocess
spawns 4 gloo ranks of the port (``file://`` store) that load the same
arrays, run the same forms and write their results.  Bars: the same id set
per query, sorted distances within rtol=atol=1e-4, equal ``n_reranked`` and
``n_second_pass``.  The port's own sharded engine (S=4) must also return
its batched engine's id sets (the JAX package's ``assert_parity``), and the
CLI's ``--shards 2 --device cpu`` must serve the verify config.

Config: 8000 x 32 clustered, 32 clusters, n_probe=8, k=500, B=8, m=128,
where every shard's survivors fit the default per-shard budget.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.data import synthetic
    from repro.index import engine, search

    out = {}
    rng = np.random.default_rng(3)
    x = synthetic.clustered(rng, 8000, 32, n_centers=48)
    qs = synthetic.queries_from(rng, x, 16)
    key = jax.random.key(0)
    jx = jnp.asarray(x)
    pq = search.build_pq_index(key, jx, 32, n_iter=4)
    rq = search.build_rabitq_index(key, jx, 32, n_iter=4)
    out.update(x=x, qs=qs, ivf_centroids=pq.ivf.centroids,
               member_ids=pq.ivf.member_ids,
               member_valid=pq.ivf.member_valid,
               cluster_sizes=pq.ivf.cluster_sizes,
               pq_centroids=pq.pq.centroids, pq_codes=pq.codes,
               rq_ivf_centroids=rq.ivf.centroids,
               rq_member_ids=rq.ivf.member_ids,
               rq_member_valid=rq.ivf.member_valid,
               rq_cluster_sizes=rq.ivf.cluster_sizes, rot=rq.rq.rot,
               rq_codes=rq.rq.codes, norm_o=rq.rq.norm_o, f_o=rq.rq.f_o)
    index = {"ivf": pq.ivf, "pq": pq, "rq": rq}
    meshes = {"m4": jax.make_mesh((4,), ("model",)),
              "m22": jax.make_mesh((2, 2), ("host", "model"))}

    def keep(name, r):
        for f in ("dists", "ids", "n_reranked", "n_second_pass"):
            out[f"{name}:{f}"] = np.asarray(getattr(r, f))

    for kind, ix in index.items():
        vec = dict(vectors=jx) if kind == "ivf" else {}
        for mname, mesh in meshes.items():
            e = engine.SearchEngine.build(ix, k=500, n_probe=8, mesh=mesh,
                                          **vec)
            keep(f"{kind}:{mname}:static", e.search(jnp.asarray(qs[:8])))
            if mname != "m4":
                continue
            st = e.predictor_init()
            for i in range(2):
                r, st = e.search(jnp.asarray(qs[8 * i:8 * (i + 1)]),
                                 pred_state=st)
                keep(f"{kind}:{mname}:pred{i}", r)
            e = engine.SearchEngine.build(ix, k=500, n_probe=8, mesh=mesh,
                                          use_bbc=False, **vec)
            keep(f"{kind}:{mname}:naive", e.search(jnp.asarray(qs[8:])))
    np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
    print("JAX_SHARDED_OK")
    """
)

PORT_SCRIPT = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    import torch.distributed as tdist
    import torch.multiprocessing as mp


    def rank_main(rank, src, dst, store):
        torch.set_num_threads(1)
        tdist.init_process_group("gloo", init_method=f"file://{store}",
                                 rank=rank, world_size=4)
        from repro_torch import convert
        from repro_torch.core import distributed as dist
        from repro_torch.index import engine
        a = dict(np.load(src))
        common = {k: a[k] for k in ("ivf_centroids", "member_ids",
                                    "member_valid", "cluster_sizes")}
        pq, _ = convert.pq_index_from_numpy(
            dict(common, vectors=a["x"], pq_centroids=a["pq_centroids"],
                 codes=a["pq_codes"]), device="cpu")
        rq, _ = convert.rabitq_index_from_numpy(
            {"ivf_centroids": a["rq_ivf_centroids"],
             "member_ids": a["rq_member_ids"],
             "member_valid": a["rq_member_valid"],
             "cluster_sizes": a["rq_cluster_sizes"], "vectors": a["x"],
             "rot": a["rot"], "codes": a["rq_codes"],
             "norm_o": a["norm_o"], "f_o": a["f_o"]}, device="cpu")
        index = {"ivf": pq.ivf, "pq": pq, "rq": rq}
        meshes = {"m4": dist.make_mesh((4,), ("model",)),
                  "m22": dist.make_mesh((2, 2), ("host", "model"))}
        qs, out = torch.from_numpy(a["qs"]), {}

        def keep(name, r):
            for f in ("dists", "ids", "n_reranked", "n_second_pass"):
                out[f"{name}:{f}"] = getattr(r, f).numpy()

        x = torch.from_numpy(a["x"])
        for kind, ix in index.items():
            vec = dict(vectors=x) if kind == "ivf" else {}
            for mname, mesh in meshes.items():
                e = engine.SearchEngine.build(ix, k=500, n_probe=8,
                                              mesh=mesh, **vec)
                keep(f"{kind}:{mname}:static", e.search(qs[:8]))
                if mname != "m4":
                    continue
                st = e.predictor_init()
                for i in range(2):
                    r, st = e.search(qs[8 * i:8 * (i + 1)], pred_state=st)
                    keep(f"{kind}:{mname}:pred{i}", r)
                e = engine.SearchEngine.build(ix, k=500, n_probe=8,
                                              mesh=mesh, use_bbc=False,
                                              **vec)
                keep(f"{kind}:{mname}:naive", e.search(qs[8:]))
            if rank == 0:    # the port's batched engine: no collective
                b = engine.SearchEngine.build(ix, k=500, n_probe=8,
                                              device="cpu", **vec)
                keep(f"{kind}:batched", b.search(qs[:8]))
        if rank == 0:
            np.savez(dst, **out)
        tdist.barrier()
        tdist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(rank_main, args=tuple(sys.argv[1:4]), nprocs=4, join=True)
        print("PORT_SHARDED_OK")
    """
)


def _run(args, marker, tmp):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run(args, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=600)
    assert marker in out.stdout, out.stdout[-2000:] + "\n" + out.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    pytest.importorskip("torch")
    tmp = tmp_path_factory.mktemp("sharded_multi")
    ref, port = tmp / "jax.npz", tmp / "port.npz"
    _run([sys.executable, "-c", JAX_SCRIPT, str(ref)], "JAX_SHARDED_OK", tmp)
    script = tmp / "port_ranks.py"
    script.write_text(PORT_SCRIPT)
    _run([sys.executable, str(script), str(ref), str(port),
          str(tmp / "store")], "PORT_SHARDED_OK", tmp)
    return dict(np.load(ref)), dict(np.load(port))


def _same(results, name, jname=None):
    ref, port = results
    jname = jname or name
    for row in range(ref[f"{jname}:ids"].shape[0]):
        assert set(ref[f"{jname}:ids"][row].tolist()) == \
            set(port[f"{name}:ids"][row].tolist()), (name, row)
    np.testing.assert_allclose(np.sort(port[f"{name}:dists"], 1),
                               np.sort(ref[f"{jname}:dists"], 1),
                               rtol=1e-4, atol=1e-4, err_msg=name)
    for f in ("n_reranked", "n_second_pass"):
        np.testing.assert_array_equal(port[f"{name}:{f}"],
                                      ref[f"{jname}:{f}"], err_msg=name)


KINDS = ["ivf", "pq", "rq"]


@pytest.mark.multidevice
@pytest.mark.parametrize("mesh", ["m4", "m22"])
@pytest.mark.parametrize("kind", KINDS)
def test_four_ranks_static_match_reference(results, kind, mesh):
    _same(results, f"{kind}:{mesh}:static")


@pytest.mark.multidevice
@pytest.mark.parametrize("kind", KINDS)
def test_four_ranks_predictive_match_reference(results, kind):
    for i in range(2):
        _same(results, f"{kind}:m4:pred{i}")


@pytest.mark.multidevice
@pytest.mark.parametrize("kind", KINDS)
def test_four_ranks_naive_match_reference(results, kind):
    _same(results, f"{kind}:m4:naive")


@pytest.mark.multidevice
@pytest.mark.parametrize("kind", KINDS)
def test_four_ranks_equal_the_batched_engine(results, kind):
    """The JAX package's ``assert_parity``: the sharded engine's id sets
    are the batched engine's, on a flat and on a 2-D mesh."""
    _, port = results
    want = port[f"{kind}:batched:ids"]
    for mesh in ("m4", "m22"):
        got = port[f"{kind}:{mesh}:static:ids"]
        for row in range(want.shape[0]):
            assert set(got[row].tolist()) == set(want[row].tolist()), \
                (kind, mesh, row)


@pytest.mark.multidevice
def test_serve_cli_two_cpu_shards():
    pytest.importorskip("torch")
    out = _run([sys.executable, "-m", "repro_torch.launch.serve",
                "--device", "cpu", "--shards", "2", "--n", "12000", "--d",
                "64", "--k", "500", "--n-clusters", "64", "--queries", "16",
                "--batch", "8"], '"shards": 2', None)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["shards"] == 2 and line["device"] == "cpu"
    assert line["recall_mean"] >= 0.9
