"""The port's mesh-sharded deployment on the CPU: ``ivf.sharded_layout``
against the JAX package's, array for array, and the three sharded searchers
on a one-rank gloo mesh against the JAX package's on its one-device mesh,
on the reference's own indexes carried across with ``convert``.

Config: 8000 x 32 clustered, 32 clusters, 8 queries per batch, k=200,
n_probe=12, m=128.  Every form (static, predictive over 3 batches, naive;
RaBitQ's two-phase form too) must give the reference's id set for every
query, sorted distances within rtol=atol=1e-4, and equal ``n_reranked``
and ``n_second_pass``.  RaBitQ is held against the JAX package's default
backend: its composed branch and the port's kernel structure compute the
same counters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as tdist  # noqa: E402

from repro.data import synthetic  # noqa: E402
from repro.index import engine as jengine  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core import numerics  # noqa: E402
from repro_torch.index import engine, ivf, search  # noqa: E402

torch.set_num_threads(2)

N, D, C, B = 8000, 32, 32, 8
K, N_PROBE = 200, 12


def _pq_arrays(ji) -> dict:
    return {k: np.asarray(v) for k, v in {
        "ivf_centroids": ji.ivf.centroids, "member_ids": ji.ivf.member_ids,
        "member_valid": ji.ivf.member_valid,
        "cluster_sizes": ji.ivf.cluster_sizes, "vectors": ji.vectors,
        "pq_centroids": ji.pq.centroids, "codes": ji.codes}.items()}


def _rq_arrays(ji) -> dict:
    return {k: np.asarray(v) for k, v in {
        "ivf_centroids": ji.ivf.centroids, "member_ids": ji.ivf.member_ids,
        "member_valid": ji.ivf.member_valid,
        "cluster_sizes": ji.ivf.cluster_sizes, "vectors": ji.vectors,
        "rot": ji.rq.rot, "codes": ji.rq.codes, "norm_o": ji.rq.norm_o,
        "f_o": ji.rq.f_o}.items()}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    x = synthetic.clustered(rng, N, D, n_centers=48)
    qs = synthetic.queries_from(rng, x, 3 * B)
    key = jax.random.key(0)
    jx = jnp.asarray(x)
    jpq = jsearch.build_pq_index(key, jx, C, n_iter=4)
    jrq = jsearch.build_rabitq_index(key, jx, C, n_iter=4)
    tpq, _ = convert.pq_index_from_numpy(_pq_arrays(jpq), device="cpu")
    trq, _ = convert.rabitq_index_from_numpy(_rq_arrays(jrq), device="cpu")
    return dict(x=x, qs=qs, jx=jx, jpq=jpq, jrq=jrq, tpq=tpq, trq=trq)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """A one-rank gloo group in this process and the JAX one-device mesh."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    tdist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                             world_size=1)
    try:
        yield dist.make_mesh((1,), ("model",)), \
            jax.make_mesh((1,), ("model",))
    finally:
        tdist.destroy_process_group()


def _assert_same(jr, tr):
    jids, tids = np.asarray(jr.ids), tr.ids.numpy()
    for row in range(jids.shape[0]):
        assert set(jids[row].tolist()) == set(tids[row].tolist()), row
    np.testing.assert_allclose(np.sort(tr.dists.numpy(), 1),
                               np.sort(np.asarray(jr.dists), 1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tr.n_reranked.numpy(),
                                  np.asarray(jr.n_reranked))
    np.testing.assert_array_equal(tr.n_second_pass.numpy(),
                                  np.asarray(jr.n_second_pass))


@pytest.mark.parametrize("s", [1, 2, 8])
def test_sharded_layout_matches_reference(data, s):
    jl, jcap = jivf.sharded_layout(data["jpq"].ivf, s)
    tl, tcap = ivf.sharded_layout(data["tpq"].ivf, s)
    assert tcap == jcap and tl.n_shards == s
    for name, a, b in zip(tl._fields, jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    local = tl.local(s - 1)
    assert local.order.shape[0] == tl.shard_flat
    assert int(local.offsets[-1]) == int(local.valid.sum())


def _engines(data, meshes, kind, **kw):
    tmesh, jmesh = meshes
    if kind == "ivf":
        ji, ti = data["jpq"].ivf, data["tpq"].ivf
        kw = dict(kw, vectors=None)
        jv, tv = data["jx"], data["x"]
    else:
        ji, ti = data["j" + kind], data["t" + kind]
        jv = tv = None
    je = jengine.SearchEngine.build(ji, k=K, n_probe=N_PROBE, mesh=jmesh,
                                    **dict(kw, vectors=jv))
    te = engine.SearchEngine.build(ti, k=K, n_probe=N_PROBE, mesh=tmesh,
                                   **dict(kw, vectors=tv))
    return je, te


def _stream_rows(kind, ti, x) -> dict:
    """Each per-lane tensor of ``kind``'s stream, as the index keeps it."""
    if kind == "ivf":
        return {"vectors": x}
    if kind == "pq":
        return {"vectors": ti.vectors, "codes": ti.codes}
    return {"vectors": ti.vectors, "codes": ti.rq.codes,
            "norm_o": ti.rq.norm_o, "f_o": ti.rq.f_o}


STREAM_SMALL = {"ivf": set(), "pq": {"pq"}, "rq": {"rot", "cl", "s2"}}


@pytest.mark.parametrize("on_mesh", [False, True],
                         ids=["one_device", "rank_block"])
@pytest.mark.parametrize("kind", ["ivf", "pq", "rq"])
def test_engine_stream_is_the_index_in_stream_order(data, meshes, kind,
                                                    on_mesh):
    """``SearchEngine.build`` gathers the corpus and its codes into stream
    order once: every per-lane tensor of ``eng.stream`` is the index's at
    ``layout.order``, bit for bit, on one device and on this rank's block
    of the one-rank mesh; the small tensors are the index's, and the
    fields of the other methods are None."""
    x = torch.from_numpy(data["x"])
    ti = data["tpq"].ivf if kind == "ivf" else data["t" + kind]
    kw = dict(vectors=x) if kind == "ivf" else {}
    where = dict(mesh=meshes[0]) if on_mesh else dict(device="cpu")
    eng = engine.SearchEngine.build(ti, k=K, n_probe=N_PROBE, **kw, **where)
    layout = eng.shard_layout if on_mesh else eng.layout
    st, rows = eng.stream, _stream_rows(kind, ti, x)
    for name, src in rows.items():
        assert torch.equal(getattr(st, name), src[layout.order]), name
    ivf_index = ti if kind == "ivf" else ti.ivf
    assert torch.equal(st.centroids, ivf_index.centroids)
    assert {f for f in st._fields if getattr(st, f) is not None} == \
        {"centroids", *rows, *STREAM_SMALL[kind]}
    if kind == "pq":
        assert torch.equal(st.pq.centroids, ti.pq.centroids)
    if kind == "rq":
        assert torch.equal(st.rot, ti.rq.rot)
        assert torch.equal(st.cl, torch.clamp(layout.cluster_of,
                                              max=C - 1).to(torch.int32))
        h = numerics.rotate(ivf_index.centroids, ti.rq.rot)
        assert torch.equal(st.s2, numerics.rabitq_s2(st.codes, h, st.cl))


FORMS = [("ivf", {}), ("pq", {}), ("rq", {}), ("rq", {"fused": False})]


@pytest.mark.parametrize("kind,kw", FORMS,
                         ids=["ivf", "ivfpq", "ivfrabitq", "rabitq_two_phase"])
def test_sharded_static_matches_reference(data, meshes, kind, kw):
    je, te = _engines(data, meshes, kind, **kw)
    assert te.mesh is meshes[0] and te.layout is None
    q = data["qs"][:B]
    _assert_same(je.search(jnp.asarray(q)), te.search(q))


@pytest.mark.parametrize("kind,kw", FORMS,
                         ids=["ivf", "ivfpq", "ivfrabitq", "rabitq_two_phase"])
def test_sharded_predictive_sequence_matches_reference(data, meshes, kind,
                                                       kw):
    je, te = _engines(data, meshes, kind, **kw)
    js, ts = je.predictor_init(), te.predictor_init()
    for i in range(3):
        q = data["qs"][i * B:(i + 1) * B]
        jr, js = je.search(jnp.asarray(q), pred_state=js)
        tr, ts = te.search(q, pred_state=ts)
        _assert_same(jr, tr)
    assert float(ts.weight) > 0


@pytest.mark.parametrize("kind", ["ivf", "pq", "rq"])
def test_sharded_naive_matches_reference(data, meshes, kind):
    je, te = _engines(data, meshes, kind, use_bbc=False)
    q = data["qs"][B:2 * B]
    _assert_same(je.search(jnp.asarray(q)), te.search(q))


def test_sharded_engine_refuses_what_is_not_ported(data, meshes):
    """Tombstones and a single query, once refused here, are ported: the
    sharded engine takes the JAX mesh engine's mask (an all-live one
    changes nothing) and serves a single query as a singleton batch, as
    the JAX mesh engine's single call does."""
    je, te = _engines(data, meshes, "pq")
    q8 = data["qs"][:B]
    _assert_same(je.with_live(np.ones(N, bool)).search(jnp.asarray(q8)),
                 te.with_live(np.ones(N, bool)).search(q8))
    q = data["qs"][0]
    jr, tr = je.search(jnp.asarray(q)), te.search(q)
    assert tr.ids.shape == (K,)
    _assert_same(jax.tree.map(lambda a: a[None], jr),
                 search.SearchResult(*(t[None] for t in tr)))
    with pytest.raises(ValueError, match="mesh"):
        engine.SearchEngine.build(data["tpq"], k=K, n_probe=N_PROBE,
                                  mesh=meshes[0], device="cuda")


@pytest.mark.parametrize("kind", ["ivf", "pq", "rq"])
def test_sharded_single_query_matches_reference(data, meshes, kind):
    """A (d,) query on the one-rank gloo mesh against the JAX engine's
    single call on its one-device mesh, static and predictive from cold."""
    je, te = _engines(data, meshes, kind)
    js, ts = je.predictor_init(), te.predictor_init()
    for q in data["qs"][:2]:
        jr, tr = je.search(jnp.asarray(q)), te.search(q)
        _assert_same(jax.tree.map(lambda a: a[None], jr),
                     search.SearchResult(*(t[None] for t in tr)))
        jr, js = je.search(jnp.asarray(q), pred_state=js)
        tr, ts = te.search(q, pred_state=ts)
        _assert_same(jax.tree.map(lambda a: a[None], jr),
                     search.SearchResult(*(t[None] for t in tr)))


def test_mesh_refuses_a_device_its_backend_cannot_carry(meshes):
    tmesh, _ = meshes
    assert tmesh.device.type == "cpu" and tmesh.n_shards == 1
    with pytest.raises(ValueError, match="nccl"):
        dist.make_mesh((1,), ("model",), device="cuda")
    x = torch.ones(3, device="meta")
    with pytest.raises(ValueError, match="no host staging"):
        dist.hier_psum(x, tmesh)
    assert torch.equal(dist.hier_psum(torch.ones(3), tmesh), torch.ones(3))
    assert torch.equal(dist.hier_psum(torch.ones(3), None), torch.ones(3))


def test_collective_cost_model_prices_nvlink():
    from repro.core import distributed as jdist
    for kw in ({}, {"n_hosts": 2}):
        want = jdist.collective_cost_model(5000, 128, 4, link_bw=450e9,
                                           dcn_bw=450e9, **kw)
        got = dist.collective_cost_model(5000, 128, 4, **kw)
        assert got == pytest.approx(want)
    assert dist.NVLINK_BYTES_PER_S == 450e9


def test_single_query_collectives_keep_the_top_k(meshes, rng):
    """``bbc_shard_search`` and ``naive_shard_search`` on the one-rank mesh
    return the flat top-k of the valid lanes when the budget holds the
    survivors (the reference's single-query collectives, batched)."""
    from repro_torch.core import buffer as rb
    tmesh, _ = meshes
    b, n, k = 4, 3000, 100
    d = torch.from_numpy(rng.random((b, n)).astype(np.float32))
    valid = torch.from_numpy(rng.random((b, n)) < 0.6)
    ids = torch.arange(n) + 10_000
    want_d, want_pos = rb.smallest(torch.where(valid, d, float("inf")), k)
    cb = rb.build_codebook(d, k=k, m=64, valid=valid)
    got = dist.bbc_shard_search(d, ids, valid, cb, k, 1, tmesh)
    assert torch.equal(got.topk_dists, want_d)
    assert torch.equal(got.topk_ids, ids[want_pos])
    assert bool((got.survivors_per_shard >= k).all())
    nd, ni = dist.naive_shard_search(d, ids, valid, k, tmesh)
    assert torch.equal(nd, want_d) and torch.equal(ni, ids[want_pos])


def test_kth_value_mask_keeps_the_reference_set(rng):
    """The post-gather re-cut keeps the reference bisection's set: the kth
    smallest (value, global id) pairs, with ties at the boundary value (as
    PQ estimates tie) and padding (+inf, -1) lanes in the pool."""
    rows, w, kth = 6, 400, 150
    vals = rng.integers(0, 40, (rows, w)).astype(np.float32) / 8
    ids = np.stack([rng.permutation(10_000)[:w] for _ in range(rows)])
    pad = rng.random((rows, w)) < 0.1
    vals[pad], ids[pad] = np.inf, -1
    ids = ids.astype(np.int32)
    want = np.asarray(jsearch._kth_value_mask(jnp.asarray(vals),
                                              jnp.asarray(ids), kth))
    got = search._kth_value_mask(torch.from_numpy(vals),
                                 torch.from_numpy(ids).long(), kth).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(axis=1) == kth).all()
