"""Tombstone lane masks (streaming-ingest deletes) in the port, against the
JAX package's ``SearchEngine.with_live`` on the same index and the same
corpus-row mask.

Config: the JAX package's tombstone test (N=6000, D=32, 24 clusters,
k=150, m=64), 6 queries, n_probe=8, so the dead rows sit inside probed
clusters; the mask deletes 1/7 of the rows and each query's exact top 10.
For every method and form (PQ fused, unfused, without BBC and predictive;
RaBitQ fused, two-phase, threshold baseline and predictive; IVF; batched,
single (d,) queries and sharded on 4 gloo ranks) the id sets equal the
reference's, sorted distances agree within rtol=atol=1e-4 (the bar of
``tests/test_search_batch.py:139-144``; each RaBitQ form is held against
the same form of the reference, ROADMAP.md queue 3), the counters are
equal, and no deleted id surfaces.  The histograms count only live lanes,
equal to the JAX mirror on the same estimate; on a card each kernel that
sees a tombstoned mask equals its plain version bit for bit.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import buffer as jrb  # noqa: E402
from repro.core import rerank as jrr  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.index import engine as jengine  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import buffer as rb  # noqa: E402
from repro_torch.core import rerank as rr  # noqa: E402
from repro_torch.index import engine, ivf, search  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, NQ, K, C, N_PROBE, M = 6000, 32, 6, 150, 24, 8, 64


def _ivf_arrays(ji):
    return {"ivf_centroids": ji.ivf.centroids,
            "member_ids": ji.ivf.member_ids,
            "member_valid": ji.ivf.member_valid,
            "cluster_sizes": ji.ivf.cluster_sizes, "vectors": ji.vectors}


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    x = synthetic.clustered(rng, N, D, n_centers=48)
    qs = synthetic.queries_from(rng, x, NQ)
    jx = jnp.asarray(x)
    key = jax.random.key(0)
    jpq = jsearch.build_pq_index(key, jx, C, n_iter=4)
    jrq = jsearch.build_rabitq_index(key, jx, C, n_iter=4)
    tpq, _ = convert.pq_index_from_numpy(_np(dict(
        _ivf_arrays(jpq), pq_centroids=jpq.pq.centroids, codes=jpq.codes)),
        device="cpu")
    trq, _ = convert.rabitq_index_from_numpy(_np(dict(
        _ivf_arrays(jrq), rot=jrq.rq.rot, codes=jrq.rq.codes,
        norm_o=jrq.rq.norm_o, f_o=jrq.rq.f_o)), device="cpu")
    live = np.ones(N, bool)
    live[np.random.default_rng(3).choice(N, N // 7, replace=False)] = False
    d = ((qs[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    for bi in range(NQ):
        live[np.argsort(d[bi])[:10]] = False
    return dict(x=x, qs=qs, jx=jx, jpq=jpq, jrq=jrq, tpq=tpq, trq=trq,
                live=live)


def _engines(data, kind, **kw):
    """(JAX engine, port engine) over the same index, unmasked.  ``backend``
    picks the reference's path (the port runs its kernel branch)."""
    backend = kw.pop("backend", "ref")
    kw = dict(k=K, n_probe=N_PROBE, m=M, **kw)
    if kind == "ivfpq":
        return (jengine.SearchEngine.build(data["jpq"], backend=backend,
                                           **kw),
                engine.SearchEngine.build(data["tpq"], device="cpu", **kw))
    if kind == "ivfrabitq":
        return (jengine.SearchEngine.build(data["jrq"], backend=backend,
                                           **kw),
                engine.SearchEngine.build(data["trq"], device="cpu", **kw))
    return (jengine.SearchEngine.build(data["jpq"].ivf, vectors=data["jx"],
                                       backend=backend, **kw),
            engine.SearchEngine.build(data["tpq"].ivf, vectors=data["x"],
                                      device="cpu", **kw))


def _assert_same(jr, tr, live, counters=True):
    jids, tids = np.atleast_2d(np.asarray(jr.ids)), np.atleast_2d(
        tr.ids.numpy())
    dead = set(np.flatnonzero(~live).tolist())
    for row in range(jids.shape[0]):
        got = set(tids[row].tolist())
        assert got == set(jids[row].tolist()), row
        assert not (got & dead), row
    np.testing.assert_allclose(
        np.sort(np.atleast_2d(tr.dists.numpy()), 1),
        np.sort(np.atleast_2d(np.asarray(jr.dists)), 1), rtol=1e-4,
        atol=1e-4)
    if counters:
        np.testing.assert_array_equal(tr.n_reranked.numpy(),
                                      np.asarray(jr.n_reranked))
        np.testing.assert_array_equal(tr.n_second_pass.numpy(),
                                      np.asarray(jr.n_second_pass))


FORMS = {
    "pq_fused": ("ivfpq", dict(use_bbc=True, fused=True)),
    "pq_unfused": ("ivfpq", dict(use_bbc=True, fused=False)),
    "pq_no_bbc": ("ivfpq", dict(use_bbc=False, fused=False)),
    "rq_fused": ("ivfrabitq", dict(use_bbc=True, fused=True,
                                   backend="pallas")),
    "rq_two_phase": ("ivfrabitq", dict(use_bbc=True, fused=False)),
    "rq_baseline": ("ivfrabitq", dict(use_bbc=False)),
    "ivf_bbc": ("ivf", dict(use_bbc=True)),
    "ivf_topk": ("ivf", dict(use_bbc=False)),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_batched_with_live_matches_reference(data, form):
    kind, kw = FORMS[form]
    je, te = _engines(data, kind, **kw)
    jr = je.with_live(data["live"]).search(jnp.asarray(data["qs"]))
    tr = te.with_live(data["live"]).search(torch.from_numpy(data["qs"]))
    _assert_same(jr, tr, data["live"])
    # the mask moved the answer: the unmasked engine returns dead ids
    dead = ~data["live"][te.search(torch.from_numpy(data["qs"])).ids.numpy()]
    assert dead.any()


PRED_FORMS = {
    "pq_fused": ("ivfpq", dict(fused=True)),
    "pq_unfused": ("ivfpq", dict(fused=False)),
    "rq_fused": ("ivfrabitq", dict(fused=True, backend="pallas")),
    "ivf": ("ivf", {}),
}


@pytest.mark.parametrize("form", list(PRED_FORMS))
def test_predictive_with_live_matches_reference(data, form):
    """Two predictive batches threading the EMA: the same ids and the same
    predicted tau, so the histograms fed to the EMA counted the same
    (live) lanes."""
    kind, kw = PRED_FORMS[form]
    je, te = _engines(data, kind, use_bbc=True, **kw)
    je, te = je.with_live(data["live"]), te.with_live(data["live"])
    js, ts = je.predictor_init(), te.predictor_init()
    for sl in (slice(0, 4), slice(2, 6)):
        jr, js = je.search(jnp.asarray(data["qs"][sl]), pred_state=js)
        tr, ts = te.search(torch.from_numpy(data["qs"][sl]), pred_state=ts)
        _assert_same(jr, tr, data["live"])
        assert rr.predict_tau(ts, K) == int(jrr.predict_tau(js, K))


@pytest.mark.parametrize("kind", ["ivfpq", "ivfrabitq", "ivf"])
def test_single_query_with_live_matches_reference(data, kind):
    """A (d,) query on an engine with a mask is served as a singleton
    batch, as the reference's ``search_one`` does."""
    kw = dict(backend="pallas") if kind == "ivfrabitq" else {}
    je, te = _engines(data, kind, use_bbc=True, **kw)
    je, te = je.with_live(data["live"]), te.with_live(data["live"])
    for row in (0, 3):
        q = data["qs"][row]
        tr = te.search(torch.from_numpy(q))
        assert tr.ids.shape == (K,)
        _assert_same(je.search(jnp.asarray(q)), tr, data["live"])
        # it is the batched searcher's row
        assert torch.equal(tr.ids, te.search(torch.from_numpy(
            data["qs"][row:row + 1])).ids[0])


def test_with_live_none_is_identity(data):
    _, te = _engines(data, "ivfpq", use_bbc=True)
    masked = te.with_live(np.ones(N, bool))
    cleared = masked.with_live(None)
    assert cleared.live is None and te.live is None
    q = torch.from_numpy(data["qs"])
    r0, r1, r2 = te.search(q), cleared.search(q), masked.search(q)
    assert torch.equal(r0.ids, r1.ids) and torch.equal(r0.dists, r1.dists)
    assert torch.equal(r0.ids, r2.ids)


def test_with_live_keeps_the_layout_and_takes_tensors(data):
    """The mask is a runtime tensor: flipping it shares every build-time
    artifact, a tensor mask equals the numpy one, and the engine keeps its
    generation."""
    _, te = _engines(data, "ivfrabitq", use_bbc=True)
    a = te.with_live(data["live"])
    b = a.with_live(torch.from_numpy(~data["live"]))
    assert a.layout is te.layout and b.stream is te.stream
    assert a.live.shape == (te.layout.n_flat,) and a.live.dtype == torch.bool
    order = te.layout.order.numpy()
    np.testing.assert_array_equal(a.live.numpy(), data["live"][order])
    np.testing.assert_array_equal(b.live.numpy(), ~data["live"][order])
    assert engine.SearchEngine.build(data["tpq"], k=K, n_probe=N_PROBE,
                                     device="cpu",
                                     generation=3).generation == 3
    with pytest.raises(ValueError):
        te.with_live(np.ones((2, N), bool))


def test_searcher_rejects_a_mask_of_the_wrong_width(data):
    _, te = _engines(data, "ivfpq", use_bbc=True)
    with pytest.raises(ValueError, match="live mask"):
        search.ivf_pq_search_batch(
            te.index, te.stream, torch.from_numpy(data["qs"]), te.layout,
            k=K, n_probe=N_PROBE, n_cand=te.n_cand,
            live=torch.ones(5, dtype=bool))


def _tombstoned_lanes(data):
    """(layout, probed, lane mask with the tombstones, stream vectors) of
    the PQ index's IVF part for the fixture's queries."""
    ti = data["tpq"].ivf
    layout = ivf.flat_layout(ti)
    qs = torch.from_numpy(data["qs"])
    probed, lane_valid, _ = search._routing(ti, layout, qs, N_PROBE)
    live = torch.from_numpy(data["live"])[layout.order.clamp(0, N - 1)]
    return layout, probed, lane_valid & live[None, :], qs


def test_histograms_count_only_live_lanes(data):
    """The bucketize-histogram and the shard collector on a tombstoned
    mask: the histogram's mass is the live-lane count, the dead lanes'
    values do not matter, and both equal the JAX mirrors on the same
    distances."""
    layout, probed, lv, qs = _tombstoned_lanes(data)
    dists = torch.where(lv, ops.l2_exact_batch(
        torch.from_numpy(data["x"])[layout.order], qs), float("inf"))
    cbs = search._sample_codebooks(layout, probed, dists, 4,
                                   data["tpq"].ivf.cap, K, M)
    args = (cbs.d_min, cbs.delta, cbs.ew_map)
    bucket, hist = ops.bucket_hist_batch(dists, lv, *args, M)
    np.testing.assert_array_equal(hist.sum(1).numpy(), lv.sum(1).numpy())
    poisoned = torch.where(lv, dists, 0.0)
    assert torch.equal(ops.bucket_hist_batch(poisoned, lv, *args, M)[1], hist)
    jb, jh = jref.bucket_hist_batch(*(jnp.asarray(t.numpy()) for t in
                                      (dists, lv, *args)), M)
    np.testing.assert_array_equal(bucket.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))
    tau = torch.full((NQ,), M // 4, dtype=torch.int32)
    got = ops.shard_collect_batch(dists, lv, *args, M, tau, 600)
    want = jref.shard_collect_batch(*(jnp.asarray(t.numpy()) for t in
                                      (dists, lv, *args)), M,
                                    jnp.asarray(tau.numpy()), 600)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # no dead lane is compacted
    pos, ok = got[2], got[3]
    assert bool(torch.gather(lv, 1, pos.clamp(max=lv.shape[1] - 1))[ok].all())


def test_fused_scan_counts_only_live_lanes(data):
    """#1's plain version on a tombstoned mask: the histogram and the miss
    count cover the live lanes only, equal to the JAX mirror's on the same
    estimate, and no dead lane gets an exact distance."""
    layout, probed, lv, qs = _tombstoned_lanes(data)
    ti = data["tpq"]
    codes, vecs = ti.codes[layout.order], ti.vectors[layout.order]
    luts = search.pq_mod.adc_table(ti.pq, qs)
    est = search._sqrt_est(ops.pq_adc_batch(codes, luts), lv)
    cb = rb.build_codebook(est, k=K, m=M)
    tau = torch.full((NQ,), M // 3, dtype=torch.int32)
    est2, bucket, hist, early, nmiss = ops.fused_scan_batch(
        codes, vecs, lv, luts, qs, cb.d_min, cb.delta, cb.ew_map, M, tau)
    np.testing.assert_array_equal(hist.sum(1).numpy(), lv.sum(1).numpy())
    assert not bool(torch.isfinite(early[~lv]).any())
    jb, jh = jref.bucket_hist_batch(*(jnp.asarray(t.numpy()) for t in (
        est2, lv, cb.d_min, cb.delta, cb.ew_map)), M)
    np.testing.assert_array_equal(bucket.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))
    pred = lv & (bucket <= tau[:, None])
    np.testing.assert_array_equal(nmiss.numpy(), (lv & ~pred).sum(1).numpy())


# --------------------------------------------------------------------------
# sharded: 4 gloo ranks against 4 forced JAX host devices
# --------------------------------------------------------------------------

JAX_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.data import synthetic
    from repro.index import engine, search

    rng = np.random.default_rng(3)
    x = synthetic.clustered(rng, 8000, 32, n_centers=48)
    qs = synthetic.queries_from(rng, x, 8)
    live = np.ones(8000, bool)
    live[np.random.default_rng(5).choice(8000, 800, replace=False)] = False
    d = ((qs[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    for b in range(8):
        live[np.argsort(d[b])[:10]] = False
    key = jax.random.key(0)
    jx = jnp.asarray(x)
    pq = search.build_pq_index(key, jx, 32, n_iter=4)
    rq = search.build_rabitq_index(key, jx, 32, n_iter=4)
    out = dict(x=x, qs=qs, live=live, ivf_centroids=pq.ivf.centroids,
               member_ids=pq.ivf.member_ids,
               member_valid=pq.ivf.member_valid,
               cluster_sizes=pq.ivf.cluster_sizes,
               pq_centroids=pq.pq.centroids, pq_codes=pq.codes,
               rq_ivf_centroids=rq.ivf.centroids,
               rq_member_ids=rq.ivf.member_ids,
               rq_member_valid=rq.ivf.member_valid,
               rq_cluster_sizes=rq.ivf.cluster_sizes, rot=rq.rq.rot,
               rq_codes=rq.rq.codes, norm_o=rq.rq.norm_o, f_o=rq.rq.f_o)
    mesh = jax.make_mesh((4,), ("model",))
    for kind, ix in {"ivf": pq.ivf, "pq": pq, "rq": rq}.items():
        vec = dict(vectors=jx) if kind == "ivf" else {}
        for bbc in (True, False):
            # RaBitQ+BBC: the kernel branch, the one the port runs (the
            # composed CPU branch samples its codebook from masked bounds)
            bk = dict(backend="pallas") if kind == "rq" and bbc else {}
            e = engine.SearchEngine.build(ix, k=300, n_probe=8, mesh=mesh,
                                          use_bbc=bbc, **vec,
                                          **bk).with_live(live)
            r = e.search(jnp.asarray(qs))
            for f in ("dists", "ids", "n_reranked", "n_second_pass"):
                out[f"{kind}:{bbc}:{f}"] = np.asarray(getattr(r, f))
            if not bbc:
                continue
            st = e.predictor_init()
            for i in range(2):
                r, st = e.search(jnp.asarray(qs[4 * i:4 * i + 4]),
                                 pred_state=st)
                for f in ("dists", "ids", "n_reranked", "n_second_pass"):
                    out[f"{kind}:pred{i}:{f}"] = np.asarray(getattr(r, f))
    np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
    print("JAX_LIVE_OK")
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
        mesh = dist.make_mesh((4,), ("model",))
        qs, x, out = torch.from_numpy(a["qs"]), torch.from_numpy(a["x"]), {}
        for kind, ix in {"ivf": pq.ivf, "pq": pq, "rq": rq}.items():
            vec = dict(vectors=x) if kind == "ivf" else {}
            for bbc in (True, False):
                e = engine.SearchEngine.build(
                    ix, k=300, n_probe=8, mesh=mesh, use_bbc=bbc,
                    **vec).with_live(a["live"])
                assert e.live.shape == e.shard_layout.order.shape
                r = e.search(qs)
                for f in ("dists", "ids", "n_reranked", "n_second_pass"):
                    out[f"{kind}:{bbc}:{f}"] = getattr(r, f).numpy()
                if not bbc:
                    continue
                st = e.predictor_init()
                for i in range(2):
                    r, st = e.search(qs[4 * i:4 * i + 4], pred_state=st)
                    for f in ("dists", "ids", "n_reranked",
                              "n_second_pass"):
                        out[f"{kind}:pred{i}:{f}"] = getattr(r, f).numpy()
        if rank == 0:
            np.savez(dst, **out)
        tdist.barrier()
        tdist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(rank_main, args=tuple(sys.argv[1:4]), nprocs=4, join=True)
        print("PORT_LIVE_OK")
    """
)


def _run(args, marker):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run(args, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=600)
    assert marker in out.stdout, out.stdout[-2000:] + "\n" + out.stderr[-3000:]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tombstones_sharded")
    ref_path, port_path = tmp / "jax.npz", tmp / "port.npz"
    _run([sys.executable, "-c", JAX_SCRIPT, str(ref_path)], "JAX_LIVE_OK")
    script = tmp / "port_ranks.py"
    script.write_text(PORT_SCRIPT)
    _run([sys.executable, str(script), str(ref_path), str(port_path),
          str(tmp / "store")], "PORT_LIVE_OK")
    return dict(np.load(ref_path)), dict(np.load(port_path))


@pytest.mark.multidevice
@pytest.mark.parametrize("form", [True, False, "pred0", "pred1"])
@pytest.mark.parametrize("kind", ["ivf", "pq", "rq"])
def test_four_ranks_with_live_match_reference(sharded, kind, form):
    """BBC static (True), the naive collector (False) and two predictive
    batches threading the EMA, each on 4 gloo ranks against the JAX mesh
    engine's ``with_live`` on 4 forced host devices."""
    ref_out, port = sharded
    dead = set(np.flatnonzero(~ref_out["live"]).tolist())
    name = f"{kind}:{form}"
    for row in range(ref_out[f"{name}:ids"].shape[0]):
        got = set(port[f"{name}:ids"][row].tolist())
        assert got == set(ref_out[f"{name}:ids"][row].tolist()), row
        assert not (got & dead), row
    np.testing.assert_allclose(np.sort(port[f"{name}:dists"], 1),
                               np.sort(ref_out[f"{name}:dists"], 1),
                               rtol=1e-4, atol=1e-4)
    for f in ("n_reranked", "n_second_pass"):
        np.testing.assert_array_equal(port[f"{name}:{f}"],
                                      ref_out[f"{name}:{f}"])


# --------------------------------------------------------------------------
# on a card: the kernels on tombstoned masks, bitwise against their plain
# versions
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture
def card_inputs(data, cuda):
    """The PQ path's stream and lane masks (probed clusters with the
    fixture's tombstones as holes) and the RaBitQ path's, on the card."""
    layout, probed, lv, qs = _tombstoned_lanes(data)
    ti = data["tpq"]
    lv, qs = lv.to(cuda), qs.to(cuda)
    pq_stream = search.build_stream(ti, layout)
    codes, vecs = pq_stream.codes.to(cuda), pq_stream.vectors.to(cuda)
    luts = search.pq_mod.adc_table(ti.pq, qs.cpu()).to(cuda)
    est = search._sqrt_est(ref.pq_adc_batch(codes, luts), lv)
    cb = rb.build_codebook(est, k=K, m=M)
    tau = torch.full((NQ,), M // 3, dtype=torch.int32, device=cuda)
    trq = search.index_to(data["trq"], cuda)
    rlayout = ivf.flat_layout(trq.ivf)
    stream = search.build_stream(trq, rlayout)
    live = torch.from_numpy(data["live"]).to(cuda)
    _, rlv, d2 = search._routing(trq.ivf, rlayout, qs, N_PROBE,
                                 live[rlayout.order.clamp(0, N - 1)])
    ub = torch.where(rlv, torch.rand(rlv.shape, device=cuda) + 1.0,
                     float("inf"))
    rcb = rb.build_codebook(ub, k=K, m=M)
    g, nq = search._rabitq_query_terms(stream, qs, d2)
    return dict(
        pq=(codes, vecs, lv, luts, qs, cb.d_min, cb.delta, cb.ew_map, M,
            tau, probed.to(cuda), layout.offsets.to(cuda), ti.ivf.cap),
        walked=ivf.probe_mask(layout, probed, C).to(cuda),
        est=est, lv=lv, cb=(cb.d_min, cb.delta, cb.ew_map), tau=tau,
        rq=(stream.codes, stream.vectors, stream.s2, stream.norm_o,
            stream.f_o, stream.cl, g, qs, nq, rlv, rcb.d_min, rcb.delta,
            rcb.ew_map, M, tau))


def _tombstoned_call(name, a):
    """(kernel wrapper, plain version, arguments) of ``name``."""
    bh = (a["est"], a["lv"], *a["cb"], M)
    if name == "fused_scan_batch":
        return ops.fused_scan_batch, ref.fused_scan_batch, a["pq"]
    if name == "bucket_hist_batch":
        return ops.bucket_hist_batch, ref.bucket_hist_batch, bh
    if name == "shard_collect_batch":
        return ops.shard_collect_batch, ref.shard_collect_batch, (
            *bh, a["tau"], 700)
    if name == "spec_compact_batch":
        bucket = ref.bucket_hist_batch(*bh)[0]
        return ops.spec_compact_batch, ref.spec_compact_batch, (
            bucket, a["lv"], a["tau"], 700)
    return ops.fused_rabitq_scan_batch, ref.fused_rabitq_scan_batch, a["rq"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_scan_batch", "bucket_hist_batch",
                                  "shard_collect_batch", "spec_compact_batch",
                                  "fused_rabitq_scan_batch"])
def test_cuda_kernel_on_tombstoned_masks(card_inputs, name):
    """#1, #4, #6, #7 and #5 on the lane masks of a tombstoned engine (runs
    of probed clusters with holes): every output bitwise equal to the
    plain version on the same card tensors, one launch.  #1 walks each
    query's probed lists, as the searcher calls it: its (B, n) outputs
    are compared on the lists' lanes (the holes included), hist and nmiss
    whole."""
    kernel, plain, args = _tombstoned_call(name, card_inputs)
    ops.reset_launches()
    got = kernel(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == 1
    if name != "fused_scan_batch":
        assert _same_bits(got, plain(*args))
        return
    on = card_inputs["walked"]              # the lanes of the probed lists
    assert bool((card_inputs["lv"] & ~on).sum() == 0)
    want = plain(*args[:10])                # the plain version takes no lists
    assert _same_bits([t[on] if t.shape == on.shape else t for t in got],
                      [t[on] if t.shape == on.shape else t for t in want])


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [4096, 1000])
def test_cuda_delta_scan_shape(cap, cuda):
    """#3 at the delta-segment scan's shape (B=32 queries, one segment of
    ``cap`` rows, d=128), bitwise against its plain version."""
    rng = np.random.default_rng(cap)
    x = torch.from_numpy(rng.standard_normal((cap, 128)).astype(
        np.float32)).to(cuda)
    qs = torch.from_numpy(rng.standard_normal((32, 128)).astype(
        np.float32)).to(cuda)
    assert torch.equal(ops.l2_exact_batch(x, qs), ref.l2_exact_batch(x, qs))


@pytest.mark.cuda
def test_cuda_engine_with_live_equals_cpu(data, cuda):
    """Each method's tombstoned engine on the card returns the CPU
    engine's ids and distances for the same form (the kernels are bitwise
    their plain versions): PQ fused (#1) and unfused (#2, #3, #4),
    RaBitQ fused (#5), IVF (#3, #4)."""
    q = torch.from_numpy(data["qs"])
    for kind, fused in (("ivfpq", True), ("ivfpq", False),
                        ("ivfrabitq", True), ("ivf", None)):
        _, te = _engines(data, kind, use_bbc=True, fused=fused)
        idx = te.vectors if kind == "ivf" else None
        ge = engine.SearchEngine.build(
            te.index, k=K, n_probe=N_PROBE, m=M, device=cuda, vectors=idx,
            fused=fused).with_live(data["live"])
        tr = te.with_live(data["live"]).search(q)
        gr = ge.search(q.to(cuda))
        assert torch.equal(gr.ids.cpu(), tr.ids), kind
        assert torch.equal(gr.dists.cpu(), tr.dists), kind
