"""The single-query slice end to end on the CPU: routing, the RaBitQ query
factors and estimator, the single-query collectors and re-rank pieces, the
three single-query searchers, ``SearchEngine.search`` on a (d,) query and
``serve --batch 1``, each against the JAX package on the same input (the
searchers on the reference's own indexes, carried across with
``convert``).

Config: the JAX package's single/batched parity test
(``tests/test_search_batch.py``: N=8000, D=64, 32 clusters, 6 queries,
k=200, n_probe=12).  Searchers and engines must give the reference's id
set per query, sorted distances within rtol=atol=1e-4 and equal
``n_reranked`` and ``n_second_pass``; integer outputs of the collectors
and the plan are equal on the same input; the query factors and the
estimator within 1e-5.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import buffer as jrb  # noqa: E402
from repro.core import collector as jcol  # noqa: E402
from repro.core import rerank as jrr  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.index import engine as jengine  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.index import rabitq as jrq  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import buffer as rb  # noqa: E402
from repro_torch.core import collector as col  # noqa: E402
from repro_torch.core import rerank as rr  # noqa: E402
from repro_torch.index import engine, ivf, pq, rabitq, search  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

torch.set_num_threads(2)

N, D, C, NQ = 8000, 64, 32, 6
K, N_PROBE = 200, 12


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = synthetic.clustered(rng, N, D, n_centers=64)
    qs = synthetic.queries_from(rng, x, NQ)
    jx = jnp.asarray(x)
    jpq = jsearch.build_pq_index(jax.random.key(0), jx, C, n_iter=4)
    jrq_ix = jsearch.build_rabitq_index(jax.random.key(0), jx, C, n_iter=4)
    ivf_arrays = lambda ji: {  # noqa: E731
        "ivf_centroids": ji.ivf.centroids, "member_ids": ji.ivf.member_ids,
        "member_valid": ji.ivf.member_valid,
        "cluster_sizes": ji.ivf.cluster_sizes, "vectors": ji.vectors}
    tpq, _ = convert.pq_index_from_numpy({k: np.asarray(v) for k, v in dict(
        ivf_arrays(jpq), pq_centroids=jpq.pq.centroids,
        codes=jpq.codes).items()}, device="cpu")
    trq, _ = convert.rabitq_index_from_numpy({
        k: np.asarray(v) for k, v in dict(
            ivf_arrays(jrq_ix), rot=jrq_ix.rq.rot, codes=jrq_ix.rq.codes,
            norm_o=jrq_ix.rq.norm_o, f_o=jrq_ix.rq.f_o).items()},
        device="cpu")
    return dict(x=x, qs=qs, jx=jx, jpq=jpq, jrq=jrq_ix, tpq=tpq, trq=trq)


def _assert_same(jr, tr, counters=True):
    """One query's results: id sets, sorted distances, counters."""
    assert set(np.asarray(jr.ids).tolist()) == set(tr.ids.numpy().tolist())
    np.testing.assert_allclose(np.sort(tr.dists.numpy()),
                               np.sort(np.asarray(jr.dists)), rtol=1e-4,
                               atol=1e-4)
    if counters:
        assert int(tr.n_reranked) == int(jr.n_reranked)
        assert int(tr.n_second_pass) == int(jr.n_second_pass)


# ---------------------------- index pieces ---------------------------------

@pytest.mark.parametrize("n_probe", [1, N_PROBE, C])
def test_route_and_gather_match_reference(data, n_probe):
    ji, ti = data["jpq"].ivf, data["tpq"].ivf
    for q in data["qs"]:
        jp = jivf.route(ji, jnp.asarray(q), n_probe)
        tp = ivf.route(ti, _t(q), n_probe)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        # the single-query routing is the batched routing's row
        assert torch.equal(tp, ivf.route_batch_d2(ti, _t(q)[None],
                                                  n_probe)[0][0])
        jids, jvalid = jivf.gather_candidates(ji, jp)
        tids, tvalid = ivf.gather_candidates(ti, tp)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


def test_adc_table_single_is_the_batched_row(data):
    cb = data["tpq"].pq
    qs = _t(data["qs"])
    batched = pq.adc_table(cb, qs)
    for i, q in enumerate(data["qs"]):
        one = pq.adc_table(cb, _t(q))
        assert torch.equal(one, batched[i])
        want = jsearch.pq_mod.adc_table(data["jpq"].pq, jnp.asarray(q))
        np.testing.assert_allclose(one.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_query_factors_and_estimate_match_reference(data):
    jr, tr = data["jrq"], data["trq"]
    q = data["qs"][0]
    probed = jivf.route(jr.ivf, jnp.asarray(q), N_PROBE)
    cents = np.asarray(jr.ivf.centroids)[np.asarray(probed)]
    tqf = rabitq.query_factors(tr.rq, _t(q), _t(cents))     # all tiles
    for t, cid in enumerate(np.asarray(probed)[:4]):
        jqf = jrq.query_factors(jr.rq, jnp.asarray(q), jr.ivf.centroids[cid])
        one = rabitq.query_factors(tr.rq, _t(q), _t(cents[t]))
        assert torch.equal(one.v, tqf.v[t])
        assert torch.equal(one.norm_q, tqf.norm_q[t])
        np.testing.assert_allclose(one.v.numpy(), np.asarray(jqf.v),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(one.norm_q), float(jqf.norm_q),
                                   rtol=1e-5, atol=1e-5)
        ids = np.asarray(jr.ivf.member_ids[cid])
        ids = ids[ids >= 0]
        want = jrq.estimate(jr.rq.codes[ids], jr.rq.norm_o[ids],
                            jr.rq.f_o[ids], jqf)
        got = rabitq.estimate(tr.rq.codes[ids], tr.rq.norm_o[ids],
                              tr.rq.f_o[ids], one)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


# ---------------------------- collectors -----------------------------------

def _stream(rng, n_tiles=12, tile=256, p_valid=0.8, ties=False):
    d = rng.random((n_tiles, tile)).astype(np.float32) * 20 + 1
    if ties:
        d = np.round(d * 4) / 4
    valid = rng.random((n_tiles, tile)) < p_valid
    d = np.where(valid, d, np.inf).astype(np.float32)
    ids = np.where(valid, np.arange(n_tiles * tile).reshape(n_tiles, tile)
                   + 100, -1).astype(np.int32)
    return (jcol.StreamInput(*(jnp.asarray(a) for a in (d, ids, valid))),
            col.StreamInput(*(_t(a) for a in (d, ids, valid))))


COLLECTORS = ["bbc", "bbc_streamed", "topk", "topk_flat", "sorted", "lazy"]


@pytest.mark.parametrize("name", COLLECTORS)
@pytest.mark.parametrize("k,ties", [(100, False), (700, True)])
def test_collectors_match_reference(rng, name, k, ties):
    js, ts = _stream(rng, ties=ties)
    jd, ji = jcol.COLLECTORS[name](js, k)
    td, ti = col.COLLECTORS[name](ts, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert col.collector_stats(name, k, 128, 3072, 256) == \
        jcol.collector_stats(name, k, 128, 3072, 256)


@pytest.mark.parametrize("overflow", [False, True])
def test_buffer_collect_matches_reference(rng, overflow):
    """``collect`` on the fast path and on the escape hatch (a sample that
    ends below the k-th distance puts tau in the overflow bucket)."""
    n, k, m = 5000, 300, 64
    valid = rng.random(n) < 0.9
    d = np.where(valid, rng.random(n) * 10 + 1, np.inf).astype(np.float32)
    ids = np.arange(n, dtype=np.int32) + 7
    sample = np.sort(d)[:k // 2] if overflow else d[:2000]
    jcb = jrb.build_codebook(jnp.asarray(sample), k=k, m=m)
    tcb = rb.build_codebook(_t(sample)[None], k=k, m=m)
    jb = jrb.bucketize(jcb, jnp.asarray(d))
    tb = rb.bucketize(tcb, _t(d)[None])[0]
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    jd, ji = jrb.collect(jcb, jnp.asarray(d), jnp.asarray(ids), jb, k,
                         jnp.asarray(valid))
    td, ti = rb.collect(tcb, _t(d), _t(ids), tb, k, _t(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    od, oi = rb.topk_oracle(_t(d), _t(ids), k, _t(valid))
    jod, joi = jrb.topk_oracle(jnp.asarray(d), jnp.asarray(ids), k,
                               jnp.asarray(valid))
    np.testing.assert_array_equal(oi.numpy(), np.asarray(joi))
    assert torch.equal(od, td) and torch.equal(oi, ti)
    jh = jrb.histogram(jb, m, jnp.asarray(valid))
    tau = jrb.threshold_bucket(jh, k)[0]
    assert int(tau == m) == int(overflow)
    np.testing.assert_array_equal(
        rb.relaxed_threshold(tcb, _t(np.asarray(tau))[None]).numpy(),
        np.asarray(jrb.relaxed_threshold(jcb, tau))[None])


def test_default_num_buckets_matches_reference():
    for kw in ({}, {"vmem_bytes": 1 << 20}, {"lut_bytes": 12 << 20},
               {"cap": 256}, {"vmem_bytes": 1 << 30}):
        assert rb.default_num_buckets(**kw) == jrb.default_num_buckets(**kw)


# ---------------------------- re-rank pieces -------------------------------

def _bounds(rng, n=4000, p_valid=0.9):
    exact = (rng.random(n) * 10 + 1).astype(np.float32)
    width = (rng.random(n) * 1.5).astype(np.float32)
    lb = np.maximum(exact - width * rng.random(n), 0).astype(np.float32)
    ub = (exact + width * rng.random(n)).astype(np.float32)
    valid = rng.random(n) < p_valid
    est = ((lb + ub) / 2).astype(np.float32)
    return lb, ub, exact, valid, est


@pytest.mark.parametrize("k", [50, 400])
def test_greedy_plan_and_phases_match_reference(rng, k):
    lb, ub, exact, valid, est = _bounds(rng)
    jp = jrr.greedy_rerank_plan(jnp.asarray(lb), jnp.asarray(ub), k,
                                jnp.asarray(valid), m=128)
    tp = rr.greedy_rerank_plan(_t(lb), _t(ub), k, _t(valid), m=128)
    for name in tp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    jm, tm = jrr.phase1_mask(jp), rr.phase1_mask(tp)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    p1 = np.where(np.asarray(jm), exact, np.inf).astype(np.float32)
    assert float(rr.phase2_threshold(tp, _t(p1), k)) == \
        float(jrr.phase2_threshold(jp, jnp.asarray(p1), k))
    ids = np.arange(lb.shape[0], dtype=np.int32)
    jr = jrr.greedy_bounded_rerank(jnp.asarray(lb), jnp.asarray(ub),
                                   jnp.asarray(ids), k, jnp.asarray(exact),
                                   jnp.asarray(valid), est=jnp.asarray(est))
    tr = rr.greedy_bounded_rerank(_t(lb), _t(ub), _t(ids), k, _t(exact),
                                  _t(valid), est=_t(est))
    np.testing.assert_array_equal(tr.topk_ids.numpy(), np.asarray(jr.topk_ids))
    np.testing.assert_array_equal(tr.topk_dists.numpy(),
                                  np.asarray(jr.topk_dists))
    assert int(tr.n_reranked) == int(jr.n_reranked)
    for a, b in ((jrr.threshold_only_rerank_mask(
            jnp.asarray(lb), jnp.asarray(ub), k, jnp.asarray(valid)),
            rr.threshold_only_rerank_mask(_t(lb), _t(ub), k, _t(valid))),
            (jrr.minimal_rerank_set(jnp.asarray(lb), jnp.asarray(ub),
                                    jnp.asarray(exact), k,
                                    jnp.asarray(valid)),
             rr.minimal_rerank_set(_t(lb), _t(ub), _t(exact), k,
                                   _t(valid)))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_minimal_rerank_matches_reference(rng):
    lb, ub, exact, _, _ = _bounds(rng, n=1500)
    want = jrr.minimal_rerank(lb, ub, 60, lambda i: float(exact[i]))
    got = rr.minimal_rerank(lb, ub, 60, lambda i: float(exact[i]))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_early_rerank_mask_and_update_match_reference(rng):
    est = (rng.random(6000) * 10 + 1).astype(np.float32)
    jplan = jrr.early_rerank_plan(jnp.asarray(est[:800]), n_cand=900,
                                  n_sample=800, n_total=6000, m=128)
    tplan = rr.early_rerank_plan(_t(est[:800])[None], n_cand=900,
                                 n_sample=800, n_total=6000, m=128)
    assert int(tplan.tau_pred[0]) == int(jplan.tau_pred)
    np.testing.assert_array_equal(
        rr.early_rerank_mask(tplan, _t(est)[None])[0].numpy(),
        np.asarray(jrr.early_rerank_mask(jplan, jnp.asarray(est))))
    ju = jrr.update_tau_pred(jplan, jnp.asarray(est[:3000]), 3000, 6000, 900)
    tu = rr.update_tau_pred(tplan, _t(est[:3000])[None], 3000, 6000, 900)
    assert int(tu.tau_pred[0]) == int(ju.tau_pred)


# ---------------------------- searchers ------------------------------------

@pytest.mark.parametrize("use_bbc", [False, True])
@pytest.mark.parametrize("method", ["ivf", "ivfpq", "ivfrabitq"])
def test_single_searchers_match_reference(data, method, use_bbc):
    for q in data["qs"]:
        jq, tq = jnp.asarray(q), _t(q)
        if method == "ivf":
            jr = jsearch.ivf_search(data["jpq"].ivf, data["jx"], jq, k=K,
                                    n_probe=N_PROBE, use_bbc=use_bbc)
            tr = search.ivf_search(data["tpq"].ivf, data["tpq"].vectors, tq,
                                   k=K, n_probe=N_PROBE, use_bbc=use_bbc)
        elif method == "ivfpq":
            jr = jsearch.ivf_pq_search(data["jpq"], jq, k=K, n_probe=N_PROBE,
                                       n_cand=8 * K, use_bbc=use_bbc)
            tr = search.ivf_pq_search(data["tpq"], tq, k=K, n_probe=N_PROBE,
                                      n_cand=8 * K, use_bbc=use_bbc)
        else:
            jr = jsearch.ivf_rabitq_search(data["jrq"], jq, k=K,
                                           n_probe=N_PROBE, use_bbc=use_bbc)
            tr = search.ivf_rabitq_search(data["trq"], tq, k=K,
                                          n_probe=N_PROBE, use_bbc=use_bbc)
        assert tr.ids.shape == (K,) and tr.n_reranked.ndim == 0
        _assert_same(jr, tr)


def _engines(data, kind, **kw):
    if kind == "ivf":
        return (jengine.SearchEngine.build(data["jpq"].ivf, k=K,
                                           n_probe=N_PROBE, vectors=data["jx"],
                                           **kw),
                engine.SearchEngine.build(data["tpq"].ivf, k=K,
                                          n_probe=N_PROBE, device="cpu",
                                          vectors=data["x"], **kw))
    return (jengine.SearchEngine.build(data["j" + kind], k=K,
                                       n_probe=N_PROBE, **kw),
            engine.SearchEngine.build(data["t" + kind], k=K, n_probe=N_PROBE,
                                      device="cpu", **kw))


@pytest.mark.parametrize("kind", ["ivf", "pq", "rq"])
@pytest.mark.parametrize("use_bbc", [False, True])
def test_engine_single_query_matches_reference(data, kind, use_bbc):
    je, te = _engines(data, kind, use_bbc=use_bbc)
    for q in data["qs"][:3]:
        _assert_same(je.search(jnp.asarray(q)), te.search(q))


@pytest.mark.parametrize("kind", ["ivf", "pq", "rq"])
def test_engine_predictive_singletons_match_reference(data, kind):
    """A single query with ``pred_state`` is a singleton batch of the
    predictive path, in the reference and in the port, from cold."""
    je, te = _engines(data, kind)
    js, ts = je.predictor_init(), te.predictor_init()
    for q in data["qs"][:3]:
        jr, js = je.search(jnp.asarray(q), pred_state=js)
        tr, ts = te.search(q, pred_state=ts)
        assert tr.ids.shape == (K,)
        _assert_same(jr, tr)
    assert float(ts.weight) > 0


def test_warmup_runs_the_single_query_searcher(data, monkeypatch):
    _, te = _engines(data, "pq")
    calls = []
    monkeypatch.setattr(type(te.strategy), "search_one",
                        lambda self, eng, q: calls.append(q.shape))
    te.warmup((1, 4))
    assert calls == [(D,)]


# ---------------------------- serving CLI ----------------------------------

@pytest.mark.parametrize("method", serve.METHODS)
def test_serve_batch_one_cpu(capsys, method):
    assert serve.main(["--device", "cpu", "--n", "3000", "--d", "32",
                       "--k", "100", "--n-clusters", "16", "--n-probe", "8",
                       "--queries", "5", "--batch", "1",
                       "--method", method]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["batch"] == 1 and out["method"] == method
    assert out["recall_queries"] == 5 and out["recall_mean"] > 0.5
    assert out["ms_per_batch"] == out["ms_per_query"]


def test_serve_flat_serves_one_query_at_a_time(capsys, monkeypatch):
    """``--method flat`` answers each query alone through ``flat.search``
    whatever ``--batch`` says, as the JAX CLI does."""
    from repro_torch.index import flat
    seen = []
    real = flat.search
    monkeypatch.setattr(flat, "search",
                        lambda x, q, k: seen.append(q.shape) or real(x, q, k))
    assert serve.main(["--device", "cpu", "--n", "2000", "--d", "16",
                       "--k", "50", "--queries", "6", "--batch", "4",
                       "--method", "flat"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["batch"] == 1 and out["recall_mean"] == 1.0
    assert out["operating_point"] == "flat"
    assert seen and set(seen) == {(16,)} and len(seen) == 6 + 1


def test_single_query_launches_nothing_on_the_cpu(data):
    ops.reset_launches()
    engine.SearchEngine.build(data["trq"], k=K, n_probe=N_PROBE,
                              device="cpu").search(data["qs"][0])
    assert set(ops.LAUNCHES.values()) == {0}
