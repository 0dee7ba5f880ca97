"""The slice end to end: the port's batched IVF+RaBitQ searchers (fused
static and predictive, two-phase, threshold baseline) and its batched IVF
searcher on the CPU, each against the same path of the JAX package on the
reference's own index, carried across with ``convert``; then the engine
and the serving CLI.

RaBitQ config: the reference's own test (N=8000, D=64, 32 clusters, 6
queries, k=200, n_probe=12, m=128, eps0=3.0).  The fused path is held
against the reference's kernel branch (``backend="pallas"``, interpret mode
on the CPU), the port's structure on both devices; the two-phase and
baseline paths against ``backend="ref"``.  Id sets must be equal for every
query, sorted distances within rtol=atol=1e-4, and the work counters
equal.  The port's fused and two-phase paths are held to equal id sets
only: certain-in lanes report their RaBitQ estimate, and the two paths
build different codebooks, so they classify boundary lanes differently.

IVF config: the verify recipe's (n=12000, d=64, k=500, 64 clusters).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import rerank as jrr  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import rerank as rr  # noqa: E402
from repro_torch.index import engine, ivf, search  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

torch.set_num_threads(2)

N, D, C, NQ = 8000, 64, 32, 6
K, N_PROBE, M = 200, 12, 128
PRED_BATCHES = (slice(0, 4), slice(2, 6), slice(1, 5))


def _arrays(ji) -> dict:
    arrays = {
        "ivf_centroids": ji.ivf.centroids, "member_ids": ji.ivf.member_ids,
        "member_valid": ji.ivf.member_valid,
        "cluster_sizes": ji.ivf.cluster_sizes, "vectors": ji.vectors,
        "rot": ji.rq.rot, "codes": ji.rq.codes, "norm_o": ji.rq.norm_o,
        "f_o": ji.rq.f_o}
    return {k: np.asarray(v) for k, v in arrays.items()}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    x = synthetic.clustered(rng, N, D, n_centers=64)
    qs = synthetic.queries_from(rng, x, NQ)
    ji = jsearch.build_rabitq_index(jax.random.key(0), jnp.asarray(x), C,
                                    n_iter=4)
    ti, tl = convert.rabitq_index_from_numpy(_arrays(ji), device="cpu")
    return ji, jivf.flat_layout(ji.ivf), ti, tl, qs


def _ids_equal(a, b):
    for row in range(a.shape[0]):
        assert set(np.asarray(a[row]).tolist()) == \
            set(np.asarray(b[row]).tolist()), row


def _assert_same(jr, tr):
    _ids_equal(np.asarray(jr.ids), tr.ids.numpy())
    np.testing.assert_allclose(np.sort(tr.dists.numpy(), 1),
                               np.sort(np.asarray(jr.dists), 1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tr.n_reranked.numpy(),
                                  np.asarray(jr.n_reranked))
    np.testing.assert_array_equal(tr.n_second_pass.numpy(),
                                  np.asarray(jr.n_second_pass))


def _both(setup, q, fused, backend, use_bbc=True, js=None, ts=None):
    ji, jl, ti, tl, _ = setup
    jr = jsearch.ivf_rabitq_search_batch(
        ji, jnp.asarray(q), jl, k=K, n_probe=N_PROBE, use_bbc=use_bbc,
        fused=fused, backend=backend, pred_state=js)
    tr = search.ivf_rabitq_search_batch(
        ti, search.build_stream(ti, tl), torch.from_numpy(q), tl, k=K,
        n_probe=N_PROBE, use_bbc=use_bbc, fused=fused, pred_state=ts)
    return jr, tr


def test_fused_static_matches_reference_kernel_branch(setup):
    jr, tr = _both(setup, setup[4][:4], True, "pallas")
    _assert_same(jr, tr)


def test_fused_predictive_sequence_matches_reference(setup):
    qs = setup[4]
    js, ts = jrr.predictor_init(M), rr.predictor_init(M)
    for sl in PRED_BATCHES:
        (jr, js), (tr, ts) = _both(setup, qs[sl], True, "pallas", js=js,
                                   ts=ts)
        _assert_same(jr, tr)
        for count in (K // 8, K):
            assert rr.predict_tau(ts, count, margin=3) == \
                int(jrr.predict_tau(js, count, margin=3))
    # the warm gate moved work inline: fewer stragglers than the cold batch
    assert int(tr.n_second_pass.sum()) < int(tr.n_reranked.sum())


@pytest.mark.parametrize("use_bbc", [False, True])
def test_two_phase_and_baseline_match_reference(setup, use_bbc):
    jr, tr = _both(setup, setup[4], False, "ref", use_bbc=use_bbc)
    _assert_same(jr, tr)


def test_two_phase_predictive_sequence_matches_reference(setup):
    qs = setup[4]
    js, ts = jrr.predictor_init(M), rr.predictor_init(M)
    for sl in PRED_BATCHES:
        (jr, js), (tr, ts) = _both(setup, qs[sl], False, "ref", js=js, ts=ts)
        _assert_same(jr, tr)


def test_fused_and_two_phase_select_the_same_ids(setup):
    _, _, ti, tl, qs = setup
    q, ts = torch.from_numpy(qs), search.build_stream(ti, tl)
    fused = search.ivf_rabitq_search_batch(ti, ts, q, tl, k=K,
                                           n_probe=N_PROBE, use_bbc=True)
    two = search.ivf_rabitq_search_batch(ti, ts, q, tl, k=K, n_probe=N_PROBE,
                                         use_bbc=True, fused=False)
    _ids_equal(fused.ids.numpy(), two.ids.numpy())
    # the gate moves work, never the band: every band lane is evaluated
    assert bool((fused.n_second_pass <= fused.n_reranked).all())


def _short_row_k(setup, q):
    """A k one above the fewest lanes any query of ``q`` probes: that query
    has fewer than k valid lanes, the others at least k."""
    _, _, ti, tl, _ = setup
    _, lane_valid, _ = search._routing(ti.ivf, tl, q, N_PROBE)
    lanes = lane_valid.sum(1)
    assert int(lanes.min()) < int(lanes.max())
    return int(lanes.min()) + 1


def _full_width_finalize(plan, exact, lb, ids, k, est, pos, ok, n_reranked):
    """The compacted finalize's stand-in: the full-width sort over every
    lane, on the same plan."""
    res = rr.greedy_rerank_finalize(plan, exact, lb, ids, k, est=est)
    assert torch.equal(res.n_reranked, n_reranked)
    return res


@pytest.fixture(scope="module")
def few_centres():
    """A corpus of 8 centres over 32 clusters, built by the port alone: the
    nearest probed clusters, the codebook's sample, hold one centre's rows,
    so at k=1500 most queries' k-th upper bound falls in the overflow
    bucket (tau_ub = m) while each probes more than k lanes."""
    rng = np.random.default_rng(5)
    x = synthetic.clustered(rng, N, D, n_centers=8)
    qs = synthetic.queries_from(rng, x, NQ)
    ti = search.build_rabitq_index(torch.from_numpy(x), C, n_iter=4,
                                   device="cpu")
    return ti, ivf.flat_layout(ti.ivf), qs


@pytest.mark.parametrize("gate", ["static", "predictive", "short_row",
                                  "overflow_bucket"])
def test_fused_select_matches_the_full_width_finalize(setup, few_centres,
                                                      monkeypatch, gate):
    """The fused path's selection over the compacted certain-in and band
    lanes returns the ids, distances and counters of the full-width
    ``greedy_rerank_finalize``: the static gate, the predictive gate cold
    and warm, a batch in which one query probes fewer than k lanes, and
    one in which thresholds sit in the overflow bucket."""
    _, _, ti, tl, qs = setup
    batches = ([qs[:4]] if gate == "static" else
               [qs[sl] for sl in PRED_BATCHES] if gate == "predictive" else
               [qs])
    k = _short_row_k(setup, torch.from_numpy(qs)) if gate == "short_row" \
        else K
    if gate == "overflow_bucket":
        ti, tl, q = few_centres
        batches, k = [q], 1500

    ts = search.build_stream(ti, tl)

    def run():
        state = rr.predictor_init(M) if gate == "predictive" else None
        out = []
        for q in batches:
            res = search.ivf_rabitq_search_batch(
                ti, ts, torch.from_numpy(q), tl, k=k, n_probe=N_PROBE,
                use_bbc=True, pred_state=state)
            if state is not None:
                res, state = res
                out.append(state.ema)
            out.extend(res)
        return out

    got = run()
    monkeypatch.setattr(rr, "greedy_rerank_finalize_compacted",
                        _full_width_finalize)
    want = run()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_predictive_requires_bbc(setup):
    _, _, ti, tl, qs = setup
    with pytest.raises(ValueError, match="use_bbc"):
        search.ivf_rabitq_search_batch(ti, search.build_stream(ti, tl),
                                       torch.from_numpy(qs), tl, k=K,
                                       n_probe=N_PROBE,
                                       pred_state=rr.predictor_init(M))


# ---------------------------------------------------------------- IVF ------

IVF_N, IVF_D, IVF_K, IVF_C, IVF_B, IVF_PROBE = 12000, 64, 500, 64, 8, 16


@pytest.fixture(scope="module")
def ivf_setup():
    rng = np.random.default_rng(0)
    x = synthetic.clustered(rng, IVF_N, IVF_D)
    qs = synthetic.queries_from(rng, x, 3 * IVF_B)
    jx = jnp.asarray(x)
    jv = jivf.build(jax.random.key(0), jx, IVF_C)
    tv = ivf.IVFIndex(*(torch.from_numpy(np.array(a)) for a in jv))
    return jv, jx, jivf.flat_layout(jv), tv, ivf.flat_layout(tv), x, qs


def _ivf_both(ivf_setup, q, use_bbc, js=None, ts=None):
    jv, jx, jl, tv, tl, x, _ = ivf_setup
    jr = jsearch.ivf_search_batch(jv, jx, jnp.asarray(q), jl, k=IVF_K,
                                  n_probe=IVF_PROBE, use_bbc=use_bbc,
                                  backend="ref", pred_state=js)
    tr = search.ivf_search_batch(
        tv, search.build_stream(tv, tl, torch.from_numpy(x)),
        torch.from_numpy(q), tl, k=IVF_K, n_probe=IVF_PROBE,
        use_bbc=use_bbc, pred_state=ts)
    return jr, tr


@pytest.mark.parametrize("use_bbc", [False, True])
def test_ivf_static_matches_reference(ivf_setup, use_bbc):
    jr, tr = _ivf_both(ivf_setup, ivf_setup[6][:IVF_B], use_bbc)
    _assert_same(jr, tr)


def test_ivf_predictive_sequence_matches_reference(ivf_setup):
    qs = ivf_setup[6]
    js, ts = jrr.predictor_init(M), rr.predictor_init(M)
    for i in range(3):
        q = qs[i * IVF_B:(i + 1) * IVF_B]
        (jr, js), (tr, ts) = _ivf_both(ivf_setup, q, True, js=js, ts=ts)
        _assert_same(jr, tr)
        # exact in-scan: the predictive result is the static one
        tv, tl = ivf_setup[3], ivf_setup[4]
        static = search.ivf_search_batch(
            tv, search.build_stream(tv, tl, torch.from_numpy(ivf_setup[5])),
            torch.from_numpy(q), tl, k=IVF_K, n_probe=IVF_PROBE,
            use_bbc=True)
        _ids_equal(static.ids.numpy(), tr.ids.numpy())


# ------------------------------------------------------- engine and CLI ----

def test_engine_serves_the_rabitq_searcher(setup):
    _, _, ti, tl, qs = setup
    eng = engine.SearchEngine.build(ti, k=K, n_probe=N_PROBE, device="cpu")
    assert eng.kind == "ivfrabitq" and eng.pred_count == K
    assert eng.n_cand is None and eng.stream.codes.dtype == torch.int8
    q = torch.from_numpy(qs)
    res = eng.warmup((NQ,), predictive=True).search(qs)
    ts = search.build_stream(ti, tl)
    direct = search.ivf_rabitq_search_batch(ti, ts, q, tl, k=K,
                                            n_probe=N_PROBE, use_bbc=True)
    assert torch.equal(res.ids, direct.ids)
    assert torch.equal(res.n_second_pass, direct.n_second_pass)
    res2, state = eng.search(qs, pred_state=eng.predictor_init())
    assert res2.ids.shape == (NQ, K) and float(state.weight) > 0
    for use_bbc, fused in ((True, False), (False, None)):
        e = engine.SearchEngine.build(ti, k=K, n_probe=N_PROBE,
                                      use_bbc=use_bbc, fused=fused,
                                      device="cpu")
        want = search.ivf_rabitq_search_batch(ti, ts, q, tl, k=K,
                                              n_probe=N_PROBE,
                                              use_bbc=use_bbc, fused=fused)
        assert torch.equal(e.search(qs).ids, want.ids)


def test_engine_serves_the_ivf_searcher(ivf_setup):
    _, _, _, tv, tl, x, qs = ivf_setup
    eng = engine.SearchEngine.build(tv, k=IVF_K, n_probe=10 * IVF_C,
                                    vectors=x, device="cpu")
    assert eng.kind == "ivf" and eng.n_probe == IVF_C
    assert eng.pred_count == IVF_K and eng.dim == IVF_D
    res = eng.warmup((IVF_B,), predictive=True).search(qs[:IVF_B])
    direct = search.ivf_search_batch(
        tv, search.build_stream(tv, tl, torch.from_numpy(x)),
        torch.from_numpy(qs[:IVF_B]), tl, k=IVF_K, n_probe=IVF_C,
        use_bbc=True)
    assert torch.equal(res.ids, direct.ids)
    with pytest.raises(ValueError, match="vectors"):
        engine.SearchEngine.build(tv, k=IVF_K, n_probe=4, device="cpu")


@pytest.mark.parametrize("flags", [["--method", "ivfrabitq_bbc"],
                                   ["--method", "ivfrabitq"],
                                   ["--method", "ivfrabitq_bbc",
                                    "--tau-pred", "on"]])
def test_serve_cli_rabitq_cpu(capsys, flags):
    assert serve.main(["--device", "cpu", "--n", "12000", "--d", "64",
                       "--k", "500", "--n-clusters", "64", "--queries", "16",
                       "--batch", "8", *flags]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["method"] == flags[1]
    assert out["recall_mean"] >= 0.9
    assert out["tau_pred"] == ("on" if "--tau-pred" in flags else "off")


@pytest.mark.cuda
def test_cuda_rabitq_engine_matches_cpu(setup):
    """On a card: the fused, two-phase and baseline RaBitQ forms give the
    CPU run's id sets and counters on the same index."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    _, _, ti, _, qs = setup
    for use_bbc, fused in ((True, True), (True, False), (False, None)):
        res = [engine.SearchEngine.build(ti, k=K, n_probe=N_PROBE,
                                         use_bbc=use_bbc, fused=fused,
                                         device=dev).search(qs)
               for dev in ("cpu", "cuda")]
        _ids_equal(res[0].ids.numpy(), res[1].ids.cpu().numpy())
        assert torch.equal(res[0].n_second_pass, res[1].n_second_pass.cpu())
