"""The slice end to end: the port's batched IVF+PQ searchers and engine on
the CPU against the JAX package's ``ivf_pq_search_batch(backend="ref")``,
on the reference's own index carried across with ``convert``.

Config: the verify recipe's (n=12000, d=64, k=500, 64 clusters, B=8).  Id
sets must be equal for every query and sorted distances within
rtol=atol=1e-4; the work counters are compared too.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as tdist  # noqa: E402

from repro.core import rerank as jrr  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.index import engine as jengine  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core import rerank as rr  # noqa: E402
from repro_torch.index import engine, search  # noqa: E402
from repro_torch.index import pq as tpq  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

torch.set_num_threads(2)

N, D, K, C, B, N_PROBE = 12000, 64, 500, 64, 8, 16
N_CAND = 8 * K


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = synthetic.clustered(rng, N, D)
    qs = synthetic.queries_from(rng, x, 3 * B)
    ji = jsearch.build_pq_index(jax.random.key(0), jnp.asarray(x), C)
    arrays = {
        "ivf_centroids": ji.ivf.centroids, "member_ids": ji.ivf.member_ids,
        "member_valid": ji.ivf.member_valid,
        "cluster_sizes": ji.ivf.cluster_sizes,
        "pq_centroids": ji.pq.centroids, "codes": ji.codes,
        "vectors": ji.vectors}
    ti, tl = convert.pq_index_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")
    return ji, jivf.flat_layout(ji.ivf), ti, tl, qs


def _assert_same(jr, tr, counters=True, atol=1e-4):
    jids, tids = np.asarray(jr.ids), tr.ids.numpy()
    for b in range(jids.shape[0]):
        assert set(jids[b].tolist()) == set(tids[b].tolist()), b
    np.testing.assert_allclose(np.sort(tr.dists.numpy(), 1),
                               np.sort(np.asarray(jr.dists), 1),
                               rtol=1e-4, atol=atol)
    if counters:
        np.testing.assert_array_equal(tr.n_reranked.numpy(),
                                      np.asarray(jr.n_reranked))
        np.testing.assert_array_equal(tr.n_second_pass.numpy(),
                                      np.asarray(jr.n_second_pass))


@pytest.mark.parametrize("n_probe", [N_PROBE, C])
@pytest.mark.parametrize("use_bbc,fused", [(False, False), (True, False),
                                           (True, True)])
def test_static_matches_reference(setup, n_probe, use_bbc, fused):
    ji, jl, ti, tl, qs = setup
    q = qs[:B]
    jr = jsearch.ivf_pq_search_batch(
        ji, jnp.asarray(q), jl, k=K, n_probe=n_probe, n_cand=N_CAND,
        use_bbc=use_bbc, fused=fused, backend="ref")
    tr = search.ivf_pq_search_batch(
        ti, search.build_stream(ti, tl), torch.from_numpy(q), tl, k=K,
        n_probe=n_probe, n_cand=N_CAND, use_bbc=use_bbc, fused=fused)
    _assert_same(jr, tr)


# GIST1M's width: d = 960 under the reference's own M = d/4 = 240 4-bit
# sub-quantizers, on a small corpus (the codebook sample's ADC at M = 240)
GIST_N, GIST_D, GIST_C, GIST_K, GIST_PROBE = 3000, 960, 16, 50, 8


@pytest.fixture(scope="module")
def gist_setup():
    rng = np.random.default_rng(960)
    x = synthetic.clustered(rng, GIST_N, GIST_D, n_centers=24)
    qs = synthetic.queries_from(rng, x, 4)
    ji = jsearch.build_pq_index(jax.random.key(1), jnp.asarray(x), GIST_C,
                                n_iter=4)
    arrays = {
        "ivf_centroids": ji.ivf.centroids, "member_ids": ji.ivf.member_ids,
        "member_valid": ji.ivf.member_valid,
        "cluster_sizes": ji.ivf.cluster_sizes,
        "pq_centroids": ji.pq.centroids, "codes": ji.codes,
        "vectors": ji.vectors}
    ti, tl = convert.pq_index_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")
    return ji, jivf.flat_layout(ji.ivf), ti, tl, qs


@pytest.mark.parametrize("fused", [True, False])
def test_gist_width_matches_reference(gist_setup, fused):
    """Id sets and both counters equal.  Distances: the reference's fused
    exact leg lies up to 7e-4 from float64 at d = 960 (the port's within
    1.1e-5), so the sorted distances are held to each other at atol 2e-3
    and the port's alone to float64 at the bar of the rest."""
    ji, jl, ti, tl, qs = gist_setup
    assert ti.codes.shape == (GIST_N, GIST_D // 4)
    jr = jsearch.ivf_pq_search_batch(
        ji, jnp.asarray(qs), jl, k=GIST_K, n_probe=GIST_PROBE,
        n_cand=8 * GIST_K, use_bbc=True, fused=fused, backend="ref")
    tr = search.ivf_pq_search_batch(
        ti, search.build_stream(ti, tl), torch.from_numpy(qs), tl, k=GIST_K,
        n_probe=GIST_PROBE, n_cand=8 * GIST_K, use_bbc=True, fused=fused)
    _assert_same(jr, tr, atol=2e-3)
    x = np.asarray(ji.vectors).astype(np.float64)
    exact = np.sqrt(((x[tr.ids.numpy()] - qs[:, None, :]) ** 2).sum(-1))
    np.testing.assert_allclose(tr.dists.numpy(), exact, rtol=1e-4,
                               atol=1e-4)


def test_gist_width_sample_matches_reference(gist_setup):
    """The codebook sample at M = 240 (the port's one launch of the sample
    ADC, the reference's mapped estimate) over the same routing, stream
    codes and tables: the same padded lanes, estimates within 1e-5."""
    ji, jl, ti, tl, qs = gist_setup
    q = torch.from_numpy(qs)
    probed, _, _ = search._routing(ti.ivf, tl, q, GIST_PROBE)
    codes = search.build_stream(ti, tl).codes
    luts = tpq.adc_table(ti.pq, q)
    st = search.SAMPLE_TILES
    got = search._sqrt_est(*search._pq_sample_adc(tl, probed, codes, luts, st,
                                                  ti.ivf.cap))
    want = np.asarray(jsearch._pq_sample_est(
        jl, jnp.asarray(probed.numpy()), jnp.asarray(codes.numpy()),
        jnp.asarray(luts.numpy()), st, ti.ivf.cap))
    assert got.shape == want.shape == (qs.shape[0], st * ti.ivf.cap)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    assert np.isfinite(want).any() and np.isinf(want).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def gist8_setup():
    """GIST1M's width at Faiss's default 8-bit codes (IVF,PQ240: M = 240,
    K = 256), the reference's index on a small corpus."""
    rng = np.random.default_rng(968)
    x = synthetic.clustered(rng, GIST_N, GIST_D, n_centers=24)
    qs = synthetic.queries_from(rng, x, 3)
    ji = jsearch.build_pq_index(jax.random.key(8), jnp.asarray(x), GIST_C,
                                n_bits=8, n_iter=2)
    arrays = {
        "ivf_centroids": ji.ivf.centroids, "member_ids": ji.ivf.member_ids,
        "member_valid": ji.ivf.member_valid,
        "cluster_sizes": ji.ivf.cluster_sizes,
        "pq_centroids": ji.pq.centroids, "codes": ji.codes,
        "vectors": ji.vectors}
    ti, tl = convert.pq_index_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")
    return ji, jivf.flat_layout(ji.ivf), ti, tl, qs


def test_gist_width_8bit_matches_reference(gist8_setup):
    """The batched fused searcher on an 8-bit GIST-width index (its LUTs
    are (B, 240, 256)): id sets and both counters equal the reference's;
    sorted distances held as test_gist_width_matches_reference holds them,
    to the reference at atol 2e-3 and the port's alone to float64 at
    1e-4."""
    ji, jl, ti, tl, qs = gist8_setup
    assert ti.codes.shape == (GIST_N, 240) and ti.pq.centroids.shape[1] == 256
    assert int(ti.codes.max()) > 15
    jr = jsearch.ivf_pq_search_batch(
        ji, jnp.asarray(qs), jl, k=GIST_K, n_probe=GIST_PROBE,
        n_cand=8 * GIST_K, use_bbc=True, fused=True, backend="ref")
    tr = search.ivf_pq_search_batch(
        ti, search.build_stream(ti, tl), torch.from_numpy(qs), tl, k=GIST_K,
        n_probe=GIST_PROBE, n_cand=8 * GIST_K, use_bbc=True, fused=True)
    _assert_same(jr, tr, atol=2e-3)
    x = np.asarray(ji.vectors).astype(np.float64)
    exact = np.sqrt(((x[tr.ids.numpy()] - qs[:, None, :]) ** 2).sum(-1))
    np.testing.assert_allclose(tr.dists.numpy(), exact, rtol=1e-4,
                               atol=1e-4)


# deep-10M's width: d = 96 under M = d/4 = 24 4-bit sub-quantizers, the one
# M of the cells that is no multiple of 16 (the sample ADC's byte path)
DEEP_N, DEEP_D, DEEP_C, DEEP_K, DEEP_PROBE = 4000, 96, 32, 100, 8


@pytest.fixture(scope="module")
def deep_setup():
    rng = np.random.default_rng(96)
    x = synthetic.clustered(rng, DEEP_N, DEEP_D, n_centers=24)
    qs = synthetic.queries_from(rng, x, 4)
    ji = jsearch.build_pq_index(jax.random.key(96), jnp.asarray(x), DEEP_C,
                                n_iter=4)
    arrays = {
        "ivf_centroids": ji.ivf.centroids, "member_ids": ji.ivf.member_ids,
        "member_valid": ji.ivf.member_valid,
        "cluster_sizes": ji.ivf.cluster_sizes,
        "pq_centroids": ji.pq.centroids, "codes": ji.codes,
        "vectors": ji.vectors}
    ti, tl = convert.pq_index_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")
    return ji, jivf.flat_layout(ji.ivf), ti, tl, qs


def test_deep_width_matches_reference(deep_setup):
    """The batched fused searcher at deep-10M's width (M = 24): id sets and
    both counters equal the reference's, and every distance lies within
    1e-4 of the benchmark's float64 reference (``portbench/reference.py``)
    for its id."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import reference

    ji, jl, ti, tl, qs = deep_setup
    assert ti.codes.shape == (DEEP_N, 24) and 24 % 16
    jr = jsearch.ivf_pq_search_batch(
        ji, jnp.asarray(qs), jl, k=DEEP_K, n_probe=DEEP_PROBE,
        n_cand=8 * DEEP_K, use_bbc=True, fused=True, backend="ref")
    tr = search.ivf_pq_search_batch(
        ti, search.build_stream(ti, tl), torch.from_numpy(qs), tl, k=DEEP_K,
        n_probe=DEEP_PROBE, n_cand=8 * DEEP_K, use_bbc=True, fused=True)
    _assert_same(jr, tr)
    assert int(tr.n_second_pass.sum()) > 0
    exact = reference.exact_dists(torch.from_numpy(np.array(ji.vectors)),
                                  torch.from_numpy(qs), tr.ids)
    np.testing.assert_allclose(tr.dists.numpy(), exact.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_predictive_sequence_matches_reference(setup, fused):
    ji, jl, ti, tl, qs = setup
    js, ts = jrr.predictor_init(128), rr.predictor_init(128)
    stream = search.build_stream(ti, tl)
    for i in range(3):
        q = qs[i * B:(i + 1) * B]
        jr, js = jsearch.ivf_pq_search_batch(
            ji, jnp.asarray(q), jl, k=K, n_probe=N_PROBE, n_cand=N_CAND,
            use_bbc=True, fused=fused, backend="ref", pred_state=js)
        tr, ts = search.ivf_pq_search_batch(
            ti, stream, torch.from_numpy(q), tl, k=K, n_probe=N_PROBE,
            n_cand=N_CAND, use_bbc=True, fused=fused, pred_state=ts)
        _assert_same(jr, tr)
        assert rr.predict_tau(ts, 1250) == int(jrr.predict_tau(js, 1250))


def test_engine_serves_the_searcher(setup):
    _, _, ti, tl, qs = setup
    eng = engine.SearchEngine.build(ti, k=K, n_probe=N_PROBE, device="cpu")
    assert eng.n_cand == N_CAND and eng.fused is None
    direct = search.ivf_pq_search_batch(
        ti, search.build_stream(ti, tl), torch.from_numpy(qs[:B]), tl, k=K,
        n_probe=N_PROBE, n_cand=N_CAND, use_bbc=True)
    res = eng.warmup((B,), predictive=True).search(qs[:B])
    assert torch.equal(res.ids, direct.ids)
    res2, state = eng.search(qs[:B], pred_state=eng.predictor_init())
    assert res2.ids.shape == (B, K) and float(state.weight) > 0


def test_engine_clamps_knobs(setup):
    _, _, ti, _, _ = setup
    eng = engine.SearchEngine.build(ti, k=K, n_probe=10 * C,
                                    n_cand=10 * N, device="cpu")
    assert eng.n_probe == C and eng.n_cand == N
    assert eng.pred_count <= eng.n_cand


def _assert_single_same(jr, tr):
    assert set(np.asarray(jr.ids).tolist()) == set(tr.ids.numpy().tolist())
    np.testing.assert_allclose(np.sort(tr.dists.numpy()),
                               np.sort(np.asarray(jr.dists)), rtol=1e-4,
                               atol=1e-4)
    assert int(tr.n_reranked) == int(jr.n_reranked)
    assert int(tr.n_second_pass) == int(jr.n_second_pass)


@pytest.mark.parametrize("call", ["single", "mesh", "tuned", "live", "ivf"])
def test_engine_unported_paths_raise(setup, call, tmp_path):
    """Paths once refused here are ported: single-query search and
    tombstones (``live``) on the single-device engine (``single``,
    ``ivf``) and on the sharded one (``mesh``), where a single query
    answers as the JAX engine's single call and an all-live mask changes
    nothing; and tuned operating points (``tuned``), which fill the knobs
    the JAX engine fills from the same point, with the same provenance."""
    ji, _, ti, _, qs = setup
    if call == "ivf":
        # the IVF strategy is ported; it needs the corpus vectors
        with pytest.raises(ValueError, match="vectors"):
            engine.SearchEngine.build(ti.ivf, k=K, n_probe=4, device="cpu")
        eng = engine.SearchEngine.build(ti.ivf, k=K, n_probe=4, device="cpu",
                                        vectors=ti.vectors)
        je = jengine.SearchEngine.build(ji.ivf, k=K, n_probe=4,
                                        vectors=ji.vectors)
        _assert_single_same(je.search(jnp.asarray(qs[0])), eng.search(qs[0]))
        return
    if call == "tuned":
        from repro.tuning import knobs as jkn
        from repro.tuning import points as jpts
        from repro_torch.tuning import knobs as tkn
        from repro_torch.tuning import points as tpts
        kw = dict(method="ivfpq", k=K, recall_target=0.95, recall=1.0,
                  cost_units=1.0, feasible=True)
        knobs = dict(n_probe=4, n_cand=2 * K, pred_count=K + 3)
        eng = engine.SearchEngine.build(
            ti, k=K, device="cpu", tuned=tpts.PointStore(
                [tpts.OperatingPoint(knobs=tkn.KnobConfig(**knobs), **kw)]))
        je = jengine.SearchEngine.build(ji, k=K, tuned=jpts.PointStore(
            [jpts.OperatingPoint(knobs=jkn.KnobConfig(**knobs), **kw)]))
        assert (eng.n_probe, eng.n_cand, eng.pred_count, eng.tuned_from) \
            == (je.n_probe, je.n_cand, je.pred_count, je.tuned_from)
        return
    if call == "mesh":
        # the sharded engine is ported, tombstones included: an all-live
        # mask places this rank's block and changes no result
        tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                 rank=0, world_size=1)
        try:
            eng = engine.SearchEngine.build(
                ti, k=K, n_probe=4, mesh=distributed.make_mesh((1,)))
            assert eng.mesh is not None and eng.layout is None
            live = eng.with_live(np.ones(N, bool))
            assert live.live.shape == eng.shard_layout.order.shape
            assert torch.equal(live.search(qs[:2]).ids, eng.search(qs[:2]).ids)
            # a single query is the sharded engine's singleton batch
            res = eng.search(qs[0])
            want = eng.search(qs[:1])
            assert res.ids.shape == (K,)
            assert torch.equal(res.ids, want.ids[0])
            assert torch.equal(res.n_reranked, want.n_reranked[0])
        finally:
            tdist.destroy_process_group()
        return
    if call == "single":
        # n_probe wide enough that the probed rows hold n_cand (the
        # reference's single-query selection needs it)
        eng = engine.SearchEngine.build(ti, k=K, n_probe=N_PROBE,
                                        device="cpu")
        je = jengine.SearchEngine.build(ji, k=K, n_probe=N_PROBE)
        _assert_single_same(je.search(jnp.asarray(qs[0])), eng.search(qs[0]))
        return
    # tombstones are ported (ROADMAP.md item 10): an all-live mask serves
    # the frozen engine's results
    eng = engine.SearchEngine.build(ti, k=K, n_probe=4, device="cpu")
    live = eng.with_live(np.ones(N, bool))
    assert live.live.shape == (setup[3].n_flat,)
    assert torch.equal(live.search(qs[:B]).ids, eng.search(qs[:B]).ids)


def test_serve_cli_cpu(capsys):
    assert serve.main(["--device", "cpu", "--n", "3000", "--d", "32",
                       "--k", "100", "--n-clusters", "16", "--n-probe", "8",
                       "--queries", "12", "--batch", "8",
                       "--tau-pred", "on"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["batch"] == 8
    assert out["recall_mean"] > 0.5
    for key in ("qps", "ms_per_query", "ms_per_batch", "recall_queries",
                "operating_point", "tau_pred", "mode", "method", "k"):
        assert key in out


@pytest.mark.parametrize("flag", [["--mode", "async", "--replicas", "2",
                                   "--shards", "2"],
                                  ["--mode", "async", "--faults",
                                   "crash@1:t=0.5"],
                                  ["--mode", "net", "--addr", "nowhere"],
                                  ["--tuned", "no/such/points.json"]])
def test_serve_cli_unported_flags_raise(flag, capfd):
    """What the CLI refuses raises before any work: ``--faults`` without
    ``--replicas > 1``, a ``--mode net`` address that is neither
    ``unix:/path`` nor ``host:port``, and a ``--tuned`` path that holds no
    point exit as the JAX CLI does.  The replica tier over shards (item
    12b), which once raised, serves on two gloo ranks with parity 1.0 (the
    name is kept so the test's history stays one line)."""
    if "--shards" in flag:
        assert serve.main(["--device", "cpu", *flag, "--n", "3000", "--d",
                           "16", "--n-clusters", "16", "--n-probe", "4",
                           "--queries", "12", "--k-choices", "20,60",
                           "--max-batch", "4", "--deadline-ms", "30000",
                           "--check-parity"]) == 0
        out = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
        assert out["shards"] == 2 and out["replicas"] == 2
        assert out["parity"] == 1.0 and out["conserved"]
        return
    with pytest.raises(SystemExit,
                       match="requires --replicas|no usable point|"
                             "unix:/path"):
        serve.main(["--device", "cpu", *flag])


@pytest.mark.cuda
def test_cuda_engine_matches_cpu(setup):
    """On a card: the engine's fused and unfused paths (CUDA kernels) give
    the CPU run's id sets on the same index."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    _, _, ti, _, qs = setup
    for use_bbc, fused in ((True, True), (True, False), (False, False)):
        cpu = engine.SearchEngine.build(ti, k=K, n_probe=N_PROBE,
                                        use_bbc=use_bbc, fused=fused,
                                        device="cpu").search(qs[:B])
        gpu = engine.SearchEngine.build(ti, k=K, n_probe=N_PROBE,
                                        use_bbc=use_bbc, fused=fused,
                                        device="cuda").search(qs[:B])
        for b in range(B):
            assert set(cpu.ids[b].tolist()) == set(gpu.ids[b].tolist())
