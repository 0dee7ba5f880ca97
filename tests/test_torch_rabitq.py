"""The port's RaBitQ pieces against the JAX package's: the rotation, the
encoder, the conversion of a reference index, the plain version of the
bound-fused scan against the reference's mirror, and the greedy Alg. 3
plan and finalize.

Config: the reference's own RaBitQ test (``tests/test_rabitq_fused.py``):
N=8000, D=64, 32 clusters, 6 queries, k=200, n_probe=12, m=128, eps0=3.0.
Float lanes of the scan agree within rtol=atol=2e-4 (the reference's own
kernel-vs-mirror bar), exact distances within 1e-4; integer outputs are
compared on the same fp32 input, by bucketizing the reference's bounds
with the port's bucketize.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import rerank as jrr  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import buffer as rb  # noqa: E402
from repro_torch.core import numerics  # noqa: E402
from repro_torch.core import rerank as rr  # noqa: E402
from repro_torch.index import flat, ivf, rabitq, search  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)

N, D, C, NQ = 8000, 64, 32, 6
K, N_PROBE, M, EPS0 = 200, 12, 128, 3.0


def rabitq_arrays(ji) -> dict:
    """The numpy arrays of a JAX ``RabitqIndex`` that ``convert`` takes."""
    arrays = {
        "ivf_centroids": ji.ivf.centroids, "member_ids": ji.ivf.member_ids,
        "member_valid": ji.ivf.member_valid,
        "cluster_sizes": ji.ivf.cluster_sizes, "vectors": ji.vectors,
        "rot": ji.rq.rot, "codes": ji.rq.codes, "norm_o": ji.rq.norm_o,
        "f_o": ji.rq.f_o}
    return {k: np.asarray(v) for k, v in arrays.items()}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    x = synthetic.clustered(rng, N, D, n_centers=64)
    return x, synthetic.queries_from(rng, x, NQ)


@pytest.fixture(scope="module")
def jindex(corpus):
    x, _ = corpus
    return jsearch.build_rabitq_index(jax.random.key(0), jnp.asarray(x), C,
                                      n_iter=4)


@pytest.fixture(scope="module")
def tindex(jindex):
    return convert.rabitq_index_from_numpy(rabitq_arrays(jindex),
                                           device="cpu")


@pytest.fixture(scope="module")
def scan(jindex, tindex, corpus):
    """The reference's scan inputs (routing, stream, sample codebooks and
    static gate, exactly what its fused searcher feeds the kernel) and the
    port's, built from the same index."""
    _, qs = corpus
    jq = jnp.asarray(qs)
    jl = jivf.flat_layout(jindex.ivf)
    js = jsearch.rabitq_stream(jindex, jl)
    probed, lane_valid, d2 = jsearch._routing(jindex.ivf, jl, jq, N_PROBE)
    st = min(4, N_PROBE)
    sample_ub, _ = jsearch._rabitq_sample_ub(
        js.codes, js.norm_o, js.f_o, js.cl, jindex.ivf.centroids,
        jindex.rq.rot, jl, probed, jq, d2, st, jindex.ivf.cap, EPS0)
    cbs, tau = jsearch._rabitq_sample_plan(sample_ub, K, K, st, N_PROBE, M)
    ti, tl = tindex
    ts = search.build_stream(ti, tl)
    return dict(jstream=js, jlayout=jl, lane_valid=lane_valid, d2=d2,
                cbs=cbs, tau=tau, tstream=ts, qs=qs)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("d", [16, 64, 100])
def test_random_rotation_is_orthonormal(d):
    rot = rabitq.random_rotation(torch.Generator().manual_seed(d), d)
    eye = torch.eye(d)
    torch.testing.assert_close(rot @ rot.T, eye, rtol=0, atol=1e-5)
    torch.testing.assert_close(rot.T @ rot, eye, rtol=0, atol=1e-5)
    again = rabitq.random_rotation(torch.Generator().manual_seed(d), d)
    assert torch.equal(rot, again)


def test_encode_matches_reference(jindex, corpus):
    """On the reference's rotation, centroids and assignment the port's
    codes are the reference's, except where the rotated coordinate is
    within 1e-6 of 0; the factors agree."""
    x, _ = corpus
    cent = np.asarray(jindex.ivf.centroids)
    xj = jnp.asarray(x)
    assignment = np.asarray(jnp.argmin(
        jnp.sum(xj * xj, 1, keepdims=True) - 2 * xj @ jnp.asarray(cent).T
        + jnp.sum(jnp.asarray(cent) ** 2, 1), axis=1))
    rot = np.asarray(jindex.rq.rot)
    got = rabitq.encode(_t(x), _t(cent), _t(assignment), _t(rot))
    r = x - cent[assignment]
    u = (r / np.linalg.norm(r, axis=1, keepdims=True)) @ rot.T
    differ = got.codes.numpy() != np.asarray(jindex.rq.codes)
    assert np.all(np.abs(u[differ]) < 1e-6)
    assert got.codes.dtype == torch.int8
    np.testing.assert_allclose(got.norm_o.numpy(),
                               np.asarray(jindex.rq.norm_o), rtol=1e-5)
    np.testing.assert_allclose(got.f_o.numpy(), np.asarray(jindex.rq.f_o),
                               rtol=1e-5)


def test_convert_and_stream_match_reference(jindex, tindex, scan):
    ti, tl = tindex
    arrays = rabitq_arrays(jindex)
    np.testing.assert_array_equal(ti.rq.codes.numpy(), arrays["codes"])
    np.testing.assert_array_equal(ti.ivf.member_ids.numpy(),
                                  arrays["member_ids"])
    np.testing.assert_array_equal(tl.order.numpy(),
                                  np.asarray(scan["jlayout"].order))
    js, ts = scan["jstream"], scan["tstream"]
    np.testing.assert_array_equal(ts.codes.numpy(), np.asarray(js.codes))
    np.testing.assert_array_equal(ts.cl.numpy(), np.asarray(js.cl))
    for name in ("vectors", "norm_o", "f_o"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    assert ts.codes.dtype == torch.int8 and ts.cl.dtype == torch.int32
    # s2, which the reference recomputes per call, against its formula
    h = jindex.ivf.centroids @ jindex.rq.rot.T
    want = jnp.sum(js.codes * h[js.cl], axis=1)
    np.testing.assert_allclose(ts.s2.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    with pytest.raises(KeyError, match="rot"):
        convert.rabitq_index_from_numpy(
            {k: v for k, v in arrays.items() if k != "rot"}, device="cpu")


def test_fixed_order_sums():
    """ordered_sum and rotate agree with the plain reductions to rounding,
    and code_dot is the ascending-j sum."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 37, generator=g)
    torch.testing.assert_close(numerics.ordered_sum(x), x.sum(-1),
                               rtol=1e-5, atol=1e-5)
    rot = torch.randn(37, 37, generator=g)
    q = torch.randn(4, 37, generator=g)
    torch.testing.assert_close(numerics.rotate(q, rot), q @ rot.T,
                               rtol=1e-4, atol=1e-4)
    codes = torch.where(torch.randn(9, 37, generator=g) > 0, 1, -1).to(
        torch.int8)
    want = torch.zeros(4, 9)
    for j in range(37):
        want = want + codes[:, j].float()[None] * q[:, j, None]
    assert torch.equal(numerics.code_dot(codes, q), want)


@pytest.mark.parametrize("d", [1, 37, 128])
def test_exact_dist_is_the_ascending_fp32_sum(d):
    """exact_dist adds the fp32 squares in ascending coordinate order, one
    rounding per operation (the CUDA kernels' order), takes the correctly
    rounded square root (numpy's, the card's), and agrees with the fp64
    distance to fp32 rounding; the plain l2 kernel version is it."""
    g = torch.Generator().manual_seed(d)
    x = torch.randn(50, d, generator=g) * 10
    q = torch.randn(3, d, generator=g) * 10
    want = torch.zeros(3, 50)
    for j in range(d):
        t = x[None, :, j] - q[:, j, None]
        want = want + t * t
    got = numerics.exact_dist(x[None], q[:, None])
    assert torch.equal(got, torch.from_numpy(np.sqrt(want.numpy())))
    assert torch.equal(ref.l2_exact_batch(x, q), got)
    f64 = torch.cdist(q.double(), x.double())
    torch.testing.assert_close(got.double(), f64, rtol=1e-5, atol=1e-5)


def _scan_args(jindex, tindex, scan, tau):
    ti, _ = tindex
    ts, cbs = scan["tstream"], scan["cbs"]
    qs = _t(scan["qs"])
    return (ts.codes, ts.vectors, ts.s2, ts.norm_o, ts.f_o, ts.cl,
            numerics.rotate(qs, ti.rq.rot), qs,
            numerics.sqrt_rn(_t(scan["d2"])), _t(scan["lane_valid"]),
            _t(cbs.d_min), _t(cbs.delta), _t(cbs.ew_map), M,
            _t(tau, torch.int32))


@pytest.mark.parametrize("gate", ["static", "cold", "all"])
def test_plain_scan_matches_reference_mirror(jindex, tindex, scan, gate):
    tau = {"static": np.asarray(scan["tau"]),
           "cold": np.full(NQ, -1, np.int32),
           "all": np.full(NQ, M - 1, np.int32)}[gate]
    js, cbs = scan["jstream"], scan["cbs"]
    jout = jref.fused_rabitq_scan_batch(
        js.codes, js.vectors, js.norm_o, js.f_o, js.cl,
        jindex.ivf.centroids, jindex.rq.rot, jnp.asarray(scan["qs"]),
        scan["d2"], scan["lane_valid"], cbs.d_min, cbs.delta, cbs.ew_map, M,
        jnp.asarray(tau), EPS0)
    args = _scan_args(jindex, tindex, scan, tau)
    tout = ref.fused_rabitq_scan_batch(*args, eps0=EPS0)
    (jest, jlb, jub, jblb, jbub, jhlb, jhub, jexact, jcert,
     jnmiss) = (np.asarray(a) for a in jout)
    for name, a, b in (("est", tout[0], jest), ("lb", tout[1], jlb),
                       ("ub", tout[2], jub)):
        a = a.numpy()
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                      err_msg=name)
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=2e-4, atol=2e-4,
                                   err_msg=name)
    # integers on the same fp32 input: the reference's bounds through the
    # port's bucketize
    valid = args[9]
    d_min, delta, ew = args[10], args[11], args[12]
    blb = ref.bucketize_batch(_t(jlb), d_min, delta, ew, M)
    bub = ref.bucketize_batch(_t(jub), d_min, delta, ew, M)
    np.testing.assert_array_equal(blb.numpy(), jblb)
    np.testing.assert_array_equal(bub.numpy(), jbub)
    np.testing.assert_array_equal(ref.histogram_batch(blb, valid, M).numpy(),
                                  jhlb)
    np.testing.assert_array_equal(ref.histogram_batch(bub, valid, M).numpy(),
                                  jhub)
    cert = valid & (blb <= args[14][:, None])
    np.testing.assert_array_equal(cert.numpy(), jcert)
    np.testing.assert_array_equal(
        (valid & ~cert).sum(1).numpy(), jnmiss)
    # the port's own integers are self-consistent
    assert torch.equal(tout[3], ref.bucketize_batch(tout[1], d_min, delta,
                                                    ew, M))
    assert torch.equal(tout[8], valid & (tout[3] <= args[14][:, None]))
    assert torch.equal(tout[9], (valid & ~tout[8]).sum(1).to(torch.int32))
    # exact distances on the certified lanes
    ex = tout[7].numpy()
    fin = np.isfinite(ex)
    np.testing.assert_array_equal(fin, tout[8].numpy())
    if fin.any():
        want = np.linalg.norm(
            scan["qs"][:, None, :] - np.asarray(js.vectors)[None], axis=-1)
        np.testing.assert_allclose(ex[fin], want[fin], rtol=1e-4, atol=1e-4)
    if gate == "static":
        jfin = np.isfinite(jexact)
        np.testing.assert_allclose(ex[fin & jfin], jexact[fin & jfin],
                                   rtol=1e-4, atol=1e-4)


def test_ops_routes_cpu_tensors_to_the_plain_version(jindex, tindex, scan):
    args = _scan_args(jindex, tindex, scan, np.asarray(scan["tau"]))
    ops.reset_launches()
    got = ops.fused_rabitq_scan_batch(*args, eps0=EPS0)
    want = ref.fused_rabitq_scan_batch(*args, eps0=EPS0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ops.LAUNCHES["fused_rabitq_scan_batch"] == 0
    meta = [a.to("meta") if i == 1 else a for i, a in enumerate(args)]
    with pytest.raises(ValueError, match="mixed or unsupported devices"):
        ops.fused_rabitq_scan_batch(*meta, eps0=EPS0)


def test_greedy_plan_and_finalize_match_reference(jindex, scan):
    """Alg. 3 planning and finalize on the reference's own two-phase
    bounds: every plan field equal, the same ordered ids, and the same
    reported distances."""
    js = scan["jstream"]
    jq = jnp.asarray(scan["qs"])
    valid = scan["lane_valid"]
    est, lb, ub = jsearch._rabitq_batch_bounds(jindex, js, jq, valid, EPS0,
                                               d2=scan["d2"])
    jplan = jrr.greedy_rerank_plan_batch(lb, ub, K, valid, m=M)
    tplan = rr.greedy_rerank_plan_batch(_t(lb), _t(ub), K, _t(valid), m=M)
    for name in rr.GreedyRerankPlan._fields:
        np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                      np.asarray(getattr(jplan, name)),
                                      err_msg=name)
    exact = jnp.linalg.norm(jq[:, None, :] - js.vectors[None], axis=-1)
    exact = jnp.where(jplan.rerank_mask, exact, jnp.inf)
    order = scan["jlayout"].order
    jres = jax.vmap(lambda p, ef, lbv, e: jrr.greedy_rerank_finalize(
        p, ef, lbv, order, K, est=e))(jplan, exact, lb, est)
    tres = rr.greedy_rerank_finalize(tplan, _t(exact), _t(lb),
                                     _t(order).long(), K, est=_t(est))
    np.testing.assert_array_equal(tres.topk_ids.numpy(),
                                  np.asarray(jres.topk_ids))
    np.testing.assert_array_equal(tres.topk_dists.numpy(),
                                  np.asarray(jres.topk_dists))
    np.testing.assert_array_equal(tres.n_reranked.numpy(),
                                  np.asarray(jres.n_reranked))


def test_port_build_bounds_hold(corpus):
    """On the port's own index, lb <= exact <= ub on at least 99% of the
    probed lanes (the reference's ``tests/test_index.py`` check)."""
    x, qs = corpus
    ti = search.build_rabitq_index(x, C, n_iter=4, seed=1, device="cpu")
    assert ti.rq.codes.dtype == torch.int8
    assert set(np.unique(ti.rq.codes.numpy()).tolist()) <= {-1, 1}
    tl = ivf.flat_layout(ti.ivf)
    ts = search.build_stream(ti, tl)
    q = torch.from_numpy(qs)
    _, lane_valid, d2 = search._routing(ti.ivf, tl, q, N_PROBE)
    _, lb, ub = numerics.rabitq_bounds_stream(
        ts.codes, ts.s2, ts.norm_o, ts.f_o, ts.cl,
        numerics.rotate(q, ti.rq.rot), numerics.sqrt_rn(d2), lane_valid,
        EPS0)
    exact = ref.l2_exact_batch(ts.vectors, q)
    tol = 1e-4
    ok = (lb <= exact + tol) & (exact <= ub + tol)
    assert ok[lane_valid].float().mean().item() >= 0.99


def test_port_build_recall_close_to_reference():
    """At the verify config (12,000 x 64, 64 clusters, k=500) the port's own
    build reaches the JAX build's recall@k within 0.02 on the fused BBC
    searcher."""
    rng = np.random.default_rng(0)
    x = synthetic.clustered(rng, 12000, 64)
    qs = synthetic.queries_from(rng, x, 8)
    k, n_probe = 500, 16
    ji = jsearch.build_rabitq_index(jax.random.key(0), jnp.asarray(x), 64)
    jres = jsearch.ivf_rabitq_search_batch(
        ji, jnp.asarray(qs), jivf.flat_layout(ji.ivf), k=k, n_probe=n_probe,
        use_bbc=True, backend="ref")
    ti = search.build_rabitq_index(x, 64, device="cpu")
    tl = ivf.flat_layout(ti.ivf)
    tres = search.ivf_rabitq_search_batch(
        ti, search.build_stream(ti, tl), torch.from_numpy(qs), tl, k=k,
        n_probe=n_probe, use_bbc=True)
    _, gt = flat.search_batch(torch.from_numpy(x), torch.from_numpy(qs), k)

    def recall(ids):
        return np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                        for a, b in zip(ids, gt.numpy())])

    assert recall(tres.ids.numpy()) >= recall(np.asarray(jres.ids)) - 0.02


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On a card, at the reference's ragged kernel-test shapes (B=3,
    n=1000, d=100): every output bitwise equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(3)
    b, n, d, c, m = 3, 1000, 100, 7, 64
    dev = "cuda"
    cl = torch.from_numpy(np.sort(rng.integers(0, c, n)).astype(np.int32))
    codes = torch.from_numpy(
        np.where(rng.random((n, d)) < 0.5, 1, -1).astype(np.int8))
    rot = rabitq.random_rotation(torch.Generator().manual_seed(0), d)
    cent = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32))
    qs = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    vecs = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    norm_o = torch.from_numpy(rng.random(n).astype(np.float32) + 0.5)
    f_o = torch.from_numpy(0.7 + 0.15 * rng.random(n).astype(np.float32))
    valid = torch.from_numpy(rng.random((b, n)) < 0.9)
    diff = cent[None] - qs[:, None]
    d2 = numerics.ordered_sum(diff * diff)
    s2 = numerics.rabitq_s2(codes, numerics.rotate(cent, rot), cl)
    g, nq = numerics.rotate(qs, rot), numerics.sqrt_rn(d2)
    _, _, ub = numerics.rabitq_bounds_stream(codes, s2, norm_o, f_o, cl, g,
                                             nq, valid, EPS0)
    cb = rb.build_codebook(ub, k=300, m=m)
    tau = torch.tensor([-1, m // 2, m - 1], dtype=torch.int32)
    args = [codes, vecs, s2, norm_o, f_o, cl, g, qs, nq, valid,
            cb.d_min, cb.delta, cb.ew_map, m, tau]
    want = ref.fused_rabitq_scan_batch(*args, eps0=EPS0)
    cuda_args = [a.to(dev) if torch.is_tensor(a) else a for a in args]
    got = ops.fused_rabitq_scan_batch(*cuda_args, eps0=EPS0)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a.cpu(), b), i
