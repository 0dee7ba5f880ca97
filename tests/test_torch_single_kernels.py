"""The single-query kernels of the port: the RaBitQ estimator (#8) and the
single-query forms of the PQ, l2, bucket and fused kernels (#9-#12), their
plain versions against the JAX package's oracles on the JAX kernel tests'
shapes, the launch bookkeeping, and (on a card) each CUDA launch against
its plain version.

Bars: the RaBitQ estimator within rtol=atol=1e-4 of the JAX oracle (the
JAX kernel test's bar: the JAX side sums the code product as an XLA dot,
the port in ascending order), estimates within 1e-5, exact distances
within 2e-4 (the JAX l2 kernel test's bar: the JAX oracle uses the norm
identity, the port the direct sum), integer outputs equal on the same
input.  On a card the kernels equal their plain versions bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import buffer as jrb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import buffer as rb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)

RQ_SHAPES = [(256, 64), (300, 96), (1024, 128), (512, 100)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rq_inputs(rng, n, d):
    codes = rng.choice([-1, 1], (n, d)).astype(np.int8)
    norm_o = (rng.random(n) * 5 + 0.5).astype(np.float32)
    f_o = (rng.random(n) * 0.3 + 0.6).astype(np.float32)
    v = rng.standard_normal(d).astype(np.float32)
    v /= np.linalg.norm(v)
    return codes, norm_o, f_o, v, np.float32(3.3)


@pytest.mark.parametrize("n,d", RQ_SHAPES)
def test_rabitq_est_plain_matches_reference(rng, n, d):
    args = _rq_inputs(rng, n, d)
    want = jref.rabitq_est(*(jnp.asarray(a) for a in args))
    got_ref = ref.rabitq_est(*(_t(a) for a in args))
    got_ops = ops.rabitq_est(*(_t(a) for a in args))
    for w, g, o in zip(want, got_ref, got_ops):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(g, o)        # the wrapper's CPU route


def test_rabitq_est_matches_the_reference_kernel(rng):
    """Against the JAX wrapper's Pallas kernel (interpret mode on the CPU),
    which pads n to its tile and d to 128 lanes."""
    args = _rq_inputs(rng, 300, 100)
    want = jops.rabitq_est(*(jnp.asarray(a) for a in args))
    got = ops.rabitq_est(*(_t(a) for a in args))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_rabitq_est_tiles_are_per_tile_calls(rng):
    """The tile form (what the searcher launches, one call over every probed
    tile) gives each tile's single call to the bit, +inf off ``valid``."""
    t, cap, d = 5, 200, 96
    codes = _t(rng.choice([-1, 1], (t, cap, d)).astype(np.int8))
    norm_o = _t((rng.random((t, cap)) * 5 + 0.5).astype(np.float32))
    f_o = _t((rng.random((t, cap)) * 0.3 + 0.6).astype(np.float32))
    v = _t(rng.standard_normal((t, d)).astype(np.float32))
    nq = _t((rng.random(t) * 3 + 1).astype(np.float32))
    valid = _t(rng.random((t, cap)) < 0.8)
    got = ops.rabitq_est_tiles(codes, norm_o, f_o, v, nq, valid)
    for i in range(t):
        single = ops.rabitq_est(codes[i], norm_o[i], f_o[i], v[i], nq[i])
        for g, s in zip(got, single):
            assert torch.equal(g[i], torch.where(valid[i], s, float("inf")))


@pytest.mark.parametrize("n", [256, 1000, 4096])
@pytest.mark.parametrize("m_sub", [16, 32, 33])
def test_pq_adc_single_matches_reference(rng, n, m_sub):
    codes = rng.integers(0, 16, (n, m_sub)).astype(np.uint8)
    lut = rng.random((m_sub, 16)).astype(np.float32)
    want = np.asarray(jref.pq_adc(jnp.asarray(codes), jnp.asarray(lut)))
    got = ops.pq_adc(_t(codes), _t(lut))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ref.pq_adc(_t(codes), _t(lut)))


@pytest.mark.parametrize("n,d", [(256, 64), (999, 1536), (4096, 96)])
def test_l2_exact_single_matches_reference(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal(d).astype(np.float32)
    want = np.asarray(jref.l2_exact(jnp.asarray(x), jnp.asarray(q)))
    got = ops.l2_exact(_t(x), _t(q))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert torch.equal(got, ref.l2_exact(_t(x), _t(q)))


@pytest.mark.parametrize("n", [512, 2000, 8192])
@pytest.mark.parametrize("m", [16, 64, 128])
def test_bucket_hist_single_matches_reference(rng, n, m):
    valid = rng.random(n) < 0.9
    dists = np.where(valid, rng.random(n) * 10 + 1, np.inf).astype(np.float32)
    cb = jrb.build_codebook(jnp.asarray(dists), k=min(n // 2, 1000), m=m)
    want_b, want_h = jref.bucket_hist(jnp.asarray(dists), jnp.asarray(valid),
                                      cb.d_min, cb.delta, cb.ew_map, m)
    args = (_t(dists), _t(valid), _t(cb.d_min), _t(cb.delta), _t(cb.ew_map),
            m)
    got_b, got_h = ops.bucket_hist(*args)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    ref_b, ref_h = ref.bucket_hist(*args)
    assert torch.equal(got_b, ref_b) and torch.equal(got_h, ref_h)


@pytest.mark.parametrize("n,d,m_sub", [(512, 64, 16), (1000, 128, 32),
                                       (256, 96, 24)])
def test_fused_scan_single_matches_reference(rng, n, d, m_sub):
    """Estimates within 1e-5 of the JAX oracle; bucket, histogram and nmiss
    equal to the JAX oracle's bucketize run on the port's own estimate;
    the early leg within 1e-4 of the JAX oracle's."""
    k_codes, m = 16, 64
    codes = rng.integers(0, k_codes, (n, m_sub)).astype(np.uint8)
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal(d).astype(np.float32)
    valid = rng.random(n) < 0.95
    lut = (rng.random((m_sub, k_codes)) * 2).astype(np.float32)
    est_ref = jnp.sqrt(jnp.maximum(jref.pq_adc(jnp.asarray(codes),
                                               jnp.asarray(lut)), 0.0))
    cb = jrb.build_codebook(jnp.where(jnp.asarray(valid), est_ref, jnp.inf),
                            k=min(n // 2, 500), m=m)
    tau = m // 3
    want = jref.fused_scan(jnp.asarray(codes), jnp.asarray(vectors),
                           jnp.asarray(valid), jnp.asarray(lut),
                           jnp.asarray(q), cb.d_min, cb.delta, cb.ew_map, m,
                           jnp.int32(tau))
    args = (_t(codes), _t(vectors), _t(valid), _t(lut), _t(q), _t(cb.d_min),
            _t(cb.delta), _t(cb.ew_map), m, tau)
    est, bucket, hist, early, nmiss = ops.fused_scan(*args)
    np.testing.assert_allclose(est.numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    j_b, j_h = jref.bucket_hist(jnp.asarray(est.numpy()), jnp.asarray(valid),
                                cb.d_min, cb.delta, cb.ew_map, m)
    np.testing.assert_array_equal(bucket.numpy(), np.asarray(j_b))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(j_h))
    pred = valid & (np.asarray(j_b) <= tau)
    assert int(nmiss) == int(valid.sum() - pred.sum())
    assert np.array_equal(np.isfinite(early.numpy()), pred)
    exact = np.asarray(jref.l2_exact(jnp.asarray(vectors), jnp.asarray(q)))
    np.testing.assert_allclose(early.numpy()[pred], exact[pred], rtol=1e-4,
                               atol=1e-4)
    for g, w in zip((est, bucket, hist, early, nmiss), ref.fused_scan(*args)):
        assert torch.equal(g, w)


def test_single_query_launches_count_under_their_own_rows():
    """A batched PQ/l2/bucket/fused launch at B = 1 is the single-query
    kernel's; plain-version calls count nothing."""
    ops.reset_launches()
    for name in ("pq_adc", "l2_exact", "bucket_hist", "fused_scan"):
        ops._count(name, 1)
        ops._count(name, 8)
        assert ops.LAUNCHES[name] == 1 and ops.LAUNCHES[name + "_batch"] == 1
    ops.reset_launches()
    ops.l2_exact(torch.ones(4, 3), torch.zeros(3))
    ops.rabitq_est(torch.ones(4, 3, dtype=torch.int8), torch.ones(4),
                   torch.ones(4), torch.ones(3), 1.0)
    assert set(ops.LAUNCHES.values()) == {0}


@pytest.mark.cuda
def test_cuda_single_query_kernels_match_plain(cuda, rng):
    """On a card: #8 in its tile and single forms, bitwise, at the JAX
    shapes, and #9-#12 at B = 1 against their plain versions (integers
    equal, exact legs and estimates bitwise)."""
    for n, d in RQ_SHAPES:
        args = [_t(a).to(cuda) for a in _rq_inputs(rng, n, d)]
        before = ops.LAUNCHES["rabitq_est"]
        got = ops.rabitq_est(*args)
        assert ops.LAUNCHES["rabitq_est"] == before + 1
        for g, w in zip(got, ref.rabitq_est(*args)):
            assert torch.equal(g, w)
    n, d, m_sub, m = 1000, 128, 32, 64
    codes = _t(rng.integers(0, 16, (n, m_sub)).astype(np.uint8)).to(cuda)
    vectors = _t(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    q = _t(rng.standard_normal(d).astype(np.float32)).to(cuda)
    valid = _t(rng.random(n) < 0.95).to(cuda)
    lut = _t((rng.random((m_sub, 16)) * 2).astype(np.float32)).to(cuda)
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.pq_adc(codes, lut), ref.pq_adc(codes, lut))
    assert torch.equal(ops.l2_exact(vectors, q), ref.l2_exact(vectors, q))
    assert ops.LAUNCHES["pq_adc"] == before["pq_adc"] + 1
    assert ops.LAUNCHES["l2_exact"] == before["l2_exact"] + 1
    # the B=1 dispatch: the batched kernels at one query a tile (ADC) and
    # at the 8-query tile (l2)
    assert ops._adc_plan(1, n, m_sub, 16).qt == 1
    assert ops._l2_plan(1, n, d).qt == 8
    est = torch.sqrt(ref.pq_adc(codes, lut))
    cb = rb.build_codebook(torch.where(valid, est, float("inf"))[None],
                           k=500, m=m)
    bh = (est, valid, cb.d_min, cb.delta, cb.ew_map, m)
    for g, w in zip(ops.bucket_hist(*bh), ref.bucket_hist(*bh)):
        assert torch.equal(g, w)
    fs = (codes, vectors, valid, lut, q, cb.d_min, cb.delta, cb.ew_map, m,
          m // 3)
    for g, w in zip(ops.fused_scan(*fs), ref.fused_scan(*fs)):
        assert torch.equal(g, w)
