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


# --------------------------------------------------------------------------
# the one-query fused scan (#9): its launch plan on the CPU, its kernel on
# a card
# --------------------------------------------------------------------------

def _fs_smem(m_sub, k_codes, d, n_ew, m):
    """fused_scan.cu's one-query layout: the LUT, the query, the ew_map,
    8 warp histograms, 8 miss counts."""
    return 4 * (m_sub * k_codes + d + n_ew + 8 * (m + 1) + 8)


@pytest.mark.parametrize("n", [1, 5, 31, 32, 262_147, 1_000_064,
                               4_505_723])
@pytest.mark.parametrize("smem", [_fs_smem(32, 16, 128, 256, 128),
                                  _fs_smem(128, 256, 960, 256, 128)])
def test_scan_plan_covers_every_tile_once(n, smem):
    """The 32-lane tiles cover the n lanes; dealt round robin to the grid's
    warps, each warp takes at most ``per`` of them and every tile has one
    warp; no more blocks than the tiles fill or the SMs hold at the
    kernel's shared memory."""
    p = ops._scan_plan(n, smem, ops.SMS)
    assert (p.chunks - 1) * ops.FS_TILE < n <= p.chunks * ops.FS_TILE
    per_sm = max(1, min(ops.FS_BLOCKS_PER_SM,
                        ops.SMEM_PER_SM // (smem + 1024)))
    assert p.grid == min(-(-p.chunks // ops.FS_WARPS), ops.SMS * per_sm)
    warps = p.grid * ops.FS_WARPS
    taken = [len(range(w, p.chunks, warps)) for w in range(warps)]
    assert sum(taken) == p.chunks and max(taken) == p.per


def test_scan_plan_refuses_int32_overflow():
    with pytest.raises(ValueError, match="int32"):
        ops._scan_plan(2 ** 31 - 100, _fs_smem(32, 16, 128, 256, 128))


@pytest.mark.parametrize("tau", [3, -1, 64])
def test_fused_scan_int_and_tensor_thresholds_agree(rng, tau):
    """The single-query wrapper takes its threshold as an int or as a
    one-element tensor; both give the plain version's outputs."""
    n, d, m_sub, m = 300, 16, 8, 64
    codes = _t(rng.integers(0, 16, (n, m_sub)).astype(np.uint8))
    vectors = _t(rng.standard_normal((n, d)).astype(np.float32))
    q = _t(rng.standard_normal(d).astype(np.float32))
    valid = _t(rng.random(n) < 0.7)
    lut = _t((rng.random((m_sub, 16)) * 2).astype(np.float32))
    est = torch.sqrt(ref.pq_adc(codes, lut))
    cb = rb.build_codebook(torch.where(valid, est, float("inf"))[None],
                           k=100, m=m)
    args = (codes, vectors, valid, lut, q, cb.d_min, cb.delta, cb.ew_map, m)
    a = ops.fused_scan(*args, tau)
    b = ops.fused_scan(*args, torch.tensor([tau], dtype=torch.int32))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a[4]) == int((valid & (a[1] > tau)).sum())


def _same(a, b):
    """Equal, with NaN at the same places."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def _fused_edge_case(rng, n, m_sub, d, dev, shift=0, density=0.5):
    """One query's inputs with +inf and NaN estimates (LUT entries) and
    rows (coordinates), moved to ``dev``; ``shift`` = 1 makes codes,
    vectors and validity views one element into their buffers."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        if not shift:
            return t
        flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    codes = rng.integers(0, 16, (n, m_sub)).astype(np.uint8)
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    vectors[::97, d // 2] = np.nan
    vectors[::89, 0] = np.inf
    valid = rng.random(n) < density
    lut = (rng.random((m_sub, 16)) * 2).astype(np.float32)
    est = np.sqrt(np.asarray(ref.pq_adc(_t(codes), _t(lut))))
    lut[0, 15], lut[1, 14] = np.inf, np.nan
    cb = rb.build_codebook(torch.where(_t(valid), _t(est), float("inf"))[None],
                           k=min(max(n // 8, 8), 5000), m=128)
    q = rng.standard_normal(d).astype(np.float32)
    return (put(codes), put(vectors), put(valid), _t(lut).to(dev),
            _t(q).to(dev), cb.d_min.to(dev), cb.delta.to(dev),
            cb.ew_map.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m_sub,d", [(262_147, 32, 128), (1003, 24, 96),
                                       (20_001, 33, 100), (3000, 32, 960),
                                       (5, 16, 64)])
@pytest.mark.parametrize("shift", [0, 1])
def test_cuda_fused_scan_one_query_edges(cuda, rng, n, m_sub, d, shift):
    """#9's one-query kernel bitwise against the plain version: n not a
    multiple of 4 or of a block's lanes, aligned and unaligned views,
    +inf and NaN estimates and rows, the normal and the degenerate
    codebooks (delta 0, d_min +inf, both), thresholds -1, 5, m // 3 and
    m (every valid lane predicted), as an int and as a tensor."""
    a = _fused_edge_case(rng, n, m_sub, d, cuda, shift)
    d_min, delta = a[5], a[6]
    for dm, dl in ((d_min, delta), (d_min, torch.zeros_like(delta)),
                   (torch.full_like(d_min, float("inf")), delta),
                   (torch.full_like(d_min, float("inf")),
                    torch.zeros_like(delta))):
        for tau in (-1, 5, 42, 128):
            args = (*a[:5], dm, dl, a[7], 128)
            want = ref.fused_scan(*args, tau)
            before = ops.LAUNCHES["fused_scan"]
            for got in (ops.fused_scan(*args, tau),
                        ops.fused_scan(*args, torch.tensor(
                            [tau], dtype=torch.int32, device=cuda))):
                assert all(_same(x, y) for x, y in zip(got, want)), \
                    (dm, dl, tau)
            assert ops.LAUNCHES["fused_scan"] == before + 2


@pytest.mark.cuda
def test_cuda_fused_scan_no_valid_lane_every_lane_predicted_repeats(cuda,
                                                                     rng):
    """No valid lane (only the +inf stores and no flush), every lane valid
    and predicted, and ten repeated calls interleaved with another shape,
    each bitwise the plain version's; the batched wrapper at B = 1 takes
    the one-query kernel."""
    for density, tau in ((0.0, 64), (1.0, 128)):
        a = _fused_edge_case(rng, 262_147, 32, 128, cuda, density=density)
        args = (*a, 128, tau)
        assert all(_same(x, y) for x, y in zip(ops.fused_scan(*args),
                                                ref.fused_scan(*args)))
    first = (*_fused_edge_case(rng, 1_000_064, 32, 128, cuda), 128, 42)
    other = (*_fused_edge_case(rng, 5000, 24, 96, cuda), 128, 7)
    want = ref.fused_scan(*first)
    for _ in range(10):
        got = ops.fused_scan(*first)
        ops.fused_scan(*other)
        assert all(_same(x, y) for x, y in zip(got, want))
    tau = torch.tensor([42], dtype=torch.int32, device=cuda)
    before = dict(ops.LAUNCHES)
    batched = ops.fused_scan_batch(first[0], first[1], first[2][None],
                                   first[3][None], first[4][None], first[5],
                                   first[6], first[7][None], 128, tau)
    assert ops.LAUNCHES["fused_scan"] == before["fused_scan"] + 1
    assert ops.LAUNCHES["fused_scan_batch"] == before["fused_scan_batch"]
    assert all(_same(x[0], y) for x, y in zip(batched, want))
