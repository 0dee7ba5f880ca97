"""The port's kernel mirrors (repro_torch.kernels.ref) against the JAX
package's oracles (repro.kernels.ref) on the JAX kernel tests' shapes, the
wrappers' device routing, the launch plans of the exact-distance, ADC,
bucketize-histogram and RaBitQ estimator kernels, and (on a card) each
CUDA kernel against its plain version.

Float bars against JAX are the JAX kernel tests': rtol=atol=1e-5 for the
ADC and fused estimates, 1e-4 for the early exact distances, 2e-4 for l2.
Integer outputs are held equal where both sides bucketize the same
estimate.  On a card the ADC and l2 kernels equal their plain versions bit
for bit (the same order and roundings).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import buffer as jrb  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.array(a))


def _codebooks(est_rows, k, m):
    cbs = [jrb.build_codebook(jnp.asarray(e), k=k, m=m) for e in est_rows]
    return (np.stack([np.asarray(c.d_min) for c in cbs]),
            np.stack([np.asarray(c.delta) for c in cbs]),
            np.stack([np.asarray(c.ew_map) for c in cbs]))


@pytest.mark.parametrize("b", [1, 5, 8])
@pytest.mark.parametrize("n,m_sub", [(512, 16), (1000, 33)])
def test_pq_adc_batch_mirror(rng, b, n, m_sub):
    codes = rng.integers(0, 16, (n, m_sub)).astype(np.uint8)
    luts = rng.random((b, m_sub, 16)).astype(np.float32)
    want = np.asarray(jref.pq_adc_batch(jnp.asarray(codes), jnp.asarray(luts)))
    got = ref.pq_adc_batch(_t(codes), _t(luts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the wrapper routes CPU tensors to the plain version
    np.testing.assert_array_equal(ops.pq_adc_batch(_t(codes), _t(luts)).numpy(),
                                  got)


@pytest.mark.parametrize("b", [1, 4, 8, 11])
@pytest.mark.parametrize("n", [512, 1000])
def test_bucket_hist_batch_mirror(rng, b, n):
    m = 64
    valid = rng.random((b, n)) < 0.9
    dists = np.where(valid, rng.random((b, n)) * 10 + 1, np.inf)
    dists = dists.astype(np.float32)
    d_min, delta, ew = _codebooks(dists, k=min(n // 2, 400), m=m)
    want_b, want_h = jref.bucket_hist_batch(
        jnp.asarray(dists), jnp.asarray(valid), jnp.asarray(d_min),
        jnp.asarray(delta), jnp.asarray(ew), m)
    got_b, got_h = ops.bucket_hist_batch(_t(dists), _t(valid), _t(d_min),
                                         _t(delta), _t(ew), m)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))


DEGENERATE = ["inf_lanes", "nan_lanes", "delta0", "dmin_inf"]


def _degenerate_inputs(rng, b, n, case):
    """Inputs of #4 that its +inf shortcut must keep: (B, n) distances,
    +inf off the valid lanes and on a few valid ones, codebooks from the
    JAX build; then the last query gets the ``case``: NaN lanes, a delta of
    0 (with d_min one of its own distances, so 0 / 0 occurs too) or a
    d_min of +inf (so +inf - d_min is NaN)."""
    m = 64
    valid = rng.random((b, n)) < 0.7
    dists = np.where(valid, rng.random((b, n)) * 10 + 1, np.inf)
    dists[valid & (rng.random((b, n)) < 0.05)] = np.inf
    dists = dists.astype(np.float32)
    d_min, delta, ew = _codebooks(np.where(np.isfinite(dists), dists,
                                           np.inf), k=min(n // 2, 400), m=m)
    q = b - 1
    if case == "nan_lanes":
        dists[q, rng.random(n) < 0.1] = np.nan
    elif case == "delta0":
        delta[q] = 0.0
        d_min[q] = dists[q][np.isfinite(dists[q])][0]
    elif case == "dmin_inf":
        d_min[q] = np.inf
    return dists, valid, d_min, delta, ew, m


@pytest.mark.parametrize("n", [1000, 1003])
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("case", DEGENERATE)
def test_bucket_hist_batch_degenerate_mirror(rng, case, b, n):
    """The plain #4 equals the JAX oracle on +inf and NaN lanes and on the
    degenerate codebooks (delta 0, d_min +inf): where the kernel sends a
    +inf lane straight to bucket m, and where it must not."""
    dists, valid, d_min, delta, ew, m = _degenerate_inputs(rng, b, n, case)
    want_b, want_h = jref.bucket_hist_batch(
        jnp.asarray(dists), jnp.asarray(valid), jnp.asarray(d_min),
        jnp.asarray(delta), jnp.asarray(ew), m)
    got_b, got_h = ops.bucket_hist_batch(_t(dists), _t(valid), _t(d_min),
                                         _t(delta), _t(ew), m)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 1003])
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("case", DEGENERATE)
def test_cuda_bucket_hist_degenerate(rng, cuda, case, b, n):
    """#4 (and at B = 1 #12, through ``ops.bucket_hist``) on the card equal
    to its plain version on the degenerate inputs, and to the plain
    version run on the CPU."""
    args = _degenerate_inputs(rng, b, n, case)
    cpu = [_t(a) for a in args[:5]]
    gpu = [a.to(cuda) for a in cpu]
    m = args[5]
    ops.reset_launches()
    got = ops.bucket_hist_batch(*gpu, m)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["bucket_hist" if b == 1 else "bucket_hist_batch"] == 1
    want = ref.bucket_hist_batch(*gpu, m)
    want_cpu = ref.bucket_hist_batch(*cpu, m)
    for x, y, z in zip(got, want, want_cpu):
        assert torch.equal(x, y) and torch.equal(x.cpu(), z)
    if b == 1:
        single = ops.bucket_hist(gpu[0][0], gpu[1][0], gpu[2], gpu[3],
                                 gpu[4][0], m)
        for x, y in zip(single, want):
            assert torch.equal(x, y[0])


@pytest.mark.parametrize("b,n,d,m_sub", [(4, 512, 64, 16), (8, 768, 96, 24),
                                         (3, 512, 128, 32),
                                         (3, 1000, 100, 33)])
def test_fused_scan_batch_mirror(rng, b, n, d, m_sub):
    m = 64
    codes = rng.integers(0, 16, (n, m_sub)).astype(np.uint8)
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((b, d)).astype(np.float32)
    valid = rng.random((b, n)) < 0.95
    luts = (rng.random((b, m_sub, 16)) * 2).astype(np.float32)
    est_rows = np.where(valid, np.sqrt(np.asarray(jref.pq_adc_batch(
        jnp.asarray(codes), jnp.asarray(luts)))), np.inf)
    d_min, delta, ew = _codebooks(est_rows, k=n // 2, m=m)
    tau = rng.integers(0, m, b).astype(np.int32)
    args = (codes, vectors, valid, luts, qs, d_min, delta, ew)
    want = jref.fused_scan_batch(*(jnp.asarray(a) for a in args), m,
                                 jnp.asarray(tau))
    got = ops.fused_scan_batch(*(_t(a) for a in args), m, _t(tau))
    w_est, w_bucket, w_hist, w_early, w_nmiss = (np.asarray(x) for x in want)
    est, bucket, hist, early, nmiss = (x.numpy() for x in got)

    np.testing.assert_allclose(est, w_est, rtol=1e-5, atol=1e-5)
    # bucketizing the JAX estimate gives the JAX integers exactly
    jb, jh = ref.bucket_hist_batch(_t(w_est), _t(valid), _t(d_min), _t(delta),
                                   _t(ew), m)
    np.testing.assert_array_equal(jb.numpy(), w_bucket)
    np.testing.assert_array_equal(jh.numpy(), w_hist)
    # and the mirror's own integers are those of its own estimate
    ob, oh = ref.bucket_hist_batch(_t(est), _t(valid), _t(d_min), _t(delta),
                                   _t(ew), m)
    np.testing.assert_array_equal(bucket, ob.numpy())
    np.testing.assert_array_equal(hist, oh.numpy())
    pred = valid & (bucket <= tau[:, None])
    np.testing.assert_array_equal(np.isfinite(early), pred)
    np.testing.assert_array_equal(nmiss, (valid & ~pred).sum(1))
    same = bucket == w_bucket
    np.testing.assert_array_equal(np.isfinite(early)[same],
                                  np.isfinite(w_early)[same])
    both = np.isfinite(early) & np.isfinite(w_early)
    np.testing.assert_allclose(early[both], w_early[both], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("b,n,d", [(4, 512, 64), (9, 999, 96), (1, 256, 128)])
def test_l2_exact_batch_mirror(rng, b, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((b, d)).astype(np.float32)
    want = np.asarray(jref.l2_exact_batch(jnp.asarray(x), jnp.asarray(qs)))
    got = ops.l2_exact_batch(_t(x), _t(qs)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_cpu_calls_count_no_launches(rng):
    ops.reset_launches()
    codes = _t(rng.integers(0, 16, (64, 8)).astype(np.uint8))
    luts = _t(rng.random((2, 8, 16)).astype(np.float32))
    ops.pq_adc_batch(codes, luts)
    ops.l2_exact_batch(torch.ones(64, 4), torch.ones(2, 4))
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="mixed or unsupported devices"):
        ops.l2_exact_batch(torch.ones(8, 4), torch.ones(2, 4, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,m_sub", [(32, 20000, 128, 32),
                                         (3, 1000, 100, 33)])
def test_cuda_kernels_match_plain(rng, cuda, b, n, d, m_sub):
    """Each CUDA kernel against its plain version on the same card tensors:
    estimates and exact distances bit-identical, integer outputs equal to
    the plain version run on the kernel's estimate; each of the four
    kernels launched once."""
    m = 64
    codes = _t(rng.integers(0, 16, (n, m_sub)).astype(np.uint8)).to(cuda)
    vectors = _t(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    qs = _t(rng.standard_normal((b, d)).astype(np.float32)).to(cuda)
    valid = _t(rng.random((b, n)) < 0.5).to(cuda)
    luts = _t((rng.random((b, m_sub, 16)) * 2).astype(np.float32)).to(cuda)
    from repro_torch.core import buffer as rb
    est0 = torch.where(valid, torch.sqrt(ref.pq_adc_batch(codes, luts)),
                       float("inf"))
    cb = rb.build_codebook(est0, k=n // 4, m=m)
    tau = _t(rng.integers(0, m, b).astype(np.int32)).to(cuda)
    ops.reset_launches()
    est, bucket, hist, early, nmiss = ops.fused_scan_batch(
        codes, vectors, valid, luts, qs, cb.d_min, cb.delta, cb.ew_map, m,
        tau)
    adc = ops.pq_adc_batch(codes, luts)
    l2 = ops.l2_exact_batch(vectors, qs)
    bkt, h = ops.bucket_hist_batch(est, valid, cb.d_min, cb.delta, cb.ew_map,
                                   m)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "fused_scan_batch": 1, "pq_adc_batch": 1, "l2_exact_batch": 1,
        "bucket_hist_batch": 1}
    assert torch.equal(est, est0)
    assert torch.equal(adc, ref.pq_adc_batch(codes, luts))
    plain_l2 = ref.l2_exact_batch(vectors, qs)
    assert torch.equal(l2, plain_l2)
    rb_, rh = ref.bucket_hist_batch(est, valid, cb.d_min, cb.delta,
                                    cb.ew_map, m)
    assert torch.equal(bucket, rb_) and torch.equal(bkt, rb_)
    assert torch.equal(hist, rh) and torch.equal(h, rh)
    pred = valid & (rb_ <= tau[:, None])
    assert torch.equal(torch.isfinite(early), pred)
    assert torch.equal(nmiss, (valid & ~pred).sum(1).to(torch.int32))
    torch.testing.assert_close(early[pred], plain_l2[pred], rtol=1e-4,
                               atol=1e-4)


# --------------------------------------------------------------------------
# launch plans of the exact-distance (#3, #11) and ADC (#2, #10) kernels
# --------------------------------------------------------------------------

PLAN_BS = [1, 2, 32, 33, 256]
PLAN_DS = [4, 100, 128, 960]
PLAN_MKS = [(24, 16), (32, 16), (33, 16), (24, 256), (32, 256), (128, 256)]
PLAN_NS = [1, 1000, 20_001, 1_000_064]


def _covers(b, qt, per_tile):
    """Every query in [0, b) once: query tiles at multiples of qt, each
    tile's ``per_tile`` queries (the threads' queries, padding included)."""
    seen = [q0 + q for q0 in range(0, b, qt) for q in per_tile if q0 + q < b]
    return sorted(seen) == list(range(b))


@pytest.mark.parametrize("b", PLAN_BS)
def test_l2_plan(b):
    for d in PLAN_DS + [60_000]:   # 60,000: past the old B=1 kernel's reach
        for n in PLAN_NS:
            p = ops._l2_plan(b, n, d)
            assert p.smem <= ops.MAX_SMEM
            assert p.tn in (1, 2, 4) and p.qt == 8 * p.tn
            # the narrowest tile that holds B, up to 32 queries; B = 1 takes
            # the 8-query tile
            assert p.qt == min(32, max(8, 1 << (b - 1).bit_length()))
            # threads hold queries warp + 8j, j < TN: the tile's qt queries
            assert _covers(b, p.qt, [w + 8 * j for w in range(8)
                                     for j in range(p.tn)])
            assert p.grid * ops.L2_ROWS >= n > (p.grid - 1) * ops.L2_ROWS
            assert p.smem == ops.L2_STAGES * (ops.L2_ROWS + p.qt) \
                * ops.L2_LD * 4


@pytest.mark.parametrize("b", PLAN_BS)
def test_adc_plan(b):
    for m_sub, k_codes in PLAN_MKS:
        for n in PLAN_NS:
            p = ops._adc_plan(b, n, m_sub, k_codes)
            per_q = 4 * m_sub * k_codes
            assert p.smem <= ops.MAX_SMEM
            assert p.tn in (1, 2, 4, 8) and p.qt % p.tn == 0
            assert p.qt * per_q <= max(ops.ADC_LUT_BUDGET, per_q)
            assert _covers(b, p.qt, range(p.qt))
            lut = 4 * (-(-p.qt * m_sub * k_codes // 4) * 4)
            ring = ops.ADC_STAGES * ops.ADC_ROWS * m_sub
            assert p.staged and p.smem == lut + ring
            # persistent blocks: no more than the row tiles, and at most as
            # many as fit on the SMs at this shared memory
            n_tiles = -(-n // ops.ADC_ROWS)
            assert 1 <= p.grid <= n_tiles
            assert p.grid == n_tiles or p.grid % ops.SMS == 0
            assert p.grid <= ops.SMS * ops.ADC_BLOCKS_PER_SM
            assert (p.grid // ops.SMS) * (p.smem + 1024) \
                <= ops.SMEM_PER_SM or p.grid == n_tiles
            if b == 1:       # one query a tile
                assert (p.tn, p.qt) == (1, 1)
            if (m_sub, k_codes) == (32, 16) and b <= 32:
                assert p.qt >= b      # the paths' B=32 LUTs in one tile


@pytest.mark.parametrize("m_sub,k_codes,staged", [
    (200, 256, False), (227, 256, False), (100, 256, True), (3000, 16, False)])
def test_adc_plan_takes_every_lut_that_fits(m_sub, k_codes, staged):
    """Any shape whose one-query LUT (4*M*K bytes) fits a block's shared
    memory, as the earlier kernel required, plans without raising; where
    the code ring does not fit beside it, the codes are read from device
    memory."""
    assert 4 * m_sub * k_codes <= ops.MAX_SMEM
    for b in PLAN_BS:
        p = ops._adc_plan(b, 5000, m_sub, k_codes)
        assert p.staged == staged and p.smem <= ops.MAX_SMEM
        assert p.qt == 1 or staged


def test_adc_plan_refuses_a_lut_past_shared_memory():
    for b in (1, 32):
        with pytest.raises(ValueError, match="shared memory"):
            ops._adc_plan(b, 1000, 228, 256)


L2_EDGES = [(b, n, d) for b in (2, 33, 64) for n in (1000, 20_001)
            for d in (96, 100, 960)]
ADC_EDGES = [(b, n, m, k) for b in (2, 33, 64) for n in (1000, 20_001)
             for m, k in ((24, 16), (33, 16), (32, 256))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", L2_EDGES)
def test_cuda_l2_tiles_bitwise(rng, cuda, b, n, d):
    """The tiled l2 kernel across query tiles, ragged row tiles and
    coordinate chunks, equal to its plain version bit for bit."""
    x = _t(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    qs = _t(rng.standard_normal((b, d)).astype(np.float32)).to(cuda)
    ops.reset_launches()
    got = ops.l2_exact_batch(x, qs)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["l2_exact_batch"] == 1
    assert torch.equal(got, ref.l2_exact_batch(x, qs))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m_sub,k_codes", ADC_EDGES)
def test_cuda_adc_tiles_bitwise(rng, cuda, b, n, m_sub, k_codes):
    """The tiled ADC kernel across query tiles and ragged row tiles, at the
    specialised M=24 and the runtime-stride M=33 and K=256, equal to its
    plain version bit for bit."""
    codes = _t(rng.integers(0, k_codes, (n, m_sub)).astype(np.uint8)).to(cuda)
    luts = _t((rng.random((b, m_sub, k_codes)) * 2).astype(
        np.float32)).to(cuda)
    ops.reset_launches()
    got = ops.pq_adc_batch(codes, luts)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["pq_adc_batch"] == 1
    assert torch.equal(got, ref.pq_adc_batch(codes, luts))


# --------------------------------------------------------------------------
# launch plans of the bucketize-histogram (#4, #12) and RaBitQ estimator
# (#8) kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 2, 32, 33])
@pytest.mark.parametrize("n", [1, 2047, 2048, 262_144, 1_000_064])
def test_hist_plan_covers_every_item_once(b, n):
    """The runs of ``per`` consecutive (query, chunk) items tile the B *
    chunks items exactly, the chunks cover the row, at most
    ``BH_BLOCKS_PER_SM`` blocks an SM, and the blocks that meet a query
    (the kernel's ``blocks_of``) are the ones whose runs hold its items."""
    p = ops._hist_plan(b, n, ops.SMS)
    total = b * p.chunks
    assert (p.chunks - 1) * ops.BH_CHUNK < n <= p.chunks * ops.BH_CHUNK
    assert (p.grid - 1) * p.per < total <= p.grid * p.per
    assert p.grid <= ops.SMS * ops.BH_BLOCKS_PER_SM
    owners = [it // p.per for it in range(total)]
    for q in range(b):
        first = q * p.chunks // p.per
        last = ((q + 1) * p.chunks - 1) // p.per
        assert set(owners[q * p.chunks:(q + 1) * p.chunks]) == set(
            range(first, last + 1))


def _est_smem(d, lanes):
    """rabitq_est.cu's layout: each warp's v, then its 32 rows of an odd
    count of 16-byte words."""
    s = (d + 15) // 16 * 16
    row = s if (s // 16) % 2 else s + 16
    return lanes // 32 * ((4 * d + 15) // 16 * 16 + 32 * row)


@pytest.mark.parametrize("d,lanes", [(64, 128), (100, 128), (128, 128),
                                     (960, 128), (1536, 128), (2048, 64),
                                     (4096, 32)])
def test_est_lanes_fit_shared_memory(d, lanes):
    assert ops._est_lanes(d, _est_smem) == (lanes, _est_smem(d, lanes))
    assert _est_smem(d, lanes) <= ops.MAX_SMEM


def test_est_lanes_refuse_rows_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        ops._est_lanes(8192, _est_smem)

