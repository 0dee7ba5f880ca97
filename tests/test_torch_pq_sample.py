"""The codebook sample's ADC (``ops.pq_sample_adc_batch``, ``pq_adc.cu``'s
``pq_sample_adc_kernel``), the chunks of the second pass, and the IVF+PQ+BBC
searcher at GIST1M's width (d = 960, M = 240 sub-quantizers).

Bars: the sample's estimates and the chunked exact distances equal the loop
and the unchunked pass bitwise (same additions in the same order); on a card
the kernel equals its plain version bitwise; the search returns the exact
float64 top-k's id sets, with sorted distances within rtol=atol=2e-4 (the
batched searchers' bar, ``tests/test_search_batch.py``: the port sums in
float32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import numerics  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.index import ivf, search  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)
K_CODES = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _loop_sample_est(layout, probed, stream_codes, luts, st, cap):
    """The codebook sample as the searcher summed it before the kernel: a
    gather and an add per sub-quantizer over the (B, w, M) gathered codes."""
    spos, sok = ivf.tile_positions(layout, probed[:, :st], cap)
    sc = stream_codes[spos]
    acc = torch.gather(luts[:, 0, :], 1, sc[:, :, 0].long())
    for m in range(1, sc.shape[2]):
        acc = acc + torch.gather(luts[:, m, :], 1, sc[:, :, m].long())
    return torch.where(sok, numerics.sqrt_rn(torch.clamp(acc, min=0.0)),
                       float("inf"))


def _sample_inputs(rng, b, n, m_sub, w, pad_share=0.3, k_codes=K_CODES):
    """Codes, LUTs and per-query sample lanes with padded (not ok) lanes
    whose positions are 0, as ``tile_positions`` gives them."""
    codes = torch.from_numpy(
        rng.integers(0, k_codes, (n, m_sub)).astype(np.uint8))
    luts = torch.from_numpy(
        (rng.random((b, m_sub, k_codes)) * 2).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, n, (b, w)).astype(np.int64))
    ok = torch.from_numpy(rng.random((b, w)) >= pad_share)
    return codes, luts, torch.where(ok, pos, 0), ok


def _layout_inputs(rng, n_clusters, b, m_sub, n_probe):
    sizes = rng.integers(0, 300, n_clusters)
    sizes[0] = 0                                    # an empty cluster too
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n = int(offsets[-1])
    layout = ivf.FlatLayout(
        order=torch.arange(n), cluster_of=torch.zeros(n, dtype=torch.int64),
        offsets=torch.from_numpy(offsets), valid=torch.ones(n, dtype=bool))
    codes = torch.from_numpy(
        rng.integers(0, K_CODES, (n, m_sub)).astype(np.uint8))
    luts = torch.from_numpy(
        (rng.standard_normal((b, m_sub, K_CODES)) ** 2).astype(np.float32))
    probed = torch.from_numpy(np.stack([
        rng.permutation(n_clusters)[:n_probe] for _ in range(b)]))
    cap = -(-int(sizes.max()) // 128) * 128
    return layout, probed, codes, luts, cap


@pytest.mark.parametrize("m_sub", [4, 32, 240])
def test_sample_est_is_the_loop_bitwise(rng, m_sub):
    layout, probed, codes, luts, cap = _layout_inputs(rng, 40, 6, m_sub, 8)
    ops.reset_launches()
    got = search._sqrt_est(*search._pq_sample_adc(layout, probed, codes,
                                                  luts, 4, cap))
    want = _loop_sample_est(layout, probed, codes, luts, 4, cap)
    assert got.shape == (6, 4 * cap)
    assert torch.equal(got, want)
    assert torch.isinf(got).any() and torch.isfinite(got).any()
    assert set(ops.LAUNCHES.values()) == {0}      # the CPU launches nothing


@pytest.mark.parametrize("m_sub", [4, 32, 240])
def test_plain_sample_adc_is_inf_off_the_sample(rng, m_sub):
    codes, luts, pos, ok = _sample_inputs(rng, 5, 700, m_sub, 333)
    got = ref.pq_sample_adc_batch(codes, luts, pos, ok)
    full = ref.pq_adc_batch(codes, luts)            # every row, every query
    want = torch.where(ok, torch.gather(full, 1, pos), float("inf"))
    assert torch.equal(got, want)
    assert torch.equal(ops.pq_sample_adc_batch(codes, luts, pos, ok), got)


@pytest.mark.parametrize("w,m_sub,k_codes,staged", [
    (1, 16, 16, True), (1024, 240, 16, True), (1025, 32, 16, True),
    (20480, 240, 16, True), (300, 240, 256, False), (300, 226, 256, True)])
def test_sample_plan(w, m_sub, k_codes, staged):
    p = ops._sample_plan(w, m_sub, k_codes)
    assert (p.grid_x - 1) * ops.SAMPLE_LANES < w <= p.grid_x * ops.SAMPLE_LANES
    assert (p.smem > 0) == staged
    assert p.smem in (0, 4 * m_sub * k_codes) and p.smem <= ops.MAX_SMEM


@pytest.mark.cuda
@pytest.mark.parametrize("m_sub", [16, 32, 240])
@pytest.mark.parametrize("b", [1, 5, 32])
def test_cuda_sample_adc_bitwise(rng, cuda, b, m_sub):
    """The kernel against its plain version bitwise, with padded lanes and
    a ragged last block, in one launch a call; and at a code view that
    starts off a 16-byte boundary (byte-wise code reads)."""
    cpu = _sample_inputs(rng, b, 5000, m_sub, 2 * ops.SAMPLE_LANES + 77)
    want = ref.pq_sample_adc_batch(*cpu)
    gpu = [t.to(cuda) for t in cpu]
    ops.reset_launches()
    got = ops.pq_sample_adc_batch(*gpu)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "pq_sample_adc_batch": 1}
    assert torch.equal(got.cpu(), want)
    codes = cpu[0]
    flat = torch.cat([codes.new_zeros(1), codes.reshape(-1)]).to(cuda)
    shifted = flat[1:].view(codes.shape)             # one byte off alignment
    assert shifted.data_ptr() % 16 and torch.equal(shifted.cpu(), codes)
    got = ops.pq_sample_adc_batch(shifted, *gpu[1:])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_sample_adc_unstaged_luts(rng, cuda):
    """8-bit codes at M = 240: a query's LUT passes a block's shared
    memory, so the kernel reads it from device memory; the same bits."""
    cpu = _sample_inputs(rng, 3, 3000, 240, 700, k_codes=256)
    assert ops._sample_plan(700, 240, 256).smem == 0
    got = ops.pq_sample_adc_batch(*(t.to(cuda) for t in cpu))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.pq_sample_adc_batch(*cpu))


@pytest.mark.cuda
def test_cuda_sample_est_in_one_launch(rng, cuda):
    """``_pq_sample_adc`` on the card: one sample-ADC launch at M = 240 and
    the CPU's bits (squares and lanes)."""
    layout, probed, codes, luts, cap = _layout_inputs(rng, 40, 32, 240, 8)
    want, want_ok = search._pq_sample_adc(layout, probed, codes, luts, 4, cap)
    dev_layout = ivf.FlatLayout(*(t.to(cuda) for t in layout))
    ops.reset_launches()
    got, ok = search._pq_sample_adc(dev_layout, probed.to(cuda),
                                    codes.to(cuda), luts.to(cuda), 4, cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["pq_sample_adc_batch"] == 1
    assert torch.equal(got.cpu(), want) and torch.equal(ok.cpu(), want_ok)


# ---- the second pass's chunks ---------------------------------------------

@pytest.mark.parametrize("d", [128, 960])
def test_chunked_second_pass_is_one_pass_bitwise(rng, monkeypatch, d):
    n, b, w = 600, 4, 300
    vectors = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    qs = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, n, (b, w)).astype(np.int64))
    mask = (ids >= 0) & torch.from_numpy(rng.random((b, w)) < 0.7)
    monkeypatch.setattr(ref, "EXACT_CHUNK", 1 << 40)
    whole = search._exact_dists_rows(vectors, ids, qs, mask)
    # 97 entries a chunk: every chunk boundary falls inside a query's row
    monkeypatch.setattr(ref, "EXACT_CHUNK", 97)
    chunked = search._exact_dists_rows(vectors, ids, qs, mask)
    assert torch.equal(chunked, whole)
    assert torch.equal(torch.isfinite(whole), mask)


# ---- the searcher at GIST1M's width ---------------------------------------

@pytest.fixture(scope="module")
def gist_width():
    rng = np.random.default_rng(960)
    x = synthetic.clustered(rng, 3000, 960, n_centers=24)
    qs = synthetic.queries_from(rng, x, 4)
    index = search.build_pq_index(x, 16, n_sub=240, n_bits=4, n_iter=4,
                                  seed=5, device="cpu")
    return x, qs, index


def _exact_topk(x, qs, k):
    d2 = ((x[None, :, :].astype(np.float64)
           - qs[:, None, :].astype(np.float64)) ** 2).sum(-1)
    ids = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.sqrt(np.take_along_axis(d2, ids, 1)), ids


@pytest.mark.parametrize("fused", [True, False])
def test_pq_search_at_gist_width_is_exact(gist_width, fused):
    """IVF 16 + PQ 240 x 4 bits at d = 960, every cluster probed, k = 50
    out of 400 candidates: the exact float64 top-k's id sets."""
    x, qs, index = gist_width
    assert index.codes.shape == (3000, 240) and index.pq.centroids.shape[
        :2] == (240, 16)
    k = 50
    layout = ivf.flat_layout(index.ivf)
    res = search.ivf_pq_search_batch(
        index, search.build_stream(index, layout), torch.from_numpy(qs),
        layout, k=k, n_probe=16, n_cand=400, use_bbc=True, m=32,
        fused=fused)
    want_d, want_i = _exact_topk(x, qs, k)
    for b in range(qs.shape[0]):
        assert set(res.ids[b].tolist()) == set(want_i[b].tolist())
        np.testing.assert_allclose(np.sort(res.dists[b].numpy()), want_d[b],
                                   rtol=2e-4, atol=2e-4)
    assert (res.n_reranked >= k).all()
