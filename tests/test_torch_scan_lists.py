"""The batched fused PQ scan over each query's probed lists
(``fused_scan_kernel``, ``ops._batch_scan_plan`` with lists).

On the CPU: the launch plan at the whole-LUT cells' shapes and its bounds;
``scan.pairs_passed`` as the pairs the scan walks (the lists' lanes, or
B x n over every lane); and the contract that the (B, n) outputs matter
only on the lane mask: the fused searcher, static and predictive, with and
without tombstones, returns the same ids, distances and counters when the
scan's outputs are poisoned off the mask.  On a card: the kernel over
lists at the 128-d and d960 4-bit cells' widths, bitwise its plain version
on every walked lane, and its walked-pair count.

No JAX here: ``tests/test_torch_search.py`` holds the searchers against the
JAX package."""
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import profiler as ap  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.core import buffer as rb  # noqa: E402
from repro_torch.index import engine, ivf, search  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)

N_EW, M_BUCKETS = 256, 128           # every cell's codebook map and buckets


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.clear()
    yield
    spans.clear()


# --------------------------------------------------------------------------
# the plan (CPU)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,n,m_sub,d,cap", [
    (32, 1_000_064, 32, 128, 4096),        # clustered1m-pq.batch32
    (32, 1_000_064, 240, 960, 4096),       # clustered1m-d960-pq.batch32
    (32, 10_000_000, 24, 96, 6144)])       # deep10m-pq.batch32
def test_list_plan_at_the_whole_lut_cells(b, n, m_sub, d, cap):
    """One query a block, its whole 4-bit LUT and its 64 lists' sizes and
    starts in shared memory; the waves of blocks an SM split over the
    queries (33 blocks a query at B = 32), which is fewer than the tiles
    of P x cap lanes, so every block walks several tiles."""
    p = ops._batch_scan_plan(b, n, m_sub, 16, d, N_EW, M_BUCKETS, ops.SMS,
                             64, cap)
    smem = ops._batch_smem(m_sub, 16, d, N_EW, M_BUCKETS, 64)
    per_sm = min(ops.FS_LIST_BLOCKS_PER_SM, ops.SMEM_PER_SM // (smem + 1024))
    assert per_sm == ops.FS_LIST_BLOCKS_PER_SM
    blocks = -(-ops.SMS * per_sm * ops.FS_LIST_WAVES // b)
    assert p == ops.ScanPlan(False, m_sub, blocks, smem) and blocks == 33
    assert 64 * cap > 4 * blocks * ops.LANE_TILE
    assert b * blocks >= ops.SMS * per_sm * ops.FS_LIST_WAVES


def test_list_plan_is_bounded_by_the_lists_and_the_lanes():
    """No more blocks a query than the tiles of P x cap lanes, or of n
    (lists over every lane, or no cap); one query takes the whole waves."""
    args = (32, 16, 128, N_EW, M_BUCKETS, ops.SMS)
    plan = ops._batch_scan_plan
    assert plan(32, 1_000_064, *args, 2, 256).blocks == 2
    assert plan(32, 300, *args, 8, 4096).blocks == 2
    assert plan(32, 300, *args).blocks == 2
    assert plan(1, 1_000_064, *args, 64, 8192).blocks == (
        ops.SMS * ops.FS_LIST_BLOCKS_PER_SM * ops.FS_LIST_WAVES)
    assert plan(32, 1_000_064, *args).blocks == 33


def test_list_plan_grid_and_index_limits():
    """The queries are the grid's second axis; a walk's lane indices (up to
    n, plus one grid stride of tiles) stay inside int32; where the LUT and
    the lists outgrow a block, the chunked kernel over every lane."""
    args = (32, 16, 128, N_EW, M_BUCKETS, ops.SMS, 64, 4096)
    with pytest.raises(ValueError):
        ops._batch_scan_plan(ops.GRID_Y + 1, 1_000_064, *args)
    with pytest.raises(ValueError):
        ops._batch_scan_plan(32, 2 ** 31 - 1000, *args)
    assert not ops._batch_scan_plan(ops.GRID_Y, 1_000_064, *args).chunked
    p = ops._batch_scan_plan(32, 1_000_064, 240, 256, 960, N_EW, M_BUCKETS,
                             ops.SMS, 64, 4096)
    assert p.chunked and p.mc == 128
    assert ops._batch_scan_plan(32, 1_000_064, 221, 256, 960, N_EW,
                                M_BUCKETS, ops.SMS, 1000, 4096).chunked


# --------------------------------------------------------------------------
# the pairs walked (CPU)
# --------------------------------------------------------------------------

def _lists(b, n_clusters, n_probe, dev="cpu", seed=5, pad=20):
    """A layout of ``n_clusters`` lists of random sizes (some empty) and
    ``pad`` padding lanes, B queries' distinct probed lists, and the lane
    mask: the probed lists' lanes, with holes."""
    g = torch.Generator().manual_seed(seed)
    sizes = torch.randint(0, 40, (n_clusters,), generator=g)
    sizes[::5] = 0
    offsets = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
    n = int(offsets[-1]) + pad
    cluster_of = torch.cat([torch.repeat_interleave(
        torch.arange(n_clusters), sizes),
        torch.full((pad,), n_clusters)])
    probed = torch.rand(b, n_clusters, generator=g).argsort(1)[:, :n_probe]
    layout = ivf.FlatLayout(order=torch.arange(n), cluster_of=cluster_of,
                            offsets=offsets,
                            valid=cluster_of < n_clusters)
    walked = ivf.probe_mask(layout, probed, n_clusters)
    valid = walked & (torch.rand(b, n, generator=g) > 0.3)
    return (offsets.to(dev), probed.to(dev), walked.to(dev), valid.to(dev),
            int(sizes.max()))


def _scan_args(valid, m_sub=8, k_codes=16, d=12, m=16, seed=4):
    g = torch.Generator().manual_seed(seed)
    b, n = valid.shape
    dev = valid.device
    return dict(
        codes=torch.randint(0, k_codes, (n, m_sub), generator=g,
                            dtype=torch.uint8).to(dev),
        vectors=torch.randn(n, d, generator=g).to(dev), valid=valid,
        luts=torch.rand(b, m_sub, k_codes, generator=g).to(dev),
        qs=torch.randn(b, d, generator=g).to(dev),
        d_min=torch.zeros(b, device=dev),
        delta=torch.full((b,), 0.5, device=dev),
        ew_maps=torch.randint(0, m, (b, 256), generator=g,
                              dtype=torch.int32).sort(1).values.to(dev),
        m=m, tau_pred=torch.full((b,), m // 2, dtype=torch.int32,
                                 device=dev))


def _counted(fn):
    with ap.profile(use_kineto=True):
        with spans.span("scan"):
            out = fn()
    got = {}
    for c in spans.counters():
        got[c.name] = got.get(c.name, 0) + c.value
    return out, got


@pytest.mark.parametrize("mode", ["dense", "lists"])
def test_scan_pairs_passed_counts_the_walked_pairs(mode):
    """``scan.pairs_passed`` is the lanes of each query's lists summed over
    the queries (lists given), or B x n (every lane one list);
    ``scan.pairs_probed`` the lane mask's bits either way."""
    offsets, probed, walked, valid, cap = _lists(3, 12, 4)
    kw = _scan_args(valid)
    if mode == "lists":
        kw.update(probed=probed, offsets=offsets, cap=cap)
    _, got = _counted(lambda: ops.fused_scan_batch(**kw))
    sizes = (offsets[1:] - offsets[:-1])[probed].sum()
    assert got["scan.pairs_passed"] == (
        int(sizes) if mode == "lists" else valid.numel())
    assert int(sizes) == int(walked.sum()) < valid.numel()
    assert got["scan.pairs_probed"] == int(valid.sum())


def test_lists_come_with_their_offsets():
    offsets, probed, _, valid, _ = _lists(3, 12, 4)
    with pytest.raises(ValueError):
        ops.fused_scan_batch(**_scan_args(valid), probed=probed)


# --------------------------------------------------------------------------
# no consumer reads a lane off the mask (CPU)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pq_engine():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6000, 32, generator=g)
    qs = x[:8] + 0.01 * torch.randn(8, 32, generator=g)
    ix = search.build_pq_index(x, 32, n_sub=8, n_bits=4, n_iter=4,
                               device="cpu")
    eng = engine.SearchEngine.build(ix, k=100, n_probe=8, n_cand=800,
                                    fused=True, device="cpu", tuned=None)
    return eng, qs


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("path", ["static", "predictive"])
def test_no_consumer_reads_a_lane_off_the_mask(pq_engine, monkeypatch,
                                               path, live):
    """The fused searcher's scan poisoned off its lane mask (est and early
    NaN, bucket 0, which every threshold admits) returns the same ids,
    distances, ``n_reranked`` and ``n_second_pass``: the collector, the
    selection and the second pass read the (B, n) outputs only where the
    mask is set.  The searcher passes each query's lists, and they hold
    every lane the mask sets."""
    eng, qs = pq_engine
    assert eng.fused
    if live:
        g = torch.Generator().manual_seed(3)
        eng = eng.with_live(torch.rand(6000, generator=g) > 0.3)

    def call():
        if path == "static":
            return eng.search(qs)
        return eng.search(qs, pred_state=eng.predictor_init())[0]

    want = call()
    real = ops.fused_scan_batch
    seen = []

    def poisoned(codes, vectors, valid, luts, qs, d_min, delta, ew_maps, m,
                 tau_pred, probed=None, offsets=None, cap=None):
        est, bucket, hist, early, nmiss = real(
            codes, vectors, valid, luts, qs, d_min, delta, ew_maps, m,
            tau_pred, probed, offsets, cap)
        lanes = torch.arange(valid.shape[1])
        start, end = offsets[probed], offsets[probed + 1]
        in_lists = ((lanes >= start[..., None])
                    & (lanes < end[..., None])).any(1)
        seen.append((int(valid.sum()), int((valid & ~in_lists).sum()),
                     int((~valid).sum())))
        nan = torch.tensor(float("nan"))
        return (torch.where(valid, est, nan),
                torch.where(valid, bucket, 0), hist,
                torch.where(valid, early, nan), nmiss)

    monkeypatch.setattr(ops, "fused_scan_batch", poisoned)
    got = call()
    assert len(seen) == 1
    n_valid, outside, poisoned_lanes = seen[0]
    assert n_valid > 0 and outside == 0 and poisoned_lanes > 0
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.dists, want.dists)
    assert torch.equal(got.n_reranked, want.n_reranked)
    assert torch.equal(got.n_second_pass, want.n_second_pass)


# --------------------------------------------------------------------------
# the kernel over lists (card)
# --------------------------------------------------------------------------

def _same_on(got, want, walked):
    """est, bucket and early equal on the walked lanes (NaN where NaN),
    hist and nmiss whole."""
    est, bucket, hist, early, nmiss = got
    w_est, w_bucket, w_hist, w_early, w_nmiss = want
    for a, b in ((est, w_est), (early, w_early)):
        a, b = a[walked], b[walked]
        na, nb = torch.isnan(a), torch.isnan(b)
        if not (torch.equal(na, nb) and torch.equal(a[~na], b[~nb])):
            return False
    return (torch.equal(bucket[walked], w_bucket[walked])
            and torch.equal(hist, w_hist) and torch.equal(nmiss, w_nmiss))


@pytest.mark.cuda
@pytest.mark.parametrize("m_sub,d", [(32, 128), (240, 960)])
def test_cuda_list_scan_at_the_cells_widths(cuda, m_sub, d):
    """The 128-d and d960 4-bit cells' widths (B = 32, K = 16, 64 of 1,024
    lists probed a query, lists of random sizes, lanes with holes, about
    12,500 predicted a query): one launch of ``fused_scan_kernel`` over the
    lists, bitwise the plain version on every walked lane, hist and nmiss
    whole, and the walk counted as the lists' lanes."""
    b, c, n_probe = 32, 1024, 64
    g = torch.Generator(device=cuda).manual_seed(m_sub)
    sizes = torch.randint(0, 1900, (c,), generator=g, device=cuda)
    offsets = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
    n = int(offsets[-1]) + 64
    cluster_of = torch.cat([torch.repeat_interleave(
        torch.arange(c, device=cuda), sizes),
        torch.full((64,), c, device=cuda)])
    layout = ivf.FlatLayout(order=torch.arange(n, device=cuda),
                            cluster_of=cluster_of, offsets=offsets,
                            valid=cluster_of < c)
    probed = torch.rand(b, c, generator=g, device=cuda).argsort(1)
    probed = probed[:, :n_probe]                  # a strided view
    walked = ivf.probe_mask(layout, probed, c)
    valid = walked & (torch.rand(b, n, generator=g, device=cuda) > 0.1)
    codes = torch.randint(0, 16, (n, m_sub), generator=g, device=cuda,
                          dtype=torch.uint8)
    vectors = torch.randn(n, d, generator=g, device=cuda)
    luts = torch.rand(b, m_sub, 16, generator=g, device=cuda) * 2
    qs = torch.randn(b, d, generator=g, device=cuda)
    est = torch.where(valid, torch.sqrt(ref.pq_adc_batch(codes, luts)),
                      float("inf"))
    cb = rb.build_codebook(est, k=40_000, m=M_BUCKETS)
    _, hist = ref.bucket_hist_batch(est, valid, cb.d_min, cb.delta,
                                    cb.ew_map, M_BUCKETS)
    tau = (torch.cumsum(hist, 1) < 12_500).sum(1).to(torch.int32)
    args = (codes, vectors, valid, luts, qs, cb.d_min, cb.delta, cb.ew_map,
            M_BUCKETS, tau)
    cap = int(sizes.max())
    want = ref.fused_scan_batch(*args)
    ops.reset_launches()
    got, counted = _counted(lambda: ops.fused_scan_batch(
        *args, probed, offsets, cap))
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "fused_scan_batch": 1}
    assert _same_on(got, want, walked)
    assert counted["scan.pairs_passed"] == int(walked.sum())
    assert counted["scan.pairs_probed"] == int(valid.sum())
    early = torch.isfinite(got[3][walked])
    assert bool(early.any()) and int(got[4].sum()) > 0
