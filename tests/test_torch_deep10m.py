"""The path of the deep-10M cell (10,000,000 x 96 under IVF4096 + PQ24x4 +
BBC, B = 32, k = 5000) at its shapes.  On the CPU: the launches its call
plans (the whole-LUT fused scan over each query's probed lists, the sample
ADC, the compaction) and the stream layout and lane mask at 4,096 lists.
On a card: the codebook sample's ADC on its byte path (M = 24 is no
multiple of 16) and the batched fused scan (``fused_scan_kernel``, over the
lists and over every lane) bitwise their plain versions at B = 32 over a
stream of 2M lanes in 4,096 clusters, 64 probed a query.

No JAX here: ``tests/test_torch_search.py`` holds the searcher at d = 96,
M = 24 against the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import buffer as rb  # noqa: E402
from repro_torch.index import ivf  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)

N_FLAT, D, M_SUB, K_CODES = 10_000_000, 96, 24, 16   # the cell's stream
B, C, N_PROBE, K = 32, 4096, 64, 5000
N_EW, M_BUCKETS = 256, 128
N_CAND = 8 * K
PRED = max(5 * K // 2, K + 1024)                      # the searcher's default


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# the plans (CPU)
# --------------------------------------------------------------------------

def test_the_cells_scan_is_the_whole_lut_kernel():
    """A query's 24 x 16 LUT and its 64 lists fit a block: the cell takes
    ``fused_scan_kernel``, one query a block, 33 blocks a query (two waves
    of four blocks on each of the 132 SMs, over 32 queries).  A block walks
    every 33rd 256-lane tile of its query's lists laid end to end, so the
    grid's tiles cover the P x cap lanes a query may hold (cap as the
    compaction test's widest); every index the kernel forms (virtual lane =
    tile x 256 + thread, up to one grid stride past the last; a stream
    lane below n; the list sizes' running sum) stays inside int32, and so
    do the batch's (query, lane) and (lane, coordinate) offsets."""
    cap = 6144
    p = ops._batch_scan_plan(B, N_FLAT, M_SUB, K_CODES, D, N_EW, M_BUCKETS,
                             ops.SMS, N_PROBE, cap)
    smem = ops._batch_smem(M_SUB, K_CODES, D, N_EW, M_BUCKETS, N_PROBE)
    assert p == ops.ScanPlan(False, M_SUB, 33, smem)
    assert smem <= ops.MAX_SMEM
    span = N_PROBE * cap
    tiles = -(-span // ops.LANE_TILE)
    per_block = -(-tiles // p.blocks)
    assert per_block == 47
    assert p.blocks * per_block * ops.LANE_TILE >= span
    assert (tiles + p.blocks) * ops.LANE_TILE < 2 ** 31
    assert N_FLAT + p.blocks * ops.LANE_TILE < 2 ** 31
    assert B * N_FLAT < 2 ** 31 and N_FLAT * D < 2 ** 31


@pytest.mark.parametrize("cap", [2560, 6144])
def test_the_cells_sample_and_compaction_plans(cap):
    """The sample ADC over a query's four nearest clusters stages its LUT
    (1.5 KB) and takes one block for each 1,024 lanes; the compaction over
    10M lanes into the (k + slack)-wide buffer takes one ticket for each
    4,096-lane chunk and 8,192 slots of each query, within int32."""
    w = 4 * cap
    p = ops._sample_plan(w, M_SUB, K_CODES)
    assert p.smem == 4 * M_SUB * K_CODES and p.grid_x == -(-w // 1024)
    budget = rb._collect_budget(N_CAND, N_FLAT, 2, M_BUCKETS)
    assert budget == N_CAND + 2 * (N_CAND // M_BUCKETS) + 64
    cp = ops._collect_plan(B, N_FLAT, budget)
    assert cp.n_chunks == -(-N_FLAT // ops.COLLECT_CHUNK) == 2442
    assert cp.grid == B * (2442 + -(-budget // ops.COLLECT_FILL))
    assert cp.words < 2 ** 31


def _ivf_index(sizes: np.ndarray) -> ivf.IVFIndex:
    """An ``IVFIndex`` whose clusters hold ``sizes`` members, ids dealt at
    random."""
    rng = np.random.default_rng(4096)
    assignment = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    ids, sz = ivf.pack_members(assignment, len(sizes))
    t = torch.from_numpy(ids)
    return ivf.IVFIndex(centroids=torch.zeros(len(sizes), 1), member_ids=t,
                        member_valid=t >= 0,
                        cluster_sizes=torch.from_numpy(sz))


def test_layout_and_lane_mask_at_4096_lists():
    """The stream at 4,096 lists, some empty, padded to 128 lanes: each
    cluster's members in ascending id order at its offset, and a query's
    lane mask true exactly on the lanes of its probed clusters."""
    rng = np.random.default_rng(96)
    sizes = rng.integers(0, 9, C)
    sizes[:3] = 0
    layout = ivf.flat_layout(_ivf_index(sizes))
    n = int(sizes.sum())
    assert layout.n_flat == -(-n // 128) * 128
    offsets = layout.offsets.numpy()
    assert np.array_equal(offsets, np.concatenate([[0], np.cumsum(sizes)]))
    order, owner = layout.order.numpy(), layout.cluster_of.numpy()
    assert sorted(order[:n].tolist()) == list(range(n))
    for c in (3, 1000, C - 1):
        seg = order[offsets[c]:offsets[c + 1]]
        assert np.array_equal(seg, np.sort(seg))
        assert (owner[offsets[c]:offsets[c + 1]] == c).all()
    assert (owner[n:] == C).all()
    probed = torch.from_numpy(np.stack([rng.permutation(C)[:N_PROBE]
                                        for _ in range(3)]))
    mask = ivf.probe_mask(layout, probed, C).numpy()
    want = np.stack([np.isin(owner, p) for p in probed.numpy()])
    assert np.array_equal(mask, want)
    assert mask.sum() == sizes[probed.numpy()].sum()


# --------------------------------------------------------------------------
# the kernels (card)
# --------------------------------------------------------------------------

def _stream(dev, seed=24):
    """A 4,096-cluster layout over about 2M lanes, its codes and rows, and
    each of the 32 queries' 64 distinct probed clusters."""
    g = torch.Generator(device=dev).manual_seed(seed)
    sizes = torch.randint(420, 601, (C,), generator=g, device=dev)
    offsets = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
    n = int(offsets[-1])
    layout = ivf.FlatLayout(
        order=torch.arange(n, device=dev),
        cluster_of=torch.repeat_interleave(torch.arange(C, device=dev),
                                           sizes),
        offsets=offsets, valid=torch.ones(n, dtype=torch.bool, device=dev))
    codes = torch.randint(0, K_CODES, (n, M_SUB), generator=g, device=dev,
                          dtype=torch.uint8)
    vectors = torch.randn(n, D, generator=g, device=dev)
    luts = torch.rand(B, M_SUB, K_CODES, generator=g, device=dev) * 2
    qs = torch.randn(B, D, generator=g, device=dev)
    probed = torch.rand(B, C, generator=g, device=dev).argsort(1)[:, :N_PROBE]
    cap = -(-int(sizes.max()) // 128) * 128
    return layout, codes, vectors, luts, qs, probed, cap


@pytest.mark.cuda
def test_cuda_sample_adc_byte_path_at_the_cells_shapes(cuda):
    """The codebook sample's ADC over each query's four nearest probed
    clusters of a 2M-lane stream at M = 24 (byte-wise code reads): one
    launch, bitwise its plain version."""
    layout, codes, _, luts, _, probed, cap = _stream(cuda)
    assert layout.n_flat >= 2_000_000 and M_SUB % 16
    pos, ok = ivf.tile_positions(layout, probed[:, :4], cap)
    want = ref.pq_sample_adc_batch(codes, luts, pos, ok)
    ops.reset_launches()
    got = ops.pq_sample_adc_batch(codes, luts, pos, ok)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "pq_sample_adc_batch": 1}
    assert torch.equal(got, want)
    # every query's clusters end in padding, and hold members
    assert bool(torch.isinf(got).any(1).all())
    assert bool(torch.isfinite(got).any(1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lists", "dense"])
def test_cuda_fused_scan_at_the_cells_shapes(cuda, mode):
    """The batched fused scan over a 2M-lane stream at the cell's widths
    (B = 32, M = 24, d = 96, 64 of 4,096 clusters probed, about 12,500 lanes
    predicted a query): one launch of ``fused_scan_kernel``, bitwise its
    plain version's: over each query's probed lists (the searcher's call)
    on every lane of its lists, with hist and nmiss whole; over every lane
    (no lists) on every output."""
    layout, codes, vectors, luts, qs, probed, cap = _stream(cuda, seed=96)
    valid = ivf.probe_mask(layout, probed, C)
    assert 0.01 < float(valid.float().mean()) < 0.02
    est = torch.where(valid, torch.sqrt(ref.pq_adc_batch(codes, luts)),
                      float("inf"))
    cb = rb.build_codebook(est, k=N_CAND, m=M_BUCKETS)
    _, hist = ref.bucket_hist_batch(est, valid, cb.d_min, cb.delta,
                                    cb.ew_map, M_BUCKETS)
    tau = (torch.cumsum(hist, 1) < PRED).sum(1).to(torch.int32)
    args = (codes, vectors, valid, luts, qs, cb.d_min, cb.delta, cb.ew_map,
            M_BUCKETS, tau)
    lists = (probed, layout.offsets, cap) if mode == "lists" else ()
    p = ops._batch_scan_plan(B, layout.n_flat, M_SUB, K_CODES, D, N_EW,
                             M_BUCKETS, ops._sms(cuda.index),
                             *((N_PROBE, cap) if lists else ()))
    assert not p.chunked
    want = ref.fused_scan_batch(*args)
    ops.reset_launches()
    got = ops.fused_scan_batch(*args, *lists)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "fused_scan_batch": 1}
    on = valid if lists else torch.ones_like(valid)   # the walked lanes
    for a, w in zip(got, want):
        assert torch.equal(a[on] if a.shape == on.shape else a,
                           w[on] if w.shape == on.shape else w)
    early = torch.isfinite(torch.where(on, got[3], float("inf"))).sum(1)
    assert bool((early > 0).all()) and int(got[4].sum()) > 0
