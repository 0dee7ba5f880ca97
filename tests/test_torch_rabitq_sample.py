"""The codebook sample's RaBitQ upper bounds (``ops.rabitq_sample_ub_batch``,
``rabitq_fused.cu``'s ``rabitq_sample_ub_kernel``) and the fused RaBitQ
searcher that computes the rotated queries and the query-centroid
distances once a call for the sample and the scan.

Bars: the plain version equals the composition the searcher ran before the
kernel bitwise (the same products, the same ``ordered_sum`` order, the same
bound arithmetic); on a card the kernel equals the plain version bitwise;
the fused searcher's ids, distances and counters equal those of the
composition with its terms computed apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import numerics  # noqa: E402
from repro_torch.core import rerank  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.index import ivf, rabitq, search  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)
INF = float("inf")
EPS0 = 3.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _composed_sample_ub(stream, layout, probed, qs, d2, st, cap, eps0):
    """The codebook sample as the searcher computed it before the kernel:
    the rotation and the routing norms from the queries, one gather of the
    sampled code rows in query chunks, ``ordered_sum``, the bounds."""
    spos, sok = ivf.tile_positions(layout, probed[:, :st], cap)
    b, w = spos.shape
    d = stream.codes.shape[1]
    g = numerics.rotate(qs, stream.rot)
    s1 = torch.empty(b, w, dtype=torch.float32, device=qs.device)
    step = max(1, numerics.CHUNK // max(w * d, 1))
    for i in range(0, b, step):
        c = stream.codes[spos[i:i + step]].to(torch.float32)
        s1[i:i + step] = numerics.ordered_sum(c * g[i:i + step, None, :])
    nq = torch.gather(numerics.sqrt_rn(d2), 1, stream.cl.long()[spos])
    _, _, ub = numerics.rabitq_bounds(s1, stream.s2[spos], nq,
                                      stream.norm_o[spos], stream.f_o[spos],
                                      d, eps0)
    return torch.where(sok, ub, INF), sok


def _stream_inputs(rng, d, b, n_clusters=24, n_probe=6, max_size=300):
    """A synthetic RaBitQ stream over clusters of ragged sizes (one empty,
    most shorter than ``cap``), with its layout, probe lists, queries and
    squared routing distances."""
    sizes = rng.integers(1, max_size, n_clusters)
    sizes[3] = 0                                    # an empty cluster
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n = int(offsets[-1])
    cl = np.repeat(np.arange(n_clusters), sizes).astype(np.int32)
    layout = ivf.FlatLayout(
        order=torch.arange(n), cluster_of=torch.from_numpy(cl).long(),
        offsets=torch.from_numpy(offsets), valid=torch.ones(n, dtype=bool))
    codes = torch.from_numpy(
        np.where(rng.random((n, d)) < 0.5, 1, -1).astype(np.int8))
    cent = torch.from_numpy(
        rng.standard_normal((n_clusters, d)).astype(np.float32))
    rot = rabitq.random_rotation(torch.Generator().manual_seed(d), d)
    stream = search.Stream(
        vectors=torch.zeros(n, d), centroids=cent, codes=codes, rot=rot,
        norm_o=torch.from_numpy(rng.random(n).astype(np.float32) + 0.5),
        f_o=torch.from_numpy(0.7 + 0.15 * rng.random(n).astype(np.float32)),
        cl=torch.from_numpy(cl),
        s2=numerics.rabitq_s2(codes, numerics.rotate(cent, rot),
                              torch.from_numpy(cl)))
    qs = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    diff = cent[None] - qs[:, None]
    d2 = numerics.ordered_sum(diff * diff)
    probed = torch.from_numpy(np.stack([
        rng.permutation(n_clusters)[:n_probe] for _ in range(b)]))
    probed[0, 0] = 3                                # the empty cluster
    cap = -(-int(sizes.max()) // 128) * 128
    return stream, layout, probed, qs, d2, cap


def _kernel_args(stream, layout, probed, qs, d2, st, cap):
    g, nq = search._rabitq_query_terms(stream, qs, d2)
    return (stream.codes, stream.s2, stream.norm_o, stream.f_o, stream.cl,
            layout.offsets, probed[:, :st], cap, g, nq)


# ---- the plain version, on the CPU -----------------------------------------

@pytest.mark.parametrize("d", [64, 100, 128, 960])
def test_plain_is_the_composition_bitwise(rng, d):
    stream, layout, probed, qs, d2, cap = _stream_inputs(rng, d, 5)
    want_ub, want_ok = _composed_sample_ub(stream, layout, probed, qs, d2,
                                           4, cap, EPS0)
    args = _kernel_args(stream, layout, probed, qs, d2, 4, cap)
    ub, ok = ref.rabitq_sample_ub_batch(*args, eps0=EPS0)
    assert ub.shape == (5, 4 * cap) and ub.dtype == torch.float32
    assert torch.equal(ub, want_ub) and torch.equal(ok, want_ok)
    ops.reset_launches()
    got = search._rabitq_sample_ub(stream, layout, probed, *args[8:], 4,
                                   cap, EPS0)
    assert torch.equal(got[0], ub) and torch.equal(got[1], ok)
    assert set(ops.LAUNCHES.values()) == {0}      # the CPU launches nothing


@pytest.mark.parametrize("n_probe,st", [(6, 4), (2, 2), (1, 1)])
def test_plain_is_inf_exactly_off_the_sample(rng, n_probe, st):
    """Clusters shorter than ``cap``, an empty cluster, and fewer probed
    clusters than ``SAMPLE_TILES``: +inf exactly off ``tile_positions``'
    lanes, finite on them."""
    stream, layout, probed, qs, d2, cap = _stream_inputs(rng, 64, 4,
                                                         n_probe=n_probe)
    assert st == min(search.SAMPLE_TILES, n_probe)
    args = _kernel_args(stream, layout, probed, qs, d2, st, cap)
    ub, ok = ops.rabitq_sample_ub_batch(*args, eps0=EPS0)
    _, sok = ivf.tile_positions(layout, probed[:, :st], cap)
    assert torch.equal(ok, sok)
    assert torch.equal(torch.isinf(ub), ~sok) and not torch.isnan(ub).any()
    assert not ok[0, :cap].any()                  # query 0's empty cluster
    assert ok[1:].any(1).all() and (~ok).any(1).all()


@pytest.mark.parametrize("w,d,threads", [
    (1, 1, 256), (16384, 128, 256), (16385, 100, 256), (5000, 960, 32),
    (700, 300, 64), (700, 600, 32)])
def test_sample_ub_plan(w, d, threads):
    p = ops._sample_ub_plan(w, d)
    assert p.threads == threads
    assert (p.grid_x - 1) * p.threads < w <= p.grid_x * p.threads
    assert p.stride % 2 == 1 and p.stride >= (d + 1) // 2
    assert p.smem == 4 * (d + p.threads * p.stride)
    assert p.smem <= ops.SAMPLE_UB_SMEM or p.threads == 32
    assert p.smem <= ops.MAX_SMEM


def test_sample_ub_plan_refuses_too_wide_rows():
    with pytest.raises(ValueError, match="shared memory"):
        ops._sample_ub_plan(100, 4000)


def test_mixed_devices_raise(rng):
    stream, layout, probed, qs, d2, cap = _stream_inputs(rng, 64, 2)
    args = list(_kernel_args(stream, layout, probed, qs, d2, 4, cap))
    args[8] = args[8].to("meta")
    with pytest.raises(ValueError, match="mixed or unsupported devices"):
        ops.rabitq_sample_ub_batch(*args, eps0=EPS0)


def _sharded_inputs(n_shards, rank):
    x = synthetic.clustered(np.random.default_rng(7), 6000, 64, n_centers=48)
    qs = synthetic.queries_from(np.random.default_rng(8), x, 6)
    index = search.build_rabitq_index(x, 24, n_iter=4, seed=2, device="cpu")
    slayout, cap_shard = ivf.sharded_layout(index.ivf, n_shards)
    layout = slayout.local(rank)
    stream = search.build_stream(index, layout)
    probed, _, d2 = search._routing(stream, layout, torch.from_numpy(qs), 8)
    return stream, layout, probed, torch.from_numpy(qs), d2, cap_shard


def test_plain_on_a_rank_block_is_the_composition():
    """A rank's block of the sharded layout (its own offsets and the
    longest shard segment as ``cap``): the plain version is the
    composition's bits."""
    stream, layout, probed, qs, d2, cap = _sharded_inputs(4, 1)
    want = _composed_sample_ub(stream, layout, probed, qs, d2, 4, cap, EPS0)
    g, nq = search._rabitq_query_terms(stream, qs, d2)
    got = search._rabitq_sample_ub(stream, layout, probed, g, nq, 4, cap,
                                   EPS0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---- the fused searcher: the terms once a call -----------------------------

@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(32)
    x = synthetic.clustered(rng, 8000, 64, n_centers=48)
    qs = synthetic.queries_from(rng, x, 12)
    index = search.build_rabitq_index(x, 32, n_iter=4, seed=3, device="cpu")
    layout = ivf.flat_layout(index.ivf)
    return index, layout, search.build_stream(index, layout), \
        torch.from_numpy(qs)


@pytest.mark.parametrize("predictive", [False, True])
def test_fused_search_with_shared_terms_is_the_composition(
        small_index, monkeypatch, predictive):
    """The fused searcher hands one rotation and one set of routing norms
    to the sample and the scan; with the sample composed as before and the
    scan's terms computed apart from the queries, the ids, distances and
    both counters are the same bits."""
    index, layout, stream, qs = small_index
    k, n_probe = 300, 10
    pred = rerank.predictor_init(128) if predictive else None

    def run():
        res = search.ivf_rabitq_search_batch(
            index, stream, qs, layout, k=k, n_probe=n_probe, use_bbc=True,
            pred_state=pred)
        return res[0] if predictive else res

    rotations = []
    rotate = numerics.rotate
    monkeypatch.setattr(numerics, "rotate",
                        lambda *a: rotations.append(1) or rotate(*a))
    shared = run()
    assert len(rotations) == 1                    # once a call
    monkeypatch.setattr(numerics, "rotate", rotate)

    probed, _, d2 = search._routing(index.ivf, layout, qs, n_probe)
    sample_ub, scan = ops.rabitq_sample_ub_batch, ops.fused_rabitq_scan_batch

    def composed_sample(*a, eps0):
        got = sample_ub(*a, eps0=eps0)
        want = _composed_sample_ub(stream, layout, probed, qs, d2,
                                   a[6].shape[1], a[7], eps0)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return want

    def apart_scan(codes, vectors, s2, norm_o, f_o, cl, g, qs_, nq, *rest,
                   eps0):
        return scan(codes, vectors, s2, norm_o, f_o, cl,
                    numerics.rotate(qs, stream.rot), qs_,
                    numerics.sqrt_rn(d2), *rest, eps0=eps0)

    monkeypatch.setattr(ops, "rabitq_sample_ub_batch", composed_sample)
    monkeypatch.setattr(ops, "fused_rabitq_scan_batch", apart_scan)
    apart = run()
    for name in search.SearchResult._fields:
        assert torch.equal(getattr(shared, name), getattr(apart, name)), name
    assert int(shared.n_reranked.min()) > 0


# ---- on a card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 100, 128, 960])
@pytest.mark.parametrize("b", [1, 5, 32])
def test_cuda_kernel_is_the_plain_version_bitwise(rng, cuda, b, d):
    """The kernel against its plain version, on the CPU and on the card
    tensors (the composition the searcher ran on the card before), bitwise,
    in one launch a call."""
    stream, layout, probed, qs, d2, cap = _stream_inputs(rng, d, b)
    args = _kernel_args(stream, layout, probed, qs, d2, 4, cap)
    want = ref.rabitq_sample_ub_batch(*args, eps0=EPS0)
    gpu = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
    ops.reset_launches()
    got = ops.rabitq_sample_ub_batch(*gpu, eps0=EPS0)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "rabitq_sample_ub_batch": 1}
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    on_card = ref.rabitq_sample_ub_batch(*gpu, eps0=EPS0)
    assert torch.equal(got[0], on_card[0]) and torch.equal(got[1], on_card[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 960])
def test_cuda_kernel_on_a_misaligned_code_row(rng, cuda, d):
    """A code view one byte off a 16-byte boundary: byte-wise reads, the
    same bits."""
    stream, layout, probed, qs, d2, cap = _stream_inputs(rng, d, 5)
    args = _kernel_args(stream, layout, probed, qs, d2, 4, cap)
    want = ref.rabitq_sample_ub_batch(*args, eps0=EPS0)
    gpu = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
    codes = args[0]
    flat = torch.cat([codes.new_zeros(1), codes.reshape(-1)]).to(cuda)
    shifted = flat[1:].view(codes.shape)
    assert shifted.data_ptr() % 16 and torch.equal(shifted.cpu(), codes)
    got = ops.rabitq_sample_ub_batch(shifted, *gpu[1:], eps0=EPS0)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_cuda_sharded_rank_block(cuda):
    """A rank's block of a 4-way sharded layout on the card: the kernel
    equals the plain version on the CPU."""
    stream, layout, probed, qs, d2, cap = _sharded_inputs(4, 2)
    g, nq = search._rabitq_query_terms(stream, qs, d2)
    want = search._rabitq_sample_ub(stream, layout, probed, g, nq, 4, cap,
                                    EPS0)
    s_dev = search.Stream(*(t.to(cuda) if torch.is_tensor(t) else t
                            for t in stream))
    l_dev = ivf.FlatLayout(*(t.to(cuda) for t in layout))
    ops.reset_launches()
    got = search._rabitq_sample_ub(s_dev, l_dev, probed.to(cuda),
                                   g.to(cuda), nq.to(cuda), 4, cap, EPS0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rabitq_sample_ub_batch"] == 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_cuda_fused_search_takes_one_sample_launch(small_index, cuda):
    """A fused RaBitQ call on the card launches the sample kernel once and
    returns the CPU's ids, distances and counters."""
    index, layout, stream, qs = small_index
    want = search.ivf_rabitq_search_batch(index, stream, qs, layout, k=300,
                                          n_probe=10, use_bbc=True)
    d_index = search.index_to(index, cuda)
    d_layout = ivf.FlatLayout(*(t.to(cuda) for t in layout))
    d_stream = search.build_stream(d_index, d_layout)
    ops.reset_launches()
    got = search.ivf_rabitq_search_batch(d_index, d_stream, qs.to(cuda),
                                         d_layout, k=300, n_probe=10,
                                         use_bbc=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rabitq_sample_ub_batch"] == 1
    assert ops.LAUNCHES["fused_rabitq_scan_batch"] == 1
    for name in search.SearchResult._fields:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
