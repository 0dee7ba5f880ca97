"""The routing's lane mask in one kernel (``ops.probe_mask_batch``,
``lane_mask.cu``'s ``probe_mask_kernel``).

Bars: on the CPU the wrapper gives ``ivf.probe_mask``'s bits (with the
tombstone mask ANDed in), and the invariant that lets it drop the
composition's ``& valid`` holds for every layout the port builds: a lane's
cluster is ``n_clusters`` exactly where the layout marks it padding.  The
launch plan keeps a group's bitset in shared memory up to the largest C a
block holds.  On a card the kernel equals ``ivf.probe_mask`` bitwise over
query counts around a group of 32, one to every cluster probed, bitsets in
shared and in device memory, duplicate probes, tombstones, ragged and
unaligned lanes, a sharded rank's block and 10M lanes; and the batched PQ
and RaBitQ searchers launch it once a call and return the plain mask's
ids, distances and counters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import synthetic  # noqa: E402
from repro_torch.index import ivf, search  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _layout(c: int, n: int, dev="cpu", seed: int = 0, tail: int = 128):
    """A ``FlatLayout`` of about ``n`` lanes in ``c`` clusters of random
    sizes (some empty), padded with cluster ``c`` to a multiple of
    ``tail`` lanes (``tail`` 0: five or six padding lanes, to a length no
    multiple of 16)."""
    g = torch.Generator().manual_seed(seed)
    sizes = torch.randint(0, max(2, 2 * n // c + 1), (c,), generator=g)
    live = int(sizes.sum())
    n_flat = live + 5 if tail == 0 else max(tail, -(-live // tail) * tail)
    if tail == 0 and n_flat % 16 == 0:
        n_flat += 1
    cluster_of = torch.full((n_flat,), c, dtype=torch.int64)
    cluster_of[:live] = torch.repeat_interleave(torch.arange(c), sizes)
    offsets = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
    return ivf.FlatLayout(order=torch.arange(n_flat).to(dev),
                          cluster_of=cluster_of.to(dev),
                          offsets=offsets.to(dev),
                          valid=(torch.arange(n_flat) < live).to(dev))


def _probed(b: int, c: int, p: int, dev="cpu", seed: int = 1,
            dupes: bool = False):
    """(B, p) distinct probed clusters a query (a strided view, as the
    routing's selection gives), or with ``dupes`` each query's first
    cluster repeated over half its list."""
    g = torch.Generator().manual_seed(seed)
    probed = torch.rand(b, c, generator=g).argsort(1)[:, :p]
    if dupes:
        probed = probed.clone()
        probed[:, p // 2:] = probed[:, :1]
    return probed.to(dev)


def _live(n: int, dev="cpu", seed: int = 2, dead: float = 0.1):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, generator=g) >= dead).to(dev)


def _plain(layout, probed, c, live=None):
    mask = ivf.probe_mask(layout, probed, c)
    return mask if live is None else mask & live[None, :]


# --------------------------------------------------------------------------
# the CPU: the plain version and the invariant
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,c,p", [(1, 16, 1), (5, 64, 8), (33, 64, 64),
                                   (3, 1024, 64)])
@pytest.mark.parametrize("with_live", [False, True])
@pytest.mark.parametrize("dupes", [False, True])
def test_wrapper_is_probe_mask_on_the_cpu(b, c, p, with_live, dupes):
    layout = _layout(c, 6000)
    probed = _probed(b, c, p, dupes=dupes)
    live = _live(layout.n_flat) if with_live else None
    ops.reset_launches()
    got = ops.probe_mask_batch(layout.cluster_of, probed, c, live)
    assert set(ops.LAUNCHES.values()) == {0}       # the CPU launches nothing
    assert got.dtype == torch.bool and got.shape == (b, layout.n_flat)
    assert torch.equal(got, _plain(layout, probed, c, live))
    assert torch.equal(ref.probe_mask_batch(layout.cluster_of, probed, c,
                                            live), got)


def test_routing_gives_probe_masks_and_tombstones(rng):
    x = synthetic.clustered(rng, 3000, 16, n_centers=12)
    index = search.build_pq_index(x, 24, n_iter=2, device="cpu")
    layout = ivf.flat_layout(index.ivf)
    qs = torch.from_numpy(synthetic.queries_from(rng, x, 5))
    live = _live(layout.n_flat)
    probed, lane_valid, _ = search._routing(index.ivf, layout, qs, 6, live)
    assert torch.equal(lane_valid, _plain(layout, probed, 24, live))


def test_empty_batches_and_streams():
    layout = _layout(64, 1000)
    got = ops.probe_mask_batch(layout.cluster_of,
                               torch.zeros(0, 4, dtype=torch.int64), 64)
    assert got.shape == (0, layout.n_flat)
    got = ops.probe_mask_batch(torch.zeros(0, dtype=torch.int64),
                               _probed(3, 64, 4), 64)
    assert got.shape == (3, 0)


def test_live_mask_of_the_wrong_width_or_type_raises():
    layout = _layout(64, 1000)
    probed = _probed(2, 64, 4)
    with pytest.raises(ValueError, match="live mask"):
        ops.probe_mask_batch(layout.cluster_of, probed, 64,
                             torch.ones(5, dtype=torch.bool))
    with pytest.raises(ValueError, match="live mask"):
        ops.probe_mask_batch(layout.cluster_of, probed, 64,
                             torch.ones(layout.n_flat, dtype=torch.uint8))


@pytest.fixture(scope="module")
def ivf_index():
    rng = np.random.default_rng(36)
    x = synthetic.clustered(rng, 5000, 16, n_centers=20)
    return search.build_pq_index(x, 40, n_iter=3, device="cpu").ivf


@pytest.mark.parametrize("shards", [0, 1, 2, 3, 4])
def test_padding_lanes_carry_the_unprobed_cluster(ivf_index, shards):
    """The invariant the kernel's dropped ``& valid`` rests on: a lane's
    cluster is ``n_clusters`` exactly where the layout says padding, in the
    flat layout (``shards`` 0) and on every rank of a sharded one."""
    c = ivf_index.n_clusters
    if shards == 0:
        blocks = [ivf.flat_layout(ivf_index)]
    else:
        sl, _ = ivf.sharded_layout(ivf_index, shards)
        blocks = [sl.local(j) for j in range(shards)]
    for lay in blocks:
        assert torch.equal(lay.cluster_of == c, ~lay.valid)
        assert int(lay.cluster_of.min()) >= 0
        assert int(lay.cluster_of.max()) <= c


# --------------------------------------------------------------------------
# the launch plan (CPU)
# --------------------------------------------------------------------------

def test_plan_at_the_cells_shapes():
    """Deep-10M (B = 32, 10M lanes, C = 4,096): one group, its 16 KB bitset
    in shared memory, four blocks an SM; the 1M cells (C = 1,024): a block
    for every 4,096 lanes, fewer than the card holds."""
    p = ops._mask_plan(32, 10_000_000, 4096, True, 132)
    assert p == ops.MaskPlan(groups=1, grid_x=528, smem=4 * 4097)
    p = ops._mask_plan(32, 1_000_064, 1024, True, 132)
    assert p == ops.MaskPlan(groups=1, grid_x=245, smem=4 * 1025)


def test_plan_groups_bitsets_and_grids():
    assert ops._mask_plan(33, 10_000_000, 4096, True, 132).groups == 2
    assert ops._mask_plan(64, 10_000_000, 4096, True, 132).grid_x == 264
    # the largest bitset a block holds, then device memory
    top = ops.MAX_SMEM // 4 - 1
    assert ops._mask_plan(32, 10**6, top, True, 132).smem == 4 * (top + 1)
    assert ops._mask_plan(32, 10**6, top + 1, True, 132).smem == 0
    assert ops._mask_plan(32, 10**6, 65536, True, 132).smem == 0
    # a 200 KB bitset leaves one block an SM
    assert ops._mask_plan(32, 10**7, 50_000, True, 132).grid_x == 132
    # unvectorised: a lane a thread
    assert ops._mask_plan(1, 1000, 64, False, 132).grid_x == 4
    assert ops._mask_plan(1, 1000, 64, True, 132).grid_x == 1
    with pytest.raises(ValueError, match="65535 groups"):
        ops._mask_plan(32 * 65535 + 1, 128, 64, True, 132)


# --------------------------------------------------------------------------
# the kernel (card)
# --------------------------------------------------------------------------

def _one_launch(fn):
    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "probe_mask_batch": 1}
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1024, 4096, 65536])
@pytest.mark.parametrize("n_probe", [1, 64, None])
@pytest.mark.parametrize("b", [1, 31, 32, 33, 64])
def test_cuda_kernel_is_the_plain_version_bitwise(cuda, b, n_probe, c):
    """About 400,000 lanes; ``n_probe`` None probes every cluster.  At
    C = 65,536 the bitset lives in device memory."""
    layout = _layout(c, 400_000, cuda, seed=c)
    p = c if n_probe is None else n_probe
    probed = _probed(b, c, p, cuda, seed=b + p)
    assert (ops._mask_plan(b, layout.n_flat, c, True).smem == 0) == (c > 50_000)
    got = _one_launch(lambda: ops.probe_mask_batch(layout.cluster_of, probed,
                                                   c))
    assert torch.equal(got, _plain(layout, probed, c))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4096, 65536])
@pytest.mark.parametrize("form", ["dupes", "live", "dupes_live", "ragged",
                                  "ragged_live", "unaligned",
                                  "unaligned_live"])
def test_cuda_kernel_edges(cuda, form, c):
    """Duplicate probes, tombstones, n % 16 != 0 (five or six padding
    lanes) and cluster ids and tombstones read through views one element
    off their 16-byte alignment (both the byte-wise path)."""
    layout = _layout(c, 300_001, cuda, seed=7,
                     tail=0 if form.startswith("ragged") else 128)
    n = layout.n_flat
    probed = _probed(33, c, 64, cuda, dupes=form.startswith("dupes"))
    live = _live(n, cuda) if form.endswith("live") else None
    cluster_of = layout.cluster_of
    if form.startswith("unaligned"):
        cluster_of = torch.cat([cluster_of[:1], cluster_of])[1:]
        if live is not None:
            live = torch.cat([live[:1], live])[1:]
        assert cluster_of.data_ptr() % 16 and not ops._aligned(cluster_of)
    if form.startswith("ragged"):
        assert n % 16
    got = _one_launch(lambda: ops.probe_mask_batch(cluster_of, probed, c,
                                                   live))
    assert torch.equal(got, _plain(layout, probed, c, live))


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 3])
def test_cuda_kernel_on_a_sharded_ranks_block(cuda, ivf_index, shards):
    c = ivf_index.n_clusters
    sl, _ = ivf.sharded_layout(ivf_index, shards)
    probed = _probed(33, c, 7, cuda)
    for j in range(shards):
        lay = ivf.FlatLayout(*(t.to(cuda) for t in sl.local(j)))
        live = _live(lay.n_flat, cuda, seed=j)
        for lv in (None, live):
            got = _one_launch(lambda: ops.probe_mask_batch(
                lay.cluster_of, probed, c, lv))
            assert torch.equal(got, _plain(lay, probed, c, lv))


@pytest.mark.cuda
def test_cuda_kernel_at_ten_million_lanes(cuda):
    """The deep-10M cell's shapes: B = 32 over 10M lanes in 4,096
    clusters, 64 probed a query."""
    layout = _layout(4096, 10_000_000, cuda, seed=10)
    assert layout.n_flat > 9_000_000
    probed = _probed(32, 4096, 64, cuda)
    got = _one_launch(lambda: ops.probe_mask_batch(layout.cluster_of, probed,
                                                   4096))
    assert torch.equal(got, _plain(layout, probed, 4096))


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(36)
    x = synthetic.clustered(rng, 8000, 64, n_centers=48)
    qs = torch.from_numpy(synthetic.queries_from(rng, x, 12))
    out = {}
    for method, build in (("pq", search.build_pq_index),
                          ("rabitq", search.build_rabitq_index)):
        index = build(x, 32, n_iter=4, seed=3, device="cpu")
        out[method] = (index, ivf.flat_layout(index.ivf))
    return out, qs


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pq", "rabitq"])
def test_cuda_searchers_take_one_mask_launch(indexes, cuda, method,
                                             monkeypatch):
    """A fused batched call on the card launches the mask kernel once and
    returns the ids, distances and counters of the same call with the
    plain mask on the card."""
    out, qs = indexes
    index, layout = out[method]
    d_index = search.index_to(index, cuda)
    d_layout = ivf.FlatLayout(*(t.to(cuda) for t in layout))
    d_stream = search.build_stream(d_index, d_layout)
    fn, kw = ((search.ivf_pq_search_batch, {"n_cand": 2400, "fused": True})
              if method == "pq" else (search.ivf_rabitq_search_batch, {}))

    def run():
        return fn(d_index, d_stream, qs.to(cuda), d_layout, k=300,
                  n_probe=10, use_bbc=True, **kw)

    ops.reset_launches()
    got = run()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["probe_mask_batch"] == 1
    monkeypatch.setattr(ops, "probe_mask_batch", ref.probe_mask_batch)
    want = run()
    for name in search.SearchResult._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
