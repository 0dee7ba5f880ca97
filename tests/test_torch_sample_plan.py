"""The codebook sample's plan in one kernel (``ops.sample_plan_batch``,
``sample_plan.cu``'s ``sample_plan_kernel``): equal-depth codebooks over each
row's smallest sampled values and the bucket of its rank-th value.

Bars: the plain version equals the composition the searchers ran before
the kernel bitwise (PQ: ``_sqrt_est``, ``build_codebook``, ``kthvalue``,
``bucketize``; RaBitQ: a sorted ``topk``, ``build_codebook_from_topk``, the
rank-th value's bucket plus the margin); the launch chooser sorts the cells'
rows in shared memory and narrows the greedy plan's full-stream rows first;
on a card the kernel equals the plain version bitwise in both modes, and the
fused PQ and RaBitQ searchers return the plain plan's ids, distances and
counters with one plan launch a call.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import buffer as rb  # noqa: E402
from repro_torch.core import numerics  # noqa: E402
from repro_torch.core import rerank  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.index import ivf, search  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)
INF = float("inf")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ---- the composition before the kernel ------------------------------------

def _old_codebook_from_topk(topk, m, n_ew=256):
    dev = topk.device
    finite = torch.isfinite(topk)
    top_finite = torch.where(finite, topk, -INF).amax(dim=-1)
    top_finite = torch.where(torch.isfinite(top_finite), top_finite, 0.0)
    topk = torch.where(finite, topk, top_finite[:, None])
    d_min = topk[:, 0]
    d_max = topk[:, -1]
    k = topk.shape[-1]
    span = torch.maximum(d_max - d_min, torch.full_like(d_max, 1e-6)) * 1.02
    delta = span / n_ew
    step = torch.arange(m, dtype=torch.float32, device=dev) / m
    pos = torch.cat([(k - 1.0) * step,
                     torch.full((1,), k - 1.0, device=dev)])
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=k - 1)
    frac = pos - lo.to(torch.float32)
    edges = topk[:, lo] + (topk[:, hi] - topk[:, lo]) * frac
    eps = span * 1e-7
    edges = edges + eps[:, None] * torch.arange(m + 1, dtype=torch.float32,
                                                device=dev)
    centers = d_min[:, None] + (torch.arange(
        n_ew, dtype=torch.float32, device=dev) + 0.5) * delta[:, None]
    ew_map = torch.searchsorted(edges.contiguous(), centers.contiguous(),
                                right=True) - 1
    ew_map = ew_map.clamp(0, m - 1).to(torch.int32)
    return edges, d_min, delta, ew_map


def _old_pq_plan(est2, sok, n_cand, rank, m, n_ew=256):
    """``_sqrt_est``, ``build_codebook`` and ``early_rerank_plan``'s
    ``kthvalue`` and ``bucketize``, as the PQ searchers ran them."""
    s = torch.where(sok, numerics.sqrt_rn(torch.clamp(est2, min=0.0)), INF)
    k = min(n_cand, s.shape[-1])
    topk = torch.topk(s, k, dim=-1, largest=False, sorted=True).values
    cb = _old_codebook_from_topk(topk, m, n_ew)
    kth = torch.kthvalue(s, rank, dim=1).values
    tau = ref.bucketize_batch(kth[:, None], cb[1], cb[2], cb[3], m)[:, 0]
    return cb, tau


def _old_rabitq_plan(ub, k, rank, m, margin=2):
    """``_rabitq_sample_plan`` before the kernel."""
    k_cb = min(k, ub.shape[1])
    topk = torch.topk(ub, k_cb, dim=1, largest=False, sorted=True).values
    cb = _old_codebook_from_topk(topk, m)
    tau = ref.bucketize_batch(topk[:, rank - 1:rank], cb[1], cb[2], cb[3],
                              m)[:, 0]
    return cb, torch.clamp(tau + margin, max=m - 1).to(torch.int32)


def _bits_equal(a, b):
    """Equal dtypes, shapes and bits (NaN included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _same_plan(got, want):
    (gcb, gtau), (wcb, wtau) = got, want
    for g, w in zip(gcb, wcb):
        assert _bits_equal(g.cpu(), w.cpu())
    assert (gtau is None) == (wtau is None)
    if gtau is not None:
        assert _bits_equal(gtau.cpu(), wtau.cpu())


def _sample(rng, b, w, kind):
    """(B, w) squared estimates and a lane mask: valid lanes first (a ragged
    count a row), +inf padding off them; ``kind`` adds ties, a NaN, a row
    with no valid lane, or negative squares."""
    est2 = (rng.random((b, w)) * 40 + 0.5).astype(np.float32)
    n_ok = rng.integers(w // 3, w + 1, b)
    ok = np.arange(w)[None] < n_ok[:, None]
    if kind == "ties":
        est2 = np.round(est2 * 2) / 2                 # few distinct values
    elif kind == "nan":
        est2[0, 3] = np.nan
        est2[-1, rng.integers(0, w, 5)] = np.nan
    elif kind == "empty":
        ok[0] = False
    elif kind == "negative":
        est2[:, ::7] = -est2[:, ::7]                  # clamped to 0
    return torch.from_numpy(est2), torch.from_numpy(ok)


# ---- the plain version, on the CPU -----------------------------------------

CASES = [  # (b, w, k_cb, rank, m, kind)
    (5, 700, 700, 1, 128, "pad"), (5, 700, 300, 300, 128, "pad"),
    (4, 1000, 400, 37, 384, "ties"), (3, 513, 513, 513, 128, "nan"),
    (3, 600, 200, 1, 384, "empty"), (1, 900, 250, 120, 128, "negative"),
    (1, 64, 64, 64, 384, "ties")]


@pytest.mark.parametrize("b,w,k_cb,rank,m,kind", CASES)
def test_plain_is_the_pq_composition_bitwise(rng, b, w, k_cb, rank, m, kind):
    est2, sok = _sample(rng, b, w, kind)
    want = _old_pq_plan(est2, sok, k_cb, rank, m)
    got = ref.sample_plan_batch(est2, sok, k_cb, m, rank=rank, sqrt=True)
    _same_plan(got, want)
    ops.reset_launches()
    plan = rerank.early_rerank_plan(est2, n_cand=k_cb, n_sample=rank,
                                    n_total=k_cb, m=m, valid=sok,
                                    squared=True)
    assert set(ops.LAUNCHES.values()) == {0}      # the CPU launches nothing
    _same_plan((tuple(plan.cb), plan.tau_pred), want)


@pytest.mark.parametrize("b,w,k_cb,rank,m,kind", CASES)
def test_plain_is_the_rabitq_composition_bitwise(rng, b, w, k_cb, rank, m,
                                                 kind):
    est2, sok = _sample(rng, b, w, kind)
    ub = torch.where(sok, est2, INF)
    want = _old_rabitq_plan(ub, k_cb, rank, m)
    got = ref.sample_plan_batch(ub, None, k_cb, m, rank=rank, margin=2,
                                cap=m - 1)
    _same_plan(got, want)
    cbs, tau = search._rabitq_sample_plan(ub, k_cb, k_cb * rank, 4,
                                          4 * k_cb, m)
    _same_plan((tuple(cbs), tau), want)


@pytest.mark.parametrize("m", [128, 384])
def test_plain_rank_past_the_codebook(rng, m):
    """A rank past k_cb (a sample larger than the probed share, as
    ``early_rerank_plan`` may be asked): the rank-th value of the whole
    row, ``kthvalue``'s."""
    est2, sok = _sample(rng, 4, 800, "pad")
    s = ref.sample_values(est2, sok, True)
    want_cb = _old_codebook_from_topk(
        torch.topk(s, 200, dim=1, largest=False, sorted=True).values, m)
    kth = torch.kthvalue(s, 500, dim=1).values
    want_tau = ref.bucketize_batch(kth[:, None], want_cb[1], want_cb[2],
                                   want_cb[3], m)[:, 0]
    got = ref.sample_plan_batch(est2, sok, 200, m, rank=500, sqrt=True)
    _same_plan(got, (want_cb, want_tau))


def test_codebooks_from_topk_and_masks_are_the_composition(rng):
    """``build_codebook`` (a mask, no root) and ``build_codebook_from_topk``
    (rows already sorted) are the composition's codebooks."""
    est2, sok = _sample(rng, 3, 500, "nan")
    cb = rb.build_codebook(est2, 200, 128, valid=sok)
    topk = torch.topk(torch.where(sok, est2, INF), 200, dim=1, largest=False,
                      sorted=True).values
    want = _old_codebook_from_topk(topk, 128)
    _same_plan((tuple(cb), None), (want, None))
    _same_plan((tuple(rb.build_codebook_from_topk(topk, 128)), None),
               (want, None))


def test_bad_arguments_raise(rng):
    est2, sok = _sample(rng, 2, 100, "pad")
    with pytest.raises(ValueError, match="rank"):
        ops.sample_plan_batch(est2, sok, k_cb=50, m=128, rank=101)
    with pytest.raises(ValueError, match="presorted"):
        ops.sample_plan_batch(est2, sok, k_cb=100, m=128, presorted=True)
    with pytest.raises(ValueError, match="mixed or unsupported devices"):
        ops.sample_plan_batch(est2, sok.to("meta"), k_cb=50, m=128)


# ---- the launch chooser -----------------------------------------------------

@pytest.mark.parametrize("w,m", [(16_384, 128), (4 * 4096, 128),
                                 (32_768, 128), (1, 128), (700, 384)])
def test_chooser_sorts_in_shared_memory(w, m):
    """The four cells' samples (w = 16,384 at m = 128; PQ k_cb 16,384,
    RaBitQ 5,000) and every row to 32,768: sorted in a block."""
    p = ops._sample_plan_launch(w, m, 256)
    assert p.sort and p.padded >= w and p.padded & (p.padded - 1) == 0
    assert p.padded < 2 * w or w == 1
    lanes = p.padded // ops.PLAN_LANE_KEYS      # 16 keys a thread
    assert p.threads == (lanes if 512 <= p.padded <= 16_384
                         else max(32, min(ops.PLAN_THREADS, p.padded // 2)))
    assert p.smem == 4 * (p.padded + m + 1 + 256 + 33) <= ops.MAX_SMEM


@pytest.mark.parametrize("w", [1_000_064, 32_769, 58_000])
def test_chooser_takes_long_rows_sorted(w):
    """The greedy plan's full-stream row and anything past 32,768 keys:
    read sorted (the wrapper narrows it with ``torch.topk`` first)."""
    p = ops._sample_plan_launch(w, 128, 256)
    assert not p.sort and p.padded == 0
    assert p.threads == ops.PLAN_SORTED_THREADS
    assert p == ops._sample_plan_launch(5000, 128, 256, presorted=True)


def test_chooser_refuses_a_map_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        ops._sample_plan_launch(100, 128, 60_000)


# ---- on a card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,w,k_cb,rank,m,kind", CASES + [
    (32, 16_384, 16_384, 2_500, 128, "pad"),
    (32, 16_384, 5_000, 1_250, 128, "ties"), (2, 300, 300, 150, 128, "nan"),
    (2, 20_000, 20_000, 7_000, 128, "ties")])
def test_cuda_kernel_is_the_plain_version_bitwise(rng, cuda, b, w, k_cb,
                                                  rank, m, kind):
    """Sorted in shared memory (a pair of keys a thread under 512 keys and
    past 16,384, else 16 keys a thread in the warps' registers): the kernel
    against the plain version on the card (PQ's squares and mask, RaBitQ's
    bounds, margin and cap), and against the CPU's where m is a power of
    two (the CPU divides by m, the card multiplies by its reciprocal), in
    one launch a call."""
    est2, sok = _sample(rng, b, w, kind)
    g2, gok = est2.to(cuda), sok.to(cuda)
    ops.reset_launches()
    got = ops.sample_plan_batch(g2, gok, k_cb=k_cb, m=m, rank=rank,
                                sqrt=True)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "sample_plan_batch": 1}
    _same_plan(got, ref.sample_plan_batch(g2, gok, k_cb, m, rank=rank,
                                          sqrt=True))
    if m & (m - 1) == 0:
        _same_plan(got, ref.sample_plan_batch(est2, sok, k_cb, m, rank=rank,
                                              sqrt=True))
    ub = torch.where(gok, g2, INF)
    got = ops.sample_plan_batch(ub, k_cb=k_cb, m=m, rank=rank, margin=2,
                                cap=m - 1)
    _same_plan(got, ref.sample_plan_batch(ub, None, k_cb, m, rank=rank,
                                          margin=2, cap=m - 1))
    got = ops.sample_plan_batch(g2, gok, k_cb=k_cb, m=m)
    _same_plan(got, ref.sample_plan_batch(g2, gok, k_cb, m))


@pytest.mark.cuda
@pytest.mark.parametrize("w,k_cb,rank", [(1_000_064, 5_000, 5_000),
                                         (40_000, 30_000, 35_000)])
def test_cuda_long_rows_take_the_sorted_mode(rng, cuda, w, k_cb, rank):
    """The greedy plan's full-stream row (``rb.build_codebook`` at w =
    1,000,064, k_cb = k) and a row past shared memory with a rank past
    k_cb: ``torch.topk`` then the sorted-row launch, the plain version's
    bits."""
    est2, sok = _sample(rng, 2, w, "pad")
    g2, gok = est2.to(cuda), sok.to(cuda)
    ops.reset_launches()
    cb = rb.build_codebook(torch.where(gok, g2, INF), k_cb, 128)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "sample_plan_sorted_batch": 1}
    want = ref.sample_plan_batch(torch.where(gok, g2, INF), None, k_cb, 128)
    _same_plan((tuple(cb), None), want)
    got = ops.sample_plan_batch(g2, gok, k_cb=k_cb, m=128, rank=rank,
                                sqrt=True)
    _same_plan(got, ref.sample_plan_batch(g2, gok, k_cb, 128, rank=rank,
                                          sqrt=True))


@pytest.mark.cuda
def test_cuda_presorted_rows_and_strided_views(rng, cuda):
    """A caller's top-k (``build_codebook_from_topk``), also as a column
    slice of a wider sorted row (the sharded codebooks' ``asc[:, :k_cb]``):
    the sorted-row launch, the plain version's bits."""
    est2, sok = _sample(rng, 6, 3000, "nan")
    asc = torch.sort(torch.where(sok, est2, INF).to(cuda), dim=1).values
    ops.reset_launches()
    for topk in (asc[:, :1200].contiguous(), asc[:, :1200]):
        cb = rb.build_codebook_from_topk(topk, 128)
        _same_plan((tuple(cb), None),
                   (ref.codebook_from_topk(topk, 128), None))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sample_plan_sorted_batch"] == 2


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(34)
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
def test_cuda_fused_searchers_take_one_plan_launch(indexes, cuda, method,
                                                   monkeypatch):
    """A fused call on the card launches the plan kernel once and returns
    the ids, distances and counters of the same call with the plain plan
    on the card."""
    out, qs = indexes
    index, layout = out[method]
    d_index = search.index_to(index, cuda)
    d_layout = ivf.FlatLayout(*(t.to(cuda) for t in layout))
    d_stream = search.build_stream(d_index, d_layout)
    fn, kw = ((search.ivf_pq_search_batch, {"n_cand": 2400})
              if method == "pq" else (search.ivf_rabitq_search_batch, {}))

    def run():
        return fn(d_index, d_stream, qs.to(cuda), d_layout, k=300,
                  n_probe=10, use_bbc=True, **kw)

    ops.reset_launches()
    got = run()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sample_plan_batch"] == 1
    assert ops.LAUNCHES["sample_plan_sorted_batch"] == 0
    monkeypatch.setattr(ops, "sample_plan_batch",
                        lambda v, ok=None, **kw: ref.sample_plan_batch(
                            v, ok, **kw))
    want = run()
    for name in search.SearchResult._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
