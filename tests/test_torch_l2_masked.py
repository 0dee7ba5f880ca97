"""The masked exact pass (``ops.l2_exact_batch_masked``, ``l2_rerank.cu``'s
``l2_masked_kernel``): RaBitQ's straggler pass past the gather budget, the
dense pass's distances at the set (query, row) pairs alone.

Bars: on the CPU the op is the dense pass under the mask, +inf off it, and
the bound-fused RaBitQ searcher returns what it returned with the dense
pass, whatever lies off the mask; the tiles it counts are the 128-row
tiles of each round of 32 queries with a set pair, under a profiler only.
On a card the kernel equals ``ops.l2_exact_batch`` bitwise on every set
pair, in one launch, and stages exactly the tiles with a set pair.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import profiler as ap  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.index import engine, search  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)
INF = float("inf")
READ, TILES = "rerank.straggler_tiles_read", "rerank.straggler_tiles"


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


def _mask(rng, kind, b, n, lists=12, share=0.9):
    """A (B, n) straggler-like mask: ``empty``, ``full``, ``sparse`` (5% of
    the pairs at random) or ``clusters`` (the rows cut into ``lists``
    contiguous lists; each query sets ``share`` of the rows of a few of
    them, as RaBitQ's stragglers fill a query's probed lists)."""
    if kind == "empty":
        return torch.zeros(b, n, dtype=torch.bool)
    if kind == "full":
        return torch.ones(b, n, dtype=torch.bool)
    if kind == "sparse":
        return torch.from_numpy(rng.random((b, n)) < 0.05)
    cuts = np.sort(rng.choice(np.arange(1, n), lists - 1, replace=False))
    owner = np.searchsorted(cuts, np.arange(n), side="right")
    out = np.zeros((b, n), dtype=bool)
    for q in range(b):
        probed = rng.choice(lists, max(1, lists // 4), replace=False)
        out[q] = np.isin(owner, probed) & (rng.random(n) < share)
    return torch.from_numpy(out)


def _inputs(rng, b, n, d):
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    qs = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    return x, qs


def _tiles_by_hand(mask, rows=128, group=32):
    b, n = mask.shape
    out = torch.zeros(-(-b // group), -(-n // rows), dtype=torch.uint8)
    for r in range(out.shape[0]):
        for t in range(out.shape[1]):
            out[r, t] = bool(mask[group * r:group * (r + 1),
                                  rows * t:rows * (t + 1)].any())
    return out


def _counted(fn):
    """``fn()`` inside a span under a profiler, and its counters by name
    (values as recorded: a tensor stays a tensor)."""
    spans.clear()
    with ap.profile(use_kineto=True):
        with spans.span("rerank.stragglers"):
            out = fn()
    got = {}
    for rec in spans.RECORDER._records:
        if type(rec) is spans.CountRecord:
            got[rec.name] = rec.value
    return out, got


# --------------------------------------------------------------------------
# the plain version and its counters (CPU)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 7, 128, 129, 960])
@pytest.mark.parametrize("kind", ["empty", "full", "sparse", "clusters"])
def test_cpu_op_is_the_dense_pass_on_the_mask(rng, d, kind):
    x, qs = _inputs(rng, 5, 300, d)
    mask = _mask(rng, kind, 5, 300)
    got = ops.l2_exact_batch_masked(x, qs, mask)
    dense = ops.l2_exact_batch(x, qs)
    assert torch.equal(got, torch.where(mask, ref.l2_exact_batch(x, qs),
                                        INF))
    assert torch.equal(got[mask], dense[mask])
    assert bool((got[~mask] == INF).all())


@pytest.mark.parametrize("b", [1, 5, 32, 40, 70])
@pytest.mark.parametrize("n", [1, 127, 128, 300, 1000])
@pytest.mark.parametrize("kind", ["empty", "full", "sparse", "clusters"])
def test_masked_tiles_are_the_tiles_with_a_set_pair(rng, b, n, kind):
    mask = _mask(rng, kind, b, n, lists=min(12, max(n - 1, 1)))
    got = ref.masked_tiles(mask, 128, 32)
    assert got.dtype == torch.uint8
    assert torch.equal(got, _tiles_by_hand(mask))
    p = ops._masked_plan(b, n)
    assert got.shape == (p.rounds, p.grid)


def test_the_counters_are_recorded_only_under_a_profiler(rng):
    x, qs = _inputs(rng, 40, 1000, 16)
    mask = _mask(rng, "clusters", 40, 1000)
    with spans.span("rerank.stragglers"):
        ops.l2_exact_batch_masked(x, qs, mask)
    assert spans.counters() == []
    _, got = _counted(lambda: ops.l2_exact_batch_masked(x, qs, mask))
    assert set(got) == {READ, TILES}
    assert torch.equal(got[READ], _tiles_by_hand(mask))
    assert got[TILES] == 2 * 8                  # two rounds of eight tiles
    summed = {c.name: c.value for c in spans.counters()}
    assert summed == {READ: int(_tiles_by_hand(mask).sum()), TILES: 16}


@pytest.mark.parametrize("b,n,plan", [
    (32, 1_000_064, ops.MaskedPlan(1, 7813, 3 * 4 * 160 * 36)),
    (1, 300, ops.MaskedPlan(1, 3, 69_120)),
    (40, 1000, ops.MaskedPlan(2, 8, 69_120)),
    (5, 128, ops.MaskedPlan(1, 1, 69_120))])
def test_masked_plan(b, n, plan):
    """One block per 128 rows, rounds of 32 queries, and a 3-stage ring
    of (128 + 32) rows of 32 coordinates at a stride of 36 floats: three
    blocks of it (and their 4 KB mask slice) share an SM at every d."""
    p = ops._masked_plan(b, n)
    assert p == plan
    assert p.smem <= ops.MAX_SMEM
    assert ops.SMEM_PER_SM // (p.smem + 4096 + 256 + 1024) == 3
    assert p.grid * ops.L2_ROWS >= n > (p.grid - 1) * ops.L2_ROWS


# --------------------------------------------------------------------------
# the searcher's dense branch (CPU)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rabitq():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6000, 32, generator=g)
    qs = x[:8] + 0.01 * torch.randn(8, 32, generator=g)
    index = search.build_rabitq_index(x, 32, n_iter=4, device="cpu")
    eng = engine.SearchEngine.build(index, k=10, n_probe=32, fused=True,
                                    device="cpu", tuned=None)
    return eng, qs


def _search(eng, qs, k):
    spans.clear()
    with ap.profile(use_kineto=True):
        res = search.ivf_rabitq_search_batch(
            eng.index, eng.stream, qs, eng.layout, k=k, n_probe=32,
            use_bbc=True)
    got = {}
    for c in spans.counters():
        got[c.name] = got.get(c.name, 0) + c.value
    return res, got


@pytest.mark.parametrize("k", [5, 10])
def test_searcher_reads_the_masked_pass_at_the_stragglers_alone(
        rabitq, k, monkeypatch):
    """Past the gather budget (every cluster probed, k = 5 or 10) the
    searcher returns the ids, distances and counters it returned with the
    dense pass over every lane, with the masked pass's entries off the
    mask poisoned (NaN); and it counts the tiles the pass stages."""
    eng, qs = rabitq
    real = ops.l2_exact_batch_masked
    seen = []

    def dense(x, q, mask):
        seen.append(mask.clone())
        return ops.l2_exact_batch(x, q)

    monkeypatch.setattr(ops, "l2_exact_batch_masked", dense)
    before, c_before = _search(eng, qs, k)

    def poisoned(x, q, mask):
        out = real(x, q, mask)
        return torch.where(mask, out, float("nan"))

    monkeypatch.setattr(ops, "l2_exact_batch_masked", poisoned)
    after, c_after = _search(eng, qs, k)

    assert c_before["rerank.dense_stragglers"] == 1
    mask = seen[0]
    assert mask.shape == (qs.shape[0], eng.layout.n_flat)
    assert torch.equal(mask.sum(dim=1).to(torch.int32), before.n_second_pass)
    for name in ("ids", "dists", "n_reranked", "n_second_pass"):
        assert torch.equal(getattr(after, name), getattr(before, name)), name
    tiles = ref.masked_tiles(mask)
    assert c_after.pop(READ) == int(tiles.sum()) > 0
    assert c_after.pop(TILES) == tiles.numel()
    assert c_after == c_before


def test_under_the_budget_the_gather_serves_the_stragglers(rabitq,
                                                           monkeypatch):
    """Under the budget (k = 100: at most ~1,100 stragglers a query
    against 2,048 rows) the masked pass does not run and its counters are
    not recorded."""
    eng, qs = rabitq

    def refuse(*_):
        raise AssertionError("the masked pass ran under the budget")

    monkeypatch.setattr(ops, "l2_exact_batch_masked", refuse)
    res, got = _search(eng, qs, 100)
    assert got["rerank.dense_stragglers"] == 0
    assert READ not in got and TILES not in got
    assert 0 < int(res.n_second_pass.max()) <= 2048


# --------------------------------------------------------------------------
# the kernel (card)
# --------------------------------------------------------------------------

def _check_on_card(x, qs, mask):
    """The kernel against the dense pass on every set pair, in one launch,
    and its staged tiles against the tiles with a set pair."""
    ops.reset_launches()
    _, got = _counted(lambda: ops.l2_exact_batch_masked(x, qs, mask))
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "l2_exact_masked_batch": 1}
    out = ops.l2_exact_batch_masked(x, qs, mask)
    dense = ops.l2_exact_batch(x, qs)
    torch.cuda.synchronize()
    assert torch.equal(out[mask], dense[mask])
    assert torch.equal(got[READ].cpu(), ref.masked_tiles(mask.cpu()))
    assert got[TILES] == got[READ].numel()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 960, 129])
@pytest.mark.parametrize("b", [1, 5, 32, 40])
@pytest.mark.parametrize("kind", ["empty", "full", "sparse", "clusters"])
def test_cuda_bitwise_on_the_set_pairs(rng, cuda, d, b, kind):
    n = 3001                                    # not a multiple of 128 or 16
    x, qs = _inputs(rng, b, n, d)
    mask = _mask(rng, kind, b, n)
    _check_on_card(x.to(cuda), qs.to(cuda), mask.to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 960])
def test_cuda_aligned_mask_and_unaligned_rows(rng, cuda, d):
    """n % 16 == 0 reads the mask 16 bytes at a time; rows and queries one
    float off 16-byte alignment take 4-byte copies, a mask one byte off it
    1-byte reads."""
    b, n = 32, 4096
    x, qs = _inputs(rng, b, n, d)
    mask = _mask(rng, "clusters", b, n)
    _check_on_card(x.to(cuda), qs.to(cuda), mask.to(cuda))
    xs = torch.empty(n * d + 1, device=cuda)[1:].view(n, d)
    xs.copy_(x)
    qv = torch.empty(b * d + 1, device=cuda)[1:].view(b, d)
    qv.copy_(qs)
    mv = torch.empty(b * n + 1, dtype=torch.bool, device=cuda)[1:].view(b, n)
    mv.copy_(mask)
    assert not ops._aligned(xs) and not ops._aligned(mv)
    _check_on_card(xs, qv, mv)


@pytest.mark.cuda
def test_cuda_smem_layout_matches_the_plan(cuda):
    assert ops._lib("l2_rerank").l2_exact_masked_smem_bytes() == \
        ops._masked_plan(32, 1000).smem


@pytest.mark.cuda
def test_cuda_searcher_takes_the_masked_pass(rabitq, cuda):
    """The bound-fused RaBitQ searcher on the card, past the budget: one
    masked launch and no dense one, the ids and distances of the CPU."""
    eng, qs = rabitq
    cpu = search.ivf_rabitq_search_batch(
        eng.index, eng.stream, qs, eng.layout, k=10, n_probe=32,
        use_bbc=True)
    card = engine.SearchEngine.build(eng.index, k=10, n_probe=32, fused=True,
                                     device="cuda", tuned=None)
    ops.reset_launches()
    res = search.ivf_rabitq_search_batch(
        card.index, card.stream, qs.to(cuda), card.layout, k=10, n_probe=32,
        use_bbc=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["l2_exact_masked_batch"] == 1
    assert ops.LAUNCHES["l2_exact_batch"] == 0
    assert torch.equal(res.n_second_pass.cpu(), cpu.n_second_pass)
    for row in range(qs.shape[0]):
        assert set(res.ids[row].tolist()) == set(cpu.ids[row].tolist())
