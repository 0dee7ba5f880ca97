"""The shard collector's plain versions (kernels #6 and #7 of PERF.md's
table) against the JAX package's oracles, and the port's
``distributed.bbc_survivors_batch`` with no collective against the JAX
package's with ``axis_name=()``.

Shapes are the JAX package's own kernel tests' (``tests/test_shard_collect
.py``).  Both sides bucketize the same fp32 input with the same codebooks,
so every integer output (bucket, hist, pos, ok, count) must be equal.  The
CUDA kernels are held against these plain versions on the card
(``chip_smoke.py`` phase 3, and the ``cuda``-marked tests here: 1, 2 and
more chunks of one query than the card holds blocks at once, B = 1 and 64,
the edge budgets and repeated calls).  The one-pass kernel's launch plan
(``ops._collect_plan``) is plain Python, checked here on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import buffer as jrb  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)

# one compile per shape on the reference side, not one per operation
_j_collect = jax.jit(jref.shard_collect_batch, static_argnums=(5, 7))
_j_compact = jax.jit(jref.spec_compact_batch, static_argnums=(3,))
_j_bucket_hist = jax.jit(jref.bucket_hist_batch, static_argnums=(5,))
_j_survivors = jax.jit(jdist.bbc_survivors_batch,
                       static_argnames=("count", "budget", "axis_name"))
_j_codebooks = jax.jit(
    lambda d, k, m: jax.vmap(lambda s: jrb.build_codebook(s, k=k, m=m))(d),
    static_argnums=(1, 2))


def _stream(rng, b, n, m, frac=0.7):
    """(B, n) distances (+inf off ``valid``) and JAX codebooks over them,
    as numpy arrays for both sides."""
    d = (rng.standard_normal((b, n)).astype(np.float32)) ** 2 + 0.05
    valid = rng.random((b, n)) < frac
    d = np.where(valid, d, np.inf).astype(np.float32)
    cbs = _j_codebooks(jnp.asarray(d), max(8, min(n // 2, 512)), m)
    return d, valid, tuple(np.asarray(a) for a in
                           (cbs.d_min, cbs.delta, cbs.ew_map))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _taus(rng, b, m):
    return {"cold": np.full(b, -1, np.int32), "all": np.full(b, m, np.int32),
            "mixed": rng.integers(-1, m + 1, b).astype(np.int32)}


@pytest.mark.parametrize("b,n", [(8, 512), (4, 1024), (16, 256)])
@pytest.mark.parametrize("m", [32, 128])
def test_shard_collect_matches_reference(rng, b, n, m):
    d, valid, cb = _stream(rng, b, n, m)
    for name, tau in _taus(rng, b, m).items():
        want = _j_collect(jnp.asarray(d), jnp.asarray(valid),
                          *map(jnp.asarray, cb), m, jnp.asarray(tau), 48)
        got = ops.shard_collect_batch(*_t(d, valid, *cb), m,
                                      torch.from_numpy(tau), 48)
        assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32
        _equal(got, want)


@pytest.mark.parametrize("b,n,budget", [(8, 512, 32), (3, 768, 96)])
def test_spec_compact_matches_reference(rng, b, n, budget):
    m = 64
    d, valid, cb = _stream(rng, b, n, m)
    bucket = _j_bucket_hist(jnp.asarray(d), jnp.asarray(valid),
                            *map(jnp.asarray, cb), m)[0]
    for name, tau in _taus(rng, b, m).items():
        want = _j_compact(bucket, jnp.asarray(valid), jnp.asarray(tau),
                          budget)
        got = ops.spec_compact_batch(*_t(bucket, valid),
                                     torch.from_numpy(tau), budget)
        _equal(got, want)


def test_spec_compact_stream_order_and_overflow(rng):
    """The buffer holds the FIRST ``budget`` matching lanes in stream
    order; the count is the true total (the overflow signal)."""
    b, n, m, budget = 4, 512, 16, 16
    d, valid, cb = _stream(rng, b, n, m, frac=0.9)
    bucket, _ = ref.bucket_hist_batch(*_t(d, valid, *cb), m)
    pos, ok, cnt = ops.spec_compact_batch(bucket, torch.from_numpy(valid),
                                          torch.full((b,), m), budget)
    for q in range(b):
        match = np.nonzero(valid[q])[0]
        assert int(cnt[q]) == len(match)
        take = min(len(match), budget)
        np.testing.assert_array_equal(pos[q, :take].numpy(), match[:take])
        assert bool(ok[q, :take].all()) and not bool(ok[q, take:].any())


def test_budget_above_stream_pads_with_the_sentinel(rng):
    b, n, m = 3, 100, 16
    d, valid, cb = _stream(rng, b, n, m)
    tau = torch.tensor([-1, 5, m], dtype=torch.int32)
    bucket, hist, pos, ok, cnt = ops.shard_collect_batch(
        *_t(d, valid, *cb), m, tau, 160)
    assert pos.shape == (b, 160) and bool((pos[:, n:] == n).all())
    assert torch.equal(ok.sum(dim=1).to(torch.int32), cnt)
    assert int(cnt[0]) == 0 and int(cnt[2]) == int(valid[2].sum())
    assert torch.equal(hist.sum(dim=1), torch.from_numpy(valid.sum(1)).int())


def test_no_int32_composite_key_limit():
    """n * (m + 2) >= 2**31, past the JAX oracle's int32 key: the plain
    version still counts, histograms and compacts in stream order."""
    n, m, budget = 1 << 20, 2100, 64
    g = torch.Generator().manual_seed(0)
    dists = torch.rand(1, n, generator=g) * 300
    valid = torch.rand(1, n, generator=g) < 0.5
    ew = (torch.arange(256, dtype=torch.int32) * 8)[None]
    assert n * (m + 2) >= 2 ** 31
    bucket, hist, pos, ok, cnt = ops.shard_collect_batch(
        dists, valid, torch.zeros(1), torch.ones(1), ew, m,
        torch.tensor([100], dtype=torch.int32), budget)
    match = (valid & (bucket <= 100))[0].nonzero()[:, 0]
    assert int(cnt[0]) == match.numel() > budget
    assert torch.equal(pos[0].long(), match[:budget])
    assert int(hist.sum()) == int(valid.sum())


def _idsets(pos, ok):
    return [set(np.asarray(p)[np.asarray(o)].tolist())
            for p, o in zip(pos, ok)]


@pytest.mark.parametrize("count,budget", [(60, 96), (60, 24), (400, 64)])
def test_bbc_survivors_without_collective_matches_reference(rng, count,
                                                            budget):
    """Every survivor tier (covered, the correction pass, the exact
    fallback) keeps the reference's tau and survivor id sets, for the five
    provisional thresholds of the reference's own test."""
    b, n, m = 8, 512, 32
    d, valid, cb = _stream(rng, b, n, m)
    jb, jh = _j_bucket_hist(jnp.asarray(d), jnp.asarray(valid),
                            *map(jnp.asarray, cb), m)
    jkey = jnp.where(jnp.asarray(valid), jnp.asarray(d), jnp.inf)
    tb, th = _t(jb, jh)
    tkey, tvalid = _t(np.asarray(jkey), valid)
    jpos0, jok0, jtau0, _, _ = _j_survivors(
        jb, jkey, jnp.asarray(valid), jh, count=count, budget=budget,
        axis_name=())
    want = _idsets(jpos0, jok0)
    taus = {"warm_exact": jtau0, "cold": jnp.full((b,), -1, jnp.int32),
            "overshoot": jnp.minimum(jtau0 + 3, m),
            "undershoot": jnp.maximum(jtau0 - 1, -1),
            "max": jnp.full((b,), m, jnp.int32)}
    dist.reset_tiers()
    for name, ts in taus.items():
        _, _, spos, sok, scnt = ref.shard_collect_batch(
            *_t(d, valid, *cb), m, torch.from_numpy(np.array(ts)), budget)
        spec = (spos, sok, scnt, torch.from_numpy(np.array(ts)))
        pos, ok, tau, n_surv, ghist = dist.bbc_survivors_batch(
            tb, tkey, tvalid, th, count, budget, spec=spec)
        _, _, jspec_pos, jspec_ok, jspec_cnt = _j_collect(
            jnp.asarray(d), jnp.asarray(valid), *map(jnp.asarray, cb), m,
            ts, budget)
        jpos, jok, jtau, _, _ = _j_survivors(
            jb, jkey, jnp.asarray(valid), jh, count=count, budget=budget,
            axis_name=(), spec=(jspec_pos, jspec_ok, jspec_cnt, ts))
        np.testing.assert_array_equal(tau.numpy(), np.asarray(jtau))
        assert _idsets(pos, ok) == _idsets(jpos, jok) == want, name
        assert torch.equal(ghist, th)
        assert pos.shape == (b, budget)
    assert sum(dist.TIERS.values()) == len(taus)


def test_budget_above_stream_clamps_the_exact_tier(rng):
    """A budget wider than the stream keeps the (B, budget) shape, padded
    invalid, and every survivor."""
    b, n, m, budget = 4, 128, 16, 512
    d, valid, cb = _stream(rng, b, n, m)
    bucket, hist = ref.bucket_hist_batch(*_t(d, valid, *cb), m)
    key = torch.where(torch.from_numpy(valid), torch.from_numpy(d),
                      float("inf"))
    pos, ok, tau, n_surv, _ = dist.bbc_survivors_batch(
        bucket, key, torch.from_numpy(valid), hist, 64, budget)
    assert pos.shape == (b, budget) and ok.shape == (b, budget)
    assert int(ok.sum()) == int(n_surv.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,budget", [(32, 125_056, 20_224),
                                        (3, 1000, 1500)])
def test_cuda_kernels_match_plain_versions(b, n, budget):
    """On a card: both kernels bitwise equal to their plain versions, at
    cold, all and mixed thresholds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(0)
    m = 128
    d, valid, cb = _stream(rng, b, n, m)
    args = [t.cuda() for t in _t(d, valid, *cb)]
    for tau in _taus(rng, b, m).values():
        tau = torch.from_numpy(tau).cuda()
        got = ops.shard_collect_batch(*args, m, tau, budget)
        want = ref.shard_collect_batch(*args, m, tau, budget)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        got = ops.spec_compact_batch(got[0], args[1], tau, budget)
        want = ref.spec_compact_batch(want[0], args[1], tau, budget)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("n,chunks", [(1, 1), (4096, 1), (4097, 2),
                                      (1_000_064, 245)])
@pytest.mark.parametrize("budget,pieces", [(0, 0), (1, 1), (8192, 1),
                                           (8193, 2), (80_128, 10)])
def test_collect_plan_chunks_and_scratch(b, n, chunks, budget, pieces):
    """One ticket, and one block, per (query, 4,096-lane chunk) and per
    (query, 8,192 slots of its buffer); the scratch holds a 64-bit status
    word per chunk from offset 0, then the ticket counter, then (fused) the
    histogram on a 16-byte boundary, and nothing else."""
    assert (ops.COLLECT_CHUNK, ops.COLLECT_FILL) == (4096, 8192)
    for bins in (0, 129):
        p = ops._collect_plan(b, n, budget, bins)
        assert (p.n_chunks, p.pieces) == (chunks, pieces)
        assert p.grid == b * (chunks + pieces)
        assert p.ticket == 2 * b * chunks
        assert p.hist % 4 == 0 and p.ticket < p.hist <= p.ticket + 4
        assert p.words == p.hist + b * bins


def test_collect_plan_main_path_shape_and_limit():
    """Phase 11's PQ shape (B=32, n=1,000,064, budget 80,128, m=128) in
    numbers, and a ticket count past int32 raises."""
    assert ops._collect_plan(32, 1_000_064, 80_128, 129) == (
        245, 10, 32 * 255, 15680, 15684, 15684 + 32 * 129)
    assert ops._collect_plan(32, 1_000_064, 20_224).words == 15684
    with pytest.raises(ValueError, match="ticket"):
        ops._collect_plan(1 << 20, 1 << 23, 0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_stream(seed, b, n, m=128, density=0.0625):
    """Inputs made on the card: (B, n) distances (+inf off the valid lanes)
    and per-query codebooks over them (``buffer.build_codebook``)."""
    from repro_torch.core import buffer as rb
    g = torch.Generator(device="cuda").manual_seed(seed)
    d = torch.rand(b, n, generator=g, device="cuda") * 30 + 1
    valid = torch.rand(b, n, generator=g, device="cuda") < density
    d = torch.where(valid, d, float("inf"))
    cb = rb.build_codebook(d, k=min(max(n // 64, 8), 5000), m=m)
    return [d, valid, cb.d_min, cb.delta, cb.ew_map]


def _kernels_equal_plain(args, m, tau, budget):
    """Both kernels bitwise equal to their plain versions; returns the
    plain fused outputs."""
    got = ops.shard_collect_batch(*args, m, tau, budget)
    want = ref.shard_collect_batch(*args, m, tau, budget)
    for g, w in zip(got, want):
        assert torch.equal(g, w), budget
    got = ops.spec_compact_batch(want[0], args[1], tau, budget)
    for g, w in zip(got, ref.spec_compact_batch(want[0], args[1], tau,
                                                budget)):
        assert torch.equal(g, w), budget
    return want


def _resident_blocks():
    p = torch.cuda.get_device_properties(0)
    threads = getattr(p, "max_threads_per_multi_processor", 2048)
    return p.multi_processor_count * threads // 256


@pytest.mark.cuda
@pytest.mark.parametrize("b,chunks,extra", [(1, 1, 0), (64, 1, 0),
                                            (1, 2, -5), (64, 2, -5),
                                            (1, "resident", 16),
                                            (64, 3, 123)])
def test_cuda_one_pass_across_chunks(card, b, chunks, extra):
    """One chunk, two (the second ragged, n % 16 != 0: the scalar loads),
    and more chunks of one query than the card holds blocks at once (the
    look-back over chunks that ran long before), at B = 1 and 64, with
    budgets that hold and overflow the matches."""
    m = 128
    if chunks == "resident":
        chunks = _resident_blocks() + 40
    n = chunks * ops.COLLECT_CHUNK + extra
    args = _card_stream(b + n, b, n, m)
    g = torch.Generator(device="cuda").manual_seed(b)
    for tau in (torch.full((b,), m, dtype=torch.int32, device=card),
                torch.randint(-1, m + 1, (b,), generator=g,
                              device=card).to(torch.int32)):
        for budget in (n // 8, n // 40):
            _kernels_equal_plain(args, m, tau, budget)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 64])
def test_cuda_edge_budgets_and_repeats(card, b):
    """Budgets of 1, exactly query 0's total, one short of it and its
    matches in the first two chunks (a chunk boundary); then one call
    repeated 10 times gives the same bits."""
    m = 128
    n = 5 * ops.COLLECT_CHUNK + 48
    args = _card_stream(7 + b, b, n, m, density=0.3)
    tau = torch.full((b,), m, dtype=torch.int32, device=card)
    want = _kernels_equal_plain(args, m, tau, n)
    match = args[1][0] & (want[0][0] <= m)
    total = int(match.sum())
    boundary = int(match[:2 * ops.COLLECT_CHUNK].sum())
    assert 1 < boundary < total - 1
    for budget in (1, total, total - 1, boundary):
        out = _kernels_equal_plain(args, m, tau, budget)
        assert int(out[4][0]) == total
    first = ops.shard_collect_batch(*args, m, tau, boundary)
    first_c = ops.spec_compact_batch(first[0], args[1], tau, boundary)
    for _ in range(10):
        again = ops.shard_collect_batch(*args, m, tau, boundary)
        again_c = ops.spec_compact_batch(first[0], args[1], tau, boundary)
        for x, y in zip(first + first_c, again + again_c):
            assert torch.equal(x, y)
