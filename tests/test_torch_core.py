"""The port's core pieces (buffer, collector, rerank) against the JAX
package's, on shared numpy inputs.  Integer outputs must be equal; codebook
edges agree to 1e-6 relative."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import buffer as jrb  # noqa: E402
from repro.core import collector as jcol  # noqa: E402
from repro.core import rerank as jrr  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro_torch.core import buffer as rb  # noqa: E402
from repro_torch.core import collector as col  # noqa: E402
from repro_torch.core import rerank as rr  # noqa: E402
from repro_torch.index import search as tsearch  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _samples(rng, b, w, n_inf=0, ties=False):
    s = (rng.random((b, w)) * 10 + 1).astype(np.float32)
    if ties:   # PQ-style exact ties: few distinct values
        s = np.round(s, 1).astype(np.float32)
    if n_inf:
        s[:, -n_inf:] = np.inf
    return s


@pytest.mark.parametrize("b,w,k,m,n_inf", [(4, 600, 300, 64, 0),
                                           (3, 1000, 1000, 128, 200),
                                           (2, 257, 100, 16, 0),
                                           (2, 300, 300, 128, 300)])
def test_build_codebook_matches(rng, b, w, k, m, n_inf):
    s = _samples(rng, b, w, n_inf)
    got = rb.build_codebook(_t(s), k=k, m=m)
    for i in range(b):
        want = jrb.build_codebook(jnp.asarray(s[i]), k=k, m=m)
        np.testing.assert_allclose(got.edges[i].numpy(),
                                   np.asarray(want.edges), rtol=1e-6,
                                   atol=1e-6)
        assert got.d_min[i].item() == float(want.d_min)
        assert got.delta[i].item() == float(want.delta)
        np.testing.assert_array_equal(got.ew_map[i].numpy(),
                                      np.asarray(want.ew_map))


@pytest.mark.parametrize("k", [1, 50, 400, 5000])
def test_threshold_bucket_matches(rng, k):
    hist = rng.integers(0, 40, (6, 129)).astype(np.int32)
    tau, before = rb.threshold_bucket(_t(hist), k)
    for i in range(6):
        jt, jb = jrb.threshold_bucket(jnp.asarray(hist[i]), k)
        assert tau[i].item() == int(jt)
        assert before[i].item() == int(jb)


@pytest.mark.parametrize("budget", [10, 333, 1200])
def test_compact_mask_matches(rng, budget):
    mask = rng.random((3, 1000)) < 0.3
    idx, ok = rb.compact_mask(_t(mask), budget)
    for i in range(3):
        ji, jo = jrb.compact_mask(jnp.asarray(mask[i]), budget)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ok[i].numpy(), np.asarray(jo))


def test_smallest_breaks_ties_like_lax_top_k():
    x = np.array([1.0, 0.5, 0.5, 0.5, 2.0], np.float32)
    _, want = jax.lax.top_k(-jnp.asarray(x), 2)
    _, got = rb.smallest(_t(x), 2)
    assert got.tolist() == np.asarray(want).tolist() == [1, 2]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("overflow", [False, True])
def test_collect_batch_matches(rng, ties, overflow):
    b, n, k, m = 4, 3000, 400, 64
    valid = rng.random((b, n)) < 0.8
    dists = np.where(valid, _samples(rng, b, n, ties=ties), np.inf)
    dists = dists.astype(np.float32)
    ids = rng.permutation(n).astype(np.int32)
    kcb = k if not overflow else 40       # a narrow codebook overflows
    cbs = rb.build_codebook(_t(dists), k=kcb, m=m)
    bucket, hist = rb.bucketize(cbs, _t(dists)), None
    hist = rb.histogram(bucket, m, _t(valid))
    got_d, got_i = col.collect_batch(_t(dists), _t(ids).long(), _t(valid),
                                     bucket, hist, k, m)
    want_d, want_i = jcol.collect_batch(
        jnp.asarray(dists), jnp.asarray(ids), jnp.asarray(valid),
        jnp.asarray(bucket.numpy()), jnp.asarray(hist.numpy()), k, m)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def _collect_by_compact_mask(dists, ids, valid, bucket, hist, k, m):
    """``collect_batch`` as it was before the compaction kernel: a survivor
    mask, its sums and ``buffer.compact_mask``'s sort over every lane, or
    a full-width selection on overflow.  Returns (dists, ids, whether the
    batch took the full-width selection)."""
    n = dists.shape[1]
    tau, _ = rb.threshold_bucket(hist, k)
    survive = valid & (bucket <= tau[:, None])
    budget = rb._collect_budget(k, n, 2, m)
    if bool(torch.any((tau >= m) | (torch.sum(survive, 1) > budget))):
        vals, order = rb.smallest(torch.where(valid, dists, np.inf), k)
        return vals, torch.where(torch.isfinite(vals), ids[order], -1), True
    idx, ok = rb.compact_mask(survive, budget)
    safe = idx.clamp(max=n - 1)
    cd = torch.where(ok, torch.gather(dists, 1, safe), np.inf)
    ci = torch.where(ok, ids[safe], -1)
    vals, order = rb.smallest(cd, k)
    return vals, torch.gather(ci, 1, order), False


# k=100, m=16, n=3000: the buffer holds _collect_budget = 176 survivors.
# Each case is a batch: one row per entry, the lanes per low bucket
# (the rest valid in buckets 2..m-1), or "none" / "overflow" for a row with
# no valid lane / with its valid lanes past bucket 1 in the overflow bucket.
COLLECT_CASES = {
    "ties": ([{0: 60, 1: 70}, {0: 99, 1: 1}, {0: 100}], False),
    "at_budget": ([{0: 90, 1: 86}, {0: 30, 1: 90}], False),
    "over_budget": ([{0: 90, 1: 87}, {0: 30, 1: 90}], True),
    "tau_is_m": ([{0: 30, 1: 20, "overflow": True}, {0: 150}], True),
    "no_valid_lane": ([{0: 60, 1: 70}, {"none": True}], True),
}


@pytest.mark.parametrize("case", sorted(COLLECT_CASES))
@pytest.mark.parametrize("positions", [False, True])
def test_collect_batch_compacts_like_compact_mask(rng, case, positions):
    """The compacted survivors give the values and ids of the sort
    compaction and of its full-width branch bit for bit: tied buckets and
    tied estimates, a row exactly at the buffer's width, a row over it and
    a row whose threshold is the overflow bucket (the buffer widens), and a
    row with no valid lane (sentinels fill it, as invalid lanes fill the
    full width)."""
    n, k, m = 3000, 100, 16
    rows, want_full = COLLECT_CASES[case]
    bucket = rng.integers(2, m, (len(rows), n))
    valid = rng.random((len(rows), n)) < 0.9
    for r, spec in enumerate(rows):
        # the last lane survives: a sentinel slot that read it would show
        lanes = np.r_[n - 1, rng.permutation(n - 1)]
        at = 0
        for b, c in spec.items():
            if isinstance(b, int):
                bucket[r, lanes[at:at + c]] = b
                valid[r, lanes[at:at + c]] = True
                at += c
        if spec.get("overflow"):
            bucket[r, lanes[at:]] = m
        if spec.get("none"):
            valid[r] = False
    # tied estimates inside a bucket, each bucket's below the next one's;
    # finite junk on the invalid lanes
    dists = (bucket + np.round(0.9 * rng.random(bucket.shape), 1)).astype(
        np.float32)
    ids = (np.arange(n) if positions else rng.permutation(n)).astype(
        np.int64)
    args = (_t(dists), _t(ids), _t(valid), _t(bucket.astype(np.int32)))
    hist = rb.histogram(args[3], m, args[2])
    want_d, want_i, full = _collect_by_compact_mask(*args, hist, k, m)
    assert full == want_full
    got_d, got_i = col.collect_batch(*args, hist, k, m)
    assert got_d.dtype == want_d.dtype and got_i.dtype == want_i.dtype
    np.testing.assert_array_equal(got_d.numpy(), want_d.numpy())
    np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())


@pytest.mark.parametrize("with_sample", [False, True])
def test_bbc_collect_batch_matches(rng, with_sample):
    b, n, k, m = 3, 2500, 300, 64
    valid = rng.random((b, n)) < 0.85
    dists = _samples(rng, b, n, ties=True)
    ids = rng.permutation(n).astype(np.int32)
    kw_t, kw_j = {}, {}
    if with_sample:
        sample = dists[:, :800]
        kw_t = dict(sample=_t(sample), sample_valid=_t(valid[:, :800]))
        kw_j = dict(sample=jnp.asarray(sample),
                    sample_valid=jnp.asarray(valid[:, :800]))
    got_d, got_i = col.bbc_collect_batch(_t(dists), _t(ids).long(),
                                         _t(valid), k, m=m, **kw_t)
    want_d, want_i = jcol.bbc_collect_batch(
        jnp.asarray(dists), jnp.asarray(ids), jnp.asarray(valid), k, m=m,
        backend="ref", **kw_j)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_topk_collect_batch_underfilled(rng):
    dists = _samples(rng, 2, 50)
    valid = np.zeros((2, 50), bool)
    valid[:, :10] = True
    ids = np.arange(50, dtype=np.int32)
    got_d, got_i = col.topk_collect_batch(_t(dists), _t(ids).long(),
                                          _t(valid), 20)
    want_d, want_i = jcol.topk_collect_batch(
        jnp.asarray(dists), jnp.asarray(ids), jnp.asarray(valid), 20)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("n_cand,n_total", [(4000, 60000), (500, 1200)])
def test_early_rerank_plan_matches(rng, n_cand, n_total):
    s = _samples(rng, 5, 2048, n_inf=100)
    got = rr.early_rerank_plan(_t(s), n_cand=n_cand, n_sample=2048,
                               n_total=n_total, m=128)
    for i in range(5):
        want = jrr.early_rerank_plan(jnp.asarray(s[i]), n_cand=n_cand,
                                     n_sample=2048, n_total=n_total, m=128)
        assert got.tau_pred[i].item() == int(want.tau_pred)
        np.testing.assert_array_equal(got.cb.ew_map[i].numpy(),
                                      np.asarray(want.cb.ew_map))


def test_predictor_matches_reference(rng):
    m = 128
    js, ts = jrr.predictor_init(m), rr.predictor_init(m)
    assert rr.predict_tau(ts, 100) == int(jrr.predict_tau(js, 100)) == -1
    for step in range(6):
        hist = rng.integers(0, 60, (8, m + 1)).astype(np.int32)
        js = jrr.predictor_update(js, jnp.asarray(hist))
        ts = rr.predictor_update(ts, _t(hist))
        np.testing.assert_allclose(ts.ema.numpy(), np.asarray(js.ema),
                                   rtol=1e-6, atol=1e-5)
        assert ts.weight.item() == pytest.approx(float(js.weight), rel=1e-6)
        for count in (1, 500, 2500, 3000, 7000):
            assert rr.predict_tau(ts, count) == int(jrr.predict_tau(js,
                                                                    count))


def test_predict_tau_on_shared_state_exact_counts():
    """Integer-valued EMAs make cumulative sums land exactly on the count,
    where the prefix-sum association decides the bucket."""
    ema = np.zeros(129, np.float32)
    ema[:128] = np.float32(0.1) * np.arange(1, 129, dtype=np.float32)
    for weight in (np.float32(1.0), np.float32(0.2), np.float32(0.36)):
        js = jrr.PredictorState(ema=jnp.asarray(ema),
                                weight=jnp.float32(weight))
        ts = rr.PredictorState(ema=_t(ema), weight=torch.tensor(weight))
        for count in range(1, 900, 7):
            assert rr.predict_tau(ts, count) == int(jrr.predict_tau(js,
                                                                    count))


def test_predicted_fallback_mask_matches(rng):
    bucket = rng.integers(0, 65, (3, 500)).astype(np.int32)
    valid = rng.random((3, 500)) < 0.7
    tp = np.array([5, 20, -1], np.int32)
    tt = np.array([10, 3, 7], np.int32)
    got = rr.predicted_fallback_mask(_t(bucket), _t(valid), _t(tp), _t(tt))
    want = jrr.predicted_fallback_mask(jnp.asarray(bucket), jnp.asarray(valid),
                                       jnp.asarray(tp), jnp.asarray(tt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("width", [30, 300])
def test_topk_est_id_tie_cut_matches(rng, width):
    """Heavy exact ties straddle the cut: the kept set is the (value,
    global id) one, where a plain top-k would keep an arbitrary subset."""
    n = 1000
    est = (rng.integers(0, 12, (4, n)) * 0.5).astype(np.float32)
    gids = rng.permutation(n).astype(np.int32)
    _, jpos = jsearch._topk_est_id(jnp.asarray(est), jnp.asarray(gids), width)
    vals, pos = tsearch._topk_est_id(_t(est), _t(gids).long(), width)
    for i in range(4):
        assert set(pos[i].tolist()) == set(np.asarray(jpos[i]).tolist())
    np.testing.assert_array_equal(vals.numpy(), np.sort(est, 1)[:, :width])
