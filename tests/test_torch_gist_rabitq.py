"""The path of the GIST1M-width RaBitQ cell (1,000,000 x 960 under IVF1024 +
1-bit RaBitQ + BBC's greedy bounded re-rank, B = 32, k = 5000).

At a test's size at the published width (8,192 x 960, 32 lists, B = 4, on
seeded data), the batched bound-fused RaBitQ searcher through
``SearchEngine`` is held to a plain float64 exact search (recall over the
probed lists and the corpus, the exact suffix's distances within the
cell's ``exact_tol``, ascending order after the last estimate) and to the
JAX package's batched RaBitQ on the same index, carried across by
``convert`` (ids, distances and the work counters).  k alone picks the
straggler branch: at k = 256 the widest query's stragglers outgrow the
gather budget and the dense exact pass serves them; at k = 1024 the masked
per-row gather does.  On the CPU too, the launches the cell's call plans
at d = 960 over a million lanes, without a launch: the sample bounds at one
warp a block, #5's query chunk and shared memory, and #3's tiles and the
products it indexes with."""
import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.autograd import profiler as ap  # noqa: E402

from repro.data import synthetic  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro_torch import convert, spans  # noqa: E402
from repro_torch.index import engine, search  # noqa: E402
from repro_torch.kernels import ops, platform  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "portbench" / "configs" / "gist1m-rabitq.json")
                 .read_text())
N, D, C, B, N_PROBE, M = 8192, 960, 32, 4, 16, 128
EXACT_TOL = CFG["check"]["exact_tol"]
# the cell's call: B = 32 over the 1M-lane stream in 1,024 lists at k = 5000
CELL_B, CELL_N, CELL_K, N_EW = 32, 1_000_000, 5000, 256


@pytest.fixture(scope="module")
def gist():
    rng = np.random.default_rng(960)
    x = synthetic.clustered(rng, N, D, n_centers=64)
    qs = synthetic.queries_from(rng, x, B)
    ji = jsearch.build_rabitq_index(jax.random.key(0), jnp.asarray(x), C,
                                    n_iter=4)
    arrays = {
        "ivf_centroids": ji.ivf.centroids, "member_ids": ji.ivf.member_ids,
        "member_valid": ji.ivf.member_valid,
        "cluster_sizes": ji.ivf.cluster_sizes, "vectors": ji.vectors,
        "rot": ji.rq.rot, "codes": ji.rq.codes, "norm_o": ji.rq.norm_o,
        "f_o": ji.rq.f_o}
    ti, tl = convert.rabitq_index_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")
    return x, qs, ji, jivf.flat_layout(ji.ivf), ti


def _search(ti, qs, k):
    """The cell's engine (its method's knobs) at ``k``: the result and the
    call's work counters, read under a profiler."""
    eng = engine.SearchEngine.build(
        ti, k=k, n_probe=N_PROBE, n_cand=None, use_bbc=True, m=M,
        pred_count=k, fused=True, device="cpu", tuned=None)
    spans.clear()
    with ap.profile(use_kineto=True):
        res = eng.search(torch.from_numpy(qs))
    got = {}
    for c in spans.counters():
        got[c.name] = got.get(c.name, 0) + c.value
    return res, got


def _probed_rows(x, qs, ti):
    """Each query's rows in its ``N_PROBE`` nearest lists (float64)."""
    cent = ti.ivf.centroids.double().numpy()
    own = np.full(N, -1)
    ids, valid = ti.ivf.member_ids.numpy(), ti.ivf.member_valid.numpy()
    for c in range(C):
        own[ids[c][valid[c]]] = c
    out = []
    for q in qs.astype(np.float64):
        near = np.argsort(((cent - q) ** 2).sum(1), kind="stable")[:N_PROBE]
        out.append(np.flatnonzero(np.isin(own, near)))
    return out


@pytest.mark.parametrize("k,dense", [(256, True), (1024, False)])
def test_the_searcher_at_gist_width_against_exact_search_and_jax(gist, k,
                                                                  dense):
    x, qs, ji, jl, ti = gist
    res, got = _search(ti, qs, k)
    # the branch: k's gather budget against the widest query's stragglers
    budget = ((max(2 * k, 2048) + 127) // 128) * 128
    assert (int(res.n_second_pass.max()) > budget) == dense
    assert got["rerank.dense_stragglers"] == int(dense)
    assert bool((res.n_second_pass <= res.n_reranked).all())

    ids, dists = res.ids.numpy(), res.dists.numpy().astype(np.float64)
    xd = x.astype(np.float64)
    recall = []
    for row, (q, probed) in enumerate(zip(qs.astype(np.float64),
                                          _probed_rows(x, qs, ti))):
        exact_all = np.sqrt(((xd - q) ** 2).sum(1))
        assert len(set(ids[row].tolist())) == k
        # every one of the probed lists' exact top-k
        near = probed[np.argsort(exact_all[probed], kind="stable")[:k]]
        assert set(ids[row].tolist()) == set(near.tolist()), row
        top = np.argsort(exact_all, kind="stable")[:k]
        recall.append(len(set(ids[row].tolist()) & set(top.tolist())) / k)
        # certified rows first (estimates), then the exact suffix, ascending
        exact = exact_all[ids[row]]
        err = np.abs(dists[row] - exact) / exact
        estimate = np.flatnonzero(err > EXACT_TOL)
        last = estimate.max() if estimate.size else -1
        assert err[-1] <= EXACT_TOL and last < k - 1
        assert (np.diff(dists[row][last + 1:]) >= 0).all()
    # of the corpus's exact top-k, what half the lists hold
    assert np.mean(recall) >= 0.8

    jr = jsearch.ivf_rabitq_search_batch(
        ji, jnp.asarray(qs), jl, k=k, n_probe=N_PROBE, use_bbc=True,
        fused=True, backend="pallas")
    for row in range(B):
        assert set(np.asarray(jr.ids[row]).tolist()) == \
            set(ids[row].tolist()), row
    np.testing.assert_allclose(np.sort(dists, 1),
                               np.sort(np.asarray(jr.dists), 1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(res.n_reranked.numpy(),
                                  np.asarray(jr.n_reranked))
    np.testing.assert_array_equal(res.n_second_pass.numpy(),
                                  np.asarray(jr.n_second_pass))


def test_the_cell_runs_in_fp32_without_tf32():
    assert CFG["d"] == D and CFG["precision"] == "float32"
    assert CFG["tf32"] is False
    assert platform.tf32_off()


# --------------------------------------------------------------------------
# the plans of the cell's call (CPU, no launch)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1024, 6144])
def test_sample_bounds_take_one_warp_a_block_at_960(cap):
    """A thread's shared row holds ceil(960 / 2) = 480 sums at an odd
    stride of 481 floats: 64 rows beside the rotated query overrun the
    third of an SM a block may take, 32 fit, so the kernel runs one warp a
    block, one block for each 32 of a query's sampled lanes."""
    w = search.SAMPLE_TILES * cap
    p = ops._sample_ub_plan(w, D)
    assert (p.threads, p.stride) == (32, 481)
    assert p.smem == 4 * (D + 32 * 481) <= ops.SAMPLE_UB_SMEM < ops.MAX_SMEM
    assert 4 * (D + 64 * 481) > ops.SAMPLE_UB_SMEM
    assert p.grid_x == -(-w // 32) and p.grid_x * p.threads >= w
    assert CELL_B * w < 2 ** 31


def test_the_scan_takes_eight_queries_a_block_at_960():
    """#5's shared memory (``rabitq_fused_smem_bytes``: both query rows,
    the codebook parameters, the ew_map, two histograms, the gate and the
    miss count of each query of a chunk) holds eight 960-d queries in one
    block, 78,016 bytes: two blocks of 256 threads an SM; its (query,
    lane) offsets stay inside size_t arithmetic and its lanes in int."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
           / "rabitq_fused.cu").read_text()
    assert re.search(r"return 4 \* bq \* \(2 \* d \+ 2 \+ n_ew \+ "
                     r"2 \* \(m \+ 1\) \+ 2\);", src)

    def smem(bq):
        return 4 * bq * (2 * D + 2 + N_EW + 2 * (M + 1) + 2)

    bq, nbytes = ops._pick_bq(CELL_B, smem)
    assert (bq, nbytes) == (8, 78_016)
    assert ops.SMEM_PER_SM // (nbytes + 1024) == 2
    assert ops._tiles(CELL_N) == ops.MAX_TILES
    assert CELL_N * D < 2 ** 31 and CELL_N + ops.LANE_TILE < 2 ** 31


def test_the_dense_straggler_pass_plan_at_960():
    """#3 over every lane: four queries a thread in query tiles of 32, one
    block for each 128 rows, its double-buffered (128 + 32)-row chunks of
    64 coordinates in 87,040 bytes; every offset it forms (row x d, query
    x n) stays inside int32."""
    p = ops._l2_plan(CELL_B, CELL_N, D)
    assert (p.tn, p.qt, p.grid) == (4, 32, 7813)
    assert p.grid * ops.L2_ROWS >= CELL_N
    assert p.smem == 2 * (128 + 32) * 68 * 4 == 87_040 <= ops.MAX_SMEM
    assert CELL_N * D < 2 ** 31 and CELL_B * CELL_N < 2 ** 31


def test_the_masked_straggler_gather_plan_at_960():
    """Under the budget the stragglers go through the second pass's gather
    by position: 16-byte loads, 32 lanes a row, and a query, the slot list
    and a half row a group in shared memory."""
    p = ops._gather_plan(D, True)
    assert (p.g, p.vec) == (32, True)
    assert p.smem == 4 * (D + ops.GATHER_TILE + 8 * 480) <= ops.MAX_SMEM
    budget = ((max(2 * CELL_K, 2048) + 127) // 128) * 128
    assert budget == 10_112 and CELL_B * CELL_N < 2 ** 31
