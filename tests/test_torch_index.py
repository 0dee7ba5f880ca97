"""The port's index pieces against the JAX package's on the reference's own
index: routing, probe masks, tile positions and the flat layout match
exactly; PQ tables and codes agree; k-means started from the reference's
picks lands on its centroids; the port's own build reaches the reference
build's recall."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic as jsyn  # noqa: E402
from repro.index import flat as jflat  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.index import kmeans as jkm  # noqa: E402
from repro.index import pq as jpq  # noqa: E402
from repro.index import search as jsearch  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.index import flat, ivf, kmeans, pq, search  # noqa: E402

torch.set_num_threads(2)

N, D, C, NQ = 6000, 32, 48, 12


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    x = synthetic.clustered(rng, N, D, n_centers=64)
    qs = synthetic.queries_from(rng, x, NQ)
    return x, qs


@pytest.fixture(scope="module")
def jindex(data):
    x, _ = data
    return jsearch.build_pq_index(jax.random.key(3), jnp.asarray(x), C,
                                  n_iter=5)


@pytest.fixture(scope="module")
def tivf(jindex):
    j = jindex.ivf
    return ivf.IVFIndex(*(torch.from_numpy(np.array(a)) for a in
                          (j.centroids, j.member_ids, j.member_valid,
                           j.cluster_sizes)))


def test_synthetic_copy_is_the_reference():
    a = synthetic.clustered(np.random.default_rng(1), 500, 16)
    b = jsyn.clustered(np.random.default_rng(1), 500, 16)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        synthetic.queries_from(np.random.default_rng(2), a, 7),
        jsyn.queries_from(np.random.default_rng(2), b, 7))


def test_flat_layout_matches(jindex, tivf):
    want = jivf.flat_layout(jindex.ivf)
    got = ivf.flat_layout(tivf)
    for name in ("order", "cluster_of", "offsets", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


@pytest.mark.parametrize("n_probe", [1, 7, 48])
def test_routing_probe_mask_tiles_match(jindex, tivf, data, n_probe):
    _, qs = data
    jp, jd2 = jivf.route_batch_d2(jindex.ivf, jnp.asarray(qs), n_probe)
    tp, td2 = ivf.route_batch_d2(tivf, torch.from_numpy(qs), n_probe)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-5)
    jl, tl = jivf.flat_layout(jindex.ivf), ivf.flat_layout(tivf)
    np.testing.assert_array_equal(
        ivf.probe_mask(tl, tp, C).numpy(),
        np.asarray(jivf.probe_mask(jl, jp, C)))
    st = min(4, n_probe)
    jpos, jok = jivf.tile_positions(jl, jp[:, :st], jindex.ivf.cap)
    tpos, tok = ivf.tile_positions(tl, tp[:, :st], tivf.cap)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_pq_tables_and_codes_match(jindex, data):
    x, qs = data
    cb = pq.PQCodebook(torch.from_numpy(np.array(jindex.pq.centroids)))
    luts = pq.adc_table(cb, torch.from_numpy(qs))
    want = np.stack([np.asarray(jpq.adc_table(jindex.pq, jnp.asarray(q)))
                     for q in qs])
    np.testing.assert_allclose(luts.numpy(), want, rtol=1e-5, atol=1e-5)
    codes = pq.encode(cb, torch.from_numpy(x)).numpy()
    same = codes == np.asarray(jindex.codes)
    assert same.mean() > 0.9999, same.mean()


def test_kmeans_from_reference_picks(data):
    x, _ = data
    key = jax.random.key(7)
    picks = np.array(jax.random.choice(key, N, (C,), replace=False))
    jc, ja = jkm.kmeans(key, jnp.asarray(x), C, 6)
    tc, ta = kmeans.kmeans(torch.from_numpy(x), C, 6,
                           init_idx=torch.from_numpy(picks))
    assert (ta.numpy() == np.asarray(ja)).mean() > 0.999
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-3,
                               atol=1e-3)


def test_pack_members_matches_reference_build(jindex, data):
    x, _ = data
    a = np.asarray(jkm.assign(jnp.asarray(x), jindex.ivf.centroids))
    ids, sizes = ivf.pack_members(a, C)
    np.testing.assert_array_equal(ids, np.asarray(jindex.ivf.member_ids))
    np.testing.assert_array_equal(sizes, np.asarray(jindex.ivf.cluster_sizes))


def test_flat_search_matches(data):
    x, qs = data
    for q in qs[:3]:
        jd, ji = jflat.search(jnp.asarray(x), jnp.asarray(q), 50)
        td, ti = flat.search(torch.from_numpy(x), torch.from_numpy(q), 50)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                                   atol=1e-4)


def _recall(res_ids, gt_ids, k):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                    for a, b in zip(res_ids, gt_ids)])


def test_build_recall_close_to_reference(jindex, data):
    """The port's own build (torch.Generator draws, not jax.random) reaches
    the reference build's recall within 0.02 on the same corpus."""
    x, qs = data
    k, n_probe, n_cand = 100, 8, 800
    tix = search.build_pq_index(x, C, n_iter=5, seed=3, device="cpu")
    tl = ivf.flat_layout(tix.ivf)
    tres = search.ivf_pq_search_batch(
        tix, search.build_stream(tix, tl), torch.from_numpy(qs), tl, k=k,
        n_probe=n_probe, n_cand=n_cand, use_bbc=True)
    jres = jsearch.ivf_pq_search_batch(
        jindex, jnp.asarray(qs), jivf.flat_layout(jindex.ivf), k=k,
        n_probe=n_probe, n_cand=n_cand, use_bbc=True, backend="ref")
    _, gt = flat.search_batch(torch.from_numpy(x), torch.from_numpy(qs), k)
    rt = _recall(tres.ids.numpy(), gt.numpy(), k)
    rj = _recall(np.asarray(jres.ids), gt.numpy(), k)
    assert rt >= rj - 0.02, (rt, rj)
    assert tix.codes.dtype == torch.uint8 and tix.codes.shape == (N, D // 4)
