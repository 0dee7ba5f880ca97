"""The port's k-means sums each cluster in a fixed order (the reference's
one-hot product over row chunks, no float atomics), so the same input gives
the same centroids on every run of one device.  The chunked sum agrees with
a float64 ``index_add_`` within 1e-5 of the largest sum's magnitude (fp32
sums of a few thousand rows); the JAX-picks test in
``test_torch_index.py`` holds the whole k-means against the reference."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.index import kmeans, pq  # noqa: E402

torch.set_num_threads(2)


def _data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))


@pytest.mark.parametrize("n_clusters,chunk", [(7, None), (7, 333), (64, 1000),
                                              (64, 1)])
def test_cluster_sums_match_float64_index_add(n_clusters, chunk):
    x = _data(5000, 16)
    a = torch.from_numpy(np.random.default_rng(1).integers(
        0, n_clusters, 5000))
    got = kmeans.cluster_sums(x, a, n_clusters, chunk)
    want = torch.zeros(n_clusters, 16, dtype=torch.float64).index_add_(
        0, a, x.double())
    assert got.dtype == torch.float32
    err = (got.double() - want).abs().max() / want.abs().max()
    assert err < 1e-5, float(err)


def test_cluster_sums_is_the_reference_one_hot_product():
    """One chunk is the reference's own formula, ``one_hot(a).T @ x``."""
    x = _data(3000, 8, seed=2)
    a = np.random.default_rng(3).integers(0, 12, 3000)
    want = jax.nn.one_hot(jnp.asarray(a), 12, dtype=jnp.float32).T \
        @ jnp.asarray(x.numpy())
    got = kmeans.cluster_sums(x, torch.from_numpy(a), 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_kmeans_twice_gives_the_same_bits():
    """Two runs from the same seed on the CPU: equal centroids and
    assignments, for the IVF quantizer and for the PQ codebooks."""
    x = _data(6000, 32, seed=4)
    runs = [kmeans.kmeans(x, 48, 6, generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    cbs = [pq.train(x, 8, 4, 4, generator=torch.Generator().manual_seed(9))
           for _ in range(2)]
    assert torch.equal(cbs[0].centroids, cbs[1].centroids)


@pytest.mark.cuda
def test_cuda_kmeans_twice_gives_the_same_bits():
    """On the card (where ``index_add_`` would add by float atomics): two
    runs at 20,000 x 128 with 1024 clusters (two row chunks) equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x = _data(20_000, 128, seed=5).cuda()
    runs = [kmeans.kmeans(x, 1024, 10,
                          generator=torch.Generator().manual_seed(0))
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
