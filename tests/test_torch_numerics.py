"""The port's fixed-order numerics (``repro_torch.core.numerics``) on the
CPU, bit for bit: ``sqrt_rn`` against numpy's IEEE square root,
``lane_err`` against the JAX package's expression
(``src/repro/kernels/ref.py:242``), and ``exact_dist`` and
``rabitq_bounds`` against a numpy fp32 evaluation of the same operations
in the same order.

``torch.sqrt`` on fp32 CPU tensors is not correctly rounded (1 ulp off on
about 0.6% of inputs on an AVX512 CPU, torch 2.13), while numpy, JAX and
the card round to nearest.  Every comparison here is ``array_equal`` on the
bits (NaN compared as NaN): no tolerance, because the plain versions must
give the card's bits on the CPU.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch.core import numerics  # noqa: E402

torch.set_num_threads(2)

F32 = np.float32
EPS0 = 3.0


def assert_bits_equal(got: np.ndarray, want: np.ndarray) -> None:
    """Equal fp32 bit patterns, every NaN taken as equal to every NaN."""
    assert got.dtype == want.dtype == np.float32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bad = (got.view(np.uint32) != want.view(np.uint32)) & ~nan
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} differ, e.g. "
                           f"x -> {got[bad][:4]} against {want[bad][:4]}")


def _values(family: str) -> np.ndarray:
    """At least 1M fp32 values of one family, 4M+ over all four."""
    rng = np.random.default_rng({"uniform": 1, "tiny": 2, "bits": 3,
                                 "edges": 4}[family])
    if family == "uniform":
        return rng.random(1 << 20, dtype=np.float32) * F32(1000)
    if family == "tiny":                      # subnormals and small normals
        return rng.random(1 << 20, dtype=np.float32) ** 8
    if family == "bits":                      # every finite positive float
        return rng.integers(0, 0x7F800000, 2 << 20,
                            dtype=np.uint32).view(np.float32)
    fi = np.finfo(np.float32)
    edges = np.array([0.0, -0.0, np.inf, np.nan, -1.0, -np.inf, fi.max,
                      fi.tiny, fi.smallest_subnormal, 1.0, 2.0, 4.0, 0.25],
                     dtype=np.float32)
    # the neighbours of exact squares and of the midpoint squares
    r = rng.random(1 << 18, dtype=np.float32) * F32(4096) + F32(1)
    sq = r.astype(np.float64) ** 2
    near = np.concatenate([np.nextafter(sq.astype(np.float32), F32(np.inf)),
                           np.nextafter(sq.astype(np.float32), F32(0)),
                           sq.astype(np.float32)])
    return np.concatenate([edges, near, -near[:1000]])


@pytest.mark.parametrize("family", ["uniform", "tiny", "bits", "edges"])
def test_sqrt_rn_matches_ieee(family):
    x = _values(family)
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x)
    got = numerics.sqrt_rn(torch.from_numpy(x)).numpy()
    assert_bits_equal(got, want)


def test_sqrt_rn_keeps_shape_and_sign_of_zero():
    x = torch.tensor([[0.0, -0.0], [4.0, 2.0]])
    r = numerics.sqrt_rn(x)
    assert r.shape == x.shape and r.dtype == torch.float32
    assert torch.equal(torch.signbit(r), torch.tensor([[False, True],
                                                       [False, False]]))


@pytest.mark.parametrize("d", [100, 128])
def test_lane_err_matches_jax_expression(d):
    rng = np.random.default_rng(d)
    f_o = (F32(0.55) + F32(0.4) * rng.random(100_000, dtype=np.float32))
    jf = jnp.asarray(f_o)
    # src/repro/kernels/ref.py:242, op by op
    want = np.asarray(EPS0 * jnp.sqrt((1.0 - jf ** 2) / (jf ** 2 * (d - 1))))
    got = numerics.lane_err(torch.from_numpy(f_o), d, EPS0).numpy()
    assert_bits_equal(got, want)


@pytest.mark.parametrize("d", [100, 128])
def test_exact_dist_matches_numpy_fp32(d):
    rng = np.random.default_rng(7 + d)
    x = rng.standard_normal((20_000, d), dtype=np.float32)
    q = rng.standard_normal(d, dtype=np.float32)
    acc = None
    for j in range(d):                     # ascending coordinates, fp32
        t = x[:, j] - q[j]
        acc = t * t if acc is None else acc + t * t
    want = np.sqrt(acc)
    got = numerics.exact_dist(torch.from_numpy(x),
                              torch.from_numpy(q)[None]).numpy()
    assert_bits_equal(got, want)


@pytest.mark.parametrize("d", [100, 128])
def test_rabitq_bounds_match_numpy_fp32(d):
    rng = np.random.default_rng(11 + d)
    n = 20_000

    def f(lo, hi):
        return F32(lo) + F32(hi - lo) * rng.random(n, dtype=np.float32)

    s1, s2 = f(-8, 8), f(-2, 2)
    nq, norm_o, f_o = f(0.5, 6), f(0.5, 6), f(0.55, 0.95)
    # numerics.rabitq_bounds, one fp32 operation per line
    den = np.maximum(nq, F32(1e-12)) * F32(math.sqrt(d))
    ip = ((s1 - s2) / den) / f_o
    f2 = f_o * f_o
    err = F32(EPS0) * np.sqrt((F32(1) - f2) / (f2 * F32(d - 1)))
    scale = (F32(2) * nq) * norm_o
    base = nq * nq + norm_o * norm_o

    def dist(t):
        return np.sqrt(np.maximum(base - scale * t, F32(0)))

    want = (dist(ip), dist(ip + err), dist(ip - err))
    got = numerics.rabitq_bounds(*(torch.from_numpy(a) for a in
                                   (s1, s2, nq, norm_o, f_o)), d, EPS0)
    for g, w in zip(got, want):
        assert_bits_equal(g.numpy(), w)
