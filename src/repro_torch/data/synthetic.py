"""Synthetic vector corpora (numpy), the port's own copy of the JAX
package's ``data/synthetic.py`` generators.

``clustered`` is a Gaussian mixture whose distance distribution has the
concentration-plus-long-left-tail shape of real embedding corpora;
``isotropic`` is the structureless worst case of every quantizer;
``manifold`` puts Zipf-sized clusters on a low-dimensional nonlinear
manifold.  The same seed gives the same arrays as the JAX package's copy:
the draws are the same calls in the same order.
"""
from __future__ import annotations

import numpy as np


def clustered(
    rng: np.random.Generator,
    n: int,
    d: int,
    n_centers: int = 256,
    center_scale: float = 2.0,
    point_scale: float = 0.5,
    dtype=np.float32,
) -> np.ndarray:
    centers = rng.standard_normal((n_centers, d)) * center_scale
    asg = rng.integers(0, n_centers, n)
    x = centers[asg] + rng.standard_normal((n, d)) * point_scale
    return x.astype(dtype)


def queries_from(rng: np.random.Generator, x: np.ndarray, n_q: int,
                 jitter: float = 0.1) -> np.ndarray:
    """Queries near corpus points (the paper samples queries from the corpus)."""
    idx = rng.choice(len(x), n_q, replace=False)
    return (x[idx] + rng.standard_normal((n_q, x.shape[1])) * jitter).astype(x.dtype)


def isotropic(rng: np.random.Generator, n: int, d: int,
              dtype=np.float32) -> np.ndarray:
    return rng.standard_normal((n, d)).astype(dtype)


def manifold(
    rng: np.random.Generator,
    n: int,
    d: int,
    intrinsic_dim: int = 8,
    n_centers: int = 256,
    zipf_a: float = 1.3,
    center_scale: float = 2.0,
    point_scale: float = 0.35,
    curvature: float = 1.5,
    ambient_noise: float = 0.02,
    dtype=np.float32,
) -> np.ndarray:
    """Low-dimensional manifold with heavy-tailed clusters: latent centers
    in R^intrinsic_dim, Zipf(``zipf_a``) memberships, Gaussian latent
    spread, then one smooth lift z -> z @ A + curvature * sin(z @ B + phase)
    into R^d plus small isotropic noise, rows shuffled."""
    if intrinsic_dim > d:
        raise ValueError(f"intrinsic_dim {intrinsic_dim} exceeds d {d}")
    ranks = np.arange(1, n_centers + 1, dtype=np.float64)
    weights = ranks ** -zipf_a
    weights /= weights.sum()
    sizes = rng.multinomial(n, weights)
    asg = np.repeat(np.arange(n_centers), sizes)

    z_centers = rng.standard_normal((n_centers, intrinsic_dim)) * center_scale
    z = z_centers[asg] + rng.standard_normal(
        (n, intrinsic_dim)) * point_scale

    lift_a = rng.standard_normal((intrinsic_dim, d)) / np.sqrt(intrinsic_dim)
    lift_b = rng.standard_normal((intrinsic_dim, d)) / np.sqrt(intrinsic_dim)
    phase = rng.uniform(0.0, 2.0 * np.pi, d)
    x = z @ lift_a + curvature * np.sin(z @ lift_b + phase)
    x += rng.standard_normal((n, d)) * ambient_noise
    rng.shuffle(x)
    return x.astype(dtype)
