"""Synthetic vector corpora (numpy), the port's own copy of the JAX
package's ``data/synthetic.py`` generators that the serving path uses.

``clustered`` is a Gaussian mixture whose distance distribution has the
concentration-plus-long-left-tail shape of real embedding corpora.  The same
seed gives the same arrays as the JAX package's copy.
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
