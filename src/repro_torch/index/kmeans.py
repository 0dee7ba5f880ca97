"""Batched Lloyd k-means: the coarse quantizer for IVF and the PQ codebooks.

Random distinct initial picks from a ``torch.Generator`` (or explicit
``init_idx``, so a test can start from the JAX package's picks), then a
fixed number of Lloyd rounds; an empty cluster keeps its centroid.
"""
from __future__ import annotations

import torch


def _pairwise_sq(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """||x - c||^2 via the matmul identity."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    return x2 + c2 - 2.0 * (x @ c.T)


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row (first index on ties), in row chunks so
    the (rows, clusters) distance block stays under 2^24 entries."""
    chunk = max(1, (1 << 24) // centroids.shape[0])
    return torch.cat([torch.argmin(_pairwise_sq(x[i:i + chunk], centroids),
                                   dim=-1)
                      for i in range(0, x.shape[0], chunk)])


def kmeans(x: torch.Tensor, n_clusters: int, n_iter: int = 10,
           generator: torch.Generator | None = None,
           init_idx: torch.Tensor | None = None):
    """Returns (centroids (n_clusters, d), assignment (n,) int64)."""
    n, d = x.shape
    if init_idx is None:
        init_idx = torch.randperm(n, generator=generator)[:n_clusters]
    cent = x[init_idx.to(x.device)]
    for _ in range(n_iter):
        a = assign(x, cent)
        counts = torch.bincount(a, minlength=n_clusters).to(x.dtype)
        sums = torch.zeros(n_clusters, d, dtype=x.dtype, device=x.device)
        sums.index_add_(0, a, x)
        newc = sums / torch.clamp(counts, min=1.0)[:, None]
        cent = torch.where(counts[:, None] > 0, newc, cent)
    return cent, assign(x, cent)
