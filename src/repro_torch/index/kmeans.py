"""Batched Lloyd k-means: the coarse quantizer for IVF and the PQ codebooks.

Random distinct initial picks from a ``torch.Generator`` (or explicit
``init_idx``, so a test can start from the JAX package's picks), then a
fixed number of Lloyd rounds; an empty cluster keeps its centroid.

Every step runs in a fixed order, with no float atomics, so the same input
gives the same centroids on every run of one device: the cluster sums are
the reference's one-hot product (``cluster_sums``), the counts an integer
``bincount``.
"""
from __future__ import annotations

import torch


def _pairwise_sq(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """||x - c||^2 via the matmul identity."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    return x2 + c2 - 2.0 * (x @ c.T)


def _rows_per_chunk(n_clusters: int) -> int:
    """Rows per chunk that keep a (rows, clusters) block under 2^24 entries."""
    return max(1, (1 << 24) // n_clusters)


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row (first index on ties), in row chunks so
    the (rows, clusters) distance block stays under 2^24 entries."""
    chunk = _rows_per_chunk(centroids.shape[0])
    return torch.cat([torch.argmin(_pairwise_sq(x[i:i + chunk], centroids),
                                   dim=-1)
                      for i in range(0, x.shape[0], chunk)])


def cluster_sums(x: torch.Tensor, a: torch.Tensor, n_clusters: int,
                 chunk: int | None = None) -> torch.Tensor:
    """(n_clusters, d) sums of ``x``'s rows by assignment ``a``: the
    reference's ``one_hot(a).T @ x`` in ``x``'s dtype, over row chunks (the
    one-hot under 2^24 entries, as in ``assign``), the chunks' partial sums
    added in ascending order.  A matrix product on one device gives the same
    bits for the same shapes on every run, where ``index_add_`` on the card
    adds by float atomics in an order that changes between runs."""
    chunk = chunk or _rows_per_chunk(n_clusters)
    ids = torch.arange(n_clusters, device=x.device)
    sums = torch.zeros(n_clusters, x.shape[1], dtype=x.dtype, device=x.device)
    for i in range(0, x.shape[0], chunk):
        one = (a[i:i + chunk, None] == ids).to(x.dtype)
        sums = sums + one.T @ x[i:i + chunk]
    return sums


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
        newc = cluster_sums(x, a, n_clusters) / torch.clamp(counts,
                                                            min=1.0)[:, None]
        cent = torch.where(counts[:, None] > 0, newc, cent)
    return cent, assign(x, cent)
