"""Brute-force exact search: the ground truth for recall."""
from __future__ import annotations

import torch

from repro_torch.core import buffer as rb
from repro_torch.core import numerics


def search_batch(x: torch.Tensor, qs: torch.Tensor, k: int):
    """Exact top-k by Euclidean distance for a (B, d) query batch.
    Returns (dists (B, k) ascending, ids (B, k))."""
    d2 = (torch.sum(x * x, dim=1)[None, :] - 2.0 * (qs @ x.T)
          + torch.sum(qs * qs, dim=1)[:, None])
    vals, idx = rb.smallest(d2, k)
    return numerics.sqrt_rn(torch.clamp(vals, min=0.0)), idx


def search(x: torch.Tensor, q: torch.Tensor, k: int):
    """Exact top-k for one (d,) query: (dists (k,), ids (k,))."""
    d, i = search_batch(x, q[None], k)
    return d[0], i[0]
