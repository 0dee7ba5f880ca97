"""Batched top-k collectors over a shared candidate stream.

The port of the batched half of the JAX package's ``core/collector.py``:
the BBC collector (paper Alg. 1) over (B, n) estimates and the flat top-k
baseline.  The reference's ``lax.cond`` overflow escape hatch is a Python
branch on one ``.item()``: a host sync per call.
"""
from __future__ import annotations

import torch

from repro_torch.core import buffer as rb
from repro_torch.kernels import ops

INF = float("inf")


def bbc_collect_batch(dists, ids, valid, k: int, m: int = 128, sample=None,
                      sample_valid=None, n_ew: int = 256,
                      slack_buckets: int = 2):
    """Bucket collection for a query batch over a shared candidate stream.

    Per-query codebooks come from ``sample`` (or the masked rows); bucket
    ids and histograms from ``ops.bucket_hist_batch``; then
    ``collect_batch``."""
    if sample is None:
        sample, sample_valid = dists, valid
    k_cb = min(k, sample.shape[1])
    cbs = rb.build_codebook(sample, k=k_cb, m=m, n_ew=n_ew,
                            valid=sample_valid)
    dv = torch.where(valid, dists, INF)
    bucket, hist = ops.bucket_hist_batch(dv, valid, cbs.d_min, cbs.delta,
                                         cbs.ew_map, m)
    return collect_batch(dists, ids, valid, bucket, hist, k, m,
                         slack_buckets=slack_buckets)


def collect_batch(dists, ids, valid, bucket, hist, k: int, m: int,
                  slack_buckets: int = 2):
    """Batched Alg. 1 Collect over bucket ids (B, n) and histograms
    (B, m+1): lanes at or below each query's threshold bucket are compacted
    into a (k + slack)-wide buffer and the k smallest kept.  When any query
    overflows (threshold in the overflow bucket, or more survivors than the
    buffer holds) the whole batch takes one full-width selection instead.
    Returns (dists (B, k) ascending, ids (B, k))."""
    n = dists.shape[1]
    tau, _ = rb.threshold_bucket(hist, k)
    survive = valid & (bucket <= tau[:, None])
    budget = rb._collect_budget(k, n, slack_buckets, m)
    overflowed = bool(torch.any(
        (tau >= m) | (torch.sum(survive, dim=1) > budget)).item())
    if overflowed:
        d = torch.where(valid, dists, INF)
        vals, order = rb.smallest(d, k)
        return vals, torch.where(torch.isfinite(vals), ids[order], -1)
    idx, ok = rb.compact_mask(survive, budget)
    safe = idx.clamp(max=n - 1)
    cd = torch.where(ok, torch.gather(dists, 1, safe), INF)
    ci = torch.where(ok, ids[safe], -1)
    vals, order = rb.smallest(cd, k)
    return vals, torch.gather(ci, 1, order)


def topk_collect_batch(dists, ids, valid, k: int):
    """Batched flat top-k over the shared stream.  Under-filled slots come
    back as (+inf, -1)."""
    d = torch.where(valid, dists, INF)
    vals, order = rb.smallest(d, k)
    return vals, torch.where(torch.isfinite(vals), ids[order], -1)
