"""Bucket-based result buffer (paper Alg. 1), batched over queries.

The port of the JAX package's ``core/buffer.py``.  Every function takes a
leading query axis: a codebook holds (B, ...) fields and distances are
(B, n).  The steps are the reference's:

  1. ``build_codebook``   — per-query equal-depth quantizer over the local
     top-k of a sample (256 equal-width bins remapped to ``m`` equal-depth
     buckets, Eq. 6); ``sample_plan`` also gives the bucket of a rank-th
     sampled value, one kernel launch on the card.
  2. ``bucketize``        — Eq. 6 bucket ids, overflow bucket ``m``.
  3. ``histogram``        — the (B, m+1) bucket histogram.
  4. ``threshold_bucket`` — first bucket whose cumulative count reaches k.
  5. ``compact_mask``     — stream-order positions of the surviving lanes.

``collect`` and ``topk_oracle`` are the single-query forms (1-D distances,
a codebook of batch 1) the single-query searchers and the Exp-3
collectors call.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

INF = float("inf")


class BucketCodebook(NamedTuple):
    """Per-query 1-D quantizers: equal-width front end + equal-depth remap.

    ``edges`` (B, m+1) ascending bucket boundaries; ``d_min`` and ``delta``
    (B,) the equal-width range start and bin width; ``ew_map`` (B, n_ew)
    int32 equal-width bin -> equal-depth bucket id.
    """

    edges: torch.Tensor
    d_min: torch.Tensor
    delta: torch.Tensor
    ew_map: torch.Tensor

    @property
    def m(self) -> int:
        return self.edges.shape[-1] - 1

    @property
    def n_ew(self) -> int:
        return self.ew_map.shape[-1]


def default_num_buckets(vmem_bytes: int = 16 * 1024 * 1024,
                        lut_bytes: int = 0, code_tile_bytes: int = 0,
                        bytes_per_bucket: int = 2 * 2 * 64,
                        cap: int = 512) -> int:
    """The reference's Eq. 3 sizing of m: the fast-memory budget less the
    LUT and code tile, 256 B reserved per bucket, rounded down to a
    multiple of 128 within [128, ``cap``].  The reference sizes it for a
    TPU's VMEM; the defaults are kept so that both packages pick the same
    m."""
    m = (vmem_bytes - lut_bytes - code_tile_bytes) // bytes_per_bucket
    m = max(128, min(int(m), cap))
    return (m // 128) * 128


def sample_plan(vals: torch.Tensor, k_cb: int, m: int, n_ew: int = 256,
                valid: torch.Tensor | None = None, sqrt: bool = False,
                rank: int | None = None, margin: int = 0,
                cap: int | None = None):
    """A query batch's codebook sample plan (``ops.sample_plan_batch``: one
    launch on the card): equal-depth codebooks over the ``k_cb`` smallest
    of each row of ``vals`` (B, w), ``valid`` masking lanes to +inf and
    ``sqrt`` taking squared PQ estimates to distances first; with a
    ``rank``, the bucket of each row's rank-th smallest value (plus
    ``margin``, at most ``cap``).  Returns (codebooks, tau (B,) int32 or
    None)."""
    cb, tau = ops.sample_plan_batch(vals, valid, k_cb=k_cb, m=m, n_ew=n_ew,
                                    rank=rank, sqrt=sqrt, margin=margin,
                                    cap=cap)
    return BucketCodebook(*cb), tau


def build_codebook(sample_dists: torch.Tensor, k: int, m: int,
                   n_ew: int = 256,
                   valid: torch.Tensor | None = None) -> BucketCodebook:
    """Equal-depth codebooks over the local top-k of each query's sample
    (B, w); ``valid`` masks padding lanes."""
    return sample_plan(sample_dists, k, m, n_ew, valid=valid)[0]


def build_codebook_from_topk(topk: torch.Tensor, m: int,
                             n_ew: int = 256) -> BucketCodebook:
    """Codebooks from already-selected ascending local top-k rows (B, k)
    (``kernels.ref.codebook_from_topk``'s rules: +inf clamped to the row's
    largest finite value, a 2% margin above d_max, strictly increasing
    edges)."""
    cb, _ = ops.sample_plan_batch(topk, None, k_cb=topk.shape[-1], m=m,
                                  n_ew=n_ew, presorted=True)
    return BucketCodebook(*cb)


def bucketize(cb: BucketCodebook, dists: torch.Tensor) -> torch.Tensor:
    """Eq. 6 bucket ids (B, n) of (B, n) distances; overflow bucket m."""
    return kref.bucketize_batch(dists, cb.d_min, cb.delta, cb.ew_map, cb.m)


def histogram(bucket_ids: torch.Tensor, m: int,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """(B, m+1) bucket histogram (bucket m = overflow)."""
    if valid is None:
        valid = torch.ones_like(bucket_ids, dtype=torch.bool)
    return kref.histogram_batch(bucket_ids, valid, m)


def threshold_bucket(hist: torch.Tensor, k: int):
    """Alg. 1 Update: per row, the first bucket tau with cumulative count
    >= k, and the count strictly before it.  Fewer than k candidates gives
    tau = m (the overflow id)."""
    m = hist.shape[-1] - 1
    cum = torch.cumsum(hist[:, :m].long(), dim=-1)
    tau = torch.sum(cum < k, dim=-1).clamp(max=m)
    before = torch.gather(cum, 1, (tau - 1).clamp(min=0)[:, None])[:, 0]
    n_before = torch.where(tau > 0, before, 0)
    return tau.to(torch.int32), n_before.to(torch.int32)


def relaxed_threshold(cb: BucketCodebook, tau: torch.Tensor) -> torch.Tensor:
    """Upper edge of each query's threshold bucket (B,), +inf for the
    overflow bucket: the paper's relaxed threshold."""
    inf = torch.full_like(cb.edges[:, :1], INF)
    edges = torch.cat([cb.edges, inf], dim=1)
    idx = torch.clamp(tau.long() + 1, max=cb.m + 1)
    return torch.gather(edges, 1, idx[:, None])[:, 0]


def compact_mask(mask: torch.Tensor, budget: int):
    """Stream-order positions of the first ``budget`` set lanes of each row
    of ``mask`` (B, n), sentinel n past the fill.  Returns (positions (B,
    budget) int64, ok (B, budget))."""
    b, n = mask.shape
    lane = torch.arange(n, device=mask.device)
    key = torch.where(mask, lane, n)
    out = torch.topk(key, min(budget, n), dim=-1, largest=False,
                     sorted=True).values
    if budget > n:
        out = torch.cat([out, torch.full((b, budget - n), n,
                                         device=mask.device)], dim=1)
    return out, out < n


def smallest(vals: torch.Tensor, k: int):
    """The k smallest entries of each row, ascending, ties to the lower
    position: the semantics of ``jax.lax.top_k(-vals, k)``.  ``torch.topk``
    promises no order among ties, and PQ estimates tie whenever two vectors
    share codes, so the port selects with a stable sort.  Returns (values,
    positions)."""
    s = torch.sort(vals, dim=-1, stable=True)
    return s.values[..., :k], s.indices[..., :k]


def _collect_budget(k: int, n: int, slack_buckets: int, m: int) -> int:
    # Expected threshold-bucket occupancy under equal-depth is ~k/m; slack
    # covers skew.  Clamped to n (can't select more than exists).
    per_bucket = max(k // max(m, 1), 1)
    return int(min(n, k + slack_buckets * per_bucket + 64))


def collect(cb: BucketCodebook, dists: torch.Tensor, ids: torch.Tensor,
            bucket_ids: torch.Tensor, k: int,
            valid: torch.Tensor | None = None,
            hist: torch.Tensor | None = None, slack_buckets: int = 2):
    """Alg. 1 Collect for one query: (n,) distances, ids, bucket ids and
    validity, the (m+1,) histogram (built here when None).  Lanes at or
    below the threshold bucket are compacted into a (k + slack)-wide buffer
    and the k smallest kept.  The reference's ``lax.cond`` escape hatch (the
    threshold in the overflow bucket, or more survivors than the buffer
    holds) is one ``.item()`` host decision: then one full-width
    selection.  Returns (dists (k,) ascending, ids (k,))."""
    m = cb.m
    n = dists.shape[0]
    if valid is None:
        valid = torch.ones(dists.shape, dtype=torch.bool, device=dists.device)
    if hist is None:
        hist = histogram(bucket_ids[None], m, valid[None])[0]
    tau = threshold_bucket(hist[None], k)[0][0]
    survive = valid & (bucket_ids <= tau)
    budget = _collect_budget(k, n, slack_buckets, m)
    if bool(((tau >= m) | (survive.sum() > budget)).item()):
        vals, order = smallest(torch.where(valid, dists, INF), k)
        return vals, ids[order]
    idx, in_budget = compact_mask(survive[None], budget)
    safe = idx[0].clamp(max=n - 1)
    cd = torch.where(in_budget[0], dists[safe], INF)
    ci = torch.where(in_budget[0], ids[safe], -1)
    vals, order = smallest(cd, k)
    return vals, ci[order]


def topk_oracle(dists: torch.Tensor, ids: torch.Tensor, k: int,
                valid: torch.Tensor | None = None):
    """Reference collector: the full top-k of one query's lanes (ties to
    the lower position)."""
    if valid is not None:
        dists = torch.where(valid, dists, INF)
    vals, idx = smallest(dists, k)
    return vals, ids[idx]
