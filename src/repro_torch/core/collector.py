"""Top-k collectors: the paper's Exp-3 contenders over a stream of
per-cluster candidate tiles, and their batched forms over a shared stream.

The port of the JAX package's ``core/collector.py``.  The single-query
collectors take a ``StreamInput`` of (n_tiles, tile) estimated distances,
global ids and validity and return the exact top-k (distances ascending,
ids):

  * ``bbc``    — the result buffer (Alg. 1): a codebook from the first
                 tiles, one bucketize + histogram pass (``ops.bucket_hist``),
                 one selection in the threshold bucket.
  * ``bbc_streamed`` — the tile-serial form (per-tile threshold update).
  * ``topk``   — "Heap": a running top-k carried across the tiles.
  * ``topk_flat`` — one flat selection over the whole stream.
  * ``sorted`` — "Sorted": a full sort.
  * ``lazy``   — "Lazy": a threshold-filtered append buffer with a partial
                 selection whenever it would overflow.

The batched forms (``bbc_collect_batch``, ``collect_batch``,
``topk_collect_batch``) take (B, n) estimates over one shared stream.  The
reference's ``lax.cond`` branches become Python decisions on one host read
(a host sync per call): the single-query ``bbc_collect`` branches on it,
``collect_batch`` sizes its compaction buffer by it.  ``lazy_collect``
selects both branches' results with ``torch.where``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import spans
from repro_torch.core import buffer as rb
from repro_torch.kernels import ops

INF = float("inf")


class StreamInput(NamedTuple):
    """Tiled candidate stream: estimated distances, global ids, validity."""
    dists: torch.Tensor   # (n_tiles, tile)
    ids: torch.Tensor     # (n_tiles, tile) global ids, -1 on padding
    valid: torch.Tensor   # (n_tiles, tile) bool


def _flatten(s: StreamInput) -> StreamInput:
    return StreamInput(*(x.reshape(-1) for x in s))


def _sample_codebook(s: StreamInput, k: int, m: int, sample_tiles: int,
                     n_ew: int) -> rb.BucketCodebook:
    """A batch-1 codebook over the first ``sample_tiles`` tiles (IVF scans
    clusters nearest first, so this is the paper's nearest-cluster
    sample)."""
    st = min(sample_tiles, s.dists.shape[0])
    sample = torch.where(s.valid[:st], s.dists[:st], INF).reshape(1, -1)
    return rb.build_codebook(sample, k=min(k, sample.shape[1]), m=m,
                             n_ew=n_ew)


def bbc_collect(s: StreamInput, k: int, m: int = 128, sample_tiles: int = 4,
                n_ew: int = 256):
    """Result-buffer collection of one query: the codebook from the first
    tiles, one bucketize + histogram pass over the whole stream through the
    bucket_hist kernel (``ops.bucket_hist``), then ``buffer.collect``."""
    cb = _sample_codebook(s, k, m, sample_tiles, n_ew)
    flat = _flatten(s)
    bucket, hist = ops.bucket_hist(flat.dists, flat.valid, cb.d_min,
                                   cb.delta, cb.ew_map, m)
    return rb.collect(cb, flat.dists, flat.ids, bucket, k, flat.valid,
                      hist=hist)


def bbc_collect_streamed(s: StreamInput, k: int, m: int = 128,
                         sample_tiles: int = 4, n_ew: int = 256):
    """Tile-serial form of ``bbc_collect`` (the paper's streaming
    formulation: a threshold update per tile, relaxed-threshold masking).
    An Exp-3 contender; its result is ``bbc_collect``'s."""
    cb = _sample_codebook(s, k, m, sample_tiles, n_ew)
    hist = torch.zeros(1, m + 1, dtype=torch.int32, device=s.dists.device)
    for d, v in zip(s.dists, s.valid):
        tau, _ = rb.threshold_bucket(hist, k)
        b = rb.bucketize(cb, d[None])
        hist = hist + rb.histogram(b, m, v[None] & (b <= tau[:, None]))
    flat = _flatten(s)
    bucket = rb.bucketize(cb, flat.dists[None])[0]
    return rb.collect(cb, flat.dists, flat.ids, bucket, k, flat.valid)


def topk_collect(s: StreamInput, k: int):
    """Single-pass exact top-k: one flat selection over the whole stream
    (ties to the lower stream position)."""
    flat = _flatten(s)
    return rb.topk_oracle(flat.dists, flat.ids, k, flat.valid)


def topk_collect_streamed(s: StreamInput, k: int):
    """"Heap" analogue: the running exact top-k carried across tiles."""
    cd = torch.full((k,), INF, dtype=s.dists.dtype, device=s.dists.device)
    ci = torch.full((k,), -1, dtype=s.ids.dtype, device=s.ids.device)
    for d, i, v in zip(s.dists, s.ids, s.valid):
        alld = torch.cat([cd, torch.where(v, d, INF)])
        cd, idx = rb.smallest(alld, k)
        ci = torch.cat([ci, i])[idx]
    return cd, ci


def sorted_collect(s: StreamInput, k: int):
    """"Sorted" analogue: a full (stable) sort of every scanned candidate."""
    flat = _flatten(s)
    d = torch.where(flat.valid, flat.dists, INF)
    order = torch.argsort(d, stable=True)[:k]
    return d[order], flat.ids[order]


def lazy_collect(s: StreamInput, k: int, buffer_factor: int = 2):
    """"Lazy" analogue: candidates under the running threshold go into a
    ``buffer_factor * k`` linear buffer; when a tile would overflow it, a
    partial selection shrinks the buffer back to k first and tightens the
    threshold.  The reference's per-tile ``lax.cond`` is a ``torch.where``
    over both branches' results, so the loop never waits for the card."""
    tile = s.dists.shape[1]
    cap = max(buffer_factor * k, k + tile)
    dev = s.dists.device
    bd = torch.full((cap,), INF, dtype=s.dists.dtype, device=dev)
    bi = torch.full((cap,), -1, dtype=s.ids.dtype, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    thresh = torch.full((), INF, dtype=s.dists.dtype, device=dev)
    for d, i, v in zip(s.dists, s.ids, s.valid):
        would = count + torch.sum(v & (d < thresh))
        shrink = would > cap
        sv, si = rb.smallest(bd, k)
        sd = torch.cat([sv, torch.full((cap - k,), INF, dtype=bd.dtype,
                                       device=dev)])
        sid = torch.cat([bi[si], torch.full((cap - k,), -1, dtype=bi.dtype,
                                            device=dev)])
        bd = torch.where(shrink, sd, bd)
        bi = torch.where(shrink, sid, bi)
        count = torch.where(shrink, k, count)
        thresh = torch.where(shrink, sv[k - 1], thresh)
        keep = v & (d < thresh)
        pos = count + torch.cumsum(keep.to(torch.int64), 0) - 1
        slot = torch.where(keep & (pos < cap), pos, cap)   # cap: spill slot
        bd = torch.cat([bd, bd.new_full((1,), INF)]).scatter(0, slot, d)[:cap]
        bi = torch.cat([bi, bi.new_full((1,), -1)]).scatter(0, slot, i)[:cap]
        count = torch.clamp(count + torch.sum(keep), max=cap)
    vals, idx = rb.smallest(bd, k)
    return vals, bi[idx]


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
    """Batched Alg. 1 Collect over bucket ids (B, n) and the histograms of
    their valid lanes (B, m+1): ``survivors_batch`` compacts each query's
    survivors in stream order, and ``smallest_survivors`` keeps the k
    smallest.  Returns (dists (B, k) ascending, ids (B, k))."""
    with spans.span("collect"):
        pos, ok, widened = survivors_batch(bucket, valid, hist, k, m,
                                           slack_buckets)
        safe = pos.long().clamp(max=dists.shape[1] - 1)
        return smallest_survivors(torch.gather(dists, 1, safe), ids[safe],
                                  ok, k, widened)


def survivors_batch(bucket, valid, hist, k: int, m: int,
                    slack_buckets: int = 2):
    """The survivors of ``collect_batch``, the valid lanes at or below each
    query's threshold bucket, compacted in stream order by one launch of
    ``ops.spec_compact_batch``.

    The buffer is (k + slack) wide.  Where the reference overflows it (a
    query with more survivors, or whose threshold is the overflow bucket,
    where every valid lane survives) and selects over every lane instead,
    the buffer widens to the widest row's count, read from the histograms
    in the one host read: a valid lane past the threshold bucket lies above
    every survivor, so the k kept are the full-width selection's.  Returns
    (positions (B, w) int32, ok (B, w), widened)."""
    n = bucket.shape[1]
    tau, _ = rb.threshold_bucket(hist, k)
    n_surv = torch.gather(torch.cumsum(hist, 1, dtype=torch.int32), 1,
                          tau.long()[:, None])[:, 0]
    reads = torch.stack([n_surv, tau]).amax(dim=1)
    with spans.span("wait.collect_overflow"):
        most, top_tau = reads.tolist()
    budget = rb._collect_budget(k, n, slack_buckets, m)
    width = budget if most <= budget else min(n, -(-most // 128) * 128)
    spans.count("collect.widened", int(most > budget))
    pos, ok, _ = ops.spec_compact_batch(bucket, valid, tau, width)
    return pos, ok, top_tau >= m or most > budget


def smallest_survivors(vals, ids, ok, k: int, widened: bool):
    """The k smallest of the survivors' values ``vals`` (B, w) where ``ok``,
    with their ``ids`` (B, w).  Where the buffer was widened, the ids take
    the full-width selection's: -1 past the finite values (a query with
    fewer than k valid lanes fills with the buffer's +inf sentinels, as the
    full width fills with its invalid lanes)."""
    vals, order = rb.smallest(torch.where(ok, vals, INF), k)
    out = torch.gather(torch.where(ok, ids, -1), 1, order)
    if widened:
        out = torch.where(torch.isfinite(vals), out, -1)
    return vals, out


def topk_collect_batch(dists, ids, valid, k: int):
    """Batched flat top-k over the shared stream.  Under-filled slots come
    back as (+inf, -1)."""
    d = torch.where(valid, dists, INF)
    vals, order = rb.smallest(d, k)
    return vals, torch.where(torch.isfinite(vals), ids[order], -1)


COLLECTORS = {
    "bbc": bbc_collect,
    "bbc_streamed": bbc_collect_streamed,
    "topk": topk_collect_streamed,
    "topk_flat": topk_collect,
    "sorted": sorted_collect,
    "lazy": lazy_collect,
}


def collector_stats(name: str, k: int, m: int, n: int, tile: int) -> dict:
    """Structural cost model of each collector: bytes of cross-tile state
    and selection widths (the reference's figures, device-independent)."""
    if name in ("bbc", "bbc_streamed"):
        return {"cross_tile_state_bytes": 4 * (m + 1),
                "final_selection_width": min(n, k + 2 * max(k // m, 1) + 64),
                "per_tile_select_width": 0}
    if name == "topk":
        return {"cross_tile_state_bytes": 8 * k,
                "final_selection_width": k,
                "per_tile_select_width": k + tile}
    if name in ("topk_flat", "sorted"):
        return {"cross_tile_state_bytes": 8 * n,
                "final_selection_width": n,
                "per_tile_select_width": 0}
    if name == "lazy":
        return {"cross_tile_state_bytes": 8 * 2 * k,
                "final_selection_width": 2 * k,
                "per_tile_select_width": 2 * k}
    raise ValueError(name)
