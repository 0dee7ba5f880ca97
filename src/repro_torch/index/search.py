"""Batched IVF+PQ searchers, with and without the BBC collector.

The port of the batched IVF+PQ half of the JAX package's ``index/search.py``:
one routing pass per batch, one shared gather of the candidate stream in
``ivf.FlatLayout`` order, per-query lane masks, and the batched estimate /
bucketize / histogram / re-rank through ``kernels.ops`` (CUDA kernels for
CUDA tensors, their plain versions on the CPU).

  ivf_pq_search_batch(use_bbc=False)             -> IVF+PQ (top n_cand, re-rank)
  ivf_pq_search_batch(use_bbc=True, fused=True)  -> IVF+PQ+BBC, Alg. 4 early
                                                    re-rank in the fused scan
  ivf_pq_search_batch(use_bbc=True, fused=False) -> IVF+PQ+BBC, two passes
  ... pred_state=state                           -> the cross-batch
                                                    predictive form

Every selection breaks ties the reference's way (``buffer.smallest``, and
(value, global id) in ``_topk_est_id``); ``torch.topk`` is never used where
ties decide the set.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import buffer as rb
from repro_torch.core import collector as col
from repro_torch.core import rerank
from repro_torch.index import ivf as ivf_mod
from repro_torch.index import pq as pq_mod
from repro_torch.kernels import ops
from repro_torch.kernels.platform import on_cuda, resolve_device

INF = float("inf")
EXACT_CHUNK = 1 << 16     # (query, slot) entries per exact-distance gather


class PQIndex(NamedTuple):
    """IVF + PQ index bundle (codes plus fp32 vectors for exact re-rank)."""
    ivf: ivf_mod.IVFIndex
    pq: pq_mod.PQCodebook
    codes: torch.Tensor    # (N, M) uint8
    vectors: torch.Tensor  # (N, d) fp32


class SearchResult(NamedTuple):
    """Top-k result with per-query (B,) re-rank work counters."""
    dists: torch.Tensor
    ids: torch.Tensor
    n_reranked: torch.Tensor     # exact distance computations spent
    n_second_pass: torch.Tensor  # re-rank gathers not covered inline


def index_to(index: PQIndex, device) -> PQIndex:
    """The same index with every tensor on ``device``."""
    ivf = index.ivf
    return PQIndex(
        ivf=ivf_mod.IVFIndex(*(t.to(device) for t in ivf)),
        pq=pq_mod.PQCodebook(index.pq.centroids.to(device)),
        codes=index.codes.to(device), vectors=index.vectors.to(device))


def build_pq_index(x, n_clusters: int, n_sub: int | None = None,
                   n_bits: int = 4, n_iter: int = 10, seed: int = 0,
                   device=None) -> PQIndex:
    """IVF k-means + PQ training and encoding on ``device`` (the card unless
    ``device="cpu"``), seeded through a ``torch.Generator``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    d = x.shape[1]
    n_sub = n_sub or d // 4          # paper: M = d/4, 4 bits
    gen = torch.Generator().manual_seed(seed)
    index = ivf_mod.build(x, n_clusters, n_iter, generator=gen)
    cb = pq_mod.train(x, n_sub, n_bits, n_iter, generator=gen)
    return PQIndex(ivf=index, pq=cb, codes=pq_mod.encode(cb, x), vectors=x)


# --------------------------------------------------------------------------
# Shared helpers
# --------------------------------------------------------------------------

def _exact_dists(vectors: torch.Tensor, ids: torch.Tensor,
                 q: torch.Tensor) -> torch.Tensor:
    """Exact distances of rows ``ids`` (-1 padding allowed; callers mask) to
    the matching rows of ``q`` (broadcast), as the direct sum of squared
    differences (see ``kernels.ref.l2_exact_batch``)."""
    diff = vectors[ids.clamp(min=0)] - q
    return torch.sqrt(torch.sum(diff * diff, -1))


def _exact_dists_rows(vectors: torch.Tensor, ids: torch.Tensor,
                      qs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Exact distances (B, w) for per-query id rows, +inf off ``mask``.

    Only the masked (query, slot) entries are gathered, ``EXACT_CHUNK`` rows
    at a time, so no (B, w, d) block is ever materialized."""
    out = torch.full(ids.shape, INF, dtype=qs.dtype, device=qs.device)
    rows, cols = mask.nonzero(as_tuple=True)
    for i in range(0, rows.shape[0], EXACT_CHUNK):
        r, c = rows[i:i + EXACT_CHUNK], cols[i:i + EXACT_CHUNK]
        out[r, c] = _exact_dists(vectors, ids[r, c], qs[r])
    return out


def _routing(ivf: ivf_mod.IVFIndex, layout: ivf_mod.FlatLayout,
             qs: torch.Tensor, n_probe: int):
    """Probed clusters (B, n_probe), lane masks (B, n_flat), and the (B, C)
    squared query-centroid distances."""
    probed, d2 = ivf_mod.route_batch_d2(ivf, qs, n_probe)
    lane_valid = ivf_mod.probe_mask(layout, probed, ivf.n_clusters)
    return probed, lane_valid, d2


def _resolve_pred_count(pred_count: int | None, k: int,
                        n_cand: int | None = None) -> int:
    """Default predictive re-rank pool target, max(2.5k, k + 1024), clamped
    to [k, n_cand]."""
    if pred_count is None:
        pred_count = max(5 * k // 2, k + 1024)
    pred_count = max(pred_count, k)
    if n_cand is not None:
        pred_count = min(pred_count, n_cand)
    return pred_count


def _pred_budget(count: int, n: int) -> int:
    """Selection width over the predictive survivor pool."""
    b = count + max(count // 2, 256)
    return int(min(n, ((b + 127) // 128) * 128))


def _pq_sample_est(layout: ivf_mod.FlatLayout, probed: torch.Tensor,
                   stream_codes: torch.Tensor, luts: torch.Tensor, st: int,
                   cap: int) -> torch.Tensor:
    """Per-query ADC estimates (B, st*cap) over the nearest ``st`` probed
    clusters: the codebook sample.  Summed in ascending m like the kernels,
    so the sample's estimates equal the scan's for the same lanes."""
    spos, sok = ivf_mod.tile_positions(layout, probed[:, :st], cap)
    sc = stream_codes[spos]                                  # (B, w, M)
    acc = torch.gather(luts[:, 0, :], 1, sc[:, :, 0].long())
    for m in range(1, sc.shape[2]):
        acc = acc + torch.gather(luts[:, m, :], 1, sc[:, :, m].long())
    return torch.where(sok, torch.sqrt(torch.clamp(acc, min=0.0)), INF)


def _topk_est_id(est: torch.Tensor, gids: torch.Tensor, width: int):
    """The ``width`` smallest of each row of ``est`` with ties broken by
    the smallest global id ``gids`` (n,): a stable sort by value over the
    lanes in id order.  The kept set is the reference's (value, global id)
    cut.  Returns (values ascending, stream positions)."""
    perm = torch.argsort(gids, stable=True)
    vals, idx = rb.smallest(est[:, perm], width)
    return vals, perm[idx]


def _predictive_select(est, bucket, hist, lane_valid, tau_pred, count: int,
                       budget: int, gids):
    """Survivors under max(tau_pred, tau_true-at-count), picked by estimate
    into ``budget`` slots.  Returns (sel_est ascending (B, budget), sel_pos,
    sel_ok, tau_true)."""
    tau_true, _ = rb.threshold_bucket(hist, count)
    tau_used = torch.maximum(tau_pred, tau_true)
    masked = torch.where(lane_valid & (bucket <= tau_used[:, None]), est, INF)
    sel, sel_pos = _topk_est_id(masked, gids, budget)
    return sel, sel_pos, torch.isfinite(sel), tau_true


def _sqrt_est(est2: torch.Tensor, lane_valid: torch.Tensor) -> torch.Tensor:
    return torch.where(lane_valid, torch.sqrt(torch.clamp(est2, min=0.0)),
                       INF)


# --------------------------------------------------------------------------
# Batched IVF+PQ
# --------------------------------------------------------------------------

def ivf_pq_search_batch(index: PQIndex, qs: torch.Tensor,
                        layout: ivf_mod.FlatLayout, k: int, n_probe: int,
                        n_cand: int, use_bbc: bool = False, m: int = 128,
                        fused: bool | None = None,
                        pred_state: rerank.PredictorState | None = None,
                        pred_count: int | None = None):
    """Batched IVF+PQ (with or without BBC) over a (B, d) query batch.

    ``fused`` (default: True for CUDA tensors, False on the CPU) runs the
    BBC path through one fused scan that exact-ranks the predicted lanes
    inline; the second pass covers only the stragglers.  The unfused form
    selects the top n_cand by estimate and re-ranks the whole selection.
    Both give the same ids; only the counters differ.

    With ``pred_state`` the n_cand cut becomes the predictive pool and the
    call returns ``(SearchResult, new_state)``.
    """
    if fused is None:
        fused = on_cuda(qs.device)
    ivf = index.ivf
    b = qs.shape[0]
    order = layout.order
    probed, lane_valid, _ = _routing(ivf, layout, qs, n_probe)
    stream_codes = index.codes[order]                         # shared gather
    luts = pq_mod.adc_table(index.pq, qs)

    if pred_state is not None:
        if not use_bbc:
            raise ValueError("predictive search requires use_bbc=True")
        return _ivf_pq_predictive_batch(
            index, qs, layout, probed, lane_valid, stream_codes, luts, k,
            n_probe, n_cand, m, fused, pred_state, pred_count)

    n_flat = layout.n_flat
    dense_rerank = 4 * n_cand >= n_flat

    if not use_bbc:
        est = _sqrt_est(ops.pq_adc_batch(stream_codes, luts), lane_valid)
        sel_est, sel_pos = rb.smallest(est, n_cand)
        ci = torch.where(torch.isfinite(sel_est), order[sel_pos], -1)
        if dense_rerank:
            exact_all = ops.l2_exact_batch(index.vectors[order], qs)
            ex = torch.gather(exact_all, 1, sel_pos)
        else:
            ex = _exact_dists_rows(index.vectors, ci, qs, mask=ci >= 0)
        ex = torch.where(ci >= 0, ex, INF)
        vals, pick = rb.smallest(ex, k)
        counts = torch.full((b,), n_cand, dtype=torch.int32,
                            device=qs.device)
        return SearchResult(vals, torch.gather(ci, 1, pick), counts, counts)

    # ---- BBC path (Alg. 4, batched) ---------------------------------------
    if fused:
        # codebooks + tau_pred from the nearest-cluster sample, then one
        # fused pass (est + bucket + hist + early exact), selection from the
        # histogram, and a second pass for the selected-but-not-predicted
        st = min(4, n_probe)
        sample_est = _pq_sample_est(layout, probed, stream_codes, luts, st,
                                    ivf.cap)
        plans = rerank.early_rerank_plan(
            sample_est, n_cand=n_cand, n_sample=sample_est.shape[1],
            n_total=n_probe * ivf.cap, m=m)
        est, bucket, hist, early, nmiss = ops.fused_scan_batch(
            stream_codes, index.vectors[order], lane_valid, luts, qs,
            plans.cb.d_min, plans.cb.delta, plans.cb.ew_map, m,
            plans.tau_pred)
        positions = torch.arange(n_flat, device=qs.device)
        _, sel_pos = col.collect_batch(est, positions, lane_valid, bucket,
                                       hist, n_cand, m)
        safe_pos = sel_pos.clamp(min=0)
        sel_ids = torch.where(sel_pos >= 0, order[safe_pos], -1)
        e_at_sel = torch.gather(early, 1, safe_pos)
        have = torch.isfinite(e_at_sel) & (sel_pos >= 0)
        n_early = (lane_valid.sum(1) - nmiss).to(torch.int32)
    else:
        # top n_cand by estimate (boundary ties by global id), then one exact
        # pass over the whole selection
        est = _sqrt_est(ops.pq_adc_batch(stream_codes, luts), lane_valid)
        sel_est, sel_pos = _topk_est_id(est, order, n_cand)
        sel_ids = torch.where(torch.isfinite(sel_est), order[sel_pos], -1)
        e_at_sel = torch.full(sel_pos.shape, INF, device=qs.device)
        have = torch.zeros(sel_pos.shape, dtype=torch.bool, device=qs.device)
        n_early = torch.zeros(b, dtype=torch.int32, device=qs.device)

    miss = ~have & (sel_ids >= 0)
    if not fused and dense_rerank:
        # the whole selection misses: one shared pass over the stream beats
        # n_cand per-row gathers
        exact_all = ops.l2_exact_batch(index.vectors[order], qs)
        miss_d = torch.gather(exact_all, 1, sel_pos.clamp(min=0))
    else:
        miss_d = _exact_dists_rows(index.vectors, sel_ids, qs, mask=miss)
    ex = torch.where(have, e_at_sel, torch.where(miss, miss_d, INF))
    second = miss.sum(1).to(torch.int32)
    vals, pick = rb.smallest(ex, k)
    return SearchResult(vals, torch.gather(sel_ids, 1, pick),
                        n_early + second, second)


def _ivf_pq_predictive_batch(index, qs, layout, probed, lane_valid,
                             stream_codes, luts, k, n_probe, n_cand, m,
                             fused, pred_state, pred_count):
    """Predictive early-exact IVF+PQ: the re-rank pool is {bucket <=
    max(tau_pred, tau_true-at-pred_count)} instead of the top n_cand.  On
    the fused path the lanes under tau_pred were exact-ranked inline; the
    fallback pass re-ranks only survivors the prediction missed.  The
    codebooks are built exactly like the static fused path's, so bucket
    indices stay comparable across batches for the EMA."""
    ivf = index.ivf
    b = qs.shape[0]
    order = layout.order
    n_flat = layout.n_flat
    count = _resolve_pred_count(pred_count, k, n_cand)
    st = min(4, n_probe)
    sample_est = _pq_sample_est(layout, probed, stream_codes, luts, st,
                                ivf.cap)
    cbs = rb.build_codebook(sample_est, k=min(n_cand, sample_est.shape[1]),
                            m=m)
    tau_pred = torch.full((b,), rerank.predict_tau(pred_state, count),
                          dtype=torch.int32, device=qs.device)

    if fused:
        est, bucket, hist, early, nmiss = ops.fused_scan_batch(
            stream_codes, index.vectors[order], lane_valid, luts, qs,
            cbs.d_min, cbs.delta, cbs.ew_map, m, tau_pred)
        n_early = (lane_valid.sum(1) - nmiss).to(torch.int32)
    else:
        est = _sqrt_est(ops.pq_adc_batch(stream_codes, luts), lane_valid)
        bucket, hist = ops.bucket_hist_batch(est, lane_valid, cbs.d_min,
                                             cbs.delta, cbs.ew_map, m)
        n_early = torch.zeros(b, dtype=torch.int32, device=qs.device)

    # survivors form an estimate prefix, so a budget <= n_cand keeps the
    # pool a subset of the static n_cand cut
    budget = min(_pred_budget(count, n_flat), n_cand)
    _, sel_pos, sel_ok, tau_true = _predictive_select(
        est, bucket, hist, lane_valid, tau_pred, count, budget, order)
    sel_ids = torch.where(sel_ok, order[sel_pos], -1)

    if fused:
        e_at_sel = torch.gather(early, 1, sel_pos)
        fb = rerank.predicted_fallback_mask(bucket, lane_valid, tau_pred,
                                            tau_true)
        miss = torch.gather(fb, 1, sel_pos) & sel_ok
        have = sel_ok & ~miss
    else:
        e_at_sel = torch.full(sel_pos.shape, INF, device=qs.device)
        have = torch.zeros(sel_pos.shape, dtype=torch.bool, device=qs.device)
        miss = sel_ok
    if not fused and 4 * budget >= n_flat:
        exact_all = ops.l2_exact_batch(index.vectors[order], qs)
        miss_d = torch.gather(exact_all, 1, sel_pos)
    else:
        miss_d = _exact_dists_rows(index.vectors, sel_ids, qs, mask=miss)
    ex = torch.where(have, e_at_sel, torch.where(miss, miss_d, INF))
    second = miss.sum(1).to(torch.int32)
    vals, pick = rb.smallest(ex, k)
    res = SearchResult(vals, torch.gather(sel_ids, 1, pick),
                       n_early + second, second)
    return res, rerank.predictor_update(pred_state, hist)
