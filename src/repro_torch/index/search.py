"""IVF / IVF+PQ / IVF+RaBitQ searchers, each with and without the BBC
collector: for one query, batched, and mesh-sharded.

The port of the JAX package's ``index/search.py``.  The batched searchers
run one routing pass per batch, one shared candidate stream in
``ivf.FlatLayout`` order, per-query lane masks, and the batched estimate /
bucketize / histogram / re-rank through ``kernels.ops`` (CUDA kernels for
CUDA tensors, their plain versions on the CPU); the single-query searchers
run the same kernels at one query.

  ivf_search_batch(use_bbc=...)                  -> IVF (exact in-scan)
  ivf_pq_search_batch(use_bbc=False)             -> IVF+PQ (top n_cand, re-rank)
  ivf_pq_search_batch(use_bbc=True, fused=True)  -> IVF+PQ+BBC, Alg. 4 early
                                                    re-rank in the fused scan
  ivf_pq_search_batch(use_bbc=True, fused=False) -> IVF+PQ+BBC, two passes
  ivf_rabitq_search_batch(use_bbc=False)         -> IVF+RaBitQ (threshold
                                                    re-rank per probed tile)
  ivf_rabitq_search_batch(use_bbc=True)          -> IVF+RaBitQ+BBC, Alg. 3 in
                                                    the bound-fused scan
  ivf_rabitq_search_batch(..., fused=False)      -> IVF+RaBitQ+BBC, two passes
  ... pred_state=state                           -> the cross-batch
                                                    predictive form
  ivf_search / ivf_pq_search / ivf_rabitq_search -> the same methods for
                                                    one (d,) query over the
                                                    padded member table
  ivf_search_sharded / ivf_pq_search_sharded / ivf_rabitq_search_sharded
                                                 -> the same methods over a
                                                    corpus split row-wise
                                                    across the ranks of a
                                                    ``distributed.ShardMesh``

Where the reference has a Pallas-kernel branch and a composed CPU branch
(the RaBitQ fused path, the IVF BBC collection), the port runs the kernel
branch on both devices, with the plain versions on the CPU: the two
devices do the same work and the counters mean the same on both.

Every selection breaks ties the reference's way (``buffer.smallest``, and
(value, global id) in ``_topk_est_id``); ``torch.topk`` is never used where
ties decide the set.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import spans
from repro_torch.core import buffer as rb
from repro_torch.core import collector as col
from repro_torch.core import distributed as dist
from repro_torch.core import numerics
from repro_torch.core import rerank
from repro_torch.index import ivf as ivf_mod
from repro_torch.index import kmeans as km
from repro_torch.index import pq as pq_mod
from repro_torch.index import rabitq as rq_mod
from repro_torch.kernels import ops
from repro_torch.kernels.platform import on_cuda, resolve_device

INF = float("inf")
SAMPLE_TILES = 4          # nearest probed clusters of a query's codebook
                          # sample (all probed ones where n_probe is less)


class PQIndex(NamedTuple):
    """IVF + PQ index bundle (codes plus fp32 vectors for exact re-rank)."""
    ivf: ivf_mod.IVFIndex
    pq: pq_mod.PQCodebook
    codes: torch.Tensor    # (N, M) uint8
    vectors: torch.Tensor  # (N, d) fp32


class RabitqIndex(NamedTuple):
    """IVF + RaBitQ index bundle (codes plus fp32 vectors for exact
    re-rank)."""
    ivf: ivf_mod.IVFIndex
    rq: rq_mod.RabitqCodes
    vectors: torch.Tensor  # (N, d) fp32


class Stream(NamedTuple):
    """The corpus and the method's codes in ``ivf.FlatLayout`` order (a
    device's whole layout, or one rank's block), with the small tensors
    the batched and sharded searchers need beside them; built once per
    placed index by ``build_stream``.  Fields a method does not use are
    None.  RaBitQ's codes stay int8 (the reference keeps an fp32 copy);
    ``cl`` is each lane's cluster clamped to a real one; ``s2`` is the
    centroid correction the reference recomputes on every call."""
    vectors: torch.Tensor                 # (n_flat, d) fp32
    centroids: torch.Tensor               # (C, d) the IVF centroids
    codes: torch.Tensor | None = None     # PQ (n_flat, M) uint8, RaBitQ
                                          # (n_flat, d) int8 +-1
    pq: pq_mod.PQCodebook | None = None   # PQ
    rot: torch.Tensor | None = None       # RaBitQ: (d, d) rotation
    norm_o: torch.Tensor | None = None    # RaBitQ: (n_flat,)
    f_o: torch.Tensor | None = None       # RaBitQ: (n_flat,)
    cl: torch.Tensor | None = None        # RaBitQ: (n_flat,) int32
    s2: torch.Tensor | None = None        # RaBitQ: (n_flat,)


class SearchResult(NamedTuple):
    """Top-k result with per-query (B,) re-rank work counters."""
    dists: torch.Tensor
    ids: torch.Tensor
    n_reranked: torch.Tensor     # exact distance computations spent
    n_second_pass: torch.Tensor  # re-rank gathers not covered inline


def index_to(index, device):
    """The same index (``PQIndex``, ``RabitqIndex`` or ``IVFIndex``) with
    every tensor on ``device``."""
    if isinstance(index, ivf_mod.IVFIndex):
        return ivf_mod.IVFIndex(*(t.to(device) for t in index))
    ivf = index_to(index.ivf, device)
    if isinstance(index, RabitqIndex):
        return RabitqIndex(
            ivf=ivf, rq=rq_mod.RabitqCodes(*(t.to(device) for t in index.rq)),
            vectors=index.vectors.to(device))
    return PQIndex(
        ivf=ivf, pq=pq_mod.PQCodebook(index.pq.centroids.to(device)),
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


def build_rabitq_index(x, n_clusters: int, n_iter: int = 10, seed: int = 0,
                       device=None) -> RabitqIndex:
    """IVF k-means, then RaBitQ codes against the centroids, on ``device``.
    As in the reference, the codes' assignment is a separate norm-identity
    argmin over the final centroids (``kmeans.assign``), not the IVF
    member table; the rotation is drawn from the same seeded generator."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    gen = torch.Generator().manual_seed(seed)
    index = ivf_mod.build(x, n_clusters, n_iter, generator=gen)
    assignment = km.assign(x, index.centroids)
    rot = rq_mod.random_rotation(gen, x.shape[1]).to(dev)
    rq = rq_mod.encode(x, index.centroids, assignment, rot)
    return RabitqIndex(ivf=index, rq=rq, vectors=x)


def build_stream(index, layout: ivf_mod.FlatLayout,
                 vectors: torch.Tensor | None = None) -> Stream:
    """The ``Stream`` of ``index`` (an ``IVFIndex`` with its corpus
    ``vectors``, a ``PQIndex`` or a ``RabitqIndex``) in the order of
    ``layout``, on the layout's device: each tensor is gathered where it
    lives, then moved.  The one place the port puts a corpus into stream
    order.  RaBitQ's ``s2`` is summed in a fixed order, so a CPU and a
    card build give the same bits."""
    dev = layout.order.device

    def take(t):
        return t[layout.order.to(t.device)].to(dev)

    if isinstance(index, ivf_mod.IVFIndex):
        return Stream(vectors=take(vectors), centroids=index.centroids.to(dev))
    ivf = index.ivf
    out = Stream(vectors=take(index.vectors), centroids=ivf.centroids.to(dev))
    if isinstance(index, PQIndex):
        return out._replace(codes=take(index.codes), pq=pq_mod.PQCodebook(
            index.pq.centroids.to(dev)))
    rq = index.rq
    codes = rq.codes[layout.order.to(rq.codes.device)]
    cl = torch.clamp(layout.cluster_of.to(rq.codes.device),
                     max=ivf.n_clusters - 1).to(torch.int32)
    s2 = numerics.rabitq_s2(codes, numerics.rotate(ivf.centroids, rq.rot), cl)
    return out._replace(codes=codes.to(dev), rot=rq.rot.to(dev),
                        norm_o=take(rq.norm_o), f_o=take(rq.f_o),
                        cl=cl.to(dev), s2=s2.to(dev))


# --------------------------------------------------------------------------
# Shared helpers
# --------------------------------------------------------------------------

def _exact_dists_rows(vectors: torch.Tensor, ids: torch.Tensor,
                      qs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Exact distances (B, w) for per-query id rows, +inf off ``mask``:
    ``ops.l2_gather_rows``, one kernel on the card, which reads each masked
    (query, slot) entry's row once and adds its squares in
    ``numerics.ordered_sum``'s order, so the CPU's chunked plain version
    and the card give the same bits."""
    return ops.l2_gather_rows(vectors, ids.long(), qs.contiguous(),
                              mask.contiguous())


def _routing(src, layout: ivf_mod.FlatLayout, qs: torch.Tensor,
             n_probe: int, live: torch.Tensor | None = None):
    """Probed clusters (B, n_probe), lane masks (B, n_flat) over ``layout``
    (a device's whole layout or one rank's block: the routing is the same
    on every rank), and the (B, C) squared query-centroid distances.
    ``src`` is the ``IVFIndex`` or a ``Stream``: either carries the
    centroids.  ``live`` (n_flat,), the tombstone mask, is ANDed into the
    lane masks: a dead lane is an unprobed one.  The masks are
    ``ops.probe_mask_batch``, one kernel on the card, with the bits of
    ``ivf.probe_mask``."""
    probed, d2 = ivf_mod.route_batch_centroids(src.centroids, qs, n_probe)
    lane_valid = ops.probe_mask_batch(layout.cluster_of, probed,
                                      src.centroids.shape[0], live)
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


def _pq_sample_adc(layout: ivf_mod.FlatLayout, probed: torch.Tensor,
                   stream_codes: torch.Tensor, luts: torch.Tensor, st: int,
                   cap: int):
    """The codebook sample's squared ADC estimates (B, st*cap) over the
    nearest ``st`` probed clusters, +inf off the sample, and the sample's
    lanes ``ok``: one launch of the sample ADC at any M.  Summed in
    ascending m like the kernels, so the sample's estimates equal the
    scan's for the same lanes."""
    spos, sok = ivf_mod.tile_positions(layout, probed[:, :st], cap)
    return ops.pq_sample_adc_batch(stream_codes, luts, spos, sok), sok


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
    return torch.where(lane_valid,
                       numerics.sqrt_rn(torch.clamp(est2, min=0.0)), INF)


# --------------------------------------------------------------------------
# Single-query searchers
# --------------------------------------------------------------------------
#
# One (d,) query over the padded (n_probe, cap) member table of its probed
# clusters, nearest first, as in the reference.  Every kernel runs at one
# query: the estimate (``ops.pq_adc``, or ``ops.rabitq_est_tiles`` over all
# probed tiles in one launch), the bucketize + histogram passes
# (``ops.bucket_hist``) and every exact distance (``ops.l2_exact`` over
# the gathered rows, so a lane's exact distance has the same bits on the
# CPU and the card).  Counters are 0-d int32 tensors.

def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def _exact_rows(vectors: torch.Tensor, ids: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """Exact distances of the rows ``ids`` (any shape, -1 allowed: callers
    mask) to ``q``, by the l2 kernel over the gathered rows."""
    rows = vectors[ids.clamp(min=0).reshape(-1)]
    return ops.l2_exact(rows, q).reshape(ids.shape)


def _probe(ivf: ivf_mod.IVFIndex, q: torch.Tensor, n_probe: int):
    probed = ivf_mod.route(ivf, q, n_probe)
    ids, valid = ivf_mod.gather_candidates(ivf, probed)
    return probed, ids, valid


def ivf_search(index: ivf_mod.IVFIndex, vectors: torch.Tensor,
               q: torch.Tensor, k: int, n_probe: int, use_bbc: bool = False,
               m: int = 128) -> SearchResult:
    """IVF for one query: the exact distances of the probed rows (the l2
    kernel), then the BBC collector or a flat top-k."""
    _, ids, valid = _probe(index, q, n_probe)
    dists = torch.where(valid, _exact_rows(vectors, ids, q), INF)
    s = col.StreamInput(dists, ids, valid)
    d, i = col.bbc_collect(s, k, m=m) if use_bbc else col.topk_collect(s, k)
    return SearchResult(d, i, _i32(valid.sum()),
                        torch.zeros((), dtype=torch.int32, device=q.device))


def ivf_pq_search(index: PQIndex, q: torch.Tensor, k: int, n_probe: int,
                  n_cand: int, use_bbc: bool = False, m: int = 128,
                  early_slack: float = 4.0) -> SearchResult:
    """IVF+PQ (baseline) and IVF+PQ+BBC (Alg. 4 early re-rank) for one query.

    Baseline: the top n_cand by estimate, then one exact pass over them.
    BBC: a codebook from the nearest 4 probed tiles; the bucket ids and the
    histogram of every probed lane from the bucket_hist kernel, and from the
    histogram the scan threshold tau (the bucket of the n_cand-th
    estimate).  Per tile, the first ``early_budget`` lanes at or below tau
    get their exact distance "inline" (the reference's per-cluster early
    re-rank; the budget keeps its counters); the bucket collector selects
    the n_cand; the selected lanes the early leg missed are the second
    pass (``n_second_pass``)."""
    ivf = index.ivf
    _, ids, valid = _probe(ivf, q, n_probe)
    cap = ids.shape[1]
    lut = pq_mod.adc_table(index.pq, q)
    flat_ids, flat_valid = ids.reshape(-1), valid.reshape(-1)
    est = ops.pq_adc(index.codes[flat_ids.clamp(min=0)], lut)   # squared
    flat_est = numerics.sqrt_rn(torch.clamp(torch.where(flat_valid, est, INF),
                                            min=0.0))
    est2 = flat_est.reshape(n_probe, cap)

    if not use_bbc:
        _, ci = col.topk_collect(col.StreamInput(est2, ids, valid), n_cand)
        ex = torch.where(ci >= 0, _exact_rows(index.vectors, ci, q), INF)
        vals, order = rb.smallest(ex, k)
        nc = _i32(n_cand)
        return SearchResult(vals, ci[order], nc, nc)

    st = min(SAMPLE_TILES, n_probe)
    sample = torch.where(valid[:st], est2[:st], INF).reshape(1, -1)
    cb = rb.build_codebook(sample, k=min(n_cand, sample.shape[1]), m=m)
    bucket, hist = ops.bucket_hist(flat_est, flat_valid, cb.d_min, cb.delta,
                                   cb.ew_map, m)
    tau_scan = rb.threshold_bucket(hist[None], n_cand)[0]

    # the early leg: per tile, the first early_budget lanes at or below tau
    # (the bucket ids are ``rerank.early_rerank_mask``'s, from the kernel)
    early_budget = int(min(cap, max(128, round(n_cand / n_probe
                                               * early_slack))))
    early_budget = min(((early_budget + 127) // 128) * 128, cap)
    n_total = n_probe * cap
    pred = (bucket.reshape(n_probe, cap) <= tau_scan[:, None]) & valid
    pos, ok = rb.compact_mask(pred, early_budget)
    safe = pos.clamp(max=cap - 1)
    e_ids = torch.where(ok, torch.gather(ids, 1, safe), -1)
    e_d = torch.where(ok, _exact_rows(index.vectors, e_ids, q), INF)
    row0 = torch.arange(n_probe, device=q.device)[:, None] * cap
    tgt = torch.where(ok, row0 + safe, n_total)       # n_total: dump slot
    flat_e_d = torch.full((n_total + 1,), INF, device=q.device).scatter(
        0, tgt.reshape(-1), e_d.reshape(-1))[:n_total]
    n_early = ok.sum()

    positions = torch.arange(n_total, device=q.device)
    _, sel_pos = rb.collect(cb, flat_est, positions, bucket, n_cand,
                            flat_valid, hist=hist)
    sel_ids = torch.where(sel_pos >= 0, flat_ids[sel_pos.clamp(min=0)], -1)
    e_at = flat_e_d[sel_pos.clamp(min=0)]
    have = torch.isfinite(e_at) & (sel_pos >= 0)
    miss = ~have & (sel_ids >= 0)
    second = miss.sum()
    miss_d = _exact_rows(index.vectors, torch.where(miss, sel_ids, 0), q)
    ex = torch.where(have, e_at, torch.where(miss, miss_d, INF))
    vals, order = rb.smallest(ex, k)
    return SearchResult(vals, sel_ids[order], _i32(n_early + second),
                        _i32(second))


def ivf_rabitq_search(index: RabitqIndex, q: torch.Tensor, k: int,
                      n_probe: int, use_bbc: bool = False, m: int = 128,
                      eps0: float = 3.0) -> SearchResult:
    """IVF+RaBitQ for one query: the per-cluster estimator over every probed
    tile in one launch (``rabitq.estimate``), then the per-tile threshold
    baseline or Alg. 3's plan with its two exact phases.

    Baseline: tiles nearest first; a tile's lanes whose lower bound is under
    the running k-th exact distance are re-ranked (at most the re-rank
    budget of them, in tile order) and merged into a k-wide pool.  A Python
    loop over the tiles, with no host sync inside.

    BBC: ``rerank.greedy_rerank_plan`` over all probed lanes; phase 1
    re-ranks the band's likely-in lanes (ub bucket at or below tau_ub),
    whose exact distances give the tightened threshold of phase 2; phase 2
    the rest of the band under it.  Each phase takes at most its budget of
    lanes in estimate order (ties to the lower position)."""
    ivf = index.ivf
    rq = index.rq
    probed, ids, valid = _probe(ivf, q, n_probe)
    cap = ids.shape[1]
    safe_ids = ids.clamp(min=0)
    qf = rq_mod.query_factors(rq, q, ivf.centroids[probed])
    est, lb, ub = rq_mod.estimate(rq.codes[safe_ids], rq.norm_o[safe_ids],
                                  rq.f_o[safe_ids], qf, eps0, valid=valid)
    dev = q.device

    if not use_bbc:
        budget = min(cap, _rerank_budget(k))
        pool_d = torch.full((k,), INF, device=dev)
        pool_i = torch.full((k,), -1, dtype=ids.dtype, device=dev)
        n_rr = torch.zeros((), dtype=torch.int64, device=dev)
        for t in range(n_probe):
            mask = valid[t] & (lb[t] < pool_d[k - 1])
            pos, okc = rb.compact_mask(mask[None], budget)
            pos, okc = pos[0], okc[0]
            r_ids = torch.where(okc, ids[t][pos.clamp(max=cap - 1)], -1)
            r_d = torch.where(okc, _exact_rows(index.vectors, r_ids, q), INF)
            pool_d, pick = rb.smallest(torch.cat([pool_d, r_d]), k)
            pool_i = torch.cat([pool_i, r_ids])[pick]
            n_rr = n_rr + okc.sum()
        return SearchResult(pool_d, pool_i, _i32(n_rr), _i32(n_rr))

    flat_lb, flat_ub = lb.reshape(-1), ub.reshape(-1)
    flat_est = est.reshape(-1)
    flat_ids, flat_valid = ids.reshape(-1), valid.reshape(-1)
    n_flat = flat_ids.shape[0]
    plan = rerank.greedy_rerank_plan(flat_lb, flat_ub, k, flat_valid, m=m)

    def eval_mask(mask, budget, exact_flat):
        """Exact distances of up to ``budget`` masked lanes, est first."""
        key = torch.where(mask, flat_est, INF)
        kv, pos = rb.smallest(key, budget)
        ok = torch.isfinite(kv)
        r_ids = torch.where(ok, flat_ids[pos], -1)
        r_d = torch.where(ok, _exact_rows(index.vectors, r_ids, q), INF)
        exact_flat = torch.cat([exact_flat, exact_flat.new_full((1,), INF)])
        exact_flat = exact_flat.scatter(0, torch.where(ok, pos, n_flat),
                                        r_d)[:n_flat]
        return exact_flat, r_d, ok.sum()

    exact_flat = torch.full((n_flat,), INF, device=dev)
    p1 = rerank.phase1_mask(plan)
    budget1 = min(n_flat, ((k + 1024 + 127) // 128) * 128)
    exact_flat, p1_d, n1 = eval_mask(p1, budget1, exact_flat)
    t2 = rerank.phase2_threshold(plan, p1_d, k)
    p2 = plan.rerank_mask & ~p1 & torch.isinf(exact_flat) & (flat_lb <= t2)
    budget2 = min(n_flat, _rerank_budget(k))
    exact_flat, _, n2 = eval_mask(p2, budget2, exact_flat)
    res = rerank.greedy_rerank_finalize(
        plan, exact_flat, torch.where(flat_valid, flat_lb, INF), flat_ids, k,
        est=flat_est)
    n_evals = _i32(n1 + n2)
    return SearchResult(res.topk_dists, res.topk_ids, n_evals, n_evals)


# --------------------------------------------------------------------------
# Batched IVF+PQ
# --------------------------------------------------------------------------

def ivf_pq_search_batch(index: PQIndex, stream: Stream, qs: torch.Tensor,
                        layout: ivf_mod.FlatLayout, k: int, n_probe: int,
                        n_cand: int, use_bbc: bool = False, m: int = 128,
                        fused: bool | None = None,
                        pred_state: rerank.PredictorState | None = None,
                        pred_count: int | None = None,
                        live: torch.Tensor | None = None):
    """Batched IVF+PQ (with or without BBC) over a (B, d) query batch.
    ``stream`` is the index's ``Stream`` over ``layout``: the scan reads
    its codes, and every exact distance its rows by stream position.

    ``fused`` (default: True for CUDA tensors, False on the CPU) runs the
    BBC path through one fused scan that exact-ranks the predicted lanes
    inline; the second pass covers only the stragglers.  The unfused form
    selects the top n_cand by estimate and re-ranks the whole selection.
    Both give the same ids; only the counters differ.

    With ``pred_state`` the n_cand cut becomes the predictive pool and the
    call returns ``(SearchResult, new_state)``.

    ``live`` is an optional (n_flat,) stream-ordered tombstone mask
    (``SearchEngine.with_live``): dead lanes are ANDed out of the lane
    masks, so estimates, histograms and the collection treat them as
    unprobed lanes.  It is an input tensor, never baked into anything.
    """
    if fused is None:
        fused = on_cuda(qs.device)
    ivf = index.ivf
    b = qs.shape[0]
    order = layout.order
    with spans.span("pq.route"):
        probed, lane_valid, _ = _routing(ivf, layout, qs, n_probe, live)
    with spans.span("pq.tables"):
        luts = pq_mod.adc_table(index.pq, qs)

    if pred_state is not None:
        if not use_bbc:
            raise ValueError("predictive search requires use_bbc=True")
        return _ivf_pq_predictive_batch(
            index, stream, qs, layout, probed, lane_valid, luts, k,
            n_probe, n_cand, m, fused, pred_state, pred_count)

    n_flat = layout.n_flat
    dense_rerank = 4 * n_cand >= n_flat

    if not use_bbc:
        est = _sqrt_est(ops.pq_adc_batch(stream.codes, luts), lane_valid)
        sel_est, sel_pos = rb.smallest(est, n_cand)
        ci = torch.where(torch.isfinite(sel_est), order[sel_pos], -1)
        if dense_rerank:
            exact_all = ops.l2_exact_batch(stream.vectors, qs)
            ex = torch.gather(exact_all, 1, sel_pos)
        else:
            ex = _exact_dists_rows(stream.vectors, sel_pos, qs, mask=ci >= 0)
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
        with spans.span("pq.sample"):
            st = min(SAMPLE_TILES, n_probe)
            est2, sok = _pq_sample_adc(layout, probed, stream.codes, luts,
                                       st, ivf.cap)
            plans = rerank.early_rerank_plan(
                est2, n_cand=n_cand, n_sample=st * ivf.cap,
                n_total=n_probe * ivf.cap, m=m, valid=sok, squared=True)
        with spans.span("pq.scan"):
            est, bucket, hist, early, nmiss = ops.fused_scan_batch(
                stream.codes, stream.vectors, lane_valid, luts, qs,
                plans.cb.d_min, plans.cb.delta, plans.cb.ew_map, m,
                plans.tau_pred, probed, layout.offsets, ivf.cap)
        # ``collect_batch`` by its halves (ids: the positions), so that the
        # scan's (B, n) outputs go once read: past the scan the call may
        # need no more memory than the scan, the stream being held
        with spans.span("collect"):
            pos, ok, widened = col.survivors_batch(bucket, lane_valid, hist,
                                                   n_cand, m)
            del bucket, lane_valid
            pos = pos.long().clamp(max=n_flat - 1)
            est_at = torch.gather(est, 1, pos)
            del est
            _, sel_pos = col.smallest_survivors(est_at, pos, ok, n_cand,
                                                widened)
    else:
        # top n_cand by estimate (boundary ties by global id), then one exact
        # pass over the whole selection
        est = _sqrt_est(ops.pq_adc_batch(stream.codes, luts), lane_valid)
        sel_est, sel_pos = _topk_est_id(est, order, n_cand)
        sel_ids = torch.where(torch.isfinite(sel_est), order[sel_pos], -1)
        e_at_sel = torch.full(sel_pos.shape, INF, device=qs.device)
        have = torch.zeros(sel_pos.shape, dtype=torch.bool, device=qs.device)
        n_early = torch.zeros(b, dtype=torch.int32, device=qs.device)

    with spans.span("rerank.second_pass"):
        if fused:
            safe_pos = sel_pos.clamp(min=0)
            sel_ids = torch.where(sel_pos >= 0, order[safe_pos], -1)
            e_at_sel = torch.gather(early, 1, safe_pos)
            have = torch.isfinite(e_at_sel) & (sel_pos >= 0)
            # the histogram counts every valid lane
            n_early = (hist.sum(1) - nmiss).to(torch.int32)
        miss = ~have & (sel_ids >= 0)
        if not fused and dense_rerank:
            # the whole selection misses: one shared pass over the stream
            # beats n_cand per-row gathers
            exact_all = ops.l2_exact_batch(stream.vectors, qs)
            miss_d = torch.gather(exact_all, 1, sel_pos.clamp(min=0))
        else:
            miss_d = _exact_dists_rows(stream.vectors, sel_pos, qs, mask=miss)
        ex = torch.where(have, e_at_sel, torch.where(miss, miss_d, INF))
        second = miss.sum(1).to(torch.int32)
    with spans.span("select"):
        vals, pick = rb.smallest(ex, k)
        return SearchResult(vals, torch.gather(sel_ids, 1, pick),
                            n_early + second, second)


def _ivf_pq_predictive_batch(index, stream, qs, layout, probed, lane_valid,
                             luts, k, n_probe, n_cand, m, fused, pred_state,
                             pred_count):
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
    st = min(SAMPLE_TILES, n_probe)
    est2, sok = _pq_sample_adc(layout, probed, stream.codes, luts, st,
                               ivf.cap)
    cbs, _ = rb.sample_plan(est2, min(n_cand, est2.shape[1]), m, valid=sok,
                            sqrt=True)
    tau_pred = torch.full((b,), rerank.predict_tau(pred_state, count),
                          dtype=torch.int32, device=qs.device)

    if fused:
        est, bucket, hist, early, nmiss = ops.fused_scan_batch(
            stream.codes, stream.vectors, lane_valid, luts, qs,
            cbs.d_min, cbs.delta, cbs.ew_map, m, tau_pred, probed,
            layout.offsets, ivf.cap)
        n_early = (lane_valid.sum(1) - nmiss).to(torch.int32)
    else:
        est = _sqrt_est(ops.pq_adc_batch(stream.codes, luts), lane_valid)
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
        exact_all = ops.l2_exact_batch(stream.vectors, qs)
        miss_d = torch.gather(exact_all, 1, sel_pos)
    else:
        miss_d = _exact_dists_rows(stream.vectors, sel_pos, qs, mask=miss)
    ex = torch.where(have, e_at_sel, torch.where(miss, miss_d, INF))
    second = miss.sum(1).to(torch.int32)
    vals, pick = rb.smallest(ex, k)
    res = SearchResult(vals, torch.gather(sel_ids, 1, pick),
                       n_early + second, second)
    return res, rerank.predictor_update(pred_state, hist)


# --------------------------------------------------------------------------
# Batched IVF
# --------------------------------------------------------------------------

def _sample_codebooks(layout: ivf_mod.FlatLayout, probed: torch.Tensor,
                      vals: torch.Tensor, st: int, cap: int, k_cb: int,
                      m: int) -> rb.BucketCodebook:
    """Per-query codebooks from the nearest ``st`` probed cluster tiles of
    a (B, n_flat) value matrix."""
    spos, sok = ivf_mod.tile_positions(layout, probed[:, :st], cap)
    sample = torch.where(sok, torch.gather(vals, 1, spos), INF)
    return rb.build_codebook(sample, k=min(k_cb, sample.shape[1]), m=m)


def ivf_search_batch(index: ivf_mod.IVFIndex, stream: Stream,
                     qs: torch.Tensor, layout: ivf_mod.FlatLayout, k: int,
                     n_probe: int, use_bbc: bool = False, m: int = 128,
                     pred_state: rerank.PredictorState | None = None,
                     pred_count: int | None = None,
                     live: torch.Tensor | None = None):
    """Batched IVF: exact distances of the probed lanes in one shared scan
    (``ops.l2_exact_batch`` over ``stream``'s rows), then the BBC collection
    over a sample of the nearest 4 probed tiles (``use_bbc``) or a flat
    top-k.  With
    ``pred_state`` the selection is predictive and the call returns
    ``(SearchResult, new_state)``; distances are exact in-scan, so the
    result is the static one for any prediction.  ``live``: the
    tombstone mask, as in ``ivf_pq_search_batch``."""
    if pred_state is not None and not use_bbc:
        raise ValueError("predictive search requires use_bbc=True")
    probed, lane_valid, _ = _routing(index, layout, qs, n_probe, live)
    order = layout.order
    dists = ops.l2_exact_batch(stream.vectors, qs)
    dists = torch.where(lane_valid, dists, INF)
    n = torch.sum(lane_valid, dim=1).to(torch.int32)
    zeros = torch.zeros_like(n)
    if not use_bbc:
        d, i = col.topk_collect_batch(dists, order, lane_valid, k)
        return SearchResult(d, i, n, zeros)
    cbs = _sample_codebooks(layout, probed, dists, min(SAMPLE_TILES, n_probe),
                            index.cap, k, m)
    bucket, hist = ops.bucket_hist_batch(dists, lane_valid, cbs.d_min,
                                         cbs.delta, cbs.ew_map, m)
    if pred_state is None:
        d, i = col.collect_batch(dists, order, lane_valid, bucket, hist, k, m)
        return SearchResult(d, i, n, zeros)
    count = max(pred_count, k) if pred_count is not None else k
    tau_pred = torch.full((qs.shape[0],),
                          rerank.predict_tau(pred_state, count),
                          dtype=torch.int32, device=qs.device)
    budget = _pred_budget(count, layout.n_flat)
    sel_d, sel_pos, sel_ok, _ = _predictive_select(
        dists, bucket, hist, lane_valid, tau_pred, count, budget, order)
    ids = torch.where(sel_ok, order[sel_pos], -1)
    res = SearchResult(sel_d[:, :k], ids[:, :k], n, zeros)
    return res, rerank.predictor_update(pred_state, hist)


# --------------------------------------------------------------------------
# Batched IVF+RaBitQ
# --------------------------------------------------------------------------
#
# The fused path sizes its band from per-query codebooks over a sample of
# the nearest probed tiles (the paper's nearest-cluster sample), and takes
# the band threshold tau_ub from the scan's own ub histogram: exact at
# bucket granularity for any codebook, so the inline gate tau_inline only
# decides where a band member's exact distance comes from (the scan or the
# straggler gather), never whether it is evaluated.

_TAU_INLINE_MARGIN = 2   # buckets of slack on the static sample gate
# The predictor's EMA tracks the ub histogram of every 8th stream lane (an
# unbiased, roughly cluster-stratified subsample) and is queried at the
# stride-scaled count; the gate's margin leans high, because an overshoot
# certifies lanes whose rows the scan reads anyway.
_PRED_HIST_STRIDE = 8
_PRED_GATE_MARGIN = 3


def _rerank_budget(k: int) -> int:
    return ((max(8 * k, 2048) + 127) // 128) * 128


def _rabitq_inline_rank(k: int, st: int, n_probe: int, k_cb: int) -> int:
    """Sample rank of the k-th upper bound (Alg. 4 line 4's |sample|/|O|
    scaling with the static tile ratio st/n_probe)."""
    return max(1, min(k_cb, round(k * st / max(n_probe, 1))))


def _rabitq_sample_plan(sample_ub: torch.Tensor, k: int, count: int,
                        st: int, n_probe: int, m: int):
    """Per-query codebooks over the k smallest sampled upper bounds, and
    the static inline gate: the bucket of the rank-scaled ``count``-th
    sampled ub, plus ``_TAU_INLINE_MARGIN`` (at most m - 1), in one
    ``rb.sample_plan``.  Returns (codebooks, tau)."""
    k_cb = min(k, sample_ub.shape[1])
    return rb.sample_plan(sample_ub, k_cb, m,
                          rank=_rabitq_inline_rank(count, st, n_probe, k_cb),
                          margin=_TAU_INLINE_MARGIN, cap=m - 1)


def _rabitq_query_terms(stream: Stream, qs: torch.Tensor, d2: torch.Tensor):
    """The rotated queries ``g`` (B, d) and the query-centroid distances
    ``nq`` (B, C) that the bounds of every lane read, once a call."""
    return numerics.rotate(qs, stream.rot), numerics.sqrt_rn(d2)


def _rabitq_sample_ub(stream: Stream, layout: ivf_mod.FlatLayout,
                      probed: torch.Tensor, g: torch.Tensor, nq: torch.Tensor,
                      st: int, cap: int, eps0: float):
    """Upper bounds (B, st*cap) over each query's nearest ``st`` probed
    tiles (``ivf.tile_positions``' lanes, +inf off them), the codebook
    sample the fused scan needs before it runs, and the lanes' mask: one
    launch on the card (the reference maps over queries); the code products
    are added in ``ordered_sum``'s order, so the sample has the same bits on
    both devices."""
    return ops.rabitq_sample_ub_batch(
        stream.codes, stream.s2, stream.norm_o, stream.f_o, stream.cl,
        layout.offsets, probed[:, :st], cap, g, nq, eps0=eps0)


def ivf_rabitq_search_batch(index: RabitqIndex, stream: Stream,
                            qs: torch.Tensor, layout: ivf_mod.FlatLayout,
                            k: int, n_probe: int, use_bbc: bool = False,
                            m: int = 128, eps0: float = 3.0,
                            fused: bool | None = None,
                            pred_state: rerank.PredictorState | None = None,
                            pred_count: int | None = None,
                            live: torch.Tensor | None = None):
    """Batched IVF+RaBitQ (with or without BBC) over a (B, d) query batch.

    ``stream`` is the index's ``Stream`` over ``layout``.  The BBC path
    runs the bound-fused scan (``fused=None`` means fused, as in the
    reference): bounds, buckets, histograms and the inline exact distance
    of gate-certified lanes in one pass, then an exact gather of the band's
    stragglers only.  ``fused=False`` is the
    two-phase form: bounds, the full-stream Alg. 3 plan, and one dense
    exact pass.  ``use_bbc=False`` is the per-tile threshold baseline.

    With ``pred_state`` the engine's EMA gates the inline band (-1 while
    cold: nothing certified) and the call returns ``(SearchResult,
    new_state)``; the band and the ids do not depend on the gate.
    ``live``: the tombstone mask, as in ``ivf_pq_search_batch``."""
    if pred_state is not None and not use_bbc:
        raise ValueError("predictive search requires use_bbc=True")
    if fused is None:
        fused = True
    ivf = index.ivf
    with spans.span("rabitq.route"):
        probed, lane_valid, d2 = _routing(ivf, layout, qs, n_probe, live)
    if use_bbc and fused:
        return _ivf_rabitq_fused_batch(index, stream, qs, layout, probed,
                                       lane_valid, d2, k, n_probe, m, eps0,
                                       pred_state, pred_count)
    est, lb, ub = numerics.rabitq_bounds_stream(
        stream.codes, stream.s2, stream.norm_o, stream.f_o, stream.cl,
        *_rabitq_query_terms(stream, qs, d2), lane_valid, eps0)
    if not use_bbc:
        d, i, n_rr = _rabitq_threshold_baseline(index, stream, layout,
                                                probed, lb, qs, k)
        return SearchResult(d, i, n_rr, n_rr)

    # two-phase BBC (Alg. 3, batched): plan from the full-stream ub top-k,
    # then the whole band from one dense exact pass
    plan = rerank.greedy_rerank_plan_batch(lb, ub, k, lane_valid, m=m)
    exact_all = ops.l2_exact_batch(stream.vectors, qs)
    exact_flat = torch.where(plan.rerank_mask, exact_all, INF)
    res = rerank.greedy_rerank_finalize(plan, exact_flat, lb, layout.order,
                                        k, est=est)
    n_evals = res.n_reranked
    if pred_state is None:
        return SearchResult(res.topk_dists, res.topk_ids, n_evals, n_evals)
    # the band members the cross-batch gate covers would ride the scan;
    # the second pass is the rest
    count = max(pred_count, k) if pred_count is not None else k
    tau_pred = rerank.predict_tau(pred_state, count)
    n_second = torch.sum(plan.rerank_mask & (plan.a_lb > tau_pred),
                         dim=1).to(torch.int32)
    hist_ub = rb.histogram(plan.a_ub, m, lane_valid)
    return (SearchResult(res.topk_dists, res.topk_ids, n_evals, n_second),
            rerank.predictor_update(pred_state, hist_ub))


def _rabitq_threshold_baseline(index: RabitqIndex, stream: Stream, layout,
                               probed, lb, qs, k: int):
    """IVF+RaBitQ without BBC: per query, probed tiles nearest first; a
    tile's lanes whose lower bound is under the current k-th exact distance
    are re-ranked exactly and merged into a k-wide pool.  The reference's
    per-query ``lax.scan`` is a loop over the tiles with the batch
    written out.  Returns (dists (B, k) ascending, ids, re-rank counts)."""
    b, n_probe = probed.shape
    cap = index.ivf.cap
    dev = qs.device
    tpos, tok = ivf_mod.tile_positions(layout, probed, cap)
    lb_t = torch.where(tok, torch.gather(lb, 1, tpos), INF).reshape(
        b, n_probe, cap)
    pos_t = tpos.reshape(b, n_probe, cap)
    ok_t = tok.reshape(b, n_probe, cap)
    budget = min(cap, _rerank_budget(k))
    pool_d = torch.full((b, k), INF, device=dev)
    pool_i = torch.full((b, k), -1, dtype=layout.order.dtype, device=dev)
    n_rr = torch.zeros(b, dtype=torch.int32, device=dev)
    for t in range(n_probe):
        mask = ok_t[:, t] & (lb_t[:, t] < pool_d[:, k - 1:k])
        pos, okc = rb.compact_mask(mask, budget)
        r_pos = torch.gather(pos_t[:, t], 1, pos.clamp(max=cap - 1))
        r_ids = torch.where(okc, layout.order[r_pos], -1)
        r_d = _exact_dists_rows(stream.vectors, r_pos, qs, mask=okc)
        pool_d, pick = rb.smallest(torch.cat([pool_d, r_d], dim=1), k)
        pool_i = torch.gather(torch.cat([pool_i, r_ids], dim=1), 1, pick)
        n_rr += okc.sum(dim=1).to(torch.int32)
    return pool_d, pool_i, n_rr


def _ivf_rabitq_fused_batch(index, stream, qs, layout, probed, lane_valid,
                            d2, k, n_probe, m, eps0, pred_state, pred_count):
    """Bound-fused RaBitQ batch core: one scan gives bounds, buckets, both
    histograms and the exact distances of certified lanes; the band comes
    from the scan's histograms, and only its stragglers (band members the
    gate did not certify) are gathered a second time."""
    ivf = index.ivf
    b = qs.shape[0]
    n_flat = layout.n_flat
    st = min(SAMPLE_TILES, n_probe)
    count = k if pred_count is None else max(pred_count, k)
    with spans.span("rabitq.sample"):
        g, nq = _rabitq_query_terms(stream, qs, d2)
        sample_ub, _ = _rabitq_sample_ub(stream, layout, probed, g, nq, st,
                                         ivf.cap, eps0)
        cbs, tau_inline = _rabitq_sample_plan(sample_ub, k, count, st,
                                              n_probe, m)
    if pred_state is not None:
        # the EMA gate, -1 while cold (nothing certified inline)
        count_s = max(1, -(-count // _PRED_HIST_STRIDE))
        tau_inline = torch.full(
            (b,), rerank.predict_tau(pred_state, count_s,
                                     margin=_PRED_GATE_MARGIN),
            dtype=torch.int32, device=qs.device)

    with spans.span("rabitq.scan"):
        (est, lb, _, bucket_lb, bucket_ub, hist_lb, hist_ub, exact_c,
         certified, _) = ops.fused_rabitq_scan_batch(
            stream.codes, stream.vectors, stream.s2, stream.norm_o,
            stream.f_o, stream.cl, g, qs, nq, lane_valid,
            cbs.d_min, cbs.delta, cbs.ew_map, m, tau_inline, eps0=eps0)
    with spans.span("rabitq.band"):
        tau_ub, _ = rb.threshold_bucket(hist_ub, k)
        tau_lb, _ = rb.threshold_bucket(hist_lb, k)
        certain_in = lane_valid & (bucket_ub < tau_lb[:, None])
        band = lane_valid & (bucket_lb <= tau_ub[:, None]) & ~certain_in
        straggler = band & ~certified
        n_second = torch.sum(straggler, dim=1).to(torch.int32)
        n_evals = torch.sum(band, dim=1).to(torch.int32)
        # certain-in and band lanes together are exactly the valid lanes
        # whose lb bucket is at most tau_ub (lb <= ub lane by lane, so
        # tau_lb <= tau_ub); the lb histogram counts them
        n_kept = torch.gather(torch.cumsum(hist_lb, 1, dtype=torch.int32),
                              1, tau_ub.long()[:, None])[:, 0]
        reads = torch.stack([n_second, n_kept, -n_kept]).amax(dim=1)

    # The reference gathers the stragglers in lb priority into a budget of
    # round128(max(2k, 2048)) rows and falls back to one dense exact pass
    # when any query has more; under the budget every straggler is
    # gathered, so the port gathers them by position.  Past it the port
    # computes the dense pass's distances at the stragglers alone, with
    # its bits (nothing else of it is read).  One host read decides that
    # branch and sizes the selection below.
    budget = min(n_flat, ((max(2 * k, 2048) + 127) // 128) * 128)
    with spans.span("rerank.stragglers"):
        with spans.span("wait.straggler_budget"):
            most_second, most_kept, least_kept = reads.tolist()
        spans.count("rerank.dense_stragglers", int(most_second > budget))
        if most_second > budget:
            stragglers = ops.l2_exact_batch_masked(stream.vectors, qs,
                                                   straggler)
        else:
            pos = torch.arange(n_flat, device=qs.device).expand(b, n_flat)
            stragglers = _exact_dists_rows(stream.vectors, pos, qs,
                                           mask=straggler)
        exact_band = torch.where(band, torch.where(certified, exact_c,
                                                   stragglers), INF)
    with spans.span("select"):
        plan = rerank.GreedyRerankPlan(
            rerank_mask=band, certain_in=certain_in, tau_ub=tau_ub,
            tau_lb=tau_lb, a_lb=bucket_lb, a_ub=bucket_ub)
        if -least_kept < k:
            # a query with fewer than k valid lanes: the full-width sort
            spans.count("select.full_width", 1)
            with spans.span("select.full_width"):
                res = rerank.greedy_rerank_finalize(plan, exact_band, lb,
                                                    layout.order, k, est=est)
        else:
            # every row keeps at least k lanes (tau_ub < m keeps the k
            # lowest ub buckets' lanes; tau_ub = m keeps every valid lane):
            # select over the widest row's, compacted in stream order
            width = min(n_flat, -(-most_kept // 128) * 128)
            kept, ok, _ = ops.spec_compact_batch(bucket_lb, lane_valid,
                                                 tau_ub, width)
            res = rerank.greedy_rerank_finalize_compacted(
                plan, exact_band, lb, layout.order, k, est, kept, ok,
                n_evals)
        out = SearchResult(res.topk_dists, res.topk_ids, n_evals, n_second)
    if pred_state is None:
        return out
    s = _PRED_HIST_STRIDE
    hist_s = rb.histogram(bucket_ub[:, ::s], m, lane_valid[:, ::s])
    return out, rerank.predictor_update(pred_state, hist_s)


# --------------------------------------------------------------------------
# Mesh-sharded searchers (corpus row-sharded over the ranks of a ShardMesh)
# --------------------------------------------------------------------------
#
# ``ivf.sharded_layout`` deals every cluster's members round-robin over the
# S shards; each rank holds its own block of the stream (a ``FlatLayout``
# over global ids, and the stream tensors in that order) and scans only
# that.  One search step per batch, on every rank:
#
#   1. routing, the same on every rank (the single-device routing);
#   2. the local scan through the same ``ops`` kernels as the batched path,
#      over a shorter stream;
#   3. the codebook sample of the nearest probed clusters, gathered across
#      the shards, and the provisional threshold ``tau_spec`` from it;
#   4. the shard collector (``ops.shard_collect_batch``, or
#      ``ops.spec_compact_batch`` over RaBitQ's lb buckets): bucket ids,
#      histogram and the speculative survivor buffer in one pass;
#   5. ``distributed.bbc_survivors_batch``: the summed histograms give tau,
#      and the survivors go into a fixed per-shard budget;
#   6. the exact re-rank of the survivors on the shard that holds their rows;
#   7. the survivors alone are gathered, rank-major, and the final selection
#      (a stable sort: ties to the lower pool position) runs split by rows.
#
# ``use_bbc=False`` is the naive distributed collector: a local top-k by
# estimate on every shard, gathered whole.  ``mesh=None`` is one shard and
# no collective.  Every rank issues the same collectives in the same order:
# the data-dependent branches (the survivor tier, the PQ re-cut, the dense
# straggler pass) hold none.


def _n_shards(mesh) -> int:
    return 1 if mesh is None else mesh.n_shards


def _shard_budget(budget: int | None, count: int, n_shards: int,
                  shard_flat: int, slack: float) -> int:
    if budget is None:
        budget = dist.survivor_budget(count, n_shards, slack=slack)
    return max(8, min(budget, shard_flat))


def _sharded_codebooks(layout: ivf_mod.FlatLayout, probed: torch.Tensor,
                       vals: torch.Tensor, st: int, cap_shard: int,
                       k_cb: int, m: int, mesh):
    """Per-query codebooks from the nearest ``st`` probed clusters, gathered
    across the shards: the union of the shards' slices is those clusters'
    whole membership, the batched path's sample population.  Returns
    ``(codebooks, sample)``, the sample sorted ascending (it also seeds
    ``_sample_spec_tau``); the sort and the build run split by rows."""
    spos, sok = ivf_mod.tile_positions(layout, probed[:, :st], cap_shard)
    s_local = torch.where(sok, torch.gather(vals, 1, spos), INF)
    (sample,) = dist.gather_survivors(mesh, s_local)
    k_cb = min(k_cb, sample.shape[1])

    def sort_and_build(s):
        asc = torch.sort(s, dim=1).values
        return rb.build_codebook_from_topk(asc[:, :k_cb], m=m), asc

    return dist.shard_rows(mesh, sort_and_build, sample)


_SPEC_TAU_MARGIN = 2   # buckets of slack on the speculative threshold


def _sample_spec_tau(cbs: rb.BucketCodebook, sample: torch.Tensor,
                     count: int, n_probed: torch.Tensor, m: int):
    """Provisional compaction threshold for the shard collector: the bucket
    of the rank-scaled ``count``-th smallest sample value (rank = count *
    |sample| / |probed|, Alg. 4 line 4's scaling) plus a margin, leaning
    high because an overshoot costs a few buffer slots and an undershoot a
    correction pass.  m (compact everything in range) when the rank runs
    off the sample, the count >= n_probed regime where tau is m too.
    ``sample`` is sorted ascending per query."""
    ns = sample.shape[1]
    n_valid = torch.isfinite(sample).sum(dim=1)
    frac = n_valid.to(torch.float32) / torch.clamp(
        n_probed.to(torch.float32), min=1.0)
    rank = torch.ceil(count * frac).to(torch.int64)
    kth = torch.gather(sample, 1, (rank - 1).clamp(0, ns - 1)[:, None])
    tau = rb.bucketize(cbs, kth)[:, 0]
    tau = torch.clamp(tau + _SPEC_TAU_MARGIN, max=m).to(torch.int32)
    return torch.where(rank >= n_valid, m, tau).to(torch.int32)


def _kth_value_mask(vals: torch.Tensor, ids: torch.Tensor,
                    kth: int) -> torch.Tensor:
    """Mask of each row's ``kth`` smallest (value, global id) pairs.  Global
    ids are unique, so the kept set depends only on the (value, id)
    multiset, whatever the pool order: the batched stream order and the
    gathered sharded pool keep the same set where PQ estimates tie.
    Padding ids (-1) rank after every real id.  Two stable sorts: by id,
    then by value."""
    eid = torch.where(ids < 0, torch.iinfo(torch.int64).max, ids)
    by_id = torch.argsort(eid, dim=1, stable=True)
    by_val = torch.argsort(torch.gather(vals, 1, by_id), dim=1, stable=True)
    keep = torch.gather(by_id, 1, by_val[:, :kth])
    mask = torch.zeros(vals.shape, dtype=torch.bool, device=vals.device)
    return mask.scatter_(1, keep, True)


def _naive_local_topk(vals: torch.Tensor, layout: ivf_mod.FlatLayout,
                      k: int):
    """The naive collector's local half: each shard's full top-k."""
    sel, pos = rb.smallest(vals, min(k, vals.shape[1]))
    ok = torch.isfinite(sel)
    return pos, ok, torch.where(ok, layout.order[pos], -1)


def _final_topk(gd: torch.Tensor, gi: torch.Tensor, k: int):
    """Final selection over the gathered survivors (ties to the lower pool
    position, as ``lax.top_k``); (+inf, -1) past the pool's width."""
    d, order = rb.smallest(gd, min(k, gd.shape[1]))
    i = torch.where(torch.isfinite(d), torch.gather(gi, 1, order), -1)
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = torch.nn.functional.pad(d, (0, pad), value=INF)
        i = torch.nn.functional.pad(i, (0, pad), value=-1)
    return d, i


def _tau_full(pred_state, count: int, qs: torch.Tensor) -> torch.Tensor:
    return torch.full((qs.shape[0],), rerank.predict_tau(pred_state, count),
                      dtype=torch.int32, device=qs.device)


def ivf_search_sharded(mesh, qs: torch.Tensor, stream: Stream,
                       layout: ivf_mod.FlatLayout, k: int, n_probe: int,
                       use_bbc: bool = True,
                       m: int = 128, cap_shard: int = 1,
                       budget: int | None = None,
                       pred_state: rerank.PredictorState | None = None,
                       pred_count: int | None = None,
                       slive: torch.Tensor | None = None):
    """Sharded batched IVF: exact distances in the local scan (the l2
    kernel), then the shard collector and the survivor collective.
    ``layout`` and ``stream`` are this rank's block; ``slive`` (F,) is this
    rank's block of the tombstone mask (None: every lane live).

    With ``pred_state`` the predicted tau floors the survivor threshold and
    the summed histogram feeds the EMA; returns ``(SearchResult,
    new_state)``.  Distances are exact in-scan, so the ids are the static
    path's."""
    predictive = pred_state is not None
    if predictive and not use_bbc:
        raise ValueError("predictive search requires use_bbc=True")
    bud = _shard_budget(budget, k, _n_shards(mesh), layout.n_flat, 2.0)
    tau_floor = None
    if predictive:
        count = max(pred_count, k) if pred_count is not None else k
        tau_floor = _tau_full(pred_state, count, qs)
    probed, lane_valid, _ = _routing(stream, layout, qs, n_probe, slive)
    dv = torch.where(lane_valid, ops.l2_exact_batch(stream.vectors, qs), INF)
    n = dist.hier_psum(lane_valid.sum(dim=1), mesh)
    if use_bbc:
        cbs, sample = _sharded_codebooks(layout, probed, dv,
                                         min(SAMPLE_TILES, n_probe),
                                         cap_shard, k, m, mesh)
        tau_spec = _sample_spec_tau(cbs, sample, k, n, m)
        if tau_floor is not None:
            tau_spec = torch.maximum(tau_spec, tau_floor)
        bucket, hist, spos, sok, scnt = ops.shard_collect_batch(
            dv, lane_valid, cbs.d_min, cbs.delta, cbs.ew_map, m, tau_spec,
            bud)
        pos, ok, _, _, ghist = dist.bbc_survivors_batch(
            bucket, dv, lane_valid, hist, k, bud, mesh,
            tau_floor=tau_floor, spec=(spos, sok, scnt, tau_spec))
        gids = torch.where(ok, layout.order[pos], -1)
    else:
        pos, ok, gids = _naive_local_topk(dv, layout, k)
    sd = torch.where(ok, torch.gather(dv, 1, pos), INF)
    gd, gi = dist.gather_survivors(mesh, sd, gids)
    d, i = dist.shard_rows(mesh, lambda a, b_: _final_topk(a, b_, k),
                           gd, gi)
    n = n.to(torch.int32)
    res = SearchResult(d, i, n, torch.zeros_like(n))
    if predictive:
        return res, rerank.predictor_update(pred_state, ghist)
    return res


def ivf_pq_search_sharded(mesh, qs: torch.Tensor, stream: Stream,
                          layout: ivf_mod.FlatLayout, k: int, n_probe: int,
                          n_cand: int, use_bbc: bool = True, m: int = 128,
                          cap_shard: int = 1, budget: int | None = None,
                          pred_state: rerank.PredictorState | None = None,
                          pred_count: int | None = None,
                          slive: torch.Tensor | None = None):
    """Sharded batched IVF+PQ: the ADC kernel over the local codes, the
    shard collector at ``n_cand`` granularity, the exact re-rank of each
    shard's survivors on that shard, and after the gather the batched
    path's top-``n_cand``-by-estimate cut (ties by global id,
    ``_kth_value_mask``) before the top-k by exact distance.  ``layout``
    and ``stream`` are this rank's block, and ``slive`` (F,) its block of
    the tombstone mask.

    Predictive (``pred_state``): the collective runs at ``pred_count``
    granularity with the predicted tau as a floor, and the pool is cut only
    to the batched predictive path's width.  Returns ``(SearchResult,
    new_state)``.  ``use_bbc=False``: the naive collector (each shard's
    top-k by estimate, re-ranked and gathered)."""
    predictive = pred_state is not None
    if predictive and not use_bbc:
        raise ValueError("predictive search requires use_bbc=True")
    shard_flat, s = layout.n_flat, _n_shards(mesh)
    count = _resolve_pred_count(pred_count, k, n_cand) if predictive \
        else n_cand
    bud = _shard_budget(budget, count, s, shard_flat, 2.0)
    tau_floor = _tau_full(pred_state, count, qs) if predictive else None
    probed, lane_valid, _ = _routing(stream, layout, qs, n_probe, slive)
    luts = pq_mod.adc_table(stream.pq, qs)
    est = _sqrt_est(ops.pq_adc_batch(stream.codes, luts), lane_valid)
    ghist = None
    if use_bbc:
        cbs, sample = _sharded_codebooks(layout, probed, est,
                                         min(SAMPLE_TILES, n_probe),
                                         cap_shard, n_cand, m, mesh)
        n_probed = dist.hier_psum(lane_valid.sum(dim=1), mesh)
        tau_spec = _sample_spec_tau(cbs, sample, count, n_probed, m)
        if tau_floor is not None:
            tau_spec = torch.maximum(tau_spec, tau_floor)
        bucket, hist, spos, sok, scnt = ops.shard_collect_batch(
            est, lane_valid, cbs.d_min, cbs.delta, cbs.ew_map, m, tau_spec,
            bud)
        pos, ok, _, _, ghist = dist.bbc_survivors_batch(
            bucket, est, lane_valid, hist, count, bud, mesh,
            tau_floor=tau_floor, spec=(spos, sok, scnt, tau_spec))
    else:
        pos, ok, _ = _naive_local_topk(est, layout, k)
    sel_est = torch.where(ok, torch.gather(est, 1, pos), INF)
    ex = _exact_dists_rows(stream.vectors, pos, qs, mask=ok)
    gids = torch.where(ok, layout.order[pos], -1)
    n_rr = dist.hier_psum(ok.sum(dim=1), mesh)
    ge, gx, gi = dist.gather_survivors(mesh, sel_est, ex, gids)
    if use_bbc:
        # the batched path's selection, re-applied to the gathered pool:
        # static, the top n_cand by estimate; predictive, its width.  The
        # cut bites only when the pool holds more than ncs survivors; n_rr
        # is summed over the shards, so every rank takes the same branch
        if predictive:
            ncs = min(_pred_budget(count, shard_flat * s), n_cand,
                      ge.shape[1])
        else:
            ncs = min(n_cand, ge.shape[1])
        fit = bool((n_rr <= ncs).all().item())

        def tail(ge, gx, gi):
            if not fit:
                keep = _kth_value_mask(ge, gi, ncs)
                gx = torch.where(keep, gx, INF)
                gi = torch.where(keep, gi, -1)
            return _final_topk(gx, gi, k)

        d, i = dist.shard_rows(mesh, tail, ge, gx, gi)
    else:
        d, i = dist.shard_rows(mesh, lambda a, b_: _final_topk(a, b_, k),
                               gx, gi)
    n_rr = n_rr.to(torch.int32)
    res = SearchResult(d, i, n_rr, torch.zeros_like(n_rr))
    if predictive:
        return res, rerank.predictor_update(pred_state, ghist)
    return res


def _straggler_exact(stream: Stream, qs: torch.Tensor,
                     pos: torch.Tensor, strag: torch.Tensor, k: int):
    """Exact distances of the straggler survivors at local positions
    ``pos``, from the batched fused path's source: one dense l2 pass over
    the local stream when any query has more stragglers than that path's
    gather budget, else the gathered rows.  So a lane's exact distance has
    the same bits in both deployments whenever the two take the same
    branch, as they do at full width (the band overflows the budget)."""
    n = stream.vectors.shape[0]
    budget = min(n, ((max(2 * k, 2048) + 127) // 128) * 128)
    if bool((strag.sum(dim=1) > budget).any().item()):
        dense = ops.l2_exact_batch(stream.vectors, qs)
        return torch.where(strag, torch.gather(dense, 1, pos), INF)
    return _exact_dists_rows(stream.vectors, pos, qs, mask=strag)


def ivf_rabitq_search_sharded(mesh, qs: torch.Tensor, stream: Stream,
                              layout: ivf_mod.FlatLayout, k: int, n_probe: int,
                              use_bbc: bool = True, m: int = 128,
                              eps0: float = 3.0, cap_shard: int = 1,
                              budget: int | None = None,
                              fused: bool | None = None,
                              pred_state: rerank.PredictorState | None = None,
                              pred_count: int | None = None,
                              slive: torch.Tensor | None = None):
    """Sharded batched IVF+RaBitQ.  ``layout`` and ``stream`` are this
    rank's block, ``slive`` (F,) its block of the tombstone mask.

    BBC: codebooks over the sampled upper bounds; the summed ub histogram
    thresholds at k (tau_ub), and a lane survives iff its lower bound's
    bucket is at or below tau_ub (Alg. 3's certainly-out test, distributed).
    Survivors are re-ranked exactly on their shard and the gathered top-k by
    exact distance is the single-device result set.

    Fused (``fused=None`` means True): the bound-fused kernel certifies the
    lanes whose lb bucket is at or below the inline gate (the sample's
    static tau, or the predicted tau on the predictive path) and gives their
    exact distances; only the straggler survivors are re-ranked after it,
    and ``n_second_pass`` is their count summed over the shards.
    ``fused=False`` is the two-phase form: the plain bounds, the bucket_hist
    kernel over ub, one exact gather of every survivor.

    Predictive: the band does not depend on the prediction, which only
    gates the inline exact leg; the summed ub histogram feeds the EMA.
    Returns ``(SearchResult, new_state)`` with the static path's ids.
    ``use_bbc=False``: the naive collector over the estimates."""
    predictive = pred_state is not None
    if predictive and not use_bbc:
        raise ValueError("predictive search requires use_bbc=True")
    if fused is None:
        fused = True
    b = qs.shape[0]
    bud = _shard_budget(budget, k, _n_shards(mesh), layout.n_flat, 4.0)
    count = k if pred_count is None else max(pred_count, k)
    probed, lane_valid, d2 = _routing(stream, layout, qs, n_probe, slive)
    g, nq = _rabitq_query_terms(stream, qs, d2)
    ghist = None
    n_second = torch.zeros(b, dtype=torch.int32, device=qs.device)

    def bounds():
        return numerics.rabitq_bounds_stream(
            stream.codes, stream.s2, stream.norm_o, stream.f_o, stream.cl,
            g, nq, lane_valid, eps0)

    if not use_bbc:
        est, _, _ = bounds()
        pos, ok, _ = _naive_local_topk(est, layout, k)
        ex = _exact_dists_rows(stream.vectors, pos, qs, mask=ok)
    else:
        st = min(SAMPLE_TILES, n_probe)
        if fused:
            s_local, _ = _rabitq_sample_ub(stream, layout, probed, g, nq,
                                           st, cap_shard, eps0)
        else:
            _, lb, ub = bounds()
            spos, ssok = ivf_mod.tile_positions(layout, probed[:, :st],
                                                cap_shard)
            s_local = torch.where(ssok, torch.gather(ub, 1, spos), INF)
        # the gathered sample is the union of the nearest st clusters' whole
        # membership, as on every sharded path
        (sample,) = dist.gather_survivors(mesh, s_local)
        cbs, tau_spec = dist.shard_rows(
            mesh, lambda s_: _rabitq_sample_plan(s_, k, count, st, n_probe,
                                                 m), sample)
        if fused:
            tau_inline = _tau_full(pred_state, count, qs) if predictive \
                else tau_spec
            tau_spec = torch.maximum(tau_spec, tau_inline)
            (_, lb, _, bucket_lb, _, _, hist_ub, exact_c, certified,
             _) = ops.fused_rabitq_scan_batch(
                stream.codes, stream.vectors, stream.s2, stream.norm_o,
                stream.f_o, stream.cl, g, qs, nq, lane_valid, cbs.d_min,
                cbs.delta, cbs.ew_map, m, tau_inline, eps0=eps0)
        else:
            bucket_lb = rb.bucketize(cbs, lb)
            _, hist_ub = ops.bucket_hist_batch(ub, lane_valid, cbs.d_min,
                                               cbs.delta, cbs.ew_map, m)
        # the speculative survivor buffer over the lb buckets: a pass of its
        # own, since the histogram (ub) and the survivor test (lb) read
        # different bounds
        spos, sok, scnt = ops.spec_compact_batch(bucket_lb, lane_valid,
                                                 tau_spec, bud)
        pos, ok, _, _, ghist = dist.bbc_survivors_batch(
            bucket_lb, lb, lane_valid, hist_ub, k, bud, mesh,
            spec=(spos, sok, scnt, tau_spec))
        if fused:
            cert, strag = dist.split_certified_survivors(pos, ok, certified)
            n_second = dist.hier_psum(strag.sum(dim=1), mesh).to(
                torch.int32)
            ex = torch.where(cert, torch.gather(exact_c, 1, pos),
                             _straggler_exact(stream, qs, pos, strag, k))
        else:
            ex = _exact_dists_rows(stream.vectors, pos, qs, mask=ok)
    gids = torch.where(ok, layout.order[pos], -1)
    n_rr = dist.hier_psum(ok.sum(dim=1), mesh).to(torch.int32)
    gx, gi = dist.gather_survivors(mesh, ex, gids)
    d, i = dist.shard_rows(mesh, lambda a, b_: _final_topk(a, b_, k),
                           gx, gi)
    res = SearchResult(d, i, n_rr, n_second)
    if predictive:
        return res, rerank.predictor_update(pred_state, ghist)
    return res
