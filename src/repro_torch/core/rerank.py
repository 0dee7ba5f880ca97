"""Re-ranking (paper §3.3): the minimal re-rank set and its two-heap
solution (Alg. 2), the greedy bounded re-rank (Alg. 3), the early re-rank
plan (Alg. 4) and the cross-batch threshold predictor.

The port of the JAX package's ``core/rerank.py``.  Alg. 3's plan has a
single-query form (``greedy_rerank_plan``, 1-D lanes, its two
bucketize + histogram passes through the bucket_hist kernel) and a batched
one (``greedy_rerank_plan_batch``); ``greedy_rerank_finalize`` and the
phase helpers take either.  ``minimal_rerank`` stays on the host (numpy
and heapq), as the paper's baseline does.  The predictor state stays
functional: each search call takes a ``PredictorState`` and returns the
next one.

``predict_tau`` runs on the host.  The state is m+1 floats, and its
cumulative sum must be the reference's to the bit, because the predicted
bucket is where that sum first reaches an integer count: JAX's CPU cumsum
adds in blocks of 16 (``_cumsum_f32``), and neither ``torch.cumsum`` (double
accumulation on the CPU, a parallel scan on the card) nor a plain running
sum gives its bits.
"""
from __future__ import annotations

import heapq
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import buffer as rb
from repro_torch.kernels import ops

INF = float("inf")


def _kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest entry of a 1-D tensor."""
    return rb.smallest(x, k)[0][k - 1]


def minimal_rerank_set(lb: torch.Tensor, ub: torch.Tensor,
                       exact: torch.Tensor, k: int,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """Observation 1's minimal re-rank set of one query: the lanes whose
    bound interval straddles the exact k-th distance (an oracle, for
    Exp-5's accounting)."""
    e = exact if valid is None else torch.where(valid, exact, INF)
    dist_k = _kth_smallest(e, k)
    mask = (lb <= dist_k) & (dist_k <= ub)
    return mask if valid is None else mask & valid


def minimal_rerank(lb: np.ndarray, ub: np.ndarray, k: int,
                   exact_fn: Callable[[int], float]):
    """Paper Alg. 2 (the IVF+RaBitQ+MIN baseline), on the host with heapq
    as a CPU implementation runs it.  ``exact_fn(i)`` is object i's exact
    distance.  Returns (top-k ids, their distances, exact evaluations)."""
    n = len(lb)
    h_u: list = []      # (-key, lb, i): max-heap by key (ub, then exact)
    h_l: list = []      # (lb, ub, i): min-heap by lb
    kth_ub = np.inf
    for i in range(n):
        if ub[i] < kth_ub or len(h_u) < k:
            heapq.heappush(h_u, (-ub[i], lb[i], i))
            if len(h_u) > k:
                nu, nl, ni = heapq.heappop(h_u)
                heapq.heappush(h_l, (nl, -nu, ni))
            kth_ub = -h_u[0][0]
        elif lb[i] < kth_ub:
            heapq.heappush(h_l, (lb[i], ub[i], i))

    n_reranked = 0
    resolved: dict[int, float] = {}
    while h_u and h_l:
        nu, lu, iu = h_u[0]
        ku = -nu
        ll, _, il = h_l[0]
        if ku <= ll:
            break       # the largest key inside is below every lb outside
        if lu <= ll and iu not in resolved:
            heapq.heappop(h_u)
            d = exact_fn(iu)
            n_reranked += 1
            resolved[iu] = d
            heapq.heappush(h_u, (-d, d, iu))
        else:
            heapq.heappop(h_l)
            if il in resolved:
                continue
            d = exact_fn(il)
            n_reranked += 1
            resolved[il] = d
            heapq.heappush(h_u, (-d, d, il))
            if len(h_u) > k:
                nu, nl, ni = heapq.heappop(h_u)
                if ni in resolved:
                    continue
                heapq.heappush(h_l, (nl, -nu, ni))
        while len(h_u) > k:
            nu, nl, ni = heapq.heappop(h_u)
            if ni not in resolved:
                heapq.heappush(h_l, (nl, -nu, ni))

    ids, ds = [], []
    for _, _, ni in h_u:
        if ni not in resolved:
            resolved[ni] = exact_fn(ni)
            n_reranked += 1
        ids.append(ni)
        ds.append(resolved[ni])
    out = np.argsort(ds, kind="stable")[:k]
    return np.asarray(ids)[out], np.asarray(ds)[out], n_reranked


class GreedyRerankResult(NamedTuple):
    """Greedy bounded re-rank (Alg. 3) output with work accounting; the
    fields carry the plan's query axis, if any."""
    topk_dists: torch.Tensor
    topk_ids: torch.Tensor
    n_reranked: torch.Tensor     # exact evaluations spent
    rerank_mask: torch.Tensor    # which lanes were re-ranked
    certain_in: torch.Tensor     # skipped: provably inside the top-k


class GreedyRerankPlan(NamedTuple):
    """Bound-derived re-rank plan: the uncertain band plus the certain-in
    mask, the threshold buckets and both bucket ids; (n,) lanes and scalar
    taus for one query, (B, n) and (B,) batched.  A valid lane in neither
    mask is provably outside the top-k."""
    rerank_mask: torch.Tensor    # uncertain band: exact distances needed
    certain_in: torch.Tensor     # provably inside the top-k (skipped)
    tau_ub: torch.Tensor
    tau_lb: torch.Tensor
    a_lb: torch.Tensor
    a_ub: torch.Tensor


def phase1_mask(plan: GreedyRerankPlan) -> torch.Tensor:
    """The band's likely-in part: lanes whose upper-bound bucket is at or
    below tau_ub.  Their exact distances tighten the threshold for phase
    2 (the vectorized form of Alg. 3's marginal-bucket loop)."""
    return plan.rerank_mask & (plan.a_ub <= plan.tau_ub[..., None])


def phase2_threshold(plan: GreedyRerankPlan, exact_p1: torch.Tensor,
                     k: int) -> torch.Tensor:
    """One query's safe threshold after phase 1: with C certain-in lanes
    (all inside the top-k), the (k - C)-th smallest phase-1 exact distance
    bounds Dist_k from above."""
    c = torch.sum(plan.certain_in)
    rank = torch.clamp(k - c, 1, exact_p1.shape[0])
    return torch.sort(exact_p1).values[rank - 1]


def greedy_rerank_plan(lb: torch.Tensor, ub: torch.Tensor, k: int,
                       valid: torch.Tensor | None = None,
                       m: int = 128) -> GreedyRerankPlan:
    """Alg. 3's plan for one query over (n,) bounds: a codebook over the k
    smallest upper bounds; both bounds bucketized and histogrammed by the
    bucket_hist kernel (``ops.bucket_hist``); tau_ub and tau_lb the
    threshold buckets of the two histograms; certain-in lanes have an ub
    bucket below tau_lb, the band is the rest with an lb bucket at most
    tau_ub (see ``greedy_bounded_rerank``)."""
    n = lb.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=lb.device)
    lbv = torch.where(valid, lb, INF)
    ubv = torch.where(valid, ub, INF)
    cb = rb.build_codebook(ubv[None], k=min(k, n), m=m)
    a_lb, hist_lb = ops.bucket_hist(lbv, valid, cb.d_min, cb.delta,
                                    cb.ew_map, m)
    a_ub, hist_ub = ops.bucket_hist(ubv, valid, cb.d_min, cb.delta,
                                    cb.ew_map, m)
    tau_ub = rb.threshold_bucket(hist_ub[None], k)[0][0]
    tau_lb = rb.threshold_bucket(hist_lb[None], k)[0][0]
    certain_in = valid & (a_ub < tau_lb)
    maybe = valid & (a_lb <= tau_ub)
    return GreedyRerankPlan(rerank_mask=maybe & ~certain_in,
                            certain_in=certain_in, tau_ub=tau_ub,
                            tau_lb=tau_lb, a_lb=a_lb, a_ub=a_ub)


def greedy_rerank_plan_batch(lb: torch.Tensor, ub: torch.Tensor, k: int,
                             valid: torch.Tensor,
                             m: int = 128) -> GreedyRerankPlan:
    """Batched Alg. 3 planning over (B, n) bounds.  Per query: codebooks
    over the k smallest upper bounds; ``tau_ub`` and ``tau_lb`` are the
    buckets of the k-th smallest ub and lb (``threshold_bucket`` of either
    histogram is exactly that order statistic, bucketize being monotone);
    certain-in lanes have ub bucket below tau_lb, the band is the rest of
    the lanes whose lb bucket is at most tau_ub.  Only values are
    selected, so ``torch.topk``'s tie order does not matter here."""
    kk = min(k, lb.shape[1])
    lbv = torch.where(valid, lb, INF)
    ubv = torch.where(valid, ub, INF)
    ub_topk = torch.topk(ubv, kk, dim=1, largest=False, sorted=True).values
    kth_lb = torch.topk(lbv, kk, dim=1, largest=False, sorted=True).values
    cbs = rb.build_codebook_from_topk(ub_topk, m=m)
    a_lb = rb.bucketize(cbs, lbv)
    a_ub = rb.bucketize(cbs, ubv)
    tau_ub = rb.bucketize(cbs, ub_topk[:, -1:])[:, 0]
    tau_lb = rb.bucketize(cbs, kth_lb[:, -1:])[:, 0]
    certain_in = valid & (a_ub < tau_lb[:, None])
    maybe = valid & (a_lb <= tau_ub[:, None])
    return GreedyRerankPlan(rerank_mask=maybe & ~certain_in,
                            certain_in=certain_in, tau_ub=tau_ub,
                            tau_lb=tau_lb, a_lb=a_lb, a_ub=a_ub)


def greedy_rerank_finalize(plan: GreedyRerankPlan,
                           exact_where_reranked: torch.Tensor,
                           lb: torch.Tensor, ids: torch.Tensor, k: int,
                           est: torch.Tensor | None = None,
                           ub: torch.Tensor | None = None
                           ) -> GreedyRerankResult:
    """The k smallest of the re-ranked band by exact distance, with the
    certain-in lanes first (keyed ``lb - 1e30``, which is -1e30 in fp32 for
    every one of them: they tie, and the stable sort keeps stream order
    as ``lax.top_k`` does).  Certain-in rows report their estimate ``est``
    (else the bound midpoint, else ``lb``), re-ranked rows their exact
    distance.  ``ids`` (n,) maps lane positions to corpus ids.  The lanes
    are the last axis: (n,) for one query, (B, n) batched."""
    resolved = torch.where(plan.rerank_mask, exact_where_reranked, INF)
    sel_key = torch.where(plan.certain_in, lb - 1e30, resolved)
    _, idx = rb.smallest(sel_key, k)
    if est is not None:
        report = est
    elif ub is not None:
        report = (lb + ub) * 0.5
    else:
        report = lb

    def at(t):
        return torch.take_along_dim(t, idx, dim=-1)

    out_d = torch.where(at(plan.certain_in), at(report),
                        at(exact_where_reranked))
    return GreedyRerankResult(
        topk_dists=out_d, topk_ids=ids[idx],
        n_reranked=torch.sum(plan.rerank_mask, dim=-1).to(torch.int32),
        rerank_mask=plan.rerank_mask, certain_in=plan.certain_in)


def greedy_rerank_finalize_compacted(plan: GreedyRerankPlan,
                                     exact_where_reranked: torch.Tensor,
                                     lb: torch.Tensor, ids: torch.Tensor,
                                     k: int, est: torch.Tensor,
                                     pos: torch.Tensor, ok: torch.Tensor,
                                     n_reranked: torch.Tensor
                                     ) -> GreedyRerankResult:
    """``greedy_rerank_finalize`` over (B, w) compacted lanes: ``pos`` the
    stream positions of every certain-in and band lane of each row, in
    stream order (``ops.spec_compact_batch``), ``ok`` false past a row's
    fill.  The keys, reports and exact distances are gathered at ``pos``
    and sorted with the same stable sort; every lane left out has key +inf,
    so with at least k lanes a row, the k picked are the full-width
    finalize's, bit for bit.  Batched lanes only; ``n_reranked`` (B,) is
    the caller's count of the band."""
    safe = pos.long().clamp(max=lb.shape[-1] - 1)

    def at(t, i=safe):
        return torch.gather(t, 1, i)

    certain_in = at(plan.certain_in) & ok
    exact = at(exact_where_reranked)
    resolved = torch.where(at(plan.rerank_mask) & ok, exact, INF)
    sel_key = torch.where(certain_in, at(lb) - 1e30, resolved)
    _, idx = rb.smallest(sel_key, k)
    lane = at(safe, idx)
    out_d = torch.where(at(certain_in, idx), at(est, lane), at(exact, idx))
    return GreedyRerankResult(
        topk_dists=out_d, topk_ids=ids[lane], n_reranked=n_reranked,
        rerank_mask=plan.rerank_mask, certain_in=plan.certain_in)


def greedy_bounded_rerank(lb: torch.Tensor, ub: torch.Tensor,
                          ids: torch.Tensor, k: int, exact_all: torch.Tensor,
                          valid: torch.Tensor | None = None, m: int = 128,
                          est: torch.Tensor | None = None
                          ) -> GreedyRerankResult:
    """Paper Alg. 3 for one query, at its bucket-level fixed point: the plan
    (``greedy_rerank_plan``), then the band's exact distances from
    ``exact_all`` and the finalize.  Given valid bounds (lb <= exact <= ub)
    the id set is the exact top-k set."""
    n = lb.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=lb.device)
    plan = greedy_rerank_plan(lb, ub, k, valid=valid, m=m)
    exact_where = torch.where(plan.rerank_mask, exact_all, INF)
    return greedy_rerank_finalize(plan, exact_where,
                                  torch.where(valid, lb, INF), ids, k,
                                  est=est, ub=ub)


def threshold_only_rerank_mask(lb: torch.Tensor, ub: torch.Tensor, k: int,
                               valid: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """The plain IVF+RaBitQ criterion (the paper's baseline): re-rank every
    lane whose lower bound is at most the k-th smallest upper bound."""
    u = ub if valid is None else torch.where(valid, ub, INF)
    mask = lb <= _kth_smallest(u, k)
    return mask if valid is None else mask & valid


class EarlyRerankPlan(NamedTuple):
    """Per-query predicted threshold bucket (B,) int32 and codebooks."""
    tau_pred: torch.Tensor
    cb: rb.BucketCodebook


def early_rerank_plan(sample_est: torch.Tensor, n_cand: int, n_sample: int,
                      n_total: int, m: int = 128,
                      valid: torch.Tensor | None = None,
                      squared: bool = False) -> EarlyRerankPlan:
    """Alg. 4 line 4: tau_pred is the bucket of the
    (|sample| / |O| * n_cand)-th smallest sampled estimate of each query.
    ``squared`` takes the sample's squared PQ estimates (their distances
    are the square roots, +inf off ``valid``), as the sample ADC gives
    them; codebooks and tau_pred are one ``rb.sample_plan``."""
    w = sample_est.shape[1]
    rank = max(int(round(n_cand * n_sample / max(n_total, 1))), 1)
    cb, tau_pred = rb.sample_plan(sample_est, min(n_cand, w), m, valid=valid,
                                  sqrt=squared, rank=min(rank, w))
    return EarlyRerankPlan(tau_pred=tau_pred, cb=cb)


def early_rerank_mask(plan: EarlyRerankPlan,
                      est: torch.Tensor) -> torch.Tensor:
    """(B, n) lanes predicted into the re-rank pool: estimate bucket at or
    below each query's tau_pred (their exact distance is computed inline,
    in the fused scan)."""
    return rb.bucketize(plan.cb, est) <= plan.tau_pred[:, None]


def update_tau_pred(plan: EarlyRerankPlan, est_so_far: torch.Tensor,
                    n_scanned: int, n_total: int, n_cand: int,
                    valid: torch.Tensor | None = None) -> EarlyRerankPlan:
    """Alg. 4 line 14: tau_pred refreshed from the (B, w) scanned prefix,
    the bucket of its (n_cand * n_scanned / n_total)-th smallest
    estimate."""
    rank = max(int(round(n_cand * n_scanned / max(n_total, 1))), 1)
    rank = min(rank, est_so_far.shape[1])
    s = est_so_far if valid is None else torch.where(valid, est_so_far, INF)
    kth = rb.smallest(s, rank)[0][:, rank - 1]
    tau_pred = rb.bucketize(plan.cb, kth[:, None])[:, 0]
    return EarlyRerankPlan(tau_pred=tau_pred, cb=plan.cb)


class PredictorState(NamedTuple):
    """EMA over batched (B, m+1) bucket histograms.

    ``ema`` (m+1,) float32 decayed sum of mean per-query histograms;
    ``weight`` () float32 decayed sum of ones (0 = cold: no prediction).
    """

    ema: torch.Tensor
    weight: torch.Tensor


def predictor_init(m: int, device="cpu") -> PredictorState:
    return PredictorState(
        ema=torch.zeros(m + 1, dtype=torch.float32, device=device),
        weight=torch.zeros((), dtype=torch.float32, device=device))


def predictor_update(state: PredictorState, hist: torch.Tensor,
                     decay: float = 0.8) -> PredictorState:
    """Fold one batch's (B, m+1) histograms into the EMA."""
    h = hist.reshape(-1, hist.shape[-1]).to(torch.float32)
    mean = h.sum(dim=0) / h.shape[0]      # integer sums: exact, then IEEE div
    return PredictorState(ema=decay * state.ema + (1.0 - decay) * mean,
                          weight=decay * state.weight + (1.0 - decay))


def _cumsum_f32(x: np.ndarray) -> np.ndarray:
    """float32 inclusive prefix sum in XLA's CPU association: sequential
    within blocks of 16, then the block totals' prefix (recursively) added
    to each block."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n <= 16:
        return np.cumsum(x, dtype=np.float32)
    nb = -(-n // 16)
    xp = np.zeros(nb * 16, np.float32)
    xp[:n] = x
    rows = np.cumsum(xp.reshape(nb, 16), axis=1, dtype=np.float32)
    carry = np.zeros(nb, np.float32)
    carry[1:] = _cumsum_f32(rows[:, -1])[:-1]
    return (rows + carry[:, None]).reshape(-1)[:n]


def predict_tau(state: PredictorState, count: int, margin: int = 1) -> int:
    """Predicted threshold bucket: the first bucket whose bias-corrected
    cumulative EMA count reaches ``count``, plus ``margin`` buckets of
    slack.  -1 while cold, so the first batch behaves like the static path.
    Computed on the host (see the module docstring)."""
    ema = state.ema.detach().cpu().numpy()
    weight = np.float32(state.weight.item())
    m = ema.shape[0] - 1
    corrected = ema / np.maximum(weight, np.float32(1e-12))
    cum = _cumsum_f32(corrected[:m])
    tau = int(np.searchsorted(cum, np.float32(count), side="left"))
    tau = min(tau + margin, m - 1)
    return tau if weight > 0 else -1


def predicted_fallback_mask(bucket: torch.Tensor, valid: torch.Tensor,
                            tau_pred: torch.Tensor,
                            tau_true: torch.Tensor) -> torch.Tensor:
    """Survivors the prediction missed: bucket in (tau_pred, max(tau_pred,
    tau_true)] on valid lanes.  The thresholds broadcast over the lane axis.
    """
    tau_used = torch.maximum(tau_pred, tau_true)
    return valid & (bucket > tau_pred[..., None]) & \
        (bucket <= tau_used[..., None])
