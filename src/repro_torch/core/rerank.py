"""Re-rank planning, batched over queries: the greedy bounded re-rank
(paper Alg. 3), the early re-rank plan (Alg. 4) and the cross-batch
threshold predictor.

The port of ``core/rerank.py:146-294`` (the batched Alg. 3 planning and
its finalize) and ``:365-497`` of the JAX package.  The predictor state
stays functional: each search call takes a ``PredictorState`` and returns
the next one.

``predict_tau`` runs on the host.  The state is m+1 floats, and its
cumulative sum must be the reference's to the bit, because the predicted
bucket is where that sum first reaches an integer count: JAX's CPU cumsum
adds in blocks of 16 (``_cumsum_f32``), and neither ``torch.cumsum`` (double
accumulation on the CPU, a parallel scan on the card) nor a plain running
sum gives its bits.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import buffer as rb

INF = float("inf")


class GreedyRerankResult(NamedTuple):
    """Greedy bounded re-rank (Alg. 3) output with work accounting; every
    field has a leading query axis."""
    topk_dists: torch.Tensor
    topk_ids: torch.Tensor
    n_reranked: torch.Tensor     # (B,) exact evaluations spent


class GreedyRerankPlan(NamedTuple):
    """Bound-derived re-rank plan: the uncertain band (B, n) plus the
    certain-in/out masks, the (B,) threshold buckets and both bucket ids."""
    rerank_mask: torch.Tensor    # uncertain band: exact distances needed
    certain_in: torch.Tensor     # provably inside the top-k (skipped)
    certain_out: torch.Tensor    # provably outside (skipped)
    tau_ub: torch.Tensor
    tau_lb: torch.Tensor
    a_lb: torch.Tensor
    a_ub: torch.Tensor


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
                            certain_in=certain_in, certain_out=valid & ~maybe,
                            tau_ub=tau_ub, tau_lb=tau_lb, a_lb=a_lb,
                            a_ub=a_ub)


def greedy_rerank_finalize(plan: GreedyRerankPlan,
                           exact_where_reranked: torch.Tensor,
                           lb: torch.Tensor, ids: torch.Tensor, k: int,
                           est: torch.Tensor) -> GreedyRerankResult:
    """The k smallest of the re-ranked band by exact distance, with the
    certain-in lanes first (keyed ``lb - 1e30``, which is -1e30 in fp32 for
    every one of them: they tie, and the stable sort keeps stream order
    as ``lax.top_k`` does).  Certain-in rows report their estimate ``est``,
    re-ranked rows their exact distance.  ``ids`` (n,) maps stream
    positions to corpus ids."""
    resolved = torch.where(plan.rerank_mask, exact_where_reranked, INF)
    sel_key = torch.where(plan.certain_in, lb - 1e30, resolved)
    _, idx = rb.smallest(sel_key, k)
    out_d = torch.where(torch.gather(plan.certain_in, 1, idx),
                        torch.gather(est, 1, idx),
                        torch.gather(exact_where_reranked, 1, idx))
    return GreedyRerankResult(
        topk_dists=out_d, topk_ids=ids[idx],
        n_reranked=torch.sum(plan.rerank_mask, dim=1).to(torch.int32))


class EarlyRerankPlan(NamedTuple):
    """Per-query predicted threshold bucket (B,) int32 and codebooks."""
    tau_pred: torch.Tensor
    cb: rb.BucketCodebook


def early_rerank_plan(sample_est: torch.Tensor, n_cand: int, n_sample: int,
                      n_total: int, m: int = 128,
                      valid: torch.Tensor | None = None) -> EarlyRerankPlan:
    """Alg. 4 line 4: tau_pred is the bucket of the
    (|sample| / |O| * n_cand)-th smallest sampled estimate of each query."""
    w = sample_est.shape[1]
    cb = rb.build_codebook(sample_est, k=min(n_cand, w), m=m, valid=valid)
    rank = max(int(round(n_cand * n_sample / max(n_total, 1))), 1)
    rank = min(rank, w)
    s = sample_est if valid is None else torch.where(valid, sample_est, INF)
    kth = torch.kthvalue(s, rank, dim=1).values
    tau_pred = rb.bucketize(cb, kth[:, None])[:, 0]
    return EarlyRerankPlan(tau_pred=tau_pred, cb=cb)


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
