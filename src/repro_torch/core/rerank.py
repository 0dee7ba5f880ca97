"""Early re-rank planning (paper Alg. 4) and the cross-batch threshold
predictor, batched over queries.

The port of ``core/rerank.py:365-497`` of the JAX package.  The predictor
state stays functional: each search call takes a ``PredictorState`` and
returns the next one.

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
