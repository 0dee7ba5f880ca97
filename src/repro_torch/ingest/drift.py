"""Predictor-warmth drift detector: histogram-distribution shift test.

The cross-batch ``PredictorState`` EMA is a distribution over bucket
indices; it stays valid across an engine swap only while the NEW engine's
bucket histograms look like the old ones.  The test is direct: run one
probe batch through the new engine from a cold state (its updated EMA is
exactly the mean probe histogram), normalize both EMAs to distributions,
and compare by total-variation distance.  Below the threshold the warm
state carries over; above it the state cold-resets (``predict_tau``
returns -1 until re-warmed, which the searchers treat as "no prediction":
correctness never rides on this, only the early-exact hit rate does).
The comparison runs on the host in float64, as in the reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import rerank


def normalized_ema(state: rerank.PredictorState) -> np.ndarray | None:
    """Bias-corrected EMA as a probability distribution over the (m+1)
    buckets; None while the state is cold (nothing to compare)."""
    w = float(state.weight)
    if w <= 0.0:
        return None
    p = np.asarray(state.ema.detach().cpu().numpy(), np.float64) / w
    s = p.sum()
    if s <= 0.0:
        return None
    return p / s


def tv_distance(p: np.ndarray, q: np.ndarray) -> float:
    """Total-variation distance between two bucket distributions."""
    return 0.5 * float(np.abs(np.asarray(p) - np.asarray(q)).sum())


def probe_histogram(engine, probe_qs) -> rerank.PredictorState:
    """One predictive probe batch through ``engine`` from a cold state:
    the returned state's normalized EMA is the mean probe-batch histogram,
    the new engine's bucket distribution on held-out queries."""
    _, fresh = engine.search_batch(probe_qs,
                                   pred_state=engine.predictor_init())
    return fresh


def carry_state(old_state: rerank.PredictorState,
                fresh_state: rerank.PredictorState,
                threshold: float) -> tuple[rerank.PredictorState, float, bool]:
    """Decide whether a warm predictor survives an engine swap.

    Returns ``(state, tv, carried)``: the old state (carried) when the TV
    shift between its normalized EMA and the fresh probe histogram is at
    most ``threshold``; a cold reset otherwise.  A cold old state carries
    trivially (nothing at risk); a missing probe signal keeps the old
    state (no evidence to reset on).
    """
    p = normalized_ema(old_state)
    if p is None:
        return old_state, 0.0, True
    q = normalized_ema(fresh_state)
    if q is None:
        return old_state, 0.0, True
    tv = tv_distance(p, q)
    if tv > threshold:
        m = int(old_state.ema.shape[0]) - 1
        return rerank.predictor_init(m, old_state.ema.device), tv, False
    return old_state, tv, True
