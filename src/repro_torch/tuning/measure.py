"""Measure one knob configuration: deterministic recall + work features.

The solver's acceptance criterion is byte-identical replay: the same corpus,
index, query set and seed must produce the same operating point on every
re-run.  Wall-clock QPS is not replayable, so each evaluated configuration
is summarized by two kinds of numbers:

* **deterministic**: mean recall@k against exact ground truth on the
  held-out query set, and the work features the latency is made of (probed
  stream lanes from the routing geometry, re-ranked candidates and
  second-pass gathers reported by the engine).  The solver sees ONLY these.
* **diagnostic**: measured wall seconds per batch (after a warm call, the
  card synchronised around each timed call), reported beside the points,
  never used by the solver.

The deterministic latency surrogate is a fixed-weight linear model over the
work features (``cost_units``); ``fit_cost_model`` fits the same model to
the measured wall times as a calibration diagnostic.  The port of the JAX
package's ``repro.tuning.measure``: the routing geometry stays numpy
(float64 and a stable argsort), as in the reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.index import engine as engine_mod
from repro_torch.index import flat
from repro_torch.kernels.platform import resolve_device
from repro_torch.tuning.knobs import Cell, KnobConfig

# Reference per-lane weights of the deterministic latency surrogate:
#   cost_units = scanned + W_RERANK * reranked + W_SECOND * second_pass
# Scanned lanes are estimate-kernel work (1 unit); a re-ranked candidate
# pays a d-wide gather + exact L2 (~4 lanes of estimate work at the bench
# dimensionalities); an uncovered second-pass gather pays the same compute
# plus a separate dispatch (~8).  The weights are FIXED so the solver is
# pure; fit_cost_model reports how far a machine's measured surface is
# from them.
W_RERANK = 4.0
W_SECOND = 8.0


@dataclass(frozen=True)
class Sample:
    """One evaluated configuration: deterministic objective inputs plus
    wall-clock diagnostics."""

    knobs: KnobConfig
    recall: float               # mean recall@k on held-out queries (det.)
    scanned: float              # mean probed stream lanes / query (det.)
    reranked: float             # mean exact re-ranks / query (det.)
    second_pass: float          # mean uncovered gathers / query (det.)
    cost_units: float           # fixed-weight surrogate (det.)
    wall_s: float | None = None     # measured seconds / batch (diagnostic)

    @property
    def qps_model(self) -> float:
        """Deterministic throughput surrogate (bigger is better)."""
        return 1e6 / max(self.cost_units, 1.0)


def ground_truth_ids(x, queries, k: int, device=None) -> np.ndarray:
    """(Q, k) exact top-k ids for the held-out query set (brute force on
    ``device``: the card unless ``device="cpu"``; a tensor corpus stays on
    its own device)."""
    if isinstance(x, torch.Tensor):
        xt = x.to(torch.float32) if device is None else \
            x.to(device=device, dtype=torch.float32)
    else:
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            resolve_device(device))
    qs = torch.as_tensor(np.ascontiguousarray(
        queries.detach().cpu().numpy() if isinstance(queries, torch.Tensor)
        else queries, np.float32)).to(xt.device)
    return np.stack([flat.search(xt, q, k)[1].cpu().numpy() for q in qs])


def mean_recall(ids: np.ndarray, gt_ids: np.ndarray) -> float:
    """Mean per-query recall@k; -1 pad lanes never count as hits."""
    rs = []
    for got, want in zip(ids, gt_ids):
        g = set(got.tolist()) - {-1}
        rs.append(len(g & set(want.tolist())) / max(len(want), 1))
    return float(np.mean(rs))


def scanned_lanes(index_ivf, queries: np.ndarray, n_probe: int) -> float:
    """Mean probed stream lanes per query: the routing geometry's
    deterministic share of the scan cost (sum of probed cluster sizes),
    in float64 with a stable argsort on the host, as in the reference."""
    cents = _np(index_ivf.centroids).astype(np.float64)
    sizes = _np(index_ivf.cluster_sizes).astype(np.int64)
    queries = _np(queries)
    d2 = ((queries[:, None, :].astype(np.float64) - cents[None]) ** 2
          ).sum(-1)
    probed = np.argsort(d2, axis=1, kind="stable")[:, :n_probe]
    return float(sizes[probed].sum(axis=1).mean())


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def build_engine(index, cell: Cell, cfg: KnobConfig, vectors=None,
                 device=None) -> engine_mod.SearchEngine:
    """One single-device engine at this configuration (the sweep's unit)."""
    return engine_mod.SearchEngine.build(
        index, k=cell.k, n_probe=cfg.n_probe, n_cand=cfg.n_cand,
        pred_count=cfg.pred_count, fused=cfg.fused, vectors=vectors,
        device=device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(index, cell: Cell, cfg: KnobConfig, queries, gt_ids: np.ndarray,
            *, vectors=None, ivf=None, predictive: bool = False,
            warm_batches: int = 2, repeats: int = 3, timed: bool = True,
            device=None) -> Sample:
    """Evaluate one configuration on the held-out query set.

    ``predictive=True`` measures the tau_pred serving path (the predictor
    warmed on ``warm_batches`` calls over the query set before the
    measured call) so ``pred_count`` has a measurable effect; the static
    path is measured otherwise.  Recall measured on the predictive path is
    a LOWER bound for the static path at the same knobs (the predictive
    pool is a subset of the static cut), so a constraint satisfied here
    transfers to non-predictive serving.

    Everything entering the returned sample except ``wall_s`` is a
    deterministic function of (index, cfg, queries); ``timed=False`` skips
    the wall-clock repeats entirely (tests, replay verification).  The
    engine runs on ``device`` (the card unless ``device="cpu"``)."""
    eng = build_engine(index, cell, cfg, vectors=vectors, device=device)
    qs = torch.as_tensor(np.ascontiguousarray(_np(queries), np.float32)).to(
        eng.device)

    if predictive:
        state = eng.predictor_init()
        for _ in range(max(warm_batches, 1)):
            _, state = eng.search_batch(qs, pred_state=state)

        def call():
            res, _ = eng.search_batch(qs, pred_state=state)
            return res
    else:
        call = lambda: eng.search_batch(qs)    # noqa: E731

    res = call()
    _sync(eng.device)
    wall = None
    if timed:
        ts = []
        for _ in range(repeats):
            _sync(eng.device)
            t0 = time.perf_counter()
            call()
            _sync(eng.device)
            ts.append(time.perf_counter() - t0)
        wall = float(np.min(ts))

    ivf_index = ivf if ivf is not None else getattr(index, "ivf", index)
    scanned = scanned_lanes(ivf_index, _np(queries).astype(np.float64),
                            cfg.n_probe)
    reranked = float(np.mean(_np(res.n_reranked)))
    second = float(np.mean(_np(res.n_second_pass)))
    recall = mean_recall(_np(res.ids), gt_ids)
    cost = scanned + W_RERANK * reranked + W_SECOND * second
    return Sample(knobs=cfg, recall=round(recall, 6),
                  scanned=round(scanned, 1), reranked=round(reranked, 1),
                  second_pass=round(second, 1), cost_units=round(cost, 1),
                  wall_s=wall)


def fit_cost_model(samples) -> dict:
    """Least-squares fit of wall seconds on the work features (calibration
    diagnostic only: the solver always uses the fixed reference weights).

    Returns the fitted per-feature seconds and the correlation between the
    fixed-weight surrogate and the measured wall times over the sample set
    (1.0 = the surrogate ranks configurations exactly like this machine).
    """
    timed = [s for s in samples if s.wall_s is not None]
    if len(timed) < 3:
        return {"n": len(timed)}
    feats = np.array([[s.scanned, s.reranked, s.second_pass, 1.0]
                      for s in timed])
    wall = np.array([s.wall_s for s in timed])
    coef, *_ = np.linalg.lstsq(feats, wall, rcond=None)
    surrogate = np.array([s.cost_units for s in timed])
    corr = float(np.corrcoef(surrogate, wall)[0, 1]) \
        if len(timed) > 1 and np.std(surrogate) > 0 and np.std(wall) > 0 \
        else None
    return {"n": len(timed),
            "s_per_scanned": float(coef[0]),
            "s_per_reranked": float(coef[1]),
            "s_per_second_pass": float(coef[2]),
            "s_intercept": float(coef[3]),
            "surrogate_wall_corr": None if corr is None else round(corr, 4)}
