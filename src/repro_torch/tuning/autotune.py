"""Tune one cell end-to-end: sweep -> solve -> versioned operating points.

``tune_cell`` is the orchestration an offline tuning job calls: build the
cell from the index geometry, run the seeded coordinate-descent sweep over
the knob grid, then solve the constrained problem once per recall target
against the full memoized sample set (the sweep's evaluations are reused
across targets: one sweep, many points).  The ivfpq cell is swept on the
PREDICTIVE serving path so ``pred_count`` has a measurable effect; the
predictive pool is a subset of the static ``n_cand`` cut, so recall
measured there lower-bounds the static path and the constraint transfers
(see ``measure.measure``).

Determinism: every function here is a deterministic composition of the pure
solver and ``measure``'s deterministic fields.  Wall-clock enters only the
per-sample ``wall_s`` diagnostics, which never reach the persisted points.
The port of the JAX package's ``repro.tuning.autotune``; the sweep's
engines run on ``device`` (the card unless ``device="cpu"``).
"""
from __future__ import annotations

from repro_torch.index import engine as engine_mod
from repro_torch.tuning import knobs as kn
from repro_torch.tuning import measure as ms
from repro_torch.tuning import points as pts
from repro_torch.tuning import solver as sv

# Recall targets solved per cell, descending: the primary serving target
# first, then the degradation rungs the DegradeLadder walks.
DEFAULT_TARGETS = (0.95, 0.9, 0.8)


def make_cell(index, k: int, vectors=None) -> kn.Cell:
    """Cell geometry from a built index (method resolved by engine dispatch,
    n/d/n_clusters taken from the index, never from caller intent)."""
    method = engine_mod.resolve_kind(index, vectors)
    ivf = getattr(index, "ivf", index)
    n, d = (tuple(vectors.shape) if method == "ivf"
            else tuple(index.vectors.shape))
    return kn.Cell(method=method, k=k, n=int(n), d=int(d),
                   n_clusters=int(ivf.centroids.shape[0]))


def sweep_cell(index, cell: kn.Cell, queries, gt_ids, *, vectors=None,
               seed: int = 0, grid: dict | None = None, timed: bool = True,
               rounds: int = 2, n_starts: int = 2,
               device=None) -> dict[str, ms.Sample]:
    """Run the seeded coordinate-descent sweep; returns the full memo
    (every distinct configuration evaluated, keyed by knob key)."""
    grid = kn.grid(cell) if grid is None else grid
    ivf = getattr(index, "ivf", index)
    predictive = cell.method == "ivfpq"

    def evaluate(cfg: kn.KnobConfig) -> ms.Sample:
        return ms.measure(index, cell, cfg, queries, gt_ids,
                          vectors=vectors, ivf=ivf, predictive=predictive,
                          timed=timed, device=device)

    return sv.coordinate_descent(evaluate, cell, grid,
                                 target=max(DEFAULT_TARGETS), seed=seed,
                                 rounds=rounds, n_starts=n_starts)


def tune_cell(index, k: int, queries, gt_ids, *, vectors=None,
              targets=DEFAULT_TARGETS, seed: int = 0,
              corpus: dict | None = None, grid: dict | None = None,
              timed: bool = True, rounds: int = 2, n_starts: int = 2,
              device=None) -> dict:
    """Tune one (method, k) cell: one sweep, one solved point per target.

    Returns ``{"cell", "points", "samples", "frontier", "default",
    "cost_model"}``: the points are ready to ``PointStore.add``; the
    frontier is the recall/cost Pareto subset of everything evaluated
    (what ``DegradeLadder.from_frontier`` consumes); ``default`` is the
    hand-tuned baseline's sample; ``cost_model`` is the wall-time
    calibration diagnostic.
    """
    cell = make_cell(index, k, vectors=vectors)
    memo = sweep_cell(index, cell, queries, gt_ids, vectors=vectors,
                      seed=seed, grid=grid, timed=timed, rounds=rounds,
                      n_starts=n_starts, device=device)
    samples = [memo[key] for key in sorted(memo)]
    corpus = dict(corpus or {})
    corpus.setdefault("n", cell.n)
    corpus.setdefault("d", cell.d)
    commit = pts.commit_fingerprint()

    points = []
    for target in targets:
        best, _lam, feasible = sv.solve(samples, target)
        points.append(pts.OperatingPoint(
            method=cell.method, k=cell.k, recall_target=float(target),
            knobs=best.knobs, recall=best.recall,
            cost_units=best.cost_units, feasible=feasible,
            corpus=corpus, commit=commit, seed=seed))

    default_cfg = kn.default_config(cell)
    default = memo.get(default_cfg.key())
    return {"cell": cell, "points": points, "samples": samples,
            "frontier": sv.pareto_frontier(samples), "default": default,
            "cost_model": ms.fit_cost_model(samples)}
