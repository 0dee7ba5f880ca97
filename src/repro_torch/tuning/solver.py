"""Pure constrained solver: maximize QPS subject to recall@k >= target.

The formulation follows the ScaNN auto-tuning paper ("Automating Nearest
Neighbor Search Configuration with Constrained Optimization", PAPERS.md):
relax the recall constraint into the objective with a Lagrange multiplier,

    L(c, lam) = qps(c) + lam * min(0, recall(c) - target)

and search the multiplier for the smallest ``lam`` whose unconstrained
argmax satisfies the constraint.  Two layers:

* ``solve`` — given an already-evaluated sample set, bisect ``lam`` and
  return the winning sample.  Pure: same samples + target -> same answer,
  with deterministic tie-breaking on (score, recall, -cost, knob key).
* ``coordinate_descent`` — the sweep itself: explore the discrete knob grid
  one knob at a time from seeded starting points, scoring candidates with
  the current multiplier and updating it by dual ascent between rounds.
  ``evaluate`` is memoized by knob key, so the expensive engine builds run
  once per distinct configuration.

Nothing here reads a clock or unseeded RNG; byte-identical replay of a
tuner run reduces to the determinism of ``measure.Sample``'s inputs.
"""
from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch.tuning import knobs as kn
from repro_torch.tuning.measure import Sample

LAM_MAX = 1e9       # feasibility-dominating multiplier ceiling
BISECT_ITERS = 60   # enough for lam to resolve to ~1e-9 relative


def score(s: Sample, lam: float, target: float) -> float:
    """Lagrangian score of one sample (hinge penalty below the target)."""
    return s.qps_model + lam * min(0.0, s.recall - target)


def _argmax(samples: Sequence[Sample], lam: float, target: float) -> Sample:
    """Deterministic argmax of the Lagrangian over a sample set."""
    return max(samples, key=lambda s: (score(s, lam, target), s.recall,
                                       -s.cost_units, s.knobs.key()))


def solve(samples: Sequence[Sample], target: float
          ) -> tuple[Sample, float, bool]:
    """(winning sample, lam*, feasible) for one recall target.

    Bisects the multiplier on [0, LAM_MAX]: below lam* the argmax chases
    raw QPS into infeasible configurations, above it the hinge penalty
    forces feasibility; the returned sample is the feasible argmax at the
    crossover — the cheapest configuration that meets the target.  When no
    evaluated sample is feasible the highest-recall sample is returned with
    ``feasible=False`` (callers must surface this, not serve it silently).
    """
    if not samples:
        raise ValueError("solve() needs at least one sample")
    if not any(s.recall >= target for s in samples):
        return _argmax(samples, LAM_MAX, target), LAM_MAX, False
    lo, hi = 0.0, LAM_MAX
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        if _argmax(samples, mid, target).recall >= target:
            hi = mid
        else:
            lo = mid
    best = _argmax(samples, hi, target)
    return best, hi, True


def pareto_frontier(samples: Iterable[Sample]) -> list[Sample]:
    """Recall/cost Pareto-optimal subset, sorted by descending recall
    (the tuned degradation frontier ``DegradeLadder.from_frontier`` walks)."""
    ordered = sorted(samples, key=lambda s: (-s.recall, s.cost_units,
                                             s.knobs.key()))
    out: list[Sample] = []
    best_cost = np.inf
    for s in ordered:
        if s.cost_units < best_cost:
            out.append(s)
            best_cost = s.cost_units
    return out


def coordinate_descent(
    evaluate: Callable[[kn.KnobConfig], Sample],
    cell: kn.Cell,
    grid: dict[str, tuple],
    target: float,
    seed: int = 0,
    rounds: int = 2,
    n_starts: int = 2,
    lam0: float = 1e3,
) -> dict[str, Sample]:
    """Seeded coordinate descent over the discrete knob grid.

    From each start (the hand-tuned default plus ``n_starts - 1`` seeded
    random grid draws), sweep the knobs in declaration order, evaluating
    every grid value of one knob with the others held fixed and keeping the
    best Lagrangian score; between rounds the multiplier takes a dual-ascent
    step ``lam += lam * (target - best recall)`` clipped to [0, LAM_MAX], so
    infeasible regions get progressively penalized.  Every evaluation is
    memoized by knob key and the full memo (the sample set ``solve`` and
    ``pareto_frontier`` consume) is returned.

    Determinism: the RNG is ``np.random.default_rng(seed)`` drawn in a fixed
    order, grid iteration order is the dict/tuple order, and ties break on
    the knob key — same (grid, seed, evaluate) -> same memo, same answer.
    """
    rng = np.random.default_rng(seed)
    memo: dict[str, Sample] = {}

    def ev(cfg: kn.KnobConfig) -> Sample:
        cfg = kn.clamp(cfg, cell)
        s = memo.get(cfg.key())
        if s is None:
            s = evaluate(cfg)
            memo[cfg.key()] = s
        return s

    starts = [kn.default_config(cell)]
    for _ in range(max(n_starts - 1, 0)):
        draw = {knob: values[int(rng.integers(len(values)))]
                for knob, values in grid.items()}
        starts.append(kn.clamp(
            kn.KnobConfig(n_probe=draw.get("n_probe", 1),
                          n_cand=draw.get("n_cand"),
                          pred_count=draw.get("pred_count"),
                          fused=draw.get("fused"),
                          budget_slack=draw.get(
                              "budget_slack",
                              kn.BUDGET_SLACK[cell.method])), cell))

    for start in starts:
        lam = float(lam0)
        cur = ev(start)
        for _ in range(rounds):
            for knob, values in grid.items():
                cands = [ev(c) for c in
                         kn.neighbors(cur.knobs, knob, values, cell)]
                cands.append(cur)
                cur = max(cands, key=lambda s: (score(s, lam, target),
                                                s.recall, -s.cost_units,
                                                s.knobs.key()))
            lam = float(np.clip(lam + lam * (target - cur.recall),
                                0.0, LAM_MAX))
    return memo
