"""The tunable knob surface: types, valid ranges, and coupling invariants.

Every knob the tuner may set is declared here with the invariant that bounds
it, so the solver cannot emit a configuration the engine would reject or —
worse — silently serve incorrectly.  The three contracts the engine's
correctness rides on (the reference's ``docs/tuning.md`` has the table):

* **threshold contract** — the predictive re-rank threshold is always
  ``max(tau_pred, tau_true)``: a mispredicted tau can only widen the pool,
  never narrow it below the true k-th bucket.  The tuner never touches tau
  directly; it only sizes the pools the contract operates on.
* **pool-subset contract** — the predictive pool is a subset of the static
  ``n_cand`` cut, so ``pred_count`` is clamped to ``[k, n_cand]``.
* **budget <= stream contract** — a per-shard survivor budget is a buffer
  width; it is clamped to the shard's stream length before any ``top_k``.

``clamp`` is the single normalization point: every configuration the sweep
evaluates and every configuration a persisted operating point resolves to
passes through it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterator

from repro_torch.core import distributed as dist

METHODS = ("ivf", "ivfpq", "ivfrabitq")

# Documented per-method survivor-budget slack over the balanced share
# (pool / n_shards).  These are the reference's hand constants, named,
# versioned inside every OperatingPoint, and clamped against the stream
# (dist.survivor_budget + the budget <= stream clamp in shard_budget()):
#   ivf       2.0 — exact in-scan distances, survivor counts concentrate
#                   tightly around k/S under round-robin dealing;
#   ivfpq     1.25 — the pool is the (larger) n_cand cut, so the balanced
#                   share is already wide and per-shard skew is relatively
#                   smaller (hypergeometric concentration);
#   ivfrabitq 4.0 — survivors are the lb<=tau band, which is data-dependent
#                   and several times wider than k's share.
BUDGET_SLACK = {"ivf": 2.0, "ivfpq": 1.25, "ivfrabitq": 4.0}


@dataclass(frozen=True)
class KnobConfig:
    """One point on the knob surface (a single engine configuration).

    Fields mirror ``SearchEngine.build`` arguments; ``None`` means "use the
    engine's per-method default".  Instances are hashable so sweeps can
    memoize evaluations.
    """

    n_probe: int                    # routing width, in [1, n_clusters]
    n_cand: int | None = None       # ivfpq estimate cut, in [k, n]
    pred_count: int | None = None   # predictive pool target, in [k, n_cand]
    fused: bool | None = None       # fused-scan switch (None = per-searcher)
    budget_slack: float | None = None   # sharded survivor-budget slack

    def key(self) -> str:
        """Canonical string key (deterministic ordering / tie-breaking)."""
        return (f"np={self.n_probe},nc={self.n_cand},pc={self.pred_count},"
                f"fu={self.fused},bs={self.budget_slack}")


@dataclass(frozen=True)
class Cell:
    """One tuning cell: the (method, k-bucket, corpus shape) a sweep runs in.

    ``n`` / ``d`` / ``n_clusters`` pin the corpus geometry the invariants
    are clamped against; they come from the built index, not from the
    caller's intent, so a configuration can never reference structure the
    index does not have.
    """

    method: str
    k: int
    n: int
    d: int
    n_clusters: int

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, "
                             f"got {self.method!r}")
        if not 1 <= self.k <= self.n:
            raise ValueError(f"k must be in [1, n={self.n}], got {self.k}")


def clamp(cfg: KnobConfig, cell: Cell) -> KnobConfig:
    """Normalize a configuration onto the valid knob surface of ``cell``.

    Applies every coupling invariant (n_probe within the routing grid,
    n_cand within [k, n], pred_count within [k, n_cand] — the pool-subset
    contract, slack positive).  Idempotent: ``clamp(clamp(c)) == clamp(c)``.
    """
    n_probe = max(1, min(int(cfg.n_probe), cell.n_clusters))
    n_cand = cfg.n_cand
    if cell.method != "ivfpq":
        n_cand = None               # the estimate cut exists only on PQ
    elif n_cand is not None:
        n_cand = max(cell.k, min(int(n_cand), cell.n))
    pred_count = cfg.pred_count
    if pred_count is not None:
        pred_count = max(cell.k, int(pred_count))
        if n_cand is not None:
            pred_count = min(pred_count, n_cand)    # pool-subset contract
    slack = cfg.budget_slack
    if slack is not None and slack <= 0:
        raise ValueError(f"budget_slack must be positive, got {slack}")
    return KnobConfig(n_probe=n_probe, n_cand=n_cand, pred_count=pred_count,
                      fused=cfg.fused, budget_slack=slack)


def default_config(cell: Cell) -> KnobConfig:
    """The hand-tuned default configuration the engine ships for this cell
    (the baseline the tuned point must beat): n_probe=64, n_cand=8k on PQ,
    engine-default pred_count, per-method budget slack."""
    n_cand = min(8 * cell.k, cell.n) if cell.method == "ivfpq" else None
    return clamp(KnobConfig(n_probe=64, n_cand=n_cand, pred_count=None,
                            fused=None,
                            budget_slack=BUDGET_SLACK[cell.method]), cell)


def grid(cell: Cell) -> dict[str, tuple]:
    """Per-knob discrete sweep values for a cell, every one pre-clamped.

    The grid is deliberately small (one engine build and one measured
    search per configuration are the sweep's unit cost): a geometric
    n_probe ladder over the routing grid for every method, plus the
    n_cand multiplier and pred_count ladders on ivfpq —
    the knobs whose measured effect the cost model can see.  ``fused`` and
    ``budget_slack`` stay single-valued by default (their defaults are
    documented per-method contracts, not free parameters); callers may
    extend the returned dict to sweep them.
    """
    c = cell.n_clusters
    # geometric ladder up to the FULL routing width: at k ~ n the recall
    # target is only reachable by probing (nearly) every cluster, so the
    # grid must contain that point for the constraint to be satisfiable
    n_probe = sorted({max(1, c // 16), max(1, c // 8), max(1, c // 4),
                      max(1, c // 2), min(64, c), c})
    g: dict[str, tuple] = {"n_probe": tuple(n_probe)}
    if cell.method == "ivfpq":
        # multiplier ladder plus the vacuous cut (n_cand = n): on corpora
        # where the PQ estimate ordering is weakly informative the target
        # may be unreachable under ANY bounded cut, so — as with the full
        # routing width above — the grid must contain the point that makes
        # the constraint satisfiable
        g["n_cand"] = tuple(sorted({min(m * cell.k, cell.n)
                                    for m in (2, 4, 8)} | {cell.n}))
        # pred_count ladder: the engine default (~2.5k) and a shallower
        # pool one rung above the floor; both clamped to [k, n_cand]
        g["pred_count"] = (None, max(cell.k + 1024, 3 * cell.k // 2))
    return g


def neighbors(cfg: KnobConfig, knob: str, values: tuple,
              cell: Cell) -> Iterator[KnobConfig]:
    """All clamped variants of ``cfg`` with ``knob`` set to each grid value
    (the coordinate-descent move set)."""
    seen = set()
    for v in values:
        c = clamp(replace(cfg, **{knob: v}), cell)
        if c.key() not in seen:
            seen.add(c.key())
            yield c


def base_pool(method: str, k: int, n_cand: int | None) -> int:
    """The survivor pool a sharded budget is sized against: the n_cand cut
    on ivfpq (the collective carries estimate survivors), k elsewhere."""
    return n_cand if (method == "ivfpq" and n_cand is not None) else k


def shard_budget(method: str, k: int, n_cand: int | None, n_shards: int,
                 stream_len: int | None = None,
                 slack: float | None = None) -> int:
    """Per-shard survivor budget for a configuration, invariants applied.

    Wraps ``dist.survivor_budget`` (balanced share x slack, 128-aligned)
    with the two contracts the tuner owns: the slack defaults to the
    method's documented ``BUDGET_SLACK`` entry, and the result is clamped
    to ``stream_len`` when given (budget <= stream — a short-stream shard
    must not be asked to compact more lanes than it holds).
    """
    slack = BUDGET_SLACK[method] if slack is None else float(slack)
    b = dist.survivor_budget(base_pool(method, k, n_cand), n_shards,
                             slack=slack)
    if stream_len is not None:
        b = min(b, int(stream_len))
    return max(b, 1)
