"""Versioned operating-point records: the tuner's persisted contract.

An :class:`OperatingPoint` is one solved cell — (method, k-bucket, recall
target) -> knob settings — together with the provenance needed to trust it:
the corpus fingerprint it was measured on, the code commit, the tuner seed,
and the deterministic sample numbers the solver saw.  Wall-clock
measurements are deliberately EXCLUDED from the record so a re-run of the
tuner with the same inputs serializes byte-identically (the replay gate);
measured times are reported beside the points, never inside them.

A :class:`PointStore` is an ordered collection persisted as one JSON file.
The port keeps its own store (default ``tuned_points_torch.json`` at the
repo root, override with ``REPRO_TORCH_TUNED_POINTS``), so that points
measured on a card never land in the JAX package's ``tuned_points.json``;
both files have the reference's schema and no other key, so each package
reads the other's (``--tuned <path>``).  Consumers resolve with
:meth:`PointStore.resolve`: exact method, the nearest k-bucket (smallest
tuned k >= requested k, else the largest tuned k), highest recall target
<= the requested target.  A
resolution that crosses a corpus fingerprint is still returned — the knobs
are a better prior than the hand defaults — but flagged in ``provenance``
so serving summaries can attribute it.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from repro_torch.tuning.knobs import KnobConfig

SCHEMA_VERSION = 1
DEFAULT_PATH = "tuned_points_torch.json"
ENV_PATH = "REPRO_TORCH_TUNED_POINTS"
HAND_TUNED = "hand-tuned fallback"


def corpus_fingerprint(x) -> str:
    """12-hex-digit digest of the corpus bytes + shape (content identity).

    Hashes a C-contiguous float32 numpy copy (a tensor is copied to the
    host first), so the digest is the reference's on the same corpus: a
    tensor's own shape and dtype print as ``torch.Size([..])`` and
    ``torch.float32``, which would make every corpus look new."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.ascontiguousarray(np.asarray(x), dtype=np.float32)
    h = hashlib.sha256()
    h.update(str(x.shape).encode())
    h.update(str(x.dtype).encode())
    h.update(x.tobytes())
    return h.hexdigest()[:12]


def commit_fingerprint() -> str:
    """Short git commit of the working tree ('unknown' outside a repo);
    '-dirty' is appended when tracked files have uncommitted changes."""
    try:
        base = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=base, capture_output=True, text=True,
                             timeout=10)
        if rev.returncode != 0:
            return "unknown"
        dirty = subprocess.run(["git", "status", "--porcelain", "-uno"],
                               cwd=base, capture_output=True, text=True,
                               timeout=10)
        suffix = "-dirty" if dirty.stdout.strip() else ""
        return rev.stdout.strip() + suffix
    except (OSError, subprocess.SubprocessError):
        return "unknown"


@dataclass(frozen=True)
class OperatingPoint:
    """One solved (method, k-bucket, recall-target) cell.

    ``knobs`` are the engine settings the solver chose; ``recall`` /
    ``cost_units`` are the deterministic sample numbers it chose them on
    (recall measured against exact ground truth on the held-out set);
    ``feasible`` records whether the recall constraint was actually met —
    consumers must treat an infeasible point as advisory, never as a
    recall promise.
    """

    method: str
    k: int
    recall_target: float
    knobs: KnobConfig
    recall: float
    cost_units: float
    feasible: bool
    corpus: dict = field(default_factory=dict)   # n / d / kind / fingerprint
    commit: str = "unknown"
    seed: int = 0
    version: int = SCHEMA_VERSION

    @property
    def name(self) -> str:
        """Stable human-readable identity for attribution in summaries."""
        return (f"{self.method}/k{self.k}@r{self.recall_target:g}"
                f"#{self.corpus.get('fingerprint', '?')}")

    def to_json(self) -> dict:
        """Plain-dict form (canonical: knob dataclass flattened)."""
        d = asdict(self)
        d["knobs"] = asdict(self.knobs)
        return d

    @staticmethod
    def from_json(d: dict) -> "OperatingPoint":
        """Inverse of :meth:`to_json` (unknown keys rejected loudly)."""
        d = dict(d)
        d["knobs"] = KnobConfig(**d["knobs"])
        return OperatingPoint(**d)


def canonical_json(points) -> str:
    """Byte-stable serialization of a point list (sorted keys, fixed
    separators, records ordered by (method, k, -target)) — the replay
    gate compares these strings directly."""
    recs = sorted((p.to_json() for p in points),
                  key=lambda d: (d["method"], d["k"], -d["recall_target"]))
    return json.dumps({"schema_version": SCHEMA_VERSION, "points": recs},
                      indent=2, sort_keys=True)


class PointStore:
    """Ordered collection of operating points with nearest-cell resolution."""

    def __init__(self, points=()):  # noqa: D107
        self.points: list[OperatingPoint] = list(points)

    # -- persistence --------------------------------------------------------

    @staticmethod
    def default_path() -> str:
        """Store location: $REPRO_TORCH_TUNED_POINTS, else
        ``tuned_points_torch.json`` at the repo root (the port's own file,
        never the JAX package's ``tuned_points.json``)."""
        env = os.environ.get(ENV_PATH)
        if env:
            return env
        base = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        return os.path.join(base, DEFAULT_PATH)

    @classmethod
    def load(cls, path: str | None = None) -> "PointStore":
        """Load a store; missing or unreadable file -> empty store (every
        consumer has a documented hand-tuned fallback)."""
        path = path or cls.default_path()
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return cls()
        if doc.get("schema_version") != SCHEMA_VERSION:
            return cls()
        return cls(OperatingPoint.from_json(d) for d in doc.get("points", ()))

    def save(self, path: str | None = None) -> str:
        """Persist canonically; returns the path written."""
        path = path or self.default_path()
        with open(path, "w") as f:
            f.write(canonical_json(self.points) + "\n")
        return path

    # -- mutation -----------------------------------------------------------

    def add(self, point: OperatingPoint) -> None:
        """Insert, replacing any existing point for the same (method, k,
        target, corpus fingerprint) cell."""
        key = (point.method, point.k, point.recall_target,
               point.corpus.get("fingerprint"))
        self.points = [p for p in self.points
                       if (p.method, p.k, p.recall_target,
                           p.corpus.get("fingerprint")) != key]
        self.points.append(point)

    # -- resolution ---------------------------------------------------------

    def resolve(self, method: str, k: int, target: float = 0.95,
                corpus_fp: str | None = None, *,
                drift: float | None = None,
                drift_threshold: float = 0.10
                ) -> tuple[OperatingPoint | None, str]:
        """(point, provenance) for a serving cell; (None, HAND_TUNED) when
        the store has nothing usable for the method.

        Nearest-cell rule: exact method match required; among those, the
        smallest tuned k >= requested k (a point tuned for a larger k is
        recall-safe at a smaller one), else the largest tuned k; among
        those, the highest recall_target <= requested (else the lowest
        available).  Feasible points are always preferred over infeasible
        ones.  Provenance is ``'tuned'`` for an exact corpus match,
        ``'tuned-nearest'`` when the fingerprint differs.

        ``drift`` is the live corpus's churn fraction (inserted + deleted
        over base size — streaming ingest).  Past ``drift_threshold`` an
        exact fingerprint match is NO LONGER trusted as exact: the stored
        point was measured on the pre-churn corpus bytes, so the resolution
        falls back to nearest-cell semantics with provenance
        ``'tuned-drifted(<pct>)'`` and a ``UserWarning`` — never a silent
        stale hit.  The knobs are still returned (a measured point on the
        pre-churn corpus beats hand defaults), but ``tuned_from``
        attribution makes the staleness auditable.
        """
        cands = [p for p in self.points if p.method == method]
        if not cands:
            return None, HAND_TUNED
        drifted = drift is not None and drift > drift_threshold
        if drifted:
            import warnings
            warnings.warn(
                f"operating-point store resolved under corpus drift "
                f"{drift:.0%} > {drift_threshold:.0%} for {method}/k{k}: "
                f"treating tuned points as nearest-cell priors, not exact "
                f"matches (re-run the tuner after the next merge)",
                UserWarning, stacklevel=2)
            provenance = f"tuned-drifted({drift:.0%})"
        elif corpus_fp is not None and any(
                p.corpus.get("fingerprint") == corpus_fp for p in cands):
            cands = [p for p in cands
                     if p.corpus.get("fingerprint") == corpus_fp]
            provenance = "tuned"
        else:
            provenance = "tuned" if corpus_fp is None else "tuned-nearest"
        covering = [p for p in cands if p.k >= k]
        pool = covering or cands
        k_best = min(p.k for p in pool) if covering else max(
            p.k for p in pool)
        pool = [p for p in pool if p.k == k_best]
        under = [p for p in pool if p.recall_target <= target]
        pool = under or pool
        t_best = max(p.recall_target for p in pool) if under else min(
            p.recall_target for p in pool)
        pool = [p for p in pool if p.recall_target == t_best]
        pool.sort(key=lambda p: (not p.feasible, p.cost_units,
                                 p.knobs.key()))
        return pool[0], provenance

    def frontier(self, method: str, k: int,
                 corpus_fp: str | None = None) -> list[OperatingPoint]:
        """Degradation frontier for a cell: the resolved k-bucket's points
        across recall targets, sorted by descending target (the order
        ``DegradeLadder.from_frontier`` consumes)."""
        seen: dict[float, OperatingPoint] = {}
        for p in self.points:
            q, _ = self.resolve(method, k, target=p.recall_target,
                                corpus_fp=corpus_fp)
            if q is not None:
                seen[q.recall_target] = q
        return [seen[t] for t in sorted(seen, reverse=True)]

    def __len__(self) -> int:
        return len(self.points)
