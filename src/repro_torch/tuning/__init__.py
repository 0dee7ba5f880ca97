"""Constrained auto-tuning of the engine's knob surface.

The port of the JAX package's ``repro.tuning``: **maximize QPS subject to
recall@k >= target**, solved per (method, k-bucket, corpus) over measured
recall/latency samples on a held-out query set with exact ground truth,
via Lagrangian relaxation with a deterministic seeded coordinate-descent
search ("Automating Nearest Neighbor Search Configuration with Constrained
Optimization", PAPERS.md).

Layout:

* ``knobs``   — the knob surface: types, valid ranges, coupling invariants,
  default grids.
* ``measure`` — one knob configuration -> a :class:`measure.Sample`
  (deterministic recall + work features, plus wall-clock diagnostics).
* ``solver``  — pure functions from samples to a chosen configuration;
  same samples + seed -> byte-identical choice.
* ``points``  — versioned :class:`points.OperatingPoint` records persisted
  as JSON in the reference's schema, and the :class:`points.PointStore`
  consumers resolve against (``SearchEngine.build(..., tuned=...)``,
  ``ServingState(tuned=)``, ``MutableIndex(tuned=)``, ``serve --tuned``,
  ``DegradeLadder.from_frontier``).  The port's store is its own file.
* ``autotune``— the orchestration: sweep a cell, solve for each recall
  target, emit points.
"""
from repro_torch.tuning import (autotune, knobs, measure,  # noqa: F401
                                points, solver)
from repro_torch.tuning.knobs import KnobConfig  # noqa: F401
from repro_torch.tuning.points import OperatingPoint, PointStore  # noqa: F401
