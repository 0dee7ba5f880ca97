"""Per-shape-bucket engine and predictor-state ownership.

The cross-batch tau predictor (``core.rerank.PredictorState``) is an EMA
over bucket histograms, and histograms are only comparable when they come
from the same search configuration: the per-query codebooks depend on
``n_probe`` and the prediction target (``pred_count``) on ``k``.  Under
micro-batching the batch composition varies call to call, so a single
global predictor would mix histograms across shape buckets and drift.  This
module therefore keys BOTH the engines and the predictor states per
``ShapeBucket`` (a ``ServingState`` wraps exactly one index): each bucket
self-tunes on its own request stream.

``ServingState`` is the only stateful object the server loop owns; engines
stay immutable (``index.engine.SearchEngine``) and predictor states thread
through each call exactly as in ``launch/serve.py --tau-pred``, one state
per bucket.  Every engine lives on the state's device: the card unless the
caller asks for ``device="cpu"``.

``mesh`` builds every bucket engine on the sharded deployment; the state
is then one rank's, and every rank must make the same engine calls in the
same order (``serving.lockstep`` drives the other ranks from rank 0's
event loop).  ``live`` is a corpus-row tombstone mask applied to every
engine built, and ``swap`` re-points the state at a rebuilt index
(streaming ingest), carrying or resetting each bucket's predictor by the
drift test of ``ingest.drift``.  ``tuned`` (a ``tuning.points.PointStore``)
fills every bucket engine's unset knobs from the tuner's operating points;
``operating_points()`` reports where each bucket's knobs came from.
``fork`` gives the replica tier one state per replica over the shared
engines (``clone_engines=True``: engine objects of its own over the same
tensors, a respawned replica's), and ``centroids`` is the host copy of the
routing centroids the affinity router scores against.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import rerank
from repro_torch.index import engine as engine_mod
from repro_torch.index import search as search_mod
from repro_torch.ingest import drift as drift_mod
from repro_torch.kernels.platform import resolve_device
from repro_torch.serving.batcher import Batch, ShapeBucket

# what operating_points() reports for a bucket whose knobs are the
# engine's hand defaults
HAND_TUNED = "hand-tuned fallback"


class ServingState:
    """Engines + predictor states for every shape bucket the traffic hits.

    Engines are made lazily on first use of a bucket, one per (k ceiling,
    n_probe) (prefer ``warmup`` with the full bucket set at server start),
    and cached for the state's lifetime.  The first is a
    ``SearchEngine.build``; every other is that engine's ``with_knobs``,
    so all of them share one layout and one stream.  The index (and
    ``vectors``, required for the plain-IVF method as in
    ``SearchEngine.build``) is placed on ``device`` once; with ``mesh`` (a
    ``distributed.ShardMesh``) the engines live on the mesh's device and
    share this rank's block of the stream, so the index stays where the
    caller holds it.
    """

    def __init__(self, index: Any, *, use_bbc: bool = True,
                 tau_pred: bool = False, vectors=None, mesh=None,
                 m: int = 128, pred_count: int | None = None, tuned=None,
                 device=None):
        if tau_pred and not use_bbc:
            raise ValueError("tau_pred serving requires use_bbc=True")
        if mesh is not None and device is not None and \
                torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            resolve_device(device)
        self.use_bbc = use_bbc
        self.tau_pred = bool(tau_pred)
        self.m = m
        self.pred_count = pred_count
        # tuned operating points (a tuning.points.PointStore) every
        # per-bucket engine build resolves its unset knobs from
        self.tuned = tuned
        self._place(index, vectors)
        # streaming-ingest state: the generation counter keys engine swaps
        # (every bucket engine carries it), ``live`` is an optional
        # corpus-row tombstone mask applied to every built engine, and
        # ``drift_report`` records the last swap's per-bucket predictor
        # carry/reset decisions
        self.generation = 0
        self.live = None
        self.drift_report: dict[tuple[int, int], dict] = {}
        # engines depend only on (k, n_probe): two buckets that differ only
        # in batch width share one engine
        self._engines: dict[tuple[int, int], engine_mod.SearchEngine] = {}
        self._pred: dict[ShapeBucket, rerank.PredictorState] = {}

    def _place(self, index: Any, vectors) -> None:
        self.kind = engine_mod.resolve_kind(index, vectors)
        if vectors is not None:
            vectors = torch.as_tensor(vectors, dtype=torch.float32)
        if self.mesh is None:
            index = search_mod.index_to(index, self.device)
            vectors = None if vectors is None else vectors.to(self.device)
        self.index = index
        self.vectors = vectors

    # -- engines ------------------------------------------------------------

    def engine(self, bucket: ShapeBucket) -> engine_mod.SearchEngine:
        key = (bucket.k, bucket.n_probe)
        eng = self._engines.get(key)
        if eng is not None:
            return eng
        built = next(iter(self._engines.values()), None)
        if built is not None:
            # the index's layout, stream and mask, this bucket's knobs
            eng = built.with_knobs(bucket.k, n_probe=bucket.n_probe,
                                   pred_count=self.pred_count,
                                   tuned=self.tuned)
        else:
            eng = engine_mod.SearchEngine.build(
                self.index, k=bucket.k, n_probe=bucket.n_probe,
                use_bbc=self.use_bbc, m=self.m, vectors=self.vectors,
                pred_count=self.pred_count, mesh=self.mesh,
                device=None if self.mesh is not None else self.device,
                tuned=self.tuned, generation=self.generation)
            if self.live is not None:
                eng = eng.with_live(self.live)
        self._engines[key] = eng
        return eng

    def operating_points(self) -> dict[str, str]:
        """Per-bucket knob provenance for serving summaries: which tuned
        operating point (or the hand-tuned fallback) each built engine's
        knobs came from, keyed ``"k<k>/np<n_probe>"``."""
        return {f"k{k}/np{np_}": eng.tuned_from or HAND_TUNED
                for (k, np_), eng in sorted(self._engines.items())}

    def warmup(self, buckets) -> "ServingState":
        """Build every bucket's engine and run its padded (B, d) batch
        once (with ``tau_pred``, its predictive form too), so the kernels
        are built and loaded before the first request.  Partial batches
        are padded to B, so the batch shape is the ONLY one steady-state
        serving hits."""
        for bucket in sorted(set(buckets)):
            self.engine(bucket).warmup(batch_sizes=(bucket.batch,),
                                       predictive=self.tau_pred)
        return self

    def synchronize(self) -> None:
        """Wait for the work queued on the engines' CUDA stream (a no-op
        on the CPU): the end of a batch's service window."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- streaming-ingest swap ----------------------------------------------

    def swap(self, index: Any, *, vectors=None, live=None, probe_qs=None,
             drift_threshold: float = 0.25) -> dict[tuple[int, int], dict]:
        """Generation-aware engine swap (copy-on-swap): re-point this state
        at a rebuilt ``index`` without touching any fork serving the old
        generation.

        The engine cache is REPLACED with a fresh dict, never cleared in
        place: forks share the cache object by reference
        (``fork(clone_engines=False)``), so old forks keep resolving the
        OLD generation's engines while forks taken after the swap see only
        the new one.

        ``live`` is an optional corpus-row tombstone mask for the new
        generation (deletes that landed during the merge); ``vectors``
        replaces the corpus for the plain-IVF method.

        Predictor warmth: with ``tau_pred`` on and ``probe_qs`` given, each
        warm bucket's EMA is tested against one probe batch through the NEW
        engine (``ingest.drift``): carried when the bucket-histogram
        distribution shifted by at most ``drift_threshold`` (total
        variation), cold-reset otherwise.  Returns (and stores as
        ``drift_report``) ``{(k, n_probe): {"tv": .., "carried": ..}}``.
        """
        self._place(index, self.vectors if vectors is None else vectors)
        self.live = live
        self.generation += 1
        old_pred = self._pred
        self._engines = {}                      # copy-on-swap: NEW dict
        self._pred = {}
        report: dict[tuple[int, int], dict] = {}
        if self.tau_pred and probe_qs is not None and old_pred:
            qs = torch.as_tensor(probe_qs, dtype=torch.float32).to(
                self.device)
            for bucket, state in old_pred.items():
                fresh = drift_mod.probe_histogram(self.engine(bucket), qs)
                kept, tv, carried = drift_mod.carry_state(
                    state, fresh, drift_threshold)
                self._pred[bucket] = kept
                report[(bucket.k, bucket.n_probe)] = {
                    "tv": tv, "carried": carried}
        self.drift_report = report
        return report

    # -- replica hooks ------------------------------------------------------

    @property
    def centroids(self) -> np.ndarray:
        """Host numpy copy of the index's coarse centroids: the routing
        geometry the affinity router scores queries against (PQ and
        RaBitQ indexes carry them on ``.ivf``; an IVF index directly)."""
        ivf = self.index if hasattr(self.index, "centroids") \
            else self.index.ivf
        return ivf.centroids.detach().cpu().numpy()

    def fork(self, clone_engines: bool = False,
             pred_states=None) -> "ServingState":
        """A new ``ServingState`` sharing this one's (immutable) engines
        but owning FRESH per-bucket predictor states: each replica
        self-tunes on the traffic slice the affinity router sends it.

        With ``clone_engines=False`` (pool construction) the engine cache
        is the SAME dict, so a bucket's one-time build is shared across
        the pool.  With ``clone_engines=True`` (crash respawn) the fork
        gets its own cache seeded with ``SearchEngine.replica_clone()`` of
        every engine built so far: new engine objects over the same
        tensors, while later builds stay private to it.  ``pred_states``
        seeds the fork's predictor states (``restore_pred``)."""
        twin = type(self).__new__(type(self))
        twin.__dict__.update(self.__dict__)
        if clone_engines:
            twin._engines = {key: eng.replica_clone()
                             for key, eng in self._engines.items()}
        twin._pred = {}
        if pred_states:
            twin.restore_pred(pred_states)
        return twin

    def restore_pred(self, states) -> None:
        """Set this state's per-bucket predictor states (a respawn's
        checkpoint restore, a rolling swap's carried states); on a mesh
        every rank takes them (``serving.lockstep``)."""
        self._pred = dict(states)

    def release(self) -> None:
        """A replica's fork that the pool replaced (a respawn, a rolling
        swap) is dropped; on a mesh every rank drops it
        (``serving.lockstep``).  Nothing to do here."""

    # -- predictor states ---------------------------------------------------

    def pred_state(self, bucket: ShapeBucket) -> rerank.PredictorState:
        state = self._pred.get(bucket)
        if state is None:
            state = self.engine(bucket).predictor_init()
            self._pred[bucket] = state
        return state

    def pred_states(self) -> dict[ShapeBucket, rerank.PredictorState]:
        return dict(self._pred)

    # -- serving ------------------------------------------------------------

    def run(self, batch: Batch):
        """One engine call for an assembled batch; threads (and retains)
        the bucket's predictor state when ``tau_pred`` is on.  Returns the
        engine's ``SearchResult`` on the device, without waiting for it."""
        eng = self.engine(batch.bucket)
        qs = torch.from_numpy(np.ascontiguousarray(
            batch.queries, dtype=np.float32)).to(self.device)
        if self.tau_pred:
            res, new_state = eng.search_batch(
                qs, pred_state=self.pred_state(batch.bucket))
            self._pred[batch.bucket] = new_state
            return res
        return eng.search_batch(qs)
