"""Search engine: the serving-side entry point of the port.

Wraps a built index (IVF, IVF+PQ or IVF+RaBitQ) with its ``ivf.FlatLayout``
candidate stream (``search.Stream``: the corpus and its codes in stream
order, gathered once at build) and the static search knobs, and serves
(B, d) query batches through the batched searchers of ``index.search`` and
(d,) single queries through its single-query searchers:

    eng = engine.SearchEngine.build(index, k=5000, n_probe=64)
    res = eng.search(qs)                            # (B, d) -> SearchResult
    res = eng.search(qs[0])                         # (d,): (k,) rows
    state = eng.predictor_init()
    res, state = eng.search(qs, pred_state=state)   # predictive serving

A single query with ``pred_state``, or on the sharded engine, is served as
a singleton batch (both paths are natively batched), as in the reference.

Sharded deployment is a build-time switch, on every rank of a process
group together:

    mesh = distributed.make_mesh((n_shards,), ("model",))
    eng = engine.SearchEngine.build(index, k=5000, n_probe=64, mesh=mesh)

The stream is split row-wise over the mesh (``ivf.sharded_layout``, round
robin within each cluster) and each rank builds and keeps only its own
block, on its device; every call runs the distributed BBC collector of
``core.distributed`` through the sharded searchers of ``index.search``, on
all ranks at once.

Each method is a strategy object chosen once, at build, from the index
type (``IVFIndex`` with ``vectors=``, ``PQIndex``, ``RabitqIndex``).

Deletes are a tombstone mask, not a rebuild: ``eng.with_live(corpus_live)``
returns an engine whose searchers AND the mask (permuted once into stream
order, this rank's block on a mesh) into their lane masks, so a dead row
is an unprobed lane.  The mask is a tensor input of every call; flipping
tombstones touches neither the layout nor the quantized streams.

Knobs may come from the constrained tuner's operating points:
``SearchEngine.build(index, k, tuned=store)`` fills every knob the caller
left unset from the point ``store`` resolves for (method, k,
``recall_target``), re-clamped to this k and this index, and records the
point in ``tuned_from``.  ``eng.with_knobs(k, n_probe)`` is an engine
with other knobs over the same index, layout and stream (the serving
state's shape buckets), and ``replica_clone()`` a new engine object over
the same tensors (the replica tier's respawn).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import rerank
from repro_torch.core.distributed import ShardMesh
from repro_torch.index import ivf as ivf_mod
from repro_torch.index import search as search_mod
from repro_torch.kernels.platform import resolve_device


class _IvfStrategy:
    """IVF (no quantization): exact distances in-scan."""

    kind = "ivf"

    def default_n_cand(self, index, k: int) -> int | None:
        return None

    def default_pred_count(self, k: int, n_cand: int | None) -> int:
        return k        # distances are exact in-scan: the pool target is k

    def search_one(self, eng: "SearchEngine", q):
        return search_mod.ivf_search(
            eng.index, eng.vectors, q, k=eng.k, n_probe=eng.n_probe,
            use_bbc=eng.use_bbc, m=eng.m)

    def search_batch(self, eng: "SearchEngine", qs, pred_state=None):
        return search_mod.ivf_search_batch(
            eng.index, eng.stream, qs, eng.layout, k=eng.k,
            n_probe=eng.n_probe, use_bbc=eng.use_bbc, m=eng.m,
            pred_state=pred_state, pred_count=eng.pred_count, live=eng.live)

    def search_sharded(self, eng: "SearchEngine", qs, pred_state=None):
        return search_mod.ivf_search_sharded(
            eng.mesh, qs, eng.stream, eng.shard_layout, k=eng.k,
            n_probe=eng.n_probe, use_bbc=eng.use_bbc, m=eng.m,
            cap_shard=eng.cap_shard, budget=eng.shard_budget,
            pred_state=pred_state, pred_count=eng.pred_count, slive=eng.live)


class _IvfPqStrategy:
    """IVF+PQ: ADC estimate -> n_cand selection -> exact re-rank."""

    kind = "ivfpq"

    def default_n_cand(self, index, k: int) -> int | None:
        return min(8 * k, int(index.vectors.shape[0]))

    def default_pred_count(self, k: int, n_cand: int | None) -> int:
        return search_mod._resolve_pred_count(None, k, n_cand)

    def search_one(self, eng: "SearchEngine", q):
        return search_mod.ivf_pq_search(
            eng.index, q, k=eng.k, n_probe=eng.n_probe, n_cand=eng.n_cand,
            use_bbc=eng.use_bbc, m=eng.m)

    def search_batch(self, eng: "SearchEngine", qs, pred_state=None):
        return search_mod.ivf_pq_search_batch(
            eng.index, eng.stream, qs, eng.layout, k=eng.k,
            n_probe=eng.n_probe, n_cand=eng.n_cand, use_bbc=eng.use_bbc,
            m=eng.m, fused=eng.fused, pred_state=pred_state,
            pred_count=eng.pred_count, live=eng.live)

    def search_sharded(self, eng: "SearchEngine", qs, pred_state=None):
        return search_mod.ivf_pq_search_sharded(
            eng.mesh, qs, eng.stream, eng.shard_layout, k=eng.k,
            n_probe=eng.n_probe, n_cand=eng.n_cand, use_bbc=eng.use_bbc,
            m=eng.m, cap_shard=eng.cap_shard, budget=eng.shard_budget,
            pred_state=pred_state, pred_count=eng.pred_count, slive=eng.live)


class _IvfRabitqStrategy:
    """IVF+RaBitQ: bounded estimates -> greedy bounded re-rank."""

    kind = "ivfrabitq"

    def default_n_cand(self, index, k: int) -> int | None:
        return None

    def default_pred_count(self, k: int, n_cand: int | None) -> int:
        return k        # the band is anchored at the k-th upper bound

    def search_one(self, eng: "SearchEngine", q):
        return search_mod.ivf_rabitq_search(
            eng.index, q, k=eng.k, n_probe=eng.n_probe, use_bbc=eng.use_bbc,
            m=eng.m)

    def search_batch(self, eng: "SearchEngine", qs, pred_state=None):
        return search_mod.ivf_rabitq_search_batch(
            eng.index, eng.stream, qs, eng.layout, k=eng.k,
            n_probe=eng.n_probe, use_bbc=eng.use_bbc, m=eng.m,
            fused=eng.fused, pred_state=pred_state,
            pred_count=eng.pred_count, live=eng.live)

    def search_sharded(self, eng: "SearchEngine", qs, pred_state=None):
        return search_mod.ivf_rabitq_search_sharded(
            eng.mesh, qs, eng.stream, eng.shard_layout, k=eng.k,
            n_probe=eng.n_probe, use_bbc=eng.use_bbc, m=eng.m,
            cap_shard=eng.cap_shard, budget=eng.shard_budget,
            fused=eng.fused, pred_state=pred_state,
            pred_count=eng.pred_count, slive=eng.live)


_STRATEGIES = {s.kind: s for s in
               (_IvfStrategy(), _IvfPqStrategy(), _IvfRabitqStrategy())}


def _resolve_strategy(index, vectors):
    if isinstance(index, search_mod.PQIndex):
        return _STRATEGIES["ivfpq"], index.ivf
    if isinstance(index, search_mod.RabitqIndex):
        return _STRATEGIES["ivfrabitq"], index.ivf
    if isinstance(index, ivf_mod.IVFIndex):
        if vectors is None:
            raise ValueError("kind 'ivf' needs the corpus vectors")
        return _STRATEGIES["ivf"], index
    raise TypeError(f"unsupported index type: {type(index)!r}")


def resolve_kind(index, vectors=None) -> str:
    """The method an index serves: "ivf", "ivfpq" or "ivfrabitq"."""
    return _resolve_strategy(index, vectors)[0].kind


def _knobs(strategy, index, ivf, k: int, n_probe, n_cand=None,
           pred_count=None, fused=None, tuned=None,
           recall_target: float = 0.95) -> dict:
    """An engine's k, n_probe, n_cand, pred_count, fused and tuned_from:
    the tuned point fills what the caller left unset, the method's
    defaults the rest, and n_probe, n_cand and pred_count are clamped to
    what ``ivf`` can give (see ``SearchEngine.build``)."""
    tuned_from = None
    if tuned is not None:
        from repro_torch.tuning import points as tuning_points
        if isinstance(tuned, tuning_points.OperatingPoint):
            point, provenance = tuned, "tuned"
        else:
            point, provenance = tuned.resolve(
                strategy.kind, k, target=recall_target)
        if point is not None:
            cfg = point.knobs
            n_probe = cfg.n_probe if n_probe is None else n_probe
            if n_cand is None and cfg.n_cand is not None:
                n_cand = max(cfg.n_cand, k)
            if pred_count is None and cfg.pred_count is not None:
                pred_count = max(cfg.pred_count, k)
                if n_cand is not None:
                    pred_count = min(pred_count, n_cand)
            fused = cfg.fused if fused is None else fused
            tuned_from = f"{point.name} ({provenance})"
    if n_probe is None:
        raise ValueError(
            "n_probe is required when no tuned operating point "
            "covers this (method, k) cell")
    if n_cand is None:
        n_cand = strategy.default_n_cand(index, k)
    if pred_count is None:
        pred_count = strategy.default_pred_count(k, n_cand)
    n_probe = min(n_probe, ivf.n_clusters)
    if n_cand is not None:
        n_cand = min(n_cand, int(ivf.cluster_sizes.sum().item()))
        pred_count = min(pred_count, n_cand)
    return dict(k=k, n_probe=n_probe, n_cand=n_cand, pred_count=pred_count,
                fused=fused, tuned_from=tuned_from)


@dataclass(frozen=True)
class SearchEngine:
    """Serving facade: index + layout + static knobs on one device, or on
    this rank's shard of a mesh."""
    index: Any                  # IVFIndex | PQIndex | RabitqIndex
    layout: ivf_mod.FlatLayout | None
    kind: str                   # "ivf" | "ivfpq" | "ivfrabitq"
    k: int
    n_probe: int
    n_cand: int | None = None
    use_bbc: bool = True
    m: int = 128
    pred_count: int | None = None
    # fused-scan switch (None = the searcher's default: fused PQ on CUDA,
    # bound-fused RaBitQ everywhere)
    fused: bool | None = None
    vectors: torch.Tensor | None = None   # the corpus, for kind "ivf"
    # the corpus and its codes in stream order (``search.build_stream``):
    # over ``layout``, or over ``shard_layout`` on a mesh; built once per
    # placed index and shared by every engine made from this one
    stream: search_mod.Stream | None = None
    device: torch.device = torch.device("cpu")
    # sharded deployment: the mesh, this rank's block of the stream layout,
    # the longest shard cluster segment, and the per-shard survivor budget
    # (None: ``distributed.survivor_budget``)
    mesh: ShardMesh | None = None
    shard_layout: ivf_mod.FlatLayout | None = None
    cap_shard: int = 1
    shard_budget: int | None = None
    # tombstones: a (n_flat,) stream-ordered bool mask on ``device`` (this
    # rank's (F,) block when sharded), ANDed into the lane masks at scan
    # time; None = every lane live.  Made from a corpus-row mask by
    # ``with_live``.
    live: torch.Tensor | None = None
    # streaming-ingest generation of the index this engine serves
    generation: int = 0
    # provenance of the knob values: the tuned OperatingPoint name that
    # filled caller-unset knobs at build time, or None for hand defaults
    # ("hand-tuned fallback" in serving summaries)
    tuned_from: str | None = None

    @property
    def strategy(self):
        return _STRATEGIES[self.kind]

    @staticmethod
    def build(index, k: int, n_probe: int | None = None,
              n_cand: int | None = None, use_bbc: bool = True, m: int = 128,
              pred_count: int | None = None, fused: bool | None = None,
              device=None, vectors=None, mesh=None,
              shard_budget: int | None = None, tuned=None,
              recall_target: float = 0.95,
              generation: int = 0) -> "SearchEngine":
        """Place ``index`` (and ``vectors``, for an ``IVFIndex``) on
        ``device`` (the card unless ``device="cpu"``) and resolve the knobs
        from the method's defaults; then n_probe, n_cand and pred_count are
        clamped to what this index can give.

        ``tuned`` (a ``tuning.points.PointStore``, resolved at this
        method, ``k`` and ``recall_target``, or one ``OperatingPoint``)
        fills the knobs the caller left unset before the defaults do;
        explicit arguments always win.  Pools tuned at another k are
        re-clamped onto this k (k <= pred_count <= n_cand).  Without a
        point, ``n_probe`` is required.

        With ``mesh`` (a ``distributed.ShardMesh``; every rank builds
        together) the engine keeps only this rank's shard of the stream, on
        the mesh's device, and serves through the sharded searchers; the
        index may stay where the caller holds it."""
        if mesh is not None:
            device = mesh.device if device is None else device
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
        dev = resolve_device(device)
        strategy, ivf = _resolve_strategy(index, vectors)
        knobs = _knobs(strategy, index, ivf, k, n_probe, n_cand, pred_count,
                       fused, tuned, recall_target)
        if vectors is not None:
            vectors = torch.as_tensor(vectors, dtype=torch.float32)
        if mesh is None:
            index = search_mod.index_to(index, dev)
            vectors = None if vectors is None else vectors.to(dev)
            layout = ivf_mod.flat_layout(
                index if strategy.kind == "ivf" else index.ivf)
            where = dict(layout=layout)
        else:
            slayout, cap_shard = ivf_mod.sharded_layout(ivf, mesh.n_shards)
            layout = ivf_mod.FlatLayout(*(t.to(dev) for t in
                                          slayout.local(mesh.shard_index)))
            where = dict(layout=None, mesh=mesh, shard_layout=layout,
                         cap_shard=cap_shard)
        return SearchEngine(
            index=index, kind=strategy.kind, use_bbc=use_bbc, m=m,
            vectors=vectors, device=dev, shard_budget=shard_budget,
            generation=generation, **where, **knobs,
            stream=search_mod.build_stream(index, layout, vectors))

    def with_knobs(self, k: int, n_probe: int | None = None,
                   pred_count: int | None = None,
                   tuned=None) -> "SearchEngine":
        """An engine over this one's index, layout, stream (this rank's
        block on a mesh) and tombstone mask, with the knobs that ``build``
        resolves from these arguments: nothing is placed, gathered or
        copied.  The serving state's shape buckets over one index are made
        this way."""
        strategy, ivf = _resolve_strategy(self.index, self.vectors)
        return dataclasses.replace(self, **_knobs(
            strategy, self.index, ivf, k, n_probe, pred_count=pred_count,
            tuned=tuned))

    def predictor_init(self) -> rerank.PredictorState:
        """Cold cross-batch threshold-predictor state for this engine."""
        return rerank.predictor_init(self.m, self.device)

    def with_live(self, corpus_live) -> "SearchEngine":
        """Engine with a tombstone mask: ``corpus_live[i]`` False deletes
        corpus row ``i`` from every search, without touching the layout or
        the quantized streams.  The (N,) mask (numpy or a tensor) is
        permuted into stream order (``corpus_live[clip(order)]``; padding
        lanes are masked by the layout anyway) and placed on the engine's
        device, this rank's block on a mesh.  ``None`` clears it.  Returns
        a new engine sharing every build-time artifact."""
        if corpus_live is None:
            return dataclasses.replace(self, live=None)
        if isinstance(corpus_live, torch.Tensor):
            corpus_live = corpus_live.to(torch.bool)
        else:
            corpus_live = torch.from_numpy(
                np.ascontiguousarray(np.asarray(corpus_live, dtype=bool)))
        if corpus_live.ndim != 1 or corpus_live.shape[0] < 1:
            raise ValueError(f"corpus_live must be (N,), got "
                             f"{tuple(corpus_live.shape)}")
        order = (self.layout if self.mesh is None else self.shard_layout).order
        pos = order.clamp(0, corpus_live.shape[0] - 1)
        live = corpus_live.to(order.device)[pos].to(self.device)
        return dataclasses.replace(self, live=live)

    def replica_clone(self) -> "SearchEngine":
        """A new engine object over the very same tensors (the layout, the
        stream, the tombstone mask): nothing is copied or moved.  The
        replica tier's respawn builds its fresh state from these
        (``ServingState.fork(clone_engines=True)``); the engine is
        immutable, so sharing is safe."""
        return dataclasses.replace(self)

    @property
    def dim(self) -> int:
        return int(self.stream.vectors.shape[1])

    def warmup(self, batch_sizes=(1,),
               predictive: bool = False) -> "SearchEngine":
        """Run one search per batch width (and one predictive search against
        a throwaway cold state), so the kernels are built and loaded before
        the first timed request.  Width 1 also runs the single-query
        searcher on the single-device engine (the sharded engine serves a
        single query as a singleton batch)."""
        qs = torch.zeros(max(batch_sizes), self.dim, device=self.device)
        for b in sorted(set(int(b) for b in batch_sizes)):
            if b < 1:
                raise ValueError(f"batch sizes must be >= 1, got {b}")
            self.search_batch(qs[:b])
            if b == 1 and self.mesh is None:
                self.search_one(qs[0])
            if predictive:
                self.search_batch(qs[:b], pred_state=self.predictor_init())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def search(self, qs, pred_state=None):
        """(B, d) batch or (d,) single query -> SearchResult (or
        ``(SearchResult, new_state)`` with ``pred_state``)."""
        with spans.span("engine.search"):
            if torch.as_tensor(qs).ndim == 1:
                return self.search_one(qs, pred_state=pred_state)
            return self.search_batch(qs, pred_state=pred_state)

    def _to_device(self, qs) -> torch.Tensor:
        """The queries as fp32 on the engine's device.  A host tensor's copy
        to the card returns when the copy is done (``wait.h2d``)."""
        with spans.span("engine.h2d"):
            qs = torch.as_tensor(qs, dtype=torch.float32)
            if qs.device.type == self.device.type:
                return qs.to(self.device)
            with spans.span("wait.h2d"):
                return qs.to(self.device)

    def search_one(self, q, pred_state=None):
        """One (d,) query -> SearchResult of (k,) rows and 0-d counters.
        Predictive search, the sharded engine and an engine with a
        tombstone mask (the masks live on the batched searchers) serve a
        singleton batch; otherwise the method's single-query searcher
        runs."""
        q = self._to_device(q)
        if pred_state is not None:
            res, state = self.search_batch(q[None], pred_state=pred_state)
            return search_mod.SearchResult(*(x[0] for x in res)), state
        if self.mesh is not None or self.live is not None:
            res = self.search_batch(q[None])
            return search_mod.SearchResult(*(x[0] for x in res))
        return self.strategy.search_one(self, q)

    def search_batch(self, qs, pred_state=None):
        qs = self._to_device(qs)
        if self.mesh is not None:
            return self.strategy.search_sharded(self, qs,
                                                pred_state=pred_state)
        return self.strategy.search_batch(self, qs, pred_state=pred_state)
