"""MutableIndex: frozen base generation + delta segments + tombstones.

The mutability model keeps every frozen invariant intact:

- The BASE is a normal built index (IVF / IVF+PQ / IVF+RaBitQ) wrapped in
  a ``SearchEngine``; it never mutates.  Base deletes are tombstone masks
  (``SearchEngine.with_live``) ANDed into the scan's lane masks.
- INSERTS land in append-only ``DeltaSegment`` buffers, scanned exactly
  per query and merged with the base results on the device (id spaces are
  disjoint, so the merge is one stable sort, no dedup).
- A background MERGE (``ingest.merge``) seals the current segments,
  checkpoints the live corpus, re-clusters/re-quantizes it into a new base
  generation off the serving path, and swaps it in (``complete_merge``).
  Queries keep serving the old generation + sealed segments until the
  swap; deletes arriving mid-merge are re-applied to the new generation at
  swap time, so a merge never resurrects a deleted row.

External ids are assigned monotonically and NEVER reused; ``row_ids`` is
kept ascending (initial ids are 0..n-1 and each merge folds segments whose
ids all exceed the previous base's), which makes base delete lookups a
binary search.  Ids must stay below 2**31.  The bookkeeping lives on the
host in numpy; the engine, the segments' scan copies and the merge of the
results live on the device (the card unless ``device="cpu"``, or the
mesh's on a sharded deployment, where every rank runs the same calls).
"""
from __future__ import annotations

import dataclasses

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.index import engine as engine_mod
from repro_torch.index import ivf as ivf_mod
from repro_torch.index import search as search_mod
from repro_torch.ingest import segment as segment_mod
from repro_torch.kernels.platform import resolve_device


@dataclass(frozen=True)
class IngestConfig:
    """Streaming-ingest knobs."""

    segment_capacity: int = 4096   # rows per delta segment
    merge_trigger: float = 0.10    # churn fraction that requests a merge
    drift_threshold: float = 0.25  # TV shift that cold-resets the predictor


@dataclass(frozen=True)
class MergeSnapshot:
    """Frozen input of an in-flight merge (what the checkpoint records)."""

    vectors: np.ndarray   # (n, d) live rows at seal time
    ids: np.ndarray       # (n,) external ids, ascending
    step: int             # target generation


class MutableIndex:
    """Segmented mutable ANN index over the frozen ``SearchEngine``.

    ``kind`` picks the base method ("ivf" | "ivfpq" | "ivfrabitq"); the
    engine-build knobs (``n_probe``/``n_cand``/...) are captured once and
    re-used by every generation rebuild.  ``mesh`` switches the base AND
    the delta scans to the sharded deployment.  ``tuned`` (a
    ``tuning.points.PointStore`` or one ``OperatingPoint``) fills the knobs
    left unset; a store is resolved at every generation's build with the
    corpus fingerprint and the churn share, so a point measured before
    the churn is flagged in ``engine.tuned_from``, never a silent stale
    hit.
    """

    def __init__(self, vectors, kind: str = "ivfpq", *, k: int,
                 n_probe: int | None = None, n_clusters: int | None = None,
                 n_cand: int | None = None, use_bbc: bool = True,
                 m: int = 128, mesh=None, shard_budget: int | None = None,
                 pred_count: int | None = None, fused: bool | None = None,
                 tuned=None, recall_target: float = 0.95,
                 config: IngestConfig | None = None, seed: int = 0,
                 device=None):
        if kind not in ("ivf", "ivfpq", "ivfrabitq"):
            raise ValueError(f"unknown kind: {kind!r}")
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.detach().cpu().numpy()
        vectors = np.ascontiguousarray(np.asarray(vectors, np.float32))
        self.kind = kind
        self.k = int(k)
        self.config = config or IngestConfig()
        self.seed = int(seed)
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device if mesh is not None and device is None else device)
        self.n_clusters = n_clusters or max(
            4, int(round(math.sqrt(len(vectors)))))
        self._recall_target = recall_target
        self._tuned = tuned
        self._build_kw = dict(
            n_probe=n_probe, n_cand=n_cand, use_bbc=use_bbc, m=m, mesh=mesh,
            shard_budget=shard_budget, pred_count=pred_count, fused=fused)
        self.segments: list[segment_mod.DeltaSegment] = []
        self._sealed: list[segment_mod.DeltaSegment] | None = None
        self.next_id = len(vectors)
        self.generation = 0
        self._inserted = 0
        self._deleted = 0
        self._scan_cache: dict[int, tuple[int, tuple]] = {}
        self._set_rows(vectors, np.arange(len(vectors), dtype=np.int64),
                       np.ones(len(vectors), bool))
        self.engine = self.build_engine(vectors, 0)

    # -- index / engine construction ---------------------------------------

    def _build_index(self, x: np.ndarray, generation: int):
        """The generation's index, from a ``torch.Generator`` seeded with
        ``seed + generation`` (the reference's ``jax.random.key(seed +
        generation)``, whose draws torch cannot reproduce)."""
        seed = self.seed + generation
        xt = torch.from_numpy(x).to(self.device)
        if self.kind == "ivf":
            return ivf_mod.build(xt, self.n_clusters, n_iter=6,
                                 generator=torch.Generator().manual_seed(seed))
        if self.kind == "ivfpq":
            return search_mod.build_pq_index(xt, self.n_clusters, n_iter=6,
                                             seed=seed, device=self.device)
        return search_mod.build_rabitq_index(xt, self.n_clusters, n_iter=6,
                                             seed=seed, device=self.device)

    def build_engine(self, x: np.ndarray, generation: int):
        """Re-cluster/re-quantize ``x`` into a generation-``generation``
        engine (the merge job's off-serving-path rebuild; also the initial
        build).  Tuned-point resolution passes the CURRENT churn fraction
        as ``drift`` so a point solved on the pre-churn corpus is flagged
        (never a silent stale hit): ``tuned_from`` carries the drifted
        provenance onto the engine."""
        index = self._build_index(x, generation)
        kw = dict(self._build_kw)
        if self.kind == "ivf":
            kw["vectors"] = torch.from_numpy(x)
        tuned, tuned_from = self._tuned, None
        if tuned is not None and hasattr(tuned, "resolve"):
            from repro_torch.tuning import points as tpoints
            point, prov = tuned.resolve(
                self.kind, self.k, target=self._recall_target,
                corpus_fp=tpoints.corpus_fingerprint(x),
                drift=self.churn_fraction())
            tuned = point
            if point is not None:
                tuned_from = f"{point.name} ({prov})"
        eng = engine_mod.SearchEngine.build(
            index, self.k, tuned=tuned, recall_target=self._recall_target,
            generation=generation,
            device=None if self.mesh is not None else self.device, **kw)
        if tuned_from is not None:
            eng = dataclasses.replace(eng, tuned_from=tuned_from)
        return eng

    def _set_rows(self, x: np.ndarray, ids: np.ndarray,
                  live: np.ndarray) -> None:
        self.row_vectors = x
        self.row_ids = ids
        self.row_live = live
        # the base's external ids on the device, for the result merge
        self._row_ids_dev = torch.from_numpy(ids).to(self.device)

    # -- mutation ------------------------------------------------------------

    def insert(self, vecs) -> np.ndarray:
        """Append rows to the delta tier; returns their external ids.
        Visible to the very next ``search`` call (no rebuild)."""
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        out, i = [], 0
        while i < len(vecs):
            seg = self._active_segment()
            take = min(seg.room, len(vecs) - i)
            ids = np.arange(self.next_id, self.next_id + take,
                            dtype=np.int64)
            seg.append(vecs[i:i + take], ids)
            self.next_id += take
            self._inserted += take
            out.append(ids)
            i += take
        return np.concatenate(out) if out else np.empty(0, np.int64)

    def delete(self, ext_ids) -> int:
        """Tombstone external ids (base rows via the engine's lane mask,
        segment rows via the segment's live flags).  Returns the number of
        rows actually deleted.  Deletes during an in-flight merge are
        recorded on the sealed segments / base mask too, so the merge's
        swap re-applies them to the new generation."""
        ext = np.atleast_1d(np.asarray(ext_ids, np.int64))
        count, base_changed = 0, False
        for e in ext:
            pos = int(np.searchsorted(self.row_ids, e))
            if (pos < len(self.row_ids) and self.row_ids[pos] == e
                    and self.row_live[pos]):
                self.row_live[pos] = False
                base_changed = True
                count += 1
                continue
            for seg in self._all_segments():
                if seg.delete(int(e)):
                    count += 1
                    break
        if base_changed:
            self.engine = self.engine.with_live(self.row_live)
        self._deleted += count
        return count

    # -- query ---------------------------------------------------------------

    def search(self, qs, pred_state=None):
        """Search the LIVE corpus: base engine + every segment, one merged
        top-k by a stable sort of [base, segment 1, segment 2, ...] (ties
        to the earlier part, as the reference's host merge).  (B, d) or
        (d,) queries; with ``pred_state`` returns ``(SearchResult,
        new_state)`` like the engine entry points.  The result lives on the
        device."""
        qs = torch.as_tensor(qs, dtype=torch.float32).to(self.device)
        single = qs.ndim == 1
        if single:
            qs = qs[None]
        out = self.engine.search_batch(qs, pred_state=pred_state)
        res, new_state = out if pred_state is not None else (out, None)
        d = res.dists
        safe = res.ids.clamp(0, len(self.row_ids) - 1).long()
        i = torch.where(res.ids >= 0, self._row_ids_dev[safe], -1)
        parts_d, parts_i = [d], [i]
        for seg in self._all_segments():
            if seg.n_live == 0:
                continue
            sd, si = self._scan_segment(seg, qs)
            parts_d.append(sd)
            parts_i.append(si)
        if len(parts_d) > 1:
            d = torch.cat(parts_d, dim=1)
            i = torch.cat(parts_i, dim=1)
            s = torch.sort(d, dim=1, stable=True)
            d = s.values[:, :self.k]
            i = torch.gather(i, 1, s.indices[:, :self.k])
        i = torch.where(torch.isfinite(d), i, -1)
        res = search_mod.SearchResult(d, i, res.n_reranked, res.n_second_pass)
        if single:
            res = search_mod.SearchResult(*(x[0] for x in res))
        return (res, new_state) if pred_state is not None else res

    # -- merge lifecycle -----------------------------------------------------

    def churn_fraction(self) -> float:
        """(inserts + deletes since the current generation was built) over
        the base size: the merge trigger's input."""
        return (self._inserted + self._deleted) / max(len(self.row_ids), 1)

    def needs_merge(self) -> bool:
        """True when accumulated churn crossed ``config.merge_trigger``."""
        return (self.churn_fraction() >= self.config.merge_trigger
                and (self._inserted + self._deleted) > 0)

    def live_corpus(self) -> tuple[np.ndarray, np.ndarray]:
        """(vectors, ids) of every live row (base + segments), ascending by
        id: the exact ground-truth corpus for recall gates."""
        parts_v = [self.row_vectors[self.row_live]]
        parts_i = [self.row_ids[self.row_live]]
        for seg in self._all_segments():
            mask = seg.live[:seg.size]
            parts_v.append(seg.vectors[:seg.size][mask])
            parts_i.append(seg.ids[:seg.size][mask])
        v = np.concatenate(parts_v, axis=0)
        i = np.concatenate(parts_i, axis=0)
        order = np.argsort(i)
        return v[order], i[order]

    def begin_merge(self) -> MergeSnapshot:
        """Seal the current segments and snapshot the live corpus (the
        merge input).  Serving continues on the sealed state; new inserts
        open fresh segments and ride through the merge as delta."""
        if self._sealed is not None:
            raise RuntimeError("a merge is already in flight")
        self._sealed = self.segments
        self.segments = []
        v, i = self.live_corpus()
        return MergeSnapshot(vectors=v, ids=i, step=self.generation + 1)

    def abort_merge(self) -> None:
        """Unwind ``begin_merge``: sealed segments return to the active
        set (prepended: their rows predate the post-seal segments)."""
        if self._sealed is None:
            return
        self.segments = self._sealed + self.segments
        self._sealed = None

    def complete_merge(self, engine, x: np.ndarray, ids: np.ndarray,
                       step: int) -> None:
        """The swap: the rebuilt engine becomes the base generation.
        Deletes recorded while the merge ran (base mask or sealed-segment
        tombstones) are re-applied as the new generation's lane mask, so
        the swap never resurrects a deleted row."""
        ids = np.asarray(ids, np.int64)
        live_now = np.concatenate(
            [self.row_ids[self.row_live]]
            + [s.ids[:s.size][s.live[:s.size]] for s in (self._sealed or [])]
        ).astype(np.int64)
        keep = np.isin(ids, live_now)
        self._set_rows(np.asarray(x, np.float32), ids, keep)
        self.engine = engine.with_live(keep) if not keep.all() else engine
        self._sealed = None
        self.generation = int(step)
        self._inserted = sum(s.size for s in self.segments)
        self._deleted = int((~keep).sum()) + sum(
            s.size - s.n_live for s in self.segments)
        self._scan_cache.clear()

    # -- internals -----------------------------------------------------------

    def _all_segments(self):
        return (self._sealed or []) + self.segments

    def _active_segment(self) -> segment_mod.DeltaSegment:
        if not self.segments or self.segments[-1].full:
            self.segments.append(segment_mod.DeltaSegment(
                self.config.segment_capacity, self.row_vectors.shape[1]))
        return self.segments[-1]

    def _scan_segment(self, seg: segment_mod.DeltaSegment, qs: torch.Tensor):
        ent = self._scan_cache.get(id(seg))
        if ent is None or ent[0] != seg.version:
            if self.mesh is not None:
                arrays = segment_mod.place_delta(self.mesh, seg)
            else:
                arrays = (torch.from_numpy(seg.vectors).to(self.device),
                          torch.from_numpy(seg.ids).to(self.device),
                          torch.from_numpy(seg.live).to(self.device))
            ent = (seg.version, arrays)
            self._scan_cache[id(seg)] = ent
        if self.mesh is not None:
            return segment_mod.delta_scan_sharded(self.mesh, qs, *ent[1],
                                                  k=self.k)
        return segment_mod.delta_scan(*ent[1], qs, k=self.k)
