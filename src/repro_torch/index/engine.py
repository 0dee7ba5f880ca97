"""Batched search engine: the serving-side entry point of the port.

Wraps a built IVF+PQ index with its ``ivf.FlatLayout`` candidate stream
and the static search knobs, and serves (B, d) query batches through
``search.ivf_pq_search_batch``:

    eng = engine.SearchEngine.build(index, k=5000, n_probe=64)
    res = eng.search(qs)                            # (B, d) -> SearchResult
    state = eng.predictor_init()
    res, state = eng.search(qs, pred_state=state)   # predictive serving

Only the IVF+PQ strategy is ported so far.  What the JAX engine also does
raises ``NotImplementedError`` naming the ROADMAP item that brings it: no
request is quietly served through another path.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import rerank
from repro_torch.index import ivf as ivf_mod
from repro_torch.index import search as search_mod
from repro_torch.kernels.platform import resolve_device


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, "
        f"{item})")


@dataclass(frozen=True)
class SearchEngine:
    """Serving facade: index + layout + static knobs on one device."""
    index: search_mod.PQIndex
    layout: ivf_mod.FlatLayout
    k: int
    n_probe: int
    n_cand: int
    use_bbc: bool = True
    m: int = 128
    pred_count: int | None = None
    # fused-scan switch (None = the searcher's default: fused on CUDA)
    fused: bool | None = None
    device: torch.device = torch.device("cpu")

    @staticmethod
    def build(index, k: int, n_probe: int | None = None,
              n_cand: int | None = None, use_bbc: bool = True, m: int = 128,
              pred_count: int | None = None, fused: bool | None = None,
              device=None, vectors=None, mesh=None, tuned=None
              ) -> "SearchEngine":
        """Place ``index`` on ``device`` (the card unless ``device="cpu"``)
        and resolve the knobs: n_cand defaults to min(8k, N) and pred_count
        to max(2.5k, k + 1024); then n_probe, n_cand and pred_count are
        clamped to what this index can give."""
        dev = resolve_device(device)
        if mesh is not None:
            raise _not_ported("mesh-sharded serving", "item 14")
        if tuned is not None:
            raise _not_ported("tuned operating points", "item 11")
        if not isinstance(index, search_mod.PQIndex) or vectors is not None:
            raise _not_ported(f"the {type(index).__name__} engine strategy "
                              "(IVF, IVF+RaBitQ)", "items 5 and 6")
        if n_probe is None:
            raise ValueError("n_probe is required")
        index = search_mod.index_to(index, dev)
        ivf = index.ivf
        n_rows = int(ivf.cluster_sizes.sum().item())
        if n_cand is None:
            n_cand = min(8 * k, int(index.vectors.shape[0]))
        if pred_count is None:
            pred_count = search_mod._resolve_pred_count(None, k, n_cand)
        n_probe = min(n_probe, ivf.n_clusters)
        n_cand = min(n_cand, n_rows)
        pred_count = min(pred_count, n_cand)
        return SearchEngine(index=index, layout=ivf_mod.flat_layout(ivf),
                            k=k, n_probe=n_probe, n_cand=n_cand,
                            use_bbc=use_bbc, m=m, pred_count=pred_count,
                            fused=fused, device=dev)

    def predictor_init(self) -> rerank.PredictorState:
        """Cold cross-batch threshold-predictor state for this engine."""
        return rerank.predictor_init(self.m, self.device)

    def with_live(self, corpus_live) -> "SearchEngine":
        raise _not_ported("tombstone deletes (with_live)", "item 10")

    @property
    def dim(self) -> int:
        return int(self.index.vectors.shape[1])

    def warmup(self, batch_sizes=(1,),
               predictive: bool = False) -> "SearchEngine":
        """Run one search per batch width (and one predictive search against
        a throwaway cold state), so the kernels are built and loaded before
        the first timed request."""
        qs = torch.zeros(max(batch_sizes), self.dim, device=self.device)
        for b in sorted(set(int(b) for b in batch_sizes)):
            if b < 1:
                raise ValueError(f"batch sizes must be >= 1, got {b}")
            self.search_batch(qs[:b])
            if predictive:
                self.search_batch(qs[:b], pred_state=self.predictor_init())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def search(self, qs, pred_state=None):
        """(B, d) batch -> SearchResult (or ``(SearchResult, new_state)``
        with ``pred_state``)."""
        if torch.as_tensor(qs).ndim == 1:
            raise _not_ported("single-query search (the JAX package's "
                              "dedicated single-query searchers)", "item 8")
        return self.search_batch(qs, pred_state=pred_state)

    def search_batch(self, qs, pred_state=None):
        qs = torch.as_tensor(qs, dtype=torch.float32).to(self.device)
        return search_mod.ivf_pq_search_batch(
            self.index, qs, self.layout, k=self.k, n_probe=self.n_probe,
            n_cand=self.n_cand, use_bbc=self.use_bbc, m=self.m,
            fused=self.fused, pred_state=pred_state,
            pred_count=self.pred_count)
