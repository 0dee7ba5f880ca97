"""Streaming ingest: a segmented mutable index over the frozen engine.

The frozen machinery (layouts, quantized streams, ``SearchEngine``) never
mutates; mutability is layered on top of it:

- ``segment``: append-only ``DeltaSegment`` rows, scanned exactly with the
  exact-distance kernel (single-device and sharded forms).
- ``mutable``: ``MutableIndex``, the frozen base generation + delta
  segments + tombstones, merged into one result stream per query.
- ``merge``: the re-cluster/re-quantize job that folds sealed segments
  into a new base generation through a checksummed checkpoint.
- ``drift``: the histogram-distribution shift test deciding whether the
  cross-batch ``PredictorState`` stays warm across an engine swap.
"""
from repro_torch.ingest.drift import carry_state, probe_histogram, tv_distance
from repro_torch.ingest.merge import MergeCrash, MergeJob, resume_merge
from repro_torch.ingest.mutable import IngestConfig, MergeSnapshot, MutableIndex
from repro_torch.ingest.segment import DeltaSegment

__all__ = [
    "DeltaSegment",
    "IngestConfig",
    "MergeCrash",
    "MergeJob",
    "MergeSnapshot",
    "MutableIndex",
    "carry_state",
    "probe_histogram",
    "resume_merge",
    "tv_distance",
]
