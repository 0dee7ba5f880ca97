"""Append-only delta segments: the mutable tier's brute-force substrate.

A ``DeltaSegment`` is a fixed-capacity host-side row buffer (vectors,
external ids, live flags).  Inserts append; deletes flip ``live``; neither
touches the frozen base index.  At query time each segment is scanned
exactly (``ops.l2_exact_batch``, the exact-distance kernel on the card) and
its top-k' is merged with the base engine's results by the
``MutableIndex``.

The device copies are shaped by the segment CAPACITY, not its fill level,
so every scan of a segment launches the same shape; dead and never-filled
rows ride the live mask, exactly like the engine-side tombstones.

Segments align with ``ivf.sharded_layout``: ``shard_delta`` deals rows
round robin (row j to shard ``j % S``, the rule the sharded layout applies
per cluster), each rank scans its own rows, keeps a local top-k', and the
survivors alone are all-gathered (``distributed.gather_survivors``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import buffer as rb
from repro_torch.core import distributed as dist
from repro_torch.kernels import ops

INF = float("inf")
LANE = 128


class DeltaSegment:
    """Fixed-capacity append-only row buffer with tombstone flags.

    External ids are assigned by the owning ``MutableIndex`` and must fit
    int32 (the id range of the kernel paths).  ``version`` bumps on every
    append/delete so scan-side device copies know when they are stale.
    """

    def __init__(self, capacity: int, d: int):
        if capacity < 1:
            raise ValueError(f"segment capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.d = int(d)
        self.vectors = np.zeros((self.capacity, self.d), np.float32)
        self.ids = np.full((self.capacity,), -1, np.int64)
        self.live = np.zeros((self.capacity,), bool)
        self.size = 0          # rows ever appended (dead rows included)
        self.version = 0

    @property
    def room(self) -> int:
        """Rows that can still be appended."""
        return self.capacity - self.size

    @property
    def full(self) -> bool:
        """True when no more rows fit (dead rows still occupy their slot)."""
        return self.size >= self.capacity

    @property
    def n_live(self) -> int:
        """Live (not tombstoned) row count."""
        return int(self.live.sum())

    def append(self, vecs: np.ndarray, ids: np.ndarray) -> int:
        """Append rows (must fit: check ``room`` first).  Returns the count."""
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        n = len(ids)
        if n > self.room:
            raise ValueError(f"segment overflow: {n} rows into {self.room}")
        s = self.size
        self.vectors[s:s + n] = vecs
        self.ids[s:s + n] = ids
        self.live[s:s + n] = True
        self.size += n
        self.version += 1
        return n

    def delete(self, ext_id: int) -> bool:
        """Tombstone one external id; False if it is not live here."""
        hit = np.nonzero((self.ids[:self.size] == ext_id)
                         & self.live[:self.size])[0]
        if len(hit) == 0:
            return False
        self.live[hit[0]] = False
        self.version += 1
        return True


def delta_scan(vectors: torch.Tensor, ids: torch.Tensor, live: torch.Tensor,
               qs: torch.Tensor, *, k: int):
    """Exact masked scan of one segment: (B, k') ascending distances and
    external ids (k' = min(k, capacity); -1 ids past the live rows).  Ties
    go to the lower row, as ``lax.top_k`` breaks them in the reference.

    Dead and never-filled rows are +inf under the live mask, so they can
    never enter the top-k'."""
    d = ops.l2_exact_batch(vectors, qs)
    d = torch.where(live[None, :], d, INF)
    vals, pos = rb.smallest(d, min(k, vectors.shape[0]))
    return vals, torch.where(torch.isfinite(vals), ids[pos], -1)


def shard_delta(seg: DeltaSegment, n_shards: int, lane: int = LANE):
    """Deal a segment's rows round robin over ``n_shards`` (row j to shard
    ``j % n_shards``), padded to a common lane-rounded width.

    Returns host arrays ``(svecs (S, F, d) f32, sids (S, F) i32,
    slive (S, F) bool)``; padding rows are dead (id -1, live False).  The
    FULL capacity is dealt (dead rows included) so the placed arrays keep
    one shape for the segment's whole lifetime."""
    cap = seg.capacity
    f = (cap + n_shards - 1) // n_shards
    f = max(((f + lane - 1) // lane) * lane, lane)
    svecs = np.zeros((n_shards, f, seg.d), np.float32)
    sids = np.full((n_shards, f), -1, np.int32)
    slive = np.zeros((n_shards, f), bool)
    for j in range(n_shards):
        rows = np.arange(j, cap, n_shards)
        svecs[j, :len(rows)] = seg.vectors[rows]
        sids[j, :len(rows)] = seg.ids[rows].astype(np.int32)
        slive[j, :len(rows)] = seg.live[rows]
    return svecs, sids, slive


def place_delta(mesh, seg: DeltaSegment):
    """This rank's block of ``shard_delta`` on the mesh's device:
    ``(vectors (F, d), ids (F,) int64, live (F,))``."""
    svecs, sids, slive = shard_delta(seg, mesh.n_shards)
    j = mesh.shard_index
    return (torch.from_numpy(svecs[j]).to(mesh.device),
            torch.from_numpy(sids[j].astype(np.int64)).to(mesh.device),
            torch.from_numpy(slive[j]).to(mesh.device))


def delta_scan_sharded(mesh, qs: torch.Tensor, svecs: torch.Tensor,
                       sids: torch.Tensor, slive: torch.Tensor, *, k: int):
    """Sharded exact segment scan, on every rank together: each rank scans
    only its dealt rows (``place_delta``), keeps a local top-k', and the
    survivor-only gather assembles the (B, S*k') pool, rank-major.  Returns
    (dists, ids); the caller's merge re-sorts."""
    vals, lids = delta_scan(svecs, sids, slive, qs, k=k)
    return dist.gather_survivors(mesh, vals, lids)
