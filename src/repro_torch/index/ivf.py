"""IVF coarse index: k-means partition, cluster-major stream layout, routing.

``IVFIndex`` keeps the padded (n_clusters, cap) member table of the JAX
package (``cap`` is the largest cluster rounded up to 128).  ``FlatLayout``
re-orders the corpus cluster by cluster with no per-cluster padding: the
batched searchers gather the candidate stream once per batch in this order
and give each query a boolean lane mask over it (``probe_mask``; the
routing computes the same bits with ``ops.probe_mask_batch``).  The
single-query searchers read the padded table directly (``route``,
``gather_candidates``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import buffer as rb
from repro_torch.core import numerics
from repro_torch.index import kmeans as km


class IVFIndex(NamedTuple):
    """Coarse IVF index: centroids plus the padded per-cluster member table."""
    centroids: torch.Tensor      # (n_clusters, d)
    member_ids: torch.Tensor     # (n_clusters, cap) int32, -1 padded
    member_valid: torch.Tensor   # (n_clusters, cap) bool
    cluster_sizes: torch.Tensor  # (n_clusters,) int32

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.member_ids.shape[1]


def pack_members(assignment: np.ndarray, n_clusters: int,
                 lane: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """(member_ids (n_clusters, cap) int32 with ascending ids and -1 padding,
    sizes (n_clusters,) int32) from a cluster assignment."""
    sizes = np.bincount(assignment, minlength=n_clusters)
    cap = max(int(sizes.max()), 1)
    cap = ((cap + lane - 1) // lane) * lane
    order = np.argsort(assignment, kind="stable")
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    a_sorted = assignment[order]
    rank = np.arange(order.shape[0]) - starts[a_sorted]
    ids = np.full((n_clusters, cap), -1, np.int32)
    ids[a_sorted, rank] = order
    return ids, sizes.astype(np.int32)


def build(x: torch.Tensor, n_clusters: int, n_iter: int = 10,
          lane: int = 128, generator: torch.Generator | None = None,
          init_idx: torch.Tensor | None = None) -> IVFIndex:
    """k-means on ``x``'s device + host-side packing of the member table."""
    cent, a = km.kmeans(x, n_clusters, n_iter, generator=generator,
                        init_idx=init_idx)
    ids, sizes = pack_members(a.cpu().numpy(), n_clusters, lane)
    dev = x.device
    ids_t = torch.from_numpy(ids).to(dev)
    return IVFIndex(centroids=cent, member_ids=ids_t,
                    member_valid=ids_t >= 0,
                    cluster_sizes=torch.from_numpy(sizes).to(dev))


def route_batch_centroids(centroids: torch.Tensor, qs: torch.Tensor,
                          n_probe: int):
    """(B, n_probe) nearest-first probed clusters (ties to the lower id) and
    the (B, C) squared query-centroid distances.

    The broadcast difference, not the norm identity, as in the reference:
    nearest-first order matters, because the codebook sample reads the
    first probed clusters.  The sum over d runs in ``numerics.ordered_sum``'s
    fixed order, so the CPU and the card route alike and RaBitQ's norm_q
    (the square root of ``d2``) has the same bits on both."""
    diff = centroids[None, :, :] - qs[:, None, :]
    d2 = numerics.ordered_sum(diff * diff)
    return rb.smallest(d2, n_probe)[1], d2


def route_batch_d2(index: IVFIndex, qs: torch.Tensor, n_probe: int):
    return route_batch_centroids(index.centroids, qs, n_probe)


def route(index: IVFIndex, q: torch.Tensor, n_probe: int) -> torch.Tensor:
    """Nearest-first (n_probe,) probed clusters of one (d,) query: the
    batched routing's first row, so the single-query and batched paths
    probe the same clusters in the same order."""
    return route_batch_centroids(index.centroids, q[None], n_probe)[0][0]


def gather_candidates(index: IVFIndex, probed: torch.Tensor):
    """(n_probe, cap) candidate ids (-1 padded) and validity of the probed
    clusters' rows of the member table."""
    return index.member_ids[probed], index.member_valid[probed]


class FlatLayout(NamedTuple):
    """Corpus ids re-ordered by cluster, with zero per-cluster padding.

    ``order``      (n_flat,) int64 corpus ids, cluster-major.
    ``cluster_of`` (n_flat,) int64 owning cluster; n_clusters on the tail.
    ``offsets``    (n_clusters + 1,) int64 start of each cluster.
    ``valid``      (n_flat,) bool, False on the padding tail (to 128 lanes).
    """

    order: torch.Tensor
    cluster_of: torch.Tensor
    offsets: torch.Tensor
    valid: torch.Tensor

    @property
    def n_flat(self) -> int:
        return self.order.shape[0]


def flat_layout(index: IVFIndex, lane: int = 128) -> FlatLayout:
    """Host-side packing of the member table into a FlatLayout."""
    ids = index.member_ids.cpu().numpy()
    sizes = index.cluster_sizes.cpu().numpy().astype(np.int64)
    n_clusters = ids.shape[0]
    n = int(sizes.sum())
    n_flat = ((n + lane - 1) // lane) * lane
    order = np.zeros(n_flat, np.int64)
    order[:n] = ids[ids >= 0]                 # row-major = cluster-major
    cluster_of = np.full(n_flat, n_clusters, np.int64)
    cluster_of[:n] = np.repeat(np.arange(n_clusters), sizes)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    dev = index.member_ids.device
    return FlatLayout(order=torch.from_numpy(order).to(dev),
                      cluster_of=torch.from_numpy(cluster_of).to(dev),
                      offsets=torch.from_numpy(offsets).to(dev),
                      valid=torch.arange(n_flat, device=dev) < n)


def probe_mask(layout: FlatLayout, probed: torch.Tensor,
               n_clusters: int) -> torch.Tensor:
    """(B, n_flat) lane mask: lane j is live for query b iff its cluster is
    in ``probed[b]`` and j is not stream-tail padding."""
    b = probed.shape[0]
    hit = torch.zeros(b, n_clusters + 1, dtype=torch.bool,
                      device=probed.device)
    hit.scatter_(1, probed, True)
    hit[:, n_clusters] = False
    return hit[:, layout.cluster_of] & layout.valid[None, :]


def tile_positions(layout: FlatLayout, clusters: torch.Tensor, cap: int):
    """Stream positions of the members of ``clusters`` (B, t), padded to
    ``cap`` lanes per cluster.  Returns (positions (B, t*cap), valid)."""
    offs = layout.offsets[clusters]
    sizes = layout.offsets[clusters + 1] - offs
    lane = torch.arange(cap, device=clusters.device)
    pos = offs[..., None] + lane
    ok = lane < sizes[..., None]
    pos = torch.where(ok, pos, 0)
    b, t = clusters.shape
    return pos.reshape(b, t * cap), ok.reshape(b, t * cap)


class ShardedLayout(NamedTuple):
    """Row-sharded partition of the ``FlatLayout`` candidate stream.

    Each cluster's members are dealt round-robin across the S shards, so
    every shard holds ~1/S of every cluster: the scan work is balanced
    whichever clusters a query probes, and the global top-k spreads evenly
    over the shards (which keeps a small fixed per-shard survivor budget
    safe; see ``core.distributed``).  Every field has a leading shard axis,
    and ``local(j)`` is shard j's block as a ``FlatLayout`` over global
    corpus ids:

    ``order``      (S, F) int64 corpus ids, cluster-major per shard.
    ``cluster_of`` (S, F) int64 owning cluster; n_clusters on the padding.
    ``offsets``    (S, C + 1) int64 per-shard cluster start offsets.
    ``valid``      (S, F) bool, False on each shard's padding tail.
    """

    order: torch.Tensor
    cluster_of: torch.Tensor
    offsets: torch.Tensor
    valid: torch.Tensor

    @property
    def n_shards(self) -> int:
        return self.order.shape[0]

    @property
    def shard_flat(self) -> int:
        return self.order.shape[1]

    def local(self, j: int) -> FlatLayout:
        return FlatLayout(order=self.order[j], cluster_of=self.cluster_of[j],
                          offsets=self.offsets[j], valid=self.valid[j])


def sharded_layout(index: IVFIndex, n_shards: int,
                   lane: int = 128) -> tuple[ShardedLayout, int]:
    """Partition the member table into ``n_shards`` stream segments
    (host-side).  Returns ``(layout, cap_shard)``; ``cap_shard`` is the
    longest per-shard cluster segment, the static width of
    ``tile_positions`` on a shard's block.

    Shard j takes members ``j::n_shards`` of every cluster, in the cluster's
    order, so the shards' segments of a cluster together are exactly its
    members.  F, the same on every shard, is the longest shard's length
    rounded up to ``lane``."""
    ids = index.member_ids.cpu().numpy()
    sizes = index.cluster_sizes.cpu().numpy().astype(np.int64)
    n_clusters = ids.shape[0]
    s = n_shards
    # members j::s of a cluster of size z: ceil((z - j) / s) of them
    seg = np.maximum(sizes[None, :] - np.arange(s)[:, None] + s - 1, 0) // s
    f = max(int(seg.sum(axis=1).max()), 1)
    f = ((f + lane - 1) // lane) * lane
    offsets = np.zeros((s, n_clusters + 1), np.int64)
    offsets[:, 1:] = np.cumsum(seg, axis=1)
    live = np.arange(ids.shape[1])[None, :] < sizes[:, None]
    c_of, rank = np.nonzero(live)                   # cluster-major members
    shard = rank % s
    at = offsets[shard, c_of] + rank // s
    order = np.zeros((s, f), np.int64)
    cluster_of = np.full((s, f), n_clusters, np.int64)
    order[shard, at] = ids[c_of, rank]
    cluster_of[shard, at] = c_of
    valid = np.arange(f)[None, :] < offsets[:, -1:]
    dev = index.member_ids.device
    layout = ShardedLayout(*(torch.from_numpy(a).to(dev) for a in
                             (order, cluster_of, offsets, valid)))
    return layout, max(int(seg.max()), 1)
