"""Distributed BBC over ``torch.distributed``: the mesh-sharded collector.

The port of the JAX package's ``core/distributed.py``.  The corpus stream is
split row-wise over the shards (``ivf.sharded_layout``); every rank scans
its own block and the ranks meet in a few collectives per batch:

  1. local (B, m+1) bucket histograms, summed over the shards (``hier_psum``)
     -- (m+1)*4 bytes per query on the wire, not k*8;
  2. every rank derives the same per-query threshold bucket tau from the sum;
  3. local lanes at or below tau survive, compacted into a fixed per-shard
     budget (``bbc_survivors_batch``, three tiers);
  4. the survivors alone are all-gathered (``gather_survivors``) and the
     final selection runs on the gathered pool, split by rows over the
     shards (``shard_rows``).

``ShardMesh`` takes the place of the JAX ``Mesh``: one process group per
mesh axis, this rank's coordinates, and the device its tensors live on.  A
mesh on CUDA tensors needs the NCCL backend and one on CPU tensors gloo; a
mismatch raises rather than staging tensors through the host.  Passing no
mesh (or empty ``axes``) runs a function with no collective at all, as
``axis_name=()`` does in the JAX package.

Every rank must issue the same collectives in the same order.  The tier
choice of ``bbc_survivors_batch`` depends on this shard's data, so no
branch of it holds a collective.  Its ``.item()`` reads are host syncs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import buffer as rb

INF = float("inf")
SHARD_AXIS = "model"
HOST_AXIS = "host"
_BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}

# survivor tier taken per ``bbc_survivors_batch`` call, as a plain count
# (``chip_smoke.py`` zeroes it and reads it around a run)
TIERS = {"covered": 0, "correction": 0, "exact": 0}


def reset_tiers() -> None:
    for name in TIERS:
        TIERS[name] = 0


@dataclass(frozen=True)
class ShardMesh:
    """A device mesh over the ranks of the default process group.

    ``axis_names`` ``("model",)`` or ``("host", "model")``; ``shape`` their
    sizes; ``coords`` this rank's coordinate on each axis (rank = outer-major
    composite, ``host * S_model + model``); ``groups`` the process group of
    the ranks that differ from this one only along each axis; ``device``
    where this rank's tensors live."""
    axis_names: tuple
    shape: tuple
    coords: tuple
    groups: tuple
    device: torch.device

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[self.axis_names.index(axis)]

    @property
    def shard_axes(self) -> tuple:
        """Axes the corpus stream is sharded over: both on a 2-D
        ("host", "model") mesh (the hierarchical schedule), else model."""
        if HOST_AXIS in self.axis_names:
            return (HOST_AXIS, SHARD_AXIS)
        return (SHARD_AXIS,)

    @property
    def n_shards(self) -> int:
        return math.prod(self.size(a) for a in self.shard_axes)

    @property
    def shard_index(self) -> int:
        """This rank's shard: the outer-major composite of its coordinates
        on the shard axes (the order the gathers concatenate in)."""
        idx = 0
        for a in self.shard_axes:
            idx = idx * self.size(a) + self.coord(a)
        return idx


def make_mesh(shape, axis_names=(SHARD_AXIS,), backend: str | None = None,
              device=None) -> ShardMesh:
    """A ``ShardMesh`` of ``shape`` over every rank of the default group.

    Every rank must call this, with the same arguments: each axis group is
    made with ``dist.new_group``, which all ranks enter together.
    ``backend`` (default: the default group's) picks the groups' backend;
    ``device`` (default: the current card for NCCL, the CPU for gloo) must
    match it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(init_process_group)")
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or SHARD_AXIS not in axis_names:
        raise ValueError(f"mesh shape {shape} and axes {axis_names}: one size "
                         f"per axis, and a {SHARD_AXIS!r} axis")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"group has {world}")
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    grid = np.arange(world).reshape(shape)
    groups = []
    for a in range(len(shape)):
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        mine = None
        for line in lines:        # every rank creates every group, in order
            g = dist.new_group([int(r) for r in line], backend=backend)
            if rank in line:
                mine = g
        groups.append(mine)
    used = dist.get_backend(groups[0])
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if used == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if _BACKEND_OF.get(device.type) != used:
        raise ValueError(f"a mesh on {device} needs the "
                         f"{_BACKEND_OF.get(device.type)} backend, not {used}")
    return ShardMesh(axis_names=axis_names, shape=shape, coords=coords,
                     groups=tuple(groups), device=device)


def _axes(mesh: ShardMesh | None, axes) -> tuple:
    if mesh is None:
        return ()
    return mesh.shard_axes if axes is None else tuple(axes)


def _check(mesh: ShardMesh, t: torch.Tensor) -> None:
    if t.device.type != mesh.device.type:
        raise ValueError(f"a collective of the {mesh.device.type} mesh got a "
                         f"tensor on {t.device}; no host staging is done")


def _all_gather(t: torch.Tensor, mesh: ShardMesh, axis: str, dim: int):
    """Concatenation along ``dim`` of every axis member's ``t``, in the
    group's rank order."""
    _check(mesh, t)
    g, n = mesh.group(axis), mesh.size(axis)
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src.contiguous(), group=g)
    out = torch.cat(parts, dim=dim)
    return out.bool() if t.dtype == torch.bool else out


def hier_psum(x: torch.Tensor, mesh: ShardMesh | None, axes=None):
    """Sum over the shard axes one at a time, innermost (last) first: on a
    ("host", "model") mesh the intra-host reduce, then the inter-host sum of
    the already reduced partials, so the outer tier carries the same O(m)
    payload.  Returns a new tensor; no mesh or no axes: ``x`` itself."""
    for ax in reversed(_axes(mesh, axes)):
        _check(mesh, x)
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group(ax))
    return x


def _gather_cols(r: torch.Tensor, mesh, axes) -> torch.Tensor:
    """all_gather along dim 1, innermost axis first: rank-major order,
    rank = host * S_model + model."""
    for ax in reversed(axes):
        r = _all_gather(r, mesh, ax, dim=1)
    return r


def _gather_rows(r: torch.Tensor, mesh, axes) -> torch.Tensor:
    for ax in reversed(axes):
        r = _all_gather(r, mesh, ax, dim=0)
    return r


def _flatten(out):
    """(tensor leaves, rebuild) of a tensor or a (named) tuple of them."""
    if isinstance(out, torch.Tensor):
        return [out], lambda ls: ls[0]
    parts = [_flatten(o) for o in out]

    def rebuild(ls):
        items, i = [], 0
        for leaves, rebuild_part in parts:
            items.append(rebuild_part(ls[i:i + len(leaves)]))
            i += len(leaves)
        return type(out)(*items) if hasattr(out, "_fields") else \
            type(out)(items)

    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def shard_rows(mesh: ShardMesh | None, fn, *arrays: torch.Tensor,
               axes=None):
    """Split a replicated row-independent computation over the shards.

    After a gather or a sum every rank holds the same rows; instead of S
    copies of ``fn`` over all of them, each rank runs ``fn`` on its
    contiguous slice (rows padded to a multiple of S by wrapping) and the
    slices are all-gathered back.  Returns ``fn``'s output (a tensor or a
    (named) tuple of them), the same on every rank, with the original row
    count."""
    ax = _axes(mesh, axes)
    if not ax:
        return fn(*arrays)
    s = math.prod(mesh.size(a) for a in ax)
    b = arrays[0].shape[0]
    rows = -(-b // s)
    idx = 0
    for a in ax:                           # outer-major composite index
        idx = idx * mesh.size(a) + mesh.coord(a)

    def part(t):
        if rows * s != b:
            t = t[torch.arange(rows * s, device=t.device) % b]
        return t[idx * rows:(idx + 1) * rows]

    leaves, rebuild = _flatten(fn(*(part(t) for t in arrays)))
    return rebuild([_gather_rows(o, mesh, ax)[:b] for o in leaves])


class ShardedSearchResult(NamedTuple):
    """``bbc_shard_search`` output: global top-k, tau, per-shard survivor
    counts (each with a leading query axis)."""
    topk_dists: torch.Tensor
    topk_ids: torch.Tensor
    tau: torch.Tensor
    survivors_per_shard: torch.Tensor


def survivor_budget(k: int, n_shards: int, slack: float = 2.0) -> int:
    """Fixed per-shard survivor budget: balanced shards hold ~k/S of the
    global top-k, and ``slack`` covers skew.  A multiple of 128."""
    b = int(k / max(n_shards, 1) * slack) + 128
    return ((b + 127) // 128) * 128


def bbc_shard_search(local_dists, local_ids, local_valid,
                     cb: rb.BucketCodebook, k: int, n_shards: int,
                     mesh: ShardMesh | None = None, axes=None,
                     budget: int | None = None) -> ShardedSearchResult:
    """Distributed BBC over (B, n_local) distances with (n_local,) global
    ids and per-query codebooks ``cb``: local histograms, their sum, the
    global threshold bucket, the survivors compacted into ``budget``, their
    gather and the final top-k (ties to the lower pool position)."""
    if budget is None:
        budget = survivor_budget(k, n_shards)
    n = local_dists.shape[1]
    bucket = rb.bucketize(cb, torch.where(local_valid, local_dists, INF))
    ghist = hier_psum(rb.histogram(bucket, cb.m, local_valid), mesh, axes)
    tau, _ = rb.threshold_bucket(ghist, k)
    survive = local_valid & (bucket <= tau[:, None])
    idx, ok = rb.compact_mask(survive, budget)
    safe = idx.clamp(max=n - 1)
    sd = torch.where(ok, torch.gather(local_dists, 1, safe), INF)
    si = torch.where(ok, local_ids[safe], -1)
    gd, gi = gather_survivors(mesh, sd, si, axes=axes)
    vals, order = rb.smallest(gd, min(k, gd.shape[1]))
    return ShardedSearchResult(
        topk_dists=vals, topk_ids=torch.gather(gi, 1, order), tau=tau,
        survivors_per_shard=survive.sum(dim=1).to(torch.int32))


def bbc_survivors_batch(bucket, key, valid, hist, count: int, budget: int,
                        mesh: ShardMesh | None = None, axes=None,
                        tau_floor: torch.Tensor | None = None,
                        spec: tuple | None = None):
    """Batched core of the distributed BBC collector.

    ``bucket``, ``key`` (distance-like, ascending) and ``valid`` are this
    shard's (B, F) lanes and ``hist`` its (B, m+1) histograms.  The summed
    histograms give every shard the same per-query threshold bucket tau at
    ``count`` (raised to ``tau_floor``, the predictor's hook, when given);
    lanes at or below it survive, in a fixed ``budget``.

    ``spec = (pos, ok, count, tau_spec)`` is the shard collector's buffer
    (``ops.shard_collect_batch``): the lanes at or below the provisional
    ``tau_spec``, in stream order.  The cheapest exact tier wins:

      1. covered (tau_spec >= tau and no overflow, every query): filter the
         buffer down to tau, O(budget);
      2. every query's survivors fit the budget: one stream-order
         compaction pass over the stream;
      3. otherwise (and always without ``spec``): the ``budget`` survivors
         of smallest key (ties to the lower position).

    Every tier keeps the same survivor id set.  The choice is this shard's
    own (one or two ``.item()`` host syncs) and holds no collective.

    Returns ``(pos (B, budget) int64, ok, tau (B,), n_survive (B,),
    global_hist (B, m+1))``."""
    f = key.shape[1]
    global_hist = hier_psum(hist, mesh, axes)
    tau, _ = rb.threshold_bucket(global_hist, count)
    if tau_floor is not None:
        tau = torch.maximum(tau, tau_floor)
    survive = valid & (bucket <= tau[:, None])
    n_survive = survive.sum(dim=1).to(torch.int32)

    def exact_topk():
        kk = min(budget, f)
        vals, pos = rb.smallest(torch.where(survive, key, INF), kk)
        ok = torch.isfinite(vals)
        if kk < budget:
            pad = budget - kk
            pos = torch.nn.functional.pad(pos, (0, pad))
            ok = torch.nn.functional.pad(ok, (0, pad))
        return pos, ok

    tier = "exact"
    if spec is not None:
        spos, sok, scount, tau_spec = spec
        if bool(((tau_spec >= tau) & (scount <= budget)).all().item()):
            tier = "covered"
        elif bool((n_survive <= budget).all().item()):
            tier = "correction"
    TIERS[tier] += 1
    if tier == "covered":
        pos = spos.long().clamp(max=f - 1)
        ok = sok & (torch.gather(bucket, 1, pos) <= tau[:, None]) \
            & torch.isfinite(torch.gather(key, 1, pos))
    elif tier == "correction":
        idx, ok = rb.compact_mask(survive, budget)
        pos = idx.clamp(max=f - 1)
    else:
        pos, ok = exact_topk()
    return pos, ok, tau, n_survive, global_hist


def split_certified_survivors(pos, ok, certified):
    """Split a shard's survivors by the bound-fused scan's inline coverage:
    ``(cert_ok, strag_ok)``, the survivors whose exact distance the scan
    already holds and the stragglers the on-shard gather must compute."""
    cert_ok = torch.gather(certified, 1, pos) & ok
    return cert_ok, ok & ~cert_ok


def gather_survivors(mesh: ShardMesh | None, *rows: torch.Tensor,
                     axes=None):
    """All-gather per-shard (B, w) survivor rows into (B, S * w), rank-major
    (innermost axis first): the survivor-only collective."""
    ax = _axes(mesh, axes)
    return tuple(_gather_cols(r, mesh, ax) for r in rows)


def naive_shard_search(local_dists, local_ids, local_valid, k: int,
                       mesh: ShardMesh | None = None, axes=None):
    """Baseline distributed collector: local top-k, all-gather k (dist, id)
    pairs per shard, re-select.  Returns (dists (B, k), ids (B, k))."""
    d = torch.where(local_valid, local_dists, INF)
    vals, idx = rb.smallest(d, min(k, d.shape[1]))
    gd, gi = gather_survivors(mesh, vals, local_ids[idx], axes=axes)
    out, order = rb.smallest(gd, min(k, gd.shape[1]))
    return out, torch.gather(gi, 1, order)


NVLINK_BYTES_PER_S = 450e9   # H100 SXM NVLink 4: 900 GB/s, 450 GB/s each way


def collective_cost_model(k: int, m: int, n_shards: int,
                          budget: int | None = None,
                          link_bw: float = NVLINK_BYTES_PER_S,
                          n_hosts: int = 1,
                          dcn_bw: float = NVLINK_BYTES_PER_S) -> dict:
    """Bytes on the wire per query: BBC against the naive distributed top-k.

    A ring all-reduce of h bytes moves ~2*h*(S-1)/S per link and a ring
    all-gather of b bytes per shard ~b*(S-1).  ``link_bw`` defaults to one
    direction of an H100 SXM's NVLink (900 GB/s in all, 450 GB/s each way,
    NVIDIA's data sheet).  ``n_hosts > 1`` also prices the hierarchical
    schedule's outer tier (the summed O(m) histogram over the ``n_hosts``
    ring, and each outer member's concatenated survivor block) at
    ``dcn_bw``; its default is NVLink too, the outer axis of a mesh of cards
    on one host, so pass the inter-node fabric's rate for a mesh that spans
    nodes."""
    if budget is None:
        budget = survivor_budget(k, n_shards)
    s = n_shards
    hist_bytes = 4 * (m + 1)
    bbc_wire = 2 * hist_bytes * (s - 1) / s + 8 * budget * (s - 1)
    naive_wire = 8 * k * (s - 1)
    out = {
        "bbc_bytes_per_link": bbc_wire,
        "naive_bytes_per_link": naive_wire,
        "ratio": naive_wire / max(bbc_wire, 1e-9),
        "bbc_collective_seconds": bbc_wire / link_bw,
        "naive_collective_seconds": naive_wire / link_bw,
    }
    if n_hosts > 1:
        sh = n_hosts
        per_host = max(s // sh, 1)
        bbc_dcn = 2 * hist_bytes * (sh - 1) / sh \
            + 8 * budget * per_host * (sh - 1)
        naive_dcn = 8 * k * per_host * (sh - 1)
        out.update({
            "n_hosts": sh,
            "bbc_dcn_bytes_per_link": bbc_dcn,
            "naive_dcn_bytes_per_link": naive_dcn,
            "dcn_ratio": naive_dcn / max(bbc_dcn, 1e-9),
            "bbc_dcn_seconds": bbc_dcn / dcn_bw,
            "naive_dcn_seconds": naive_dcn / dcn_bw,
        })
    return out
