"""Activation-sharding hints usable from inside model code.

The port of the JAX package's ``repro.models.sharding``.  There,
``constrain(x, *axes)`` applies ``with_sharding_constraint`` when a mesh is
ambient (``with mesh:`` around a jit); here the mesh travels with the
tensor: parameters and batches placed on a
``torch.distributed.device_mesh.DeviceMesh`` are ``DTensor``s, and
``constrain`` redistributes a ``DTensor`` to the placements its axes name
on that tensor's own mesh.  A plain tensor (no mesh) comes back as it is,
so every path without a mesh runs unchanged.  Reading the mesh from the
tensor, not from a thread's context, also holds in the backward, where
the card's autograd thread recomputes a checkpointed layer.

The reference's rules: axes missing from the mesh are dropped (``"pod"``
on the single-pod mesh), and a dimension that its axes' sizes do not
divide stays unsharded.  A group such as ``("pod", "data")`` shards its
dimension over each of those mesh dimensions, in mesh order (the
reference's major-to-minor order).

``use_mesh(mesh)`` takes the place of ``with mesh:``: inside it the plain
tensors the models make for themselves (rope tables, masks, positions,
zeros) act as replicated on the mesh (DTensor's implicit replication), so
they mix with the ``DTensor`` activations.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def _sizes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh`` (or anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names or (), tuple(mesh.shape)))


def resolve(shape, axes, sizes: dict) -> tuple:
    """The reference's rules on one spec: per dimension an axis name, a
    tuple of names or None, keeping the axes present in ``sizes`` and
    dropping a group whose sizes' product does not divide the dimension.
    Returns one entry per dimension: None or a tuple of axis names."""
    out = []
    for dim, ax in zip(shape, axes):
        group = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        group = tuple(a for a in group if a in sizes)
        total = math.prod(sizes[a] for a in group)
        out.append(group if group and dim % total == 0 and dim >= total
                   else None)
    return tuple(out)


def placements(spec, mesh) -> tuple:
    """``DTensor`` placements of a spec (one entry per tensor dimension: an
    axis name, a tuple of names or None) on ``mesh``: ``Shard(d)`` on each
    mesh dimension a tensor dimension ``d`` names, ``Replicate()`` on the
    rest."""
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for d, ax in enumerate(spec):
        for a in (() if ax is None else
                  (ax if isinstance(ax, tuple) else (ax,))):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """axes: one entry per dim, an axis name, a tuple of names, or None.
    A ``DTensor`` is redistributed to those placements on its mesh (the
    axes the reference's rules keep); anything else comes back as is."""
    if not isinstance(x, DTensor) or not x.device_mesh.mesh_dim_names:
        return x
    mesh = x.device_mesh
    want = placements(resolve(x.shape, axes, _sizes(mesh)), mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    # the gradient is held to the same placements in the backward, as JAX
    # transposes a sharding constraint into one on the cotangent
    return DTensor.from_local(x.to_local(), mesh, want, run_check=False,
                              shape=x.shape, stride=x.stride())


BATCH = ("pod", "data")


def rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its batch over the batch axes and every other dimension
    whole: the layout a product over the feature dimension reads (a
    sequence-parallel stream is gathered at a layer's entry, as XLA does
    for the reference; DTensor flattens (batch, sequence) into rows, which
    it cannot do across a sharded sequence)."""
    return constrain(x, BATCH, *([None] * (x.ndim - 1)))


def whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` replicated on every rank (a ``DTensor``; anything else as it
    is): a small parameter, such as a per-head vector, made whole before
    it meets activations, whose heads stay whole (``split_heads``)."""
    return constrain(t, *([None] * t.ndim))


def sp(y: torch.Tensor) -> torch.Tensor:
    """The sequence-parallel layout of the residual stream (the
    reference's ``_sp``/``_sp_out``): the batch over the batch axes, the
    sequence over "model".  A branch output takes it before it is added
    to the stream."""
    return constrain(y, BATCH, "model", None)


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: rows of a table by an integer index whose leading
    dimension is the batch.  On a mesh each rank looks its own batch rows
    up in the whole table, and the table's gradient is a partial sum over
    the batch axes (DTensor's own indexed lookup and its backward do not
    take every placement in every torch version)."""
    if not isinstance(table, DTensor):
        return table[idx]
    mesh = table.device_mesh
    idx = constrain(idx, BATCH, *([None] * (idx.ndim - 1)))
    grad = [Partial() if isinstance(p, Shard) else Replicate()
            for p in idx.placements]
    out = whole(table).to_local(grad_placements=grad)[idx.to_local()]
    shape = (*idx.shape, *table.shape[1:])
    return DTensor.from_local(out, mesh, idx.placements, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


def unshard_heads(t: torch.Tensor) -> torch.Tensor:
    """A (..., heads, width) ``DTensor`` (a KV cache) with its heads whole:
    a mesh dimension that shards the heads shards the width instead where
    it divides (else the heads are gathered); the other placements stay
    (a cache's sequence sharded over "data" stays so)."""
    if not isinstance(t, DTensor):
        return t
    heads, width = t.ndim - 2, t.ndim - 1
    pl = tuple((Shard(width) if t.shape[width] % t.device_mesh.size(m) == 0
                else Replicate())
               if isinstance(p, Shard) and p.dim == heads else p
               for m, p in enumerate(t.placements))
    return t if pl == tuple(t.placements) else \
        t.redistribute(t.device_mesh, pl)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(b, ..., n, hd) -> (b, ..., n * hd), a ``DTensor`` made whole but
    for its batch first (its head width may be sharded, as a KV cache's
    is, and DTensor does not flatten across that)."""
    o = rows(o)
    return o.reshape(*o.shape[:-2], o.shape[-2] * o.shape[-1])


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(b, ..., n * hd) -> (b, ..., n, hd), a ``DTensor`` with its features
    whole first (``rows``).  The heads stay whole on a mesh: attention and
    the SSD scan flatten (batch, heads) into one dimension of a batched
    product, which DTensor does not do across sharded heads."""
    return rows(t).reshape(*t.shape[:-1], n, hd)


_SPLIT = [1]      # how many ranks split the local section running now


def split() -> int:
    """How many ranks split the work of the ops running now: above 1 in
    and in the backward of ``by_queries``' local section, else 1 (the dry
    run's FLOP count scales what it sees there by it)."""
    return _SPLIT[0]


class _Mark(torch.autograd.Function):
    """The identity on tensors, setting ``split()`` to ``n`` when its
    backward runs: at a local section's exit the section's backward
    starts, at its entry (n=1) it ends."""

    @staticmethod
    def forward(ctx, n, *ts):
        ctx.n = n
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        _SPLIT[0] = ctx.n
        return (None, *gs)


def by_queries(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool) -> torch.Tensor:
    """``attend(q, k, v, causal)`` (q (b, s, h, hd); k, v (b, s_k, h, hd))
    with the query positions split over "model": on a mesh each rank
    attends its own query rows, at their offset in the sequence
    (``attend``'s fifth argument), to every key of its batch rows, so the
    attention is not repeated on every "model" rank whatever the head
    count (the heads stay whole, ``split_heads``).  Where the sequence
    does not divide, every rank takes every row.  The gradients of k and
    v are partial sums over the ranks that split the queries.  Plain
    tensors go to ``attend`` as they are."""
    if not isinstance(q, DTensor):
        return attend(q, k, v, causal)
    mesh = q.device_mesh
    q = constrain(q, BATCH, "model", None, None)
    k, v = rows(k), rows(v)
    lo, n = 0, 1             # this rank's first query row; ranks splitting
    for m, p in enumerate(q.placements):
        if isinstance(p, Shard):
            n *= mesh.size(m)
            if p.dim == 1:
                lo = lo * mesh.size(m) + mesh.get_local_rank(m)
    grad = tuple(Partial() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in q.placements)
    ql, kl, vl = _Mark.apply(1, q.to_local(), k.to_local(grad_placements=grad),
                             v.to_local(grad_placements=grad))
    _SPLIT[0] = n
    try:
        out = attend(ql, kl, vl, causal, lo * ql.shape[1])
    finally:
        _SPLIT[0] = 1
    (out,) = _Mark.apply(n, out)
    # the global shape and stride follow from the even shards and keep
    # the local output's layout (a permuted product's)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def local_rows(fn, *tensors):
    """``fn`` on each rank's rows: for ``DTensor`` inputs, each is placed
    with its leading (batch) dimension over the batch axes and whole
    otherwise, ``fn`` runs on the local shards, and its outputs (a tensor
    or a tuple of tensors, each with the same leading dimension) come back
    as ``DTensor``s placed the same way.  For ops that work row by row and
    that DTensor has no sharding rule for (sorts into slots, searches,
    indexed gathers); plain tensors go to ``fn`` as they are."""
    dts = [t for t in tensors if isinstance(t, DTensor)]
    if not dts:
        return fn(*tensors)
    mesh = dts[0].device_mesh
    placed = [rows(t) if isinstance(t, DTensor) else t for t in tensors]
    lead = placed[tensors.index(dts[0])]
    pl = lead.placements
    out = fn(*[t.to_local() if isinstance(t, DTensor) else t
               for t in placed])

    def wrap(o):
        shape = (lead.shape[0], *o.shape[1:])
        return DTensor.from_local(o, mesh, pl, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta")
                                  .stride())

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def put_rows(cache: torch.Tensor, pos: torch.Tensor,
             new: torch.Tensor) -> None:
    """``cache[b, pos[b]] = new[b]`` for every row ``b``, in place.
    ``cache`` (B, S, ...), ``pos`` (B,), ``new`` (B, ...).  On a ``DTensor``
    cache each rank writes its own shard: ``new`` and ``pos`` are placed
    as the cache's batch and trailing dimensions are, and where the cache's
    sequence is sharded only the rank whose slice holds ``pos[b]`` writes
    (DTensor has no in-place rule for an indexed write into a shard)."""
    if not isinstance(cache, DTensor):
        cache[torch.arange(cache.shape[0], device=cache.device), pos] = new
        return
    mesh = cache.device_mesh
    pl = cache.placements
    # new's dimension d is the cache's d (batch) or d + 1 (after the
    # sequence); pos's only dimension is the batch
    new_l = new.redistribute(mesh, tuple(
        Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard) and p.dim != 1
        else Replicate() for p in pl)).to_local()
    if isinstance(pos, DTensor):
        pos = pos.redistribute(mesh, tuple(
            Shard(0) if isinstance(p, Shard) and p.dim == 0
            else Replicate() for p in pl)).to_local()
    loc = cache.to_local()
    lo = 0           # this rank's first position, where the sequence splits
    for m, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 1:
            lo = lo * mesh.size(m) + mesh.get_local_rank(m)
    lo *= loc.shape[1]
    rel = pos.long() - lo
    inside = (rel >= 0) & (rel < loc.shape[1])
    rel = rel.clamp(0, loc.shape[1] - 1)
    b_idx = torch.arange(loc.shape[0], device=loc.device)
    keep = loc[b_idx, rel]
    grow = (slice(None),) + (None,) * (new_l.ndim - 1)
    loc[b_idx, rel] = torch.where(inside[grow], new_l.to(loc.dtype), keep)


@contextlib.contextmanager
def use_mesh(mesh):
    """The models' mesh context (the reference's ``with mesh:``): plain
    tensors made inside it act as replicated on ``mesh``."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield mesh
