"""Lock step: the async serving loop over a sharded deployment.

The port's shards are processes, one rank per card, and a sharded engine
call is a collective: every rank must make it, with the same queries, in
the same order.  The JAX package runs one process over a device mesh and
needs no such step.  Here rank 0 runs the ``Server`` (or ``ReplicaServer``)
event loop over a ``LockstepState``; every engine call it makes is first
broadcast to the other ranks, which ``follow``.

Every message is a header, broadcast as one object, whose first two
fields are the op and a state id ``sid`` (the base state is 0; each fork
gets the next id), then any tensors it announces, broadcast one by one on
the mesh's device:

- ``warmup``: ``(op, sid, k, n_probe, batch, predictive, batch_sizes)``;
- ``search``: ``(op, sid, k, n_probe, batch, pred, queries' shape)`` and
  the padded (B, d) queries.  ``pred`` is ``None`` (no predictor), ``
  "thread"`` (the state's own per-bucket ``PredictorState``, which every
  rank updates from the psum'd histograms, so the states stay equal
  without being sent) or ``"cold"`` (a throwaway cold state: the drift
  probe of an engine swap);
- ``fork``: ``(op, parent_sid, new_sid, clone_engines)``: each rank makes
  the same ``ServingState.fork`` (``clone_engines``: through
  ``SearchEngine.replica_clone`` on every rank);
- ``restore``: ``(op, sid, [(k, batch, n_probe, ema shape)...])`` and each
  bucket's ``ema`` and ``weight``: the predictor states rank 0 set on a
  state (a respawn's checkpoint restore, a rolling swap's carried states,
  an engine swap's drift decisions).  No rank rebuilds them from its own
  history;
- ``swap``: ``(op, sid, kind, [(shape, dtype)...], has_vectors, has_live,
  the index's device type)`` and the new index's tensors in field order,
  then the corpus vectors and the tombstone mask when given: each rank
  makes the same ``ServingState.swap`` (the drift probes follow as
  ``search`` ops, the carried states as one ``restore``);
- ``release``: ``(op, sid)``: the pool replaced that fork (a respawn, a
  rolling swap); each rank drops it, and with it the engines and placed
  shard it alone held;
- ``stop``: ``(op, 0)``, the last message.

A following rank keeps one ``ServingState`` per sid and builds the same
bucket engines in the same order (on first use of a bucket, as rank 0
does).  Faults stay at rank 0's replica service boundary: a call that a
fault cancels before the engine is reached is broadcast to no rank.
``Server`` and ``ReplicaServer`` are untouched and keep the reference's
decisions.

A failure on any rank ends that rank's process with an exception; the
launcher (``torch.multiprocessing.spawn`` or ``torchrun``) then ends the
others, so the run exits non-zero and never waits on a missing rank.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.core import rerank
from repro_torch.index import ivf as ivf_mod
from repro_torch.index import pq as pq_mod
from repro_torch.index import rabitq as rq_mod
from repro_torch.index import search as search_mod
from repro_torch.serving.batcher import ShapeBucket
from repro_torch.serving.state import ServingState

WARMUP, SEARCH, FORK, RESTORE, SWAP, RELEASE, STOP = (
    "warmup", "search", "fork", "restore", "swap", "release", "stop")
THREAD, COLD = "thread", "cold"


def _obj_device(mesh):
    return mesh.device if mesh.device.type == "cuda" else None


def _send(mesh, header: tuple, tensors=()) -> None:
    tdist.broadcast_object_list([header], src=0, device=_obj_device(mesh))
    for t in tensors:
        # bool goes as uint8: not every backend reduces or sends bool
        t = t.to(mesh.device)
        tdist.broadcast((t.to(torch.uint8) if t.dtype == torch.bool
                         else t).contiguous(), src=0)


def _recv_header(mesh) -> tuple:
    box = [None]
    tdist.broadcast_object_list(box, src=0, device=_obj_device(mesh))
    return box[0]


def _recv_tensor(mesh, shape, dtype: torch.dtype) -> torch.Tensor:
    wire = torch.uint8 if dtype == torch.bool else dtype
    t = torch.empty(tuple(shape), dtype=wire, device=mesh.device)
    tdist.broadcast(t, src=0)
    return t.to(dtype)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.rsplit(".", 1)[-1])


def _index_leaves(index) -> tuple[str, list[torch.Tensor]]:
    """An index as (kind, its tensors in field order)."""
    if isinstance(index, ivf_mod.IVFIndex):
        return "ivf", list(index)
    if isinstance(index, search_mod.RabitqIndex):
        return "rabitq", [*index.ivf, *index.rq, index.vectors]
    return "pq", [*index.ivf, index.pq.centroids, index.codes,
                  index.vectors]


def _index_from_leaves(kind: str, leaves: list[torch.Tensor]):
    ivf = ivf_mod.IVFIndex(*leaves[:4])
    if kind == "ivf":
        return ivf
    if kind == "rabitq":
        return search_mod.RabitqIndex(
            ivf=ivf, rq=rq_mod.RabitqCodes(*leaves[4:8]), vectors=leaves[8])
    return search_mod.PQIndex(ivf=ivf, pq=pq_mod.PQCodebook(leaves[4]),
                              codes=leaves[5], vectors=leaves[6])


def _bucket_key(bucket: ShapeBucket) -> tuple[int, int, int]:
    return bucket.k, bucket.batch, bucket.n_probe


class _LeaderEngine:
    """Rank 0's view of one bucket engine of one state: each call is
    broadcast to the following ranks, under the state's sid, before the
    engine runs it here."""

    def __init__(self, state: "LockstepState", bucket: ShapeBucket, eng):
        self._state, self._bucket, self._eng = state, bucket, eng

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def _header(self, op: str, pred, extra) -> tuple:
        b = self._bucket
        return (op, self._state.sid, b.k, b.n_probe, b.batch, pred, extra)

    def _pred_mode(self, pred_state):
        if pred_state is None:
            return None
        if pred_state is self._state._pred.get(self._bucket):
            return THREAD
        if not bool(pred_state.weight) and not bool(pred_state.ema.any()):
            return COLD
        raise ValueError("the lock-step protocol threads each bucket's own "
                         "predictor state, or a cold one; pass "
                         "pred_state(bucket)")

    def warmup(self, batch_sizes=(1,), predictive: bool = False):
        sizes = tuple(int(s) for s in batch_sizes)
        _send(self._state.mesh, self._header(WARMUP, predictive, sizes))
        self._eng.warmup(batch_sizes=sizes, predictive=predictive)
        return self

    def search_batch(self, qs, pred_state=None):
        mode = self._pred_mode(pred_state)
        qs = torch.as_tensor(qs, dtype=torch.float32).to(
            self._state.mesh.device).contiguous()
        _send(self._state.mesh, self._header(SEARCH, mode, tuple(qs.shape)),
              (qs,))
        return self._eng.search_batch(qs, pred_state=pred_state)


class LockstepState(ServingState):
    """Rank 0's ``ServingState`` over a mesh: ``engine(bucket)`` returns an
    engine whose ``warmup`` and ``search_batch`` are broadcast to the
    following ranks first, and ``fork``, ``restore_pred``, ``swap`` and
    ``release`` are made on every rank.  Call ``stop()`` once every engine
    call is done (the parity check included)."""

    def __init__(self, index, *, mesh, **kw):
        if mesh is None:
            raise ValueError("the lock-step protocol needs a mesh")
        if tdist.get_rank() != 0:
            raise ValueError("LockstepState runs on rank 0; the other ranks "
                             "follow()")
        super().__init__(index, mesh=mesh, **kw)
        self.sid = 0
        # shared by every fork: the next state id
        self._sids = itertools.count(1)

    def engine(self, bucket: ShapeBucket):
        return _LeaderEngine(self, bucket, super().engine(bucket))

    def fork(self, clone_engines: bool = False,
             pred_states=None) -> "LockstepState":
        sid = next(self._sids)
        _send(self.mesh, (FORK, self.sid, sid, bool(clone_engines)))
        twin = super().fork(clone_engines)
        twin.sid = sid
        if pred_states:
            twin.restore_pred(pred_states)
        return twin

    def restore_pred(self, states) -> None:
        states = dict(states)
        buckets = sorted(states, key=_bucket_key)
        tensors = [t for b in buckets
                   for t in (states[b].ema, states[b].weight)]
        _send(self.mesh, (RESTORE, self.sid, [
            (*_bucket_key(b), tuple(states[b].ema.shape)) for b in buckets]),
            tensors)
        super().restore_pred(states)

    def swap(self, index, *, vectors=None, live=None, probe_qs=None,
             drift_threshold: float = 0.25):
        kind, leaves = _index_leaves(index)
        extra = []
        if vectors is not None:
            extra.append(torch.as_tensor(vectors, dtype=torch.float32))
        if live is not None:
            live = torch.as_tensor(np.asarray(live, dtype=bool)) \
                if not isinstance(live, torch.Tensor) else live.to(torch.bool)
            extra.append(live)
        sent = leaves + extra
        _send(self.mesh, (SWAP, self.sid, kind,
                          [(tuple(t.shape), str(t.dtype)) for t in sent],
                          vectors is not None, live is not None,
                          leaves[0].device.type), sent)
        report = super().swap(index, vectors=vectors, live=live,
                              probe_qs=probe_qs,
                              drift_threshold=drift_threshold)
        # the drift decisions were made here; the other ranks take them
        self.restore_pred(self._pred)
        return report

    def release(self) -> None:
        if self.sid == 0:
            raise ValueError("the base state (sid 0) lives until stop()")
        _send(self.mesh, (RELEASE, self.sid))
        super().release()

    def stop(self) -> None:
        """Release the following ranks (the last message)."""
        _send(self.mesh, (STOP, 0))


def _follow_swap(state: ServingState, header: tuple) -> None:
    _, _, kind, specs, has_vectors, has_live, where = header
    # where rank 0 holds its index: on the card, each rank's own
    dev = state.mesh.device if where == "cuda" else torch.device(where)
    got = [_recv_tensor(state.mesh, shape, _dtype(dt)).to(dev)
           for shape, dt in specs]
    extra = len(got) - int(has_vectors) - int(has_live)
    leaves, rest = got[:extra], got[extra:]
    vectors = rest.pop(0) if has_vectors else None
    live = rest.pop(0) if has_live else None
    # no probe here: rank 0's drift probes arrive as search ops, and its
    # decisions as the restore that follows
    state.swap(_index_from_leaves(kind, leaves), vectors=vectors, live=live)


def follow(state: ServingState) -> int:
    """Serve rank 0's broadcast calls on this rank's ``state`` (a
    ``ServingState`` over the same mesh, built as rank 0's, sid 0) and on
    the forks rank 0 makes of it, until the stop message.  Returns the
    number of search calls made."""
    if state.mesh is None:
        raise ValueError("follow() needs a ServingState over a mesh")
    states = {0: state}
    n = 0
    while True:
        header = _recv_header(state.mesh)
        op, sid = header[0], header[1]
        if op == STOP:
            return n
        if op == FORK:
            states[header[2]] = states[sid].fork(header[3])
            continue
        if op == RELEASE:
            states.pop(sid).release()
            continue
        st = states[sid]
        if op == RESTORE:
            st.restore_pred({
                ShapeBucket(k=k, batch=b, n_probe=p): rerank.PredictorState(
                    ema=_recv_tensor(st.mesh, shape, torch.float32),
                    weight=_recv_tensor(st.mesh, (), torch.float32))
                for k, b, p, shape in header[2]})
            continue
        if op == SWAP:
            _follow_swap(st, header)
            continue
        _, _, k, n_probe, batch, pred, extra = header
        eng = st.engine(ShapeBucket(k=k, batch=batch, n_probe=n_probe))
        if op == WARMUP:
            eng.warmup(batch_sizes=extra, predictive=pred)
            continue
        qs = _recv_tensor(st.mesh, extra, torch.float32)
        bucket = ShapeBucket(k=k, batch=batch, n_probe=n_probe)
        if pred == THREAD:
            _, st._pred[bucket] = eng.search_batch(
                qs, pred_state=st.pred_state(bucket))
        elif pred == COLD:
            eng.search_batch(qs, pred_state=eng.predictor_init())
        else:
            eng.search_batch(qs)
        n += 1
