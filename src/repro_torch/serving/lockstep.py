"""Lock step: the async serving loop over a sharded deployment.

The port's shards are processes, one rank per card, and a sharded engine
call is a collective: every rank must make it, with the same queries, in
the same order.  The JAX package runs one process over a device mesh and
needs no such step.  Here rank 0 runs the ``Server`` event loop over a
``LockstepState``; every engine call it makes is first broadcast to the
other ranks, which ``follow``:

- the header ``(op, k, n_probe, batch, predictive, batch_sizes or the
  queries' shape)`` as one object broadcast, then for a search the padded
  (B, d) queries as one tensor broadcast on the mesh's device;
- ``warmup`` ops (``ServingState.warmup``), ``search`` ops (each
  ``state.run(batch)``, predictive or not, and each direct call of
  ``server.parity_vs_direct``), and a ``stop`` op last.

A following rank builds the same bucket engines in the same order (on
first use of a bucket, as rank 0 does) and makes the same
``search_batch`` call.  With ``tau_pred`` each rank threads its OWN
per-bucket ``PredictorState``: the searchers update it from the psum'd
histograms, which are equal on every rank, so the states stay equal
without being sent.  ``Server`` itself is untouched and keeps the
reference's decisions.

A failure on any rank ends that rank's process with an exception; the
launcher (``torch.multiprocessing.spawn`` or ``torchrun``) then ends the
others, so the run exits non-zero and never waits on a missing rank.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from repro_torch.serving.batcher import ShapeBucket
from repro_torch.serving.state import ServingState

WARMUP, SEARCH, STOP = "warmup", "search", "stop"


def _obj_device(mesh):
    return mesh.device if mesh.device.type == "cuda" else None


def _send(mesh, header: tuple, qs: torch.Tensor | None = None) -> None:
    tdist.broadcast_object_list([header], src=0, device=_obj_device(mesh))
    if qs is not None:
        tdist.broadcast(qs, src=0)


def _recv(mesh) -> tuple[tuple, torch.Tensor | None]:
    box = [None]
    tdist.broadcast_object_list(box, src=0, device=_obj_device(mesh))
    header = box[0]
    qs = None
    if header[0] == SEARCH:
        qs = torch.empty(header[5], dtype=torch.float32, device=mesh.device)
        tdist.broadcast(qs, src=0)
    return header, qs


class _LeaderEngine:
    """Rank 0's view of one bucket engine: each call is broadcast to the
    following ranks before the engine runs it here."""

    def __init__(self, state: "LockstepState", bucket: ShapeBucket, eng):
        self._state, self._bucket, self._eng = state, bucket, eng

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def _header(self, op: str, predictive: bool, extra) -> tuple:
        b = self._bucket
        return (op, b.k, b.n_probe, b.batch, predictive, extra)

    def warmup(self, batch_sizes=(1,), predictive: bool = False):
        sizes = tuple(int(s) for s in batch_sizes)
        _send(self._state.mesh, self._header(WARMUP, predictive, sizes))
        self._eng.warmup(batch_sizes=sizes, predictive=predictive)
        return self

    def search_batch(self, qs, pred_state=None):
        if pred_state is not None and \
                pred_state is not self._state._pred.get(self._bucket):
            raise ValueError("the lock-step protocol threads each bucket's "
                             "own predictor state; pass pred_state(bucket)")
        qs = torch.as_tensor(qs, dtype=torch.float32).to(
            self._state.mesh.device).contiguous()
        _send(self._state.mesh, self._header(
            SEARCH, pred_state is not None, tuple(qs.shape)), qs)
        return self._eng.search_batch(qs, pred_state=pred_state)


class LockstepState(ServingState):
    """Rank 0's ``ServingState`` over a mesh: ``engine(bucket)`` returns an
    engine whose ``warmup`` and ``search_batch`` are broadcast to the
    following ranks first.  Call ``stop()`` once every engine call is done
    (the parity check included)."""

    def __init__(self, index, *, mesh, **kw):
        if mesh is None:
            raise ValueError("the lock-step protocol needs a mesh")
        if tdist.get_rank() != 0:
            raise ValueError("LockstepState runs on rank 0; the other ranks "
                             "follow()")
        super().__init__(index, mesh=mesh, **kw)

    def engine(self, bucket: ShapeBucket):
        return _LeaderEngine(self, bucket, super().engine(bucket))

    def swap(self, *a, **kw):
        raise ValueError("a lock-step state is not swapped; swap every "
                         "rank's ServingState together")

    def fork(self, clone_engines: bool = False):
        raise NotImplementedError(
            "the replica tier over the sharded deployment is not ported: a "
            "fork would neither broadcast its engine calls nor tell the "
            "following ranks whose predictor states to thread (ROADMAP.md "
            "queue 1, item 12b)")

    def stop(self) -> None:
        """Release the following ranks (the last message)."""
        _send(self.mesh, (STOP, 0, 0, 0, False, None))


def follow(state: ServingState) -> int:
    """Serve rank 0's broadcast engine calls on this rank's ``state`` (a
    ``ServingState`` over the same mesh, built as rank 0's) until the stop
    message.  Returns the number of search calls made."""
    if state.mesh is None:
        raise ValueError("follow() needs a ServingState over a mesh")
    n = 0
    while True:
        (op, k, n_probe, batch, predictive, extra), qs = _recv(state.mesh)
        if op == STOP:
            return n
        bucket = ShapeBucket(k=k, batch=batch, n_probe=n_probe)
        eng = state.engine(bucket)
        if op == WARMUP:
            eng.warmup(batch_sizes=extra, predictive=predictive)
        elif predictive:
            _, state._pred[bucket] = eng.search_batch(
                qs, pred_state=state.pred_state(bucket))
            n += 1
        else:
            eng.search_batch(qs)
            n += 1
