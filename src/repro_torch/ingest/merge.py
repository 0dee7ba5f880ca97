"""Background merge: checkpointed re-cluster/re-quantize fold.

The merge job turns accumulated churn back into a frozen base index:

1. ``begin_merge`` seals the delta segments and snapshots the live corpus
   (serving continues on the sealed state, untouched).
2. The snapshot is written through ``checkpoint.CheckpointManager``
   (checksummed, atomically renamed) BEFORE any rebuild work, so a crash
   at any later point recovers from a verified copy of the merge input.
3. The rebuild (k-means + quantization + engine build) runs off the
   serving path.
4. ``complete_merge`` swaps the new generation in (one engine reference
   assignment) and re-applies any deletes that landed mid-merge.

A crash between (2) and (4) leaves the mutable index fully serviceable
(sealed segments still scanned, old base still live); ``resume_merge``
restores the checkpoint (verifying every checksum first) and finishes the
fold.  A corrupt checkpoint raises ``CorruptCheckpointError`` before
anything is deserialized; the caller aborts the merge (sealed segments
return to the active set) and re-runs it fresh from live state.  Either
way the serving index is never left corrupted.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.ingest.mutable import MutableIndex


class MergeCrash(RuntimeError):
    """Injected merge crash (tests, ``chip_smoke.py``): raised after the
    checkpoint is durable but before the swap, the window crash recovery
    must cover."""


class MergeJob:
    """One merge execution against a ``MutableIndex``, checkpointed through
    ``checkpoint_dir``."""

    def __init__(self, mutable: MutableIndex, checkpoint_dir: str, *,
                 keep_last: int = 2):
        self.mutable = mutable
        self.manager = CheckpointManager(checkpoint_dir, keep_last=keep_last)

    def run(self, *, crash_after_checkpoint: bool = False):
        """Seal -> checkpoint -> rebuild -> swap.  Returns the new engine.

        ``crash_after_checkpoint`` raises ``MergeCrash`` right after the
        snapshot is durable (fault injection for the recovery path); the
        sealed state is left in place for ``resume_merge``.  Any OTHER
        failure unwinds the seal (``abort_merge``) and re-raises: the index
        keeps serving exactly what it served before.
        """
        snap = self.mutable.begin_merge()
        try:
            self.manager.save(snap.step, {
                "vectors": snap.vectors,
                "row_ids": snap.ids.astype(np.int32),
            })
            if crash_after_checkpoint:
                raise MergeCrash(
                    f"injected crash merging to generation {snap.step}")
            return _finish(self.mutable, snap.vectors, snap.ids, snap.step)
        except MergeCrash:
            raise
        except Exception:
            self.mutable.abort_merge()
            raise


def resume_merge(mutable: MutableIndex, checkpoint_dir: str, *,
                 keep_last: int = 2):
    """Finish a crashed merge from its checksummed checkpoint.

    Verifies the checkpoint (``CorruptCheckpointError`` on any mismatch:
    the caller should ``abort_merge`` and re-run fresh), restores the
    snapshot, rebuilds, and swaps.  Returns the new engine.
    """
    mgr = CheckpointManager(checkpoint_dir, keep_last=keep_last)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no merge checkpoint in {checkpoint_dir}")
    if step != mutable.generation + 1:
        raise RuntimeError(
            f"checkpoint step {step} does not continue generation "
            f"{mutable.generation}")
    like = _like_from_manifest(checkpoint_dir, step)
    tree, _ = mgr.restore(like, step)
    x = tree["vectors"].numpy().astype(np.float32, copy=False)
    ids = tree["row_ids"].numpy().astype(np.int64)
    return _finish(mutable, x, ids, step)


def _finish(mutable: MutableIndex, x: np.ndarray, ids: np.ndarray,
            step: int):
    eng = mutable.build_engine(x, step)
    mutable.complete_merge(eng, x, ids, step)
    return eng


def _like_from_manifest(checkpoint_dir: str, step: int) -> dict:
    """Shape/dtype skeleton for ``CheckpointManager.restore`` built from
    the manifest itself: recovery must not depend on in-memory state that
    died with the crashed process."""
    path = os.path.join(checkpoint_dir, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    return {key: np.zeros(tuple(meta["shape"]), np.dtype(meta["dtype"]))
            for key, meta in manifest["leaves"].items()}
