"""Checkpointing: save/restore of nested tensor trees with per-leaf
checksums, atomic renames, bounded retention and async writes.

Layout (the JAX package's, byte for byte on the same arrays):
``<dir>/step_<n>/manifest.json`` plus one ``leaf_<i>.npy`` per leaf.  The
manifest records a sha256 per leaf file and a whole-checkpoint checksum
over the leaf digests; ``restore`` verifies both BEFORE deserializing and
raises ``CorruptCheckpointError`` on any mismatch.  Writes land in a tmp
dir that is renamed atomically; ``save(wait=False)`` serializes on a
background thread.

A tree is a nest of dicts, lists, tuples and named tuples whose leaves are
tensors, numpy arrays or scalars.  Leaves are keyed by their ``/``-joined
path, with dict keys SORTED (as JAX's tree flattening orders them), so the
leaf indices, the files and the checksum of a tree equal the ones the JAX
package's manager writes for the same arrays, and either manager restores
the other's checkpoint.  ``None`` is an empty subtree, as in JAX.  The
reference's ``treedef`` string needs JAX to produce and is never read on
restore, so the port does not write it.

A bfloat16 leaf is written as the reference writes one: its 16 bits as a
``'<V2'`` ``.npy`` (numpy has no bfloat16) and ``"dtype": "bfloat16"`` in
the manifest, so its file, digest and manifest entry are the reference's
for the same bits.  ``restore`` reads a 2-byte void leaf as bfloat16 (the
only 2-byte void either manager writes), and an int16 or uint16 leaf as
bfloat16 bits when ``like``'s leaf is bfloat16.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch


class CorruptCheckpointError(RuntimeError):
    """A checkpoint's on-disk bytes do not match its manifest checksums.

    Raised on restore BEFORE any array is deserialized, so a caller either
    loads a verified state or starts over; it never resumes from
    garbage."""


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(``/``-joined path, leaf) pairs in JAX's flattening order: sorted
    dict keys, sequence positions, named-tuple fields in declaration
    order; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for key, sub in items:
        out.extend(_flatten(sub, prefix + (key,)))
    return out


def _unflatten(like, leaves: list):
    """``like``'s structure with its leaves taken from ``leaves`` in
    ``_flatten`` order (consumed from the front)."""
    if like is None:
        return None
    if isinstance(like, dict):
        got = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: got[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return leaves.pop(0)


_BF16_VOID = np.dtype("V2")


def _to_host(leaf) -> np.ndarray:
    """A host copy of the leaf (never a view of the caller's buffer); a
    bfloat16 tensor becomes its bits as 2-byte voids."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_VOID)
        return t.numpy()
    return np.array(leaf)


def _save_leaf(path: str, leaf: np.ndarray) -> str:
    """``np.save`` the leaf; returns the manifest's dtype string.  2-byte
    voids (bfloat16 bits) get the header the reference's numpy writes for
    a bfloat16 array (``'<V2'``; numpy's own would read ``'|V2'``)."""
    if leaf.dtype != _BF16_VOID:
        np.save(path, leaf)
        return str(leaf.dtype)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": leaf.shape})
        f.write(np.ascontiguousarray(leaf).tobytes())
    return "bfloat16"


def _from_host(arr: np.ndarray, like) -> torch.Tensor:
    """The leaf read from disk as a tensor typed like ``like`` (a tensor:
    its dtype and device; else its numpy dtype, on the CPU), with its own
    shape (``np.ascontiguousarray`` would make a 0-d leaf 1-d)."""
    is_tensor = isinstance(like, torch.Tensor)
    if arr.dtype.kind == "V" and arr.dtype.itemsize != 2:
        raise ValueError(f"a {arr.dtype.itemsize}-byte void leaf is not "
                         f"bfloat16 bits; cannot restore it")
    if arr.dtype.kind == "V" or (
            is_tensor and like.dtype == torch.bfloat16
            and arr.dtype in (np.int16, np.uint16)):
        bits = torch.from_numpy(np.asarray(arr, order="C").view(np.int16))
        if is_tensor:
            return bits.view(torch.bfloat16).to(device=like.device,
                                                dtype=like.dtype)
        arr = bits.view(torch.bfloat16).float().numpy()
    if is_tensor:
        return torch.from_numpy(np.asarray(arr, order="C")).to(
            device=like.device, dtype=like.dtype)
    return torch.from_numpy(np.asarray(
        arr.astype(np.asarray(like).dtype, copy=False), order="C"))


class CheckpointManager:
    """Checksummed checkpoint save/restore with bounded retention and
    optional async writes."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, wait: bool = True):
        """Write ``tree`` as step ``step``.  Leaves are copied to the host
        here, before any thread starts, so the caller may go on mutating
        its tensors.  ``wait=False`` writes on a background thread (one
        outstanding write at a time; ``wait()`` joins it)."""
        host = [(key, _to_host(leaf)) for key, leaf in _flatten(tree)]
        if wait:
            self._write(step, host)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list[tuple[str, np.ndarray]]):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        digests = []
        for i, (key, leaf) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            dtype = _save_leaf(os.path.join(tmp, fname), leaf)
            digest = _file_sha256(os.path.join(tmp, fname))
            digests.append(digest)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(leaf.shape),
                "dtype": dtype, "index": i, "sha256": digest,
            }
        # order-stable over the leaf digests: a garbled leaf and a
        # manifest/leaf mismatch both fail verification
        manifest["checksum"] = hashlib.sha256(
            "".join(digests).encode()).hexdigest()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int) -> tuple[str, dict]:
        d = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                return d, json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            raise CorruptCheckpointError(
                f"{d}: unreadable manifest ({e})") from e

    def verify(self, step: int) -> None:
        """Check a checkpoint's checksums without deserializing it.

        Raises ``CorruptCheckpointError`` when any leaf file's bytes
        disagree with the manifest, or the manifest-level checksum with the
        per-leaf digests.  A manifest without ``sha256`` entries passes: it
        carries nothing to verify against."""
        d, manifest = self._manifest(step)
        metas = sorted(manifest["leaves"].values(), key=lambda m: m["index"])
        digests = []
        for meta in metas:
            want = meta.get("sha256")
            if want is None:
                return
            path = os.path.join(d, meta["file"])
            if not os.path.exists(path):
                raise CorruptCheckpointError(
                    f"{d}: missing leaf file {meta['file']}")
            got = _file_sha256(path)
            if got != want:
                raise CorruptCheckpointError(
                    f"{d}: leaf {meta['file']} checksum mismatch "
                    f"(manifest {want[:12]}…, on disk {got[:12]}…)")
            digests.append(got)
        want_total = manifest.get("checksum")
        if want_total is not None and hashlib.sha256(
                "".join(digests).encode()).hexdigest() != want_total:
            raise CorruptCheckpointError(f"{d}: manifest checksum mismatch")

    def restore(self, like, step: int | None = None):
        """Restore step ``step`` (default: the latest) into the structure
        of ``like``, after verifying every checksum.  Each leaf comes back
        as a tensor with the dtype of ``like``'s leaf, on that leaf's
        device when it is a tensor (else on the CPU).  Returns
        ``(tree, step)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d, manifest = self._manifest(step)
        self.verify(step)
        leaves = []
        for key, leaf_like in _flatten(like):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.load(os.path.join(d, meta["file"]))
            want = tuple(np.shape(leaf_like))
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: ckpt {arr.shape} vs want {want}")
            leaves.append(_from_host(arr, leaf_like))
        return _unflatten(like, leaves), step
