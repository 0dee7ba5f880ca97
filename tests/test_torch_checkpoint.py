"""The port's checkpoint manager against the JAX package's.

The same tree (nested dicts with unsorted keys, a list, a tuple, a named
tuple, scalars, float32/int32/uint8/bool leaves) saved by both managers
gives the same leaf files, the same per-leaf sha256 digests and the same
whole-checkpoint checksum; each manager restores the other's checkpoint.
Verification runs before any leaf is deserialized, a corrupt leaf or
manifest raises ``CorruptCheckpointError``, retention keeps the last
``keep_last`` steps, and an async write lands the same bytes.  A bfloat16
leaf is written in the reference's bytes (its file, sha256 and manifest
entry), and the port restores the reference's bfloat16 leaf bit for bit.
"""
import json
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as jmanager  # noqa: E402
from repro_torch.checkpoint import manager  # noqa: E402

torch.set_num_threads(2)


class Pair(NamedTuple):
    ema: np.ndarray
    weight: np.ndarray


def _tree(rng):
    return {
        "vectors": rng.standard_normal((50, 8)).astype(np.float32),
        "row_ids": np.arange(50, dtype=np.int32),
        "nested": {"z": [rng.integers(0, 16, (7, 3)).astype(np.uint8),
                         np.array(3.5, np.float32)],
                   "a": (rng.random(5) < 0.5,),
                   "pred": Pair(np.ones(9, np.float32),
                                np.array(0.2, np.float32))},
        "count": np.array(7, np.int64),
    }


def _torch_tree(tree):
    """The same tree with torch tensors as leaves."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(*(_torch_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _manifest(d, step):
    return json.loads((d / f"step_{step:08d}" / "manifest.json").read_text())


def test_same_tree_same_digests_and_checksum(tmp_path):
    tree = _tree(np.random.default_rng(0))
    jmanager.CheckpointManager(str(tmp_path / "jax")).save(3, tree)
    manager.CheckpointManager(str(tmp_path / "port")).save(
        3, _torch_tree(tree))
    jm, tm = _manifest(tmp_path / "jax", 3), _manifest(tmp_path / "port", 3)
    assert tm["checksum"] == jm["checksum"]
    assert tm["leaves"] == jm["leaves"]
    for meta in tm["leaves"].values():
        a = (tmp_path / "port" / "step_00000003" / meta["file"]).read_bytes()
        b = (tmp_path / "jax" / "step_00000003" / meta["file"]).read_bytes()
        assert a == b
    # sorted dict keys, as JAX's flattening orders them
    keys = sorted(tm["leaves"], key=lambda k: tm["leaves"][k]["index"])
    assert keys[0] == "count" and keys[1].startswith("nested/a")
    assert "nested/pred/ema" in keys and "treedef" not in tm


def test_each_restores_the_others(tmp_path):
    tree = _tree(np.random.default_rng(1))
    jm = jmanager.CheckpointManager(str(tmp_path / "jax"))
    tm = manager.CheckpointManager(str(tmp_path / "port"))
    jm.save(1, tree)
    tm.save(1, _torch_tree(tree))
    # the port restores the reference's checkpoint into torch tensors
    got, step = manager.CheckpointManager(str(tmp_path / "jax")).restore(
        _torch_tree(tree))
    assert step == 1 and isinstance(got["nested"]["pred"], Pair)
    assert list(got) == list(tree)
    assert torch.equal(got["vectors"], torch.from_numpy(tree["vectors"]))
    assert got["count"].shape == got["nested"]["z"][1].shape == ()
    assert got["nested"]["a"][0].dtype == torch.bool
    assert torch.equal(got["nested"]["z"][0],
                       torch.from_numpy(tree["nested"]["z"][0]))
    # the reference restores the port's
    jgot, _ = jmanager.CheckpointManager(str(tmp_path / "port")).restore(
        tree)
    np.testing.assert_array_equal(np.asarray(jgot["row_ids"]),
                                  tree["row_ids"])
    np.testing.assert_array_equal(np.asarray(jgot["nested"]["pred"].ema),
                                  tree["nested"]["pred"].ema)
    assert isinstance(jgot["vectors"], type(jnp.zeros(1)))


def test_restore_places_on_like_and_casts(tmp_path):
    tm = manager.CheckpointManager(str(tmp_path))
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    tm.save(5, {"x": x, "skip": None})
    like = {"x": torch.zeros(3, 4, dtype=torch.float64), "skip": None}
    got, step = tm.restore(like)
    assert step == 5 and got["skip"] is None
    assert got["x"].dtype == torch.float64 and got["x"].device == x.device
    assert torch.equal(got["x"], x.double())
    got, _ = tm.restore({"x": np.zeros((3, 4), np.float32)})
    assert isinstance(got["x"], torch.Tensor)
    with pytest.raises(ValueError):
        tm.restore({"x": torch.zeros(4, 3)})
    with pytest.raises(KeyError):
        tm.restore({"y": torch.zeros(3, 4)})


def test_corruption_raises_before_deserializing(tmp_path, monkeypatch):
    tm = manager.CheckpointManager(str(tmp_path))
    tm.save(1, {"a": torch.ones(100), "b": torch.zeros(10)})
    d = tmp_path / "step_00000001"
    victim = d / "leaf_00001.npy"
    data = bytearray(victim.read_bytes())
    data[-1] ^= 0x01
    victim.write_bytes(bytes(data))
    loads = []
    monkeypatch.setattr(manager.np, "load",
                        lambda *a, **k: loads.append(a) or np.zeros(1))
    with pytest.raises(manager.CorruptCheckpointError, match="leaf"):
        tm.restore({"a": torch.ones(100), "b": torch.zeros(10)})
    assert not loads
    monkeypatch.undo()
    (d / "manifest.json").write_text("{not json")
    with pytest.raises(manager.CorruptCheckpointError, match="manifest"):
        tm.verify(1)
    # the reference's manager refuses the port's corrupt leaf too
    tm.save(2, {"a": torch.ones(100)})
    (tmp_path / "step_00000002" / "leaf_00000.npy").write_bytes(b"junk")
    with pytest.raises(jmanager.CorruptCheckpointError):
        jmanager.CheckpointManager(str(tmp_path)).verify(2)
    with pytest.raises(manager.CorruptCheckpointError):
        tm.verify(2)


def test_retention_async_and_whole_checksum(tmp_path):
    tm = manager.CheckpointManager(str(tmp_path), keep_last=2)
    for step in range(4):
        tm.save(step, {"v": torch.full((4,), float(step))}, wait=False)
    tm.wait()
    assert tm.all_steps() == [2, 3] and tm.latest_step() == 3
    assert not list(tmp_path.glob("*.tmp"))
    got, step = tm.restore({"v": torch.zeros(4)})
    assert step == 3 and torch.equal(got["v"], torch.full((4,), 3.0))
    # a manifest whose whole checksum disagrees with its leaf digests
    m = _manifest(tmp_path, 3)
    m["checksum"] = "0" * 64
    (tmp_path / "step_00000003" / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(manager.CorruptCheckpointError, match="checksum"):
        tm.verify(3)
    with pytest.raises(FileNotFoundError):
        manager.CheckpointManager(str(tmp_path / "none")).restore({})


def test_save_copies_leaves_before_returning(tmp_path):
    """An async save writes the values the tree had at the call."""
    tm = manager.CheckpointManager(str(tmp_path))
    t = torch.ones(1000)
    tm.save(0, {"t": t}, wait=False)
    t.zero_()
    tm.wait()
    assert torch.equal(tm.restore({"t": torch.zeros(1000)})[0]["t"],
                       torch.ones(1000))


def _bf16_bits(rng, shape):
    """bfloat16 values as their 16 bits, every pattern but NaNs."""
    bits = rng.integers(0, 1 << 16, shape).astype(np.uint16)
    exp_all_ones = (bits & 0x7F80) == 0x7F80
    return np.where(exp_all_ones, bits & 0xFF7F, bits).astype(np.uint16)


def test_bf16_leaf_has_the_references_bytes(tmp_path):
    bits = _bf16_bits(np.random.default_rng(3), (7, 5))
    jtree = {"w": jnp.asarray(bits).view(jnp.bfloat16),
             "step": np.array(4, np.int32)}
    ttree = {"w": torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16),
             "step": torch.tensor(4, dtype=torch.int32)}
    jmanager.CheckpointManager(str(tmp_path / "jax")).save(2, jtree)
    manager.CheckpointManager(str(tmp_path / "port")).save(2, ttree)
    jm, tm = _manifest(tmp_path / "jax", 2), _manifest(tmp_path / "port", 2)
    assert tm["leaves"] == jm["leaves"] and tm["checksum"] == jm["checksum"]
    assert tm["leaves"]["w"]["dtype"] == "bfloat16"
    for meta in tm["leaves"].values():
        a = (tmp_path / "port" / "step_00000002" / meta["file"]).read_bytes()
        b = (tmp_path / "jax" / "step_00000002" / meta["file"]).read_bytes()
        assert a == b
    # restored bit for bit, from either manager's files
    like = {"w": torch.zeros(7, 5, dtype=torch.bfloat16),
            "step": torch.zeros((), dtype=torch.int32)}
    for d in ("jax", "port"):
        got, _ = manager.CheckpointManager(str(tmp_path / d)).restore(like)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16),
                           torch.from_numpy(bits.view(np.int16)))
        assert got["step"].dtype == torch.int32 and int(got["step"]) == 4
        assert got["step"].shape == ()
    # a bfloat16 leaf into an fp32 tensor: the same values, exactly
    got, _ = manager.CheckpointManager(str(tmp_path / "jax")).restore(
        {"w": torch.zeros(7, 5), "step": np.zeros((), np.int32)})
    assert torch.equal(got["w"], ttree["w"].float())


def test_bf16_from_int_bits_and_other_voids(tmp_path):
    bits = _bf16_bits(np.random.default_rng(4), (6,))
    tm = manager.CheckpointManager(str(tmp_path))
    tm.save(1, {"w": bits.view(np.int16)})
    got, _ = tm.restore({"w": torch.zeros(6, dtype=torch.bfloat16)})
    assert torch.equal(got["w"].view(torch.int16),
                       torch.from_numpy(bits.view(np.int16)))
    # an int16 leaf restored into an int16 tensor stays an integer
    got, _ = tm.restore({"w": torch.zeros(6, dtype=torch.int16)})
    assert torch.equal(got["w"], torch.from_numpy(bits.view(np.int16)))
    np.save(tmp_path / "step_00000001" / "leaf_00000.npy",
            np.zeros(6, np.uint32).view("V4"))
    m = _manifest(tmp_path, 1)
    digest = manager._file_sha256(
        str(tmp_path / "step_00000001" / "leaf_00000.npy"))
    m["leaves"]["w"]["sha256"] = digest
    m["checksum"] = manager.hashlib.sha256(digest.encode()).hexdigest()
    (tmp_path / "step_00000001" / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="4-byte void"):
        tm.restore({"w": torch.zeros(6, dtype=torch.bfloat16)})
