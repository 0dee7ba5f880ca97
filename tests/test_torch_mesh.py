"""The port's production mesh rules (``launch/mesh.py``) and sharding
constraint (``models/sharding.py``) against the JAX package's, on the
CPU.

* Parameter, optimizer, batch and cache specs equal the reference's for
  the ten full configs and the variants on both production meshes; a
  parameter's reference spec is the port's with the stacked layer axes
  prepended (the port's layers are separate tensors).  The reference's
  functions read only ``mesh.shape``, so they get a stand-in; its
  parameter shapes come from ``jax.eval_shape``.
* The per-chip argument bytes of every dry-run cell equal the reference's
  (its specs applied to its shapes) on both meshes.
* ``constrain`` case by case against the reference's rules, on a fake
  group's mesh (torch's single-process fake process group: no rank
  exists, nothing is sent).
* A train step on DTensors equals the step without a mesh: bitwise on
  one gloo rank, within 1e-5 on 2 and 4 (dense, MoE and SSM smoke
  configs, fp32).
"""
import math
import os
import tempfile
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate,  # noqa: E402
                                      Shard)

from repro import configs as jconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import sharding as shard  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

# the reference's dry run sets XLA_FLAGS to 512 host devices when it is
# imported (for backends made after it): keep this process's setting
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS")
else:
    os.environ["XLA_FLAGS"] = _FLAGS

torch.set_num_threads(2)

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = list(configs.ALIASES) + list(configs.VARIANTS)


def standins(which: str):
    """(reference stand-in, port stand-in) of a production mesh: the
    reference reads ``mesh.shape[name]``, the port ``mesh_dim_names`` and
    ``mesh.shape``."""
    shape, names = MESHES[which]
    return (types.SimpleNamespace(shape=dict(zip(names, shape))),
            types.SimpleNamespace(mesh_dim_names=names, shape=shape))


@pytest.fixture
def fake_group():
    """torch's single-process fake group of 512 ranks, made for one test
    and destroyed after it."""
    assert not dist.is_initialized()
    dryrun.fake_world()
    yield
    dist.destroy_process_group()


def norm(spec) -> tuple:
    """A spec with one-name groups as the name (``PartitionSpec`` keeps
    ``("data",)`` as ``"data"``)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def norm_all(specs: dict) -> dict:
    return {k: norm(v) for k, v in specs.items()}


def _ref_tree_leaf(tree, name: str):
    """The reference's leaf for a port parameter name: the numeric parts
    (layer and segment indices) are its stacked axes."""
    parts = name.split(".")
    node = tree
    for p in parts:
        if not p.isdigit():
            node = node[p]
    return node, sum(p.isdigit() for p in parts)


@pytest.fixture(scope="module")
def ref_shapes():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jconfigs.get(arch)
            cache[arch] = (cfg, jax.eval_shape(jmodel.build(cfg).init,
                                               jax.random.key(0)))
        return cache[arch]
    return get


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch, which, ref_shapes):
    jcfg, sds = ref_shapes(arch)
    ref_mesh, port_mesh = standins(which)
    ref = jmesh.param_specs(sds, jcfg, ref_mesh)
    cfg = configs.get(arch)
    params = model_mod.build(cfg).init(device="meta")
    got = mesh_mod.param_specs(params, cfg, port_mesh)
    ref_paths = {tuple(k.key for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(sds)[0]}
    assert ref_paths == {tuple(p for p in name.split(".") if not p.isdigit())
                         for name in got}
    for name, p in params.named_parameters():
        spec, n_stack = _ref_tree_leaf(ref, name)
        assert norm(spec) == (None,) * n_stack + norm(got[name]), name
        leaf, _ = _ref_tree_leaf(sds, name)
        assert tuple(leaf.shape[n_stack:]) == tuple(p.shape), name
    opt = mesh_mod.opt_state_specs(got)
    ref_opt = jmesh.opt_state_specs(None, ref)
    assert opt["step"] == tuple(ref_opt.step) == ()
    assert opt["m"] == got and opt["v"] == got


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, which):
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    ref_mesh, port_mesh = standins(which)
    for b in (1, 8, 16, 32, 48, 128, 256):
        assert jmesh.batch_axes_for(b, ref_mesh) == \
            mesh_mod.batch_axes_for(b, port_mesh)
        for mode in ("train", "prefill", "decode"):
            ref = jmesh.batch_specs(jcfg, ref_mesh, b, mode)
            assert norm_all(ref) == norm_all(
                mesh_mod.batch_specs(cfg, port_mesh, b, mode))
        ref = jmesh.cache_specs(jcfg, ref_mesh, b)
        assert norm_all(ref) == norm_all(
            mesh_mod.cache_specs(cfg, port_mesh, b))


def _ref_bytes(sds_tree, spec_tree, sizes: dict) -> int:
    """Per-chip bytes of the reference's leaves under its specs (every
    sharded dimension divides evenly)."""
    total = 0
    leaves = jax.tree.leaves(sds_tree)
    specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(specs)
    for leaf, spec in zip(leaves, specs):
        div = 1
        for ax in spec:
            for a in (() if ax is None else
                      (ax if isinstance(ax, tuple) else (ax,))):
                div *= sizes[a]
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // div
    return total


def _ref_args(arch: str, shape_name: str, ref_mesh, sds, jcfg) -> int:
    sh = jdryrun.SHAPES[shape_name]
    sizes = ref_mesh.shape
    p_specs = jmesh.param_specs(sds, jcfg, ref_mesh)
    total = _ref_bytes(sds, p_specs, sizes)
    total += _ref_bytes(jdryrun.input_specs(jcfg, shape_name),
                        jmesh.batch_specs(jcfg, ref_mesh, sh["batch"],
                                          sh["mode"]), sizes)
    if sh["mode"] == "train":
        opt = jax.eval_shape(jadamw.init, sds)
        total += _ref_bytes(opt, jmesh.opt_state_specs(opt, p_specs), sizes)
    if sh["mode"] == "decode":
        model = jmodel.build(jcfg)
        caches = jax.eval_shape(
            lambda: model.init_caches(sh["batch"], sh["seq"]))
        total += _ref_bytes(caches, jmesh.cache_specs(jcfg, ref_mesh,
                                                      sh["batch"]), sizes)
    return total


@pytest.mark.parametrize("which", MESHES)
@pytest.mark.parametrize("arch", list(configs.ALIASES))
def test_argument_bytes_equal_the_reference(arch, which, fake_group,
                                            ref_shapes):
    jcfg, sds = ref_shapes(arch)
    ref_mesh, _ = standins(which)
    cfg = configs.get(arch)
    mesh = mesh_mod.make_production_mesh(multi_pod=which == "multi")
    model = model_mod.build(cfg)
    for shape_name, sh in dryrun.SHAPES.items():
        if shape_name == "long_500k" and \
                cfg.family not in dryrun.LONG_OK_FAMILIES:
            continue
        args = dryrun.cell_inputs(model, sh, mesh)
        assert dryrun._bytes(*args) == _ref_args(
            arch, shape_name, ref_mesh, sds, jcfg), shape_name


def _dt(mesh, shape, pl, dtype=torch.float32):
    """A meta DTensor of global ``shape`` with placements ``pl``."""
    local = list(shape)
    for m, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(m)
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


CONSTRAIN_CASES = [
    # (mesh, shape, axes, placements the reference's rules give)
    ("single", (32, 4096, 576), (shard.BATCH, "model", None),
     (Shard(0), Shard(1))),
    # a batch of 8 does not divide over 16 ranks: whole
    ("single", (8, 4096, 576), (shard.BATCH, "model", None),
     (Replicate(), Shard(1))),
    # "pod" is not on the single-pod mesh: the rest of the group applies
    ("single", (256, 128), (("pod", "data"), None), (Shard(0), Replicate())),
    # both batch axes shard dimension 0, in mesh order
    ("multi", (64, 32, 8), (shard.BATCH, "model", None),
     (Shard(0), Shard(0), Shard(1))),
    # 16 rows do not divide over pod x data = 32: the whole group drops
    ("multi", (16, 32, 8), (shard.BATCH, "model", None),
     (Replicate(), Replicate(), Shard(1))),
    # a dimension smaller than its axis stays whole
    ("single", (32, 1, 576), (shard.BATCH, "model", None),
     (Shard(0), Replicate())),
    ("single", (32, 24, 64), (None, "model", "data"),
     (Shard(2), Replicate())),
    ("single", (32, 48, 64), (None, "model", "data"),
     (Shard(2), Shard(1))),
]


@pytest.mark.parametrize("case", range(len(CONSTRAIN_CASES)))
def test_constrain_follows_the_reference_rules(case, fake_group):
    which, shape, axes, want = CONSTRAIN_CASES[case]
    mesh = mesh_mod.make_production_mesh(multi_pod=which == "multi")
    x = _dt(mesh, shape, [Replicate()] * mesh.ndim)
    y = shard.constrain(x, *axes)
    assert tuple(y.placements) == want
    assert tuple(y.shape) == shape
    plain = torch.zeros(shape[:2])
    assert shard.constrain(plain, *axes[:2]) is plain


def test_constrain_holds_the_gradient_to_its_placements(fake_group):
    """As JAX transposes a sharding constraint into one on the cotangent:
    the gradient reaching the constrained value's producer has the
    constraint's placements, whatever its consumers made of it."""
    mesh = mesh_mod.make_production_mesh()
    x = _dt(mesh, (32, 64, 16), [Shard(0), Replicate()])
    x.requires_grad_(True)
    y = shard.constrain(x * 2, shard.BATCH, "model", None)
    assert tuple(y.placements) == (Shard(0), Shard(1))
    seen = {}
    z = x * 2
    z.register_hook(lambda g: seen.update(g=g.placements))
    shard.constrain(z, shard.BATCH, None, None).sum().backward()
    assert tuple(seen["g"]) == (Shard(0), Replicate())


# --------------------------------------------------------------------------
# a train step on DTensors against the step without a mesh
# --------------------------------------------------------------------------

STEP_ARCHS = ("smollm-135m", "granite-moe-1b-a400m", "mamba2-130m")
STEP_OPT = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10, eps=1e-4)


def _batch(cfg, b=8, s=32):
    rng = np.random.default_rng(0)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))),
            "targets": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}


def step_both(arch: str, mesh) -> dict:
    """One train step (two microbatches) of a smoke config without a mesh
    and on ``mesh``: the largest difference of the loss, grad_norm, lr and
    every updated parameter, and whether all were bitwise equal."""
    cfg = configs.get(arch, smoke=True)
    m = model_mod.build(cfg)
    step = model_mod.make_train_step(m, adamw.AdamWConfig(**STEP_OPT),
                                     n_microbatches=2)
    batch = _batch(cfg)
    p = m.init(0, device="cpu")
    p, _, met = step(p, adamw.init(p), dict(batch))
    q = m.init(0, device="cpu")
    specs = mesh_mod.param_specs(q, cfg, mesh)
    o = mesh_mod.distribute_opt_state(adamw.init(q), specs, mesh)
    mesh_mod.distribute_params(q, specs, mesh)
    b = mesh_mod.distribute_batch(batch, mesh_mod.batch_specs(
        cfg, mesh, 8, "train"), mesh)
    with shard.use_mesh(mesh):
        q, _, qmet = step(q, o, b)
    pairs = [(met[k], qmet[k].full_tensor()) for k in met]
    pairs += [(a.detach(), g.detach().full_tensor()) for (_, a), (_, g) in
              zip(p.named_parameters(), q.named_parameters())]
    return {"max": max(float((a - g).abs().max()) for a, g in pairs),
            "bitwise": all(torch.equal(a, g) for a, g in pairs),
            "sharded": any(isinstance(pl, Shard) for t in q.parameters()
                           for pl in t.placements)}


def _rank(rank, world, shape, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        res = {a: step_both(a, mesh) for a in STEP_ARCHS}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(res, out)


def test_train_step_on_one_gloo_rank_is_bitwise(tmp_path):
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        for arch in STEP_ARCHS:
            r = step_both(arch, mesh)
            assert r["bitwise"], (arch, r)
    finally:
        dist.destroy_process_group()


@pytest.mark.multidevice
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_train_step_on_gloo_ranks_within_1e5(shape):
    world = math.prod(shape)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "res.pt")
        mp.spawn(_rank, args=(world, shape, os.path.join(tmp, "store"), out),
                 nprocs=world, join=True)
        res = torch.load(out)
    for arch, r in res.items():
        assert r["sharded"], arch          # the mesh really splits weights
        assert r["max"] <= 1e-5, (arch, r)
