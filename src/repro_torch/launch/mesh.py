"""Production mesh + sharding rules for the assigned architecture matrix.

The port of the JAX package's ``repro.launch.mesh``.  Mesh axes:
  single-pod : (16, 16)      ("data", "model")          = 256 ranks
  multi-pod  : (2, 16, 16)   ("pod", "data", "model")   = 512 ranks

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the first
ranks of the default process group: real cards (NCCL), CPU ranks (gloo),
or the single-process fake group of ``launch/dryrun.py``, where no rank
exists and nothing is sent.

Sharding policy (the reference's, divisibility-guarded):

  * weights: the last axis divisible by |model| shards over "model"
    (output-feature / expert / vocab preference), and one further divisible
    axis shards over "data" (FSDP/ZeRO pattern); 1-D tensors replicate
    unless divisible.
  * MoE expert stacks prefer the expert axis for "model" (EP).
  * optimizer state (m, v) mirrors its parameter's spec; step replicates.
  * batch: global batch shards over ("pod", "data") when divisible, else
    ("data",), else replicated.
  * KV caches: batch -> batch axes; kv-heads or head_dim -> "model";
    sequence -> "data" when batch could not use it.

A spec is a tuple with one entry per tensor dimension: an axis name, a
tuple of names, or None (the reference's ``PartitionSpec``).  The port's
layers are separate tensors, not stacked on a leading axis, so a
parameter's spec here is the reference's without its stacked prefix (one
leading None, two for the hybrid's SSM layers).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.models.sharding import placements as to_placements

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh over ranks 0..n-1 of the default group, which
    must hold at least n ranks: on the cards of an NCCL group, else on the
    CPU (gloo, or the dry run's fake group)."""
    import torch.distributed as dist
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, the default group has {world}: "
            "initialise torch.distributed first (launch/dryrun.py makes a "
            "fake group of 512)")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def axis_size(mesh, name: str) -> int:
    sizes = dict(zip(mesh.mesh_dim_names or (), tuple(mesh.shape)))
    return sizes.get(name, 1)


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------

def leaf_spec(name: str, shape, model_n: int, data_n: int) -> tuple:
    """One parameter's spec by the reference's ``_leaf_spec`` rule, for the
    port's unstacked tensors.  ``name`` is its ``named_parameters`` name."""
    ndim = len(shape)
    dims: list = [None] * ndim

    def divisible(ax, n):
        return shape[ax] >= n and shape[ax] % n == 0

    cand_model = list(range(ndim - 1, -1, -1))
    if name.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down") and ndim >= 3:
        cand_model = [0] + cand_model          # expert axis first
    for ax in cand_model:
        if dims[ax] is None and divisible(ax, model_n):
            dims[ax] = "model"
            break
    for ax in range(ndim):
        if dims[ax] is None and divisible(ax, data_n):
            dims[ax] = "data"
            break
    return tuple(dims)


def param_specs(params: nn.Module, cfg, mesh) -> dict:
    """Parameter name -> spec, for every parameter of ``params``."""
    model_n, data_n = axis_size(mesh, "model"), axis_size(mesh, "data")
    return {k: leaf_spec(k, p.shape, model_n, data_n)
            for k, p in params.named_parameters()}


def opt_state_specs(p_specs: dict) -> dict:
    """m/v mirror params; step replicates."""
    return {"step": (), "m": dict(p_specs), "v": dict(p_specs)}


# --------------------------------------------------------------------------
# batch / cache specs
# --------------------------------------------------------------------------

def batch_axes_for(global_batch: int, mesh):
    pod_n = axis_size(mesh, "pod")
    data_n = axis_size(mesh, "data")
    if pod_n > 1 and global_batch % (pod_n * data_n) == 0:
        return ("pod", "data")
    if global_batch % data_n == 0:
        return ("data",)
    return None


def batch_specs(cfg, mesh, global_batch: int, mode: str) -> dict:
    ba = batch_axes_for(global_batch, mesh)
    tok = (ba, None)
    if mode in ("train", "prefill"):
        specs = {"tokens": tok, "targets": tok}
        if cfg.family == "vlm":
            specs["patch_embeds"] = (ba, None, None)
        if cfg.family == "encdec":
            specs = {"tokens": tok, "targets": tok,
                     "frames": (ba, None, None)}
        if mode == "prefill":
            specs.pop("targets")
        return specs
    specs = {"token": (ba,), "pos": (ba,)}
    if cfg.family == "encdec":
        specs["enc_out"] = (ba, None, None)
    return specs


def cache_specs(cfg, mesh, global_batch: int) -> dict:
    """Specs of ``init_decode_caches``' tensors (family-dependent)."""
    model_n = axis_size(mesh, "model")
    data_n = axis_size(mesh, "data")
    ba = batch_axes_for(global_batch, mesh)
    seq_axis = None if ba is not None else ("data" if data_n > 1 else None)

    def kv_spec(n_lead):  # (lead..., B, S, kv, hd)
        kv_ax = "model" if cfg.n_kv % model_n == 0 else None
        hd_ax = None
        if kv_ax is None and cfg.hd % model_n == 0:
            hd_ax = "model"
        return (*([None] * n_lead), ba, seq_axis, kv_ax, hd_ax)

    if cfg.family in ("dense", "moe", "vlm"):
        out = {"k": kv_spec(1), "v": kv_spec(1)}
        if cfg.kv_quant:
            out["k_scale"] = (None, ba, seq_axis)
            out["v_scale"] = (None, ba, seq_axis)
        return out
    sd = cfg.ssm_dims()

    def ssm_h_spec(n_lead):  # (lead..., B, H, P, N)
        h_ax = "model" if sd.n_heads % model_n == 0 else None
        return (*([None] * n_lead), ba, h_ax, None, None)

    def conv_spec(n_lead):  # (lead..., B, W-1, C)
        c_ax = "model" if sd.d_conv_ch % model_n == 0 else None
        return (*([None] * n_lead), ba, None, c_ax)

    if cfg.family == "ssm":
        return {"h": ssm_h_spec(1), "conv": conv_spec(1)}
    if cfg.family == "hybrid":
        return {"h": ssm_h_spec(2), "conv": conv_spec(2),
                "k": kv_spec(1), "v": kv_spec(1)}
    if cfg.family == "encdec":
        return {"k": kv_spec(1), "v": kv_spec(1)}
    raise ValueError(cfg.family)


# --------------------------------------------------------------------------
# placing tensors on the mesh
# --------------------------------------------------------------------------

def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's shard of a tensor of ``shape`` (every
    sharded dimension divides evenly, as the specs guarantee)."""
    out = list(shape)
    for d, ax in enumerate(spec):
        for a in (() if ax is None else
                  (ax if isinstance(ax, tuple) else (ax,))):
            out[d] //= axis_size(mesh, a)
    return tuple(out)


def distribute(t: torch.Tensor, spec, mesh) -> DTensor:
    """``t`` as a ``DTensor`` on ``mesh`` by ``spec``.  A meta tensor
    becomes a meta shard of the right local shape (nothing allocated, no
    collective); a real one is split by ``distribute_tensor`` (every rank
    must pass the same full tensor)."""
    from torch.distributed.tensor import distribute_tensor
    pl = to_placements(spec, mesh)
    if t.device.type == "meta":
        local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, pl)


def distribute_params(params: nn.Module, specs: dict, mesh) -> nn.Module:
    """Replace every parameter of ``params`` by a ``DTensor`` by its spec,
    in place (same names, no gradient, as ``layers.param`` makes them)."""
    for name, p in list(params.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = params.get_submodule(mod_name) if mod_name else params
        setattr(mod, leaf, nn.Parameter(distribute(p.detach(), specs[name],
                                                   mesh),
                                        requires_grad=False))
    return params


def distribute_opt_state(state, p_specs: dict, mesh):
    """An ``AdamWState`` with its moments as ``DTensor``s by their
    parameters' specs and its step replicated."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(
        step=distribute(state.step, (), mesh),
        m={k: distribute(v, p_specs[k], mesh) for k, v in state.m.items()},
        v={k: distribute(v, p_specs[k], mesh) for k, v in state.v.items()})


def distribute_batch(batch: dict, specs: dict, mesh) -> dict:
    return {k: distribute(v, specs[k], mesh) for k, v in batch.items()}


def local_bytes(t: torch.Tensor) -> int:
    """Bytes of one rank's shard of ``t`` (all of a plain tensor)."""
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()
