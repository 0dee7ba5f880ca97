"""Carry an index built elsewhere into the port, as numpy arrays.

The JAX package's ``PQIndex`` and ``RabitqIndex`` fields, taken out with
``np.asarray``, become the port's index (and its ``FlatLayout``) on one
device.  The port never sees a JAX object: whoever holds one turns it into
these arrays.

Keys of ``arrays``, for both: ``ivf_centroids`` (C, d) f32, ``member_ids``
(C, cap) int32 (-1 padded), ``member_valid`` (C, cap) bool,
``cluster_sizes`` (C,) int and ``vectors`` (N, d) f32.  PQ adds
``pq_centroids`` (M, K, dsub) f32 and ``codes`` (N, M) uint8; RaBitQ adds
``rot`` (d, d) f32, ``codes`` (N, d) int8 +-1, ``norm_o`` and ``f_o``
(N,) f32.

``lm_params_from_numpy`` does the same for a model: the reference's
parameter pytree, numpy leaves with the layers stacked on a leading axis,
becomes the port's modules (``models.model.build(cfg).init``), and
``lm_params_to_numpy`` takes it back out.  ``lm_tree`` and ``lm_untree``
map between the modules' parameter names and that stacked layout for any
per-parameter tensors (the trainer's checkpoints: parameters and AdamW
moments in the reference's tree).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.index import ivf as ivf_mod
from repro_torch.index import pq as pq_mod
from repro_torch.index import rabitq as rq_mod
from repro_torch.index import search as search_mod
from repro_torch.kernels.platform import resolve_device
from repro_torch.models import model as model_mod

IVF_FIELDS = ("ivf_centroids", "member_ids", "member_valid",
              "cluster_sizes", "vectors")
FIELDS = IVF_FIELDS + ("pq_centroids", "codes")
RABITQ_FIELDS = IVF_FIELDS + ("rot", "codes", "norm_o", "f_o")


def _loader(arrays: Mapping[str, np.ndarray], fields, device):
    """(tensor-making function, IVFIndex) for ``arrays`` on ``device``."""
    missing = [f for f in fields if f not in arrays]
    if missing:
        raise KeyError(f"missing index arrays: {missing}")
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(arrays[name]).astype(dtype))).to(dev)

    ivf = ivf_mod.IVFIndex(
        centroids=t("ivf_centroids", np.float32),
        member_ids=t("member_ids", np.int32),
        member_valid=t("member_valid", np.bool_),
        cluster_sizes=t("cluster_sizes", np.int32))
    return t, ivf


def ivf_index_from_numpy(arrays: Mapping[str, np.ndarray], device=None):
    """The IVF part alone (the four ``ivf`` keys; the corpus vectors go to
    the engine as ``vectors=``).  Returns ``(IVFIndex, FlatLayout)`` on
    ``device``."""
    _, ivf = _loader(arrays, IVF_FIELDS[:-1], device)
    return ivf, ivf_mod.flat_layout(ivf)


def pq_index_from_numpy(arrays: Mapping[str, np.ndarray], device=None):
    """Returns ``(PQIndex, FlatLayout)`` on ``device``."""
    t, ivf = _loader(arrays, FIELDS, device)
    index = search_mod.PQIndex(
        ivf=ivf, pq=pq_mod.PQCodebook(t("pq_centroids", np.float32)),
        codes=t("codes", np.uint8), vectors=t("vectors", np.float32))
    return index, ivf_mod.flat_layout(ivf)


def rabitq_index_from_numpy(arrays: Mapping[str, np.ndarray], device=None):
    """Returns ``(RabitqIndex, FlatLayout)`` on ``device``."""
    t, ivf = _loader(arrays, RABITQ_FIELDS, device)
    rq = rq_mod.RabitqCodes(rot=t("rot", np.float32),
                            codes=t("codes", np.int8),
                            norm_o=t("norm_o", np.float32),
                            f_o=t("f_o", np.float32))
    index = search_mod.RabitqIndex(ivf=ivf, rq=rq,
                                   vectors=t("vectors", np.float32))
    return index, ivf_mod.flat_layout(ivf)


def lm_tree(module: nn.Module, values: Mapping | None = None) -> dict:
    """The reference's pytree of ``module``'s parameters: nested dicts
    under the reference's names, each ``ModuleList`` stacked on a leading
    axis (on the parameters' device, in their dtype, without a gradient).
    With ``values`` (parameter name -> tensor, as ``named_parameters()``
    names them: the optimizer's moments, say), those tensors in the same
    layout."""
    if values is None:
        values = dict(module.named_parameters())
    with torch.no_grad():
        return _tree(module, values, "")


def _tree(mod: nn.Module, values: Mapping, prefix: str):
    if isinstance(mod, nn.ModuleList):
        return _stack([_tree(c, values, f"{prefix}{i}.")
                       for i, c in enumerate(mod)])
    out = {name: values[prefix + name]
           for name, _ in mod.named_parameters(recurse=False)}
    for name, child in mod.named_children():
        out[name] = _tree(child, values, f"{prefix}{name}.")
    return out


def _stack(trees: list):
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def lm_untree(module: nn.Module, tree: Mapping) -> dict:
    """The inverse of ``lm_tree``: parameter name -> leaf (a tensor or a
    numpy array, as ``tree`` holds it), each stacked leaf split along its
    leading axis.  Every name and shape must match ``module``'s."""
    out: dict = {}
    _untree(module, tree, "", out)
    return out


def _untree(mod: nn.Module, tree, prefix: str, out: dict) -> None:
    if isinstance(mod, nn.ModuleList):
        for i, c in enumerate(mod):
            _untree(c, _index_leaves(tree, i, len(mod)), f"{prefix}{i}.", out)
        return
    names = {n for n, _ in mod.named_parameters(recurse=False)} | {
        n for n, _ in mod.named_children()}
    if set(tree) != names:
        raise KeyError(f"{type(mod).__name__}: the tree has {sorted(tree)}, "
                       f"the module {sorted(names)}")
    for name, val in tree.items():
        child = getattr(mod, name)
        if isinstance(child, nn.Module):
            _untree(child, val, f"{prefix}{name}.", out)
            continue
        if tuple(val.shape) != tuple(child.shape):
            raise ValueError(f"{prefix}{name}: shape {tuple(val.shape)}, the "
                             f"module's {tuple(child.shape)}")
        out[prefix + name] = val


def _index_leaves(tree, i: int, n: int):
    if isinstance(tree, Mapping):
        return {k: _index_leaves(v, i, n) for k, v in tree.items()}
    a = tree if isinstance(tree, torch.Tensor) else np.asarray(tree)
    if a.shape[0] != n:
        raise ValueError(f"a stacked leaf has {a.shape[0]} layers, the "
                         f"module {n}")
    return a[i]


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":      # numpy has no bfloat16
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


def load_lm_params(module: nn.Module, tree: Mapping) -> None:
    """Copy ``tree`` (the reference's layout, numpy or tensor leaves) into
    ``module``'s parameters, cast to their dtype and device."""
    flat = lm_untree(module, tree)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(_as_tensor(flat[name]))


def lm_params_from_numpy(tree: Mapping, cfg, device=None) -> nn.Module:
    """The reference's parameter pytree (nested dicts of numpy arrays, the
    layers stacked on a leading axis) as the port's parameters of
    ``cfg`` on ``device``: every name and shape must match."""
    params = model_mod.build(cfg).init(None, device=device)
    load_lm_params(params, tree)
    return params


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params_to_numpy(module: nn.Module) -> dict:
    """The inverse of ``lm_params_from_numpy``: ``module``'s parameters as
    the reference's pytree of numpy arrays (layers stacked; bfloat16 as
    fp32, which the loader casts back exactly)."""
    return _map(lm_tree(module), _host)
