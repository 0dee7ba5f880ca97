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
becomes the port's modules (``models.model.build(cfg).init``).
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


def _load_tree(mod: nn.Module, tree: Mapping) -> None:
    """Copy ``tree``'s leaves into ``mod``'s parameters of the same names;
    a ``ModuleList`` takes its entries from the leading axis."""
    names = {n for n, _ in mod.named_parameters(recurse=False)} | {
        n for n, _ in mod.named_children()}
    if set(tree) != names:
        raise KeyError(f"{type(mod).__name__}: the tree has {sorted(tree)}, "
                       f"the module {sorted(names)}")
    for name, val in tree.items():
        child = getattr(mod, name)
        if isinstance(child, nn.ModuleList):
            _load_stack(child, val)
        elif isinstance(child, nn.Module):
            _load_tree(child, val)
        else:
            a = np.asarray(val)
            if a.dtype.name == "bfloat16":      # numpy has no bfloat16
                a = a.astype(np.float32)
            if tuple(a.shape) != tuple(child.shape):
                raise ValueError(f"{name}: shape {a.shape}, the module's "
                                 f"{tuple(child.shape)}")
            child.data.copy_(torch.from_numpy(np.array(a)))


def _load_stack(mods: nn.ModuleList, tree) -> None:
    for i, mod in enumerate(mods):
        sub = _index_leaves(tree, i, len(mods))
        if isinstance(mod, nn.ModuleList):
            _load_stack(mod, sub)
        else:
            _load_tree(mod, sub)


def _index_leaves(tree, i: int, n: int):
    if isinstance(tree, Mapping):
        return {k: _index_leaves(v, i, n) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.shape[0] != n:
        raise ValueError(f"a stacked leaf has {a.shape[0]} layers, the "
                         f"module {n}")
    return a[i]


def lm_params_from_numpy(tree: Mapping, cfg, device=None) -> nn.Module:
    """The reference's parameter pytree (nested dicts of numpy arrays, the
    layers stacked on a leading axis) as the port's parameters of
    ``cfg`` on ``device``: every name and shape must match."""
    params = model_mod.build(cfg).init(None, device=device)
    _load_tree(params, tree)
    return params
