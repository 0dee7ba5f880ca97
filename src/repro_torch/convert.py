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
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.index import ivf as ivf_mod
from repro_torch.index import pq as pq_mod
from repro_torch.index import rabitq as rq_mod
from repro_torch.index import search as search_mod
from repro_torch.kernels.platform import resolve_device

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
