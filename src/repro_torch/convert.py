"""Carry an index built elsewhere into the port, as numpy arrays.

The JAX package's ``PQIndex`` fields, taken out with ``np.asarray``, become
the port's ``PQIndex`` (and its ``FlatLayout``) on one device.  The port
never sees a JAX object: whoever holds one turns it into these arrays.

Keys of ``arrays``: ``ivf_centroids`` (C, d) f32, ``member_ids`` (C, cap)
int32 (-1 padded), ``member_valid`` (C, cap) bool, ``cluster_sizes`` (C,)
int, ``pq_centroids`` (M, K, dsub) f32, ``codes`` (N, M) uint8 and
``vectors`` (N, d) f32.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.index import ivf as ivf_mod
from repro_torch.index import pq as pq_mod
from repro_torch.index import search as search_mod
from repro_torch.kernels.platform import resolve_device

FIELDS = ("ivf_centroids", "member_ids", "member_valid", "cluster_sizes",
          "pq_centroids", "codes", "vectors")


def pq_index_from_numpy(arrays: Mapping[str, np.ndarray], device=None):
    """Returns ``(PQIndex, FlatLayout)`` on ``device``."""
    missing = [f for f in FIELDS if f not in arrays]
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
    index = search_mod.PQIndex(
        ivf=ivf, pq=pq_mod.PQCodebook(t("pq_centroids", np.float32)),
        codes=t("codes", np.uint8), vectors=t("vectors", np.float32))
    return index, ivf_mod.flat_layout(ivf)
