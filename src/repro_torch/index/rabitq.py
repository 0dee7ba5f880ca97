"""RaBitQ (bounded estimator): 1-bit codes with a probabilistic error bound.

The port of the index-time half of the JAX package's ``index/rabitq.py``
(the 1-bit RaBitQ estimator of Gao & Long, 2024).  Per object o of cluster
centroid c:

    r = o - c, norm_o = ||r||, unit o' = r / norm_o
    u = P o'                        (P: random orthonormal rotation)
    code = sign(u) in {-1, +1}^d    (stored int8)
    f_o = (1/sqrt d) sum |u_i|      (stored fp32 factor)

The query-time estimator (est, lb, ub from the code product, the norms and
eps0) is ``core.numerics.rabitq_bounds_stream``, fused into the CUDA kernel
``kernels/csrc/rabitq_fused.cu`` on the BBC path.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class RabitqCodes(NamedTuple):
    """RaBitQ sign codes with the rotation and per-vector factors."""
    rot: torch.Tensor      # (d, d) orthonormal
    codes: torch.Tensor    # (n, d) int8 in {-1, +1}
    norm_o: torch.Tensor   # (n,)
    f_o: torch.Tensor      # (n,)


def random_rotation(generator: torch.Generator, d: int) -> torch.Tensor:
    """Orthonormal (d, d): QR of a standard normal draw from ``generator``
    (a CPU generator; the result lies on the CPU), with the columns' signs
    fixed by diag(R) for a Haar distribution."""
    g = torch.randn(d, d, generator=generator, dtype=torch.float32)
    q, r = torch.linalg.qr(g)
    return q * torch.sign(torch.diagonal(r))[None, :]


def encode(x: torch.Tensor, centroids: torch.Tensor, assignment: torch.Tensor,
           rot: torch.Tensor) -> RabitqCodes:
    """Codes and factors of ``x`` against its assigned centroids under the
    rotation ``rot``."""
    d = x.shape[1]
    r = x - centroids[assignment]
    norm_o = torch.linalg.vector_norm(r, dim=1)
    unit = r / torch.clamp(norm_o, min=1e-12)[:, None]
    u = unit @ rot.T                                     # P o'
    codes = torch.where(u >= 0, 1, -1).to(torch.int8)
    f_o = torch.sum(torch.abs(u), dim=1) / math.sqrt(d)
    return RabitqCodes(rot=rot, codes=codes, norm_o=norm_o,
                       f_o=torch.clamp(f_o, min=1e-6))
