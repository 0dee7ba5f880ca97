"""RaBitQ (bounded estimator): 1-bit codes with a probabilistic error bound.

The port of the index-time half of the JAX package's ``index/rabitq.py``
(the 1-bit RaBitQ estimator of Gao & Long, 2024).  Per object o of cluster
centroid c:

    r = o - c, norm_o = ||r||, unit o' = r / norm_o
    u = P o'                        (P: random orthonormal rotation)
    code = sign(u) in {-1, +1}^d    (stored int8)
    f_o = (1/sqrt d) sum |u_i|      (stored fp32 factor)

At query time, per probed cluster (``query_factors``, ``estimate``):

    q_r = q - c, norm_q = ||q_r||, v = P (q_r / norm_q)
    ip = (code . v / sqrt d) / f_o,  err = eps0 sqrt((1 - f_o^2) / (f_o^2 (d-1)))
    est, lb, ub = sqrt(max(norm_q^2 + norm_o^2 - 2 norm_q norm_o (ip, ip + err,
                                                              ip - err), 0))

the single-query searcher's estimator (the CUDA kernel
``kernels/csrc/rabitq_est.cu``).  The batched searchers use the P(q - c) =
Pq - Pc form of the same estimator, ``core.numerics.rabitq_bounds_stream``,
fused into ``kernels/csrc/rabitq_fused.cu`` on the BBC path.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import numerics
from repro_torch.kernels import ops


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


class QueryFactors(NamedTuple):
    """Per-query RaBitQ factors against one centroid (``v`` (d,), ``norm_q``
    ()) or against T centroids at once (``v`` (T, d), ``norm_q`` (T,))."""
    v: torch.Tensor        # rotated unit residual(s)
    norm_q: torch.Tensor   # residual norm(s)


def query_factors(rq: RabitqCodes, q: torch.Tensor,
                  centroid: torch.Tensor) -> QueryFactors:
    """The factors of the (d,) query ``q`` against a (d,) centroid, or
    against (T, d) centroids in one pass.  The norm is the square root of
    the ``numerics.ordered_sum`` of the squared residual and the rotation
    goes through ``numerics.rotate``: fixed orders, so the CPU and the card
    give the same bits."""
    single = centroid.ndim == 1
    qr = q[None] - (centroid[None] if single else centroid)      # (T, d)
    norm_q = numerics.sqrt_rn(numerics.ordered_sum(qr * qr))
    v = numerics.rotate(qr / torch.clamp(norm_q, min=1e-12)[:, None], rq.rot)
    if single:
        return QueryFactors(v=v[0], norm_q=norm_q[0])
    return QueryFactors(v=v, norm_q=norm_q)


def estimate(codes: torch.Tensor, norm_o: torch.Tensor, f_o: torch.Tensor,
             qf: QueryFactors, eps0: float = 3.0,
             valid: torch.Tensor | None = None):
    """(est, lb, ub): actual distances, the lower bound clamped at 0.

    One cluster's members (codes (c, d), factors (c,), ``qf`` against one
    centroid) give (c,) outputs; T tiles at once (codes (T, cap, d),
    factors and ``valid`` (T, cap), ``qf`` against T centroids) give
    (T, cap) outputs, +inf off ``valid``.  Both run the estimator kernel
    (``ops.rabitq_est_tiles``) on CUDA tensors."""
    if codes.ndim == 2:
        return ops.rabitq_est(codes, norm_o, f_o, qf.v, qf.norm_q, eps0)
    if valid is None:
        valid = torch.ones(codes.shape[:2], dtype=torch.bool,
                           device=codes.device)
    return ops.rabitq_est_tiles(codes, norm_o, f_o, qf.v, qf.norm_q, valid,
                                eps0)
