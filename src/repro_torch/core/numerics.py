"""Fixed-order fp32 arithmetic shared by the index, the searchers and the
plain kernel versions.

Every sum that reaches a bucketize or a ranking is added here in an order
fixed by the code, not by the device, and every square root goes through
``sqrt_rn``, so a CPU and a CUDA run give the same bits.  The port relies
on these fp32 operations to round alike on both devices: ``+``, ``-``,
``*`` and ``/`` of two tensors (IEEE round to nearest on both; on CUDA a
division by a Python scalar becomes a multiply by its reciprocal, so the
plain versions divide by a tensor), ``floor``, ``clamp``, ``where``,
comparisons and conversions.  ``torch.sqrt`` is not one of them: on the
CPU (torch 2.13, AVX512) it is 1 ulp off the IEEE root on about 0.6% of
fp32 inputs, while the card's is IEEE.

* ``sqrt_rn``: the IEEE round-to-nearest fp32 square root on both devices.

* ``ordered_sum``: a fixed pairwise order, for the rotations, the RaBitQ
  centroid correction ``s2``, the routing distances and the code products
  of the RaBitQ codebook sample (which the sample kernel adds in the same
  order).
* ``code_dot`` and ``exact_dist``: ascending coordinate order from 0, the
  order in which the CUDA kernels add ``s1`` and ``(x - q)^2`` (with
  ``__fmul_rn``/``__fadd_rn``, so nvcc contracts nothing into an FMA).
* ``rabitq_bounds``: one operation per line, in the order the RaBitQ kernel
  evaluates its ``__f*_rn`` intrinsics.
"""
from __future__ import annotations

import math

import torch

INF = float("inf")
CHUNK = 1 << 24   # elements per temporary block of the fixed-order sums


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded (IEEE round-to-nearest) fp32 square root of an
    fp32 tensor, as ``__fsqrt_rn`` and nvcc's default ``sqrtf`` give it on
    the card and ``jnp.sqrt``/``np.sqrt`` on the CPU; 0, -0, +inf, NaN and
    negatives as ``torch.sqrt``.

    On the CPU ``torch.sqrt`` rounds wrongly by 1 ulp on some inputs, so the
    fp64 root, rounded to fp32, is moved one step to the neighbour whose
    midpoint with it, squared in fp64, lies on the other side of ``x``.  A
    midpoint of two adjacent floats has at most 25 significant bits, so its
    square (at most 50) and the comparison are exact in fp64, and no fp32
    ``x`` equals such a square (no ties).  On the card ``torch.sqrt`` is
    already IEEE (``chip_smoke.py`` phase 3 holds it bitwise against this
    fix-up on 23M values) and saves the fix-up's passes over the (B, n)
    arrays of the main path."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    xd = x.double()
    r = torch.sqrt(xd).float()
    ok = torch.isfinite(r) & (r > 0)
    up = torch.nextafter(r, torch.full_like(r, INF))
    lo = torch.nextafter(r, torch.zeros_like(r))
    rd = r.double()
    hi_m = (rd + up.double()) * 0.5
    lo_m = (rd + lo.double()) * 0.5
    r = torch.where(ok & (xd > hi_m * hi_m), up, r)
    return torch.where(ok & (xd < lo_m * lo_m), lo, r)


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order: the first half is
    added to the second, elementwise, until one column is left (an odd
    column rides along to the next round).  Unlike ``torch.sum``, whose
    reduction order depends on the device, this gives the same bits on the
    CPU and the card."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        y = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([y, x[..., 2 * h:]], dim=-1) if x.shape[-1] % 2 else y
    return x[..., 0]


def exact_dist(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Euclidean distance over the last axis of ``x`` and ``q``
    (broadcast): the fp32 squares of the fp32 differences, added in
    ascending coordinate order in fp32, as the CUDA kernels add them.

    The direct sum, not the norm identity |x|^2 - 2 x.q + |q|^2 of the JAX
    oracle: in fp32 the identity cancels on the clustered corpora (|x|^2 ~
    500 beside a nearest distance ~1) by more than the 1e-4 bar."""
    xt = x.movedim(-1, 0).contiguous()
    qt = q.movedim(-1, 0).contiguous()
    acc = None
    for j in range(xt.shape[0]):
        t = xt[j] - qt[j]
        acc = t * t if acc is None else acc + t * t
    return sqrt_rn(acc)


def rotate(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """``x @ rot.T`` for (R, d) rows, summed by ``ordered_sum`` in row
    chunks of at most ``CHUNK`` products."""
    r, d = x.shape[0], rot.shape[0]
    out = torch.empty(r, d, dtype=torch.float32, device=x.device)
    step = max(1, CHUNK // max(d * d, 1))
    for i in range(0, r, step):
        out[i:i + step] = ordered_sum(x[i:i + step, None, :] * rot[None])
    return out


def rabitq_s2(codes: torch.Tensor, h: torch.Tensor,
              cl: torch.Tensor) -> torch.Tensor:
    """Query-independent centroid correction per lane, ``s2[i] = sum_j
    code[i, j] * h[cl[i], j]`` with ``h = centroids @ rot.T``.  The +-1
    products are exact; ``ordered_sum`` fixes the order of the adds."""
    n, d = codes.shape
    out = torch.empty(n, dtype=torch.float32, device=codes.device)
    step = max(1, CHUNK // max(d, 1))
    for i in range(0, n, step):
        out[i:i + step] = ordered_sum(
            codes[i:i + step].to(torch.float32) * h[cl[i:i + step].long()])
    return out


def code_dot(codes: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(n, d) codes x (B, d) rotated queries -> (B, n) ``s1``, added over
    the coordinates in ascending order from 0, the CUDA kernel's order."""
    acc = torch.zeros(g.shape[0], codes.shape[0], dtype=torch.float32,
                      device=g.device)
    for j in range(codes.shape[1]):
        acc = acc + codes[None, :, j].to(torch.float32) * g[:, j, None]
    return acc


def lane_err(f_o: torch.Tensor, d: int, eps0: float) -> torch.Tensor:
    """The per-lane error bound eps0 * sqrt((1 - f^2) / (f^2 (d - 1)))."""
    f2 = f_o * f_o
    return eps0 * sqrt_rn((1.0 - f2) / (f2 * float(d - 1)))


def rabitq_bounds(s1, s2, nq, norm_o, f_o, d: int, eps0: float):
    """(est, lb, ub) from the code products and the per-lane factors; all
    arguments broadcast against each other.  One operation per line, in
    the CUDA kernel's order (its ``__f*_rn`` calls forbid contraction)."""
    den = torch.clamp(nq, min=1e-12) * math.sqrt(d)
    ip = ((s1 - s2) / den) / f_o
    err = lane_err(f_o, d, eps0)
    scale = (2.0 * nq) * norm_o
    base = nq * nq + norm_o * norm_o

    def dist(t):
        return sqrt_rn(torch.clamp(base - scale * t, min=0.0))

    return dist(ip), dist(ip + err), dist(ip - err)


def rabitq_bounds_stream(codes, s2, norm_o, f_o, cl, g, nq, lane_valid,
                         eps0: float):
    """Batched RaBitQ estimator over a shared stream: (est, lb, ub), each
    (B, n) and +inf off ``lane_valid``.  ``codes`` (n, d) int8 +-1, ``s2``
    (n,) the stream's centroid correction, ``cl`` (n,) clamped owning
    cluster, ``g`` (B, d) the rotated queries ``rotate(qs, rot)``, ``nq``
    (B, C) the query-centroid distances ``sqrt_rn(d2)``.  The P(q - c) =
    Pq - Pc decomposition of the JAX oracle, in fixed summation order."""
    d = codes.shape[1]
    s1 = code_dot(codes, g)
    bounds = rabitq_bounds(s1, s2[None], nq[:, cl.long()], norm_o[None],
                           f_o[None], d, eps0)
    return tuple(torch.where(lane_valid, t, INF) for t in bounds)
