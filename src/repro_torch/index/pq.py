"""Product quantization: training, encoding and ADC tables.

Paper settings: M = d/4 sub-vectors of 4 bits (16 centroids each).  The ADC
table of a query is (M, K) squared sub-distances; an object's estimate is
sum_m LUT[m, code[m]].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.index import kmeans as km
from repro_torch.kernels import ref as kref


class PQCodebook(NamedTuple):
    """Product-quantization codebook: per-subspace centroid tables."""
    centroids: torch.Tensor  # (M, 2^B, dsub)

    @property
    def n_sub(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_codes(self) -> int:
        return self.centroids.shape[1]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]


def train(x: torch.Tensor, n_sub: int, n_bits: int = 4, n_iter: int = 10,
          generator: torch.Generator | None = None) -> PQCodebook:
    n, d = x.shape
    if d % n_sub:
        raise ValueError(f"d={d} is not a multiple of n_sub={n_sub}")
    xs = x.reshape(n, n_sub, d // n_sub)
    cents = [km.kmeans(xs[:, m, :].contiguous(), 2 ** n_bits, n_iter,
                       generator=generator)[0] for m in range(n_sub)]
    return PQCodebook(centroids=torch.stack(cents))


def encode(cb: PQCodebook, x: torch.Tensor) -> torch.Tensor:
    """(n, M) uint8 codes: the nearest sub-centroid of each sub-vector."""
    n = x.shape[0]
    xs = x.reshape(n, cb.n_sub, cb.dsub)
    codes = [km.assign(xs[:, m, :], cb.centroids[m]) for m in range(cb.n_sub)]
    return torch.stack(codes, dim=1).to(torch.uint8)


def adc_table(cb: PQCodebook, qs: torch.Tensor) -> torch.Tensor:
    """(B, M, K) tables of squared sub-distances for a (B, d) query batch,
    or the (M, K) table of one (d,) query.

    The sum over a sub-vector's dsub coordinates runs in ascending order
    with one rounding per add, so a CPU and a CUDA run give the same bits,
    and one query's table is its batched row to the bit."""
    if qs.ndim == 1:
        return adc_table(cb, qs[None])[0]
    diff = qs.reshape(qs.shape[0], cb.n_sub, 1, cb.dsub) - cb.centroids[None]
    sq = diff * diff
    acc = sq[..., 0]
    for t in range(1, cb.dsub):
        acc = acc + sq[..., t]
    return acc


def estimate(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC estimates (B, n) of shared codes (n, M) under (B, M, K) tables,
    squared; the plain version of the ADC kernel."""
    return kref.pq_adc_batch(codes, luts)
