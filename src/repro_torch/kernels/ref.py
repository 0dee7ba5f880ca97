"""Plain PyTorch versions of the four main-path kernels.

Each function mirrors the same-named oracle in the JAX package's
``kernels/ref.py`` and is the CPU path behind ``kernels.ops``.  On the card
``chip_smoke.py`` holds each CUDA kernel against these on the same inputs.

Summation order is part of the contract.  The ADC sum runs over the
sub-quantizers in ascending order in fp32, exactly as the CUDA kernels add
it, so a CPU and a CUDA run of the port give bit-identical estimates and
therefore identical bucket ids, histograms, thresholds and selections.
"""
from __future__ import annotations

import torch

INF = float("inf")


def pq_adc_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """(n, M) shared codes + (B, M, K) per-query LUTs -> (B, n) squared
    estimates, summed over m in ascending order."""
    idx = codes.long()
    acc = luts[:, 0, :][:, idx[:, 0]]
    for m in range(1, codes.shape[1]):
        acc = acc + luts[:, m, :][:, idx[:, m]]
    return acc


def bucketize_batch(dists: torch.Tensor, d_min: torch.Tensor,
                    delta: torch.Tensor, ew_maps: torch.Tensor,
                    m: int) -> torch.Tensor:
    """(B, n) distances, per-query codebook params -> (B, n) Eq. 6 bucket ids,
    with overflow bucket ``m``."""
    n_ew = ew_maps.shape[1]
    bin_f = torch.floor((dists - d_min[:, None]) / delta[:, None])
    overflow = bin_f >= n_ew
    bin_id = bin_f.clamp(0, n_ew - 1).long()
    bucket = torch.gather(ew_maps.long(), 1, bin_id)
    return torch.where(overflow, m, bucket).to(torch.int32)


def histogram_batch(bucket: torch.Tensor, valid: torch.Tensor,
                    m: int) -> torch.Tensor:
    """(B, m+1) int32 counts of the valid lanes per bucket."""
    hist = torch.zeros(bucket.shape[0], m + 1, dtype=torch.int64,
                       device=bucket.device)
    hist.scatter_add_(1, bucket.long(), valid.to(torch.int64))
    return hist.to(torch.int32)


def bucket_hist_batch(dists: torch.Tensor, valid: torch.Tensor,
                      d_min: torch.Tensor, delta: torch.Tensor,
                      ew_maps: torch.Tensor, m: int):
    """Batched Eq. 6 + histogram.  Returns (bucket (B, n), hist (B, m+1))."""
    bucket = bucketize_batch(dists, d_min, delta, ew_maps, m)
    return bucket, histogram_batch(bucket, valid, m)


def l2_exact_batch(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """(n, d) shared vectors, (B, d) queries -> (B, n) exact distances.

    The sum of (x - q)^2, as the CUDA kernels compute it, rather than the
    JAX oracle's norm-identity matmul: in fp32 the identity cancels on the
    clustered corpora (|x|^2 ~ 500 beside a nearest distance ~1) by more
    than the 1e-4 bar, and the direct sum does not.  Lane chunks keep each
    (B, lanes, d) difference block under 2^24 elements."""
    b, n = qs.shape[0], x.shape[0]
    out = torch.empty(b, n, dtype=x.dtype, device=x.device)
    step = max(1, (1 << 24) // max(b * x.shape[1], 1))
    for i in range(0, n, step):
        diff = x[None, i:i + step, :] - qs[:, None, :]
        out[:, i:i + step] = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return out


def fused_scan_batch(codes, vectors, valid, luts, qs, d_min, delta, ew_maps,
                     m: int, tau_pred):
    """Plain version of the batched fused scan.

    Returns (est (B, n), bucket (B, n), hist (B, m+1), early (B, n),
    nmiss (B,)): ``early`` is the exact distance on valid lanes whose bucket
    is at or below ``tau_pred`` and +inf elsewhere, and ``nmiss`` counts the
    valid lanes above it."""
    est = torch.sqrt(torch.clamp(pq_adc_batch(codes, luts), min=0.0))
    est = torch.where(valid, est, INF)
    bucket = bucketize_batch(est, d_min, delta, ew_maps, m)
    hist = histogram_batch(bucket, valid, m)
    pred = valid & (bucket <= tau_pred[:, None])
    early = torch.where(pred, l2_exact_batch(vectors, qs), INF)
    nmiss = torch.sum(valid & ~pred, dim=1).to(torch.int32)
    return est, bucket, hist, early, nmiss
