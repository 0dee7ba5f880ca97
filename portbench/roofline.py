"""The yardstick of the kernels' roofline shares.

Byte and operation counts of the two fused scans, after ``chip_smoke.py``'s
``bound()`` and its phase-7 arithmetic, with every term cut to the least the
search needs, whatever kernel does the scan: the codes of the probed lanes
at their bit width, each query's probe list, the outputs of the probed
(query, lane) pairs alone, each input byte read once and each output byte
written once.  A kernel that reads a dense lane mask, writes every lane or
keeps a code in a whole byte does more than this, and its share shows it.

Two terms depend on what the program decided inside the call: the rows the
PQ scan re-ranks inline (lanes at or below its predicted threshold) and the
rows the RaBitQ scan certifies.  The benchmark reads them from the call's
public work counters, which give per-query pair counts: the pairs count as
they are, and the rows read once are counted as the largest per-query
count, a lower bound of the batch's union.  Every term is a floor of the
work, so the share never overstates the kernel.
"""
from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12      # device memory bandwidth
FP32_FLOP_PER_S = 67e12        # float32 outside the tensor cores
N_EW = 256                     # equal-width map entries of a codebook


def bound(nbytes: float, ops32: float) -> tuple[float, str]:
    """The least seconds the work needs: bytes at the memory rate or fp32
    operations at the peak rate, whichever is longer, and which it is."""
    tb = nbytes / HBM_BYTES_PER_S
    to = ops32 / FP32_FLOP_PER_S
    return max(tb, to), ("bytes" if tb >= to else "operations")


def fused_scan_work(b: int, n_probe: int, m_sub: int, n_bits: int, d: int,
                    m: int, lanes_probed: int, pairs_valid: int,
                    rows_pred: int, pairs_pred: int) -> tuple[int, int]:
    """Bytes and fp32 operations of one batched fused PQ scan (#1) of ``b``
    queries: the ``n_bits``-bit codes of the probed lanes, the rows
    re-ranked inline, each query's ``n_probe`` probed clusters, an estimate,
    a bucket and an early exact distance (4 B each) per probed pair, the
    histograms and the per-query parameters; an ADC add per probed pair and
    sub-quantizer, a subtract, multiply and add per coordinate of each pair
    re-ranked inline."""
    params = 4 * b * (m_sub * (1 << n_bits) + d + N_EW + 3)
    nbytes = (lanes_probed * m_sub * n_bits // 8 + rows_pred * d * 4
              + 4 * b * n_probe + 12 * pairs_valid + 4 * b * (m + 2)
              + params)
    ops32 = pairs_valid * m_sub + 3 * d * pairs_pred
    return nbytes, ops32


def rabitq_scan_work(b: int, n_probe: int, d: int, c: int, m: int,
                     lanes_probed: int, pairs_valid: int, rows_cert: int,
                     pairs_cert: int) -> tuple[int, int]:
    """Bytes and fp32 operations of one bound-fused RaBitQ scan (#5): the
    1-bit codes (d / 8 B) and 16 B of factors per probed lane, the rows
    certified inline, each query's ``n_probe`` probed clusters, 25 B of
    outputs per probed pair (estimate, two bounds, two buckets, exact
    distance, certified flag), the histograms and the per-query parameters;
    the estimate and bounds per probed pair, a subtract, multiply and add
    per coordinate of each certified pair."""
    nbytes = (lanes_probed * (d // 8 + 16) + rows_cert * d * 4
              + 4 * b * n_probe + 25 * pairs_valid
              + 4 * b * (2 * (m + 1) + 1)
              + 4 * b * (2 * d + c + N_EW + 3))
    ops32 = pairs_valid * (2 * d + 20) + 3 * d * pairs_cert
    return nbytes, ops32


def probe_counts(centroids, sizes, qs, n_probe: int) -> tuple[int, int]:
    """(lanes_probed, pairs_valid) of one call: the members of the clusters
    any of the call's queries probe (the ``n_probe`` nearest centroids), and
    the sum over queries of their probed members."""
    import torch
    q = torch.as_tensor(qs, dtype=torch.float32).to(centroids.device)
    q = q.reshape(-1, centroids.shape[1])
    d2 = ((q[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
    probed = torch.topk(d2, n_probe, dim=1, largest=False).indices
    sizes = sizes.to(torch.int64)
    return (int(sizes[torch.unique(probed)].sum().item()),
            int(sizes[probed].sum().item()))


def kernel_seconds(trace, kernel: str) -> float:
    """Device seconds of the counted calls in kernels named ``kernel``
    (any namespace and template arguments: ``void (anonymous
    namespace)::fused_scan_kernel<8>(...)``)."""
    import re
    pat = re.compile(r"(?:^|[\s:])" + re.escape(kernel) + r"(?:<[^()]*>)?\(")
    return 1e-6 * sum(t - s for s, t, name in trace.kernels()
                      if pat.search(name))


def inline_pairs(res) -> tuple[int, int]:
    """(largest per-query count, sum) of the pairs a call's scan ranked by
    their exact distance inline: the re-ranked pairs that no second pass
    gathered (``n_reranked - n_second_pass``)."""
    import torch
    inline = (res.n_reranked.to(torch.int64)
              - res.n_second_pass.to(torch.int64)).reshape(-1)
    return int(inline.max().item()), int(inline.sum().item())
