"""The yardstick of two roofline shares of the IVF+PQ path: the codebook
sample's ADC (``pq_sample_adc_kernel`` of ``pq_adc.cu``) and the second
pass (the ``rerank.second_pass`` stage: the exact distances of the selected
lanes that the fused scan did not rank inline).

As in ``roofline.py``, every term is the least the work needs, whatever
kernel does it, so a share never overstates the code it reads:

- the sample: the codes of the lanes of the clusters that some query of
  the call samples, read once at their bit width (the union over the
  batch); each query's LUTs; the (B, w) estimates written once, w the
  sample's padded width; an fp32 add per sub-quantizer after the first for
  each sampled (query, lane) pair;
- the second pass: each query's ``n_second_pass`` rows of d float32, the
  rows counted once by the largest per-query count (a lower bound of the
  batch's union), a 4-byte distance written per pair, and a subtract,
  multiply and add per coordinate of each pair.
"""
from __future__ import annotations


def sample_adc_work(b: int, m_sub: int, n_bits: int, k_codes: int, w: int,
                    lanes: int, pairs: int) -> tuple[int, int]:
    """Bytes and fp32 operations of the sample ADC of one call of ``b``
    queries: ``lanes`` the union of the sampled lanes, ``pairs`` the
    sampled (query, lane) pairs."""
    nbytes = lanes * m_sub * n_bits // 8 + 4 * b * m_sub * k_codes + 4 * b * w
    return nbytes, pairs * (m_sub - 1)


def second_pass_work(d: int, rows: int, pairs: int) -> tuple[int, int]:
    """Bytes and fp32 operations of one call's second pass: ``rows`` the
    largest per-query count of gathered rows, ``pairs`` their sum."""
    return rows * d * 4 + 4 * pairs, 3 * d * pairs


def second_pass_counts(res) -> tuple[int, int]:
    """(largest per-query count, sum) of a call's second-pass rows
    (``SearchResult.n_second_pass``)."""
    import torch
    n = res.n_second_pass.to(torch.int64).reshape(-1)
    return int(n.max().item()), int(n.sum().item())
