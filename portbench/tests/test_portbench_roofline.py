"""The roofline yardstick at shapes counted by hand."""
from __future__ import annotations

import torch

from portbench import profiling, roofline


def test_bound_takes_the_longer_of_bytes_and_operations():
    t, by = roofline.bound(3.35e12, 1.0)
    assert by == "bytes" and abs(t - 1.0) < 1e-12
    t, by = roofline.bound(1.0, 67e12 * 2)
    assert by == "operations" and abs(t - 2.0) < 1e-12


def test_fused_scan_work_by_hand():
    # b=2 queries probing 3 clusters each, M=4 codes of 4 bits, d=8, m=16
    # buckets; 100 lanes probed, 150 pairs, 10 rows / 12 pairs ranked inline
    nbytes, ops = roofline.fused_scan_work(2, 3, 4, 4, 8, 16, 100, 150, 10,
                                           12)
    params = 4 * 2 * (4 * 16 + 8 + 256 + 3)
    assert nbytes == (100 * 2 + 10 * 8 * 4 + 2 * 3 * 4 + 150 * 12
                      + 4 * 2 * 18 + params)
    assert ops == 150 * 4 + 3 * 8 * 12


def test_rabitq_scan_work_by_hand():
    # b=2 queries probing 3 of 5 clusters each, d=8 (1 B of code a lane)
    nbytes, ops = roofline.rabitq_scan_work(2, 3, 8, 5, 16, 100, 150, 10,
                                            12)
    assert nbytes == (100 * 17 + 10 * 32 + 2 * 3 * 4 + 25 * 150 + 4 * 2 * 35
                      + 4 * 2 * (16 + 5 + 256 + 3))
    assert ops == 150 * (16 + 20) + 3 * 8 * 12


def test_the_counts_grow_with_the_probed_pairs_not_the_stream():
    small = roofline.fused_scan_work(32, 64, 32, 4, 128, 128, 500_000,
                                     2_000_000, 20_000, 300_000)[0]
    more = roofline.fused_scan_work(32, 64, 32, 4, 128, 128, 500_000,
                                    2_000_001, 20_000, 300_000)[0]
    assert more - small == 12


def test_probe_counts():
    cent = torch.tensor([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0], [9.0, 9.0]])
    sizes = torch.tensor([5, 7, 11, 13], dtype=torch.int32)
    qs = torch.tensor([[1.0, 0.0], [9.0, 1.0]])
    # query 0 probes clusters 0 and 1, query 1 clusters 1 and 3
    assert roofline.probe_counts(cent, sizes, qs, 2) == (5 + 7 + 13,
                                                         12 + 20)


def test_inline_pairs_and_kernel_seconds():
    from repro_torch.index.search import SearchResult
    res = SearchResult(None, None, torch.tensor([10, 7, 30]),
                       torch.tensor([4, 0, 5]))
    assert roofline.inline_pairs(res) == (25, 6 + 7 + 25)
    tr = profiling.Trace([(0.0, 100.0)], [(0.0, 90.0)], [
        (1.0, 3.0, "fused_scan_kernel(unsigned char const*, float const*)"),
        (4.0, 5.5, "void fused_scan_kernel(int)"),
        (6.0, 9.0, "fused_scan_b1_kernel(int)"),
        (20.0, 21.0, "void (anonymous namespace)::fused_scan_kernel<8>("
                     "unsigned char const*, float const*)"),
        (22.0, 30.0, "void at::native::vectorized_gather_kernel<16, long>("
                     "char*)"),
        (10.0, 12.0, "Memcpy HtoD (Pageable -> Device)")], [])
    assert abs(roofline.kernel_seconds(tr, "fused_scan_kernel")
               - 4.5e-6) < 1e-15


def test_trace_busy_idle_and_syncs():
    host = sorted([(0.0, 50.0, "portbench.call"),
                   (0.0, 40.0, "portbench.search"),
                   (5.0, 20.0, "aten::item"),
                   (6.0, 19.0, "cudaStreamSynchronize"),
                   (25.0, 26.0, "cudaLaunchKernel"),
                   (41.0, 49.0, "cudaDeviceSynchronize")])
    tr = profiling.Trace([(0.0, 50.0)], [(0.0, 40.0)],
                         [(2.0, 10.0, "k1"), (8.0, 12.0, "k2"),
                          (30.0, 45.0, "Memcpy DtoH")], host)
    assert tr.busy_intervals() == [(2.0, 12.0), (30.0, 45.0)]
    assert tr.busy_us() == 25.0
    assert tr.idle_gaps() == [(0.0, 2.0), (12.0, 30.0), (45.0, 50.0)]
    assert tr.syncs() == 1           # the harness's own sync is outside
    assert len(tr.kernels()) == 2
    assert tr.host_at(15.0) == "aten::item / cudaStreamSynchronize"
    assert tr.host_at(28.0) == "portbench.search"
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "Memcpy DtoH"
    assert b["idle_gaps"][0][0] == "portbench.search"
    assert abs(b["idle_gaps"][0][1] - 20e-6) < 1e-15
