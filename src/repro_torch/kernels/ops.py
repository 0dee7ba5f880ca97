"""Wrappers of the port's CUDA kernels, with the JAX package's signatures.

The backend follows the tensors' device: CPU tensors go to the plain
versions in ``kernels/ref.py``; CUDA tensors go to the hand-written CUDA
kernels in ``csrc/`` (built at first use by ``kernels/_build.py``).  A mix of
devices, or a CUDA tensor the kernel does not take (wrong dtype, layout or
shape), raises; there is no fallback from a CUDA tensor to the plain version.

Layout follows the JAX package's public one: ``valid`` is (B, n) and every
per-lane output is (B, n).  PQ codes stay uint8, RaBitQ codes int8, and the
kernels mask their own ragged edges, so nothing is padded.

The single-query wrappers (``pq_adc``, ``l2_exact``, ``bucket_hist``,
``fused_scan``, ``rabitq_est``) keep the JAX package's single-query
signatures; the first three launch their batched kernel at B = 1, and
``fused_scan`` launches the one-query kernel of ``fused_scan.cu``, which
``fused_scan_batch`` also launches at B = 1.

``LAUNCHES`` counts kernel launches (plain-version calls do not count);
``chip_smoke.py`` zeroes it before a run and reads it after.  A launch of
the PQ, l2, bucket or fused kernel at B = 1 counts under its single-query
key, whichever wrapper made it; B > 1 under the ``*_batch`` key.  The
codebook sample's ADC, its RaBitQ upper bounds and the second pass's
gather have no single-query form and count under ``pq_sample_adc_batch``,
``rabitq_sample_ub_batch`` and ``l2_gather_rows_batch`` at every B; so does
the fused scan's chunked-LUT kernel, under ``fused_scan_chunked_batch``, and
the sample plan's kernel, by mode: ``sample_plan_batch`` (the row sorted in
shared memory) and ``sample_plan_sorted_batch`` (a row read sorted: a long
row after ``torch.topk``, or a caller's top-k).  The routing's lane mask
counts under ``probe_mask_batch`` at every B, the masked exact pass
(RaBitQ's stragglers) under ``l2_exact_masked_batch``.  While a profiler
records,
the two batched fused scans also count (``spans.count``, in the wrapper
that chooses the grid) the (query, lane) pairs their grid walks, as
``scan.pairs_passed`` (the lanes of each query's probed lists, which the
whole-LUT PQ kernel counts itself, or B x n where a scan covers every
lane), and the probed ones among them, the set bits of the lane mask that
their histogram counts, as ``scan.pairs_probed``; the masked exact pass
counts the row tiles it staged (``rerank.straggler_tiles_read``) and all
of them (``rerank.straggler_tiles``).

The launch shape of the exact-distance and ADC kernels is a plain function
of the problem's shape (``_l2_plan``, ``_adc_plan``): how many queries a
thread and a query tile hold, the grid and the shared memory; one kernel
each serves every B.  The shard collector's (``_collect_plan``) is its
chunk count, grid and the layout of the scratch that one memset zeroes.
The bucketize-histogram kernel's (``_hist_plan``) is its persistent grid
over (query, chunk) items, the one-query fused scan's (``_scan_plan``) its
persistent grid over chunks, the batched one's (``_batch_scan_plan``) its
blocks a query over the query's probed lists and whether the LUT is
staged whole or in chunks of sub-quantizers, the RaBitQ estimator's (``_est_lanes``) the
lanes a block holds, the sample ADC's (``_sample_plan``) its blocks a
query and whether a query's LUT is staged, the sample's RaBitQ bounds'
(``_sample_ub_plan``) its threads a block and shared rows, the second
pass's gather's (``_gather_plan``) its lanes a row, load width and shared
memory, the sample plan's (``_sample_plan_launch``) whether a block sorts
the row in shared memory, the lane mask's (``_mask_plan``) its groups of
queries, blocks a group and where a group's bitset lives, the masked
exact pass's (``_masked_plan``) its rounds of queries, row tiles and ring.
The CPU tests check the plans; the kernels
refuse a shared-memory size below their layout's.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch import spans
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"fused_scan_batch": 0, "pq_adc_batch": 0, "l2_exact_batch": 0,
            "bucket_hist_batch": 0, "fused_rabitq_scan_batch": 0,
            "shard_collect_batch": 0, "spec_compact_batch": 0,
            "rabitq_est": 0, "fused_scan": 0, "pq_adc": 0, "l2_exact": 0,
            "bucket_hist": 0, "pq_sample_adc_batch": 0,
            "l2_gather_rows_batch": 0, "rabitq_sample_ub_batch": 0,
            "fused_scan_chunked_batch": 0, "sample_plan_batch": 0,
            "sample_plan_sorted_batch": 0, "probe_mask_batch": 0,
            "l2_exact_masked_batch": 0}

MAX_SMEM = 232448      # 227 KB: the most dynamic shared memory a block may use
MAX_TILES = 1024       # lane-tile blocks per query chunk (grid-stride beyond)
LANE_TILE = 256        # threads per block = lanes per tile
SMEM_PER_SM = 233472   # 228 KB: the shared memory of one SM, for occupancy
SMS = 132              # SMs of an H100 SXM (the plans' default)
# l2_rerank.cu's tiled layout: rows per block, coordinates per chunk, the
# ring depth, and the padded chunk stride
L2_ROWS, L2_CHUNK, L2_STAGES = 128, 64, 2
L2_LD = L2_CHUNK + 4
# l2_rerank.cu's masked layout: the queries whose mask a block reads at
# once (a round, at most four groups of eight), coordinates per chunk, the
# ring depth, and the padded chunk stride
L2M_ROUND, L2M_CHUNK, L2M_STAGES = 32, 32, 3
L2M_LD = L2M_CHUNK + 4
# pq_adc.cu's tiled layout: code rows per tile, ring depth; the LUT bytes a
# block may stage (two blocks per SM at B = 32, M = 32, K = 16) and the
# blocks an SM holds at most (the kernel's __launch_bounds__)
ADC_ROWS, ADC_STAGES, ADC_LUT_BUDGET = 256, 2, 96 * 1024
ADC_BLOCKS_PER_SM = 2
# pq_adc.cu's sample kernel: the lanes of a query one block walks (four a
# thread)
SAMPLE_LANES = 4 * LANE_TILE
# rabitq_fused.cu's sample kernel: the shared memory a block may take, so
# that three blocks share an SM
SAMPLE_UB_SMEM = SMEM_PER_SM // 3 - 1024
# l2_rerank.cu's gather kernel: the slots of one query a block takes, and
# the first round's pairs a lane loads at once (4-byte words, 16-byte)
GATHER_TILE = 1024
GATHER_PAIRS = {False: 8, True: 4}
# shard_collect.cu: lanes per chunk ticket (256 threads x 16 lanes), and
# buffer slots per sentinel-fill ticket
COLLECT_CHUNK, COLLECT_FILL = 4096, 8192
# bucket_hist.cu: lanes per work item (256 threads x 4 lanes) and the
# persistent blocks an SM holds (its __launch_bounds__)
BH_CHUNK, BH_BLOCKS_PER_SM = 1024, 4
# fused_scan.cu's one-query kernel: lanes per work item (one a thread of a
# warp), warps a block, the persistent blocks an SM holds (its
# __launch_bounds__), and the code-row widths it loads as whole words
# (16-byte words; 8-byte words for 24)
FS_TILE, FS_WARPS, FS_BLOCKS_PER_SM = 32, 8, 6
FS_WORD_ROWS = {16: 16, 24: 8, 32: 16}
# fused_scan.cu's batched kernel: the blocks an SM holds (its
# __launch_bounds__) and the waves of them a launch fills, split over the
# queries (one query a block)
FS_LIST_BLOCKS_PER_SM, FS_LIST_WAVES = 4, 2
# fused_scan.cu's chunked-LUT kernel: lanes a tile (its threads; one block
# an SM, its __launch_bounds__), the waves of such blocks a launch fills,
# and the grid's largest second axis
FS_CHUNK_LANES, FS_CHUNK_WAVES, GRID_Y = 1024, 2, 65535
# rabitq_est.cu: the most lanes (threads) a block holds
EST_LANES = 128
# sample_plan.cu: the most threads a block has (its __launch_bounds__), the
# keys a thread holds where a warp sorts 512 keys in registers (at least
# 512 keys, at most 16 * 1024), and the threads that read a sorted row
PLAN_THREADS, PLAN_LANE_KEYS, PLAN_SORTED_THREADS = 1024, 16, 256
# lane_mask.cu: the queries a bitset word holds (a block's group), the
# lanes a thread takes at a time, and the persistent blocks an SM holds
# (its __launch_bounds__)
MASK_GROUP, MASK_LANES, MASK_BLOCKS_PER_SM = 32, 16, 4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fused_scan": {
        "fused_scan_batch_launch": [_P] * 15 + [_I] * 12 + [_P],
        "fused_scan_batch_smem_bytes": [_I] * 6,
        "fused_scan_batch_tile": [],
        "fused_scan_smem_bytes": [_I] * 6,
        "fused_scan_b1_launch": [_P] * 13 + [_I] * 11 + [_P],
        "fused_scan_b1_smem_bytes": [_I] * 5,
        "fused_scan_b1_tile": [],
        "fused_scan_chunked_launch": [_P] * 13 + [_I] * 12 + [_P],
        "fused_scan_chunked_tile": []},
    "pq_adc": {
        "pq_adc_batch_launch": [_P] * 3 + [_I] * 9 + [_P],
        "pq_adc_tiled_smem_bytes": [_I] * 4,
        "pq_sample_adc_launch": [_P] * 5 + [_I] * 7 + [_P]},
    "l2_rerank": {
        "l2_exact_batch_launch": [_P] * 3 + [_I] * 7 + [_P],
        "l2_gather_rows_launch": [_P] * 5 + [ctypes.c_longlong]
                                 + [_I] * 6 + [_P],
        "l2_gather_rows_smem_bytes": [_I] * 2,
        "l2_exact_masked_launch": [_P] * 5 + [_I] * 7 + [_P],
        "l2_exact_masked_smem_bytes": []},
    "bucket_hist": {
        "bucket_hist_batch_launch": [_P] * 7 + [_I] * 9 + [_P],
        "bucket_hist_smem_bytes": [_I] * 2,
        "bucket_hist_chunk": []},
    "rabitq_fused": {
        "fused_rabitq_scan_batch_launch":
            [_P] * 24 + [_I] * 6 + [_F] * 3 + [_I] * 3 + [_P],
        "rabitq_fused_smem_bytes": [_I] * 4,
        "rabitq_sample_ub_launch":
            [_P] * 7 + [_I] + [_P] * 4 + [_I] * 10 + [_F] * 3 + [_P]},
    "shard_collect": {
        "shard_collect_batch_launch": [_P] * 13 + [_I] * 10 + [_P],
        "spec_compact_batch_launch": [_P] * 8 + [_I] * 7 + [_P],
        "shard_collect_smem_bytes": [_I] * 2,
        "shard_collect_chunk": []},
    "rabitq_est": {
        "rabitq_est_launch": [_P] * 9 + [_I] * 3 + [_F] * 3 + [_I] * 2 + [_P],
        "rabitq_est_smem_bytes": [_I] * 2},
    "sample_plan": {
        "sample_plan_launch": [_P] * 2 + [ctypes.c_longlong] + [_I] * 10
                              + [_F] * 3 + [_P] * 5 + [_I] * 3 + [_P]},
    "lane_mask": {
        "probe_mask_launch": [_P, _P, ctypes.c_longlong] + [_P] * 3
                             + [ctypes.c_longlong] + [_I] * 6 + [_P]},
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_READY: dict[str, ctypes.CDLL] = {}


def _lib(name: str) -> ctypes.CDLL:
    """Kernel library ``name``, built on first use, with its C signatures
    declared (every pointer a c_void_p, so ctypes never truncates one)."""
    lib = _READY.get(name)
    if lib is None:
        lib = _build.load(name)
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _READY[name] = lib
    return lib


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for all-CUDA arguments, False for all-CPU; raises otherwise."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"kernel arguments on mixed or unsupported devices: "
                     f"{sorted(str(t.device) for t in tensors)}")


def _need(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple) -> torch.Tensor:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: the CUDA kernel takes a contiguous {dtype} tensor of "
            f"shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
            f"contiguous={t.is_contiguous()}")
    return t


def _params(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Small per-query parameters are cast here (B or B*n_ew elements)."""
    return x.to(dtype).contiguous()


def _pick_bq(b: int, smem_bytes) -> tuple[int, int]:
    """Largest query chunk (8, 4, 2, 1; no wider than the batch needs) whose
    shared memory fits one block."""
    bq = 8
    while bq > 1 and bq // 2 >= b:
        bq //= 2
    while bq > 1 and smem_bytes(bq) > MAX_SMEM:
        bq //= 2
    smem = smem_bytes(bq)
    if smem > MAX_SMEM:
        raise ValueError(f"one query needs {smem} bytes of shared memory, "
                         f"more than the {MAX_SMEM} a block may use")
    return bq, smem


def _tiles(n: int) -> int:
    return max(1, min((n + LANE_TILE - 1) // LANE_TILE, MAX_TILES))


def _scan_smem(bq: int, m_sub: int, k_codes: int, d: int, n_ew: int,
               m: int) -> int:
    """``fused_scan_smem_bytes`` of ``fused_scan.cu``: one block of the
    chunked-LUT scan (``bq`` = 1) with a chunk of ``m_sub`` sub-quantizers
    of its query's LUT, its query, codebook, histogram and counters."""
    return 4 * bq * (m_sub * k_codes + d + 2 + n_ew + (m + 1) + 3)


def _batch_smem(m_sub: int, k_codes: int, d: int, n_ew: int, m: int,
                p: int) -> int:
    """``fused_scan_batch_smem_bytes``: one block of the batched scan (a
    query's whole LUT, its row and ew_map, a histogram, a miss count, and
    the running sizes and starts of its ``p`` lists)."""
    return 4 * (m_sub * k_codes + d + n_ew + (m + 1) + 1 + 2 * p + 1)


def _b1_smem(m_sub: int, k_codes: int, d: int, n_ew: int, m: int) -> int:
    """``fused_scan_b1_smem_bytes``: one block of the one-query kernel (the
    whole LUT, the query, the ew_map, a histogram and a counter a warp)."""
    return 4 * (m_sub * k_codes + d + n_ew + FS_WARPS * (m + 1) + FS_WARPS)


class ScanPlan(NamedTuple):
    """One launch of the batched fused PQ scan."""
    chunked: bool        # fused_scan_chunked_kernel; else fused_scan_kernel
    mc: int              # sub-quantizers a staged LUT chunk (M: the whole)
    blocks: int          # lane-tile blocks of a query (one query a block)
    smem: int            # dynamic shared memory, bytes


@functools.lru_cache(maxsize=4096)
def _batch_scan_plan(b: int, n: int, m_sub: int, k_codes: int, d: int,
                     n_ew: int, m: int, sms: int = SMS, p: int = 1,
                     cap: int | None = None) -> ScanPlan:
    """The batched scan's launch over each query's ``p`` probed lists of at
    most ``cap`` lanes each (p = 1 and no cap: one list of every lane).
    Where one query's whole LUT fits a block beside its lists,
    ``fused_scan_kernel``: one query a block, ``FS_LIST_WAVES`` waves of
    ``FS_LIST_BLOCKS_PER_SM`` blocks an SM (fewer where the shared memory
    holds fewer) split over the queries, and no more blocks a query than
    the ``LANE_TILE``-lane tiles of p x cap lanes (of n, past it); a
    block's tiles are every ``blocks``-th of its query's walk, so any walk
    up to n lanes is covered.  Past that, the chunked-LUT kernel
    (``_chunked_plan``), over every lane.  Raises where the batch outgrows
    the grid's second axis or a lane index its int32."""
    smem = _batch_smem(m_sub, k_codes, d, n_ew, m, p)
    if smem > MAX_SMEM:
        return _chunked_plan(b, n, m_sub, k_codes, d, n_ew, m, sms=sms)
    span = n if cap is None else min(n, p * cap)
    per_sm = max(1, min(FS_LIST_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    blocks = max(1, min(-(-span // LANE_TILE),
                        -(-sms * per_sm * FS_LIST_WAVES // max(b, 1))))
    if b > GRID_Y:
        raise ValueError(f"fused_scan_batch: {b} queries, more than the "
                         f"{GRID_Y} blocks of a grid's second axis")
    if n + blocks * LANE_TILE >= 2 ** 31:
        raise ValueError(f"fused_scan_batch: n={n} lanes overflow the "
                         f"kernel's int32 lane indices")
    return ScanPlan(False, m_sub, blocks, smem)


def _chunked_plan(b: int, n: int, m_sub: int, k_codes: int, d: int,
                  n_ew: int, m: int, mc: int | None = None,
                  sms: int = SMS) -> ScanPlan:
    """``fused_scan_chunked_kernel``: one query a block, its LUT staged
    ``mc`` sub-quantizers at a time; by default the fewest chunks that fit
    a block, each a multiple of 16 sub-quantizers where M is one (16-byte
    code words).  A block holds its lane tiles through every chunk, the
    partial sums kept in ``est`` by the lane's own thread, so it loads its
    query's LUT once; there are ``FS_CHUNK_WAVES`` waves of one block an
    SM, split over the queries, and no more blocks than lane tiles:
    ``blocks`` loads of each query's LUT a call.  Raises where not even one
    sub-quantizer's rows fit."""
    step = 16 if m_sub % 16 == 0 else 1
    if mc is None:
        for chunks in range(1, m_sub + 1):
            mc = -(-(-(-m_sub // chunks)) // step) * step
            if _scan_smem(1, mc, k_codes, d, n_ew, m) <= MAX_SMEM:
                break
    smem = _scan_smem(1, mc, k_codes, d, n_ew, m)
    if smem > MAX_SMEM:
        raise ValueError(f"fused_scan: a query's LUT rows of K={k_codes} at "
                         f"d={d} need {smem} bytes of shared memory, more "
                         f"than the {MAX_SMEM} a block may use")
    tiles = max(1, -(-n // FS_CHUNK_LANES))
    blocks = min(tiles, GRID_Y, max(1, sms * FS_CHUNK_WAVES // b))
    return ScanPlan(True, mc, blocks, smem)


class Plan(NamedTuple):
    """One launch of the exact-distance or ADC kernel."""
    tn: int              # queries per thread
    qt: int              # queries per query tile (looped inside a block)
    grid: int            # blocks
    smem: int            # dynamic shared memory, bytes
    staged: bool = True  # ADC: codes through the shared-memory ring


def _pow2_at_least(b: int, cap: int) -> int:
    p = 1
    while p < min(b, cap):
        p *= 2
    return p


@functools.lru_cache(maxsize=4096)
def _l2_plan(b: int, n: int, d: int) -> Plan:
    """The exact-distance launch for B queries over (n, d) rows: TN = 1, 2
    or 4 queries per thread, query tiles of 8, 16 or 32 (the narrowest that
    holds B, looped inside the block past 32), one block per 128 rows."""
    tn = _pow2_at_least(-(-b // 8), 4)
    return Plan(tn, 8 * tn, max(1, -(-n // L2_ROWS)),
                L2_STAGES * (L2_ROWS + 8 * tn) * L2_LD * 4)


@functools.lru_cache(maxsize=4096)
def _adc_plan(b: int, n: int, m_sub: int, k_codes: int,
              sms: int = SMS) -> Plan:
    """The ADC launch for B queries over (n, M) codes with (B, M, K) LUTs,
    one kernel at every B: TN = 1-8 queries per thread and as many queries
    per tile as ``ADC_LUT_BUDGET`` (or one query's LUT, if larger) holds;
    the codes go through the ring when it fits beside the LUTs; one
    persistent block per row tile, at most ``ADC_BLOCKS_PER_SM`` on each SM
    and fewer where the shared memory holds fewer.
    Raises when one query's LUT exceeds a block's shared memory."""
    per_q = 4 * m_sub * k_codes
    budget = max(ADC_LUT_BUDGET, per_q)
    tn = _pow2_at_least(b, 8)
    while tn > 1 and tn * per_q > budget:
        tn //= 2
    qt = min(-(-b // tn) * tn, budget // per_q // tn * tn)
    lut = 4 * (-(-qt * m_sub * k_codes // 4) * 4)
    ring = ADC_STAGES * ADC_ROWS * m_sub
    staged = lut + ring <= MAX_SMEM
    smem = lut + ring * staged
    if smem > MAX_SMEM:
        raise ValueError(f"pq_adc: one query's LUT (M={m_sub}, K={k_codes}) "
                         f"needs {smem} bytes of shared memory, more than "
                         f"the {MAX_SMEM} a block may use")
    blocks = max(1, min(ADC_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    return Plan(tn, qt, max(1, min(-(-n // ADC_ROWS), sms * blocks)), smem,
                staged)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _count_pairs(passed, hist: torch.Tensor) -> None:
    """A fused scan's work, while a profiler records: the (query, lane)
    pairs its grid walks (``scan.pairs_passed``: an int, or a tensor of
    per-query counts summed after the window) and those of them probed,
    the lanes the lane mask sets, which the scan's (B, m+1) histogram
    ``hist`` counts once each (``scan.pairs_probed``, its sum)."""
    spans.count("scan.pairs_passed", passed)
    spans.count("scan.pairs_probed", hist)


def _count(name: str, b: int) -> None:
    """One launch of a batched kernel: at B = 1 it is the single-query
    kernel's launch."""
    LAUNCHES[name if b == 1 else name + "_batch"] += 1


def pq_adc_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Shared (n, M) uint8 codes x per-query (B, M, K) LUTs -> (B, n) squared
    estimates."""
    if not _on_cuda(codes, luts):
        return _ref.pq_adc_batch(codes, luts)
    n, m_sub = codes.shape
    b, _, k_codes = luts.shape
    _need(codes, "codes", torch.uint8, (n, m_sub))
    _need(luts, "luts", torch.float32, (b, m_sub, k_codes))
    out = torch.empty(b, n, dtype=torch.float32, device=codes.device)
    if b == 0 or n == 0:
        return out
    p = _adc_plan(b, n, m_sub, k_codes, _sms(codes.device.index))
    # bit 0: codes through the ring; bit 1: 16-byte code copies
    flags = p.staged | 2 * _aligned(codes)
    rc = _lib("pq_adc").pq_adc_batch_launch(
        codes.data_ptr(), luts.data_ptr(), out.data_ptr(), n, m_sub, k_codes,
        b, p.tn, p.qt, flags, p.grid, p.smem, _stream())
    _check(rc, "pq_adc_batch")
    _count("pq_adc", b)
    return out


class SamplePlan(NamedTuple):
    """One launch of the codebook sample's ADC."""
    grid_x: int          # blocks a query
    smem: int            # the staged LUT, bytes; 0: LUTs from device memory


def _sample_plan(w: int, m_sub: int, k_codes: int) -> SamplePlan:
    """The sample ADC's launch over w lanes a query: one block for each
    ``SAMPLE_LANES`` lanes, the query's LUT staged in shared memory where
    it fits a block."""
    lut = 4 * m_sub * k_codes
    return SamplePlan(max(1, -(-w // SAMPLE_LANES)),
                      lut if lut <= MAX_SMEM else 0)


def pq_sample_adc_batch(codes: torch.Tensor, luts: torch.Tensor,
                        pos: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Shared (n, M) uint8 codes x per-query (B, M, K) LUTs over per-query
    lanes: ``pos`` (B, w) int64 stream positions, in range where ``ok``
    (B, w) holds -> (B, w) squared estimates, +inf off ``ok``.  One launch
    at any M."""
    if not _on_cuda(codes, luts, pos, ok):
        return _ref.pq_sample_adc_batch(codes, luts, pos, ok)
    n, m_sub = codes.shape
    b, _, k_codes = luts.shape
    w = pos.shape[1]
    _need(codes, "codes", torch.uint8, (n, m_sub))
    _need(luts, "luts", torch.float32, (b, m_sub, k_codes))
    _need(pos, "pos", torch.int64, (b, w))
    _need(ok, "ok", torch.bool, (b, w))
    if b > 65535:
        raise ValueError(f"pq_sample_adc_batch: {b} queries, more than the "
                         f"65535 blocks of a grid's second axis")
    out = torch.empty(b, w, dtype=torch.float32, device=codes.device)
    if b == 0 or w == 0:
        return out
    p = _sample_plan(w, m_sub, k_codes)
    vec = m_sub % 16 == 0 and _aligned(codes)     # 16-byte code words
    rc = _lib("pq_adc").pq_sample_adc_launch(
        codes.data_ptr(), luts.data_ptr(), pos.data_ptr(), ok.data_ptr(),
        out.data_ptr(), m_sub, k_codes, b, w, vec, p.grid_x, p.smem,
        _stream())
    _check(rc, "pq_sample_adc_batch")
    LAUNCHES["pq_sample_adc_batch"] += 1
    return out


def l2_exact_batch(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """(n, d) shared vectors x (B, d) queries -> (B, n) exact distances."""
    if not _on_cuda(x, qs):
        return _ref.l2_exact_batch(x, qs)
    n, d = x.shape
    b = qs.shape[0]
    _need(x, "x", torch.float32, (n, d))
    _need(qs, "qs", torch.float32, (b, d))
    out = torch.empty(b, n, dtype=torch.float32, device=x.device)
    if b == 0 or n == 0:
        return out
    p = _l2_plan(b, n, d)
    vec = d % 4 == 0 and _aligned(x, qs)     # 16-byte copies
    rc = _lib("l2_rerank").l2_exact_batch_launch(
        x.data_ptr(), qs.data_ptr(), out.data_ptr(), n, d, b, p.tn, vec,
        p.grid, p.smem, _stream())
    _check(rc, "l2_exact_batch")
    _count("l2_exact", b)
    return out


class MaskedPlan(NamedTuple):
    """One launch of the masked exact-distance kernel."""
    rounds: int          # rounds of ``L2M_ROUND`` queries a block takes
    grid: int            # blocks: one per ``L2_ROWS`` rows
    smem: int            # dynamic shared memory, bytes


@functools.lru_cache(maxsize=4096)
def _masked_plan(b: int, n: int) -> MaskedPlan:
    """The masked pass's launch for B queries over n rows: one block per
    128-row tile, taking the queries in rounds of 32 (each round's mask
    slice, list and ring of its own), and a 3-stage ring of (128 + 32)
    rows of 32 coordinates at a stride of 36 floats, at every d: three
    blocks an SM."""
    return MaskedPlan(max(1, -(-b // L2M_ROUND)), max(1, -(-n // L2_ROWS)),
                      L2M_STAGES * (L2_ROWS + L2M_ROUND) * L2M_LD * 4)


def l2_exact_batch_masked(x: torch.Tensor, qs: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """(n, d) shared vectors x (B, d) queries under a (B, n) bool ``mask``
    -> (B, n) exact distances, bitwise ``l2_exact_batch``'s at every set
    pair.  Entries off the mask are not written on the card (the plain
    version gives +inf there): a caller reads the set pairs alone.  One
    launch (``_masked_plan``); a row tile no query needs is not read.

    While a profiler records, the (rounds, tiles) bytes of the row tiles
    the pass staged count as ``rerank.straggler_tiles_read`` (summed after
    the window) and their number as ``rerank.straggler_tiles``."""
    if not _on_cuda(x, qs, mask):
        out = _ref.l2_exact_batch_masked(x, qs, mask)
        staged = _ref.masked_tiles(mask, L2_ROWS, L2M_ROUND)
    else:
        n, d = x.shape
        b = qs.shape[0]
        _need(x, "x", torch.float32, (n, d))
        _need(qs, "qs", torch.float32, (b, d))
        _need(mask, "mask", torch.bool, (b, n))
        out = torch.empty(b, n, dtype=torch.float32, device=x.device)
        if b == 0 or n == 0:
            return out
        p = _masked_plan(b, n)
        staged = torch.empty(p.rounds, p.grid, dtype=torch.uint8,
                             device=x.device)
        vec = d % 4 == 0 and _aligned(x, qs)        # 16-byte copies
        vec_mask = n % 16 == 0 and _aligned(mask)   # 16-byte mask reads
        rc = _lib("l2_rerank").l2_exact_masked_launch(
            x.data_ptr(), qs.data_ptr(), mask.data_ptr(), out.data_ptr(),
            staged.data_ptr(), n, d, b, vec, vec_mask, p.grid, p.smem,
            _stream())
        _check(rc, "l2_exact_batch_masked")
        LAUNCHES["l2_exact_masked_batch"] += 1
    spans.count("rerank.straggler_tiles_read", staged)
    spans.count("rerank.straggler_tiles", staged.numel())
    return out


class GatherPlan(NamedTuple):
    """One launch of the second pass's gather kernel."""
    g: int               # lanes a row (8, 16 or 32)
    vec: bool            # 16-byte loads
    smem: int            # dynamic shared memory, bytes


def _gather_plan(d: int, aligned: bool) -> GatherPlan:
    """The gather's launch at width d: 16-byte loads where d % 8 == 0 and
    the vectors are 16-byte aligned; the fewest lanes a row (8-32) that
    take the first round's pairs (d/2 / 4 of 16 bytes, or d/2 words) at
    ``GATHER_PAIRS`` a lane, so small rows put more rows of a warp in
    flight; the query, the slot list and a buffer of ceil(d/2) floats a
    group in shared memory (the kernel's ``gather_smem_floats``).  Raises
    past a block's shared memory."""
    vec = d % 8 == 0 and aligned
    units = d // 2 // 4 if vec else d // 2
    per = GATHER_PAIRS[vec]
    g = 8
    while g < 32 and g * per < units:
        g *= 2
    smem = 4 * (-(-d // 4) * 4 + GATHER_TILE
                + LANE_TILE // g * (-(-(d - d // 2) // 4) * 4))
    if smem > MAX_SMEM:
        raise ValueError(f"l2_gather_rows: d={d} needs {smem} bytes of "
                         f"shared memory, more than the {MAX_SMEM} a block "
                         f"may use")
    return GatherPlan(g, vec, smem)


def l2_gather_rows(vectors: torch.Tensor, ids: torch.Tensor,
                   qs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, d) vectors, per-query id rows ``ids`` (B, w) int64 (-1 allowed
    off ``mask``; a view with any row stride and unit column stride, such
    as a row expanded over the queries), (B, d) queries and a (B, w)
    ``mask`` -> (B, w) exact distances on ``mask``, +inf off it.  One
    launch: the second pass of the re-rank."""
    if not _on_cuda(vectors, ids, qs, mask):
        return _ref.l2_gather_rows(vectors, ids, qs, mask)
    n, d = vectors.shape
    b, w = mask.shape
    _need(vectors, "vectors", torch.float32, (n, d))
    _need(qs, "qs", torch.float32, (b, d))
    _need(mask, "mask", torch.bool, (b, w))
    if ids.dtype != torch.int64 or tuple(ids.shape) != (b, w) \
            or (w > 1 and ids.stride(1) != 1):
        raise ValueError(f"ids: the CUDA kernel takes int64 ({b}, {w}) rows "
                         f"with unit column stride, got {ids.dtype} "
                         f"{tuple(ids.shape)} strides {ids.stride()}")
    if b > 65535:
        raise ValueError(f"l2_gather_rows: {b} queries, more than the 65535 "
                         f"blocks of a grid's second axis")
    out = torch.empty(b, w, dtype=torch.float32, device=vectors.device)
    if b == 0 or w == 0:
        return out
    p = _gather_plan(d, _aligned(vectors))
    rc = _lib("l2_rerank").l2_gather_rows_launch(
        vectors.data_ptr(), ids.data_ptr(), qs.data_ptr(), mask.data_ptr(),
        out.data_ptr(), ids.stride(0), d, b, w, p.g, p.vec, p.smem,
        _stream())
    _check(rc, "l2_gather_rows")
    LAUNCHES["l2_gather_rows_batch"] += 1
    return out


class HistPlan(NamedTuple):
    """One launch of a persistent-block kernel over work items of a fixed
    number of lanes: the bucketize histogram (``bucket_hist.cu``) and the
    one-query fused scan (``fused_scan.cu``)."""
    chunks: int          # work items (chunks of lanes) per query
    per: int             # items of a block's run; the scan: most a warp takes
    grid: int            # persistent blocks


@functools.lru_cache(maxsize=4096)
def _hist_plan(b: int, n: int, sms: int = SMS) -> HistPlan:
    """The B * chunks work items, query-major, cut into runs of ``per``
    consecutive items, one run a block, at most ``BH_BLOCKS_PER_SM`` blocks
    on each SM: a block stages a query's codebook once per run."""
    chunks = max(1, -(-n // BH_CHUNK))
    total = b * chunks
    per = -(-total // min(total, sms * BH_BLOCKS_PER_SM))
    if total + per >= 2 ** 31:
        raise ValueError(f"bucket_hist_batch: {total} work items (B={b}, "
                         f"n={n}) overflow the kernel's int32 indices")
    return HistPlan(chunks, per, -(-total // per))


@functools.lru_cache(maxsize=4096)
def _scan_plan(n: int, smem: int, sms: int = SMS) -> HistPlan:
    """The one-query fused scan over n lanes: tiles of ``FS_TILE`` lanes
    dealt round robin to the ``FS_WARPS`` warps of persistent blocks (tile
    t to warp t % (grid * FS_WARPS), counted block-fastest, so consecutive
    tiles land on different SMs), at most ``FS_BLOCKS_PER_SM`` blocks on
    each SM and fewer where ``smem`` bytes a block hold fewer; ``per`` is
    the most tiles a warp takes."""
    chunks = max(1, -(-n // FS_TILE))
    blocks = max(1, min(FS_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    grid = min(-(-chunks // FS_WARPS), sms * blocks)
    warps = grid * FS_WARPS
    if (chunks + warps) * FS_TILE >= 2 ** 31:
        raise ValueError(f"fused_scan: n={n} lanes overflow the kernel's "
                         f"int32 lane indices")
    return HistPlan(chunks, -(-chunks // warps), grid)


@functools.lru_cache(maxsize=None)
def _hist_lib() -> ctypes.CDLL:
    """The histogram kernel's library, checked once against ``BH_CHUNK``."""
    lib = _lib("bucket_hist")
    if lib.bucket_hist_chunk() != BH_CHUNK:
        raise RuntimeError(f"bucket_hist.cu takes {lib.bucket_hist_chunk()} "
                           f"lanes a work item, ops.BH_CHUNK says {BH_CHUNK}")
    return lib


def bucket_hist_batch(dists: torch.Tensor, valid: torch.Tensor,
                      d_min: torch.Tensor, delta: torch.Tensor,
                      ew_maps: torch.Tensor, m: int):
    """(B, n) distances, per-query codebooks -> (bucket (B, n) int32, hist
    (B, m+1) int32 over the valid lanes).  On the card the launch function
    memsets ``hist`` and launches the kernel: no PyTorch call between."""
    if not _on_cuda(dists, valid, d_min, delta, ew_maps):
        return _ref.bucket_hist_batch(dists, valid, d_min, delta, ew_maps, m)
    b, n = dists.shape
    n_ew = ew_maps.shape[1]
    _need(dists, "dists", torch.float32, (b, n))
    _need(valid, "valid", torch.bool, (b, n))
    d_min = _params(d_min, torch.float32)
    delta = _params(delta, torch.float32)
    ew_maps = _params(ew_maps, torch.int32)
    dev = dists.device
    bucket = torch.empty(b, n, dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return bucket, torch.zeros(b, m + 1, dtype=torch.int32, device=dev)
    lib = _hist_lib()
    smem = lib.bucket_hist_smem_bytes(n_ew, m)
    if smem > MAX_SMEM:
        raise ValueError(f"bucket_hist_batch: n_ew={n_ew}, m={m} need {smem} "
                         f"bytes of shared memory")
    p = _hist_plan(b, n, _sms(dev.index))
    hist = torch.empty(b, m + 1, dtype=torch.int32, device=dev)
    vec = n % 4 == 0 and _aligned(dists, bucket) \
        and valid.data_ptr() % 4 == 0
    rc = lib.bucket_hist_batch_launch(
        dists.data_ptr(), valid.data_ptr(), d_min.data_ptr(),
        delta.data_ptr(), ew_maps.data_ptr(), bucket.data_ptr(),
        hist.data_ptr(), n, b, n_ew, m, p.chunks, p.per, p.grid, vec, smem,
        _stream())
    _check(rc, "bucket_hist_batch")
    _count("bucket_hist", b)
    return bucket, hist


def fused_scan_batch(codes: torch.Tensor, vectors: torch.Tensor,
                     valid: torch.Tensor, luts: torch.Tensor,
                     qs: torch.Tensor, d_min: torch.Tensor,
                     delta: torch.Tensor, ew_maps: torch.Tensor, m: int,
                     tau_pred: torch.Tensor,
                     probed: torch.Tensor | None = None,
                     offsets: torch.Tensor | None = None,
                     cap: int | None = None):
    """Batched fused estimate + bucketize + histogram + early exact over a
    shared candidate stream.

    ``codes`` (n, M) uint8 and ``vectors`` (n, d) are the stream every query
    shares; ``valid`` (B, n) masks each query's probed lanes; ``luts``
    (B, M, K), ``qs`` (B, d), the codebook parameters and ``tau_pred`` (B,)
    are per query.  ``probed`` (B, P) int64 (each query's distinct probed
    clusters, nearest first) and ``offsets`` (C + 1) int64 (the layout's
    cluster starts) give each query's lists of lanes, at most ``cap``
    lanes a list (a host bound that sizes the grid; default n); without
    them a query's one list is every lane.  Every lane ``valid`` sets must
    lie in one of its query's lists.

    Returns (est (B, n), bucket (B, n), hist (B, m+1), early (B, n), nmiss
    (B,)).  ``est``, ``bucket`` and ``early`` are defined on the lanes of
    each query's lists, and unspecified elsewhere: a valid lane's estimate,
    bucket, and exact distance where its bucket is at or below tau_pred
    (+inf where not); an invalid lane's (+inf, the bucket of +inf, +inf).
    ``hist`` counts the valid lanes' buckets and ``nmiss`` the valid lanes
    above tau_pred, the lanes left to the second gather.  The plain version
    (the CPU's) defines every lane.  On the card the launch function zeroes
    hist and nmiss (one memset) and launches the kernel: the one-query
    kernel at B = 1 (``_fused_scan_one``), else ``fused_scan_kernel`` over
    the lists; where one query's LUT outgrows a block's shared memory, the
    chunked-LUT kernel at any B over every lane (``_batch_scan_plan``).
    While a profiler records, ``scan.pairs_passed`` counts the pairs
    walked: the lists' lanes (B x n on the two kernels over every lane)."""
    if (probed is None) != (offsets is None):
        raise ValueError("fused_scan_batch: probed and offsets come together")
    lists = () if probed is None else (probed, offsets)
    b, n = valid.shape
    if not _on_cuda(codes, vectors, valid, luts, qs, d_min, delta, ew_maps,
                    tau_pred, *lists):
        out = _ref.fused_scan_batch(codes, vectors, valid, luts, qs, d_min,
                                    delta, ew_maps, m, tau_pred)
        passed = (b * n if not lists
                  else (offsets[probed + 1] - offsets[probed]).sum())
    elif luts.shape[0] == 1:
        out = tuple(t[None] for t in _fused_scan_one(
            codes, vectors, valid.reshape(-1), luts[0], qs.reshape(-1),
            d_min, delta, ew_maps, m, tau_pred))
        passed = n
    else:
        out, passed = _scan_batch(None, codes, vectors, valid, luts, qs,
                                  d_min, delta, ew_maps, m, tau_pred,
                                  probed, offsets, cap)
    _count_pairs(passed, out[2])
    return out


@functools.lru_cache(maxsize=64)
def _one_list(n: int, dev: torch.device):
    """Every lane as one list: ``probed`` (1, 1) zeros, which each query
    reads at row stride 0, and ``offsets`` [0, n]."""
    return (torch.zeros(1, 1, dtype=torch.int64, device=dev),
            torch.tensor([0, n], dtype=torch.int64, device=dev))


def _scan_batch(plan: ScanPlan | None, codes, vectors, valid, luts, qs,
                d_min, delta, ew_maps, m: int, tau_pred, probed=None,
                offsets=None, cap: int | None = None):
    """``fused_scan_batch`` on CUDA tensors under ``plan`` (None: the one
    ``_batch_scan_plan`` picks; a test may force either kernel).  Returns
    the outputs and the pairs walked (a (B,) tensor of the kernel's
    per-query counts over lists, else B x n)."""
    n, m_sub = codes.shape
    d = vectors.shape[1]
    b, _, k_codes = luts.shape
    n_ew = ew_maps.shape[1]
    _need(codes, "codes", torch.uint8, (n, m_sub))
    _need(vectors, "vectors", torch.float32, (n, d))
    _need(valid, "valid", torch.bool, (b, n))
    _need(luts, "luts", torch.float32, (b, m_sub, k_codes))
    _need(qs, "qs", torch.float32, (b, d))
    d_min = _params(d_min, torch.float32)
    delta = _params(delta, torch.float32)
    ew_maps = _params(ew_maps, torch.int32)
    tau_pred = _params(tau_pred, torch.int32)
    dev = codes.device
    if probed is None:
        (probed, offsets), pstride, cap = _one_list(n, dev), 0, None
    else:
        if probed.dim() != 2 or probed.shape[0] != b or offsets.dim() != 1:
            raise ValueError(f"fused_scan_batch: probed (B={b}, P) and "
                             f"offsets (C + 1,), got {tuple(probed.shape)} "
                             f"and {tuple(offsets.shape)}")
        if probed.dtype != torch.int64 or probed.stride(1) != 1:
            probed = probed.to(torch.int64).contiguous()
        offsets = _params(offsets, torch.int64)
        pstride = probed.stride(0)
    n_lists = probed.shape[1]
    est, bucket, early, hist, nmiss, counts = _scan_outputs(b, n, m, dev)
    if b == 0 or n == 0:
        counts.zero_()
        return (est, bucket, hist, early, nmiss), 0
    lib = _scan_lib()
    p = plan or _batch_scan_plan(b, n, m_sub, k_codes, d, n_ew, m,
                                 _sms(dev.index), n_lists, cap)
    args = (codes.data_ptr(), vectors.data_ptr(), valid.data_ptr(),
            luts.data_ptr(), qs.data_ptr(), d_min.data_ptr(),
            delta.data_ptr(), ew_maps.data_ptr(), tau_pred.data_ptr())
    outs = (est.data_ptr(), bucket.data_ptr(), early.data_ptr(),
            counts.data_ptr())
    if p.chunked:
        _launch_chunked(lib, p, args + outs, 0, n, m_sub, k_codes, d, b,
                        n_ew, m, codes)
        return (est, bucket, hist, early, nmiss), b * n
    words = next((w for w in (16, 8) if m_sub % w == 0
                  and codes.data_ptr() % w == 0), 0)
    rc = lib.fused_scan_batch_launch(
        *args, probed.data_ptr(), offsets.data_ptr(), *outs, n, m_sub,
        k_codes, d, b, n_ew, m, n_lists, pstride, words, p.blocks, p.smem,
        _stream())
    _check(rc, "fused_scan_batch")
    _count("fused_scan", b)
    return (est, bucket, hist, early, nmiss), counts[b * (m + 2):]


def _launch_chunked(lib, p: ScanPlan, args: tuple, tau_val: int, n: int,
                    m_sub: int, k_codes: int, d: int, b: int, n_ew: int,
                    m: int, codes: torch.Tensor) -> None:
    """One launch of ``fused_scan_chunked_kernel`` under ``p``, counted:
    ``args`` the 13 pointers of ``fused_scan_chunked_launch`` (the
    threshold's may be None, for ``tau_val``)."""
    vec = m_sub % 16 == 0 and p.mc % 16 == 0 and _aligned(codes)
    rc = lib.fused_scan_chunked_launch(*args, tau_val, n, m_sub, k_codes, d,
                                       b, n_ew, m, p.mc, p.blocks, vec,
                                       p.smem, _stream())
    _check(rc, "fused_scan_chunked")
    LAUNCHES["fused_scan_chunked_batch"] += 1


def _scan_outputs(b: int, n: int, m: int, dev):
    """(est, bucket, early) (B, n), the (B, m+1) histogram and (B,) nmiss,
    the last two views of one int32 buffer (returned last) that one memset
    zeroes; the buffer's last B ints are the batched kernel's per-query
    walked lanes."""
    est = torch.empty(b, n, dtype=torch.float32, device=dev)
    bucket = torch.empty(b, n, dtype=torch.int32, device=dev)
    early = torch.empty(b, n, dtype=torch.float32, device=dev)
    counts = torch.empty(b * (m + 3), dtype=torch.int32, device=dev)
    return (est, bucket, early, counts[:b * (m + 1)].view(b, m + 1),
            counts[b * (m + 1):b * (m + 2)], counts)


@functools.lru_cache(maxsize=None)
def _scan_lib() -> ctypes.CDLL:
    """The fused scan's library, checked once against ``FS_TILE``."""
    lib = _lib("fused_scan")
    if lib.fused_scan_batch_tile() != LANE_TILE:
        raise RuntimeError(f"fused_scan.cu's batched kernel takes "
                           f"{lib.fused_scan_batch_tile()} lanes a tile, "
                           f"ops.LANE_TILE says {LANE_TILE}")
    if lib.fused_scan_b1_tile() != FS_TILE:
        raise RuntimeError(f"fused_scan.cu takes {lib.fused_scan_b1_tile()} "
                           f"lanes a work item, ops.FS_TILE says {FS_TILE}")
    if lib.fused_scan_chunked_tile() != FS_CHUNK_LANES:
        raise RuntimeError(f"fused_scan.cu's chunked kernel takes "
                           f"{lib.fused_scan_chunked_tile()} lanes a tile, "
                           f"ops.FS_CHUNK_LANES says {FS_CHUNK_LANES}")
    shape = (240, 256, 960, 256, 128)
    if (lib.fused_scan_smem_bytes(3, *shape) != _scan_smem(3, *shape)
            or lib.fused_scan_b1_smem_bytes(*shape) != _b1_smem(*shape)
            or lib.fused_scan_batch_smem_bytes(*shape, 64)
            != _batch_smem(*shape, 64)):
        raise RuntimeError("fused_scan.cu's shared-memory layouts differ "
                           "from ops._scan_smem / ops._b1_smem / "
                           "ops._batch_smem")
    return lib


def _fused_scan_one(codes: torch.Tensor, vectors: torch.Tensor,
                    valid: torch.Tensor, lut: torch.Tensor, q: torch.Tensor,
                    d_min: torch.Tensor, delta: torch.Tensor,
                    ew_map: torch.Tensor, m: int, tau_pred):
    """The one-query kernel (``fused_scan_b1_kernel``) on CUDA tensors:
    (n,) validity, (M, K) LUT, (d,) query, one codebook and ``tau_pred``, a
    Python int or a one-element CUDA tensor (read by the kernel).  Where the
    LUT outgrows its block, the chunked-LUT kernel at one query, with the
    threshold passed the same way.  Returns (est (n,), bucket (n,), hist
    (m+1,), early (n,), nmiss ())."""
    n, m_sub = codes.shape
    d = vectors.shape[1]
    k_codes = lut.shape[1]
    _need(codes, "codes", torch.uint8, (n, m_sub))
    _need(vectors, "vectors", torch.float32, (n, d))
    _need(valid, "valid", torch.bool, (n,))
    _need(lut, "lut", torch.float32, (m_sub, k_codes))
    _need(q, "q", torch.float32, (d,))
    d_min = _params(d_min.reshape(1), torch.float32)
    delta = _params(delta.reshape(1), torch.float32)
    ew_map = _params(ew_map.reshape(-1), torch.int32)
    n_ew = ew_map.shape[0]
    tau_ptr, tau_val = None, 0
    if torch.is_tensor(tau_pred):
        if tau_pred.numel() != 1:
            raise ValueError(f"tau_pred: one query takes one threshold, got "
                             f"shape {tuple(tau_pred.shape)}")
        tau_ptr = _params(tau_pred.reshape(1), torch.int32)
    else:
        tau_val = int(tau_pred)
    dev = codes.device
    est, bucket, early, hist, nmiss, counts = _scan_outputs(1, n, m, dev)
    out = est[0], bucket[0], hist[0], early[0], nmiss[0]
    if n == 0:
        counts.zero_()
        return out
    lib = _scan_lib()
    smem = _b1_smem(m_sub, k_codes, d, n_ew, m)
    if smem > MAX_SMEM:             # the LUT past a block: staged in chunks
        p = _chunked_plan(1, n, m_sub, k_codes, d, n_ew, m,
                          sms=_sms(dev.index))
        _launch_chunked(lib, p, (
            codes.data_ptr(), vectors.data_ptr(), valid.data_ptr(),
            lut.data_ptr(), q.data_ptr(), d_min.data_ptr(), delta.data_ptr(),
            ew_map.data_ptr(), None if tau_ptr is None else tau_ptr.data_ptr(),
            est.data_ptr(), bucket.data_ptr(), early.data_ptr(),
            counts.data_ptr()), tau_val, n, m_sub, k_codes, d, 1, n_ew, m,
            codes)
        return out
    p = _scan_plan(n, smem, _sms(dev.index))
    word = FS_WORD_ROWS.get(m_sub)
    mc = m_sub if word and codes.data_ptr() % word == 0 else 0
    rc = lib.fused_scan_b1_launch(
        codes.data_ptr(), vectors.data_ptr(), valid.data_ptr(),
        lut.data_ptr(), q.data_ptr(), d_min.data_ptr(), delta.data_ptr(),
        ew_map.data_ptr(), None if tau_ptr is None else tau_ptr.data_ptr(),
        est.data_ptr(), bucket.data_ptr(), early.data_ptr(),
        counts.data_ptr(), tau_val, n, m_sub, k_codes, d, n_ew, m, p.chunks,
        p.grid, mc, smem, _stream())
    _check(rc, "fused_scan")
    LAUNCHES["fused_scan"] += 1
    return out


def fused_rabitq_scan_batch(codes: torch.Tensor, vectors: torch.Tensor,
                            s2: torch.Tensor, norm_o: torch.Tensor,
                            f_o: torch.Tensor, cl: torch.Tensor,
                            g: torch.Tensor, qs: torch.Tensor,
                            nq: torch.Tensor, valid: torch.Tensor,
                            d_min: torch.Tensor, delta: torch.Tensor,
                            ew_maps: torch.Tensor, m: int,
                            tau_inline: torch.Tensor, eps0: float = 3.0):
    """Batched bound-fused RaBitQ scan over a shared candidate stream.

    ``codes`` (n, d) int8 +-1, ``vectors`` (n, d), ``s2`` (n,) (the
    query-independent centroid correction, ``RabitqStream.s2``),
    ``norm_o``/``f_o`` (n,) and ``cl`` (n,) int32 (each lane's clamped
    owning cluster) are the stream every query shares; the rotated queries
    ``g`` (B, d) (``numerics.rotate(qs, rot)``), ``qs`` (B, d), the (B, C)
    query-centroid distances ``nq`` (``numerics.sqrt_rn(d2)``), ``valid``
    (B, n), the codebook parameters and ``tau_inline`` (B,) are per query.
    The JAX wrapper's signature with ``centroids`` replaced by the
    build-time ``s2``, and the rotation and the routing distances by ``g``
    and ``nq``, which the caller computes once for the codebook sample
    too.
    Returns ``(est, lb, ub, bucket_lb, bucket_ub, hist_lb, hist_ub, exact,
    certified, nmiss)``; see ``kernels.ref.fused_rabitq_scan_batch``."""
    if not _on_cuda(codes, vectors, s2, norm_o, f_o, cl, g, qs, nq, valid,
                    d_min, delta, ew_maps, tau_inline):
        outs = _ref.fused_rabitq_scan_batch(
            codes, vectors, s2, norm_o, f_o, cl, g, qs, nq, valid, d_min,
            delta, ew_maps, m, tau_inline, eps0=eps0)
        _count_pairs(valid.numel(), outs[5])
        return outs
    n, d = codes.shape
    b, c = nq.shape
    n_ew = ew_maps.shape[1]
    _need(codes, "codes", torch.int8, (n, d))
    _need(vectors, "vectors", torch.float32, (n, d))
    _need(norm_o, "norm_o", torch.float32, (n,))
    _need(f_o, "f_o", torch.float32, (n,))
    _need(cl, "cl", torch.int32, (n,))
    _need(qs, "qs", torch.float32, (b, d))
    _need(valid, "valid", torch.bool, (b, n))
    _need(s2, "s2", torch.float32, (n,))
    _need(g, "g", torch.float32, (b, d))
    _need(nq, "nq", torch.float32, (b, c))
    d_min = _params(d_min, torch.float32)
    delta = _params(delta, torch.float32)
    ew_maps = _params(ew_maps, torch.int32)
    tau_inline = _params(tau_inline, torch.int32)
    dev = codes.device
    est, lb, ub, exact = (torch.empty(b, n, dtype=torch.float32, device=dev)
                          for _ in range(4))
    bucket_lb, bucket_ub = (torch.empty(b, n, dtype=torch.int32, device=dev)
                            for _ in range(2))
    certified = torch.empty(b, n, dtype=torch.bool, device=dev)
    hist_lb, hist_ub = (torch.zeros(b, m + 1, dtype=torch.int32, device=dev)
                        for _ in range(2))
    nmiss = torch.zeros(b, dtype=torch.int32, device=dev)
    outs = (est, lb, ub, bucket_lb, bucket_ub, hist_lb, hist_ub, exact,
            certified, nmiss)
    _count_pairs(valid.numel(), hist_lb)
    if b == 0 or n == 0:
        return outs
    lib = _lib("rabitq_fused")
    bq, smem = _pick_bq(b, lambda q: lib.rabitq_fused_smem_bytes(q, d, n_ew,
                                                                 m))
    rc = lib.fused_rabitq_scan_batch_launch(
        codes.data_ptr(), vectors.data_ptr(), s2.data_ptr(),
        norm_o.data_ptr(), f_o.data_ptr(), cl.data_ptr(), valid.data_ptr(),
        nq.data_ptr(), g.data_ptr(), qs.data_ptr(), d_min.data_ptr(),
        delta.data_ptr(), ew_maps.data_ptr(), tau_inline.data_ptr(),
        est.data_ptr(), lb.data_ptr(), ub.data_ptr(), bucket_lb.data_ptr(),
        bucket_ub.data_ptr(), exact.data_ptr(), certified.data_ptr(),
        hist_lb.data_ptr(), hist_ub.data_ptr(), nmiss.data_ptr(), n, d, b, c,
        n_ew, m, math.sqrt(d), eps0, float(d - 1), bq, _tiles(n), smem,
        _stream())
    _check(rc, "fused_rabitq_scan_batch")
    LAUNCHES["fused_rabitq_scan_batch"] += 1
    return outs


class SampleUbPlan(NamedTuple):
    """One launch of the codebook sample's RaBitQ upper bounds."""
    threads: int         # lanes a block, one a thread
    grid_x: int          # blocks a query
    stride: int          # floats of one thread's shared row (odd)
    smem: int            # the rotated query and the rows, bytes


@functools.lru_cache(maxsize=4096)
def _sample_ub_plan(w: int, d: int) -> SampleUbPlan:
    """The sample bounds' launch over w lanes a query at width d: each
    thread keeps the ceil(d/2) sums of ``ordered_sum``'s first round in a
    shared row of odd stride (a warp's 32 rows then fall in 32 banks), the
    most threads (256 down to 32) whose rows fit ``SAMPLE_UB_SMEM``, 32
    beyond it.  Raises when 32 rows exceed a block's shared memory."""
    stride = (d + 1) // 2 | 1
    threads = 256
    while threads > 32 and 4 * (d + threads * stride) > SAMPLE_UB_SMEM:
        threads //= 2
    smem = 4 * (d + threads * stride)
    if smem > MAX_SMEM:
        raise ValueError(f"rabitq_sample_ub_batch: d={d} needs {smem} bytes "
                         f"of shared memory, more than the {MAX_SMEM} a "
                         f"block may use")
    return SampleUbPlan(threads, max(1, -(-w // threads)), stride, smem)


def rabitq_sample_ub_batch(codes: torch.Tensor, s2: torch.Tensor,
                           norm_o: torch.Tensor, f_o: torch.Tensor,
                           cl: torch.Tensor, offsets: torch.Tensor,
                           clusters: torch.Tensor, cap: int,
                           g: torch.Tensor, nq: torch.Tensor,
                           eps0: float = 3.0):
    """The codebook sample's RaBitQ upper bounds over each query's sampled
    clusters: the stream's ``codes`` (n, d) int8 +-1, ``s2``, ``norm_o``,
    ``f_o`` (n,), ``cl`` (n,) int32 and cluster starts ``offsets`` (C + 1,)
    int64; ``clusters`` (B, t) int64 (a column slice of the probe list will
    do), ``cap`` lanes a cluster, the rotated queries ``g`` (B, d) and the
    query-centroid distances ``nq`` (B, C).  Returns ``(ub (B, t*cap), ok
    (B, t*cap))``, ub +inf off ``ok``; see
    ``kernels.ref.rabitq_sample_ub_batch``.  One launch at any d."""
    if not _on_cuda(codes, s2, norm_o, f_o, cl, offsets, clusters, g, nq):
        return _ref.rabitq_sample_ub_batch(codes, s2, norm_o, f_o, cl,
                                           offsets, clusters, cap, g, nq,
                                           eps0=eps0)
    n, d = codes.shape
    b, t = clusters.shape
    c = nq.shape[1]
    w = t * cap
    _need(codes, "codes", torch.int8, (n, d))
    for name, x in (("s2", s2), ("norm_o", norm_o), ("f_o", f_o)):
        _need(x, name, torch.float32, (n,))
    _need(cl, "cl", torch.int32, (n,))
    _need(offsets, "offsets", torch.int64, (c + 1,))
    _need(g, "g", torch.float32, (b, d))
    _need(nq, "nq", torch.float32, (b, c))
    if clusters.dtype != torch.int64 or (t > 1 and clusters.stride(1) != 1):
        raise ValueError(f"clusters: the CUDA kernel takes int64 rows of "
                         f"unit stride, got {clusters.dtype} strides "
                         f"{clusters.stride()}")
    if b > 65535 or w >= 2 ** 31:
        raise ValueError(f"rabitq_sample_ub_batch: {b} queries of {w} lanes, "
                         f"past the kernel's grid (65535 queries, 2^31 lanes)")
    ub = torch.empty(b, w, dtype=torch.float32, device=codes.device)
    ok = torch.empty(b, w, dtype=torch.bool, device=codes.device)
    if b == 0 or w == 0:
        return ub, ok
    p = _sample_ub_plan(w, d)
    vec = d % 32 == 0 and _aligned(codes)     # 16-byte code words
    rc = _lib("rabitq_fused").rabitq_sample_ub_launch(
        codes.data_ptr(), s2.data_ptr(), norm_o.data_ptr(), f_o.data_ptr(),
        cl.data_ptr(), offsets.data_ptr(), clusters.data_ptr(),
        clusters.stride(0), g.data_ptr(), nq.data_ptr(), ub.data_ptr(),
        ok.data_ptr(), d, b, c, t, cap, vec, p.threads, p.grid_x, p.stride,
        p.smem, math.sqrt(d), eps0, float(d - 1), _stream())
    _check(rc, "rabitq_sample_ub_batch")
    LAUNCHES["rabitq_sample_ub_batch"] += 1
    return ub, ok


class PlanLaunch(NamedTuple):
    """One launch of the sample-plan kernel (``sample_plan.cu``)."""
    sort: bool           # the row sorted in shared memory, else read sorted
    padded: int          # keys a block sorts (w's power of two; 0 unsorted)
    threads: int         # threads a block, one block a query
    smem: int            # dynamic shared memory, bytes


def _plan_smem(padded: int, m: int, n_ew: int) -> int:
    """The kernel's shared memory: the keys, the m + 1 edges, the n_ew map
    and 33 floats of the block's reduction."""
    return 4 * (padded + m + 1 + n_ew + 33)


@functools.lru_cache(maxsize=4096)
def _sample_plan_launch(w: int, m: int, n_ew: int,
                        presorted: bool = False) -> PlanLaunch:
    """The sample plan's launch for rows of ``w`` values.  Where the row's
    power of two of keys fits a block's shared memory beside the edges and
    the map (w <= 32,768 at m = 128), the block sorts it there:
    ``PLAN_LANE_KEYS`` keys a thread from 512 to 16,384 keys (the warps'
    register stages), else a pair of keys a thread.  A longer row, or a
    ``presorted`` one, is read sorted in place (the wrapper narrows a long
    row with ``torch.topk`` first: the long-row mode).  Raises where not
    even the edges and the map fit."""
    if not presorted:
        padded = 1 << max(0, (w - 1).bit_length())
        smem = _plan_smem(padded, m, n_ew)
        if smem <= MAX_SMEM:
            lanes = padded // PLAN_LANE_KEYS
            threads = (lanes if 32 <= lanes <= PLAN_THREADS
                       else max(32, min(PLAN_THREADS, padded // 2)))
            return PlanLaunch(True, padded, threads, smem)
    smem = _plan_smem(0, m, n_ew)
    if smem > MAX_SMEM:
        raise ValueError(f"sample_plan: m={m} edges and an n_ew={n_ew} map "
                         f"need {smem} bytes of shared memory, more than the "
                         f"{MAX_SMEM} a block may use")
    return PlanLaunch(False, 0, PLAN_SORTED_THREADS, smem)


def sample_plan_batch(vals: torch.Tensor, ok: torch.Tensor | None = None, *,
                      k_cb: int, m: int, n_ew: int = 256,
                      rank: int | None = None, sqrt: bool = False,
                      margin: int = 0, cap: int | None = None,
                      presorted: bool = False):
    """A query batch's codebook sample plan from (B, w) fp32 sample values
    and an optional (B, w) lane mask ``ok``: the equal-depth codebooks over
    each row's ``k_cb`` smallest (at most w) and, with a ``rank`` (1 to w),
    the Eq. 6 bucket of each row's rank-th smallest, plus ``margin`` and
    at most ``cap`` (default m).  ``sqrt`` takes squared PQ estimates:
    lanes are ``ok ? sqrt(clamp(vals, min=0)) : +inf`` as loaded.
    ``presorted`` rows are already ascending (a caller's top-k, its width
    ``k_cb``).  Returns ((edges (B, m+1), d_min (B,), delta (B,), ew_map
    (B, n_ew) int32), tau (B,) int32 or None); see
    ``kernels.ref.sample_plan_batch``.  One launch on the card; a long row
    (``_sample_plan_launch``) takes ``torch.topk`` first."""
    b, w = vals.shape
    k_cb = min(k_cb, w)
    if k_cb < 1 or (rank is not None and not 1 <= rank <= w) \
            or (presorted and (k_cb != w or ok is not None or sqrt)):
        raise ValueError(f"sample_plan_batch: k_cb={k_cb}, rank={rank} over "
                         f"rows of {w} (presorted={presorted}, a mask: "
                         f"{ok is not None}, sqrt={sqrt})")
    if not _on_cuda(vals, *(() if ok is None else (ok,))):
        return _ref.sample_plan_batch(vals, ok, k_cb, m, n_ew, rank, sqrt,
                                      margin, cap, presorted)
    p = _sample_plan_launch(w, m, n_ew, presorted)
    if not p.sort and not presorted:
        # the long-row mode: the row's smallest, sorted, then the plan
        vals = torch.topk(_ref.sample_values(vals, ok, sqrt),
                          max(k_cb, rank or 0), dim=1, largest=False,
                          sorted=True).values
        ok, sqrt, w = None, False, vals.shape[1]
    if vals.dtype != torch.float32 or (w > 1 and vals.stride(1) != 1):
        raise ValueError(f"vals: the CUDA kernel takes fp32 rows of unit "
                         f"stride, got {vals.dtype} strides {vals.stride()}")
    if ok is not None:
        _need(ok, "ok", torch.bool, (b, w))
    dev = vals.device
    edges = torch.empty(b, m + 1, dtype=torch.float32, device=dev)
    d_min = torch.empty(b, dtype=torch.float32, device=dev)
    delta = torch.empty(b, dtype=torch.float32, device=dev)
    ew_map = torch.empty(b, n_ew, dtype=torch.int32, device=dev)
    tau = None if rank is None else torch.empty(b, dtype=torch.int32,
                                                device=dev)
    if b == 0:
        return (edges, d_min, delta, ew_map), tau
    rc = _lib("sample_plan").sample_plan_launch(
        vals.data_ptr(), None if ok is None else ok.data_ptr(),
        vals.stride(0) if b > 1 else w, w, k_cb, p.sort, sqrt, b, m, n_ew,
        rank or 0, margin, m if cap is None else cap, 1e-6, 1.02, 1e-7,
        edges.data_ptr(), d_min.data_ptr(), delta.data_ptr(),
        ew_map.data_ptr(), None if tau is None else tau.data_ptr(), p.padded,
        p.threads, p.smem, _stream())
    _check(rc, "sample_plan_batch")
    LAUNCHES["sample_plan_batch" if p.sort else "sample_plan_sorted_batch"] \
        += 1
    return (edges, d_min, delta, ew_map), tau


class CollectPlan(NamedTuple):
    """One launch of the shard collector or the compaction
    (``shard_collect.cu``) and its scratch, zeroed by one memset."""
    n_chunks: int        # chunks of COLLECT_CHUNK lanes per query
    pieces: int          # fill pieces of COLLECT_FILL slots per query
    grid: int            # blocks, one per ticket: B * (n_chunks + pieces)
    ticket: int          # int32 offset of the ticket counter
    hist: int            # int32 offset of the (B, m+1) histogram (fused)
    words: int           # int32 words of scratch


@functools.lru_cache(maxsize=4096)
def _collect_plan(b: int, n: int, budget: int,
                  hist_bins: int = 0) -> CollectPlan:
    """The launch for B queries over n lanes into a (B, budget) buffer:
    one ticket per chunk of ``COLLECT_CHUNK`` lanes of each query, then one
    per ``COLLECT_FILL`` slots of each query's buffer (the sentinel fill),
    a block each (a 1-D grid); and a scratch of int32 words that holds,
    from offset 0, one 64-bit status word per chunk, the ticket counter and
    (``hist_bins`` = m + 1 for the fused form) the (B, m+1) histogram on a
    16-byte boundary."""
    n_chunks = max(1, -(-n // COLLECT_CHUNK))
    pieces = -(-budget // COLLECT_FILL)
    grid = b * (n_chunks + pieces)
    if grid >= 2 ** 31:
        raise ValueError(f"shard collector: {grid} tickets (B={b}, n={n}, "
                         f"budget={budget}) overflow the int32 ticket")
    ticket = 2 * b * n_chunks
    hist = -(-(ticket + 1) // 4) * 4
    return CollectPlan(n_chunks, pieces, grid, ticket, hist,
                       hist + b * hist_bins)


def _collect_outputs(b: int, n: int, budget: int, dev):
    """(pos, ok, count) as the kernel writes them in full, or filled here
    when there is nothing to launch."""
    if b == 0 or n == 0:
        pos = torch.full((b, budget), n, dtype=torch.int32, device=dev)
        return pos, pos < n, torch.zeros(b, dtype=torch.int32, device=dev)
    return (torch.empty(b, budget, dtype=torch.int32, device=dev),
            torch.empty(b, budget, dtype=torch.bool, device=dev),
            torch.empty(b, dtype=torch.int32, device=dev))


@functools.lru_cache(maxsize=None)
def _collect_lib() -> ctypes.CDLL:
    """The collector's library, checked once against ``COLLECT_CHUNK``."""
    lib = _lib("shard_collect")
    if lib.shard_collect_chunk() != COLLECT_CHUNK:
        raise RuntimeError(f"shard_collect.cu takes {lib.shard_collect_chunk()}"
                           f" lanes a block, ops.COLLECT_CHUNK says "
                           f"{COLLECT_CHUNK}")
    return lib


def shard_collect_batch(dists: torch.Tensor, valid: torch.Tensor,
                        d_min: torch.Tensor, delta: torch.Tensor,
                        ew_maps: torch.Tensor, m: int, tau_spec: torch.Tensor,
                        budget: int):
    """Fused shard collect: (B, n) distances -> (bucket (B, n), hist
    (B, m+1), spec_pos (B, budget), spec_ok (B, budget), spec_count (B,)).

    One stream pass bucketizes and histograms the valid lanes and ranks
    the lanes at or below the provisional ``tau_spec`` (B,) in stream
    order; the positions of the first ``budget`` of them fill ``spec_pos``
    (sentinel n past the fill).  ``spec_count`` is the true total, above
    ``budget`` on overflow (``tau_spec = -1`` compacts nothing).  Feed the
    buffer to ``distributed.bbc_survivors_batch``.  On the card: one memset
    of the scratch (``_collect_plan``) and one kernel launch."""
    if not _on_cuda(dists, valid, d_min, delta, ew_maps, tau_spec):
        return _ref.shard_collect_batch(dists, valid, d_min, delta, ew_maps,
                                        m, tau_spec, budget)
    b, n = dists.shape
    n_ew = ew_maps.shape[1]
    _need(dists, "dists", torch.float32, (b, n))
    _need(valid, "valid", torch.bool, (b, n))
    d_min = _params(d_min, torch.float32)
    delta = _params(delta, torch.float32)
    ew_maps = _params(ew_maps, torch.int32)
    tau_spec = _params(tau_spec, torch.int32)
    dev = dists.device
    bucket = torch.empty(b, n, dtype=torch.int32, device=dev)
    pos, ok, count = _collect_outputs(b, n, budget, dev)
    if b == 0 or n == 0:
        hist = torch.zeros(b, m + 1, dtype=torch.int32, device=dev)
        return bucket, hist, pos, ok, count
    lib = _collect_lib()
    smem = lib.shard_collect_smem_bytes(n_ew, m)
    if smem > MAX_SMEM:
        raise ValueError(f"shard_collect_batch: n_ew={n_ew}, m={m} need "
                         f"{smem} bytes of shared memory")
    p = _collect_plan(b, n, budget, m + 1)
    scratch = torch.zeros(p.words, dtype=torch.int32, device=dev)
    hist = scratch[p.hist:].view(b, m + 1)
    vec = n % 16 == 0 and _aligned(dists, valid, bucket)
    rc = lib.shard_collect_batch_launch(
        dists.data_ptr(), valid.data_ptr(), d_min.data_ptr(),
        delta.data_ptr(), ew_maps.data_ptr(), tau_spec.data_ptr(),
        bucket.data_ptr(), hist.data_ptr(), pos.data_ptr(), ok.data_ptr(),
        count.data_ptr(), scratch.data_ptr(), scratch[p.ticket:].data_ptr(),
        n, b, n_ew, m, budget, p.n_chunks, COLLECT_FILL, p.grid, vec, smem,
        _stream())
    _check(rc, "shard_collect_batch")
    LAUNCHES["shard_collect_batch"] += 1
    return bucket, hist, pos, ok, count


def spec_compact_batch(bucket: torch.Tensor, valid: torch.Tensor,
                       tau_spec: torch.Tensor, budget: int):
    """Compaction-only form of ``shard_collect_batch`` over (B, n) int32
    bucket ids that already exist (the bound-fused RaBitQ scan emits
    bucket_lb itself).  Returns (spec_pos, spec_ok, spec_count)."""
    if not _on_cuda(bucket, valid, tau_spec):
        return _ref.spec_compact_batch(bucket, valid, tau_spec, budget)
    b, n = bucket.shape
    _need(bucket, "bucket", torch.int32, (b, n))
    _need(valid, "valid", torch.bool, (b, n))
    tau_spec = _params(tau_spec, torch.int32)
    dev = bucket.device
    pos, ok, count = _collect_outputs(b, n, budget, dev)
    if b == 0 or n == 0:
        return pos, ok, count
    lib = _collect_lib()
    p = _collect_plan(b, n, budget)
    scratch = torch.zeros(p.words, dtype=torch.int32, device=dev)
    vec = n % 16 == 0 and _aligned(bucket, valid)
    rc = lib.spec_compact_batch_launch(
        bucket.data_ptr(), valid.data_ptr(), tau_spec.data_ptr(),
        pos.data_ptr(), ok.data_ptr(), count.data_ptr(), scratch.data_ptr(),
        scratch[p.ticket:].data_ptr(), n, b, budget, p.n_chunks,
        COLLECT_FILL, p.grid, vec, _stream())
    _check(rc, "spec_compact_batch")
    LAUNCHES["spec_compact_batch"] += 1
    return pos, ok, count


class MaskPlan(NamedTuple):
    """One launch of the lane-mask kernel (``lane_mask.cu``)."""
    groups: int          # groups of MASK_GROUP queries: the grid's 2nd axis
    grid_x: int          # blocks a group
    smem: int            # a group's bitset, bytes; 0: in device memory


@functools.lru_cache(maxsize=4096)
def _mask_plan(b: int, n: int, n_clusters: int, vec: bool,
               sms: int = SMS) -> MaskPlan:
    """The lane mask's launch: a group's (C + 1)-word bitset in shared
    memory where it fits a block, else in device memory; a persistent grid
    of at most ``MASK_BLOCKS_PER_SM`` blocks an SM (fewer where the bitset
    limits them) shared among the groups, and no more blocks than give each
    thread one step of ``MASK_LANES`` lanes (one lane unvectorised)."""
    groups = -(-b // MASK_GROUP)
    if groups > 65535:
        raise ValueError(f"probe_mask_batch: {b} queries, more than the "
                         f"65535 groups of a grid's second axis")
    smem = 4 * (n_clusters + 1)
    if smem > MAX_SMEM:
        smem, per_sm = 0, MASK_BLOCKS_PER_SM
    else:
        per_sm = max(1, min(MASK_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    steps = n // MASK_LANES if vec else n
    grid_x = max(1, min(-(-steps // LANE_TILE), -(-sms * per_sm // groups)))
    return MaskPlan(groups, grid_x, smem)


def probe_mask_batch(cluster_of: torch.Tensor, probed: torch.Tensor,
                     n_clusters: int,
                     live: torch.Tensor | None = None) -> torch.Tensor:
    """(B, n) bool lane mask over a layout's (n,) int64 ``cluster_of`` (a
    padding lane's cluster is ``n_clusters``): lane j is set for query b
    iff ``probed[b]`` ((B, n_probe) int64, rows of unit stride) holds its
    cluster, and ``live[j]`` where the (n,) bool tombstone mask is given.
    See ``kernels.ref.probe_mask_batch``.  One launch on the card
    (``_mask_plan``)."""
    n = cluster_of.shape[0]
    if live is not None and (live.shape != cluster_of.shape
                             or live.dtype != torch.bool):
        raise ValueError(f"live mask {tuple(live.shape)} {live.dtype} for "
                         f"{n} lanes")
    extra = () if live is None else (live,)
    if not _on_cuda(cluster_of, probed, *extra):
        return _ref.probe_mask_batch(cluster_of, probed, n_clusters, live)
    b, p = probed.shape
    _need(cluster_of, "cluster_of", torch.int64, (n,))
    if live is not None:
        _need(live, "live", torch.bool, (n,))
    if probed.dtype != torch.int64 or (p > 1 and probed.stride(1) != 1):
        raise ValueError(f"probed: the CUDA kernel takes int64 rows of unit "
                         f"stride, got {probed.dtype} strides "
                         f"{probed.stride()}")
    dev = cluster_of.device
    out = torch.empty(b, n, dtype=torch.bool, device=dev)
    if b == 0 or n == 0:
        return out
    vec = n % MASK_LANES == 0 and _aligned(cluster_of, out, *extra)
    pl = _mask_plan(b, n, n_clusters, vec, _sms(dev.index))
    scratch = None if pl.smem else torch.empty(
        pl.groups * (n_clusters + 1), dtype=torch.int32, device=dev)
    rc = _lib("lane_mask").probe_mask_launch(
        cluster_of.data_ptr(), probed.data_ptr(),
        probed.stride(0) if b > 1 else p,
        None if live is None else live.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n, b, p, n_clusters,
        vec, pl.grid_x, pl.smem, _stream())
    _check(rc, "probe_mask_batch")
    LAUNCHES["probe_mask_batch"] += 1
    return out


# --------------------------------------------------------------------------
# Single-query wrappers (the JAX package's ``ops.pq_adc`` & co.)
# --------------------------------------------------------------------------

def pq_adc(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """(n, M) uint8 codes, (M, K) LUT -> (n,) squared ADC estimates."""
    return pq_adc_batch(codes, lut[None])[0]


def l2_exact(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(n, d) vectors, (d,) query -> (n,) exact distances."""
    return l2_exact_batch(x, q[None])[0]


def bucket_hist(dists: torch.Tensor, valid: torch.Tensor,
                d_min: torch.Tensor, delta: torch.Tensor,
                ew_map: torch.Tensor, m: int):
    """(n,) distances and one codebook (``d_min``/``delta`` scalars or
    (1,), ``ew_map`` (n_ew,) or (1, n_ew)) -> (bucket (n,) int32, hist
    (m+1,) int32 over the valid lanes)."""
    bucket, hist = bucket_hist_batch(dists[None], valid[None],
                                     d_min.reshape(1), delta.reshape(1),
                                     ew_map.reshape(1, -1), m)
    return bucket[0], hist[0]


def fused_scan(codes: torch.Tensor, vectors: torch.Tensor,
               valid: torch.Tensor, lut: torch.Tensor, q: torch.Tensor,
               d_min: torch.Tensor, delta: torch.Tensor, ew_map: torch.Tensor,
               m: int, tau_pred):
    """One query's fused estimate + bucketize + histogram + early exact:
    (est (n,), bucket (n,), hist (m+1,), early (n,), nmiss ()).
    ``tau_pred`` is a Python int or a one-element tensor; on the card an
    int goes to the kernel as a value, with no copy to the device."""
    tensors = [codes, vectors, valid, lut, q, d_min, delta, ew_map]
    if torch.is_tensor(tau_pred):
        tensors.append(tau_pred)
    if not _on_cuda(*tensors):
        return _ref.fused_scan(codes, vectors, valid, lut, q, d_min, delta,
                               ew_map, m, tau_pred)
    return _fused_scan_one(codes, vectors, valid, lut, q, d_min, delta,
                           ew_map, m, tau_pred)


def _est_lanes(d: int, smem_bytes) -> tuple[int, int]:
    """Lanes a block of the RaBitQ estimator holds (``EST_LANES``, or fewer
    where their d-byte code rows do not fit shared memory) and its shared
    memory.  Raises when 32 rows do not fit."""
    lanes = EST_LANES
    while lanes > 32 and smem_bytes(d, lanes) > MAX_SMEM:
        lanes //= 2
    smem = smem_bytes(d, lanes)
    if smem > MAX_SMEM:
        raise ValueError(f"rabitq_est: d={d} needs {smem} bytes of shared "
                         f"memory for {lanes} code rows")
    return lanes, smem


def rabitq_est_tiles(codes: torch.Tensor, norm_o: torch.Tensor,
                     f_o: torch.Tensor, v: torch.Tensor,
                     norm_q: torch.Tensor, valid: torch.Tensor,
                     eps0: float = 3.0):
    """RaBitQ est/lb/ub of one query over T probed tiles in one launch:
    codes (T, cap, d) int8 +-1, norm_o/f_o/valid (T, cap), v (T, d) the
    tiles' rotated unit query residuals, norm_q (T,).  Returns three
    (T, cap) fp32 tensors, +inf off ``valid``."""
    if not _on_cuda(codes, norm_o, f_o, v, norm_q, valid):
        return _ref.rabitq_est_tiles(codes, norm_o, f_o, v, norm_q, valid,
                                     eps0)
    t, cap, d = codes.shape
    _need(codes, "codes", torch.int8, (t, cap, d))
    _need(norm_o, "norm_o", torch.float32, (t, cap))
    _need(f_o, "f_o", torch.float32, (t, cap))
    _need(v, "v", torch.float32, (t, d))
    _need(norm_q, "norm_q", torch.float32, (t,))
    _need(valid, "valid", torch.bool, (t, cap))
    est, lb, ub = (torch.empty(t, cap, dtype=torch.float32,
                               device=codes.device) for _ in range(3))
    if t == 0 or cap == 0:
        return est, lb, ub
    lib = _lib("rabitq_est")
    lanes, smem = _est_lanes(d, lib.rabitq_est_smem_bytes)
    if -(-cap // lanes) > 65535:
        raise ValueError(f"rabitq_est: {cap} lanes a tile, more than a "
                         f"grid's 65535 chunks of {lanes}")
    rc = lib.rabitq_est_launch(
        codes.data_ptr(), norm_o.data_ptr(), f_o.data_ptr(), v.data_ptr(),
        norm_q.data_ptr(), valid.data_ptr(), est.data_ptr(), lb.data_ptr(),
        ub.data_ptr(), t, cap, d, math.sqrt(d), eps0, float(d - 1), lanes,
        smem, _stream())
    _check(rc, "rabitq_est")
    LAUNCHES["rabitq_est"] += 1
    return est, lb, ub


def rabitq_est(codes: torch.Tensor, norm_o: torch.Tensor, f_o: torch.Tensor,
               v: torch.Tensor, norm_q, eps0: float = 3.0):
    """(n, d) int8 +-1 codes, (n,) factors, (d,) rotated unit query
    residual, scalar ``norm_q`` -> (est, lb, ub), each (n,): the tile form
    at T = 1 with every lane valid."""
    dev = codes.device
    nq = torch.as_tensor(norm_q, dtype=torch.float32, device=dev).reshape(1)
    valid = torch.ones(1, codes.shape[0], dtype=torch.bool, device=dev)
    out = rabitq_est_tiles(codes[None], norm_o[None], f_o[None], v[None], nq,
                           valid, eps0)
    return tuple(t[0] for t in out)
