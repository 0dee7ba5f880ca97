#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py                 # phases 1-7, 9 and 11-22
    python3 chip_smoke.py --phases 1,2,3  # build and check the kernels only

Phases (run in the order 1, 2, 3, 4, 9, 5, 6, 12, 11, 13, 14, 15, 16, 17,
18, 19, 20, 21, 22, 7, 8, 10):
  1. the card's name and power limit; TF32 must be off;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, all at once);
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes and at the JAX package's ragged kernel-test shapes (the
     RaBitQ scan: est/lb/ub bitwise, every integer output equal; the shard
     collector and the compaction: every output bitwise, at cold, full and
     mixed thresholds, an overflowing budget, the edge budgets (1, a
     query's total, one short of it, a chunk boundary), ten repeated calls
     and one query longer than the card's resident blocks hold; the
     RaBitQ estimator
     bitwise at the JAX kernel test's shapes and in its tile form; the
     single-query forms at B=1 at the JAX single-kernel tests' shapes; the
     exact-distance and ADC kernels bitwise, also across their query
     tiles, ragged row tiles and coordinate chunks, on unaligned views;
     the bucketize-histogram on +inf and NaN lanes and degenerate
     codebooks, aligned and unaligned, over repeated calls; the RaBitQ
     estimator with tiles all padding; the fused scan, batched and in its
     one-query kernel, on +inf and NaN estimates and rows, degenerate
     codebooks, thresholds -1 and m, ragged and unaligned shapes, no valid
     lane and every lane predicted, over repeated calls, every output
     bitwise; ``numerics.sqrt_rn`` on the card bitwise against its CPU
     form on 23M values; the exact-distance kernel at the delta-segment
     scan's shapes (B=32 over 4096 rows and ragged capacities, d=128) and
     the whole segment scan against the CPU's; the fused scan, the
     bucketize-histogram, the shard collector, the compaction and the
     RaBitQ scan on lane masks with 5% of the lanes tombstoned inside the
     probed clusters, at the main path's width);
  4. the main path at full size: a SIFT1M-width synthetic corpus (1,000,000
     x 128 fp32), index built on the card (its k-means and PQ training run
     twice more, and must give the same bits), 64 queries through the fused
     IVF+PQ+BBC engine at k=5000, then 4 predictive batches; recall@k;
     one sample-plan launch a call and no plain plan, and none of the
     composition's topk, kthvalue, searchsorted or sort left inside the
     ``pq.sample`` span of a profiled call (``[plan]`` line); one lane-mask
     launch a call and no plain mask, and none of the mask composition's
     index, bitwise_and or scatter_ left inside ``pq.route`` (``[route]``);
  9. the IVF+RaBitQ path at the same size (1024 clusters, n_probe=64,
     k=5000, B=32, m=128, eps0=3.0): 64 queries through the bound-fused
     engine, 4 predictive batches, the two-phase form and the threshold
     baseline; recall@k, which must reach 0.95 on the BBC forms; the
     sample-plan check of phase 4 in the fused form's ``rabitq.sample``, the
     lane-mask check in its ``rabitq.route``;
  5. CPU<->GPU parity of the engines (IVF+PQ, IVF+RaBitQ and IVF, every
     form, batched and sharded: the CPU engine on a one-rank gloo mesh, the
     card's on a one-rank NCCL mesh; each form also on single (d,)
     queries) on a 20,000 x 128 index: id sets, distances, counters, and
     the plain versions' float outputs bitwise between the CPU and the
     card;
  6. the unfused, unfused predictive and plain IVF+PQ forms and the IVF
     forms at the JAX serving CLI's defaults (100,000 x 96, k=5000, 316
     clusters); then the fused IVF+PQ+BBC engine on a GIST-width index at
     8-bit codes (3,000 x 960, 16 clusters, PQ 240 x 8 bits: a query's LUT
     past a block's shared memory), built on the card: a batch of 8 and
     three predictive singletons through ``SearchEngine.search``, id sets,
     distances and counters equal to the CPU engine's on the same index,
     every scan the chunked-LUT kernel's;
  7. each kernel's time at its path's full-width shapes beside its bound,
     its plain version's and (where one exists) one PyTorch call's (the
     single-query kernels at phase 12's shapes, and they, the batched
     bucketize-histogram, the shard collector and compaction also the
     kernel alone; the one-query fused scan beside the batched kernel at
     one query, its design before, and with no predicted row and no valid
     lane; the exact-distance kernel at one delta segment's scan, B=32 x
     4096 rows, beside its bound and issue ceiling; the codebook sample's
     ADC at phase 4's sample, first held bitwise to its plain version on
     the same card tensors; the second pass's gather at phase 4's second
     pass and at the GIST1M-width cell's shapes, B=32 x 40,000 slots, 88%
     set, d=960, held bitwise the same way; the fused scan's chunked-LUT
     kernel at the GIST1M-width 8-bit cell's shapes, B=32 x 1M lanes, M =
     240 one-byte codes, d=960, held bitwise the same way; the batched
     fused scan at the deep-10M cell's shapes, B=32 x 10M lanes, M = 24
     codes, d=96, 64 of 4,096 clusters probed, the kernel alone beside the
     dense bound and the probed one, held bitwise the same way; the lane
     mask at the deep-10M cell's routing, B=32 x 10M lanes, C = 4,096, 64
     probed, and at the 1M cells', C = 1,024, bitwise ``ivf.probe_mask``
     and beside that composition's time); for #2
     and #3 also the ceiling their numerics leave (shared memory,
     instruction issue) and the one-thread-per-row kernels' times they
     replaced;
 12. the single-query path on the indexes of phases 4, 9 and 6: IVF+PQ+BBC,
     IVF+PQ, IVF+PQ+BBC predictive (singleton batches from cold),
     IVF+RaBitQ+BBC, the IVF+RaBitQ threshold baseline, IVF BBC and IVF
     top-k, 16 queries each (4 predictive) through ``eng.search(q)``: ms
     per query, recall@k, id-set overlap with the batched engine, counters
     and launches;
 11. the mesh-sharded deployment on a one-rank NCCL group (a ``file://``
     store, no network), on the indexes of phases 4, 9 and 6: IVF+PQ+BBC
     static, predictive and naive, IVF+RaBitQ+BBC fused static, fused
     predictive and naive, IVF static, predictive and naive; ms per batch,
     recall@k, the id-set overlap with the batched engine on the same
     index, the survivor tier of each batch and the counters;
 13. ``serve --mode async`` at the JAX serving CLI's defaults (100,000 x
     96, 316 clusters, IVF+PQ+BBC, k=5000, 64 Poisson requests at 200/s,
     deadline 500 ms, batches of 16) with ``--check-parity``: p50/p99
     latency, shed, degraded and deadline-met shares, batches, recall and
     parity, which must be 1.0 over more than 0 requests; then the same run
     sharded (``serve_rank`` on a one-rank NCCL mesh over a ``file://``
     store: rank 0's event loop drives the sharded engines through the
     lock-step protocol), held to the same bars;
 14. streaming ingest on phase 4's corpus: a ``MutableIndex`` (IVF+PQ+BBC,
     1024 clusters, k=5000, n_probe=64, B=32), 50,000 inserted rows of the
     corpus's mixture (13 segments of 4096), 50,000 deleted ids (40,000
     base rows, 10,000 segment rows: churn 0.10, the merge trigger), 64
     queries with and without the segments, a merge crashed after its
     checkpoint, the checkpoint verified, the merge resumed, the queries
     again: recall@5000 against exact search over the live corpus (>= 0.95
     before, while sealed and after), deleted ids surfaced (0), seconds of
     the build, checkpoint write and verify and the rebuild; the same
     schedule merged without a crash must return the same bits;
 15. the replica tier: ``serve --mode async --replicas 4`` at the JAX
     serving CLI's defaults with ``--check-parity`` and the fault schedule
     ``crash@1:t=0.1;corrupt@2:t=0.05,dur=0.2;slow@3:t=0.0,dur=1.0,
     factor=4`` (conserved, parity 1.0 over more than 0 requests, a
     respawn), then the same with ``--max-wait-ms 40`` (its batches start
     inside the corrupt window: a corrupt response detected and retried);
     twice through the library with a fixed service model on the
     serve-default index, tau predictor on, predictor checkpoints in a
     temporary directory (equal outcome digests, the respawned replica's
     predictors equal to its latest verified checkpoint); and on phase 5's
     index on the card and on the CPU (equal digests);
 16. constrained tuning: ``autotune.tune_cell`` on phase 4's index (k=5000)
     with 32 held-out queries, exact ground truth on the card, targets
     0.95/0.9/0.8, the reference's grid, rounds=2, n_starts=2: each
     sample's knobs, recall, cost units and ms, each point's feasibility
     (a feasible point meets its target), a ``timed=False`` re-sweep equal
     byte for byte, the store saved to a temporary file and reloaded
     resolving the 0.95 point through ``SearchEngine.build(tuned=)``, and
     the tuned and hand-default engines' ms per batch on phase 4's queries;
 17. the socket transport with 4 worker processes on the card, at the JAX
     serving CLI's net defaults (the serve-default corpus, k=5000, 200 Zipf
     requests at 200/s, deadline 500 ms): (a) ``python -m
     repro_torch.launch.serve --mode net --record <tmp> --check-replay``
     (replay identical, 200 requests conserved; p50/p99, client p99, the
     workers' READY service times, the codec, net_stats); through
     ``MasterServer`` on the same spec and trace, (b) under the reference
     bench's wire schedule with worker 0 SIGKILLed at 40% of the trace
     (conserved, a respawn and its seconds, parity 1.0 over the
     non-degraded completions against an in-process twin on the card), (c)
     (b)'s transcript replayed in process on the card (equal digest, 0
     checksum mismatches), (d) clean runs with the result cache off and on
     (shared completions id-identical, hits above 0); the faulted and
     fault-free client p99 and their ratio, not gated;
 18. the replica tier over the sharded deployment, on a one-rank NCCL mesh:
     (a) ``serve --mode async --replicas 4`` with phase 15's fault schedule
     through ``serve_rank`` (``--shards 1``): parity 1.0, conserved, a
     respawn; (b) phase 15(c)'s library run over a ``LockstepState`` and
     without a mesh (tau predictor on, predictor checkpoints): equal
     outcome digests, every request ending once, the respawn restoring a
     checkpoint; (c) a rolling swap of the sharded pool onto the index with
     5% of its rows tombstoned, then the trace again: parity 1.0, no
     deleted id served;
 19. the model substrate: (a) the full-width ``smollm-135m`` in bf16
     (random weights from a seeded generator): a prefill of B=4 x 128
     tokens filling the caches, then 16 decode steps, each step's logits
     equal to ``forward``'s within twice bf16's own cost (bf16 against fp32
     forward on the same weights; at least 2^-4), and within 1e-3 in fp32;
     parameters, ms per prefill, ms per decoded token, the model's peak
     memory (weights, caches, activations: over what earlier phases hold); (b)
     the ten ``smoke()`` configs in fp32: forward, prefill and one decode
     step on the card equal to the CPU within rtol=atol=1e-4; (c)
     ``examples/torch_serve_retrieval.py`` at its defaults (the full-width
     encoder, 20,000 documents, IVF+RaBitQ, k=1000): recall@1000, and the
     RaBitQ kernels it takes must show launches;
 21. the mesh, the sharding constraint, the dry run and the search
     examples: (a) phase 20's train step (full-width bf16 ``smollm-135m``,
     B=8 x 1024) on a one-rank NCCL ``DeviceMesh`` (1, 1) with parameters,
     optimizer state and batch as DTensors, bitwise equal to the step
     without a mesh (loss, grad_norm, lr, every parameter), and both
     steps' ms in turns; (b) the same cell through ``launch/dryrun.py`` at
     mesh (1, 1) on meta, its argument bytes equal to the card's bytes of
     (a)'s parameters, optimizer state and batch, its temporary bytes
     beside (a)'s peak; (c) dry-run cells on the (16, 16) mesh
     (``smollm-135m`` x the four shapes, ``granite-moe-1b-a400m`` x
     ``train_4k``), each ``ok`` or the reference's ``skip``, the dense
     prefill's counted FLOPs equal to the analytic model; (b) and (c) run
     in spawned processes on the host's cores (no card) while (d) runs
     ``examples/torch_quickstart.py`` (recall@2000 >= 0.95 on each query;
     #10-#12 must launch) and ``examples/torch_distributed_search.py`` on
     the one-rank NCCL group (overlap 1.0, the reference's cost-model
     bytes; #1, #2 and #6 must launch);
 22. the GIST1M-width RaBitQ cell's kernels at its shapes: a 1,000,000 x
     960 mixture as the cell's, IVF 1024 + 1-bit RaBitQ built on the card,
     one batch of 32 through the fused engine (recall@5000 >= 0.95 on 8
     queries); on that batch's inputs #5, the sample bounds (one warp a
     block at d=960) and #3 over every lane (the dense straggler pass,
     B=32 x n=1,000,000), each bitwise its plain version in one launch a
     call, then timed (the call and the kernel alone) beside its bound,
     its plain version and, for #3, ``torch.cdist``; the masked straggler
     pass on the call's own straggler mask, bitwise #3 on every set pair
     and staging exactly the tiles with a straggler, timed beside its
     bound, the issue ceiling of the groups it computes, its plain version
     and the dense pass; the batch's band, stragglers against the gather
     budget, and band anatomy;
  8. (only when asked for) torch.profiler over batches of phases 4, 9, 11
     (sharded IVF+PQ) and 14 (the mutable index with its segments), over
     single IVF+PQ+BBC queries (phase 12) and over three train steps of
     phase 20(a): device time by kernel and operator and the device's
     idle share;
 10. (only when asked for, after 9) the band anatomy of one RaBitQ batch:
     the band threshold, the static and warm predictive gates, and where
     the band lanes' lower-bound buckets lie.

Kernel launch counts are zeroed before phases 4, 9, 6, 12, 11, 13 (each
of its two runs), 14 (its searches with the segments), 15 (each of its
runs on the card), 16 (the timed sweep), 17 (the replay and the parity
twin in this process; the workers launch in their own), 18 (each of its
runs), 19 (the retrieval example), 20 (which must launch none) and 21
(each example) and read after each;
comparison and timing launches do not count.  A launch of the PQ, l2,
bucket or fused kernel at one query counts under its single-query row.  Any failed check raises and
the script exits non-zero without the last line.  Without CUDA it exits 2
before doing anything.  The second-to-last lines are the launch counts,
the card's ``nvidia-smi`` name and power limit, and a JSON list of kernels;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import atexit
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# The ceilings of #3 and #2, whose numerics fix their instruction mix (see
# l2_rerank.cu and pq_adc.cu): separate fp32 instructions a second (132 SMs
# x 128 lanes x 1.98 GHz boost) and 4-byte shared-memory words a second
# (132 SMs x 32 banks x 1.98 GHz).
FP32_ISSUE_PER_S = 132 * 128 * 1.98e9
SMEM_WORDS_PER_S = 132 * 32 * 1.98e9
# #2, #3, #10 and #11 before the tiled kernels (one thread per row, commit
# a8dde8d; NVIDIA H100 80GB HBM3 at 700 W; wrapper call, CUDA events).
ROW_KERNEL_MS = {"pq_adc_batch": 0.2753, "l2_exact_batch": 0.9324,
                 "pq_adc": 0.0238, "l2_exact": 0.0456}
SEED = 0
DEV = "cuda"

KERNELS = {
    "fused_scan_batch": ("src/repro_torch/kernels/csrc/fused_scan.cu",
                         "src/repro/kernels/fused_scan.py:284"),
    "pq_adc_batch": ("src/repro_torch/kernels/csrc/pq_adc.cu",
                     "src/repro/kernels/pq_adc.py:105"),
    "l2_exact_batch": ("src/repro_torch/kernels/csrc/l2_rerank.cu",
                       "src/repro/kernels/l2_rerank.py:61"),
    "bucket_hist_batch": ("src/repro_torch/kernels/csrc/bucket_hist.cu",
                          "src/repro/kernels/bucket_hist.py:131"),
    "fused_rabitq_scan_batch": (
        "src/repro_torch/kernels/csrc/rabitq_fused.cu",
        "src/repro/kernels/rabitq_fused.py:138"),
    "shard_collect_batch": ("src/repro_torch/kernels/csrc/shard_collect.cu",
                            "src/repro/kernels/shard_collect.py:104"),
    "spec_compact_batch": ("src/repro_torch/kernels/csrc/shard_collect.cu",
                           "src/repro/kernels/shard_collect.py:179"),
    "rabitq_est": ("src/repro_torch/kernels/csrc/rabitq_est.cu",
                   "src/repro/kernels/rabitq_est.py:43"),
    "fused_scan": ("src/repro_torch/kernels/csrc/fused_scan.cu",
                   "src/repro/kernels/fused_scan.py:114"),
    "pq_adc": ("src/repro_torch/kernels/csrc/pq_adc.cu",
               "src/repro/kernels/pq_adc.py:55"),
    "l2_exact": ("src/repro_torch/kernels/csrc/l2_rerank.cu",
                 "src/repro/kernels/l2_rerank.py:29"),
    "bucket_hist": ("src/repro_torch/kernels/csrc/bucket_hist.cu",
                    "src/repro/kernels/bucket_hist.py:65"),
    # no TPU kernel: the JAX package maps the sample's ADC in XLA
    "pq_sample_adc_batch": ("src/repro_torch/kernels/csrc/pq_adc.cu",
                            "src/repro/index/search.py:214"),
    # no TPU kernel: the JAX package gathers the second pass's rows in XLA
    "l2_gather_rows_batch": ("src/repro_torch/kernels/csrc/l2_rerank.cu",
                             "src/repro/index/search.py:501"),
    # no TPU kernel: the JAX package maps the RaBitQ sample's bounds in XLA
    "rabitq_sample_ub_batch": ("src/repro_torch/kernels/csrc/rabitq_fused.cu",
                               "src/repro/index/search.py:914"),
    # #1 where one query's LUT outgrows a block (8-bit codes at wide d)
    "fused_scan_chunked_batch": ("src/repro_torch/kernels/csrc/fused_scan.cu",
                                 "src/repro/kernels/fused_scan.py:284"),
    # no TPU kernel: the JAX package builds the sample's codebooks and
    # threshold bucket in XLA (its sorted-row mode counts apart, as
    # sample_plan_sorted_batch)
    "sample_plan_batch": ("src/repro_torch/kernels/csrc/sample_plan.cu",
                          "src/repro/core/buffer.py:82"),
    # no TPU kernel: the JAX package builds the lane mask with XLA's
    # scatter, gather and AND
    "probe_mask_batch": ("src/repro_torch/kernels/csrc/lane_mask.cu",
                         "src/repro/index/ivf.py:159"),
    # no TPU kernel: the JAX package's RaBitQ searcher reads its stragglers
    # from the dense #3 pass over every row
    "l2_exact_masked_batch": ("src/repro_torch/kernels/csrc/l2_rerank.cu",
                              "src/repro/index/search.py:1200"),
}
RQ_K, RQ_PROBE, RQ_EPS0 = 5000, 64, 3.0


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=30).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Device time per call of the CUDA kernels whose name holds
    ``kernel``, from torch.profiler over ``reps`` warm calls: at one query
    a kernel can finish before the host has issued the next call, and then
    ``cuda_ms`` times the wrapper's dispatch, not the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda_type = torch.autograd.DeviceType.CUDA
    return sum(e.device_time for e in prof.events()
               if e.device_type == cuda_type and kernel in e.name) / 1e3 / reps


def under_load(fn, ms_per_call: float, seconds: float = 1.0) -> str:
    """The card's SM clock, power draw and power-cap throttle flag, read by
    ``nvidia-smi`` while about ``seconds`` of ``fn`` calls run."""
    import torch
    for _ in range(max(1, int(seconds / (ms_per_call * 1e-3)))):
        fn()
    time.sleep(seconds / 2)
    reading = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
         "clocks_throttle_reasons.sw_power_cap", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip()
    torch.cuda.synchronize()
    return reading


def max_abs(a, b) -> float:
    """Largest |a - b| over lanes finite in both; +inf lanes must match."""
    import torch
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    check(torch.equal(fa, fb), "finite lanes differ")
    if not bool(fa.any()):
        return 0.0
    return float((a[fa] - b[fa]).abs().max().item())


def close(a, b, tol: float, name: str) -> float:
    import torch
    err = max_abs(a, b)
    fa = torch.isfinite(a)
    ok = torch.allclose(a[fa], b[fa], rtol=tol, atol=tol)
    check(ok, f"{name}: max abs err {err} beyond rtol=atol={tol}")
    return err


def kernel_inputs(rng, b, n, m_sub, d, k_codes=16, m=128, density=0.0625,
                  valid=None):
    """Random kernel inputs and per-query codebooks built from the plain
    ADC estimate (as the searcher builds them from its sample); ``valid``
    replaces the random lane mask."""
    import numpy as np
    import torch
    from repro_torch.core import buffer as rb
    from repro_torch.kernels import ref
    dev = "cuda"
    codes = torch.from_numpy(rng.integers(0, k_codes, (n, m_sub),
                                          dtype=np.uint8)).to(dev)
    vectors = torch.from_numpy(
        rng.standard_normal((n, d), dtype=np.float32)).to(dev)
    qs = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev)
    if valid is None:
        valid = torch.from_numpy(rng.random((b, n)) < density).to(dev)
    luts = torch.from_numpy(
        (rng.random((b, m_sub, k_codes)) * 2).astype(np.float32)).to(dev)
    est = torch.sqrt(ref.pq_adc_batch(codes, luts))
    est = torch.where(valid, est, float("inf"))
    cb = rb.build_codebook(est, k=min(n // 4, 40000), m=m)
    tau = torch.from_numpy(rng.integers(0, m, b).astype(np.int32)).to(dev)
    return dict(codes=codes, vectors=vectors, valid=valid, luts=luts, qs=qs,
                d_min=cb.d_min, delta=cb.delta, ew_maps=cb.ew_map, m=m,
                tau_pred=tau)


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def check_kernels(inp, errs: dict, tag: str) -> None:
    import torch
    from repro_torch.kernels import ops, ref
    a = inp
    # #1 over each query's lists (a random quarter of them), as the
    # searcher calls it: compared on the lists' lanes
    valid, lists, on = probe_lists(a["valid"], SEED + a["valid"].shape[1])
    est, bucket, hist, early, nmiss = ops.fused_scan_batch(
        a["codes"], a["vectors"], valid, a["luts"], a["qs"], a["d_min"],
        a["delta"], a["ew_maps"], a["m"], a["tau_pred"], *lists)
    torch.cuda.synchronize()
    p_est, p_bucket, p_hist, p_early, p_nmiss = ref.fused_scan_batch(
        a["codes"], a["vectors"], valid, a["luts"], a["qs"], a["d_min"],
        a["delta"], a["ew_maps"], a["m"], a["tau_pred"])
    e1 = close(est[on], p_est[on], 1e-5, f"{tag} fused est")
    # integer outputs: equal to the plain version run on the kernel's est
    # (its walked lanes; +inf elsewhere)
    est = torch.where(on, est, float("inf"))
    r_bucket, r_hist = ref.bucket_hist_batch(
        est, valid, a["d_min"], a["delta"], a["ew_maps"], a["m"])
    pred = valid & (r_bucket <= a["tau_pred"][:, None])
    r_nmiss = (valid & ~pred).sum(1).to(torch.int32)
    # early against the exact distances of the same predicted lanes
    p_early = torch.where(pred, ref.l2_exact_batch(a["vectors"], a["qs"]),
                          float("inf"))
    e2 = close(early[on], p_early[on], 1e-4, f"{tag} fused early")
    check(torch.equal(early[on], p_early[on]),
          f"{tag} fused early not bitwise equal")
    log(f"[kernels] {tag}: fused est over {lists[0].shape[1]} of "
        f"{lists[1].shape[0] - 1} lists a query ({int(on.sum().item())} "
        f"walked pairs of {on.numel()}) bit-identical to the plain version "
        f"on the walked lanes: {torch.equal(est[on], p_est[on])}; early "
        f"bit-identical")
    check(torch.equal(bucket[on], r_bucket[on]), f"{tag} fused bucket")
    check(torch.equal(hist, r_hist), f"{tag} fused hist")
    check(torch.equal(nmiss, r_nmiss), f"{tag} fused nmiss")
    check(torch.equal(torch.isfinite(early)[on], pred[on]),
          f"{tag} early finite exactly where bucket <= tau_pred")
    errs["fused_scan_batch"] = max(errs.get("fused_scan_batch", 0.0), e1, e2)

    adc = ops.pq_adc_batch(a["codes"], a["luts"])
    torch.cuda.synchronize()
    p_adc = ref.pq_adc_batch(a["codes"], a["luts"])
    e = close(adc, p_adc, 1e-5, f"{tag} pq_adc")
    check(torch.equal(adc, p_adc), f"{tag} pq_adc not bitwise equal")
    errs["pq_adc_batch"] = max(errs.get("pq_adc_batch", 0.0), e)

    l2 = ops.l2_exact_batch(a["vectors"], a["qs"])
    torch.cuda.synchronize()
    p_l2 = ref.l2_exact_batch(a["vectors"], a["qs"])
    e = close(l2, p_l2, 2e-4, f"{tag} l2")
    check(torch.equal(l2, p_l2), f"{tag} l2 not bitwise equal")
    errs["l2_exact_batch"] = max(errs.get("l2_exact_batch", 0.0), e)

    bkt, h = ops.bucket_hist_batch(est, valid, a["d_min"], a["delta"],
                                   a["ew_maps"], a["m"])
    torch.cuda.synchronize()
    check(torch.equal(bkt, r_bucket), f"{tag} bucket_hist bucket")
    check(torch.equal(h, r_hist), f"{tag} bucket_hist hist")
    errs["bucket_hist_batch"] = max(
        errs.get("bucket_hist_batch", 0.0),
        float((bkt - r_bucket).abs().max().item()))
    log(f"[kernels] {tag}: fused est err {e1:.3g} early err {e2:.3g}, "
        f"pq_adc err {errs['pq_adc_batch']:.3g} (bitwise), l2 err "
        f"{errs['l2_exact_batch']:.3g} (bitwise), bucket/hist/nmiss equal")


# Shapes that cross the tiled l2 and ADC kernels' edges: query tiles (B
# past 8, 16, 32 and a multiple of 32), ragged row tiles, coordinate chunks
# (d not a multiple of 64 or of 4, d = 960), the runtime-stride ADC (M=33,
# K=256, and M=128, K=256 at one query a tile) and the B=1 forms.  Each
# runs on aligned tensors and on views one element into a buffer, which
# take the narrow copies.
L2_EDGES = ((2, 20_001, 96), (33, 1000, 100), (64, 20_001, 960),
            (17, 129, 4), (9, 300, 99), (1, 1000, 960), (1, 777, 36))
ADC_EDGES = ((2, 20_001, 24, 16), (33, 1000, 33, 16), (64, 20_001, 24, 16),
             (32, 20_001, 32, 256), (5, 3000, 128, 256), (1, 777, 32, 16),
             (1, 1000, 33, 256))


def check_tile_edges(errs: dict) -> None:
    """#2 and #3 (and their B=1 forms) bitwise against their plain
    versions at ``L2_EDGES`` and ``ADC_EDGES``; each ADC plan's shared
    memory equal to the kernel's layout."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(SEED + 7)
    lib = ops._lib("pq_adc")

    def cu(a, shift):       # shift = 1: a view one element into a buffer
        flat = torch.zeros(a.size + shift, dtype=torch.from_numpy(a).dtype,
                           device=DEV)
        flat[shift:] = torch.from_numpy(a.ravel()).to(DEV)
        return flat[shift:].view(a.shape)

    for b, n, d in L2_EDGES:
        for shift in (0, 1):
            x = cu(rng.standard_normal((n, d)).astype(np.float32), shift)
            q = cu(rng.standard_normal((b, d)).astype(np.float32), shift)
            got = ops.l2_exact_batch(x, q)
            torch.cuda.synchronize()
            want = ref.l2_exact_batch(x, q)
            check(torch.equal(got, want), f"l2 B={b} n={n} d={d} "
                  f"shift={shift} ({ops._l2_plan(b, n, d)}) not bitwise")
            key = "l2_exact" if b == 1 else "l2_exact_batch"
            errs[key] = max(errs.get(key, 0.0), max_abs(got, want))
    for b, n, m_sub, k_codes in ADC_EDGES:
        p = ops._adc_plan(b, n, m_sub, k_codes)
        check(p.smem == lib.pq_adc_tiled_smem_bytes(
            p.qt, m_sub, k_codes, p.staged), f"pq_adc plan {p}: shared "
              f"memory differs from the kernel's layout")
        for shift in (0, 1):
            codes = cu(rng.integers(0, k_codes, (n, m_sub)).astype(np.uint8),
                       shift)
            luts = cu((rng.random((b, m_sub, k_codes)) * 2).astype(
                np.float32), shift)
            got = ops.pq_adc_batch(codes, luts)
            torch.cuda.synchronize()
            want = ref.pq_adc_batch(codes, luts)
            check(torch.equal(got, want), f"pq_adc B={b} n={n} M={m_sub} "
                  f"K={k_codes} shift={shift} ({p}) not bitwise")
            key = "pq_adc" if b == 1 else "pq_adc_batch"
            errs[key] = max(errs.get(key, 0.0), max_abs(got, want))
    log(f"[kernels] tile edges: l2 (B, n, d) in {L2_EDGES} and pq_adc "
        f"(B, n, M, K) in {ADC_EDGES}, aligned and unaligned: bitwise")


def rabitq_kernel_inputs(seed, b, n, d, c, m=128, density=0.0625,
                         dead: float = 0.0):
    """Random inputs of the RaBitQ scan: a cluster-major stream of +-1 int8
    codes over ``c`` clusters, per-query probe masks (each cluster probed
    with probability ``density``; a ``dead`` share of the lanes tombstoned,
    holes inside the probed clusters), and per-query codebooks over the
    upper bounds of a sample of the probed lanes (every 16th), as the
    searcher builds them from its sample."""
    import torch
    from repro_torch.core import buffer as rb
    from repro_torch.core import numerics as nm
    from repro_torch.index import rabitq
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    cl = torch.sort(torch.randint(0, c, (n,), generator=g, device=dev)
                    ).values.to(torch.int32)
    codes = (torch.randint(0, 2, (n, d), generator=g, device=dev) * 2 - 1
             ).to(torch.int8)
    cent = torch.randn(c, d, generator=g, device=dev) * 2
    vectors = cent[cl.long()] + 0.5 * torch.randn(n, d, generator=g,
                                                  device=dev)
    qs = vectors[torch.randint(0, n, (b,), generator=g, device=dev)] + 0.1
    rot = rabitq.random_rotation(torch.Generator().manual_seed(seed),
                                 d).to(dev)
    norm_o = 0.5 + rand(n)
    f_o = 0.7 + 0.15 * rand(n)
    hit = rand(b, c) < density
    hit[torch.arange(b, device=dev), torch.randint(0, c, (b,), generator=g,
                                                   device=dev)] = True
    valid = hit[:, cl.long()] & (rand(n) >= dead)[None, :]
    diff = cent[None] - qs[:, None]
    d2 = nm.ordered_sum(diff * diff)
    s2 = nm.rabitq_s2(codes, nm.rotate(cent, rot), cl)
    rq_g, nq = nm.rotate(qs, rot), nm.sqrt_rn(d2)
    _, _, ub = nm.rabitq_bounds_stream(codes, s2, norm_o, f_o, cl, rq_g, nq,
                                       valid, RQ_EPS0)
    lane = torch.arange(n, device=dev)
    sample = torch.where(valid & (lane % 16 == 0)[None], ub, float("inf"))
    cb = rb.build_codebook(sample, k=min(RQ_K, max(n // 32, 1)), m=m)
    tau = torch.randint(-1, m, (b,), generator=g, device=dev).to(torch.int32)
    return dict(codes=codes, vectors=vectors, s2=s2, norm_o=norm_o, f_o=f_o,
                cl=cl, g=rq_g, qs=qs, nq=nq, valid=valid, d_min=cb.d_min,
                delta=cb.delta, ew_maps=cb.ew_map, m=m, tau_inline=tau)


RQ_ARGS = ("codes", "vectors", "s2", "norm_o", "f_o", "cl", "g", "qs",
           "nq", "valid", "d_min", "delta", "ew_maps", "m", "tau_inline")
RQ_OUT = ("est", "lb", "ub", "bucket_lb", "bucket_ub", "hist_lb", "hist_ub",
          "exact", "certified", "nmiss")


def check_rabitq_kernel(a, errs: dict, tag: str) -> None:
    """The RaBitQ scan against its plain version on the same inputs: every
    output bitwise equal (est/lb/ub/exact with their inf patterns, every
    integer output)."""
    import torch
    from repro_torch.kernels import ops, ref
    args = [a[k] for k in RQ_ARGS]
    got = ops.fused_rabitq_scan_batch(*args, eps0=RQ_EPS0)
    torch.cuda.synchronize()
    want = ref.fused_rabitq_scan_batch(*args, eps0=RQ_EPS0)
    e = max(max_abs(got[i], want[i]) for i in (0, 1, 2, 7))
    for i, name in enumerate(RQ_OUT):
        check(torch.equal(got[i], want[i]),
              f"{tag} rabitq {name} differs from the plain version")
    errs["fused_rabitq_scan_batch"] = max(
        errs.get("fused_rabitq_scan_batch", 0.0), e)
    n_cert = int(got[8].sum().item())
    log(f"[kernels] {tag}: rabitq est/lb/ub/exact bitwise equal to the "
        f"plain version, buckets/hists/certified/nmiss equal; "
        f"{n_cert} certified (query, lane) pairs")


def shard_collect_inputs(seed, b, n, m=128, density=0.0625, valid=None):
    """Random inputs of the shard collector: (B, n) distances (+inf off the
    ``density`` valid lanes, or off ``valid``) and per-query codebooks over
    them."""
    import torch
    from repro_torch.core import buffer as rb
    g = torch.Generator(device=DEV).manual_seed(seed)
    dists = torch.rand(b, n, generator=g, device=DEV) * 30 + 1
    if valid is None:
        valid = torch.rand(b, n, generator=g, device=DEV) < density
    dists = torch.where(valid, dists, float("inf"))
    cb = rb.build_codebook(dists, k=min(max(n // 64, 8), 5000), m=m)
    return dict(dists=dists, valid=valid, d_min=cb.d_min, delta=cb.delta,
                ew_maps=cb.ew_map, m=m)


def check_shard_collect(a, budgets, errs: dict, tag: str) -> None:
    """Both compaction kernels against their plain versions on the same
    inputs, bitwise on every output, at tau_spec -1 (nothing), m
    (everything valid) and mixed, for each budget (one of which overflows
    at tau_spec = m); then at the edge budgets of query 0 (1, its total,
    one short of it, and its matches in the first half of its chunks, a
    chunk boundary) and over ten repeated calls."""
    import torch
    from repro_torch.kernels import ops, ref
    b, n, m = *a["valid"].shape, a["m"]
    g = torch.Generator(device=DEV).manual_seed(b)
    taus = {"cold": torch.full((b,), -1, dtype=torch.int32, device=DEV),
            "all": torch.full((b,), m, dtype=torch.int32, device=DEV),
            "mixed": torch.randint(-1, m + 1, (b,), generator=g,
                                   device=DEV).to(torch.int32)}
    args = (a["dists"], a["valid"], a["d_min"], a["delta"], a["ew_maps"], m)
    names = ("bucket", "hist", "pos", "ok", "count")

    def both(tname, tau, budget):
        got = ops.shard_collect_batch(*args, tau, budget)
        torch.cuda.synchronize()
        want = ref.shard_collect_batch(*args, tau, budget)
        for name, x, y in zip(names, got, want):
            check(torch.equal(x, y), f"{tag} shard_collect {name} differs "
                  f"(budget {budget}, tau {tname})")
        got_c = ops.spec_compact_batch(want[0], a["valid"], tau, budget)
        torch.cuda.synchronize()
        want_c = ref.spec_compact_batch(want[0], a["valid"], tau, budget)
        for name, x, y in zip(names[2:], got_c, want_c):
            check(torch.equal(x, y), f"{tag} spec_compact {name} differs "
                  f"(budget {budget}, tau {tname})")
        return want

    overflow = False
    for budget in budgets:
        for tname, tau in taus.items():
            want = both(tname, tau, budget)
            overflow |= bool((want[4] > budget).any().item())
    check(overflow, f"{tag}: no budget overflowed")
    bucket, edges = want[0], set()
    half = max(1, -(-n // ops.COLLECT_CHUNK) // 2) * ops.COLLECT_CHUNK
    for tname in ("all", "mixed"):
        tau = taus[tname]
        match = a["valid"][0] & (bucket[0] <= tau[0])
        total = int(match.sum().item())
        boundary = int(match[:half].sum().item())
        for budget in {1, total, total - 1, boundary} - {0, -1}:
            both(tname, tau, budget)
            edges.add(budget)
    tau, budget = taus["mixed"], budgets[0]
    first = ops.shard_collect_batch(*args, tau, budget)
    first_c = ops.spec_compact_batch(first[0], a["valid"], tau, budget)
    for _ in range(10):
        again = ops.shard_collect_batch(*args, tau, budget)
        again_c = ops.spec_compact_batch(first[0], a["valid"], tau, budget)
        check(all(torch.equal(x, y) for x, y in zip(first + first_c,
                                                    again + again_c)),
              f"{tag}: a repeated call of the shard collector differs")
    for name in ("shard_collect_batch", "spec_compact_batch"):
        errs[name] = max(errs.get(name, 0.0), 0.0)
    log(f"[kernels] {tag}: shard_collect and spec_compact bitwise equal to "
        f"their plain versions at budgets {budgets}, tau cold/all/mixed "
        f"(an overflow included), at query 0's edge budgets "
        f"{sorted(edges)} and over 10 repeated calls")


def tombstoned_probe_mask(seed, b, n, c=1024, n_probe=64, dead=0.05):
    """A mutable index's lane masks: a cluster-major stream of ``c``
    clusters, each query probing ``n_probe`` of them (runs of whole
    clusters), with a ``dead`` share of the stream's lanes tombstoned (the
    same rows for every query: holes inside the probed clusters).
    Returns (mask, live-lane share of the probed lanes)."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    cl = torch.sort(torch.randint(0, c, (n,), generator=g, device=DEV)
                    ).values
    pick = torch.rand(b, c, generator=g, device=DEV).argsort(dim=1)[:, :n_probe]
    hit = torch.zeros(b, c, dtype=torch.bool, device=DEV)
    hit.scatter_(1, pick, True)
    probe = hit[:, cl]
    live = torch.rand(n, generator=g, device=DEV) >= dead
    mask = probe & live[None, :]
    return mask, float(mask.sum().item()) / max(1, int(probe.sum().item()))


DELTA_SHAPES = ((32, 4096, 128), (32, 1000, 128), (32, 4095, 128))


def check_delta_scan(errs: dict) -> None:
    """#3 at the delta-segment scan's shapes (B=32 queries, one segment of
    4096 rows and ragged capacities, d=128), bitwise against its plain
    version, and the whole scan (``ingest.segment.delta_scan``: the mask,
    the k' smallest) against the same scan on the CPU."""
    import numpy as np
    import torch
    from repro_torch.ingest import segment
    from repro_torch.kernels import ops, ref
    for b, n, d in DELTA_SHAPES:
        rng = np.random.default_rng(n)
        x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
        q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32))
        got = ops.l2_exact_batch(x.to(DEV), q.to(DEV))
        torch.cuda.synchronize()
        check(torch.equal(got, ref.l2_exact_batch(x.to(DEV), q.to(DEV))),
              f"l2 at the delta shape {(b, n, d)} differs from its plain "
              f"version")
        live = torch.from_numpy(rng.random(n) >= 0.05)
        ids = torch.arange(10_000, 10_000 + n)
        cd, ci = segment.delta_scan(x, ids, live, q, k=5000)
        gd, gi = segment.delta_scan(x.to(DEV), ids.to(DEV), live.to(DEV),
                                    q.to(DEV), k=5000)
        check(torch.equal(gd.cpu(), cd) and torch.equal(gi.cpu(), ci),
              f"delta_scan at {(b, n, d)} differs between the card and the "
              f"CPU")
        errs["l2_exact_batch"] = max(errs.get("l2_exact_batch", 0.0),
                                     max_abs(got.cpu(),
                                             ref.l2_exact_batch(x, q)))
    log(f"[kernels] delta scan: l2 bitwise at {list(DELTA_SHAPES)}; "
        f"delta_scan (5% dead rows, k'=min(5000, capacity)) equal to the "
        f"CPU's")


def check_tombstones(errs: dict, summary: dict) -> None:
    """#1, #4, #6 and #7, and #5, on lane masks with 5% of the lanes
    tombstoned inside the probed clusters (a mutable index's masks), at the
    main path's width: every output bitwise against the plain version."""
    import numpy as np
    n, b = 1_000_064, 32
    mask, share = tombstoned_probe_mask(SEED + 7, b, n)
    check_kernels(kernel_inputs(np.random.default_rng(SEED + 7), b, n, 32,
                                128, valid=mask),
                  errs, "tombstoned B=32 n=1000064 M=32 d=128")
    check_shard_collect(shard_collect_inputs(SEED + 8, b, n, valid=mask),
                        (80_128, 20_224, 4096), errs,
                        f"tombstoned B={b} n={n}")
    check_rabitq_kernel(rabitq_kernel_inputs(SEED + 9, b, n, 128, 1024,
                                             dead=0.05),
                        errs, "tombstoned RaBitQ B=32 n=1000064 d=128")
    summary["tombstoned_live_share"] = share
    log(f"[kernels] tombstoned masks: {share:.4f} of the probed lanes live; "
        f"fused scan, bucket_hist, shard_collect, spec_compact and the "
        f"RaBitQ scan bitwise equal to their plain versions")


RQ_EST_SHAPES = ((256, 64), (300, 96), (1024, 128), (512, 100))


def rabitq_est_inputs(seed, t, cap, d, ragged: bool, empty: int = 0,
                      scatter: bool = False):
    """Random inputs of the RaBitQ estimator over ``t`` tiles of ``cap``
    lanes: +-1 int8 codes, factors in the JAX kernel test's ranges, unit
    v rows, and (``ragged``) each tile's valid lanes a prefix of random
    length, as the member table pads its clusters; the first ``empty``
    tiles all padding; ``scatter``: valid lanes scattered, not a prefix."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=DEV)

    codes = (torch.randint(0, 2, (t, cap, d), generator=g, device=DEV) * 2
             - 1).to(torch.int8)
    v = torch.randn(t, d, generator=g, device=DEV)
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    size = torch.randint(1, cap + 1, (t, 1), generator=g, device=DEV) \
        if ragged else torch.full((t, 1), cap, device=DEV)
    valid = torch.arange(cap, device=DEV)[None] < size
    if scatter:
        valid = rand(t, cap) < 0.3
    valid[:empty] = False
    return dict(codes=codes, norm_o=rand(t, cap) * 5 + 0.5,
                f_o=rand(t, cap) * 0.3 + 0.6, v=v, norm_q=rand(t) * 3 + 1,
                valid=valid)


RQE_ARGS = ("codes", "norm_o", "f_o", "v", "norm_q", "valid")


def check_rabitq_est(a, errs: dict, tag: str) -> None:
    """Kernel #8's tile form against its plain version: est, lb and ub
    bitwise (with their +inf lanes)."""
    import torch
    from repro_torch.kernels import ops, ref
    args = [a[k] for k in RQE_ARGS]
    got = ops.rabitq_est_tiles(*args, eps0=RQ_EPS0)
    torch.cuda.synchronize()
    want = ref.rabitq_est_tiles(*args, eps0=RQ_EPS0)
    for name, x, y in zip(("est", "lb", "ub"), got, want):
        check(torch.equal(x, y), f"{tag} rabitq_est {name} differs from the "
              f"plain version")
    errs["rabitq_est"] = max(errs.get("rabitq_est", 0.0),
                             max(max_abs(x, y) for x, y in zip(got, want)))
    log(f"[kernels] {tag}: rabitq_est est/lb/ub bitwise equal to the plain "
        f"version ({int(a['valid'].sum().item())} valid lanes)")


def sqrt_rn_values(count: int = 1 << 24):
    """``count`` + a few fp32 values from a numpy seed: uniform, tiny
    (u**8: subnormals), random bit patterns of every finite positive float,
    the neighbours of exact squares, and 0, -0, +inf, -inf, NaN, -1, the
    largest, the smallest normal and the smallest subnormal float."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    q = count // 4
    fi = np.finfo(np.float32)
    sq = (rng.random(q, dtype=np.float32) * np.float32(4096) + 1) ** 2
    return np.concatenate([
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, fi.max, fi.tiny,
                  fi.smallest_subnormal], dtype=np.float32),
        rng.random(q, dtype=np.float32) * np.float32(1000),
        rng.random(q, dtype=np.float32) ** 8,
        rng.integers(0, 0x7F800000, q, dtype=np.uint32).view(np.float32),
        np.nextafter(sq, np.float32(np.inf)), np.nextafter(sq, np.float32(0)),
        sq[: count - 4 * q + q // 2]])


def check_sqrt_rn(summary: dict) -> None:
    """``numerics.sqrt_rn`` on the card (``torch.sqrt``) bitwise equal to
    its CPU form (the fp64 fix-up) on 16M+ values: the card's square root
    is IEEE, which the port's CPU/card agreement rests on.  Also counts
    how many of them the CPU's ``torch.sqrt`` rounds differently."""
    import numpy as np
    import torch
    from repro_torch.core import numerics
    x = torch.from_numpy(sqrt_rn_values())
    card = numerics.sqrt_rn(x.to(DEV)).cpu()
    cpu = numerics.sqrt_rn(x)
    bits = card.view(torch.int32) == cpu.view(torch.int32)
    nan = torch.isnan(cpu)
    check(torch.equal(torch.isnan(card), nan), "sqrt_rn NaN lanes differ")
    bad = int((~bits & ~nan).sum().item())
    check(bad == 0, f"sqrt_rn: {bad} of {x.numel()} values differ between "
          f"the card and the CPU fix-up")
    with np.errstate(invalid="ignore"):
        ieee = torch.from_numpy(np.sqrt(x.numpy()))
    plain = torch.sqrt(x)
    off = int(((plain.view(torch.int32) != ieee.view(torch.int32))
               & ~nan).sum().item())
    summary["sqrt_rn"] = {"values": x.numel(), "card_vs_cpu_fixup_differ": 0,
                          "cpu_torch_sqrt_not_ieee": off}
    log(f"[kernels] sqrt_rn: {x.numel()} values bitwise equal on the card "
        f"(torch.sqrt) and the CPU (fp64 fix-up); the CPU's torch.sqrt "
        f"rounds {off} of them differently")


def bucket_hist_edge_inputs(seed, b, n, shift: int = 0):
    """#4's inputs with the lanes and codebooks its +inf shortcut must
    keep: +inf off the valid lanes and on some valid ones, NaN lanes, and
    per query a codebook from its finite lanes, query 1 with delta 0 (and
    d_min one of its distances, so 0 / 0 occurs), query 2 with d_min +inf,
    query 3 with both; ``shift`` = 1 puts the distances and validity one
    element into their buffers (the lane-by-lane path)."""
    import torch
    from repro_torch.core import buffer as rb
    g = torch.Generator(device=DEV).manual_seed(seed)

    def view(t):
        flat = torch.zeros(t.numel() + shift, dtype=t.dtype, device=DEV)
        flat[shift:] = t.reshape(-1)
        return flat[shift:].view(t.shape)

    valid = torch.rand(b, n, generator=g, device=DEV) < 0.5
    dists = torch.rand(b, n, generator=g, device=DEV) * 30 + 1
    dists = torch.where(valid, dists, float("inf"))
    cb = rb.build_codebook(dists, k=min(max(n // 8, 8), 5000), m=128)
    odd = torch.rand(b, n, generator=g, device=DEV)
    dists = torch.where(valid & (odd < 0.05), float("inf"), dists)
    dists = torch.where(odd > 0.97, float("nan"), dists)
    d_min, delta = cb.d_min.clone(), cb.delta.clone()
    if b > 1:
        delta[1], d_min[1] = 0.0, dists[1, 0] if bool(
            torch.isfinite(dists[1, 0])) else 5.0
    if b > 2:
        d_min[2] = float("inf")
    if b > 3:
        d_min[3], delta[3] = float("inf"), 0.0
    return (view(dists), view(valid), d_min, delta, cb.ew_map, 128)


def check_bucket_hist_edges(errs: dict) -> None:
    """#4 and its B=1 form #12 bitwise against the plain version on the
    card and the plain version on the CPU, on +inf and NaN lanes and the
    degenerate codebooks (delta 0, d_min +inf), at ragged and unaligned
    shapes, B from 1 to 33; then ten repeated calls interleaved with calls
    of other shapes."""
    import torch
    from repro_torch.kernels import ops, ref
    shapes = ((1, 262_144), (1, 1003), (4, 1000), (5, 100_003),
              (33, 20_001), (32, 1_000_064), (2, 3))
    for i, (b, n) in enumerate(shapes):
        for shift in (0, 1):
            a = bucket_hist_edge_inputs(SEED + i, b, n, shift)
            got = ops.bucket_hist_batch(*a)
            torch.cuda.synchronize()
            want = ref.bucket_hist_batch(*a)
            cpu = ref.bucket_hist_batch(*(t.cpu() if torch.is_tensor(t)
                                          else t for t in a))
            for name, x, y, z in zip(("bucket", "hist"), got, want, cpu):
                check(torch.equal(x, y), f"bucket_hist B={b} n={n} "
                      f"shift={shift} {name} differs from the plain version")
                check(torch.equal(x.cpu(), z), f"bucket_hist B={b} n={n} "
                      f"{name}: the plain version differs on the CPU")
            if b == 1:
                one = ops.bucket_hist(a[0][0], a[1][0], a[2], a[3], a[4][0],
                                      a[5])
                check(all(torch.equal(x, y[0]) for x, y in zip(one, want)),
                      f"bucket_hist (B=1 form) n={n} shift={shift}")
    first = bucket_hist_edge_inputs(SEED, 32, 1_000_064)
    other = bucket_hist_edge_inputs(SEED + 1, 3, 5000)
    want = ref.bucket_hist_batch(*first)
    for _ in range(10):
        got = ops.bucket_hist_batch(*first)
        ops.bucket_hist_batch(*other)
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              "bucket_hist: a repeated call differs")
    errs["bucket_hist_batch"] = max(errs.get("bucket_hist_batch", 0.0), 0.0)
    errs["bucket_hist"] = max(errs.get("bucket_hist", 0.0), 0.0)
    log(f"[kernels] bucket_hist (B, n) in {shapes}, aligned and unaligned, "
        f"+inf/NaN lanes, delta 0 and d_min +inf: bitwise equal to the plain "
        f"version on the card and on the CPU; 10 repeated calls equal")


def same(a, b) -> bool:
    """Equal values and NaN at the same places (``torch.equal`` counts a
    NaN unequal to itself)."""
    import torch
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def probe_lists(valid, seed: int, share: float = 0.25):
    """#1's lists for a (B, n) lane mask: the n lanes cut at random points
    into lists (some empty; one list where n < 128), each query given a
    random ``share`` of them, distinct and in random order, and the mask
    kept inside them.  Returns (mask, (probed (B, P) int64, offsets
    (C + 1) int64, cap), walked (B, n): the lanes of each query's lists)."""
    import torch
    b, n = valid.shape
    dev = valid.device
    g = torch.Generator(device=dev).manual_seed(seed)
    c = max(1, min(1024, n // 64))
    cuts = torch.randint(0, n + 1, (c - 1,), generator=g, device=dev)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         cuts.sort().values,
                         torch.full((1,), n, dtype=torch.int64, device=dev)])
    probed = torch.rand(b, c, generator=g, device=dev).argsort(1)
    probed = probed[:, :max(1, int(c * share))]
    walked = lanes_of(probed, offsets, n)
    cap = int((offsets[1:] - offsets[:-1]).max().item())
    return valid & walked, (probed, offsets, cap), walked


def lanes_of(probed, offsets, n: int):
    """(B, n) bool: the lanes of each query's lists ``probed`` over the
    list starts ``offsets``."""
    import torch
    c = offsets.shape[0] - 1
    owner = torch.searchsorted(offsets[1:], torch.arange(n, device=DEV),
                               right=True).clamp(max=c - 1)
    hit = torch.zeros(probed.shape[0], c, dtype=torch.bool, device=DEV)
    hit.scatter_(1, probed, True)
    return hit[:, owner]


def lists_holding(valid, offsets, seed: int):
    """Each query's lists over ``offsets`` that hold a lane of ``valid``,
    then others at random up to the widest query's count: (B, P) int64."""
    import torch
    b, n = valid.shape
    c = offsets.shape[0] - 1
    owner = torch.searchsorted(offsets[1:], torch.arange(n, device=DEV),
                               right=True).clamp(max=c - 1)
    held = torch.zeros(b, c, dtype=torch.int32, device=DEV).scatter_add_(
        1, owner.expand(b, n), valid.int()) > 0
    g = torch.Generator(device=DEV).manual_seed(seed)
    key = held.float() * 2 + torch.rand(b, c, generator=g, device=DEV)
    width = int(held.sum(1).max().item())
    return key.argsort(1, descending=True)[:, :max(1, width)]


def same_on(got, want, walked, what: str) -> None:
    """#1's outputs: est, bucket and early equal on the walked lanes (NaN
    where NaN), hist and nmiss whole."""
    names = ("est", "bucket", "hist", "early", "nmiss")
    for name, x, y in zip(names, got, want):
        if x.shape == walked.shape:
            x, y = x[walked], y[walked]
        check(same(x, y), f"{what}: {name} differs from the plain version")


def fused_edge_inputs(seed, b, n, m_sub, d, shift: int = 0,
                      density: float = 0.5, odd: bool = True):
    """Fused-scan inputs with what its kernels must get right: per query a
    codebook from the clean estimates, query 1 with delta 0, query 2 with
    d_min +inf, query 3 with both; thresholds m // 3, -1, m and 5; with
    ``odd`` LUT entries of +inf and NaN (so 1 lane in 16 estimates +inf and
    1 in 16 NaN) and +inf and NaN coordinates in some vector rows;
    ``shift`` = 1 puts codes, vectors and validity one element into their
    buffers (the narrow loads)."""
    import torch
    from repro_torch.core import buffer as rb
    from repro_torch.kernels import ref
    g = torch.Generator(device=DEV).manual_seed(seed)

    def view(t):
        flat = torch.zeros(t.numel() + shift, dtype=t.dtype, device=DEV)
        flat[shift:] = t.reshape(-1)
        return flat[shift:].view(t.shape)

    codes = torch.randint(0, 16, (n, m_sub), generator=g, device=DEV,
                          dtype=torch.uint8)
    vectors = torch.randn(n, d, generator=g, device=DEV)
    qs = torch.randn(b, d, generator=g, device=DEV)
    valid = torch.rand(b, n, generator=g, device=DEV) < density
    luts = torch.rand(b, m_sub, 16, generator=g, device=DEV) * 2
    m = 128
    est = torch.where(valid, torch.sqrt(ref.pq_adc_batch(codes, luts)),
                      float("inf"))
    cb = rb.build_codebook(est, k=min(max(n // 8, 8), 5000), m=m)
    d_min, delta = cb.d_min.clone(), cb.delta.clone()
    if b > 1:
        delta[1], d_min[1] = 0.0, est[1][torch.isfinite(est[1])][:1].sum()
    if b > 2:
        d_min[2] = float("inf")
    if b > 3:
        d_min[3], delta[3] = float("inf"), 0.0
    if odd:
        luts[:, 0, 15] = float("inf")
        luts[:, 1 % m_sub, 14] = float("nan")
        vectors[::97, d // 2] = float("nan")
        vectors[::89, 0] = float("inf")
    tau = torch.tensor([m // 3, -1, m, 5] * b, dtype=torch.int32,
                       device=DEV)[:b]
    return dict(codes=view(codes), vectors=view(vectors), valid=view(valid),
                luts=luts, qs=qs, d_min=d_min, delta=delta,
                ew_maps=cb.ew_map, m=m, tau_pred=tau)


FUSED_ARGS = ("codes", "vectors", "valid", "luts", "qs", "d_min", "delta",
              "ew_maps", "m", "tau_pred")


def check_fused_edges(errs: dict) -> None:
    """#1 and the one-query kernel #9 bitwise against the plain version
    (every output, NaN where it is NaN; #1 also over a quarter of random
    lists a query, on the lists' lanes) on ``fused_edge_inputs``: +inf and
    NaN lanes and rows, degenerate codebooks, thresholds -1 and m, n not a
    multiple of 4 or of a work item, unaligned views, M of whole-word rows
    (16, 24, 32) and not (8, 33), d of several staging passes and not a
    multiple of 4, no valid lane, every lane valid and predicted; #9 with
    its threshold as an int and as a tensor, on the CPU too where n is
    small; then ten repeated calls interleaved with another shape."""
    import torch
    from repro_torch.kernels import ops, ref
    names = ("est", "bucket", "hist", "early", "nmiss")

    def one_args(a, j):
        return (a["codes"], a["vectors"], a["valid"][j], a["luts"][j],
                a["qs"][j], a["d_min"][j], a["delta"][j], a["ew_maps"][j],
                a["m"], a["tau_pred"][j])

    def hold(got, want, what):
        for name, x, y in zip(names, got, want):
            check(same(x, y), f"{what}: {name} differs from the plain "
                  f"version")

    shapes = ((1_000_064, 32, 128), (262_147, 32, 128), (1003, 24, 96),
              (5, 16, 64), (20_001, 33, 100), (3000, 32, 960),
              (4099, 8, 12))
    for i, (n, m_sub, d) in enumerate(shapes):
        for shift in (0, 1):
            a = fused_edge_inputs(SEED + i, 4, n, m_sub, d, shift)
            args = [a[k] for k in FUSED_ARGS]
            what = f"fused_scan_batch B=4 n={n} M={m_sub} d={d} shift={shift}"
            hold(ops.fused_scan_batch(*args), ref.fused_scan_batch(*args),
                 what)
            args[2], lists, on = probe_lists(args[2], SEED + i)
            same_on(ops.fused_scan_batch(*args, *lists),
                    ref.fused_scan_batch(*args), on, what + " (lists)")
            for j in range(4):
                one = one_args(a, j)
                want = ref.fused_scan(*one)
                what = f"fused_scan n={n} M={m_sub} d={d} shift={shift} q{j}"
                hold(ops.fused_scan(*one), want, what)
                hold(ops.fused_scan(*one[:-1], int(one[-1])), want,
                     what + " (int threshold)")
                if n <= 20_001:
                    cpu = ref.fused_scan(*(t.cpu() if torch.is_tensor(t)
                                           else t for t in one))
                    hold([x.cpu() for x in want], cpu, what + " (CPU)")
    for dens, tau, label in ((0.0, 64, "no valid lane"),
                             (1.0, 128, "every lane predicted")):
        a = fused_edge_inputs(SEED + 11, 1, 262_147, 32, 128,
                              density=dens, odd=False)
        a["tau_pred"][:] = tau
        one = one_args(a, 0)
        hold(ops.fused_scan(*one), ref.fused_scan(*one),
             f"fused_scan {label}")
    first = fused_edge_inputs(SEED, 1, 1_000_064, 32, 128)
    other = fused_edge_inputs(SEED + 1, 1, 5000, 24, 96)
    want = ref.fused_scan(*one_args(first, 0))
    for _ in range(10):
        got = ops.fused_scan(*one_args(first, 0))
        ops.fused_scan(*one_args(other, 0))
        hold(got, want, "fused_scan: a repeated call")
    errs["fused_scan_batch"] = max(errs.get("fused_scan_batch", 0.0), 0.0)
    errs["fused_scan"] = max(errs.get("fused_scan", 0.0), 0.0)
    log(f"[kernels] fused_scan (B=1) and fused_scan_batch (B=4, over every "
        f"lane and over a quarter of random lists) at (n, M, "
        f"d) in {shapes}, aligned and unaligned, +inf/NaN lanes and rows, "
        f"delta 0 and d_min +inf, thresholds -1/5/m/3/m, no valid lane, "
        f"every lane predicted: bitwise equal to the plain version (the "
        f"CPU's too where n <= 20001); 10 repeated calls equal")


def check_single_kernels(errs: dict) -> None:
    """Phase 3's single-query half: #8 at the JAX kernel test's shapes
    (T = 1, through the JAX-signature wrapper) and in its tile form, and
    the B = 1 forms #9-#12 at the JAX single-kernel tests' shapes
    (``tests/test_kernels.py``): integers equal, exact legs bitwise, the
    estimates within 1e-5 (and reported bitwise)."""
    import numpy as np
    import torch
    from repro_torch.core import buffer as rb
    from repro_torch.kernels import ops, ref
    for i, (n, d) in enumerate(RQ_EST_SHAPES):
        a = rabitq_est_inputs(SEED + i, 1, n, d, ragged=False)
        args = (a["codes"][0], a["norm_o"][0], a["f_o"][0], a["v"][0],
                a["norm_q"][0])
        got = ops.rabitq_est(*args, eps0=RQ_EPS0)
        torch.cuda.synchronize()
        want = ref.rabitq_est(*args, eps0=RQ_EPS0)
        for name, x, y in zip(("est", "lb", "ub"), got, want):
            check(torch.equal(x, y), f"rabitq_est n={n} d={d} {name}")
        errs["rabitq_est"] = max(errs.get("rabitq_est", 0.0),
                                 max(max_abs(x, y) for x, y in zip(got, want)))
    log(f"[kernels] rabitq_est (T=1) bitwise at (n, d) in {RQ_EST_SHAPES}")
    check_rabitq_est(rabitq_est_inputs(SEED, 64, 4096, 128, ragged=True),
                     errs, "tiles T=64 cap=4096 d=128 (ragged tiles)")
    check_rabitq_est(rabitq_est_inputs(SEED + 1, 7, 300, 100, ragged=True),
                     errs, "tiles T=7 cap=300 d=100 (ragged tiles)")
    # tiles all padding (the +inf stores, full and ragged chunks), valid
    # lanes not a prefix, rows that do not fit 128 to a block (d = 960),
    # one long tile (blocks that own several chunks), many short tiles
    for i, (t, cap, d, empty, scatter) in enumerate((
            (64, 4096, 128, 16, False), (9, 1003, 128, 4, False),
            (6, 777, 100, 2, True), (5, 2048, 128, 1, True),
            (3, 600, 960, 1, False), (1, 70_001, 128, 0, True),
            (700, 300, 128, 100, False))):
        check_rabitq_est(rabitq_est_inputs(SEED + 2 + i, t, cap, d,
                                           ragged=True, empty=empty,
                                           scatter=scatter),
                         errs, f"tiles T={t} cap={cap} d={d}, {empty} all "
                         f"padding{', scattered lanes' if scatter else ''}")

    rng = np.random.default_rng(SEED)

    def cu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)

    for n in (256, 1000, 4096):
        for m_sub in (16, 32, 33):
            codes = cu(rng.integers(0, 16, (n, m_sub)).astype(np.uint8))
            lut = cu(rng.random((m_sub, 16)).astype(np.float32))
            got, want = ops.pq_adc(codes, lut), ref.pq_adc(codes, lut)
            errs["pq_adc"] = max(errs.get("pq_adc", 0.0),
                                 close(got, want, 1e-5, f"pq_adc n={n}"))
            check(torch.equal(got, want), f"pq_adc n={n} M={m_sub} bitwise")
    for n, d in ((256, 64), (999, 1536), (4096, 96)):
        x = cu(rng.standard_normal((n, d)).astype(np.float32))
        q = cu(rng.standard_normal(d).astype(np.float32))
        got, want = ops.l2_exact(x, q), ref.l2_exact(x, q)
        check(torch.equal(got, want), f"l2_exact n={n} d={d} not bitwise")
        errs["l2_exact"] = max(errs.get("l2_exact", 0.0), max_abs(got, want))
    for n in (512, 2000, 8192):
        for m in (16, 64, 128):
            valid = cu(rng.random(n) < 0.9)
            dists = torch.where(valid, cu((rng.random(n) * 10 + 1).astype(
                np.float32)), float("inf"))
            cb = rb.build_codebook(dists[None], k=min(n // 2, 1000), m=m)
            args = (dists, valid, cb.d_min, cb.delta, cb.ew_map, m)
            for name, x, y in zip(("bucket", "hist"), ops.bucket_hist(*args),
                                  ref.bucket_hist(*args)):
                check(torch.equal(x, y), f"bucket_hist n={n} m={m} {name}")
            errs["bucket_hist"] = 0.0
    for n, d, m_sub in ((512, 64, 16), (1000, 128, 32), (256, 96, 24)):
        m = 64
        codes = cu(rng.integers(0, 16, (n, m_sub)).astype(np.uint8))
        vectors = cu(rng.standard_normal((n, d)).astype(np.float32))
        q = cu(rng.standard_normal(d).astype(np.float32))
        valid = cu(rng.random(n) < 0.95)
        lut = cu((rng.random((m_sub, 16)) * 2).astype(np.float32))
        est0 = torch.where(valid, torch.sqrt(ref.pq_adc(codes, lut)),
                           float("inf"))
        cb = rb.build_codebook(est0[None], k=min(n // 2, 500), m=m)
        args = (codes, vectors, valid, lut, q, cb.d_min, cb.delta, cb.ew_map,
                m, m // 3)
        est, bucket, hist, early, nmiss = ops.fused_scan(*args)
        torch.cuda.synchronize()
        want = ref.fused_scan(*args)
        e = close(est, want[0], 1e-5, f"fused_scan n={n} est")
        r_bucket, r_hist = ref.bucket_hist(est, valid, cb.d_min, cb.delta,
                                           cb.ew_map, m)
        pred = valid & (r_bucket <= m // 3)
        check(torch.equal(bucket, r_bucket) and torch.equal(hist, r_hist),
              f"fused_scan n={n} bucket/hist")
        check(int(nmiss) == int((valid & ~pred).sum()), f"fused_scan n={n} "
              f"nmiss")
        p_early = torch.where(pred, ref.l2_exact(vectors, q), float("inf"))
        check(torch.equal(early, p_early), f"fused_scan n={n} early bitwise")
        errs["fused_scan"] = max(errs.get("fused_scan", 0.0), e)
    log("[kernels] single-query forms at B=1 (JAX single-kernel test "
        "shapes): pq_adc bitwise, l2_exact bitwise, bucket_hist equal, "
        "fused_scan est within 1e-5 with bucket/hist/nmiss equal and the "
        "early leg bitwise")


# --------------------------------------------------------------------------
# phases 4-6 and 9: the engines
# --------------------------------------------------------------------------

def corpus(n, d, n_q, seed=SEED):
    import numpy as np
    import torch
    from repro_torch.data import synthetic
    rng = np.random.default_rng(seed)
    x = synthetic.clustered(rng, n, d)
    qs = synthetic.queries_from(rng, x, n_q)
    return torch.from_numpy(x).to(DEV), torch.from_numpy(qs).to(DEV)


def recall(x, qs, ids, k) -> float:
    import numpy as np
    from repro_torch.index import flat
    _, gt = flat.search_batch(x, qs, k)
    gt, ids = gt.cpu().numpy(), ids.cpu().numpy()
    return float(np.mean([len(set(r.tolist()) & set(g.tolist())) / k
                          for r, g in zip(ids, gt)]))


def check_result(res, b, k, name, ascending: bool = True) -> None:
    """Shape, finite distances, no padding or duplicate ids, and (except
    for RaBitQ+BBC, whose certain-in rows come first and report their
    estimate) ascending distances."""
    import torch
    check(tuple(res.ids.shape) == (b, k), f"{name}: ids shape {res.ids.shape}")
    check(bool(torch.isfinite(res.dists).all()), f"{name}: non-finite dists")
    check(bool((res.ids >= 0).all()), f"{name}: padding ids in a full result")
    check(not ascending or bool((res.dists[:, 1:] >= res.dists[:, :-1]).all()),
          f"{name}: dists not ascending")
    srt = torch.sort(res.ids, dim=1).values
    check(bool((srt[:, 1:] != srt[:, :-1]).all()), f"{name}: duplicate ids")


def timed_batches(fn, batches):
    """Run ``fn`` over the batches; per-batch ms by CUDA events."""
    import torch
    out, ms = [], []
    for qb in batches:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out.append(fn(qb))
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    return out, ms


def overlap(a, b) -> float:
    """Mean share of equal ids between two (B, k) results."""
    return sum(len(set(x.tolist()) & set(y.tolist()))
               for x, y in zip(a.ids, b.ids)) / a.ids.numel()


def kmeans_repro(x, index) -> dict:
    """The build's IVF k-means (1024 clusters) and PQ codebook training
    (M=32 x 4 bits), each run twice as ``search.build_pq_index`` runs them
    (one generator from the seed, 10 rounds): both runs and the index the
    main path built must hold the same bits."""
    import torch
    from repro_torch.index import kmeans, pq
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(SEED)
        t0 = time.monotonic()
        cent, assign = kmeans.kmeans(x, 1024, 10, generator=gen)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        cb = pq.train(x, 32, 4, 10, generator=gen)
        torch.cuda.synchronize()
        runs.append((cent, assign, cb.centroids, t1 - t0,
                     time.monotonic() - t1))
    (c1, a1, p1, *_), (c2, a2, p2, *_) = runs
    check(torch.equal(c1, c2) and torch.equal(a1, a2),
          "two k-means runs at 1,000,000 x 128 differ")
    check(torch.equal(p1, p2), "two PQ codebook trainings differ")
    check(torch.equal(c1, index.ivf.centroids)
          and torch.equal(p1, index.pq.centroids),
          "the k-means runs differ from the main path's index")
    out = {"kmeans_s": [r[3] for r in runs], "pq_train_s": [r[4] for r in runs]}
    log(f"[kmeans] IVF k-means (1,000,000 x 128, 1024 clusters, 10 rounds) "
        f"and PQ training (32 x 16 centroids) each twice: torch.equal, and "
        f"equal to the main path's index; seconds {json.dumps(out)}")
    return out


PLAN_OPS = ("aten::topk", "aten::kthvalue", "aten::searchsorted",
            "aten::sort")


class PlainCalls:
    """Counts the calls of the plain version ``kernels.ref.<name>`` while
    open (none may come from card tensors: the wrapper launches the kernel
    or raises)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        from repro_torch.kernels import ref
        self.calls, self._real = 0, getattr(ref, self.name)

        def counted(*a, **kw):
            self.calls += 1
            return self._real(*a, **kw)

        setattr(ref, self.name, counted)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ref
        setattr(ref, self.name, self._real)


def stage_ops(search_fn, stage: str) -> dict:
    """The host operators (``aten::*``, nested ones too) that run inside
    the span ``stage`` of one profiled ``search_fn()`` call, by name and
    count."""
    import torch
    from repro_torch import spans
    spans.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        search_fn()
        torch.cuda.synchronize()
    base = prof.profiler.kineto_results.trace_start_ns()
    wins = [((r.t0_ns - base) / 1e3, (r.t1_ns - base) / 1e3)
            for r in spans.records() if r.name == stage]
    spans.clear()
    check(len(wins) == 1, f"{len(wins)} {stage} spans in one call")
    (t0, t1), out = wins[0], {}
    for e in prof.events():
        if e.name.startswith("aten::") and t0 <= e.time_range.start < t1:
            out[e.name] = out.get(e.name, 0) + 1
    return out


def check_plan_stage(search_fn, stage: str, tag: str) -> dict:
    """One plan launch in one call, no plain plan, and none of the
    composition's selections (``PLAN_OPS``) left in the sample stage."""
    from repro_torch.kernels import ops
    before = dict(ops.LAUNCHES)
    with PlainCalls("sample_plan_batch") as plain:
        search_fn()
    got = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v - before[k]}
    check(got.get("sample_plan_batch") == 1
          and not got.get("sample_plan_sorted_batch") and plain.calls == 0,
          f"{tag}: plan launches {got}, plain plan calls {plain.calls}")
    inside = stage_ops(search_fn, stage)
    left = {k: v for k, v in inside.items() if k in PLAN_OPS}
    check(not left, f"{tag}: {left} inside {stage}")
    log(f"[plan] {tag}: one sample_plan_batch launch a call, no plain plan; "
        f"{sum(inside.values())} aten operators inside {stage}: {inside}")
    return inside


# the lane mask's composition: the (B, n) gather hit[:, cluster_of], the
# AND with the layout's validity, and the (B, C + 1) scatter before them
ROUTE_OPS = ("aten::index", "aten::bitwise_and", "aten::scatter_")


def check_route_stage(search_fn, stage: str, tag: str) -> dict:
    """One lane-mask launch in one call, no plain mask, and none of the
    composition's operators (``ROUTE_OPS``) left in the routing stage."""
    from repro_torch.kernels import ops
    before = dict(ops.LAUNCHES)
    with PlainCalls("probe_mask_batch") as plain:
        search_fn()
    got = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v - before[k]}
    check(got.get("probe_mask_batch") == 1 and plain.calls == 0,
          f"{tag}: mask launches {got}, plain mask calls {plain.calls}")
    inside = stage_ops(search_fn, stage)
    left = {k: v for k, v in inside.items() if k in ROUTE_OPS}
    check(not left, f"{tag}: {left} inside {stage}")
    log(f"[route] {tag}: one probe_mask_batch launch a call, no plain mask; "
        f"{sum(inside.values())} aten operators inside {stage}: {inside}")
    return inside


def main_path(summary: dict, card: str):
    import torch
    from repro_torch.index import engine, search
    from repro_torch.kernels import ops
    n, d, k, b = 1_000_000, 128, 5000, 32
    t0 = time.monotonic()
    x, qs = corpus(n, d, 64 + 4 * b)
    log(f"[main] corpus {n} x {d} in {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    index = search.build_pq_index(x, 1024, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"[main] index (1024 clusters, M=32 x 4 bits) built on the card in "
        f"{time.monotonic() - t0:.1f}s")
    summary["kmeans_repro"] = kmeans_repro(x, index)
    eng = engine.SearchEngine.build(index, k=k, n_probe=64, device="cuda")
    check(eng.n_cand == 40000, f"n_cand {eng.n_cand}")
    eng.warmup((b,), predictive=True)
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    static_q = [qs[i:i + b] for i in range(0, 64, b)]
    res, ms = timed_batches(eng.search, static_q)
    state = [eng.predictor_init()]

    def pred(qb):
        r, state[0] = eng.search(qb, pred_state=state[0])
        return r

    pred_q = [qs[64 + i * b:64 + (i + 1) * b] for i in range(4)]
    pres, pms = timed_batches(pred, pred_q)
    launches = dict(ops.LAUNCHES)
    check(launches["fused_scan_batch"] > 0, "main path never ran the fused "
          "kernel")
    n_calls = len(static_q) + len(pred_q)
    check(launches["sample_plan_batch"] == n_calls
          and launches["sample_plan_sorted_batch"] == 0,
          f"main path: {launches['sample_plan_batch']} + "
          f"{launches['sample_plan_sorted_batch']} plan launches in "
          f"{n_calls} calls")
    check(launches["probe_mask_batch"] == n_calls,
          f"main path: {launches['probe_mask_batch']} mask launches in "
          f"{n_calls} calls")
    plan_ops = check_plan_stage(lambda: eng.search(qs[:b]), "pq.sample",
                                "main path")
    route_ops = check_route_stage(lambda: eng.search(qs[:b]), "pq.route",
                                  "main path")
    for r in res + pres:
        check_result(r, b, k, "main path")
    rec = recall(x, qs[:8], res[0].ids[:8], k)
    prec = recall(x, pred_q[-1][:8], pres[-1].ids[:8], k)
    check(rec > 0.5, f"main-path recall {rec}")
    steady = sorted(ms)[len(ms) // 2]
    summary["main_path"] = {
        "corpus": [n, d], "n_clusters": 1024, "n_probe": 64, "k": k,
        "n_cand": eng.n_cand, "batch": b, "pq": "M=32 x 4 bits", "m": 128,
        "ms_per_batch": ms, "qps": 1e3 * b / steady,
        "recall_at_k_8q": rec,
        "predictive_ms_per_batch": pms,
        "predictive_recall_at_k_8q": prec,
        "predictive_second_pass_mean": [
            float(r.n_second_pass.float().mean().item()) for r in pres],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "sample_stage_ops": plan_ops, "route_stage_ops": route_ops,
        "launches": launches, "card": card}
    log(f"[main] fused static ms/batch {ms}, QPS {1e3 * b / steady:.1f}, "
        f"recall@{k} {rec:.4f} (8 queries); predictive ms/batch {pms}, "
        f"recall {prec:.4f}; launches {launches}; {card}")
    return eng, qs, launches, x


def band_anatomy(eng, qb, state) -> dict:
    """Phase 10, a diagnostic off by default: why band lanes are or are not
    certified inline, on one batch of phase 9's fused engine after its
    predictive batches (outside the launch counts): the band threshold,
    the static and the warm predictive gates, and where the band lanes' lb
    buckets lie."""
    import torch
    from repro_torch.core import buffer as rb
    from repro_torch.core import rerank
    from repro_torch.kernels import ops
    a = rabitq_kernel_args(eng, qb)
    out = ops.fused_rabitq_scan_batch(*[a[k] for k in RQ_ARGS],
                                      eps0=RQ_EPS0)
    m, k, valid = eng.m, eng.k, a["valid"]
    blb, bub = out[3], out[4]
    tau_ub = rb.threshold_bucket(out[6], k)[0]
    tau_lb = rb.threshold_bucket(out[5], k)[0]
    band = valid & (blb <= tau_ub[:, None]) & ~(bub < tau_lb[:, None])
    gate = rerank.predict_tau(state, -(-k // 8), margin=3)
    n_band = band.sum(1).float()

    def mean(t):
        return float(t.float().mean().item())

    return {"tau_ub_mean": mean(tau_ub), "tau_ub_overflow_share":
            mean(tau_ub == m), "tau_lb_mean": mean(tau_lb),
            "static_gate_mean": mean(a["tau_inline"]),
            "predictive_gate": gate, "valid_mean": mean(valid.sum(1)),
            "band_mean": mean(n_band),
            "band_lb_overflow_share": mean((band & (blb == m)).sum(1) / n_band),
            "band_lb_over_predictive_gate_share":
                mean((band & (blb > gate)).sum(1) / n_band)}


def rabitq_path(summary: dict, card: str, x=None, qs=None):
    """Phase 9: IVF+RaBitQ at SIFT1M's widths through the engine."""
    import torch
    from repro_torch.index import engine, search
    from repro_torch.kernels import ops
    n, d, b, k = 1_000_000, 128, 32, RQ_K
    if x is None:
        x, qs = corpus(n, d, 64 + 4 * b)
    t0 = time.monotonic()
    index = search.build_rabitq_index(x, 1024, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"[rabitq] index (1024 clusters, 1-bit codes) built on the card in "
        f"{time.monotonic() - t0:.1f}s")
    kw = dict(k=k, n_probe=RQ_PROBE, device="cuda")
    engs = {"fused": engine.SearchEngine.build(index, **kw),
            "two_phase": engine.SearchEngine.build(index, fused=False, **kw),
            "baseline": engine.SearchEngine.build(index, use_bbc=False,
                                                  **kw)}
    for name, e in engs.items():
        e.warmup((b,), predictive=name == "fused")
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    res, ms = timed_batches(engs["fused"].search,
                            [qs[i:i + b] for i in range(0, 64, b)])
    state = [engs["fused"].predictor_init()]

    def pred(qb):
        r, state[0] = engs["fused"].search(qb, pred_state=state[0])
        return r

    pred_q = [qs[64 + i * b:64 + (i + 1) * b] for i in range(4)]
    pres, pms = timed_batches(pred, pred_q)
    fused_plans = ops.LAUNCHES["sample_plan_batch"]
    check(fused_plans == 2 + len(pred_q)
          and ops.LAUNCHES["sample_plan_sorted_batch"] == 0,
          f"the fused RaBitQ path: {fused_plans} plan launches in "
          f"{2 + len(pred_q)} calls")
    two, tms = timed_batches(engs["two_phase"].search, [qs[:b]])
    base, bms = timed_batches(engs["baseline"].search, [qs[:b]])
    launches = dict(ops.LAUNCHES)
    check(launches["fused_rabitq_scan_batch"] > 0,
          "the RaBitQ path never ran the bound-fused kernel")
    check(launches["rabitq_sample_ub_batch"]
          == launches["fused_rabitq_scan_batch"],
          f"the fused RaBitQ path: {launches['rabitq_sample_ub_batch']} "
          f"sample launches for {launches['fused_rabitq_scan_batch']} scans")
    plan_ops = check_plan_stage(lambda: engs["fused"].search(qs[:b]),
                                "rabitq.sample", "RaBitQ path")
    route_ops = check_route_stage(lambda: engs["fused"].search(qs[:b]),
                                  "rabitq.route", "RaBitQ path")
    for r in res + pres + two:
        check_result(r, b, k, "rabitq bbc", ascending=False)
    check_result(base[0], b, k, "rabitq baseline")
    rec = recall(x, qs[:8], res[0].ids[:8], k)
    prec = recall(x, pred_q[-1][:8], pres[-1].ids[:8], k)
    trec = recall(x, qs[:8], two[0].ids[:8], k)
    brec = recall(x, qs[:8], base[0].ids[:8], k)
    same = overlap(res[0], two[0])
    for name, r in (("fused", rec), ("fused predictive", prec),
                    ("two-phase", trec)):
        check(r >= 0.95, f"rabitq {name} recall@{k} {r} below 0.95")
    check(same >= 0.999, f"rabitq fused vs two-phase id overlap {same}")
    steady = sorted(ms)[len(ms) // 2]

    def mean(t):
        return float(t.float().mean().item())

    summary["rabitq_path"] = {
        "corpus": [n, d], "n_clusters": 1024, "n_probe": RQ_PROBE, "k": k,
        "batch": b, "m": engs["fused"].m, "eps0": RQ_EPS0,
        "fused_ms_per_batch": ms, "fused_qps": 1e3 * b / steady,
        "fused_recall_at_k_8q": rec,
        "fused_band_mean": mean(res[0].n_reranked),
        "fused_second_pass_mean": mean(res[0].n_second_pass),
        "predictive_ms_per_batch": pms, "predictive_recall_at_k_8q": prec,
        "predictive_second_pass_mean": [mean(r.n_second_pass) for r in pres],
        "two_phase_ms_per_batch": tms, "two_phase_recall_at_k_8q": trec,
        "baseline_ms_per_batch": bms, "baseline_recall_at_k_8q": brec,
        "baseline_reranked_mean": mean(base[0].n_reranked),
        "fused_vs_two_phase_overlap": same,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "sample_stage_ops": plan_ops, "route_stage_ops": route_ops,
        "launches": launches, "card": card}
    log(f"[rabitq] {json.dumps(summary['rabitq_path'])}")
    return engs["fused"], qs, launches, state[0]


def id_diff(g, c, row, x, qb) -> str:
    """The ids one side has and the other lacks, with their exact distances
    in fp64 and each side's largest reported distance."""
    import torch
    a, b = set(g.ids[row].tolist()), set(c.ids[row].tolist())
    q = qb[row].double().cpu()

    def dist(ids):
        return {i: float(torch.linalg.vector_norm(x[i].double().cpu() - q))
                for i in sorted(ids)[:5]}

    return (f"card only {dist(a - b)}, cpu only {dist(b - a)}, max "
            f"reported card {float(g.dists[row].max())} cpu "
            f"{float(c.dists[row].max())}")


def plain_float_parity(pq_index, rq_index, x, qs) -> dict:
    """Phase 5's float half: the plain versions run on the card and on the
    CPU over the same inputs (built on the card, copied to the CPU) give
    the same bits: the PQ estimate, early leg and integers of the fused
    scan, the RaBitQ scan's est/lb/ub/exact and integers, one query's
    factors and tile estimates, and the exact distances in the kernels'
    ascending order and in the gathered rows' fixed pairwise order."""
    import torch
    from repro_torch.index import engine, ivf as ivf_mod
    from repro_torch.index import rabitq as rq_mod
    from repro_torch.kernels import ref
    pq_eng = engine.SearchEngine.build(pq_index, k=1000, n_probe=16,
                                       device=DEV)
    rq_eng = engine.SearchEngine.build(rq_index, k=1000, n_probe=16,
                                       device=DEV)
    qb = qs[:32]
    out = {}

    def same(name, fn, *args):
        def cpu(a):
            return a.cpu() if torch.is_tensor(a) else a
        got, want = fn(*args), fn(*(cpu(a) for a in args))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for i, (g, c) in enumerate(zip(got, want)):
            diff = int((g.cpu() != c).sum().item())
            check(torch.equal(g.cpu(), c), f"parity plain {name}[{i}]: "
                  f"{diff} of {c.numel()} differ between the card and the CPU")
        out[name] = sum(g.numel() for g in got)

    a = main_path_kernel_args(pq_eng, qb)
    same("pq_fused_scan", ref.fused_scan_batch, *(a[k] for k in (
        "codes", "vectors", "valid", "luts", "qs", "d_min", "delta",
        "ew_maps", "m", "tau_pred")))
    r = rabitq_kernel_args(rq_eng, qb)
    same("rabitq_fused_scan", lambda *t: ref.fused_rabitq_scan_batch(
        *t, eps0=RQ_EPS0), *(r[k] for k in RQ_ARGS))
    probed = ivf_mod.route(rq_index.ivf, qs[0], 16)
    ids, valid = ivf_mod.gather_candidates(rq_index.ivf, probed)
    safe = ids.clamp(min=0)
    rq = rq_index.rq
    same("rabitq_query_factors", lambda rot, q, c: tuple(
        rq_mod.query_factors(rq._replace(rot=rot), q, c)), rq.rot, qs[0],
        rq_index.ivf.centroids[probed])
    qf = rq_mod.query_factors(rq, qs[0], rq_index.ivf.centroids[probed])
    same("rabitq_est_tiles", lambda *t: ref.rabitq_est_tiles(
        *t, eps0=RQ_EPS0), rq.codes[safe], rq.norm_o[safe], rq.f_o[safe],
        qf.v, qf.norm_q, valid)
    same("l2_exact", ref.l2_exact_batch, x, qb)
    g = torch.Generator(device=DEV).manual_seed(SEED)
    rows = torch.randint(0, x.shape[0], (32, 2000), generator=g, device=DEV)
    on = torch.rand(32, 2000, generator=g, device=DEV) < 0.9
    same("exact_rows", ref.l2_gather_rows, x, rows, qb, on)
    log(f"[parity] plain versions bitwise equal on the card and the CPU "
        f"(values compared): {json.dumps(out)}")
    return out


def parity(summary: dict) -> None:
    """Phase 5: each engine form on the card and on the CPU (the plain
    versions) over the same index, batched and sharded: equal id sets,
    sorted distances within 1e-4, equal work counters; the predictive forms
    over 3 batches."""
    import torch
    from repro_torch.index import engine, search
    x, qs = corpus(20_000, 128, 64, seed=SEED + 1)
    pq_index = search.build_pq_index(x, 128, seed=SEED, device="cuda")
    rq_index = search.build_rabitq_index(x, 128, seed=SEED, device="cuda")
    plain = plain_float_parity(pq_index, rq_index, x, qs)
    ivf_kw = dict(vectors=x)
    forms = [("bbc_fused", pq_index, dict(use_bbc=True, fused=True), True),
             ("bbc_unfused", pq_index, dict(use_bbc=True, fused=False), True),
             ("ivfpq", pq_index, dict(use_bbc=False, fused=False), False),
             ("rabitq_fused", rq_index, dict(use_bbc=True), True),
             ("rabitq_two_phase", rq_index, dict(use_bbc=True, fused=False),
              True),
             ("rabitq_baseline", rq_index, dict(use_bbc=False), False),
             ("ivf_bbc", pq_index.ivf, dict(use_bbc=True, **ivf_kw), True),
             ("ivf", pq_index.ivf, dict(use_bbc=False, **ivf_kw), False)]
    # the sharded forms: the CPU engine on a one-rank gloo mesh, the card's
    # on a one-rank NCCL mesh
    forms += [("sharded_" + name, index, dict(kw, mesh=True), can_predict)
              for name, index, kw, can_predict in (
                  ("ivfpq_bbc", pq_index, {}, True),
                  ("ivfpq_naive", pq_index, dict(use_bbc=False), False),
                  ("rabitq_fused", rq_index, {}, True),
                  ("rabitq_two_phase", rq_index, dict(fused=False), True),
                  ("rabitq_naive", rq_index, dict(use_bbc=False), False),
                  ("ivf_bbc", pq_index.ivf, ivf_kw, True),
                  ("ivf_naive", pq_index.ivf, dict(use_bbc=False, **ivf_kw),
                   False))]
    out = {}
    for name, index, kw, can_predict in forms:
        engs = [engine.SearchEngine.build(
            ix, k=1000, n_probe=16, device=dev,
            **dict(kw, mesh=mesh(dev) if kw.get("mesh") else None))
            for ix, dev in ((index, "cuda"),
                            (search.index_to(index, "cpu"), "cpu"))]
        for predictive in ((False, True) if can_predict else (False,)):
            states = [e.predictor_init() for e in engs]
            batches = [qs[:32], qs[32:], qs[:32]] if predictive else [qs[:32]]
            for qb in batches:
                rs = []
                for i, e in enumerate(engs):
                    if predictive:
                        r, states[i] = e.search(qb.to(e.device),
                                                pred_state=states[i])
                    else:
                        r = e.search(qb.to(e.device))
                    rs.append(r)
                g, c = rs
                key = name + ("_predictive" if predictive else "")
                for row in range(qb.shape[0]):
                    check(set(g.ids[row].tolist()) == set(c.ids[row].tolist()),
                          f"parity {key} query {row}: "
                          f"{id_diff(g, c, row, x, qb)}")
                gd = torch.sort(g.dists.cpu(), 1).values
                cd = torch.sort(c.dists, 1).values
                check(torch.allclose(gd, cd, rtol=1e-4, atol=1e-4),
                      f"parity {key} dists: max abs diff "
                      f"{(gd - cd).abs().max().item()}")
                for field in ("n_reranked", "n_second_pass"):
                    check(torch.equal(getattr(g, field).cpu(),
                                      getattr(c, field)),
                          f"parity {key} {field} differs")
            out[key] = {"ids_equal": True, "counters_equal": True}
            log(f"[parity] {key}: id sets equal, dists within 1e-4, "
                f"counters equal")
            # the same form on single (d,) queries (the predictive form:
            # singleton batches from cold)
            states = [e.predictor_init() for e in engs]
            for qi in range(3 if predictive else 4):
                rs = []
                for i, e in enumerate(engs):
                    q = qs[qi].to(e.device)
                    if predictive:
                        r, states[i] = e.search(q, pred_state=states[i])
                    else:
                        r = e.search(q)
                    rs.append(r)
                g, c = rs
                skey = key + "_single"
                check(g.ids.shape == (1000,), f"parity {skey}: ids shape "
                      f"{tuple(g.ids.shape)}")
                check(set(g.ids.tolist()) == set(c.ids.tolist()),
                      f"parity {skey} query {qi}")
                gd, cd = torch.sort(g.dists.cpu()).values, \
                    torch.sort(c.dists).values
                check(torch.allclose(gd, cd, rtol=1e-4, atol=1e-4),
                      f"parity {skey} dists: max abs diff "
                      f"{(gd - cd).abs().max().item()}")
                for field in ("n_reranked", "n_second_pass"):
                    check(int(getattr(g, field)) == int(getattr(c, field)),
                          f"parity {skey} {field} differs")
            out[skey] = {"ids_equal": True, "counters_equal": True}
            log(f"[parity] {skey}: id sets equal, dists within 1e-4, "
                f"counters equal")
    out["plain_floats_bitwise"] = plain
    summary["parity_20k"] = out


def other_forms(summary: dict, card: str) -> dict:
    import torch
    from repro_torch.index import engine, search
    from repro_torch.kernels import ops
    n, d, k, b = 100_000, 96, 5000, 32
    x, qs = corpus(n, d, 96)
    index = search.build_pq_index(x, 316, seed=SEED, device="cuda")
    engs = {
        "bbc_unfused": engine.SearchEngine.build(index, k=k, n_probe=64,
                                                 fused=False, device="cuda"),
        "ivfpq": engine.SearchEngine.build(index, k=k, n_probe=64,
                                           use_bbc=False, device="cuda"),
        "bbc_fused": engine.SearchEngine.build(index, k=k, n_probe=64,
                                               fused=True, device="cuda"),
        "ivf_bbc": engine.SearchEngine.build(index.ivf, k=k, n_probe=64,
                                             vectors=x, device="cuda"),
        "ivf": engine.SearchEngine.build(index.ivf, k=k, n_probe=64,
                                         use_bbc=False, vectors=x,
                                         device="cuda"),
    }
    for e in engs.values():
        e.warmup((b,), predictive=e.use_bbc)
    ops.reset_launches()
    out = {}
    res_unfused, ms = timed_batches(engs["bbc_unfused"].search, [qs[:b]])
    out["bbc_unfused"] = {"ms_per_batch": ms}
    state = [engs["bbc_unfused"].predictor_init()]

    def pred(qb):
        r, state[0] = engs["bbc_unfused"].search(qb, pred_state=state[0])
        return r

    pres, pms = timed_batches(pred, [qs[b:2 * b], qs[2 * b:3 * b]])
    out["bbc_unfused_predictive"] = {"ms_per_batch": pms}
    base, bms = timed_batches(engs["ivfpq"].search, [qs[:b]])
    out["ivfpq"] = {"ms_per_batch": bms}
    ivf_res, ims = timed_batches(engs["ivf_bbc"].search, [qs[:b]])
    out["ivf_bbc"] = {"ms_per_batch": ims}
    ivf_flat, fms = timed_batches(engs["ivf"].search, [qs[:b]])
    out["ivf"] = {"ms_per_batch": fms}
    istate = [engs["ivf_bbc"].predictor_init()]

    def ivf_pred(qb):
        r, istate[0] = engs["ivf_bbc"].search(qb, pred_state=istate[0])
        return r

    ivf_pres, ipms = timed_batches(ivf_pred, [qs[b:2 * b], qs[2 * b:3 * b]])
    out["ivf_predictive"] = {"ms_per_batch": ipms}
    launches = dict(ops.LAUNCHES)
    for name in ("pq_adc_batch", "l2_exact_batch", "bucket_hist_batch"):
        check(launches[name] > 0, f"the other forms never ran {name}")
    for r in res_unfused + pres + base + ivf_res + ivf_flat + ivf_pres:
        check_result(r, b, k, "other forms")
    # IVF ranks by exact distance: BBC, flat top-k and predictive agree
    check(overlap(ivf_res[0], ivf_flat[0]) == 1.0, "ivf bbc vs top-k ids")
    ivf_static = engs["ivf_bbc"].search(qs[2 * b:3 * b])
    check(overlap(ivf_static, ivf_pres[-1]) == 1.0,
          "ivf predictive vs static ids")
    for name, r, q in (("ivf_bbc", ivf_res[0], qs[:8]),
                       ("ivf", ivf_flat[0], qs[:8]),
                       ("ivf_predictive", ivf_pres[-1], qs[2 * b:2 * b + 8])):
        out[name]["recall_at_k_8q"] = recall(x, q, r.ids[:8], k)
    # the fused and unfused BBC forms select the same ids
    same = overlap(engs["bbc_fused"].search(qs[:b]), res_unfused[0])
    check(same >= 0.999, f"fused vs unfused id overlap {same}")
    out["bbc_unfused"]["recall_at_k_8q"] = recall(x, qs[:8],
                                                  res_unfused[0].ids[:8], k)
    out["ivfpq"]["recall_at_k_8q"] = recall(x, qs[:8], base[0].ids[:8], k)
    out["bbc_unfused_predictive"]["recall_at_k_8q"] = recall(
        x, qs[2 * b:2 * b + 8], pres[-1].ids[:8], k)
    out["fused_vs_unfused_overlap"] = same
    out["launches"] = launches
    out["card"] = card
    summary["other_forms_100k"] = out
    log(f"[forms] {json.dumps(out)}")
    return launches, engs["ivf_bbc"], x, qs


def pq8_path(summary: dict, card: str) -> dict:
    """Phase 6's 8-bit GIST-width index (3,000 x 960, 16 clusters, PQ 240 x
    8 bits: a query's (240, 256) LUT outgrows a block's shared memory),
    built on the card, and the fused IVF+PQ+BBC engine over it on the card
    and on the CPU: a batch of 8 and three predictive singletons (the
    batched searcher at one query) through ``SearchEngine.search``.  Id
    sets, sorted distances (1e-4) and both counters equal the CPU engine's;
    the launches of the card's searches are counted, and every scan among
    them is the chunked-LUT kernel's."""
    import torch
    from repro_torch.index import engine, search
    from repro_torch.kernels import ops
    x, qs = corpus(3000, 960, 11, seed=SEED + 9)
    index = search.build_pq_index(x, 16, n_bits=8, n_iter=4, seed=SEED,
                                  device="cuda")
    check(tuple(index.codes.shape) == (3000, 240)
          and index.pq.centroids.shape[1] == 256,
          f"pq8: codes {tuple(index.codes.shape)}, centroids "
          f"{tuple(index.pq.centroids.shape)}")
    engs = [engine.SearchEngine.build(ix, k=50, n_probe=8, fused=True,
                                      device=dev)
            for ix, dev in ((index, "cuda"),
                            (search.index_to(index, "cpu"), "cpu"))]
    states = [e.predictor_init() for e in engs]
    runs = [[], []]
    for i, e in enumerate(engs):
        if i == 0:
            torch.cuda.synchronize()
            ops.reset_launches()
        runs[i].append(e.search(qs[:8].to(e.device)))
        for q in qs[8:11]:
            r, states[i] = e.search(q.to(e.device), pred_state=states[i])
            runs[i].append(r)
        if i == 0:
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
    for j, (g, c) in enumerate(zip(*runs)):
        gi, ci = g.ids.reshape(-1, 50).cpu(), c.ids.reshape(-1, 50)
        for row in range(gi.shape[0]):
            check(set(gi[row].tolist()) == set(ci[row].tolist()),
                  f"pq8 search {j} query {row}: id sets differ")
        gd = torch.sort(g.dists.reshape(-1, 50).cpu(), 1).values
        cd = torch.sort(c.dists.reshape(-1, 50), 1).values
        check(torch.allclose(gd, cd, rtol=1e-4, atol=1e-4),
              f"pq8 search {j} dists: max abs diff "
              f"{(gd - cd).abs().max().item()}")
        for field in ("n_reranked", "n_second_pass"):
            check(torch.equal(getattr(g, field).cpu().reshape(-1),
                              getattr(c, field).reshape(-1)),
                  f"pq8 search {j} {field} differs")
    check(launches["fused_scan_chunked_batch"] == 4,
          f"pq8: {launches['fused_scan_chunked_batch']} chunked-LUT scans "
          f"for 4 searches")
    check(launches["fused_scan_batch"] == launches["fused_scan"] == 0,
          "pq8: a whole-LUT scan ran on the 8-bit index")
    out = {"ids_equal": True, "counters_equal": True, "card": card,
           "launches": {k: v for k, v in launches.items() if v}}
    summary["pq8_d960_3k"] = out
    log(f"[pq8] {json.dumps(out)}")
    return launches


# --------------------------------------------------------------------------
# phase 12: the single-query path
# --------------------------------------------------------------------------

SINGLE_Q = 16        # queries per single-query form, one at a time
SINGLE_PRED_Q = 4    # predictive singletons, from cold


def single_path(summary: dict, card: str, pq_eng, rq_eng, ivf_eng, qs_main,
                qs_rq, x_main, x_ivf, qs_ivf):
    """Phase 12: the single-query forms on the indexes of phases 4, 9 and 6
    (nothing is built), each serving ``SINGLE_Q`` queries one at a time
    through ``eng.search(q)``: ms per query (host clock around the call and
    a synchronise), recall@k over 8 of them, the id-set overlap with the
    batched engine on the same queries, the counters and the launches."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.kernels import ops
    k = pq_eng.k

    def replace(e, **kw):
        return dataclasses.replace(e, **kw)

    forms = {   # name: (engine, queries, truth corpus, predictive)
        "ivfpq_bbc": (pq_eng, qs_main, x_main, False),
        "ivfpq": (replace(pq_eng, use_bbc=False), qs_main, x_main, False),
        "ivfpq_bbc_predictive": (pq_eng, qs_main, x_main, True),
        "ivfrabitq_bbc": (rq_eng, qs_rq, x_main, False),
        "ivfrabitq": (replace(rq_eng, use_bbc=False), qs_rq, x_main, False),
        "ivf_bbc": (ivf_eng, qs_ivf, x_ivf, False),
        "ivf": (replace(ivf_eng, use_bbc=False), qs_ivf, x_ivf, False)}
    for e, qs, _, pred in forms.values():
        e.warmup((1,), predictive=pred)

    ops.reset_launches()
    runs = {}
    for name, (e, qs, _, pred) in forms.items():
        nq = SINGLE_PRED_Q if pred else SINGLE_Q
        before = dict(ops.LAUNCHES)
        state = e.predictor_init()
        res, ms = [], []
        for q in qs[:nq]:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            if pred:
                r, state = e.search(q, pred_state=state)
            else:
                r = e.search(q)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.monotonic() - t0))
            res.append(r)
        runs[name] = (res, ms, {kn: v - before[kn] for kn, v in
                                ops.LAUNCHES.items() if v - before[kn]})
    launches = dict(ops.LAUNCHES)
    for kname in ("rabitq_est", "fused_scan", "pq_adc", "l2_exact",
                  "bucket_hist"):
        check(launches[kname] > 0, f"the single-query path never ran "
              f"{kname}")

    out = {}
    for name, (res, ms, lch) in runs.items():
        e, qs, x, pred = forms[name]
        nq = len(res)
        for r in res:
            check(tuple(r.ids.shape) == (k,) and r.n_reranked.ndim == 0,
                  f"single {name}: shapes {tuple(r.ids.shape)}")
            check(bool(torch.isfinite(r.dists).all()) and
                  bool((r.ids >= 0).all()), f"single {name}: padding")
            check(len(set(r.ids.tolist())) == k, f"single {name}: duplicates")
        ids = torch.stack([r.ids for r in res])
        nr = min(8, nq)
        rec = recall(x, qs[:nr], ids[:nr], k)
        # the batched engine on the same queries (predictive: the batched
        # predictive path on the same singleton sequence from cold)
        if pred:
            st, ref_ids = e.predictor_init(), []
            for q in qs[:nq]:
                r, st = e.search_batch(q[None], pred_state=st)
                ref_ids.append(r.ids[0])
            ref_ids = torch.stack(ref_ids)
        else:
            ref_ids = e.search_batch(qs[:nq]).ids
        ov = sum(len(set(a.tolist()) & set(b.tolist()))
                 for a, b in zip(ids, ref_ids)) / ids.numel()
        if not name.startswith("ivfrabitq"):
            # RaBitQ's single and batched estimators differ in their
            # algebra (P(q - c) against Pq - Pc): reported, no bar
            check(ov == 1.0, f"single {name}: id-set overlap {ov} with the "
                  f"batched engine")
            check(rec >= (0.9 if pred else 0.95),
                  f"single {name}: recall@{k} {rec}")
        out[name] = {
            "queries": nq, "median_ms": statistics.median(ms),
            "max_ms": max(ms), "ms": ms, f"recall_at_{k}_{nr}q": rec,
            "overlap_with_batched": ov,
            "n_reranked_mean": float(torch.stack(
                [r.n_reranked for r in res]).float().mean().item()),
            "n_second_pass_mean": float(torch.stack(
                [r.n_second_pass for r in res]).float().mean().item()),
            "launches": lch}
        log(f"[single] {name}: {json.dumps(out[name])}")
    out["launches"] = launches
    out["card"] = card
    summary["single_query"] = out
    return launches


# --------------------------------------------------------------------------
# phase 13: single-process async serving
# --------------------------------------------------------------------------

# the JAX serving CLI's defaults (100,000 x 96, 316 clusters, ivfpq_bbc,
# k=5000, 64 Poisson requests at 200/s, deadline 500 ms, batches of 16,
# seed 0), with the parity check
ASYNC_ARGS = ["--mode", "async", "--check-parity"]


def _async_run(summary: dict, card: str, key: str, tag: str, label: str,
               run) -> dict:
    """Run ``serve --mode async`` through ``run`` (which prints the CLI's
    lines, the JSON summary last, and returns the exit code); the summary
    must read parity 1.0 over more than 0 requests and the code be 0.
    Returns the launches of the run."""
    import contextlib
    import io
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    ops.reset_launches()
    D.reset_tiers()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = run()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    lines = buf.getvalue().strip().splitlines()
    for line in lines[:-1]:
        log(line)
    out = json.loads(lines[-1])
    batches = [int(line.split()[1]) for line in lines
               if line.startswith("[serve]") and "batches served" in line]
    check(rc == 0, f"{label} exited {rc}")
    check(out["device"] == torch.cuda.get_device_name(0),
          f"{label} ran on {out['device']}")
    check(out.get("parity") == 1.0 and out.get("parity_checked", 0) > 0,
          f"{label} parity {out.get('parity')} over "
          f"{out.get('parity_checked')} requests")
    check(out["conserved"] and out["requests"] == 64,
          f"{label} lost requests")
    check(batches and batches[0] > 0, f"{label} served no batch")
    out.update(batches=batches[0], wall_s=wall, launches={
        k: v for k, v in launches.items() if v}, card=card,
        tiers={k: v for k, v in D.TIERS.items() if v})
    log(f"[{tag}] p50 {out['p50_ms']} ms, p99 {out['p99_ms']} ms, shed "
        f"{out['shed_rate']}, degraded {out['degraded_rate']}, deadline met "
        f"{out['deadline_met_rate']}, {out['batches']} batches of up to "
        f"{out['max_batch']}, recall_mean {out['recall_mean']}, parity "
        f"{out['parity']} over {out['parity_checked']}, qps {out['qps']}, "
        f"shards {out['shards']}; launches {out['launches']}, survivor "
        f"tiers {out['tiers']}; {card}")
    summary[key] = out
    return launches


def async_serving(summary: dict, card: str) -> dict:
    """Phase 13: ``serve --mode async`` through its entry point
    (``repro_torch.launch.serve.main``) on the card, then the same run
    sharded: ``serve_rank`` on a one-rank NCCL mesh (the default group of
    phase 11), rank 0's event loop driving the sharded engines through the
    lock-step protocol.  Returns the launches of both runs."""
    import torch
    from repro_torch.launch import serve

    def sharded_run():
        mesh("cuda")
        args = serve.parse_args(ASYNC_ARGS + ["--shards", "1"])
        out, rc = serve.serve_rank(args, torch.device("cuda", 0))
        print(json.dumps(out))
        return rc

    l1 = _async_run(summary, card, "async_serving", "async",
                    "serve --mode async", lambda: serve.main(ASYNC_ARGS))
    l2 = _async_run(summary, card, "async_sharded", "async-sharded",
                    "serve --mode async, sharded (one NCCL rank)",
                    sharded_run)
    a, b = summary["async_serving"], summary["async_sharded"]
    check(b["shards"] == 1 and b["completed"] == a["completed"],
          "the sharded async run served another request set")
    return {k: l1[k] + l2[k] for k in l1}


# --------------------------------------------------------------------------
# phase 14: streaming ingest at full width
# --------------------------------------------------------------------------

INGEST_INSERT, INGEST_DELETE_BASE, INGEST_DELETE_SEG = 50_000, 40_000, 10_000
INGEST_Q = 64


def ingest_rows(n: int, d: int, seed: int):
    """``n`` new rows of the main corpus's mixture: ``corpus`` draws
    ``synthetic.clustered``'s 256 centers first from ``SEED``; the rows take
    fresh assignments and noise from ``seed``."""
    import numpy as np
    centers = np.random.default_rng(SEED).standard_normal((256, d)) * 2.0
    rng = np.random.default_rng(seed)
    return (centers[rng.integers(0, 256, n)]
            + rng.standard_normal((n, d)) * 0.5).astype(np.float32)


def ingest_schedule(x_np, rows, del_base, del_seg):
    """A MutableIndex over the main corpus (IVF+PQ+BBC, 1024 clusters,
    k=5000, n_probe=64, generation 0 built on the card), then the inserts
    and the deletes of base and segment rows.  Returns (index, seconds by
    step)."""
    import numpy as np
    import torch
    from repro_torch import ingest
    secs = {}
    t0 = time.monotonic()
    mi = ingest.MutableIndex(x_np, "ivfpq", k=5000, n_probe=64,
                             n_clusters=1024, device=DEV)
    torch.cuda.synchronize()
    secs["build_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    ins = mi.insert(rows)
    secs["insert_s"] = time.monotonic() - t0
    doomed = np.concatenate([del_base, ins[del_seg]])
    t0 = time.monotonic()
    count = mi.delete(doomed)
    torch.cuda.synchronize()
    secs["delete_s"] = time.monotonic() - t0
    check(count == len(doomed), f"deleted {count} of {len(doomed)} ids")
    return mi, secs


def live_recall(mi, qs, res, k: int):
    """(recall@k against exact search over ``live_corpus()``, deleted ids
    that surfaced: none is live, so any result id outside it counts)."""
    import numpy as np
    import torch
    from repro_torch.index import flat
    lx, lids = mi.live_corpus()
    _, gt = flat.search_batch(torch.from_numpy(lx).to(DEV), qs, k)
    gt = lids[gt.cpu().numpy()]
    ids = np.concatenate([r.ids.cpu().numpy() for r in res])
    rec = float(np.mean([len(set(r.tolist()) & set(g.tolist())) / k
                         for r, g in zip(ids, gt)]))
    return rec, int((~np.isin(ids, lids)).sum())


def ingest_path(summary: dict, card: str, x, qs, prof: bool = False) -> dict:
    """Phase 14: the main cell's corpus as a MutableIndex; 50,000 inserted
    rows (13 segments of 4096), 50,000 deleted ids (40,000 base rows,
    10,000 segment rows: churn 0.10, the merge trigger); 64 queries in
    batches of 32 with and without the segments; a merge crashed after its
    checkpoint, the checkpoint verified, the merge resumed, the queries
    again; the same schedule merged without a crash must give the same
    bits.  ``prof`` (phase 8) adds torch.profiler over three batches with
    the segments, before the merge.  Returns the launches of the
    searches."""
    import numpy as np
    import torch
    from repro_torch import ingest
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels import ops
    k, b = 5000, 32
    x_np = x.cpu().numpy()
    n, d = x_np.shape
    rows = ingest_rows(INGEST_INSERT, d, SEED + 14)
    rng = np.random.default_rng(SEED + 15)
    del_base = rng.choice(n, INGEST_DELETE_BASE, replace=False)
    del_seg = rng.choice(INGEST_INSERT, INGEST_DELETE_SEG, replace=False)
    q = qs[:INGEST_Q]
    batches = [q[i:i + b] for i in range(0, INGEST_Q, b)]
    out = {"corpus": [n, d], "inserted": INGEST_INSERT,
           "deleted": INGEST_DELETE_BASE + INGEST_DELETE_SEG, "k": k,
           "n_probe": 64, "batch": b, "queries": INGEST_Q, "card": card}

    mi, secs = ingest_schedule(x_np, rows, del_base, del_seg)
    out.update(secs)
    out["segments"] = len(mi.segments)
    out["churn"] = mi.churn_fraction()
    check(out["segments"] == 13, f"{out['segments']} segments")
    check(mi.needs_merge(), f"churn {out['churn']} under the merge trigger")
    mi.search(batches[0])                       # warm: uploads the segments
    ops.reset_launches()
    res, ms = timed_batches(mi.search, batches)
    launches = dict(ops.LAUNCHES)
    _, ms_base = timed_batches(mi.engine.search_batch, batches)
    for r in res:
        check_result(r, b, k, "mutable index")
    out["recall_before"], out["surfaced_before"] = live_recall(mi, q, res, k)
    out.update(ms_per_batch=ms, ms_per_batch_base_only=ms_base,
               launches={kk: v for kk, v in launches.items() if v})
    check(launches["l2_exact_batch"] == 13 * len(batches),
          f"{launches['l2_exact_batch']} delta-scan launches of #3")
    if prof:
        log("[profile] the mutable index with 13 segments (phase 14):")
        summary["profile_ingest"] = profile(mi, qs)

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_merge_")
    t0 = time.monotonic()
    try:
        ingest.MergeJob(mi, ckpt).run(crash_after_checkpoint=True)
        check(False, "the injected merge crash did not happen")
    except ingest.MergeCrash:
        pass
    out["checkpoint_write_s"] = time.monotonic() - t0   # seal + snapshot
    out["checkpoint_bytes"] = sum(
        f.stat().st_size for f in Path(ckpt).rglob("*") if f.is_file())
    sealed, _ = timed_batches(mi.search, batches)
    out["recall_sealed"], out["surfaced_sealed"] = live_recall(mi, q, sealed,
                                                               k)
    t0 = time.monotonic()
    CheckpointManager(ckpt).verify(mi.generation + 1)
    out["checkpoint_verify_s"] = time.monotonic() - t0
    build = mi.build_engine

    def timed_build(*a):
        t = time.monotonic()
        eng = build(*a)
        torch.cuda.synchronize()
        out["rebuild_s"] = time.monotonic() - t
        return eng

    mi.build_engine = timed_build
    t0 = time.monotonic()
    ingest.resume_merge(mi, ckpt)
    out["resume_s"] = time.monotonic() - t0
    check(mi.generation == 1 and not mi.segments and mi.churn_fraction() == 0,
          "the resumed merge left churn behind")
    mi.search(batches[0])
    after, ms_after = timed_batches(mi.search, batches)
    out["ms_per_batch_after"] = ms_after
    out["recall_after"], out["surfaced_after"] = live_recall(mi, q, after, k)
    del mi
    torch.cuda.empty_cache()

    twin, _ = ingest_schedule(x_np, rows, del_base, del_seg)
    ingest.MergeJob(twin, tempfile.mkdtemp(prefix="chip_smoke_merge_")).run()
    straight = [twin.search(qb) for qb in batches]
    out["resumed_equals_uninterrupted"] = all(
        torch.equal(a.ids, c.ids) and torch.equal(a.dists, c.dists)
        for a, c in zip(after, straight))
    del twin
    torch.cuda.empty_cache()
    for key in ("recall_before", "recall_sealed", "recall_after"):
        check(out[key] >= 0.95, f"phase 14 {key} {out[key]}")
    for key in ("surfaced_before", "surfaced_sealed", "surfaced_after"):
        check(out[key] == 0, f"phase 14: {out[key]} deleted ids surfaced")
    check(out["resumed_equals_uninterrupted"],
          "the resumed merge differs from the uninterrupted one")
    log(f"[ingest] {n} x {d} + {INGEST_INSERT} rows ({out['segments']} "
        f"segments) - {out['deleted']} ids, churn {out['churn']:.4f}: "
        f"ms/batch {ms} with segments, {ms_base} base only, {ms_after} after "
        f"the merge; recall@{k} before {out['recall_before']:.4f}, sealed "
        f"{out['recall_sealed']:.4f}, after {out['recall_after']:.4f}; "
        f"deleted ids surfaced {out['surfaced_before']}/"
        f"{out['surfaced_sealed']}/{out['surfaced_after']}; build "
        f"{out['build_s']:.2f}s, checkpoint write {out['checkpoint_write_s']:.2f}s "
        f"({out['checkpoint_bytes']} bytes), verify "
        f"{out['checkpoint_verify_s']:.2f}s, rebuild {out['rebuild_s']:.2f}s, "
        f"resume {out['resume_s']:.2f}s; resumed == uninterrupted: "
        f"{out['resumed_equals_uninterrupted']}; launches {out['launches']}; "
        f"{card}")
    summary["ingest"] = out
    return launches


# --------------------------------------------------------------------------
# phase 15: the replica tier on the card
# --------------------------------------------------------------------------

REPLICA_FAULTS = ("crash@1:t=0.1;corrupt@2:t=0.05,dur=0.2;"
                  "slow@3:t=0.0,dur=1.0,factor=4")
REPLICA_ARGS = ASYNC_ARGS + ["--replicas", "4", "--faults", REPLICA_FAULTS]
# the twin runs' fixed service model (seconds a batch) and batching cap
REPLICA_SVC, REPLICA_MAX_WAIT = 0.015, 0.04
# phase 18: the least (min, mean) id-set overlap of the sharded tau run
# with the mesh-less one.  The reference's own runs part there as well
# (min 0.9936, mean 0.99955 at 60,000 rows on the CPU); a sharded result
# that lost or garbled ids falls far below.
REPLICA_SHARDED_OVERLAP = (0.98, 0.995)


def _replica_cli(summary: dict, card: str, key: str, tag: str,
                 extra: list) -> dict:
    """``serve --mode async --replicas 4 --faults ...`` through its entry
    point, held to the async bars (parity 1.0 over more than 0 requests,
    conserved) and a respawn; returns the summary's fault stats."""
    from repro_torch.launch import serve
    launches = _async_run(summary, card, key, tag,
                          f"serve --mode async --replicas 4 {extra}",
                          lambda: serve.main(REPLICA_ARGS + extra))
    out = summary[key]
    stats = out["fault_stats"]
    check(out["replicas"] == 4 and out["faults"] == REPLICA_FAULTS,
          f"{tag}: the summary names another tier")
    check(stats["respawns"] >= 1, f"{tag}: no respawn ({stats})")
    log(f"[{tag}] fault stats {stats}; retried {out['retried']}, hedged "
        f"{out['hedged']}, failed {out['failed']}; digest "
        f"{out['outcome_digest']}; {card}")
    return launches


def _replica_twin(state, trace_args, ks, ckpt_dir=None):
    """One library run of the tier with the fixed service model: the
    ``ReplicaServer`` the CLI builds, over ``state``, on the CLI's seeded
    trace and the phase's schedule, batches capped at 40 ms so that they
    start inside the corrupt window.  Returns (server, outcomes, the
    respawns' restores)."""
    import numpy as np
    from repro_torch.serving import batcher as bt
    from repro_torch.serving import faults as flt
    from repro_torch.serving import queue as rq
    from repro_torch.serving.router import ReplicaServer
    qs, n_probe = trace_args
    trace = rq.make_trace(np.random.default_rng(SEED), qs, ks, rate=200.0,
                          deadline=0.5, n_probe=n_probe,
                          recall_target=0.95)
    srv = ReplicaServer(state, 4, ceilings=bt.k_ceilings(ks), batch=16,
                        faults=flt.FaultSchedule.parse(REPLICA_FAULTS),
                        service_time_fn=lambda b: REPLICA_SVC,
                        max_wait=REPLICA_MAX_WAIT, hb_interval=0.02,
                        respawn_delay=0.05, checkpoint_dir=ckpt_dir,
                        checkpoint_every=1)
    restores = []
    respawn = srv.pool.respawn

    def recorded(rid, now):
        # what the respawn must restore: the latest checkpoint, verified
        mgr = srv.pool._manager(rid)
        step = None if mgr is None else mgr.latest_step()
        rep = respawn(rid, now)
        restores.append((rid, step, mgr, dict(rep.state._pred)))
        return rep

    srv.pool.respawn = recorded
    return srv, srv.run_trace(trace), restores


def replica_tier(summary: dict, card: str) -> dict:
    """Phase 15: the replica tier on the card.  (a) ``serve --mode async
    --replicas 4`` at the JAX CLI's defaults with the phase's fault
    schedule and ``--check-parity``; (b) the same with ``--max-wait-ms 40``,
    whose batches start inside the corrupt window; (c) twice through the
    library with the fixed service model on the serve-default index, tau
    predictor on and predictor checkpoints in a temporary directory: equal
    digests, a detected corruption, a respawn restoring the latest
    verified checkpoint bit for bit; (d) the same run on phase 5's index
    on the card and on the CPU: equal digests.  Returns the launches of
    every run."""
    import torch
    from repro_torch.core import rerank
    from repro_torch.index import search
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import server as sv
    from repro_torch.serving.replica import _pred_key
    from repro_torch.serving.router import outcome_digest
    from repro_torch.serving.state import ServingState
    launches = _replica_cli(summary, card, "replica", "replica", [])
    out = summary["replica"]
    log(f"[replica] at the defaults every batch waits for its slack: "
        f"{out['fault_stats']['corrupt_detected']} corrupt responses in "
        f"the window t=0.05-0.25 s")
    more = _replica_cli(summary, card, "replica_max_wait",
                        "replica-max-wait", ["--max-wait-ms", "40"])
    launches = {k: launches[k] + more[k] for k in launches}
    stats = summary["replica_max_wait"]["fault_stats"]
    check(stats["corrupt_detected"] >= 1 and stats["retries_sent"] >= 1,
          f"replica-max-wait: no corrupt response detected and retried "
          f"({stats})")

    # (c) twin library runs on the serve-default index, predictor on
    args = serve.parse_args([])
    x, qs = serve.corpus(args, torch.device(DEV))
    index = serve.build_index(args.method, x, args.n_clusters, args.seed,
                              torch.device(DEV))
    trace_args = (qs.cpu().numpy(), 64)
    digests, twin = [], {}
    for run in range(2):
        state = ServingState(index, tau_pred=True, device=DEV)
        ops.reset_launches()
        t0 = time.monotonic()
        srv, outcomes, restores = _replica_twin(
            state, trace_args, (5000,),
            ckpt_dir=tempfile.mkdtemp(prefix="chip_smoke_replica_"))
        wall = time.monotonic() - t0
        got = dict(ops.LAUNCHES)
        launches = {k: launches[k] + got[k] for k in launches}
        s = sv.summarize(outcomes)
        check(s["conserved"] and s["requests"] == 64,
              f"replica twin {run}: lost requests")
        check(srv.stats["corrupt_detected"] >= 1 and
              srv.stats["respawns"] >= 1,
              f"replica twin {run}: stats {srv.stats}")
        check(restores, f"replica twin {run}: no respawn recorded")
        for rid, step, mgr, pred in restores:
            check(step is not None and pred,
                  f"replica twin {run}: replica {rid} respawned with no "
                  f"checkpoint to restore")
            mgr.verify(step)
            like = {_pred_key(b): rerank.predictor_init(128, DEV)
                    for b in pred}
            tree, _ = mgr.restore(like, step)
            for b, st in pred.items():
                want = tree[_pred_key(b)]
                check(torch.equal(st.ema, want.ema) and
                      torch.equal(st.weight, want.weight),
                      f"replica twin {run}: replica {rid}'s restored "
                      f"predictor differs from checkpoint {step}")
        digests.append(outcome_digest(outcomes))
        twin = {"summary": {k: s[k] for k in (
            "requests", "completed", "failed", "retried", "hedged",
            "p50_ms", "p99_ms", "deadline_met_rate")},
            "fault_stats": dict(sorted(srv.stats.items())),
            "restored": [[rid, step, len(pred)]
                         for rid, step, _, pred in restores],
            "wall_s": wall, "launches": {k: v for k, v in got.items() if v}}
    check(digests[0] == digests[1], f"replica twin digests differ: "
          f"{digests}")
    twin["digest"] = digests[0]
    summary["replica_twin"] = twin
    log(f"[replica-twin] fixed service {REPLICA_SVC * 1e3:.0f} ms, batches "
        f"capped at {REPLICA_MAX_WAIT * 1e3:.0f} ms, tau predictor on: "
        f"digests equal over two card runs ({digests[0]}); p50 "
        f"{twin['summary']['p50_ms']} ms, p99 {twin['summary']['p99_ms']} "
        f"ms (model time); stats {twin['fault_stats']}; restored from "
        f"verified checkpoints (replica, step, buckets) {twin['restored']}; "
        f"launches {twin['launches']}; {card}")

    # (d) phase 5's index on the card and on the CPU
    x5, qs5 = corpus(20_000, 128, 64, seed=SEED + 1)
    pq5 = search.build_pq_index(x5, 128, seed=SEED, device=DEV)
    dev_digests = {}
    for dev, ix in ((DEV, pq5), ("cpu", search.index_to(pq5, "cpu"))):
        ops.reset_launches()
        srv, outcomes, _ = _replica_twin(
            ServingState(ix, device=dev), (qs5.cpu().numpy(), 16), (1000,))
        got = dict(ops.LAUNCHES)
        if dev == DEV:
            launches = {k: launches[k] + got[k] for k in launches}
        check(sv.summarize(outcomes)["conserved"],
              f"replica on phase 5's index ({dev}): lost requests")
        dev_digests[dev] = outcome_digest(outcomes)
    check(dev_digests[DEV] == dev_digests["cpu"],
          f"replica digests differ between the card and the CPU: "
          f"{dev_digests}")
    summary["replica_cpu_card"] = dev_digests
    log(f"[replica-parity] phase 5's index (20,000 x 128, k=1000, "
        f"n_probe=16): the card's digest equals the CPU's "
        f"({dev_digests[DEV]}); {card}")
    summary["replica_launches"] = {k: v for k, v in launches.items() if v}
    log(f"[replica] launches over the phase's runs on the card "
        f"{summary['replica_launches']}")
    return launches


# --------------------------------------------------------------------------
# phase 16: constrained tuning on the card
# --------------------------------------------------------------------------

def tuning_path(summary: dict, card: str, eng, x, qs) -> dict:
    """Phase 16: ``autotune.tune_cell`` on phase 4's IVF+PQ index (k=5000)
    with 32 held-out queries of the corpus's mixture and exact ground truth
    on the card, targets (0.95, 0.9, 0.8), the reference's grid, rounds=2,
    n_starts=2; a ``timed=False`` re-sweep must serialise byte-identically;
    the store, saved to a temporary file and reloaded, must resolve the
    0.95 point through ``SearchEngine.build(tuned=)``.  Then the tuned and
    the hand-default engines on phase 4's 64 queries.  Returns the
    launches of the sweep."""
    import numpy as np
    import torch
    from repro_torch.index import engine
    from repro_torch.kernels import ops
    from repro_torch.tuning import autotune, measure
    from repro_torch.tuning import points as tp
    from repro_torch.data import synthetic
    k = 5000
    x_np = x.cpu().numpy()
    held = synthetic.queries_from(np.random.default_rng(SEED + 16), x_np, 32)
    t0 = time.monotonic()
    gt = measure.ground_truth_ids(x, held, k)
    gt_s = time.monotonic() - t0
    fp = tp.corpus_fingerprint(x_np)
    del x_np
    corpus_meta = {"kind": "clustered", "fingerprint": fp}
    ops.reset_launches()
    t0 = time.monotonic()
    tuned = autotune.tune_cell(eng.index, k, held, gt, corpus=corpus_meta,
                               device=DEV)
    sweep_s = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    again = autotune.tune_cell(eng.index, k, held, gt, corpus=corpus_meta,
                               timed=False, device=DEV)
    canon = tp.canonical_json(tuned["points"])
    check(canon == tp.canonical_json(again["points"]),
          "the timed=False re-sweep serialises differently")
    for p in tuned["points"]:
        check(not p.feasible or p.recall >= p.recall_target,
              f"feasible point {p.name} below its target: {p.recall}")
    rows = [{"knobs": s.knobs.key(), "recall": s.recall,
             "cost_units": s.cost_units,
             "wall_ms": None if s.wall_s is None else s.wall_s * 1e3}
            for s in tuned["samples"]]
    for r in rows:
        log(f"[tune] {r['knobs']}: recall {r['recall']}, cost "
            f"{r['cost_units']}, {r['wall_ms']:.3f} ms per batch of 32 "
            f"(predictive)")
    wall = {r["knobs"]: r["wall_ms"] for r in rows}
    points = [{"target": p.recall_target, "knobs": p.knobs.key(),
               "recall": p.recall, "feasible": p.feasible,
               "cost_units": p.cost_units, "wall_ms": wall[p.knobs.key()]}
              for p in tuned["points"]]
    for p in points:
        log(f"[tune] point @{p['target']}: {p['knobs']}, recall "
            f"{p['recall']}, feasible {p['feasible']}, cost "
            f"{p['cost_units']}, {p['wall_ms']:.3f} ms per batch of 32")
    default = tuned["default"]
    log(f"[tune] hand default {default.knobs.key()}: recall "
        f"{default.recall}, cost {default.cost_units}, "
        f"{default.wall_s * 1e3:.3f} ms per batch of 32 (predictive)")

    path = Path(tempfile.mkdtemp(prefix="chip_smoke_tune_")) / "points.json"
    tp.PointStore(tuned["points"]).save(str(path))
    store = tp.PointStore.load(str(path))
    check(tp.canonical_json(store.points) == canon, "store round trip")
    best = next(p for p in tuned["points"] if p.recall_target == 0.95)
    t_eng = engine.SearchEngine.build(eng.index, k=k, tuned=store,
                                      recall_target=0.95, device=DEV)
    check(t_eng.tuned_from == f"{best.name} (tuned)",
          f"tuned_from {t_eng.tuned_from}, want {best.name}")
    check(t_eng.n_probe == best.knobs.n_probe and
          (best.knobs.n_cand is None or t_eng.n_cand == best.knobs.n_cand),
          "the store's point did not set the engine's knobs")
    batches = [qs[i:i + 32] for i in range(0, 64, 32)]
    for e in (t_eng, eng):
        e.warmup((32,))
    _, tuned_ms = timed_batches(t_eng.search, batches)
    _, hand_ms = timed_batches(eng.search, batches)
    out = {"held_out": 32, "k": k, "ground_truth_s": gt_s,
           "sweep_s": sweep_s, "samples": rows, "points": points,
           "default": {"knobs": default.knobs.key(),
                       "recall": default.recall,
                       "cost_units": default.cost_units,
                       "wall_ms": default.wall_s * 1e3},
           "cost_model": tuned["cost_model"],
           "tuned_from": t_eng.tuned_from,
           "tuned_ms_per_batch": tuned_ms, "hand_ms_per_batch": hand_ms,
           "launches": {k_: v for k_, v in launches.items() if v},
           "card": card}
    summary["tuning"] = out
    log(f"[tune] {len(rows)} configurations in {sweep_s:.1f}s (ground truth "
        f"{gt_s:.1f}s); the 0.95 point resolves as {t_eng.tuned_from}; static "
        f"ms per batch of 32 on phase 4's queries: tuned {tuned_ms}, hand "
        f"default {hand_ms}; cost model {tuned['cost_model']}; launches "
        f"{out['launches']}; {card}")
    return launches


# --------------------------------------------------------------------------
# phase 17: the socket transport (serve --mode net) on the card
# --------------------------------------------------------------------------

# the reference bench's wire schedule (benchmarks/bench_transport.py) and
# its worker SIGKILL at 40% of the trace
NET_WIRE = dict(seed=11, drop=0.02, dup=0.01, slow=0.08, truncate=0.005,
                disconnect=0.005)
NET_CRASH_FRAC, NET_SETTLE, NET_UP_S = 0.4, 60.0, 300.0
NET_ARGS = ["--mode", "net"]        # the JAX CLI's net defaults


NET_KERNELS = ("pq_adc", "l2_exact", "bucket_hist")    # #10, #11, #12


def check_worker_launches(mode: str, launches: dict) -> None:
    """Every kernel of the workers' path launched in the workers of one run
    (their own counts, zeroed after the warm-up, reported on exit)."""
    for k in NET_KERNELS:
        check(launches.get(k, 0) > 0, f"net {mode}: the workers never "
              f"launched {k} ({launches})")


def _net_cli(summary: dict, card: str, tmp: str, n_req: int) -> dict:
    """(a) ``python -m repro_torch.launch.serve --mode net --record
    <tmp> --check-replay`` at the JAX CLI's net defaults, as a process
    group of its own (killed whole on a timeout).  Returns the kernel
    launches its workers reported."""
    import signal
    import torch
    from repro_torch.transport import frames
    from repro_torch.transport.wire import Transcript
    rec = os.path.join(tmp, "net_cli.jsonl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *NET_ARGS,
         "--record", rec, "--check-replay"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
    wall = time.monotonic() - t0
    lines = text.strip().splitlines()
    for line in lines[:-1]:
        if line.startswith("[serve]"):
            log(line)
    check(proc.returncode == 0, f"serve --mode net exited "
          f"{proc.returncode}: {lines[-20:]}")
    out = json.loads(lines[-1])
    check(out["device"] == torch.cuda.get_device_name(0),
          f"serve --mode net ran on {out['device']}")
    check(out["replay_identical"] is True,
          f"serve --mode net: replay digest {out['replay_digest']} != "
          f"{out['outcome_digest']}")
    ends = out["completed"] + out["shed"] + out["failed"] + out["rejected"]
    check(out["conserved"] and out["requests"] == n_req and ends == n_req,
          f"serve --mode net lost requests ({ends} of {out['requests']})")
    tr = Transcript.load(rec)
    ready = {e["wid"]: e["svc"] for e in tr.entries if e.get("ev") == "up"}
    out.update(wall_s=wall, ready_svc=ready, codec=frames.default_codec(),
               card=card)
    check_worker_launches("cli", out["worker_launches"])
    summary["net_cli"] = out
    log(f"[net] serve --mode net at the JAX CLI's defaults (100,000 x 96, "
        f"316 clusters, n_probe 64, k 5000, 4 workers, 200 Zipf requests "
        f"at 200/s, 500 ms, cache 256): p50 {out['p50_ms']} ms, p99 "
        f"{out['p99_ms']} ms, client p99 {out.get('client_p99_ms')} ms, "
        f"completed {out['completed']} (client {out['client_completed']}), "
        f"shed {out['shed']}, failed {out['failed']}, rejected "
        f"{out['rejected']}, replay identical; READY service seconds "
        f"{ready}; codec {out['codec']}; net_stats {out['net_stats']}; "
        f"cache {out['cache']['results']}; wall {wall:.1f}s; workers' "
        f"launches {out['worker_launches']}; {card}")
    return out["worker_launches"]


def _net_run(mode: str, spec: dict, trace, cache: bool, wire=None,
             crash_at: float | None = None) -> dict:
    """One library run of ``MasterServer`` over 4 worker processes on the
    card: the trace through ``NetClient``, with worker 0 SIGKILLed
    ``crash_at`` seconds in (then served on until its respawn reports
    READY).  Returns the client's records, the outcomes, digest, stats,
    transcript, timings and the workers' kernel launches."""
    import threading
    from repro_torch.serving.batcher import k_ceilings
    from repro_torch.serving.router import outcome_digest
    from repro_torch.transport.client import NetClient
    from repro_torch.transport.core import MasterConfig
    from repro_torch.transport.master import MasterServer
    cfg = MasterConfig(n_workers=4, ceilings=k_ceilings(spec["ks"]),
                       cache_size=256 if cache else 0)
    ms = MasterServer(cfg, spec, wire=wire, record=True)
    stop = threading.Event()
    th = threading.Thread(target=lambda: ms.serve(until=stop.is_set),
                          daemon=True)
    killed: list[float] = []
    t0 = time.monotonic()
    try:
        ms.start()
        check(ms.wait_workers(timeout=NET_UP_S), f"net {mode}: workers "
              f"never came up")
        up_s = time.monotonic() - t0
        th.start()
        if crash_at is not None:
            def killer():
                time.sleep(crash_at)
                p = ms.procs.get(0)
                if p is not None and p.poll() is None:
                    killed.append(time.monotonic())
                    p.kill()
            threading.Thread(target=killer, daemon=True).start()
        t1 = time.monotonic()
        with NetClient(ms.addr, timeout=30.0) as c:
            records = c.run_trace(trace, settle=NET_SETTLE)
        wall = time.monotonic() - t1
        if crash_at is not None:
            end = time.monotonic() + NET_UP_S
            while ms.core.stats["respawns"] < 1 and time.monotonic() < end:
                time.sleep(0.1)
    finally:
        stop.set()
        if th.is_alive():
            th.join(timeout=10.0)
        ms.shutdown()
    check(not th.is_alive(), f"net {mode}: the serve loop did not stop")
    outcomes = ms.core.outcome_list()
    respawn_s = None
    ups = [e for e in ms.transcript.entries
           if e.get("ev") == "up" and e.get("respawned")]
    if killed and ups:
        respawn_s = ups[0]["t"] - killed[0]
    return {"records": records, "outcomes": outcomes,
            "digest": outcome_digest(outcomes),
            "stats": dict(ms.core.stats), "cfg": cfg,
            "faults": ms.shim.fault_counts(),
            "transcript": ms.transcript, "up_s": up_s, "wall_s": wall,
            "respawn_s": respawn_s,
            "worker_launches": dict(ms.worker_launches),
            "worker_reports": ms.worker_reports,
            "ready_svc": {e["wid"]: e["svc"] for e in ms.transcript.entries
                          if e.get("ev") == "up"}}


def _net_row(run: dict) -> dict:
    from repro_torch.serving import server as sv
    s = sv.summarize(run["outcomes"])
    lats = sorted(r["latency_s"] for r in run["records"].values()
                  if r["status"] in ("ok", "degraded"))
    pct = (lambda p: None if not lats else
           1e3 * lats[min(len(lats) - 1, int(p * len(lats)))])
    return {"offered": s["requests"], "completed": s["completed"],
            "degraded": sum(o.status == sv.DEGRADED
                            for o in run["outcomes"]),
            "shed": s["shed"], "failed": s["failed"],
            "rejected": s["rejected"], "conserved": bool(s["conserved"]),
            "client_replies": len(run["records"]),
            "client_p50_ms": pct(0.5), "client_p99_ms": pct(0.99),
            "digest": run["digest"],
            "stats": {k: v for k, v in sorted(run["stats"].items()) if v},
            "wire_faults": run["faults"], "workers_up_s": run["up_s"],
            "trace_wall_s": run["wall_s"], "respawn_s": run["respawn_s"],
            "worker_launches": run["worker_launches"],
            "worker_reports": run["worker_reports"]}


def net_serving(summary: dict, card: str, errs: dict) -> dict:
    """Phase 17: the socket transport with its workers on the card.  (a)
    the CLI at the JAX CLI's net defaults, replay identical, 200 requests
    conserved; (b) the same spec and trace (``serve.net_spec_and_trace``)
    through ``MasterServer`` under the reference bench's wire schedule with
    worker 0 SIGKILLed at 40% of the trace: conserved, a respawn, parity
    1.0 against an in-process twin on the card over the non-degraded
    completions; (c) (b)'s transcript replayed in process on the card:
    equal digest, no checksum mismatch; (d) clean runs with the result
    cache off and on: shared completions id-identical, hits above 0.  #10,
    #12 and #11 are held bitwise against their plain versions at this
    path's shapes on the twin's engine.  Returns the launches the workers
    of (a), (b) and (d) reported (each worker zeroes its counts after its
    warm-up); the replay's and the twin's are reported apart."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import faults as flt
    from repro_torch.serving.batcher import bucket_of
    from repro_torch.transport.enginehost import (build_state_from_spec,
                                                  make_exec_fn)
    from repro_torch.transport.replay import replay_transcript
    from repro_torch.transport.wire import Transcript
    args = serve.parse_args(NET_ARGS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_net_") as tmp:
        cli_launches = _net_cli(summary, card, tmp, args.requests)

    spec, trace = serve.net_spec_and_trace(args, args.device)
    span = trace[-1].arrival - trace[0].arrival
    wire = flt.WireSchedule(**NET_WIRE)
    runs = {"fault_free": _net_run("fault_free", spec, trace, cache=False),
            "faulted": _net_run("faulted", spec, trace, cache=False,
                                wire=wire, crash_at=span * NET_CRASH_FRAC),
            "cached": _net_run("cached", spec, trace, cache=True)}
    rows = {mode: _net_row(run) for mode, run in runs.items()}
    for mode, row in rows.items():
        ends = row["completed"] + row["shed"] + row["failed"] + \
            row["rejected"]
        check(row["conserved"] and row["offered"] == len(trace) and
              ends == len(trace), f"net {mode}: lost requests ({row})")
        check_worker_launches(mode, row["worker_launches"])
        log(f"[net-{mode}] {json.dumps(row)}; {card}")
    faulted = runs["faulted"]
    check(faulted["stats"]["respawns"] >= 1,
          f"net faulted: no respawn ({faulted['stats']})")
    launches = {k: cli_launches.get(k, 0) + sum(
        run["worker_launches"].get(k, 0) for run in runs.values())
        for k in ops.LAUNCHES}

    # (b) parity and (c) replay against the in-process twin on the card
    state, ceil = build_state_from_spec(spec)
    exec_fn = make_exec_fn(state, ceil)
    ops.reset_launches()
    t0 = time.monotonic()
    res = replay_transcript(Transcript.loads(faulted["transcript"].dumps()),
                            faulted["cfg"], state.centroids, exec_fn,
                            strict=False)
    replay_s = time.monotonic() - t0
    by_rid = {r.rid: r for r in trace}
    n_checked = n_match = 0
    for rid, rec in faulted["records"].items():
        if rec["status"] != "ok":       # non-degraded completions only
            continue
        req = by_rid[rid]
        _, ids = exec_fn(req.q, req.k, req.n_probe)
        n_checked += 1
        n_match += int(np.array_equal(rec["ids"], ids))
    twin_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(res.digest == faulted["digest"] and not res.checksum_mismatches
          and res.core.stats == faulted["stats"],
          f"net replay: digest {res.digest} vs {faulted['digest']}, "
          f"{len(res.checksum_mismatches)} checksum mismatches")
    check(n_checked > 0 and n_match == n_checked,
          f"net faulted: parity {n_match}/{n_checked} against the twin")

    # #10, #12 and #11 against their plain versions at this path's shapes:
    # the twin's engine for the largest k, the first request at that k
    req = max(trace, key=lambda r: r.k)
    eng = state.engine(bucket_of(req.k, req.n_probe, ceil, 1))
    q = torch.from_numpy(np.asarray(req.q, np.float32)).to(state.device)
    shapes = check_pq_single(pq_single_args(eng, q), errs,
                             f"the net path's shapes (k={eng.k})")

    # (d) the result cache: id-identical on shared completions, hits
    free, cached = runs["fault_free"]["records"], runs["cached"]["records"]
    common = [rid for rid, r in cached.items()
              if r["status"] in ("ok", "degraded") and
              free.get(rid, {}).get("status") in ("ok", "degraded")]
    hits = runs["cached"]["stats"].get("cache_hits", 0)
    check(common and all(np.array_equal(cached[rid]["ids"],
                                        free[rid]["ids"]) for rid in common),
          "net cache: cached and uncached completions differ")
    check(hits > 0, "net cache: no hit")
    p99_free, p99_fault = rows["fault_free"]["client_p99_ms"], \
        rows["faulted"]["client_p99_ms"]
    summary["net"] = {
        "rows": rows, "wire": wire.to_dict(),
        "crash_at_s": span * NET_CRASH_FRAC,
        "respawn_s": faulted["respawn_s"],
        "ready_svc": faulted["ready_svc"],
        "parity": n_match / n_checked, "parity_checked": n_checked,
        "replay_digest": res.digest, "replay_s": replay_s,
        "cache_common": len(common), "cache_hit_rate": hits / len(trace),
        "p99_ratio": (p99_fault / p99_free if p99_free and p99_fault
                      else None),
        "kernel_shapes": shapes,
        "worker_launches": {k: v for k, v in launches.items() if v},
        "twin_launches": twin_launches, "card": card}
    out = summary["net"]
    log(f"[net-faults] wire {out['wire']}, worker 0 SIGKILLed at "
        f"{out['crash_at_s']:.3f}s: respawned READY after "
        f"{out['respawn_s']} s; parity {out['parity']} over {n_checked} "
        f"non-degraded completions against the twin on the card; replay "
        f"digest equal ({res.digest}), 0 checksum mismatches, "
        f"{replay_s:.2f}s; faulted/fault-free client p99 "
        f"{p99_fault} / {p99_free} ms = {out['p99_ratio']} (not gated); "
        f"READY service seconds {out['ready_svc']}; {card}")
    log(f"[net-cache] {len(common)} shared completions id-identical, hit "
        f"rate {out['cache_hit_rate']}; {card}")
    log(f"[net-launches] the workers of (a), (b) and (d): "
        f"{out['worker_launches']}; apart, the replay and the twin in this "
        f"process: {twin_launches}; {card}")
    return launches


# --------------------------------------------------------------------------
# phase 18: the replica tier over the sharded deployment
# --------------------------------------------------------------------------

def replica_sharded(summary: dict, card: str, kind: str = "cuda") -> dict:
    """Phase 18: the replica tier over a ``LockstepState`` on a one-rank
    mesh (NCCL on the card).  (a) ``serve --mode async --replicas 4
    --faults ... --check-parity`` through ``serve_rank`` with ``--shards
    1``: parity 1.0, conserved, a respawn; (b) the library run of phase
    15(c) (fixed service model, tau predictor on, predictor checkpoints)
    over a ``LockstepState``, over the same sharded engines without the
    lock-step protocol, and without a mesh: the first two digests equal;
    against the third the schedule, the assignment log and the stats
    equal, and the id sets overlap by at least ``REPLICA_SHARDED_OVERLAP``
    (its ids are the batched engine's, whose exact distances are summed in
    another order, so near-equal ones trade places, and whose predictor
    works on another pool, so the sets part a little: the reference's own
    sharded and mesh-less runs part the same way,
    ``tests/test_torch_replica_k5000.py``); every request ending once, the
    respawn restoring a checkpoint; (c) a rolling
    swap of the sharded pool onto the same index with 5% of its rows
    tombstoned (the index's tensors go out through the lock-step swap),
    then the trace again: every replica on the new generation, parity 1.0,
    no deleted id served.  Returns the launches of every run."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import batcher as bt
    from repro_torch.serving import lockstep
    from repro_torch.serving import queue as rq
    from repro_torch.serving import server as sv
    from repro_torch.serving.router import ReplicaServer, outcome_digest
    from repro_torch.serving.state import ServingState
    dev = torch.device(DEV, 0) if kind == "cuda" else torch.device("cpu")
    m = mesh(kind)

    def cli():
        args = serve.parse_args(REPLICA_ARGS + ["--shards", "1"])
        out, rc = serve.serve_rank(args, dev)
        print(json.dumps(out))
        return rc

    launches = _async_run(summary, card, "replica_sharded", "replica-sharded",
                          "serve --mode async --replicas 4 --shards 1", cli)
    out = summary["replica_sharded"]
    check(out["shards"] == 1 and out["replicas"] == 4 and
          out["faults"] == REPLICA_FAULTS, "replica-sharded: the summary "
          "names another tier")
    check(out["fault_stats"]["respawns"] >= 1,
          f"replica-sharded: no respawn ({out['fault_stats']})")
    log(f"[replica-sharded] fault stats {out['fault_stats']}; digest "
        f"{out['outcome_digest']}; {card}")

    args = serve.parse_args([])
    x, qs = serve.corpus(args, dev)
    index = serve.build_index(args.method, x, args.n_clusters, args.seed, dev)
    trace_args = (qs.cpu().numpy(), 64)
    runs, twin = {}, {}
    states = {"lock step": lambda: lockstep.LockstepState(
                  index, mesh=m, tau_pred=True),
              "sharded": lambda: ServingState(index, mesh=m, tau_pred=True),
              "no mesh": lambda: ServingState(index, tau_pred=True,
                                              device=dev)}
    for name, make in states.items():
        state = make()
        ops.reset_launches()
        srv, outcomes, restores = _replica_twin(
            state, trace_args, (5000,),
            ckpt_dir=tempfile.mkdtemp(prefix="chip_smoke_replica_"))
        got = dict(ops.LAUNCHES)
        launches = {k: launches[k] + got[k] for k in launches}
        outcomes = sorted(outcomes, key=lambda o: o.request.rid)
        rids = [o.request.rid for o in outcomes]
        check(len(rids) == 64 and len(set(rids)) == 64,
              f"replica-sharded twin ({name}): {len(rids)} outcomes over "
              f"{len(set(rids))} requests")
        check(sv.summarize(outcomes)["conserved"] and
              srv.stats["respawns"] >= 1 and restores and
              all(step is not None and pred
                  for _, step, _, pred in restores),
              f"replica-sharded twin ({name}): stats {srv.stats}, restores "
              f"{[(r, s, len(p)) for r, s, _, p in restores]}")
        runs[name] = {
            "digest": outcome_digest(outcomes),
            "assignments": list(srv.assignments),
            "schedule": [(o.request.rid, o.status, o.replica, o.retries,
                          o.hedged, round(o.t_done, 9), o.k_effective)
                         for o in outcomes],
            "ids": [None if o.ids is None else set(o.ids.tolist())
                    for o in outcomes]}
        twin[name] = {"digest": runs[name]["digest"],
                      "fault_stats": dict(sorted(srv.stats.items())),
                      "restored": [[r, s, len(p)]
                                   for r, s, _, p in restores],
                      "launches": {k: v for k, v in got.items() if v}}
        if name == "lock step":
            state.stop()
    lock, shard, alone = runs["lock step"], runs["sharded"], runs["no mesh"]
    check(lock["digest"] == shard["digest"],
          f"replica-sharded: the lock-step digest {lock['digest']} is not "
          f"the sharded engines' own {shard['digest']}")
    for what in ("assignments", "schedule"):
        check(lock[what] == alone[what],
              f"replica-sharded: the {what} differ from the run without a "
              f"mesh")
    check(twin["lock step"]["fault_stats"] == twin["no mesh"]["fault_stats"],
          "replica-sharded: the stats differ from the run without a mesh")
    overlap = [len(a & b) / max(len(b), 1)
               for a, b in zip(lock["ids"], alone["ids"])
               if a is not None and b is not None]
    twin["id_overlap_vs_no_mesh"] = [min(overlap), sum(overlap) /
                                     len(overlap)]
    check(min(overlap) >= REPLICA_SHARDED_OVERLAP[0] and
          twin["id_overlap_vs_no_mesh"][1] >= REPLICA_SHARDED_OVERLAP[1],
          f"replica-sharded: id-set overlap with the run without a mesh "
          f"{twin['id_overlap_vs_no_mesh']} under the bound "
          f"{list(REPLICA_SHARDED_OVERLAP)}")
    twin["digest_equals_no_mesh"] = lock["digest"] == alone["digest"]
    summary["replica_sharded_twin"] = twin
    log(f"[replica-sharded-twin] tau predictor on, fixed service "
        f"{REPLICA_SVC * 1e3:.0f} ms: over the lock-step protocol the digest "
        f"equals the same sharded engines' without it ({lock['digest']}); "
        f"against the card without a mesh the schedule, assignment log and "
        f"stats are equal, the digest "
        f"{'equal' if twin['digest_equals_no_mesh'] else 'not'} (id-set "
        f"overlap min {min(overlap):.4f}, mean "
        f"{twin['id_overlap_vs_no_mesh'][1]:.4f}, bound "
        f"{list(REPLICA_SHARDED_OVERLAP)}: the sharded engine sums its "
        f"exact distances in another order and predicts on its own pool, "
        f"as the reference's does); every request ended once; stats "
        f"{twin['lock step']['fault_stats']}; restored (replica, step, "
        f"buckets) {twin['lock step']['restored']}; {card}")

    # (c) a rolling swap of the sharded pool, then the trace again
    state = lockstep.LockstepState(index, mesh=m)
    srv = ReplicaServer(state, 4, ceilings=bt.k_ceilings((5000,)), batch=16,
                        service_time_fn=lambda b: REPLICA_SVC,
                        max_wait=REPLICA_MAX_WAIT, hb_interval=0.02,
                        respawn_delay=0.05)
    trace = rq.make_trace(np.random.default_rng(SEED), trace_args[0],
                          (5000,), rate=200.0, deadline=0.5, n_probe=64,
                          recall_target=0.95)
    ops.reset_launches()
    srv.run_trace(trace)
    n = x.shape[0]
    live = np.ones(n, bool)
    live[np.random.default_rng(SEED).choice(n, n // 20, replace=False)] = \
        False
    t0 = time.monotonic()
    srv.pool.rolling_swap(index, live=live,
                          warm_buckets=srv._trace_buckets(trace))
    swap_s = time.monotonic() - t0
    after = srv.run_trace(trace, warmup=False)
    parity, n_checked = sv.parity_vs_direct(state, after)
    state.stop()
    got = dict(ops.LAUNCHES)
    launches = {k: launches[k] + got[k] for k in launches}
    served = np.concatenate([o.ids for o in after if o.ids is not None])
    check([r.generation for r in srv.pool] == [1] * 4,
          "replica-sharded swap: a replica stayed on the old generation")
    check(parity == 1.0 and n_checked > 0,
          f"replica-sharded swap: parity {parity} over {n_checked}")
    check(bool(live[served].all()), "replica-sharded swap: a deleted id "
          "was served")
    summary["replica_sharded_swap"] = {
        "parity": parity, "checked": n_checked, "swap_s": swap_s,
        "launches": {k: v for k, v in got.items() if v}}
    log(f"[replica-sharded-swap] rolling swap onto the index with "
        f"{n // 20} rows tombstoned in {swap_s:.2f}s; parity {parity} over "
        f"{n_checked}, 0 deleted ids served; {card}")
    return launches


# --------------------------------------------------------------------------
# phase 19: the model substrate and the retrieval pipeline
# --------------------------------------------------------------------------

LM_B, LM_PROMPT, LM_STEPS = 4, 128, 16
SMOKE_TOL = 1e-4


def lm_decode(summary: dict, card: str) -> None:
    """Phase 19(a): the full-width ``smollm-135m`` in bf16, random weights
    from a seeded ``torch.Generator``: a prefill of B=4 x 128 tokens that
    fills the caches, then 16 decode steps.  Each step's logits (and the
    prefill's last) must equal ``forward``'s at that position within the
    bf16 bound: twice what bf16 itself costs there (``forward`` in bf16
    against ``forward`` on the same weights in fp32), and no less than
    2^-4.  The same in fp32 must agree within 1e-3."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import model as model_mod
    cfg = configs.get("smollm-135m")
    m = model_mod.build(cfg)
    # the model's own memory: earlier phases' tensors are still held, and
    # those left in reference cycles are freed first, so that none is
    # freed under the measurement
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = m.init(torch.Generator().manual_seed(SEED), device=DEV)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_B, LM_PROMPT + LM_STEPS))).to(DEV)
    pos = torch.zeros(LM_B, dtype=torch.long, device=DEV)

    def serve(model, p):
        """Prefill then decode; the logits of each position, stacked."""
        caches = model.init_caches(LM_B, LM_PROMPT + LM_STEPS, device=DEV)
        last, caches = model.prefill_caches(
            p, {"tokens": tokens[:, :LM_PROMPT]}, caches)
        outs = [last]
        for i in range(LM_STEPS):
            logits, caches = model.decode_step(p, {
                "token": tokens[:, LM_PROMPT + i],
                "pos": pos + LM_PROMPT + i}, caches)
            outs.append(logits)
        return torch.stack(outs, dim=1).float()

    with torch.inference_mode():
        got = serve(m, params)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        full = m.forward(params, {"tokens": tokens}).float()
        want = full[:, LM_PROMPT - 1:]
        prefill_ms = cuda_ms(lambda: m.prefill_caches(
            params, {"tokens": tokens[:, :LM_PROMPT]},
            m.init_caches(LM_B, LM_PROMPT + LM_STEPS, device=DEV)), reps=5)
        total_ms = cuda_ms(lambda: serve(m, params), reps=3)
        # the same weights in fp32
        m32 = model_mod.build(dataclasses.replace(cfg, dtype=torch.float32))
        p32 = m32.init(None, device=DEV)
        for a, b in zip(params.parameters(), p32.parameters()):
            b.data.copy_(a.float())
        full32 = m32.forward(p32, {"tokens": tokens}).float()
        got32 = serve(m32, p32)
    err = (got - want).abs().amax(dim=(0, 2)).tolist()
    bf16_cost = float((full - full32).abs().max())
    bound = max(2 * bf16_cost, 2.0 ** -4)
    err32 = float((got32 - full32[:, LM_PROMPT - 1:]).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    decode_ms = (total_ms - prefill_ms) / LM_STEPS
    out = {"params": model_mod.param_count(params), "dtype": "bfloat16",
           "batch": LM_B, "prompt": LM_PROMPT, "steps": LM_STEPS,
           "max_abs_err_by_step": err, "bound": bound,
           "bf16_vs_fp32": bf16_cost, "fp32_max_abs_err": err32,
           "argmax_agree": agree, "prefill_ms": prefill_ms,
           "decode_ms_per_token": decode_ms, "peak_mib": peak / 2 ** 20,
           "param_mib": sum(p.numel() * p.element_size()
                            for p in params.parameters()) / 2 ** 20,
           "card": card}
    summary["lm_decode"] = out
    log(f"[lm] {cfg.arch_id} full width ({cfg.n_layers} layers, "
        f"d={cfg.d_model}, vocab {cfg.vocab}), bf16, {out['params']:,} "
        f"parameters: prefill B={LM_B} x "
        f"{LM_PROMPT} in {prefill_ms:.3f} ms, {decode_ms:.3f} ms per decoded "
        f"token (B={LM_B}), peak {out['peak_mib']:.1f} MiB over the "
        f"weights, caches and activations (weights {out['param_mib']:.1f} "
        f"MiB); decode vs "
        f"forward max |d logit| {max(err):.5f} (bound {bound:.5f} = max(2 x "
        f"bf16's own cost {bf16_cost:.5f}, 2^-4)), argmax agreement "
        f"{agree:.4f}; fp32 {err32:.2e} (bound 1e-3); {card}")
    check(max(err) <= bound, f"lm: decode differs from forward by "
          f"{max(err)} > {bound} (by step {err})")
    check(err32 <= 1e-3, f"lm: fp32 decode differs from forward by {err32}")


def smoke_configs_on_card(summary: dict, card: str) -> None:
    """Phase 19(b): the ten ``smoke()`` configs in fp32 (TF32 off) on the
    same weights on the card and on the CPU: forward, prefill and one
    decode step within rtol=atol=1e-4."""
    import copy
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import encdec
    from repro_torch.models import model as model_mod
    rows = {}
    for arch in configs.ARCHS:
        cfg = configs.get(arch, smoke=True)
        m = model_mod.build(cfg)
        cpu = m.init(torch.Generator().manual_seed(SEED), device="cpu")
        gpu = copy.deepcopy(cpu).to(DEV)
        rng = np.random.default_rng(SEED)
        batch = {"tokens": rng.integers(0, cfg.vocab, (2, 32))}
        if cfg.family == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (2, cfg.n_patches, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (2, cfg.n_frames, cfg.d_model)).astype(np.float32)
        step = {"token": rng.integers(0, cfg.vocab, (2,)),
                "pos": np.array([0, 1])}
        res = {}
        for dev, p in (("cpu", cpu), (DEV, gpu)):
            b = {k: torch.from_numpy(np.array(v)).to(dev)
                 for k, v in batch.items()}
            s = {k: torch.from_numpy(np.array(v)).to(dev)
                 for k, v in step.items()}
            with torch.inference_mode():
                if cfg.family == "encdec":
                    s["enc_out"] = encdec.encode(p, cfg, b["frames"])
                logits, caches = m.decode_step(
                    p, s, m.init_caches(2, 8, device=dev))
                res[dev] = [m.forward(p, b), m.prefill(p, b), logits,
                            *caches.values()]
        errs = []
        for a, b in zip(res["cpu"], res[DEV]):
            b = b.cpu().float()
            a = a.float()
            errs.append(float((a - b).abs().max()))
            check(bool(torch.allclose(b, a, rtol=SMOKE_TOL, atol=SMOKE_TOL)),
                  f"{arch}: the card differs from the CPU by {errs[-1]}")
        rows[arch] = max(errs)
    summary["smoke_configs"] = rows
    log(f"[lm-smoke] ten smoke configs, fp32: the card equals the CPU "
        f"(forward, prefill, one decode step and its caches) within "
        f"rtol=atol=1e-4; max |d| by arch "
        f"{ {k: float(f'{v:.3g}') for k, v in rows.items()} }; {card}")


def retrieval(summary: dict, card: str) -> dict:
    """Phase 19(c): ``examples/torch_serve_retrieval.py`` at its defaults
    on the card (the full-width ``smollm-135m`` encoder, 20,000 documents,
    IVF+RaBitQ over 141 clusters, k=1000, n_probe=100, 4 queries).  Its
    recall@1000 is printed; the RaBitQ kernels the engine takes must show
    launches.  Returns the run's launches."""
    import importlib.util
    import torch
    from repro_torch.kernels import ops
    spec = importlib.util.spec_from_file_location(
        "torch_serve_retrieval", ROOT / "examples" / "torch_serve_retrieval.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    ops.reset_launches()
    out = example.run([])
    launches = dict(ops.LAUNCHES)
    check(out["device"] == torch.cuda.get_device_name(0),
          f"retrieval ran on {out['device']}")
    check(out["launches"] == {k: v for k, v in launches.items() if v},
          "retrieval: the example's launches are not the counters'")
    rq_kernels = ("fused_rabitq_scan_batch", "rabitq_est")
    check(any(launches[k] > 0 for k in rq_kernels),
          f"retrieval: no RaBitQ kernel launched ({out['launches']})")
    out["card"] = card
    summary["retrieval"] = out
    log(f"[retrieval] {out['arch']} (d={out['d_model']}, {out['dtype']}, "
        f"{out['params']:,} parameters) over {out['n_docs']:,} documents: "
        f"recall@{out['k']} {out['recall_at_k']:.4f}, n_reranked "
        f"{out['n_reranked']}, corpus embedding {out['embed_ms']:.1f} ms, "
        f"queries {out['query_embed_ms']:.2f} ms, search "
        f"{out['search_ms']:.3f} ms; launches {out['launches']}; {card}")
    return launches


# --------------------------------------------------------------------------
# phase 20: the training path
# --------------------------------------------------------------------------

# 20(a): full-width smollm-135m in bf16, one loss chunk of B x S tokens
TRAIN_KW = dict(arch="smollm-135m", smoke=False, batch=8, seq=1024,
                steps=30, ckpt_every=10)
TRAIN_FAIL_AT = 25
# 20(b): tests/test_torch_train_step.py's optimizer (eps 1e-4 bounds the
# first step's sensitivity to gradient rounding: lr x |dg| / eps)
SMOKE_OPT = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10, eps=1e-4)


def _dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def train_full(summary: dict, card: str) -> None:
    """Phase 20(a): ``launch.train`` on the full-width ``smollm-135m``
    (bf16, ``remat``, seeded init) over ``TokenPipeline`` batches of
    B=8 x S=1024: 30 steps with a checkpoint every 10, then the same run
    through ``run_with_restarts`` with a failure injected at step 25 (a
    restart from the step-21 checkpoint).  The runs' final losses must
    agree within rtol 1e-5 (bitwise equality is reported), the loss must
    fall (mean of the last five steps under the first five's) and every
    step must be finite.  Reports ms per step (median of steps 5-29; each
    step ends in the loss's read-back, so the card is synchronised),
    tokens/s, model FLOPs (6 N D) and the analytic step FLOPs per second
    and their share of the H100's bf16 peak, the peak memory over what
    earlier phases hold, and the seconds to restore, write and verify one
    checkpoint of the run's state."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import roofline
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as model_mod
    from repro_torch.optim import adamw
    kw = dict(TRAIN_KW, device=DEV)
    cfg = configs.get(kw["arch"], smoke=kw["smoke"])
    b, s, steps = kw["batch"], kw["seq"], kw["steps"]
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.monotonic()
        run1 = train_mod.train(ckpt_dir=f"{tmp}/straight", **kw)
        run1_s = time.monotonic() - t0
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        ckpt_bytes = _dir_bytes(f"{tmp}/straight") / 3     # keep_last=3
        shutil.rmtree(f"{tmp}/straight")
        t0 = time.monotonic()
        run2 = train_mod.run_with_restarts(ckpt_dir=f"{tmp}/restarted",
                                           fail_at=TRAIN_FAIL_AT, **kw)
        run2_s = time.monotonic() - t0
        # one checkpoint of the run's state: restore run 2's last (its
        # checksums verified first), write it again, verify the copy
        params = model_mod.build(cfg).init(None, device=DEV)
        t0 = time.monotonic()
        params, opt_state, at = train_mod.restore_checkpoint(
            CheckpointManager(f"{tmp}/restarted"), params,
            adamw.init(params))
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        mgr = CheckpointManager(f"{tmp}/copy")
        t0 = time.monotonic()
        mgr.save(at, train_mod.checkpoint_tree(params, opt_state), wait=True)
        write_s = time.monotonic() - t0
        t0 = time.monotonic()
        mgr.verify(at)
        verify_s = time.monotonic() - t0
        del params, opt_state
    resumed = run1["losses"][run2["start"]:]
    bitwise = run1["final_loss"] == run2["final_loss"]
    n_bitwise = sum(a == b_ for a, b_ in zip(resumed, run2["losses"]))
    first, last = (float(np.mean(run1["losses"][:5])),
                   float(np.mean(run1["losses"][-5:])))
    step_ms = 1e3 * float(np.median(run1["step_times"][5:]))
    mflops = roofline.model_flops(cfg, "train", s, b)
    aflops = roofline.analytic_flops(cfg, "train", s, b)
    n_params = model_mod.param_count(model_mod.build(cfg).init(
        device="meta"))
    dtype = str(cfg.dtype).removeprefix("torch.")
    out = {"arch": cfg.arch_id, "params": n_params,
           "dtype": dtype, "remat": cfg.remat, "batch": b, "seq": s,
           "steps": steps, "losses": run1["losses"],
           "restarted_losses": run2["losses"], "start": run2["start"],
           "final_loss": run1["final_loss"],
           "restarted_final_loss": run2["final_loss"],
           "restart_bitwise": bitwise,
           "resumed_steps_bitwise": f"{n_bitwise}/{len(resumed)}",
           "ms_per_step": step_ms, "first_step_ms":
               1e3 * run1["step_times"][0],
           "tokens_per_s": b * s / (step_ms * 1e-3),
           "model_flops": mflops, "analytic_flops": aflops,
           "model_flops_per_s": mflops / (step_ms * 1e-3),
           "analytic_flops_per_s": aflops / (step_ms * 1e-3),
           "model_flops_share": mflops / (step_ms * 1e-3)
           / roofline.PEAK_FLOPS,
           "analytic_flops_share": aflops / (step_ms * 1e-3)
           / roofline.PEAK_FLOPS,
           "peak_mib": peak / 2 ** 20, "ckpt_mib": ckpt_bytes / 2 ** 20,
           "restore_s": restore_s, "write_s": write_s, "verify_s": verify_s,
           "run_s": [run1_s, run2_s], "card": card}
    summary["train"] = out
    log(f"[train] {cfg.arch_id} full width ({cfg.n_layers} layers, d="
        f"{cfg.d_model}, vocab {cfg.vocab}), {dtype}, remat {cfg.remat}, "
        f"{n_params:,} "
        f"parameters, B={b} x S={s}: {step_ms:.2f} ms per step (median "
        f"of steps 5-{steps - 1}; first step {out['first_step_ms']:.0f} ms), "
        f"{out['tokens_per_s']:,.0f} tokens/s, model FLOPs "
        f"{mflops:.4g} a step = {out['model_flops_per_s'] / 1e12:.1f} "
        f"TFLOP/s ({100 * out['model_flops_share']:.2f}% of the 989 TFLOP/s "
        f"bf16 peak), analytic {aflops:.4g} = "
        f"{out['analytic_flops_per_s'] / 1e12:.1f} TFLOP/s "
        f"({100 * out['analytic_flops_share']:.2f}%); peak "
        f"{out['peak_mib']:.1f} MiB over earlier phases; {card}")
    log(f"[train-restart] loss {first:.4f} (steps 0-4) -> {last:.4f} (steps "
        f"{steps - 5}-{steps - 1}); failure at {TRAIN_FAIL_AT}, resumed at "
        f"{run2['start']}: final {run1['final_loss']!r} straight, "
        f"{run2['final_loss']!r} restarted, bitwise {bitwise} "
        f"({n_bitwise}/{len(resumed)} resumed steps bitwise); checkpoint "
        f"{out['ckpt_mib']:.1f} MiB: restore {restore_s:.2f} s, write "
        f"{write_s:.2f} s, verify {verify_s:.2f} s; runs {run1_s:.1f} s / "
        f"{run2_s:.1f} s")
    check(run2["start"] > 0, "train: the restarted run did not resume")
    check(all(np.isfinite(run1["losses"] + run2["losses"])),
          "train: a step's loss is not finite")
    check(bool(np.isclose(run2["final_loss"], run1["final_loss"],
                          rtol=1e-5, atol=0)),
          f"train: restarted final loss {run2['final_loss']} against "
          f"{run1['final_loss']}")
    check(last < first, f"train: the loss did not fall ({first} -> {last})")


def smoke_train_on_card(summary: dict, card: str) -> None:
    """Phase 20(b): the ten ``smoke()`` configs in fp32 (TF32 off), seeded
    weights, ``tests/test_arch_smoke.py``'s batch at B=4 x 32: one
    ``make_train_step`` on the card equals the same step on the CPU, and
    two microbatches on the card equal one, within rtol=atol=1e-4 on the
    loss, ``grad_norm`` and every updated parameter."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import model as model_mod
    from repro_torch.optim import adamw
    rows = {}
    for arch in configs.ARCHS:
        cfg = configs.get(arch, smoke=True)
        m = model_mod.build(cfg)
        rng = np.random.default_rng(SEED)
        batch = {"tokens": rng.integers(0, cfg.vocab, (4, 32)),
                 "targets": rng.integers(0, cfg.vocab, (4, 32))}
        if cfg.family == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (4, cfg.n_patches, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (4, cfg.n_frames, cfg.d_model)).astype(np.float32)

        def step(dev, mb):
            p = m.init(torch.Generator().manual_seed(SEED), device=dev)
            b = {k: torch.from_numpy(np.array(v)).to(dev)
                 for k, v in batch.items()}
            fn = model_mod.make_train_step(m, adamw.AdamWConfig(**SMOKE_OPT),
                                           mb)
            p, _, met = fn(p, adamw.init(p), b)
            return ([met[k].float().cpu() for k in ("loss", "grad_norm",
                                                    "lr")]
                    + [t.detach().float().cpu() for t in p.parameters()])

        cpu, gpu, gpu2 = step("cpu", 1), step(DEV, 1), step(DEV, 2)
        errs = []
        for what, got in (("card vs CPU", gpu), ("2 microbatches", gpu2)):
            for a, g in zip(cpu if what == "card vs CPU" else gpu, got):
                errs.append(float((a - g).abs().max()))
                check(bool(torch.allclose(g, a, rtol=SMOKE_TOL,
                                          atol=SMOKE_TOL)),
                      f"{arch} train step, {what}: differs by {errs[-1]}")
        rows[arch] = max(errs)
    summary["smoke_train"] = rows
    log(f"[train-smoke] ten smoke configs, fp32: one train step on the card "
        f"equals the CPU's, and two microbatches equal one, within "
        f"rtol=atol=1e-4 (loss, grad_norm, lr, every updated parameter); "
        f"max |d| by arch { {k: float(f'{v:.3g}') for k, v in rows.items()} }"
        f"; {card}")


def train_example(summary: dict, card: str) -> None:
    """Phase 20(c): ``examples/torch_train_lm.py`` at its defaults on the
    card (smoke ``smollm-135m``, 60 steps of 8 x 64 tokens, a checkpoint
    every 20): a finite final loss below the first step's."""
    import importlib.util
    import math
    import torch
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.run([])
    check(out["device"] == torch.cuda.get_device_name(0),
          f"train example ran on {out['device']}")
    check(math.isfinite(out["final_loss"])
          and out["final_loss"] < out["first_loss"],
          f"train example: loss {out['first_loss']} -> {out['final_loss']}")
    summary["train_example"] = out
    log(f"[train-example] examples/torch_train_lm.py: loss "
        f"{out['first_loss']:.4f} -> {out['final_loss']:.4f}; {card}")


# --------------------------------------------------------------------------
# phase 21: the mesh and the sharding constraint, the dry run, the examples
# --------------------------------------------------------------------------

# 21(c): the dry-run cells held here (the whole matrix runs on the CPU)
DRY_CELLS = [("smollm-135m", "train_4k"), ("smollm-135m", "prefill_32k"),
             ("smollm-135m", "decode_32k"), ("smollm-135m", "long_500k"),
             ("granite-moe-1b-a400m", "train_4k")]


def _dry_cell(job: tuple) -> dict:
    """One dry-run cell in a spawned process (a fake group of its own; no
    card): ``(arch, shape name, mesh shape or None, shape or None,
    microbatches)``."""
    import math
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    arch, shape_name, mesh_shape, shape, n_mb = job
    ops.reset_launches()
    torch.set_num_threads(1)
    dryrun.fake_world()
    mesh = None
    if mesh_shape is not None:
        mesh = DeviceMesh("cpu", torch.arange(math.prod(mesh_shape))
                          .reshape(mesh_shape),
                          mesh_dim_names=("data", "model"))
    t0 = time.monotonic()
    out = dryrun.run_cell(arch, shape_name, mesh=mesh, shape=shape,
                          n_microbatches=n_mb)
    out["wall_s"] = time.monotonic() - t0
    out["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
    return out


def _allocated(tensors) -> int:
    """Bytes of the card's storages behind ``tensors`` (a DTensor's local
    shard), each storage once."""
    from torch.distributed.tensor import DTensor
    seen = {}
    for t in tensors:
        t = t.to_local() if isinstance(t, DTensor) else t
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def mesh_step(summary: dict, card: str) -> dict:
    """Phase 21(a): one train step of phase 20's model and batch
    (full-width bf16 ``smollm-135m`` with ``remat``, B=8 x S=1024, one
    microbatch, seeded weights) on a one-rank NCCL ``DeviceMesh`` (1, 1)
    ("data", "model"): parameters, optimizer state and batch as DTensors
    placed by ``launch/mesh.py``'s specs, ``shard.constrain`` active.  Its
    loss, grad_norm, lr and every updated parameter must equal the same
    step without a mesh bitwise; then three more steps of each, in turns,
    timed (host clock, each ending in the loss's read-back).  None of the
    twelve search kernels may launch in any of these steps (the counts are
    zeroed first and read after).  Returns the card's bytes of the mesh
    step's parameters, optimizer state and batch and the step's peak
    memory over them."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models import sharding as shard
    from repro_torch.optim import adamw
    ops.reset_launches()
    mesh("cuda")                 # the one-rank NCCL default group
    torch.cuda.set_device(0)
    dmesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                       mesh_dim_names=("data", "model"))
    cfg = configs.get(TRAIN_KW["arch"], smoke=TRAIN_KW["smoke"])
    b, s = TRAIN_KW["batch"], TRAIN_KW["seq"]
    m = model_mod.build(cfg)
    step = model_mod.make_train_step(m, adamw.AdamWConfig(
        warmup_steps=10, total_steps=TRAIN_KW["steps"]))
    batch_np = TokenPipeline(cfg.vocab, b, s, seed=SEED).batch_at(0)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in batch_np.items()}

    plain = [m.init(torch.Generator().manual_seed(SEED), device=DEV)]
    plain.append(adamw.init(plain[0]))
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    p = m.init(torch.Generator().manual_seed(SEED), device=DEV)
    specs = mesh_mod.param_specs(p, cfg, dmesh)
    o = mesh_mod.distribute_opt_state(adamw.init(p), specs, dmesh)
    mesh_mod.distribute_params(p, specs, dmesh)
    db = mesh_mod.distribute_batch(
        batch, mesh_mod.batch_specs(cfg, dmesh, b, "train"), dmesh)
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    args_bytes = _allocated(list(p.parameters()) + [o.step]
                            + list(o.m.values()) + list(o.v.values())
                            + list(db.values()))
    sharded = [p, o]

    def plain_step():
        plain[0], plain[1], met = step(plain[0], plain[1], batch)
        return met

    def mesh_step_():
        with shard.use_mesh(dmesh):
            sharded[0], sharded[1], met = step(sharded[0], sharded[1], db)
        return {k: v.full_tensor() if isinstance(v, DTensor) else v
                for k, v in met.items()}

    want = plain_step()
    torch.cuda.reset_peak_memory_stats()
    got = mesh_step_()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    diffs = {k: float((want[k].float() - got[k].float()).abs().max())
             for k in ("loss", "grad_norm", "lr")}
    same = all(torch.equal(want[k], got[k]) for k in want)
    n_same = 0
    for (name, a), (_, g) in zip(plain[0].named_parameters(),
                                 sharded[0].named_parameters()):
        g = g.full_tensor()
        n_same += bool(torch.equal(a, g))
        diffs[name] = float((a.float() - g.float()).abs().max())
    n_params = len(diffs) - 3
    times = {"plain": [], "mesh": []}
    for _ in range(3):
        for name, fn in (("plain", plain_step), ("mesh", mesh_step_)):
            t0 = time.monotonic()
            float(fn()["loss"])
            times[name].append(1e3 * (time.monotonic() - t0))
    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
    out = {"loss": float(want["loss"]), "metrics_bitwise": same,
           "params_bitwise": f"{n_same}/{n_params}",
           "max_abs_diff": max(diffs.values()),
           "plain_ms": times["plain"], "mesh_ms": times["mesh"],
           "args_bytes": args_bytes,
           "args_allocated_delta": held - before,
           "peak_bytes": peak, "launches": launched, "card": card}
    summary["mesh_step"] = out
    log(f"[mesh-step] {cfg.arch_id} full width, B={b} x S={s}, one train "
        f"step on a one-rank NCCL DeviceMesh (1, 1) against the same step "
        f"without a mesh: loss {out['loss']!r}, metrics bitwise {same}, "
        f"parameters bitwise {n_same}/{n_params}, max |d| "
        f"{out['max_abs_diff']}; ms per step (3 each, in turns) plain "
        f"{[round(t, 2) for t in times['plain']]}, mesh "
        f"{[round(t, 2) for t in times['mesh']]}; card bytes of the "
        f"parameters, optimizer state and batch {args_bytes:,} "
        f"(memory_allocated delta {held - before:,}), step peak "
        f"{peak:,} over them; search kernel launches over the steps: "
        f"{launched or 'none'}; {card}")
    check(not launched, f"mesh step launched search kernels: {launched}")
    check(same and n_same == n_params,
          f"mesh step: not bitwise equal to the mesh-less step ({diffs})")
    del plain, sharded, p, o, db
    gc.collect()
    return out


def dry_run_cells(summary: dict, card: str, pool_result, step: dict) -> None:
    """Phase 21(b) and (c): the dry-run records the spawned processes
    made.  (b) phase 21(a)'s cell at mesh (1, 1) on meta, one microbatch:
    its argument bytes must equal the card's bytes of (a)'s parameters,
    optimizer state and batch; its temporary bytes are printed beside
    (a)'s peak, with the ratio, not gated.  (c) ``DRY_CELLS`` on the
    single-pod mesh: each must be ``ok`` (``long_500k`` of a full-attention
    arch ``skip``, as the reference's); the dense prefill cell's counted
    FLOPs must equal ``roofline.analytic_flops``; every cell's roofline
    terms, collective bytes, counted/analytic ratio and rank 0's FLOPs
    over the even share are printed.  No cell may launch a search kernel
    (each process zeroes the counts before its cell)."""
    recs = pool_result.get(timeout=900)
    one, cells = recs[0], recs[1:]
    check(one["status"] == "ok", f"dry run at mesh (1, 1): {one}")
    for r in recs:
        check(not r["launches"], f"dry run {r['arch']} x {r['shape']} "
              f"launched search kernels: {r['launches']}")
    mem = one["memory"]
    summary["dry_run_one"] = one
    log(f"[dryrun-1x1] smollm-135m train B={TRAIN_KW['batch']} x "
        f"S={TRAIN_KW['seq']}, mesh (1, 1), meta: arguments "
        f"{mem['argument_size_in_bytes']:,} bytes (card: "
        f"{step['args_bytes']:,}), temp {mem['temp_size_in_bytes']:,} "
        f"(card peak over the arguments {step['peak_bytes']:,}, ratio "
        f"{mem['temp_size_in_bytes'] / max(step['peak_bytes'], 1):.4f}); "
        f"{one['wall_s']:.1f} s; {card}")
    check(mem["argument_size_in_bytes"] == step["args_bytes"],
          f"dry run arguments {mem['argument_size_in_bytes']} bytes, the "
          f"card's {step['args_bytes']}")
    rows = []
    for (arch, shape), r in zip(DRY_CELLS, cells):
        want = ("skip" if shape == "long_500k" and arch == "smollm-135m"
                else "ok")
        check(r["status"] == want, f"dry run {arch} x {shape}: {r}")
        if r["status"] != "ok":
            log(f"[dryrun] {arch} x {shape} x single: skip ({r['reason']})")
            rows.append(r)
            continue
        rf, mem = r["roofline"], r["memory"]
        if (arch, shape) == ("smollm-135m", "prefill_32k"):
            check(rf["counted_over_analytic"] == 1.0,
                  f"dry run {arch} x {shape}: counted FLOPs "
                  f"{rf['counted_flops_global']} against analytic "
                  f"{rf['analytic_flops_per_chip'] * r['n_chips']}")
        log(f"[dryrun] {arch} x {shape} x single ({r['n_chips']} ranks): "
            f"compute {rf['compute_s']:.6g} s, memory {rf['memory_s']:.6g} "
            f"s, collective {rf['collective_s']:.6g} s -> "
            f"{rf['dominant']}; counted/analytic FLOPs "
            f"{rf['counted_over_analytic']:.6f}, rank 0 over the even share "
            f"{rf['local_over_even_share']:.4f}; collective bytes per chip "
            f"{rf['collective_bytes_per_chip']:,.0f} "
            f"{rf['collective_breakdown']} ops {rf['collective_op_counts']}; "
            f"args {mem['argument_size_in_bytes']:,} temp "
            f"{mem['temp_size_in_bytes']:,} bytes (fits 80 GB "
            f"{mem['fits_hbm']}); launches {r['launches'] or 'none'}; "
            f"{r['wall_s']:.1f} s")
        rows.append(r)
    summary["dry_run"] = rows


def example_runs(summary: dict, card: str) -> dict:
    """Phase 21(d): ``examples/torch_quickstart.py`` (recall@2000 >= 0.95
    on each query; it must launch #10, #11 and #12) and
    ``examples/torch_distributed_search.py`` on the one-rank NCCL group
    (overlap 1.0 with the single engine, the reference's cost-model bytes
    36743 and 112000; it must launch #2 and #6 for the sharded engine and
    #1 for the single one).  Returns the two runs' launches."""
    import importlib.util
    import torch
    from repro_torch.kernels import ops
    launches = {k: 0 for k in ops.LAUNCHES}
    for name, needs in (("torch_quickstart", ("pq_adc", "l2_exact",
                                              "bucket_hist")),
                        ("torch_distributed_search", (
                            "pq_adc_batch", "shard_collect_batch",
                            "fused_scan_batch"))):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        ops.reset_launches()
        t0 = time.monotonic()
        out = example.run([])
        out["seconds"] = time.monotonic() - t0
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        launches = {k: launches[k] + ops.LAUNCHES[k] for k in launches}
        check(out["device"] == torch.cuda.get_device_name(0),
              f"{name} ran on {out['device']}")
        for k in needs:
            check(got.get(k, 0) > 0, f"{name}: kernel {k} never launched "
                  f"({got})")
        out["launches"] = got
        summary[name] = out
        if name == "torch_quickstart":
            rec = [q["recall"] for q in out["queries"]]
            log(f"[example] {name}: recall@{out['k']} {rec}, second pass "
                f"{[q['n_second_pass'] for q in out['queries']]}; "
                f"{out['seconds']:.1f} s; launches {got}; {card}")
            check(min(rec) >= 0.95, f"{name}: recall {rec}")
        else:
            log(f"[example] {name}: {out['ranks']} rank(s), id-set overlap "
                f"{out['overlap']:.4f}, cost model ({out['cost_shards']} "
                f"shards) {out['ratio']:.1f}x less on the wire "
                f"({out['bbc_bytes_per_link']:.0f} vs "
                f"{out['naive_bytes_per_link']:.0f} bytes/link per query); "
                f"{out['seconds']:.1f} s; launches {got}; {card}")
            check(out["overlap"] == 1.0, f"{name}: overlap {out['overlap']}")
            check((out["bbc_bytes_per_link"], out["naive_bytes_per_link"])
                  == (36743.0, 112000),
                  f"{name}: cost model {out['bbc_bytes_per_link']} / "
                  f"{out['naive_bytes_per_link']}")
    return launches


def phase21(summary: dict, card: str) -> dict:
    """Phase 21: (a) first, alone; then the dry-run cells of (b) and (c)
    in spawned processes on the host's cores while (d) runs the examples
    on the card; then (b) and (c) are read.  Returns (d)'s launches."""
    import multiprocessing
    t0 = time.monotonic()
    step = mesh_step(summary, card)
    one = ("smollm-135m", "train_4k", (1, 1),
           dict(mode="train", seq=TRAIN_KW["seq"], batch=TRAIN_KW["batch"]),
           1)
    jobs = [one] + [(a, s_, None, None, 8) for a, s_ in DRY_CELLS]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(len(jobs)) as pool:
        result = pool.map_async(_dry_cell, jobs, chunksize=1)
        launches = example_runs(summary, card)
        dry_run_cells(summary, card, result, step)
    summary["phase21_s"] = time.monotonic() - t0
    log(f"[phase21] {summary['phase21_s']:.1f} s")
    return launches


# --------------------------------------------------------------------------
# phase 11: the mesh-sharded deployment
# --------------------------------------------------------------------------

_MESHES: dict = {}


def mesh(kind: str):
    """One-rank meshes over a process group made once in this process: NCCL
    on the card (the default group) and a gloo group for the CPU, both from
    a ``file://`` store, with NCCL kept on the loopback interface."""
    import torch.distributed as tdist
    from repro_torch.core import distributed as D
    if not tdist.is_initialized():
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        store = Path(tempfile.mkdtemp(prefix="chip_smoke_")) / "store"
        tdist.init_process_group("nccl", init_method=f"file://{store}",
                                 rank=0, world_size=1)
        atexit.register(tdist.destroy_process_group)
    if kind not in _MESHES:
        _MESHES[kind] = D.make_mesh(
            (1,), ("model",), backend="gloo" if kind == "cpu" else None)
    return _MESHES[kind]


def sharded_path(summary: dict, card: str, pq_eng, rq_eng, ivf_eng, qs_main,
                 qs_rq, x_main, x_ivf, qs_ivf):
    """Phase 11: each sharded form on a one-rank NCCL mesh, built on the
    index of the batched engine it is held against."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.index import engine
    from repro_torch.kernels import ops
    k, b = 5000, 32
    m1 = mesh("cuda")
    kw = dict(k=k, n_probe=64, mesh=m1)
    ivf_x = ivf_eng.vectors
    # the batched forms each sharded form is held against: the unfused PQ
    # engine re-ranks by the sharded path's exact-distance sum
    pq_unfused = engine.SearchEngine.build(pq_eng.index, k=k, n_probe=64,
                                           fused=False, device="cuda")
    forms = {
        "ivfpq_bbc": engine.SearchEngine.build(pq_eng.index, **kw),
        "ivfpq_naive": engine.SearchEngine.build(pq_eng.index, use_bbc=False,
                                                 **kw),
        "ivfrabitq_bbc": engine.SearchEngine.build(rq_eng.index, **kw),
        # a per-shard budget that holds the whole band (the default,
        # survivor_budget(k, S, 4.0), truncates a band that outgrows it to
        # its smallest lower bounds, as the reference does)
        "ivfrabitq_bbc_fullbudget": engine.SearchEngine.build(
            rq_eng.index, shard_budget=int(rq_eng.index.vectors.shape[0]),
            **kw),
        "ivfrabitq_naive": engine.SearchEngine.build(
            rq_eng.index, use_bbc=False, **kw),
        "ivf_bbc": engine.SearchEngine.build(ivf_eng.index, vectors=ivf_x,
                                             **kw),
        "ivf_naive": engine.SearchEngine.build(ivf_eng.index, vectors=ivf_x,
                                               use_bbc=False, **kw)}
    for name, e in forms.items():
        e.warmup((b,), predictive=e.use_bbc)
    pq_unfused.warmup((b,))
    static_q = {"ivfpq": [qs_main[i:i + b] for i in range(0, 2 * b, b)],
                "ivfrabitq": [qs_rq[i:i + b] for i in range(0, 2 * b, b)],
                "ivf": [qs_ivf[i:i + b] for i in range(0, 2 * b, b)]}
    pred_q = {"ivfpq": [qs_main[64 + i * b:64 + (i + 1) * b]
                        for i in range(4)],
              "ivfrabitq": [qs_rq[64 + i * b:64 + (i + 1) * b]
                            for i in range(4)],
              "ivf": [qs_ivf[i * b:(i + 1) * b] for i in range(3)]}
    truth_x = {"ivfpq": x_main, "ivfrabitq": x_main, "ivf": x_ivf}
    batched = {"ivfpq": pq_unfused, "ivfrabitq": rq_eng, "ivf": ivf_eng}

    ops.reset_launches()
    runs = {}
    for name, e in forms.items():
        method = name.split("_")[0]
        tiers = []

        def one(qb, e=e, tiers=tiers):
            D.reset_tiers()
            r = e.search(qb)
            tiers.append({t: c for t, c in D.TIERS.items() if c})
            return r

        qb = static_q[method] if e.use_bbc else static_q[method][:1]
        runs[name] = (qb, *timed_batches(one, qb), tiers)
        if e.use_bbc:
            state, ptiers = [e.predictor_init()], []

            def pred(qb, e=e, state=state, ptiers=ptiers):
                D.reset_tiers()
                r, state[0] = e.search(qb, pred_state=state[0])
                ptiers.append({t: c for t, c in D.TIERS.items() if c})
                return r

            runs[name + "_predictive"] = (pred_q[method],
                                          *timed_batches(pred, pred_q[method]),
                                          ptiers)
    launches = dict(ops.LAUNCHES)
    for kname in ("pq_adc_batch", "l2_exact_batch", "fused_rabitq_scan_batch",
                  "shard_collect_batch", "spec_compact_batch",
                  "rabitq_sample_ub_batch"):
        check(launches[kname] > 0, f"the sharded path never ran {kname}")

    out = {}
    pq_pred_state = [pq_eng.predictor_init()]
    for name, (qb, res, ms, tiers) in runs.items():
        method = name.split("_")[0]
        for r in res:
            check_result(r, b, k, f"sharded {name}")
        rec = recall(truth_x[method], qb[0][:8], res[0].ids[:8], k)
        if name == "ivfpq_bbc_predictive":
            # held against the batched predictive engine run in lock-step
            # from cold (the JAX package's bar for this pair: 0.99)
            ref_res = []
            for q in qb:
                r, pq_pred_state[0] = pq_eng.search(
                    q, pred_state=pq_pred_state[0])
                ref_res.append(r)
            ov = min(overlap(r, t) for r, t in zip(res, ref_res))
            check(ov >= 0.99, f"sharded {name}: overlap {ov} with the "
                  f"batched predictive engine")
            check(rec >= 0.9, f"sharded {name}: recall@{k} {rec}")
        else:
            ov = min(overlap(r, batched[method].search(q))
                     for r, q in zip(res, qb))
            # The batched result is the JAX parity property.  The exact
            # tier keeps each shard's ``budget`` smallest keys: for IVF
            # (exact distances) and PQ (estimates, re-cut at n_cand <=
            # budget) that holds the batched selection, but RaBitQ's key is
            # the lower bound, so a band that overflows the default budget
            # loses lanes; the full-budget form must not overflow.  The
            # naive PQ and RaBitQ collectors keep k per shard by estimate
            # and are reported only.
            truncated = any("exact" in t for t in tiers)
            if "fullbudget" in name:
                check(not truncated, f"sharded {name}: survivors overflowed "
                      f"the per-shard budget {tiers}")
            lossy = name.startswith("ivfrabitq_bbc") and truncated
            if not lossy and (not name.endswith("naive") or method == "ivf"):
                check(ov == 1.0, f"sharded {name}: id-set overlap {ov} with "
                      f"the batched engine")
                check(rec >= 0.95, f"sharded {name}: recall@{k} {rec}")

        def mean(t):
            return float(t.float().mean().item())

        out[name] = {
            "ms_per_batch": ms, f"recall_at_{k}_8q": rec,
            "overlap_with_batched": ov, "tiers": tiers,
            "n_reranked_mean": [mean(r.n_reranked) for r in res],
            "n_second_pass_mean": [mean(r.n_second_pass) for r in res]}
        if name == "ivfpq_bbc":
            out[name]["overlap_with_batched_fused"] = min(
                overlap(r, pq_eng.search(q)) for r, q in zip(res, qb))
        log(f"[sharded] {name}: {json.dumps(out[name])}")
    out["launches"] = launches
    out["card"] = card
    summary["sharded_1rank_nccl"] = out
    return launches, forms


# --------------------------------------------------------------------------
# phase 7: timing
# --------------------------------------------------------------------------

def main_path_kernel_args(eng, qs):
    """The five kernels' arguments as the main path builds them for one
    batch (routing, ADC tables, the codebook sample's lanes, sample
    codebooks and tau_pred)."""
    from repro_torch.core import rerank
    from repro_torch.index import ivf as ivf_mod
    from repro_torch.index import pq as pq_mod
    from repro_torch.index import search as S
    ix, lay = eng.index, eng.layout
    probed, lane_valid, _ = S._routing(ix.ivf, lay, qs, eng.n_probe)
    codes, vecs = eng.stream.codes, eng.stream.vectors
    luts = pq_mod.adc_table(ix.pq, qs).contiguous()
    st = min(S.SAMPLE_TILES, eng.n_probe)
    spos, sok = ivf_mod.tile_positions(lay, probed[:, :st], ix.ivf.cap)
    est2, _ = S._pq_sample_adc(lay, probed, codes, luts, st, ix.ivf.cap)
    plans = rerank.early_rerank_plan(est2, n_cand=eng.n_cand,
                                     n_sample=est2.shape[1],
                                     n_total=eng.n_probe * ix.ivf.cap,
                                     m=eng.m, valid=sok, squared=True)
    return dict(codes=codes, vectors=vecs, valid=lane_valid, luts=luts,
                qs=qs, d_min=plans.cb.d_min, delta=plans.cb.delta,
                ew_maps=plans.cb.ew_map, m=eng.m, tau_pred=plans.tau_pred,
                lists=(probed, lay.offsets, ix.ivf.cap), n_probe=eng.n_probe,
                spos=spos, sok=sok, plan=dict(
                    vals=est2, ok=sok, k_cb=min(eng.n_cand, est2.shape[1]),
                    m=eng.m, sqrt=True, rank=max(1, round(
                        eng.n_cand * est2.shape[1]
                        / (eng.n_probe * ix.ivf.cap)))))


def bound(nbytes: float, ops32: float) -> tuple[float, str]:
    """The least time for the work: bytes at the memory rate, or fp32
    operations at the peak rate, whichever is longer."""
    tb = nbytes / HBM_BYTES_PER_S
    to = ops32 / FP32_FLOP_PER_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def timing(a) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    b, n = a["valid"].shape
    m_sub, d = a["codes"].shape[1], a["vectors"].shape[1]
    k_codes, n_ew, m = a["luts"].shape[2], a["ew_maps"].shape[1], a["m"]
    args = (a["codes"], a["vectors"], a["valid"], a["luts"], a["qs"],
            a["d_min"], a["delta"], a["ew_maps"], m, a["tau_pred"])
    lists = a["lists"]
    est, bucket, _, _, _ = ops.fused_scan_batch(*args, *lists)
    pred = a["valid"] & (bucket <= a["tau_pred"][:, None])
    lanes_probed = int(a["valid"].any(0).sum().item())
    rows_pred = int(pred.any(0).sum().item())
    pairs_valid = int(a["valid"].sum().item())
    pairs_pred = int(pred.sum().item())
    params = 4 * b * (m_sub * k_codes + d + n_ew + 3)
    out = {}

    # the probed bound (portbench/roofline.py's fused_scan_work: 4 bits a
    # probed lane's code, 12 B of outputs a probed pair, the probe lists)
    # and the dense one of the design before (the (B, n) mask read and
    # three (B, n) outputs written, a byte a code)
    probed_bytes = (lanes_probed * m_sub // 2 + rows_pred * d * 4
                    + 4 * b * a["n_probe"] + 12 * pairs_valid
                    + 4 * b * (m + 2) + params)
    dense_bytes = (lanes_probed * m_sub + rows_pred * d * 4 + b * n
                   + 3 * 4 * b * n + 4 * b * (m + 2) + params)
    # ADC adds; per predicted pair a subtract, multiply and add per coordinate
    fused_ops = pairs_valid * m_sub + 3 * d * pairs_pred
    fn = lambda: ops.fused_scan_batch(*args, *lists)  # noqa: E731
    out["fused_scan_batch"] = dict(
        ms=cuda_ms(fn, 20),
        plain_ms=cuda_ms(lambda: ref.fused_scan_batch(*args), 3, warm=1),
        library_ms=None, work={"lanes_probed": lanes_probed,
                               "rows_predicted": rows_pred,
                               "pairs_valid": pairs_valid,
                               "pairs_predicted": pairs_pred,
                               "device_ms": device_ms(fn,
                                                      "fused_scan_kernel")})
    t = out["fused_scan_batch"]
    t["bound_ms"], t["bound_by"] = bound(probed_bytes, fused_ops)
    t["dense_bound_ms"], _ = bound(dense_bytes, fused_ops)
    log(f"[timing] fused_scan_batch at the main path's shapes over the probed "
        f"lists: {t['ms']:.4f} ms, kernel {t['work']['device_ms']:.4f} ms; "
        f"probed bound {t['bound_ms']:.4f} ms by {t['bound_by']}, dense "
        f"bound {t['dense_bound_ms']:.4f} ms")

    c, lt = a["codes"], a["luts"]
    out["pq_adc_batch"] = dict(
        ms=cuda_ms(lambda: ops.pq_adc_batch(c, lt), 20),
        plain_ms=cuda_ms(lambda: ref.pq_adc_batch(c, lt), 3, warm=1),
        library_ms=None,
        ceiling_ms=1e3 * b * n * m_sub / SMEM_WORDS_PER_S,
        ceiling_by="shared memory")
    out["pq_adc_batch"]["bound_ms"], out["pq_adc_batch"]["bound_by"] = bound(
        n * m_sub + 4 * b * m_sub * k_codes + 4 * b * n, b * n * m_sub)

    x, q = a["vectors"], a["qs"]
    out["l2_exact_batch"] = dict(
        ms=cuda_ms(lambda: ops.l2_exact_batch(x, q), 20),
        plain_ms=cuda_ms(lambda: ref.l2_exact_batch(x, q), 5, warm=1),
        library_ms=cuda_ms(lambda: torch.cdist(q, x), 5, warm=1),
        ceiling_ms=1e3 * 3 * b * n * d / FP32_ISSUE_PER_S, ceiling_by="issue")
    out["l2_exact_batch"]["bound_ms"], out["l2_exact_batch"]["bound_by"] = \
        bound(4 * n * d + 4 * b * d + 4 * b * n, 3 * b * n * d)
    for name, fn in (("pq_adc_batch", lambda: ops.pq_adc_batch(c, lt)),
                     ("l2_exact_batch", lambda: ops.l2_exact_batch(x, q))):
        out[name]["under_load"] = under_load(fn, out[name]["ms"])

    bh = (est, a["valid"], a["d_min"], a["delta"], a["ew_maps"], m)
    out["bucket_hist_batch"] = dict(
        ms=cuda_ms(lambda: ops.bucket_hist_batch(*bh), 20),
        plain_ms=cuda_ms(lambda: ref.bucket_hist_batch(*bh), 3, warm=1),
        library_ms=None, work={
            "B": b, "n": n, "device_ms": device_ms(
                lambda: ops.bucket_hist_batch(*bh), "bucket_hist_kernel")})
    out["bucket_hist_batch"]["bound_ms"], \
        out["bucket_hist_batch"]["bound_by"] = bound(
            9 * b * n + 4 * b * (m + 1) + 4 * b * (n_ew + 2), 4 * b * n)
    for name, t in out.items():
        log(f"[timing] {name}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} "
            f"ms by {t['bound_by']}), plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']}{against_row_kernel(name, t)}")
    return out


def timing_sample(a, errs: dict) -> dict:
    """The codebook sample's ADC at the main path's sample (phase 4's
    batch): bitwise its plain version on the same card tensors, one launch
    a call, then timed beside its bound (the sampled lanes' codes read
    once, the tables, the (B, w) estimates) and the plain version."""
    import torch
    from repro_torch.kernels import ops, ref
    args = (a["codes"], a["luts"], a["spos"], a["sok"])
    b, w = a["spos"].shape
    m_sub, k_codes = a["luts"].shape[1], a["luts"].shape[2]
    before = ops.LAUNCHES["pq_sample_adc_batch"]
    got = ops.pq_sample_adc_batch(*args)
    check(ops.LAUNCHES["pq_sample_adc_batch"] == before + 1,
          "pq_sample_adc_batch: more than one launch a call")
    want = ref.pq_sample_adc_batch(*args)
    errs["pq_sample_adc_batch"] = max(errs.get("pq_sample_adc_batch", 0.0),
                                      max_abs(got, want))
    check(torch.equal(got, want), f"pq_sample_adc_batch at the main path's "
          f"sample (B={b}, w={w}, M={m_sub}) not bitwise its plain version")
    lanes = int(torch.unique(a["spos"][a["sok"]]).numel())
    pairs = int(a["sok"].sum().item())
    fn = lambda: ops.pq_sample_adc_batch(*args)  # noqa: E731
    t = dict(ms=cuda_ms(fn, 20),
             plain_ms=cuda_ms(lambda: ref.pq_sample_adc_batch(*args), 3,
                              warm=1),
             library_ms=None,
             work={"B": b, "w": w, "M": m_sub, "lanes": lanes,
                   "pairs": pairs,
                   "device_ms": device_ms(fn, "pq_sample_adc_kernel")})
    t["bound_ms"], t["bound_by"] = bound(
        lanes * m_sub + 4 * b * m_sub * k_codes + 4 * b * w,
        pairs * (m_sub - 1))
    log(f"[timing] pq_sample_adc_batch at the main path's sample (B={b}, "
        f"w={w}, M={m_sub}; {lanes} lanes, {pairs} pairs): bitwise, "
        f"{t['ms']:.4f} ms, kernel {t['work']['device_ms']:.4f} ms (bound "
        f"{t['bound_ms']:.4f} ms by {t['bound_by']}), plain "
        f"{t['plain_ms']:.4f} ms")
    return {"pq_sample_adc_batch": t}


def second_pass_args(eng, qs):
    """The second pass's gather arguments of one main-path call, recorded
    from ``eng.search(qs)``."""
    from repro_torch.kernels import ops
    seen, real = [], ops.l2_gather_rows

    def record(*args):
        seen.append(args)
        return real(*args)

    ops.l2_gather_rows = record
    try:
        eng.search(qs)
    finally:
        ops.l2_gather_rows = real
    check(len(seen) == 1, f"{len(seen)} second-pass gathers in one call")
    return seen[0]


def d960_gather_args(b=32, n=1_000_000, w=40_000, d=960, share=0.88):
    """The GIST1M-width cell's second pass in shape: B=32 queries of
    d=960, w=40,000 slots (its n_cand), about 88% set, ids of random rows
    of a million (-1 off the mask)."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(SEED + 960)
    vectors = torch.randn(n, d, device=DEV, generator=g)
    qs = torch.randn(b, d, device=DEV, generator=g)
    mask = torch.rand(b, w, device=DEV, generator=g) < share
    ids = torch.randint(0, n, (b, w), device=DEV, generator=g)
    return vectors, torch.where(mask, ids, -1), qs, mask


def timing_gather(args, errs: dict, key: str, where: str) -> dict:
    """The second pass's gather: bitwise its plain version on the same
    card tensors, one launch a call, then timed beside its bound (each set
    entry's row and id read once, the mask, the (B, w) output) and the
    plain version (the chunked gather and PyTorch passes it replaced)."""
    import torch
    from repro_torch.kernels import ops, ref
    vectors, ids, qs, mask = args
    b, w = mask.shape
    d = vectors.shape[1]
    before = ops.LAUNCHES["l2_gather_rows_batch"]
    got = ops.l2_gather_rows(*args)
    check(ops.LAUNCHES["l2_gather_rows_batch"] == before + 1,
          "l2_gather_rows: more than one launch a call")
    want = ref.l2_gather_rows(*args)
    errs["l2_gather_rows_batch"] = max(errs.get("l2_gather_rows_batch", 0.0),
                                       max_abs(got, want))
    check(torch.equal(got, want), f"l2_gather_rows at {where} (B={b}, w={w}, "
          f"d={d}) not bitwise its plain version")
    pairs = int(mask.sum().item())
    rows = int(torch.unique(ids[mask]).numel())
    fn = lambda: ops.l2_gather_rows(*args)  # noqa: E731
    t = dict(ms=cuda_ms(fn, 20),
             plain_ms=cuda_ms(lambda: ref.l2_gather_rows(*args), 3, warm=1),
             library_ms=None,
             work={"B": b, "w": w, "d": d, "pairs": pairs, "rows": rows,
                   "device_ms": device_ms(fn, "l2_gather_rows_kernel")})
    t["bound_ms"], t["bound_by"] = bound(
        pairs * (4 * d + 8) + 5 * b * w + 4 * b * d, 3 * d * pairs)
    log(f"[timing] l2_gather_rows_batch at {where} (B={b}, w={w}, d={d}; "
        f"{pairs} pairs, {rows} rows): bitwise, {t['ms']:.4f} ms, kernel "
        f"{t['work']['device_ms']:.4f} ms (bound {t['bound_ms']:.4f} ms by "
        f"{t['bound_by']}: {pairs * 4 * d / 1e9:.3f} GB of pair rows), "
        f"plain {t['plain_ms']:.4f} ms")
    return {key: t}


def d960_pq8_scan_args(b=32, n=1_000_064, d=960, m_sub=240, k_codes=256,
                       run=976, pred=12_500):
    """The GIST1M-width 8-bit cell's scan in shape: B=32 queries over the
    1M-lane stream, 240 one-byte codes a lane (K = 256), d=960; each query
    probes runs of ``run`` lanes (clusters) at 1 in 16, and its threshold
    predicts about ``pred`` lanes (the searcher's pred_count at k=5000)."""
    import torch
    from repro_torch.core import buffer as rb
    from repro_torch.kernels import ref
    g = torch.Generator(device=DEV).manual_seed(SEED + 8)
    codes = torch.randint(0, k_codes, (n, m_sub), generator=g, device=DEV,
                          dtype=torch.uint8)
    vectors = torch.randn(n, d, generator=g, device=DEV)
    runs = torch.rand(b, -(-n // run), generator=g, device=DEV) < 0.0625
    valid = runs.repeat_interleave(run, dim=1)[:, :n].contiguous()
    luts = torch.rand(b, m_sub, k_codes, generator=g, device=DEV) * 2
    qs = torch.randn(b, d, generator=g, device=DEV)
    est = torch.where(valid, torch.sqrt(ref.pq_adc_batch(codes, luts)),
                      float("inf"))
    cb = rb.build_codebook(est, k=40_000, m=128)
    _, hist = ref.bucket_hist_batch(est, valid, cb.d_min, cb.delta,
                                    cb.ew_map, 128)
    tau = (torch.cumsum(hist, 1) < pred).sum(1).to(torch.int32)
    offsets = (torch.arange(-(-n // run) + 1, device=DEV) * run).clamp(max=n)
    return dict(codes=codes, vectors=vectors, valid=valid, luts=luts, qs=qs,
                d_min=cb.d_min, delta=cb.delta, ew_maps=cb.ew_map, m=128,
                tau_pred=tau, lists=(lists_holding(valid, offsets, SEED + 9),
                                     offsets, run))


def timing_chunked(a, errs: dict) -> dict:
    """The chunked-LUT scan at the 8-bit d960 cell's shapes: given each
    query's lists, as the searcher calls it, the plan takes it over every
    lane, one launch a call, every output bitwise its plain version on the
    same card tensors; then the wrapper and the kernel alone timed beside
    the bound (``timing``'s dense arithmetic at one byte a code) and the
    plain version."""
    import torch
    from repro_torch.kernels import ops, ref
    b, n = a["valid"].shape
    m_sub, d = a["codes"].shape[1], a["vectors"].shape[1]
    k_codes, n_ew, m = a["luts"].shape[2], a["ew_maps"].shape[1], a["m"]
    args = (a["codes"], a["vectors"], a["valid"], a["luts"], a["qs"],
            a["d_min"], a["delta"], a["ew_maps"], m, a["tau_pred"])
    lists = a["lists"]
    p = ops._batch_scan_plan(b, n, m_sub, k_codes, d, n_ew, m, ops._sms(0),
                             lists[0].shape[1], lists[2])
    check(p.chunked, f"the plan at B={b}, M={m_sub}, K={k_codes}, d={d} is "
          f"not the chunked kernel: {p}")
    check(bool((a["valid"] & ~lanes_of(*lists[:2], n)).sum() == 0),
          "the 8-bit shapes' lists miss a valid lane")
    before = ops.LAUNCHES["fused_scan_chunked_batch"]
    got = ops.fused_scan_batch(*args, *lists)
    check(ops.LAUNCHES["fused_scan_chunked_batch"] == before + 1,
          "fused_scan_chunked_batch: not one launch a call")
    want = ref.fused_scan_batch(*args)
    errs["fused_scan_chunked_batch"] = max(
        errs.get("fused_scan_chunked_batch", 0.0), max_abs(got[0], want[0]),
        max_abs(got[3], want[3]))
    check(all(same(x, y) for x, y in zip(got, want)),
          f"fused_scan_chunked at the d960 8-bit shapes (B={b}, n={n}, "
          f"M={m_sub}, K={k_codes}) not bitwise its plain version")
    valid, pred = a["valid"], torch.isfinite(got[3])
    lanes_probed = int(valid.any(0).sum().item())
    rows_pred = int(pred.any(0).sum().item())
    pairs_valid, pairs_pred = int(valid.sum().item()), int(pred.sum().item())
    params = 4 * b * (m_sub * k_codes + d + n_ew + 3)
    nbytes = (lanes_probed * m_sub + rows_pred * d * 4 + b * n
              + 3 * 4 * b * n + 4 * b * (m + 2) + params)
    fn = lambda: ops.fused_scan_batch(*args, *lists)  # noqa: E731
    t = dict(ms=cuda_ms(fn, 20),
             plain_ms=cuda_ms(lambda: ref.fused_scan_batch(*args), 3, warm=1),
             library_ms=None,
             work={"B": b, "n": n, "M": m_sub, "K": k_codes, "d": d,
                   "mc": p.mc, "blocks": p.blocks, "lut_loads": p.blocks,
                   "lanes_probed": lanes_probed, "rows_predicted": rows_pred,
                   "pairs_valid": pairs_valid, "pairs_predicted": pairs_pred,
                   "device_ms": device_ms(fn, "fused_scan_chunked_kernel")})
    t["bound_ms"], t["bound_by"] = bound(
        nbytes, pairs_valid * m_sub + 3 * d * pairs_pred)
    log(f"[timing] fused_scan_chunked_batch at the d960 8-bit shapes (B={b}, "
        f"n={n}, M={m_sub}, K={k_codes}, chunks of {p.mc}, {p.blocks} blocks "
        f"a query: {p.blocks} LUT loads a query): bitwise, {t['ms']:.4f} ms, "
        f"kernel {t['work']['device_ms']:.4f} ms (bound {t['bound_ms']:.4f} "
        f"ms by {t['bound_by']}), plain {t['plain_ms']:.4f} ms; "
        f"{pairs_valid} probed pairs, {pairs_pred} predicted")
    return {"fused_scan_chunked_batch": t}


def deep10m_scan_args(b=32, n=10_000_000, d=96, m_sub=24, c=4096,
                      n_probe=64, pred=12_500):
    """The deep-10M cell's scan in shape: B=32 queries over the 10M-lane
    stream in ``c`` equal clusters, 24 4-bit codes a lane (a byte each,
    no multiple of 16), d=96; each query probes ``n_probe`` distinct
    clusters (1.6% of the lanes) and its threshold predicts about ``pred``
    lanes (the searcher's pred_count at k=5000)."""
    import torch
    from repro_torch.core import buffer as rb
    from repro_torch.kernels import ref
    g = torch.Generator(device=DEV).manual_seed(SEED + 10)
    codes = torch.randint(0, 16, (n, m_sub), generator=g, device=DEV,
                          dtype=torch.uint8)
    vectors = torch.randn(n, d, generator=g, device=DEV)
    probed = torch.rand(b, c, generator=g, device=DEV).argsort(1)[:, :n_probe]
    hit = torch.zeros(b, c, dtype=torch.bool, device=DEV)
    hit.scatter_(1, probed, True)
    valid = hit.repeat_interleave(-(-n // c), dim=1)[:, :n].contiguous()
    luts = torch.rand(b, m_sub, 16, generator=g, device=DEV) * 2
    qs = torch.randn(b, d, generator=g, device=DEV)
    est = torch.where(valid, torch.sqrt(ref.pq_adc_batch(codes, luts)),
                      float("inf"))
    cb = rb.build_codebook(est, k=40_000, m=128)
    _, hist = ref.bucket_hist_batch(est, valid, cb.d_min, cb.delta,
                                    cb.ew_map, 128)
    tau = (torch.cumsum(hist, 1) < pred).sum(1).to(torch.int32)
    size = -(-n // c)
    offsets = (torch.arange(c + 1, device=DEV) * size).clamp(max=n)
    return dict(codes=codes, vectors=vectors, valid=valid, luts=luts, qs=qs,
                d_min=cb.d_min, delta=cb.delta, ew_maps=cb.ew_map, m=128,
                tau_pred=tau, n_probe=n_probe, lists=(probed, offsets, size))


def timing_deep10m(a, errs: dict) -> dict:
    """The batched fused scan (#1, ``fused_scan_kernel``) at the deep-10M
    cell's shapes over each query's 64 probed lists: one launch of the
    whole-LUT kernel, bitwise its plain version on the same card tensors
    on every walked lane (hist and nmiss whole); then the wrapper and the
    kernel alone beside two bounds: the dense one (the design before: the
    (B, n) mask read, three 4-byte (B, n) outputs written, a byte a code)
    and the probed one (``portbench/roofline.py``'s ``fused_scan_work``: 4
    bits a probed lane's code, 12 B of outputs a probed pair, each query's
    probe list)."""
    import torch
    from repro_torch.kernels import ops, ref
    b, n = a["valid"].shape
    m_sub, d = a["codes"].shape[1], a["vectors"].shape[1]
    k_codes, n_ew, m = a["luts"].shape[2], a["ew_maps"].shape[1], a["m"]
    args = (a["codes"], a["vectors"], a["valid"], a["luts"], a["qs"],
            a["d_min"], a["delta"], a["ew_maps"], m, a["tau_pred"])
    lists = a["lists"]
    p = ops._batch_scan_plan(b, n, m_sub, k_codes, d, n_ew, m, ops._sms(0),
                             lists[0].shape[1], lists[2])
    check(not p.chunked,
          f"the plan at the deep-10M shapes is not fused_scan_kernel: {p}")
    before = dict(ops.LAUNCHES)
    got = ops.fused_scan_batch(*args, *lists)
    check(ops.LAUNCHES["fused_scan_batch"] == before["fused_scan_batch"] + 1
          and ops.LAUNCHES["fused_scan_chunked_batch"]
          == before["fused_scan_chunked_batch"],
          "fused_scan_batch at the deep-10M shapes: not one whole-LUT launch")
    t0 = time.monotonic()
    want = ref.fused_scan_batch(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.monotonic() - t0)
    valid = a["valid"]                      # the lanes of the lists
    errs["fused_scan_batch"] = max(
        errs.get("fused_scan_batch", 0.0),
        max_abs(got[0][valid], want[0][valid]),
        max_abs(got[3][valid], want[3][valid]))
    same_on(got, want, valid, f"fused_scan_batch at the deep-10M shapes "
            f"(B={b}, n={n}, M={m_sub})")
    del want
    pred = valid & torch.isfinite(got[3])
    lanes_probed = int(valid.any(0).sum().item())
    rows_pred = int(pred.any(0).sum().item())
    pairs_valid, pairs_pred = int(valid.sum().item()), int(pred.sum().item())
    params = 4 * b * (m_sub * k_codes + d + n_ew + 3)
    ops32 = pairs_valid * m_sub + 3 * d * pairs_pred
    dense = (lanes_probed * m_sub + rows_pred * d * 4 + b * n
             + 3 * 4 * b * n + 4 * b * (m + 2) + params)
    probed = (lanes_probed * m_sub // 2 + rows_pred * d * 4
              + 4 * b * a["n_probe"] + 12 * pairs_valid + 4 * b * (m + 2)
              + params)
    del got
    fn = lambda: ops.fused_scan_batch(*args, *lists)  # noqa: E731
    t = dict(ms=cuda_ms(fn, 20), plain_ms=plain_ms, library_ms=None,
             work={"B": b, "n": n, "M": m_sub, "d": d, "blocks": p.blocks,
                   "lanes_probed": lanes_probed, "rows_predicted": rows_pred,
                   "pairs_valid": pairs_valid, "pairs_predicted": pairs_pred,
                   "dense_bytes": dense, "probed_bytes": probed,
                   "device_ms": device_ms(fn, "fused_scan_kernel")})
    t["bound_ms"], t["bound_by"] = bound(dense, ops32)
    t["probed_bound_ms"], t["probed_bound_by"] = bound(probed, ops32)
    log(f"[timing] fused_scan_batch at the deep-10M shapes (B={b}, n={n}, "
        f"M={m_sub}, d={d}, {lanes_probed} lanes probed, {p.blocks} blocks "
        f"a query): bitwise on the walked lanes, "
        f"{t['ms']:.4f} ms, kernel {t['work']['device_ms']:.4f} ms; dense "
        f"bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({dense / 1e9:.3f} "
        f"GB), probed bound {t['probed_bound_ms']:.4f} ms by "
        f"{t['probed_bound_by']} ({probed / 1e9:.4f} GB); plain "
        f"{plain_ms:.1f} ms; {pairs_valid} probed pairs, {pairs_pred} "
        f"predicted")
    return {"fused_scan_batch@deep10m": t}


def mask_args(b: int, n: int, c: int, n_probe: int, seed: int) -> dict:
    """A cell's routing in shape: a layout of ``n`` lanes in ``c``
    clusters of random sizes (random cuts of the stream), cluster ``c`` on
    its last 64 lanes, the padding, and B queries' ``n_probe`` distinct
    probed clusters each (a strided view, as the routing's selection
    gives)."""
    import torch
    from repro_torch.index import ivf
    g = torch.Generator(device=DEV).manual_seed(seed)
    live = n - 64
    cuts = torch.randint(0, live + 1, (c - 1,), generator=g, device=DEV)
    offsets = torch.cat([cuts.new_zeros(1), torch.sort(cuts).values,
                         cuts.new_full((1,), live)])
    sizes = offsets.diff()
    cluster_of = torch.full((n,), c, dtype=torch.int64, device=DEV)
    cluster_of[:live] = torch.repeat_interleave(
        torch.arange(c, device=DEV), sizes)
    layout = ivf.FlatLayout(order=torch.arange(n, device=DEV),
                            cluster_of=cluster_of, offsets=offsets,
                            valid=torch.arange(n, device=DEV) < live)
    probed = torch.rand(b, c, generator=g, device=DEV).argsort(1)[:, :n_probe]
    return dict(layout=layout, probed=probed, c=c)


def timing_mask(a, errs: dict, where: str) -> dict:
    """The lane mask (``probe_mask_kernel``) at a cell's routing shapes:
    one launch, bitwise ``ivf.probe_mask`` (the composition the routing ran
    before the kernel: scatter, gather, AND) on the same card tensors; the
    wrapper and the kernel alone beside the bound (B * n bytes written,
    each lane's int64 cluster id and each probe read once) and the
    composition's time."""
    import torch
    from repro_torch.index import ivf
    from repro_torch.kernels import ops
    layout, probed, c = a["layout"], a["probed"], a["c"]
    b, n_probe = probed.shape
    n = layout.n_flat
    before = dict(ops.LAUNCHES)
    got = ops.probe_mask_batch(layout.cluster_of, probed, c)
    check({k: v - before[k] for k, v in ops.LAUNCHES.items()
           if v - before[k]} == {"probe_mask_batch": 1},
          f"probe_mask_batch at {where}: not one launch")
    want = ivf.probe_mask(layout, probed, c)
    errs["probe_mask_batch"] = max(errs.get("probe_mask_batch", 0.0),
                                   float((got != want).sum().item()))
    check(same(got, want), f"probe_mask_batch at {where} (B={b}, n={n}, "
          f"C={c}) not bitwise ivf.probe_mask")
    del got, want
    nbytes = b * n + 8 * n + 8 * b * n_probe
    fn = lambda: ops.probe_mask_batch(layout.cluster_of, probed, c)  # noqa
    t = dict(ms=cuda_ms(fn, 20),
             plain_ms=cuda_ms(lambda: ivf.probe_mask(layout, probed, c), 5),
             library_ms=None,
             work={"B": b, "n": n, "C": c, "n_probe": n_probe,
                   "bytes": nbytes,
                   "plan": ops._mask_plan(b, n, c, True,
                                          ops._sms(0))._asdict(),
                   "device_ms": device_ms(fn, "probe_mask_kernel")})
    t["bound_ms"], t["bound_by"] = bound(nbytes, 0)
    log(f"[timing] probe_mask_batch at {where} (B={b}, n={n}, C={c}, "
        f"n_probe={n_probe}): bitwise, {t['ms']:.4f} ms, kernel "
        f"{t['work']['device_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
        f"{t['bound_by']} ({nbytes / 1e9:.3f} GB); plain composition "
        f"{t['plain_ms']:.4f} ms")
    return t


def timing_delta(errs: dict) -> dict:
    """#3 at one delta segment's scan (phase 14's shape: B=32 queries over
    4096 rows of d=128), through ``timing_l2_dense``."""
    import numpy as np
    import torch
    b, n, d = DELTA_SHAPES[0]
    rng = np.random.default_rng(SEED + 21)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(DEV)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(DEV)
    return timing_l2_dense(x, q, errs, "l2_exact_batch@delta",
                           "the delta-scan shape", reps=50)


def against_row_kernel(name: str, t: dict) -> str:
    """The ceiling and the row kernels' time beside a #2/#3 reading."""
    if name not in ROW_KERNEL_MS:
        return ""
    old = ROW_KERNEL_MS[name]
    text = f"; row kernels (a8dde8d) {old:.4f} ms, {old / t['ms']:.2f}x"
    if "ceiling_ms" in t:
        text += (f"; ceiling {t['ceiling_ms']:.4f} ms by {t['ceiling_by']}; "
                 f"under load (clock, power, power cap): {t['under_load']}")
    return text


def rabitq_kernel_args(eng, qs) -> dict:
    """The RaBitQ scan's arguments as the fused static path builds them for
    one batch (routing, the engine's stream, sample codebooks, gate), and
    the sample kernel's (``sample``)."""
    from repro_torch.index import search as S
    ix, lay, st = eng.index, eng.layout, eng.stream
    probed, lane_valid, d2 = S._routing(ix.ivf, lay, qs, eng.n_probe)
    n_st = min(4, eng.n_probe)
    g, nq = S._rabitq_query_terms(st, qs, d2)
    sample_ub, _ = S._rabitq_sample_ub(st, lay, probed, g, nq, n_st,
                                       ix.ivf.cap, RQ_EPS0)
    cbs, tau = S._rabitq_sample_plan(sample_ub, eng.k, eng.k, n_st,
                                     eng.n_probe, eng.m)
    k_cb = min(eng.k, sample_ub.shape[1])
    return dict(codes=st.codes, vectors=st.vectors, s2=st.s2,
                norm_o=st.norm_o, f_o=st.f_o, cl=st.cl, g=g, qs=qs,
                nq=nq, valid=lane_valid, d_min=cbs.d_min, delta=cbs.delta,
                ew_maps=cbs.ew_map, m=eng.m, tau_inline=tau,
                plan=dict(vals=sample_ub, ok=None, k_cb=k_cb, m=eng.m,
                          rank=S._rabitq_inline_rank(eng.k, n_st,
                                                     eng.n_probe, k_cb),
                          margin=S._TAU_INLINE_MARGIN, cap=eng.m - 1),
                sample=(st.codes, st.s2, st.norm_o, st.f_o, st.cl,
                        lay.offsets, probed[:, :n_st], ix.ivf.cap, g, nq))


def timing_rabitq(a, errs: dict, key: str = "fused_rabitq_scan_batch",
                  where: str = "RaBitQ path inputs B=32 n=1M d=128") -> dict:
    """The RaBitQ scan at a RaBitQ path's real inputs: checked against its
    plain version once more, then timed beside its bound (the whole call
    and the kernel alone)."""
    from repro_torch.kernels import ops, ref
    check_rabitq_kernel(a, errs, where)
    args = [a[k] for k in RQ_ARGS]
    valid = a["valid"]
    b, n = valid.shape
    d, c = a["codes"].shape[1], a["nq"].shape[1]
    n_ew, m = a["ew_maps"].shape[1], a["m"]
    certified = ops.fused_rabitq_scan_batch(*args, eps0=RQ_EPS0)[8]
    lanes_probed = int(valid.any(0).sum().item())
    rows_cert = int(certified.any(0).sum().item())
    pairs_valid = int(valid.sum().item())
    pairs_cert = int(certified.sum().item())
    # codes + 16 B of factors per probed lane, vector rows of certified
    # lanes, the mask, 25 B of outputs per (query, lane), per-query params
    nbytes = (lanes_probed * (d + 16) + rows_cert * d * 4 + b * n
              + 25 * b * n + 4 * b * (2 * (m + 1) + 1)
              + 4 * b * (2 * d + c + n_ew + 3))
    nops = pairs_valid * (2 * d + 20) + 3 * d * pairs_cert
    fn = lambda: ops.fused_rabitq_scan_batch(*args, eps0=RQ_EPS0)  # noqa: E731
    t = dict(ms=cuda_ms(fn, 20),
             plain_ms=cuda_ms(lambda: ref.fused_rabitq_scan_batch(
                 *args, eps0=RQ_EPS0), 3, warm=1),
             library_ms=None,
             work={"d": d, "lanes_probed": lanes_probed,
                   "rows_certified": rows_cert, "pairs_valid": pairs_valid,
                   "pairs_certified": pairs_cert,
                   "device_ms": device_ms(fn, "rabitq_fused_kernel")})
    t["bound_ms"], t["bound_by"] = bound(nbytes, nops)
    log(f"[timing] {key} at the {where}: {t['ms']:.4f} ms, kernel "
        f"{t['work']['device_ms']:.4f} ms (bound {t['bound_ms']:.4f} ms by "
        f"{t['bound_by']}), plain {t['plain_ms']:.4f} ms, library none; "
        f"work {t['work']}")
    return {key: t}


def timing_rabitq_sample(a, errs: dict,
                         key: str = "rabitq_sample_ub_batch",
                         where: str = "the RaBitQ path's sample") -> dict:
    """The codebook sample's RaBitQ bounds at a RaBitQ path's sample
    (phase 9's batch, or 22's): bitwise its plain version on the same card
    tensors, one launch a call, then timed beside its bound (the sampled
    lanes' codes and 16 B of factors read once, the (B, w) ub and ok
    written) and the plain version."""
    import torch
    from repro_torch.kernels import ops, ref
    args = a["sample"]
    codes, clusters, cap, g = args[0], args[6], args[7], args[8]
    b, d, w = g.shape[0], codes.shape[1], clusters.shape[1] * cap
    before = ops.LAUNCHES["rabitq_sample_ub_batch"]
    got = ops.rabitq_sample_ub_batch(*args, eps0=RQ_EPS0)
    check(ops.LAUNCHES["rabitq_sample_ub_batch"] == before + 1,
          "rabitq_sample_ub_batch: more than one launch a call")
    want = ref.rabitq_sample_ub_batch(*args, eps0=RQ_EPS0)
    errs["rabitq_sample_ub_batch"] = max(
        errs.get("rabitq_sample_ub_batch", 0.0), max_abs(got[0], want[0]))
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"rabitq_sample_ub_batch at {where} (B={b}, w={w}, d={d}) not "
          f"bitwise its plain version")
    offs = args[5]
    lanes = int((offs[1:] - offs[:-1])[torch.unique(clusters)].clamp(
        max=cap).sum().item())              # the sampled clusters' lanes
    pairs = int(got[1].sum().item())
    fn = lambda: ops.rabitq_sample_ub_batch(*args, eps0=RQ_EPS0)  # noqa: E731
    t = dict(ms=cuda_ms(fn, 20),
             plain_ms=cuda_ms(lambda: ref.rabitq_sample_ub_batch(
                 *args, eps0=RQ_EPS0), 3, warm=1),
             library_ms=None,
             work={"B": b, "w": w, "d": d, "lanes": lanes, "pairs": pairs,
                   "plan": ops._sample_ub_plan(w, d)._asdict(),
                   "device_ms": device_ms(fn, "rabitq_sample_ub_kernel")})
    # codes and 16 B of factors of each sampled lane once, the rotated
    # queries and routing norms, ub (4 B) and ok (1 B) a (query, lane);
    # 2d - 1 products and adds and ~20 bound operations a pair
    t["bound_ms"], t["bound_by"] = bound(
        lanes * (d + 16) + 4 * b * (d + args[9].shape[1]) + 5 * b * w,
        pairs * (2 * d + 20))
    log(f"[timing] {key} at {where} (B={b}, w={w}, d={d}; {lanes} lanes, "
        f"{pairs} pairs): bitwise, {t['ms']:.4f} ms, kernel "
        f"{t['work']['device_ms']:.4f} ms (bound {t['bound_ms']:.4f} ms by "
        f"{t['bound_by']}), plain {t['plain_ms']:.4f} ms; plan "
        f"{t['work']['plan']}")
    return {key: t}


def timing_l2_dense(x, qs, errs: dict, key: str, where: str,
                    reps: int = 10) -> dict:
    """#3 over every row of ``x``, as the dense straggler pass and the
    delta scan call it: bitwise its plain version on the same card tensors,
    one launch a call, then the wrapper call and the kernel alone timed
    beside the bound (each row read once, the (B, n) output written once),
    the fp32 issue ceiling, the plain version, ``torch.cdist`` and the
    blocks the launch fills the card with."""
    import torch
    from repro_torch.kernels import ops, ref
    (n, d), b = x.shape, qs.shape[0]
    before = ops.LAUNCHES["l2_exact_batch"]
    got = ops.l2_exact_batch(x, qs)
    check(ops.LAUNCHES["l2_exact_batch"] == before + 1,
          "l2_exact_batch: more than one launch a call")
    want = ref.l2_exact_batch(x, qs)
    errs["l2_exact_batch"] = max(errs.get("l2_exact_batch", 0.0),
                                 max_abs(got, want))
    check(torch.equal(got, want), f"l2_exact_batch at {where} (B={b}, n={n}, "
          f"d={d}) not bitwise its plain version")
    del got, want
    fn = lambda: ops.l2_exact_batch(x, qs)  # noqa: E731
    t = dict(ms=cuda_ms(fn, reps), plain_ms=cuda_ms(
        lambda: ref.l2_exact_batch(x, qs), 2, warm=1),
        library_ms=cuda_ms(lambda: torch.cdist(qs, x), 5, warm=1),
        ceiling_ms=1e3 * 3 * b * n * d / FP32_ISSUE_PER_S, ceiling_by="issue",
        work={"B": b, "n": n, "d": d, "device_ms": device_ms(fn, "l2_", reps),
              "plan": ops._l2_plan(b, n, d)._asdict(), "sms": ops.SMS})
    t["bound_ms"], t["bound_by"] = bound(4 * n * d + 4 * b * d + 4 * b * n,
                                         3 * b * n * d)
    log(f"[timing] {key} at {where} {(b, n, d)}: bitwise, {t['ms']:.4f} ms, "
        f"kernel {t['work']['device_ms']:.4f} ms (bound {t['bound_ms']:.4f} "
        f"ms by {t['bound_by']}, issue ceiling {t['ceiling_ms']:.4f} ms), "
        f"plain {t['plain_ms']:.4f} ms, torch.cdist {t['library_ms']:.4f} "
        f"ms; plan {t['work']['plan']}")
    return {key: t}


def straggler_mask(eng, qs):
    """The straggler mask the engine's call hands the masked pass (its
    vectors, queries and (B, n) mask), taken from inside one call."""
    from repro_torch.kernels import ops
    real, seen = ops.l2_exact_batch_masked, []

    def keep(x, q, mask):
        seen.append((x, q, mask.clone()))
        return real(x, q, mask)
    ops.l2_exact_batch_masked = keep
    try:
        eng.search(qs)
    finally:
        ops.l2_exact_batch_masked = real
    check(len(seen) == 1, f"the call ran the masked pass {len(seen)} times")
    return seen[0]


def timing_l2_masked(x, qs, mask, errs: dict, key: str, where: str,
                     dense_ms: float | None = None, reps: int = 10) -> dict:
    """The masked straggler pass on a call's own mask: bitwise the dense
    #3 pass on every set pair, one launch a call, the tiles it staged
    equal to the tiles with a set pair; then the wrapper call and the
    kernel alone timed beside the bound (the rows some query needs read
    once, the mask read once, a distance written a set pair; 3d fp32 a set
    pair), the issue ceiling of the groups of eight it computes, the plain
    version and the dense pass."""
    import torch
    from repro_torch import spans
    from repro_torch.kernels import ops, ref
    from torch.autograd import profiler as ap
    (n, d), b = x.shape, qs.shape[0]
    before = ops.LAUNCHES["l2_exact_masked_batch"]
    spans.clear()
    with ap.profile(use_kineto=True):
        with spans.span("rerank.stragglers"):
            got = ops.l2_exact_batch_masked(x, qs, mask)
    check(ops.LAUNCHES["l2_exact_masked_batch"] == before + 1,
          "l2_exact_batch_masked: more than one launch a call")
    staged = [r.value for r in spans.RECORDER._records
              if type(r) is spans.CountRecord
              and r.name == "rerank.straggler_tiles_read"]
    spans.clear()
    tiles = ref.masked_tiles(mask)
    check(len(staged) == 1 and torch.equal(staged[0], tiles),
          f"l2_exact_batch_masked at {where}: staged tiles differ from the "
          f"tiles with a straggler")
    dense = ops.l2_exact_batch(x, qs)
    errs["l2_exact_masked_batch"] = max(
        errs.get("l2_exact_masked_batch", 0.0),
        max_abs(got[mask], dense[mask]))
    check(torch.equal(got[mask], dense[mask]),
          f"l2_exact_batch_masked at {where} (B={b}, n={n}, d={d}) not "
          f"bitwise the dense pass on the mask")
    del got, dense
    pairs = int(mask.sum().item())
    rows = int(mask.any(dim=0).sum().item())
    pad = torch.zeros(-(-b // 32) * 32, tiles.shape[1] * 128,
                      dtype=torch.bool, device=mask.device)
    pad[:b, :n] = mask
    listed = pad.reshape(-1, 32, tiles.shape[1], 128).any(dim=3).sum(dim=1)
    groups = int(((listed + 7) // 8).sum().item())
    fn = lambda: ops.l2_exact_batch_masked(x, qs, mask)  # noqa: E731
    t = dict(ms=cuda_ms(fn, reps), plain_ms=cuda_ms(
        lambda: ref.l2_exact_batch_masked(x, qs, mask), 2, warm=1),
        library_ms=None,
        ceiling_ms=1e3 * 3 * 128 * 8 * groups * d / FP32_ISSUE_PER_S,
        ceiling_by="issue of the groups computed", dense_ms=dense_ms,
        work={"B": b, "n": n, "d": d, "pairs": pairs, "rows": rows,
              "tiles_staged": int(tiles.sum().item()),
              "tiles": tiles.numel(), "groups": groups,
              "device_ms": device_ms(fn, "l2_masked", reps),
              "plan": ops._masked_plan(b, n)._asdict()})
    t["bound_ms"], t["bound_by"] = bound(
        4 * rows * d + b * n + 4 * b * d + 4 * pairs, 3 * d * pairs)
    log(f"[timing] {key} at {where} {(b, n, d)}: bitwise on {pairs} pairs "
        f"({rows} rows, {t['work']['tiles_staged']} of {tiles.numel()} "
        f"tiles, {groups} groups of 8), {t['ms']:.4f} ms, kernel "
        f"{t['work']['device_ms']:.4f} ms (bound {t['bound_ms']:.4f} ms by "
        f"{t['bound_by']}, issue ceiling of its groups "
        f"{t['ceiling_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, the "
        f"dense pass {dense_ms} ms; plan {t['work']['plan']}")
    return {key: t}


def gist_rabitq(summary: dict, errs: dict) -> dict:
    """Phase 22: the kernels of the GIST1M-width RaBitQ cell at its shapes.
    A 1,000,000 x 960 Gaussian mixture as the cell's (256 centres at scale
    2.0, points at 0.5; made on the card), IVF 1024 + 1-bit RaBitQ built
    on the card, one batch of 32 of its rows plus jitter 0.1 through the
    fused engine (k=5000, n_probe=64, m=128, eps0=3.0; recall@k on 8 of
    them must reach 0.95).  On that batch's inputs: #5, the sample bounds
    and #3 over the whole stream (the dense straggler pass), each bitwise
    its plain version in one launch a call, then timed beside its bound
    and plain version; the masked straggler pass on the call's own mask
    (``timing_l2_masked``); and the batch's band anatomy (phase 10's, cold
    predictive gate)."""
    import torch
    from repro_torch.index import engine, search
    n, d, b, c = 1_000_000, 960, 32, 1024
    g = torch.Generator(device=DEV).manual_seed(SEED + 960)
    centres = torch.randn(256, d, generator=g, device=DEV).mul_(2.0)
    x = torch.randn(n, d, generator=g, device=DEV).mul_(0.5)
    x.add_(centres[torch.randint(0, 256, (n,), generator=g, device=DEV)])
    rows = torch.randperm(n, generator=g, device=DEV)[:b]
    qs = x[rows] + 0.1 * torch.randn(b, d, generator=g, device=DEV)
    del centres
    t0 = time.monotonic()
    index = search.build_rabitq_index(x, c, seed=SEED, device="cuda")
    eng = engine.SearchEngine.build(index, k=RQ_K, n_probe=RQ_PROBE,
                                    device="cuda")
    eng.warmup((b,))
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    res = eng.search(qs)
    check_result(res, b, RQ_K, "gist rabitq bbc", ascending=False)
    rec = recall(x, qs[:8], res.ids[:8], RQ_K)
    check(rec >= 0.95, f"gist rabitq recall@{RQ_K} {rec} below 0.95")
    a = rabitq_kernel_args(eng, qs)
    times = timing_rabitq(a, errs, "fused_rabitq_scan_batch@d960",
                          "GIST-width inputs B=32 n=1M d=960")
    times.update(timing_rabitq_sample(a, errs, "rabitq_sample_ub_batch@d960",
                                      "the GIST-width RaBitQ sample"))
    times.update(timing_l2_dense(eng.stream.vectors, qs, errs,
                                 "l2_exact_batch@d960",
                                 "the dense straggler pass's shape"))
    sx, sq, smask = straggler_mask(eng, qs)
    times.update(timing_l2_masked(
        sx, sq, smask, errs, "l2_exact_masked_batch@d960",
        "the call's own straggler mask",
        dense_ms=times["l2_exact_batch@d960"]["ms"]))
    del sx, sq, smask
    budget = ((max(2 * RQ_K, 2048) + 127) // 128) * 128
    summary["gist_rabitq"] = {
        "corpus": [n, d], "n_clusters": c, "build_s": build_s,
        "recall_at_k_8q": rec,
        "band_mean": float(res.n_reranked.float().mean().item()),
        "stragglers_mean": float(res.n_second_pass.float().mean().item()),
        "stragglers_max": int(res.n_second_pass.max().item()),
        "straggler_budget": budget,
        "band_anatomy": band_anatomy(eng, qs, eng.predictor_init())}
    log(f"[gist-rabitq] {json.dumps(summary['gist_rabitq'])}")
    return times


def timing_plan(plan: dict, errs: dict, where: str) -> dict:
    """The sample plan at a path's real sample (phase 4's or phase 9's
    batch): bitwise its plain version on the same card tensors, in one
    launch a call, then timed beside its bound (the row and its mask read
    once, the codebooks and the bucket written once), the plain version
    (the composition the searchers ran before) and ``torch.topk`` alone at
    the same k_cb (the composition's first operator)."""
    import torch
    from repro_torch.kernels import ops, ref
    kw = {k: v for k, v in plan.items() if k not in ("vals", "ok")}
    vals, ok = plan["vals"], plan["ok"]
    b, w = vals.shape
    m, n_ew = plan["m"], 256
    before = dict(ops.LAUNCHES)
    got = ops.sample_plan_batch(vals, ok, **kw)
    n = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v - before[k]}
    check(n == {"sample_plan_batch": 1},
          f"sample_plan_batch at {where}: launches {n}")
    want = ref.sample_plan_batch(vals, ok, **kw)
    for g, r in zip(list(got[0]) + [got[1]], list(want[0]) + [want[1]]):
        errs["sample_plan_batch"] = max(errs.get("sample_plan_batch", 0.0),
                                        max_abs(g.float(), r.float()))
        check(same(g, r), f"sample_plan_batch at {where} (B={b}, w={w}, "
              f"k_cb={kw['k_cb']}) not bitwise its plain version")
    fn = lambda: ops.sample_plan_batch(vals, ok, **kw)  # noqa: E731
    s = ref.sample_values(vals, ok, plan.get("sqrt", False))
    t = dict(ms=cuda_ms(fn, 50),
             plain_ms=cuda_ms(lambda: ref.sample_plan_batch(vals, ok, **kw),
                              5, warm=1),
             library_ms=cuda_ms(lambda: torch.topk(
                 s, kw["k_cb"], dim=1, largest=False, sorted=True), 20),
             work={"B": b, "w": w, "k_cb": kw["k_cb"], "rank": kw["rank"],
                   "launch": ops._sample_plan_launch(w, m, n_ew)._asdict(),
                   "device_ms": device_ms(fn, "sample_plan_kernel")})
    # the (B, w) row (and mask) once; edges, d_min, delta, ew_map and tau
    t["bound_ms"], t["bound_by"] = bound(
        b * w * (4 + (ok is not None))
        + 4 * b * (m + 1 + 2 + n_ew + 1), 0)
    log(f"[timing] sample_plan_batch at {where} (B={b}, w={w}, k_cb="
        f"{kw['k_cb']}, rank {kw['rank']}): bitwise, {t['ms']:.4f} ms, kernel "
        f"{t['work']['device_ms']:.4f} ms (bound {t['bound_ms']:.4f} ms by "
        f"{t['bound_by']}), plain {t['plain_ms']:.4f} ms, torch.topk alone "
        f"{t['library_ms']:.4f} ms; launch {t['work']['launch']}")
    return t


def shard_kernel_args(forms, qs_main, qs_rq) -> dict:
    """The two compaction kernels' arguments as phase 11's static sharded
    PQ and RaBitQ paths build them for one batch (routing, the local scan,
    the gathered sample's codebooks and tau_spec)."""
    import torch
    from repro_torch.index import pq as pq_mod
    from repro_torch.index import search as S
    from repro_torch.kernels import ops
    e = forms["ivfpq_bbc"]
    st, lay, qs = e.stream, e.shard_layout, qs_main[:32]
    probed, valid, _ = S._routing(st, lay, qs, e.n_probe)
    est = S._sqrt_est(ops.pq_adc_batch(st.codes,
                                       pq_mod.adc_table(st.pq, qs)), valid)
    cbs, sample = S._sharded_codebooks(lay, probed, est, 4, e.cap_shard,
                                       e.n_cand, e.m, e.mesh)
    n_probed = valid.sum(dim=1)
    pq = dict(dists=est, valid=valid, d_min=cbs.d_min, delta=cbs.delta,
              ew_maps=cbs.ew_map, m=e.m,
              tau_spec=S._sample_spec_tau(cbs, sample, e.n_cand, n_probed,
                                          e.m),
              budget=S._shard_budget(None, e.n_cand, 1, est.shape[1], 2.0))
    e = forms["ivfrabitq_bbc"]
    st, lay, qs = e.stream, e.shard_layout, qs_rq[:32]
    probed, valid, d2 = S._routing(st, lay, qs, e.n_probe)
    g, nq = S._rabitq_query_terms(st, qs, d2)
    sample, _ = S._rabitq_sample_ub(st, lay, probed, g, nq, 4, e.cap_shard,
                                    RQ_EPS0)
    cbs, tau = S._rabitq_sample_plan(sample, e.k, e.k, 4, e.n_probe, e.m)
    out = ops.fused_rabitq_scan_batch(st.codes, st.vectors, st.s2, st.norm_o,
                                      st.f_o, st.cl, g, qs, nq, valid,
                                      cbs.d_min, cbs.delta, cbs.ew_map, e.m,
                                      tau, eps0=RQ_EPS0)
    rq = dict(bucket=out[3], valid=valid, tau_spec=tau,
              budget=S._shard_budget(None, e.k, 1, valid.shape[1], 4.0))
    torch.cuda.synchronize()
    return {"pq": pq, "rq": rq}


def timing_shard(a, errs: dict) -> dict:
    """The two compaction kernels at phase 11's inputs: checked against
    their plain versions once more, then timed beside their bounds (bytes:
    each input read once, every output written once)."""
    import torch
    from repro_torch.kernels import ops, ref
    p, r = a["pq"], a["rq"]
    args = (p["dists"], p["valid"], p["d_min"], p["delta"], p["ew_maps"],
            p["m"], p["tau_spec"], p["budget"])
    want6 = ref.shard_collect_batch(*args)
    check(all(torch.equal(x, y) for x, y in
              zip(ops.shard_collect_batch(*args), want6)),
          "shard_collect at phase 11's inputs differs from its plain version")
    cargs = (r["bucket"], r["valid"], r["tau_spec"], r["budget"])
    want7 = ref.spec_compact_batch(*cargs)
    check(all(torch.equal(x, y) for x, y in
              zip(ops.spec_compact_batch(*cargs), want7)),
          "spec_compact at phase 11's inputs differs from its plain version")
    b, n = p["valid"].shape
    m, n_ew, bud = p["m"], p["ew_maps"].shape[1], p["budget"]
    # dists + valid in, bucket out, hist, the position buffer, its ok flags
    # and counts out, per-query params in; per lane a subtract, a divide
    # and a floor
    t6 = dict(ms=cuda_ms(lambda: ops.shard_collect_batch(*args), 20),
              plain_ms=cuda_ms(lambda: ref.shard_collect_batch(*args), 3,
                               warm=1),
              library_ms=None,
              work={"B": b, "n": n, "budget": bud,
                    "matches": int(want6[4].sum().item()),
                    "device_ms": device_ms(
                        lambda: ops.shard_collect_batch(*args),
                        "shard_collect_kernel")})
    t6["bound_ms"], t6["bound_by"] = bound(
        9 * b * n + 4 * b * (m + 1) + 5 * b * bud + 4 * b
        + 4 * b * (n_ew + 3), 3 * b * n)
    b, n = r["valid"].shape
    bud = r["budget"]
    # bucket + valid in, the position buffer, its ok flags and counts out,
    # tau_spec in
    t7 = dict(ms=cuda_ms(lambda: ops.spec_compact_batch(*cargs), 20),
              plain_ms=cuda_ms(lambda: ref.spec_compact_batch(*cargs), 3,
                               warm=1),
              library_ms=None,
              work={"B": b, "n": n, "budget": bud,
                    "matches": int(want7[2].sum().item()),
                    "device_ms": device_ms(
                        lambda: ops.spec_compact_batch(*cargs),
                        "spec_compact_kernel")})
    t7["bound_ms"], t7["bound_by"] = bound(5 * b * n + 5 * b * bud + 8 * b,
                                           0)
    for name in ("shard_collect_batch", "spec_compact_batch"):
        errs[name] = max(errs.get(name, 0.0), 0.0)
    out = {"shard_collect_batch": t6, "spec_compact_batch": t7}
    for name, t in out.items():
        log(f"[timing] {name}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} "
            f"ms by {t['bound_by']}), plain {t['plain_ms']:.4f} ms, library "
            f"none; work {t['work']}")
    return out


# #9's kernel alone in PR 14, the batched kernel at one query (NVIDIA H100
# 80GB HBM3 at 700 W; torch.profiler over 20 calls)
FUSED_B1_PR14_MS = 0.0162


def fused_bq1(f):
    """One call of the batched fused-scan kernel (``fused_scan_kernel``) at
    one query over one list of every lane, launched here to time beside
    the one-query kernel #9 (no launch is counted).  ``f``: phase 12's
    arguments, (1, n) validity."""
    import torch
    from repro_torch.kernels import ops
    lib = ops._scan_lib()
    n, m_sub = f["codes"].shape
    d, m = f["vectors"].shape[1], f["m"]
    k_codes, n_ew = f["luts"].shape[2], f["ew_maps"].shape[1]
    est, bucket, early, hist, nmiss, counts = ops._scan_outputs(1, n, m, DEV)
    p = ops._batch_scan_plan(1, n, m_sub, k_codes, d, n_ew, m, ops._sms(0))
    probed, offsets = ops._one_list(n, DEV)
    par = [f[k].to(dt).contiguous() for k, dt in (
        ("d_min", torch.float32), ("delta", torch.float32),
        ("ew_maps", torch.int32), ("tau_pred", torch.int32))]
    rc = lib.fused_scan_batch_launch(
        f["codes"].data_ptr(), f["vectors"].data_ptr(), f["valid"].data_ptr(),
        f["luts"].data_ptr(), f["qs"].data_ptr(), *(t.data_ptr() for t in par),
        probed.data_ptr(), offsets.data_ptr(), est.data_ptr(),
        bucket.data_ptr(), early.data_ptr(), counts.data_ptr(), n, m_sub,
        k_codes, d, 1, n_ew, m, 1, 0, 0, p.blocks, p.smem, ops._stream())
    check(rc == 0, f"fused_scan_batch_launch at BQ=1 returned {rc}")
    return est[0], bucket[0], hist[0], early[0], nmiss[0]


def pq_single_args(eng, q) -> dict:
    """#10, #12 and #11's arguments as ``search.ivf_pq_search`` builds them
    for one (d,) query on an IVF+PQ+BBC engine: #10 and #12 over the probed
    rows, #11 over the early leg (the largest l2 call of that path:
    n_probe x early_budget rows)."""
    import torch
    from repro_torch.core import buffer as rb
    from repro_torch.core import numerics
    from repro_torch.index import ivf as ivf_mod
    from repro_torch.index import pq as pq_mod
    from repro_torch.kernels import ops
    ix = eng.index
    n_probe, n_cand, m = eng.n_probe, eng.n_cand, eng.m
    probed = ivf_mod.route(ix.ivf, q, n_probe)
    ids, valid = ivf_mod.gather_candidates(ix.ivf, probed)
    cap = ids.shape[1]
    flat_ids, flat_valid = ids.reshape(-1), valid.reshape(-1)
    codes = ix.codes[flat_ids.clamp(min=0)]
    lut = pq_mod.adc_table(ix.pq, q)
    est = numerics.sqrt_rn(torch.clamp(torch.where(
        flat_valid, ops.pq_adc(codes, lut), float("inf")), min=0.0))
    sample = torch.where(valid[:4], est.reshape(n_probe, cap)[:4],
                         float("inf")).reshape(1, -1)
    cb = rb.build_codebook(sample, k=min(n_cand, sample.shape[1]), m=m)
    early_budget = int(min(cap, max(128, round(n_cand / n_probe * 4.0))))
    early_budget = min(((early_budget + 127) // 128) * 128, cap)
    e_ids = ids[:, :early_budget].clamp(min=0)
    x = ix.vectors[e_ids.reshape(-1)]
    torch.cuda.synchronize()
    return dict(pq=dict(codes=codes, lut=lut),
                bh=(est, flat_valid, cb.d_min, cb.delta, cb.ew_map, m),
                l2=(x, q))


def check_pq_single(a, errs: dict, where: str) -> dict:
    """#10, #12 and #11 bitwise against their plain versions on
    ``pq_single_args``'s tensors.  Returns the shapes checked."""
    import torch
    from repro_torch.kernels import ops, ref
    c, lt = a["pq"]["codes"], a["pq"]["lut"]
    check(torch.equal(ops.pq_adc(c, lt), ref.pq_adc(c, lt)),
          f"pq_adc at {where}")
    x, q = a["l2"]
    check(torch.equal(ops.l2_exact(x, q), ref.l2_exact(x, q)),
          f"l2_exact at {where}")
    bh = a["bh"]
    check(all(torch.equal(x_, y_) for x_, y_ in
              zip(ops.bucket_hist(*bh), ref.bucket_hist(*bh))),
          f"bucket_hist at {where}")
    for k in NET_KERNELS:
        errs[k] = max(errs.get(k, 0.0), 0.0)
    shapes = {"pq_adc": list(c.shape), "l2_exact": list(x.shape),
              "bucket_hist": [bh[0].shape[0], bh[5]]}
    log(f"[kernels] pq_adc (n, M), l2_exact (n, d), bucket_hist (n, m) "
        f"bitwise at {where}: {shapes}")
    return shapes


def single_kernel_args(pq_eng, rq_eng, q_pq, q_rq) -> dict:
    """The single-query kernels' arguments as phase 12's paths build them
    for one query: #8 over the RaBitQ query's probed tiles, #10, #12 and
    #11 as ``pq_single_args`` builds them, #9 as the predictive singleton
    launches it (the whole stream, one probe mask)."""
    import torch
    from repro_torch.index import ivf as ivf_mod
    from repro_torch.index import rabitq as rq_mod
    rix = rq_eng.index
    # #8: ivf_rabitq_search's estimate
    probed = ivf_mod.route(rix.ivf, q_rq, rq_eng.n_probe)
    ids, valid = ivf_mod.gather_candidates(rix.ivf, probed)
    safe = ids.clamp(min=0)
    qf = rq_mod.query_factors(rix.rq, q_rq, rix.ivf.centroids[probed])
    rqe = dict(codes=rix.rq.codes[safe], norm_o=rix.rq.norm_o[safe],
               f_o=rix.rq.f_o[safe], v=qf.v, norm_q=qf.norm_q, valid=valid)
    fused = main_path_kernel_args(pq_eng, q_pq[None])
    torch.cuda.synchronize()
    return dict(rqe=rqe, fused=fused, **pq_single_args(pq_eng, q_pq))


def timing_single(a, errs: dict) -> dict:
    """Kernels #8-#12 at phase 12's single-query shapes: checked against
    their plain versions once more, then timed beside their bounds (each
    input read once, each output written once; #8 reads only the valid
    lanes' rows).  ``ms`` times the wrapper call as the path makes it;
    ``work.device_ms`` is the kernel alone (``device_ms``)."""
    import torch
    from repro_torch.kernels import ops, ref
    out = {}
    r = a["rqe"]
    check_rabitq_est(r, errs, "phase 12's RaBitQ query")
    args = [r[k] for k in RQE_ARGS]
    t, cap, d = r["codes"].shape
    n_valid = int(r["valid"].sum().item())
    out["rabitq_est"] = dict(
        ms=cuda_ms(lambda: ops.rabitq_est_tiles(*args, eps0=RQ_EPS0), 20),
        plain_ms=cuda_ms(lambda: ref.rabitq_est_tiles(*args, eps0=RQ_EPS0),
                         3, warm=1),
        library_ms=None, work={"T": t, "cap": cap, "d": d,
                               "valid_lanes": n_valid})
    out["rabitq_est"]["bound_ms"], out["rabitq_est"]["bound_by"] = bound(
        n_valid * (d + 8) + t * cap + 4 * t * (d + 1) + 12 * t * cap,
        n_valid * (2 * d + 20))
    # the same launch with every lane padding: what it costs to read the
    # validity and write +inf, with no row read
    pad = [torch.zeros_like(x) if k == "valid" else x
           for k, x in zip(RQE_ARGS, args)]
    out["rabitq_est"]["work"]["device_ms_all_padding"] = device_ms(
        lambda: ops.rabitq_est_tiles(*pad, eps0=RQ_EPS0), "rabitq_est_kernel")

    check_pq_single(a, errs, "phase 12's shapes")
    c, lt = a["pq"]["codes"], a["pq"]["lut"]
    n, m_sub = c.shape
    k_codes = lt.shape[1]
    out["pq_adc"] = dict(
        ms=cuda_ms(lambda: ops.pq_adc(c, lt), 20),
        plain_ms=cuda_ms(lambda: ref.pq_adc(c, lt), 3, warm=1),
        library_ms=None, work={"n": n, "M": m_sub})
    out["pq_adc"]["bound_ms"], out["pq_adc"]["bound_by"] = bound(
        n * m_sub + 4 * m_sub * k_codes + 4 * n, n * m_sub)

    x, q = a["l2"]
    n, d = x.shape
    out["l2_exact"] = dict(
        ms=cuda_ms(lambda: ops.l2_exact(x, q), 20),
        plain_ms=cuda_ms(lambda: ref.l2_exact(x, q), 5, warm=1),
        library_ms=cuda_ms(lambda: torch.cdist(q[None], x), 5, warm=1),
        work={"n": n, "d": d})
    out["l2_exact"]["bound_ms"], out["l2_exact"]["bound_by"] = bound(
        4 * n * d + 4 * d + 4 * n, 3 * n * d)

    bh = a["bh"]
    n, m, n_ew = bh[0].shape[0], bh[5], bh[4].shape[-1]
    out["bucket_hist"] = dict(
        ms=cuda_ms(lambda: ops.bucket_hist(*bh), 20),
        plain_ms=cuda_ms(lambda: ref.bucket_hist(*bh), 3, warm=1),
        library_ms=None, work={"n": n, "m": m})
    out["bucket_hist"]["bound_ms"], out["bucket_hist"]["bound_by"] = bound(
        9 * n + 4 * (m + 1) + 4 * (n_ew + 2), 4 * n)

    f = a["fused"]
    fargs = (f["codes"], f["vectors"], f["valid"][0], f["luts"][0],
             f["qs"][0], f["d_min"], f["delta"], f["ew_maps"], f["m"],
             f["tau_pred"])
    got = ops.fused_scan(*fargs)
    want = ref.fused_scan(*fargs)
    bq1 = fused_bq1(f)
    for form, outs in (("one-query kernel", got),
                       ("batched kernel at one query", bq1)):
        check(all(same(x_, y_) for x_, y_ in zip(outs, want)),
              f"fused_scan ({form}) at phase 12's shapes differs from the "
              f"plain version")
    n, m_sub = f["codes"].shape
    d, m = f["vectors"].shape[1], f["m"]
    k_codes, n_ew = f["luts"].shape[2], f["ew_maps"].shape[1]
    valid = f["valid"][0]
    pred = valid & (got[1] <= f["tau_pred"][0])
    n_valid, n_pred = int(valid.sum().item()), int(pred.sum().item())
    out["fused_scan"] = dict(
        ms=cuda_ms(lambda: ops.fused_scan(*fargs), 20),
        plain_ms=cuda_ms(lambda: ref.fused_scan(*fargs), 3, warm=1),
        library_ms=None, work={"n": n, "lanes_probed": n_valid,
                               "lanes_predicted": n_pred})
    out["fused_scan"]["bound_ms"], out["fused_scan"]["bound_by"] = bound(
        n_valid * m_sub + n_pred * d * 4 + n + 12 * n + 4 * (m + 2)
        + 4 * (m_sub * k_codes + d + n_ew + 3), n_valid * m_sub + 3 * d * n_pred)
    calls = {"rabitq_est": (lambda: ops.rabitq_est_tiles(*args, eps0=RQ_EPS0),
                            "rabitq_est_kernel"),
             "pq_adc": (lambda: ops.pq_adc(c, lt), "pq_adc_"),
             "l2_exact": (lambda: ops.l2_exact(x, q), "l2_"),
             "bucket_hist": (lambda: ops.bucket_hist(*bh),
                             "bucket_hist_kernel"),
             "fused_scan": (lambda: ops.fused_scan(*fargs),
                            "fused_scan_b1_kernel")}
    for name, (fn, kernel) in calls.items():
        out[name]["work"]["device_ms"] = device_ms(fn, kernel)
    # #9's kernel beside the batched kernel at one query
    # (FUSED_B1_PR14_MS: the design before #9)
    fw = out["fused_scan"]["work"]
    fw["device_ms_batched_kernel_bq1"] = device_ms(lambda: fused_bq1(f),
                                                   "fused_scan_kernel<")
    # what the launch costs with no predicted row (tau_pred -1) and with no
    # valid lane (only the +inf stores)
    fw["device_ms_no_predicted_row"] = device_ms(
        lambda: ops.fused_scan(*fargs[:-1], -1), "fused_scan_b1_kernel")
    none = torch.zeros_like(fargs[2])
    fw["device_ms_no_valid_lane"] = device_ms(
        lambda: ops.fused_scan(*fargs[:2], none, *fargs[3:]),
        "fused_scan_b1_kernel")
    fw["device_ms_pr14"] = FUSED_B1_PR14_MS
    for name, tm in out.items():
        log(f"[timing] {name}: {tm['ms']:.4f} ms (bound {tm['bound_ms']:.4f} "
            f"ms by {tm['bound_by']}), plain {tm['plain_ms']:.4f} ms, library "
            f"{tm['library_ms']}; work {tm['work']}"
            f"{against_row_kernel(name, tm)}")
    return out


def profile(eng, qs, b: int = 32, batches: int = 3,
            single: bool = False) -> dict:
    """torch.profiler over a few warm main-path batches (``single``: one
    (d,) query per call, ``batches`` of them): device time by operator (per
    call) and the device's busy share of the window."""
    qb = [qs[i] if single else qs[i * b:(i + 1) * b]
          for i in range(batches)]
    eng.search(qb[0])
    return profile_calls([lambda q=q: eng.search(q) for q in qb], "batch")


def profile_calls(calls, unit: str) -> dict:
    """torch.profiler over ``calls`` (warm): device time by kernel and by
    operator per call, and the device's busy share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    n = len(calls)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    cuda_type = torch.autograd.DeviceType.CUDA
    busy_ms = sum(e.device_time for e in prof.events()
                  if e.device_type == cuda_type) / 1e3
    out = {f"wall_ms_per_{unit}": wall_ms / n,
           f"device_busy_ms_per_{unit}": busy_ms / n,
           "device_idle_share": 1.0 - busy_ms / wall_ms}
    log(f"[profile] wall {wall_ms / n:.3f} ms/{unit}, device busy "
        f"{busy_ms / n:.3f} ms/{unit}, idle share "
        f"{out['device_idle_share']:.3f}")
    # device kernels by name, and the PyTorch operators that launched them
    # (an operator's self device time is the time of its own kernels)
    for label, keep in (("kernels", lambda ev: ev.device_type == cuda_type),
                        ("operators", lambda ev: ev.key.startswith("aten::"))):
        rows = sorted(((ev.key, ev.self_device_time_total / 1e3 / n,
                        ev.count / n) for ev in prof.key_averages()
                       if keep(ev) and ev.self_device_time_total > 0),
                      key=lambda r: -r[1])[:15]
        out[label] = [{"name": k, f"device_ms_per_{unit}": t,
                       f"calls_per_{unit}": c} for k, t, c in rows]
        for k, t, c in rows:
            log(f"[profile] {label[:-1]:8s} {t:9.4f} ms {c:6.1f}x  {k[:90]}")
    return out


def profile_train(steps: int = 3) -> dict:
    """Phase 8 with 20: torch.profiler over ``steps`` warm train steps of
    phase 20(a)'s model and batch (full-width bf16 ``smollm-135m``, B=8 x
    S=1024, one ``TokenPipeline`` batch)."""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import model as model_mod
    from repro_torch.optim import adamw
    cfg = configs.get(TRAIN_KW["arch"], smoke=TRAIN_KW["smoke"])
    m = model_mod.build(cfg)
    params = m.init(torch.Generator().manual_seed(SEED), device=DEV)
    state = [params, adamw.init(params)]
    step = model_mod.make_train_step(m, adamw.AdamWConfig(
        warmup_steps=10, total_steps=TRAIN_KW["steps"]))
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in TokenPipeline(
        cfg.vocab, TRAIN_KW["batch"], TRAIN_KW["seq"],
        seed=SEED).batch_at(0).items()}

    def one():
        state[0], state[1], _ = step(state[0], state[1], batch)

    for _ in range(2):
        one()
    log(f"[profile] {steps} train steps of phase 20(a):")
    return profile_calls([one] * steps, "step")


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,9,11,12,13,14,15,16,17,18,19,20,"
                            "21,22",
                    help="comma-separated phases to run (default 1-7, 9 and "
                         "11-22; 8 = torch.profiler over the batches of "
                         "4, 9 and 11, the queries of 12 and the train "
                         "steps of 20; 10 = phase 9's band anatomy)")
    ap.add_argument("--out", default="",
                    help="also write the summary JSON to this path")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.platform import tf32_off

    card = smi()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    check(tf32_off(), "TF32 must be off")
    summary: dict = {"card": card}

    t0 = time.monotonic()
    _build.build_all()
    summary["build_s"] = time.monotonic() - t0
    log(f"[build] {len(_build.KERNELS)} kernels in {summary['build_s']:.1f}s")
    for kname, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "Function properties" in line):
                log(f"[ptxas] {kname}: {line.strip()}")

    errs: dict = {}
    if 3 in phases:
        rng = np.random.default_rng(SEED)
        check_kernels(kernel_inputs(rng, 32, 1_000_064, 32, 128), errs,
                      "main-path shapes B=32 n=1000064 M=32 d=128")
        check_kernels(kernel_inputs(rng, 3, 1000, 33, 100, m=64, density=0.9),
                      errs, "ragged B=3 n=1000 M=33 d=100")
        check_kernels(kernel_inputs(rng, 64, 20_001, 24, 960), errs,
                      "tile edges B=64 n=20001 M=24 d=960")
        check_tile_edges(errs)
        check_rabitq_kernel(rabitq_kernel_inputs(SEED, 32, 1_000_064, 128,
                                                 1024),
                            errs, "full-width B=32 n=1000064 d=128 C=1024")
        check_rabitq_kernel(rabitq_kernel_inputs(SEED + 1, 3, 1000, 100, 7,
                                                 m=64, density=0.9),
                            errs, "ragged B=3 n=1000 d=100")
        for b, n, budgets, dens in ((32, 1_000_064, (80_128, 20_224, 4096),
                                     0.0625),
                                    (32, 125_056, (10_112, 2_560, 512),
                                     0.0625),
                                    (3, 1000, (1500, 24), 0.9),
                                    # more chunks of one query than the
                                    # card holds blocks at once
                                    (1, 1100 * 4096 + 123, (300_000, 20_000),
                                     0.0625)):
            check_shard_collect(shard_collect_inputs(SEED + n, b, n,
                                                     density=dens),
                                budgets, errs, f"B={b} n={n}")
        check_single_kernels(errs)
        check_bucket_hist_edges(errs)
        check_fused_edges(errs)
        check_sqrt_rn(summary)
        check_delta_scan(errs)
        check_tombstones(errs, summary)

    launches = {k: 0 for k in ops.LAUNCHES}
    eng = qb = main_queries = x = rq_eng = rq_queries = rq_state = None
    if 4 in phases:
        eng, main_queries, l4, x = main_path(summary, card)
        qb = main_queries[:32]
        launches = {k: launches[k] + l4[k] for k in launches}
    if 9 in phases:
        rq_eng, rq_queries, l9, rq_state = rabitq_path(summary, card, x,
                                                       main_queries)
        launches = {k: launches[k] + l9[k] for k in launches}
    if 5 in phases:
        parity(summary)
    ivf_eng = ivf_x = ivf_queries = shard_forms = None
    if 6 in phases:
        l6, ivf_eng, ivf_x, ivf_queries = other_forms(summary, card)
        l6b = pq8_path(summary, card)
        launches = {k: launches[k] + l6[k] + l6b[k] for k in launches}
    if 12 in phases:
        check(None not in (eng, rq_eng, ivf_eng), "phase 12 serves single "
              "queries on the indexes of phases 4, 9 and 6 and needs them")
        l12 = single_path(summary, card, eng, rq_eng, ivf_eng, main_queries,
                          rq_queries, x, ivf_x, ivf_queries)
        launches = {k: launches[k] + l12[k] for k in launches}
    if 11 in phases:
        check(None not in (eng, rq_eng, ivf_eng), "phase 11 shards the "
              "indexes of phases 4, 9 and 6 and needs them")
        l11, shard_forms = sharded_path(summary, card, eng, rq_eng, ivf_eng,
                                        main_queries, rq_queries, x, ivf_x,
                                        ivf_queries)
        launches = {k: launches[k] + l11[k] for k in launches}
    if 13 in phases:
        l13 = async_serving(summary, card)
        launches = {k: launches[k] + l13[k] for k in launches}
    if 14 in phases:
        check(eng is not None, "phase 14 takes phase 4's corpus and needs it")
        l14 = ingest_path(summary, card, x, main_queries, prof=8 in phases)
        launches = {k: launches[k] + l14[k] for k in launches}
    if 15 in phases:
        l15 = replica_tier(summary, card)
        launches = {k: launches[k] + l15[k] for k in launches}
    if 16 in phases:
        check(eng is not None, "phase 16 tunes phase 4's index and needs it")
        l16 = tuning_path(summary, card, eng, x, main_queries)
        launches = {k: launches[k] + l16[k] for k in launches}
    if 17 in phases:
        l17 = net_serving(summary, card, errs)
        launches = {k: launches[k] + l17[k] for k in launches}
    if 18 in phases:
        l18 = replica_sharded(summary, card)
        launches = {k: launches[k] + l18[k] for k in launches}
    if 19 in phases:
        lm_decode(summary, card)
        smoke_configs_on_card(summary, card)
        l19 = retrieval(summary, card)
        launches = {k: launches[k] + l19[k] for k in launches}
    if 20 in phases:
        # the training path takes none of the twelve kernels: a launch
        # here would be a stray search
        ops.reset_launches()
        train_full(summary, card)
        smoke_train_on_card(summary, card)
        train_example(summary, card)
        l20 = {k: v for k, v in ops.LAUNCHES.items() if v}
        log(f"[train] kernel launches over phase 20: {l20 or 'none'}")
        check(not l20, f"phase 20 launched search kernels: {l20}")
    if 21 in phases:
        l21 = phase21(summary, card)
        launches = {k: launches[k] + l21[k] for k in launches}
    times = {}
    if 22 in phases:
        times.update(gist_rabitq(summary, errs))
    if 7 in phases:
        check(eng is not None, "phase 7 times the kernels at the main path's "
              "shapes and needs phase 4")
        main_args = main_path_kernel_args(eng, qb)
        times = timing(main_args)
        times.update(timing_sample(main_args, errs))
        times["sample_plan_batch"] = timing_plan(
            main_args["plan"], errs, "the main path's sample")
        times.update(timing_gather(second_pass_args(eng, qb), errs,
                                   "l2_gather_rows_batch",
                                   "phase 4's second pass"))
        times.update(timing_gather(d960_gather_args(), errs,
                                   "l2_gather_rows_batch@d960",
                                   "the d960 cell's shapes"))
        times.update(timing_delta(errs))
        times.update(timing_chunked(d960_pq8_scan_args(), errs))
        times.update(timing_deep10m(deep10m_scan_args(), errs))
        times["probe_mask_batch"] = timing_mask(
            mask_args(32, 10_000_000, 4096, 64, SEED + 11), errs,
            "the deep-10M cell's shapes")
        times["probe_mask_batch@1m"] = timing_mask(
            mask_args(32, 1_000_064, 1024, 64, SEED + 12), errs,
            "the 1M cells' shapes")
        if rq_eng is not None:
            rq_args = rabitq_kernel_args(rq_eng, rq_queries[:32])
            times.update(timing_rabitq(rq_args, errs))
            times.update(timing_rabitq_sample(rq_args, errs))
            times["sample_plan_batch@rabitq"] = timing_plan(
                rq_args["plan"], errs, "the RaBitQ path's sample")
        if shard_forms is not None:
            times.update(timing_shard(
                shard_kernel_args(shard_forms, main_queries, rq_queries),
                errs))
        if rq_eng is not None:
            times.update(timing_single(
                single_kernel_args(eng, rq_eng, main_queries[0],
                                   rq_queries[0]), errs))
    if times:
        summary["timing"] = times
    if 8 in phases:
        check(eng is not None or rq_eng is not None or 20 in phases,
              "phase 8 profiles the paths of phases 4, 9, 11 and 20: needs "
              "one")
        if eng is not None:
            summary["profile"] = profile(eng, main_queries)
        if rq_eng is not None:
            log("[profile] the IVF+RaBitQ path (phase 9), fused static:")
            summary["profile_rabitq"] = profile(rq_eng, rq_queries)
        if shard_forms is not None:
            log("[profile] the sharded IVF+PQ path (phase 11), static:")
            summary["profile_sharded"] = profile(shard_forms["ivfpq_bbc"],
                                                 main_queries)
        if eng is not None and 12 in phases:
            log("[profile] single IVF+PQ+BBC queries (phase 12):")
            summary["profile_single"] = profile(eng, main_queries,
                                                batches=8, single=True)
        if 20 in phases:
            summary["profile_train"] = profile_train()
    if 10 in phases:
        check(rq_eng is not None, "phase 10 reads phase 9's engine")
        summary["band_anatomy"] = band_anatomy(rq_eng, rq_queries[:32],
                                               rq_state)
        log(f"[band] {json.dumps(summary['band_anatomy'])}")
    if {4, 6, 9, 11, 12, 13, 14, 15, 16} <= phases:
        for k, v in launches.items():
            check(v > 0, f"kernel {k} never launched on the paths")

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    rows = []
    for kname, (src, replaces) in KERNELS.items():
        t = times.get(kname, {})
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kname],
                     "max_abs_err": errs.get(kname),
                     "ms": t.get("ms"), "plain_ms": t.get("plain_ms"),
                     "bound_ms": t.get("bound_ms"),
                     "bound_by": t.get("bound_by"),
                     "library_ms": t.get("library_ms")})
    print(json.dumps({"kernel_launches": launches}))
    print(smi())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
