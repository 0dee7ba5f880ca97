// Fused scan: ADC estimate + Eq. 6 bucket + (B, m+1) histogram + inline
// exact distance of the predicted lanes + miss count, in one pass over the
// shared candidate stream.  Three kernels: the batched one (B > 1), a
// one-query form (B = 1) and, where one query's LUT outgrows a block's
// shared memory, a chunked-LUT form at any B, chosen by the wrapper
// (kernels/ops.py).
//
// Replaces: src/repro/kernels/fused_scan.py::fused_scan_batch_pallas (and
// its helper bucketize_hist_tile) with fused_scan_kernel and, past the
// whole-LUT limit, fused_scan_chunked_kernel, and ::fused_scan_pallas (the
// one-query kernel) with fused_scan_b1_kernel (past the limit, the chunked
// kernel at one query).
// Plain versions: kernels/ref.py fused_scan_batch and fused_scan.
//
// What bounds it on an H100.  The batched kernel walks only the lanes of
// each query's probed lists (1.5% of the (query, lane) pairs at the
// deep-10M shapes, 6% at the 1M cells'), so the floor is the probed bytes:
// a code row and a mask byte per probed pair, 12 bytes of outputs per
// probed pair, the fp32 rows of the predicted lanes; at B = 32, n = 10M,
// 64 of 4,096 lists a query, 0.260 GB, 0.0777 ms at 3.35 TB/s.  Walking
// every lane instead (the design before: the (B, n) mask read and three
// (B, n) outputs written) is 4.408 GB, 1.3157 ms.  Within the walk, the
// predicted rows carry a latency chain (each row summed by its own thread,
// the rows of the nearest lists first in every query's walk), and the
// valid lanes one of mask byte, code row, LUT words and the bucket's
// division.  The exact leg is the direct sum of (x - q)^2 in the plain
// version's order (see scan_common.cuh).
//
// What the design does about it.
//  Batched kernel (B > 1):
//  * One query a block (blockIdx.y): its LUT (1.5 KB at M = 24, 2 KB at
//    M = 32, 15 KB at M = 240, 4 bits a code), query row, ew_map and
//    parameters are staged once, and its P lists' sizes are summed into a
//    running sum in shared memory (warp 0's shuffle scan).  The lists, laid
//    end to end nearest first, make one virtual range of W lanes; a thread
//    maps its virtual lane to (list, offset) by a binary search of that
//    sum, so a 256-lane tile may straddle lists, and lanes of no walked
//    list are neither read nor written.
//  * A block walks tile blockIdx.x, then every gridDim.x-th: consecutive
//    tiles go to consecutive blocks, so the nearest lists, which hold the
//    predicted rows, spread over the SMs.  The grid (ops._batch_scan_plan)
//    is two waves of four blocks an SM split over the queries, 33 blocks a
//    query at B = 32, bounded by the tiles of P x the largest list: it is
//    known on the host, so the call adds no sync.
//  * Each walked lane reads its mask byte (tombstones stay exact) and does
//    the plain version's arithmetic: the ADC sum in ascending m from a
//    code row read as 16- or 8-byte words where M and the row allow, the
//    bucket, the threshold, and the predicted row's exact sum with its
//    16-byte words loaded kRowLoads at a time before their adds, in
//    ascending coordinates; a walked lane off the mask is written (+inf,
//    bucket of +inf, +inf).  Every output it writes is the plain version's
//    bit for bit; the rest of the (B, n) outputs is left unwritten, and
//    the callers read them only on the mask.
//  * Histogram bins below m are shared-memory atomics; bucket m and the
//    misses are counted per warp by ballot; one atomicAdd per nonzero bin
//    folds a block into the globals, which the launch function zeroes with
//    one memset together with each query's walked-lane count (written by
//    the query's first block).
//  Tried on an H100 80GB HBM3 (B = 32, n = 10M, 64 of 4,096 lists a query,
//  ~12,500 lanes predicted a query; kernel ms from torch.profiler): the
//  same kernel over one list of every lane, 2.19; over the lists, 0.200,
//  of which no predicted row 0.107 and no valid lane 0.050.  Kept: two
//  waves of four blocks an SM (one wave 0.304, three 0.230, eight 0.218;
//  64 registers); dropped: six blocks an SM (40 registers, 0.236-0.258)
//  and eight (32 registers with spills, 0.215-0.252).  The row loaded 1,
//  4 or 8 words at a time: 0.2073 / 0.2058 / 0.2005 ms here, 0.992 /
//  0.989 / 0.912 at the d960 4-bit shapes (3.84 KB rows).
//  One-query kernel (B = 1).  The batched kernel at B = 1 ran a (1, 1024)
//  grid of 256-lane blocks, each staging the LUT, query and ew_map and
//  zeroing and flushing a histogram for four tiles of work, with a serial
//  chain of M one-byte code loads, one shared histogram and one miss
//  counter per block (at k = 5000 most valid lanes fall in bucket m and
//  miss, so a warp's 32 atomics hit one word), and each predicted row read
//  by its own thread 16 bytes at a time, one round trip after another.
//  Here:
//   1. persistent blocks, about as many as the SMs hold, stage the LUT,
//      query and ew_map once; their warps take 32-lane tiles round robin,
//      consecutive tiles to consecutive blocks, so a probed cluster's
//      lanes spread over about 30 SMs: the valid lanes (1 in 16, in runs
//      of whole clusters) and above all the predicted ones (the nearest
//      clusters' lanes, each a 512-byte row to read) are latency and
//      per-SM traffic, not device bytes.  A thread loads its validity in
//      its first 32 tiles at once.  (Tried on an H100 80GB HBM3 and
//      dropped: 1,024-lane tiles, four lanes a thread with 16-byte stores,
//      1.6-3x slower than the design before; 256-lane block tiles, 0.0117
//      ms against 0.0188 for the design before, the rows of the nearest
//      clusters piling on a few SMs.)
//   2. a warp with no valid lane stores (+inf, bucket of +inf, +inf) with
//      no division (bbc::bucket_of_inf) and reads no code;
//   3. the code rows of M = 16, 24 or 32 bytes load as whole 16- or 8-byte
//      words, all at once; the adds stay in ascending m;
//   4. each warp counts into its own shared histogram; bucket m and the
//      misses are counted per warp by ballot and popcount, with no atomic;
//      a block with no valid lane skips the flush;
//   5. a predicted lane's thread sums its own row in ascending coordinate
//      order (bbc::sq_dists), bitwise the plain version's sum.  Tried and
//      dropped, none faster: rows staged through shared memory by the
//      whole warp, four a round, each summed by one thread (the predicted
//      lanes are the nearest clusters', so a warp may hold 32 and the
//      rounds queue); each thread's row copied into its own slot with
//      cp.async (a third of the blocks an SM holds); the row's lines
//      prefetched into L1 or L2, or loaded with 256-byte L2 fills; the
//      tiles with a valid lane taken first.  The predicted rows add ~3.4
//      us to the ~8 us the kernel takes without them; their loads appear
//      to wait behind the other warps' 12 MB of stores;
//   6. the histogram and nmiss are zeroed by one memset in the launch
//      function, with no PyTorch call between it and the kernel.
//  Chunked-LUT kernel (any B, where one query's LUT outgrows a block: at
//  8-bit codes, K = 256, a query's LUT is M KB, 240 KB at GIST1M's M =
//  240).  Both kernels above stage every LUT a block uses whole, and the
//  batched one does so in each of up to 1,024 lane-tile blocks a query
//  chunk: at K = 256 that would be 8 GB of LUT copies a call of 32 queries.
//  Here:
//   1. a block takes one query and a fixed set of 1,024-lane tiles
//      (blockIdx.y, then every gridDim.y-th), and walks them once for each
//      chunk of mc sub-quantizers, staging only that chunk of its query's
//      LUT: each block loads its query's LUT once, so the plan's gridDim.y
//      is the number of loads a query.  (Tried on an H100 80GB HBM3 and
//      dropped: two queries a block, with 80 sub-quantizers a chunk, ran
//      3-10% slower at the 8-bit cell's shapes; four spilled registers.)
//   2. the sum over m ascending is carried from chunk to chunk in ``est``
//      by the lane's own thread (a valid lane's partial sum, written at the
//      end of a chunk and read at the start of the next): the same fp32
//      adds in the same order as the plain version's, from a -0.0 start,
//      so the estimate, and with it bucket, histogram, tau test, early
//      exact distance and nmiss, are bitwise the plain version's;
//   3. the last chunk finishes the lane as the batched kernel does: bucket,
//      histogram, threshold, the predicted row's exact sum (bbc::sq_dists)
//      and the outputs; bucket m and the misses are counted per warp by
//      ballot.  (Tried on an H100 80GB HBM3 and dropped: the row's sum with
//      four 16-byte loads issued before its adds, 2.06 ms a call at the
//      8-bit cell's shapes against 1.75.)
//   4. 1,024 threads a block and one block an SM (a chunk takes ~130 KB):
//      the threads hide the code, LUT and row reads' latency.
// Integer adds commute, so bucket, hist and nmiss equal the plain version's
// under any block schedule.
#include "scan_common.cuh"

namespace {

constexpr float kInf = __builtin_huge_valf();

constexpr int kWarps = bbc::kThreads / 32;
constexpr int kListBlocksPerSm = 4;                   // ops.FS_LIST_BLOCKS_PER_SM
constexpr unsigned kFull = 0xffffffffu;

// sum over m ascending of LUT[m, code[m]] for one code row of M bytes: W =
// 16 or 8, the row read as whole words of W bytes (M a multiple of W, the
// row on a W-byte boundary); W = 0, a byte at a time.  The adds are the
// plain version's: fp32, from 0, in ascending m.
template <int W>
__device__ __forceinline__ float adc_row(const uint8_t* __restrict__ row,
                                         int M, int K, const float* lut_s) {
  float acc = 0.f;
  if constexpr (W == 0) {
    for (int mm = 0; mm < M; ++mm)
      acc = __fadd_rn(acc, lut_s[mm * K + __ldg(row + mm)]);
  } else {
#pragma unroll 4
    for (int t = 0; t < M / W; ++t) {
      unsigned w[W / 4];
      if constexpr (W == 16) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(row) + t);
        w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
      } else {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(row) + t);
        w[0] = x.x; w[1] = x.y;
      }
      const float* l = lut_s + W * t * K;
#pragma unroll
      for (int u = 0; u < W; ++u)
        acc = __fadd_rn(acc, l[u * K + ((w[u >> 2] >> (8 * (u & 3))) & 0xffu)]);
    }
  }
  return acc;
}

// |x - q|^2 over one vector row, bbc::sq_dists<1>'s sum (ascending
// coordinates, no contraction), with the row's 16-byte words loaded
// kRowLoads at a time before their adds where the row allows them.
constexpr int kRowLoads = 8;

__device__ __forceinline__ float row_sq(const float* __restrict__ xr,
                                        const float* q_s, int d) {
  float acc = 0.f;
  if ((d & 3) != 0 || (reinterpret_cast<uintptr_t>(xr) & 15) != 0) {
    bbc::sq_dists<1>(xr, q_s, d, &acc);
    return acc;
  }
  const float4* x4 = reinterpret_cast<const float4*>(xr);
  const int words = d / 4;
  int t = 0;
  for (; t + kRowLoads <= words; t += kRowLoads) {
    float4 x[kRowLoads];
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) x[u] = __ldg(x4 + t + u);
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u) {
      const float* q = q_s + 4 * (t + u);
      acc = bbc::add_sq(acc, x[u].x, q[0]);
      acc = bbc::add_sq(acc, x[u].y, q[1]);
      acc = bbc::add_sq(acc, x[u].z, q[2]);
      acc = bbc::add_sq(acc, x[u].w, q[3]);
    }
  }
  for (; t < words; ++t) {
    const float4 x = __ldg(x4 + t);
    const float* q = q_s + 4 * t;
    acc = bbc::add_sq(acc, x.x, q[0]);
    acc = bbc::add_sq(acc, x.y, q[1]);
    acc = bbc::add_sq(acc, x.z, q[2]);
    acc = bbc::add_sq(acc, x.w, q[3]);
  }
  return acc;
}

// One query a block (blockIdx.y); its P probed lists (cluster ids
// probed[q * pstride + j], nearest first, lanes [offsets[c], offsets[c+1])
// of the stream) laid end to end as a virtual range [0, W_q), walked in
// kThreads-lane tiles: tile blockIdx.x, then every gridDim.x-th.
template <int W>
__global__ void __launch_bounds__(bbc::kThreads, kListBlocksPerSm)
fused_scan_kernel(const uint8_t* __restrict__ codes,
                  const float* __restrict__ vectors,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ luts,
                  const float* __restrict__ qs,
                  const float* __restrict__ d_min,
                  const float* __restrict__ delta,
                  const int* __restrict__ ew_maps,
                  const int* __restrict__ tau_pred,
                  const int64_t* __restrict__ probed,
                  const int64_t* __restrict__ offsets,
                  float* __restrict__ est, int* __restrict__ bucket,
                  float* __restrict__ early, int* __restrict__ hist,
                  int* __restrict__ nmiss, int* __restrict__ walked, int n,
                  int M, int K, int d, int n_ew, int m, int P,
                  int pstride) {
  extern __shared__ __align__(16) float smem[];
  const int q = blockIdx.y;
  const int m1 = m + 1;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  float* lut_s = smem;                                  // M * K
  float* q_s = lut_s + M * K;                           // d
  int* ew_s = reinterpret_cast<int*>(q_s + d);          // n_ew
  int* hist_s = ew_s + n_ew;                            // m1
  int* miss_s = hist_s + m1;                            // 1
  int* pre_s = miss_s + 1;                              // P + 1
  int* start_s = pre_s + P + 1;                         // P

  bbc::stage_rows(lut_s, luts, q, 1, M * K);
  bbc::stage_rows(q_s, qs, q, 1, d);
  bbc::stage_rows(ew_s, ew_maps, q, 1, n_ew);
  for (int i = threadIdx.x; i < m1; i += blockDim.x) hist_s[i] = 0;
  if (threadIdx.x == 0) miss_s[0] = 0;
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    const int64_t c = probed[static_cast<size_t>(q) * pstride + j];
    const int64_t s = offsets[c];
    start_s[j] = static_cast<int>(s);
    pre_s[j + 1] = static_cast<int>(offsets[c + 1] - s);   // the list's size
  }
  const float dm = d_min[q], dl = delta[q];
  const int tau = tau_pred[q];
  __syncthreads();
  if (warp == 0) {            // the sizes' running sum: pre_s[j] = Σ_{i<j}
    int carry = 0;
    for (int base = 0; base < P; base += 32) {
      const int j = base + wl;
      int x = j < P ? pre_s[j + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (wl >= o) x += y;
      }
      if (j < P) pre_s[j + 1] = carry + x;
      carry += __shfl_sync(kFull, x, 31);
    }
    if (wl == 0) pre_s[0] = 0;
  }
  __syncthreads();
  const int total = pre_s[P];
  if (blockIdx.x == 0 && threadIdx.x == 0) walked[q] = total;
  const int b_inf = bbc::bucket_of_inf(kInf, dm, dl, bbc::inf_to_m(dm, dl),
                                       ew_s, n_ew, m);
  const size_t row0 = static_cast<size_t>(q) * n;

  int n_m = 0, n_miss = 0;                 // this warp's, in every lane
  for (int tile = blockIdx.x; tile * bbc::kThreads < total;
       tile += gridDim.x) {
    const int v = tile * bbc::kThreads + threadIdx.x;
    const bool in = v < total;
    int lane = 0;
    if (in) {                 // the last list that starts at or before v
      int lo = 0, hi = P - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pre_s[mid] <= v) lo = mid; else hi = mid - 1;
      }
      lane = start_s[lo] + (v - pre_s[lo]);
    }
    const bool ok = in && valid[row0 + lane];
    float e = kInf, ex = kInf;
    int b = b_inf;
    if (ok) {
      e = bbc::clamp0_sqrt(adc_row<W>(codes + static_cast<size_t>(lane) * M,
                                      M, K, lut_s));
      b = bbc::bucket_of(e, dm, dl, ew_s, n_ew, m);
      if (b != m) atomicAdd(&hist_s[b], 1);
    }
    const bool p = ok && b <= tau;
    n_m += __popc(__ballot_sync(kFull, ok && b == m));
    n_miss += __popc(__ballot_sync(kFull, ok && !p));
    if (p) ex = sqrtf(row_sq(vectors + static_cast<size_t>(lane) * d, q_s, d));
    if (in) {
      est[row0 + lane] = e;
      bucket[row0 + lane] = b;
      early[row0 + lane] = ex;
    }
  }
  if (wl == 0) {              // bucket m and the misses: by ballot only
    if (n_m) atomicAdd(&hist_s[m], n_m);
    if (n_miss) atomicAdd(miss_s, n_miss);
  }
  __syncthreads();
  bbc::flush_hist(hist_s, hist, q, 1, m1);
  if (threadIdx.x == 0 && miss_s[0]) atomicAdd(&nmiss[q], miss_s[0]);
}

template <int W>
int launch(const uint8_t* codes, const float* vectors, const uint8_t* valid,
           const float* luts, const float* qs, const float* d_min,
           const float* delta, const int* ew_maps, const int* tau_pred,
           const int64_t* probed, const int64_t* offsets, float* est,
           int* bucket, float* early, int* counts, int n, int M, int K, int d,
           int B, int n_ew, int m, int P, int pstride, int blocks, int smem,
           cudaStream_t stream) {
  cudaError_t err = bbc::allow_smem(fused_scan_kernel<W>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(counts, 0, sizeof(int) * B * (m + 3), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks, B);
  int* nmiss = counts + B * (m + 1);
  fused_scan_kernel<W><<<grid, bbc::kThreads, smem, stream>>>(
      codes, vectors, valid, luts, qs, d_min, delta, ew_maps, tau_pred,
      probed, offsets, est, bucket, early, counts, nmiss, nmiss + B, n, M, K,
      d, n_ew, m, P, pstride);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The one-query kernel (B = 1)
// ---------------------------------------------------------------------------

constexpr int kTile = 32;                             // lanes a work item
constexpr int kBlocksPerSm = 6;                       // ops.FS_BLOCKS_PER_SM

// sum over m ascending of LUT[m, code[l, m]].  MC = 16, 24 or 32: the row
// loads as MC / 16 words of 16 bytes (MC / 8 of 8 for 24), all issued
// before the first add; MC = 0: any M, one byte at a time.
template <int MC>
__device__ __forceinline__ float adc(const uint8_t* __restrict__ codes,
                                     int l, int M, int K,
                                     const float* lut_s) {
  float acc = 0.f;
  if constexpr (MC == 0) {
    const uint8_t* row = codes + static_cast<size_t>(l) * M;
    for (int mm = 0; mm < M; ++mm)
      acc = __fadd_rn(acc, lut_s[mm * K + __ldg(row + mm)]);
  } else {
    const uint8_t* row = codes + static_cast<size_t>(l) * MC;
    unsigned w[MC / 4];
    if constexpr (MC % 16 == 0) {
#pragma unroll
      for (int t = 0; t < MC / 16; ++t) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(row) + t);
        w[4 * t] = x.x;
        w[4 * t + 1] = x.y;
        w[4 * t + 2] = x.z;
        w[4 * t + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int t = 0; t < MC / 8; ++t) {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(row) + t);
        w[2 * t] = x.x;
        w[2 * t + 1] = x.y;
      }
    }
#pragma unroll
    for (int mm = 0; mm < MC; ++mm)
      acc = __fadd_rn(acc,
                      lut_s[mm * K + ((w[mm >> 2] >> (8 * (mm & 3))) & 0xffu)]);
  }
  return acc;
}

template <int MC>
__global__ void __launch_bounds__(bbc::kThreads, kBlocksPerSm)
fused_scan_b1_kernel(const uint8_t* __restrict__ codes,
                     const float* __restrict__ vectors,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ lut,
                     const float* __restrict__ q,
                     const float* __restrict__ d_min,
                     const float* __restrict__ delta,
                     const int* __restrict__ ew_map,
                     const int* __restrict__ tau_ptr, int tau_val,
                     float* __restrict__ est, int* __restrict__ bucket,
                     float* __restrict__ early, int* hist, int* nmiss,
                     int n, int M, int K, int d, int n_ew, int m,
                     int tiles) {
  extern __shared__ __align__(16) float smem1[];
  const int m1 = m + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* lut_s = smem1;                            // M * K
  float* q_s = lut_s + M * K;                      // d
  int* ew_s = reinterpret_cast<int*>(q_s + d);     // n_ew
  int* whist = ew_s + n_ew;                        // kWarps x (m + 1)
  int* wmiss = whist + kWarps * m1;                // kWarps
  int* wh = whist + warp * m1;
  for (int i = threadIdx.x; i < M * K; i += blockDim.x) lut_s[i] = lut[i];
  for (int i = threadIdx.x; i < d; i += blockDim.x) q_s[i] = q[i];
  for (int i = threadIdx.x; i < n_ew; i += blockDim.x) ew_s[i] = ew_map[i];
  for (int i = threadIdx.x; i < kWarps * m1; i += blockDim.x) whist[i] = 0;
  const float dm = *d_min, dl = *delta;
  const bool inf_m = bbc::inf_to_m(dm, dl);
  const int tau = tau_ptr ? *tau_ptr : tau_val;
  // warp w of block b takes tiles w * grid + b, then every warps-th one:
  // consecutive tiles go to consecutive blocks, so to different SMs
  const int warps = gridDim.x * kWarps;
  const int first = warp * gridDim.x + blockIdx.x;
  // this thread's validity in its first 32 tiles, all loaded at once
  unsigned vbits = 0;
  for (int k = 0, t = first; k < 32 && t < tiles; ++k, t += warps) {
    const int l = t * kTile + lane;
    if (l < n) vbits |= static_cast<unsigned>(__ldg(valid + l) != 0) << k;
  }
  __syncthreads();
  const int b_inf = bbc::bucket_of_inf(kInf, dm, dl, inf_m, ew_s, n_ew, m);

  int n_m = 0, n_miss = 0;                 // this warp's, in every lane
  bool seen = false;
  for (int t = first, k = 0; t < tiles; t += warps, ++k) {
    const int l = t * kTile + lane;
    const bool v = k < 32 ? (vbits >> k) & 1u : l < n && __ldg(valid + l);
    float e = kInf, ex = kInf;
    int b = b_inf;
    if (__any_sync(kFull, v)) {
      seen = true;
      if (v) {
        e = bbc::clamp0_sqrt(adc<MC>(codes, l, M, K, lut_s));
        b = bbc::bucket_of_inf(e, dm, dl, inf_m, ew_s, n_ew, m);
        if (b != m) atomicAdd(&wh[b], 1);
      }
      n_m += __popc(__ballot_sync(kFull, v && b == m));
      n_miss += __popc(__ballot_sync(kFull, v && b > tau));
      if (v && b <= tau) {
        float sq = 0.f;
        bbc::sq_dists<1>(vectors + static_cast<size_t>(l) * d, q_s, d, &sq);
        ex = sqrtf(sq);
      }
    }
    if (l < n) {
      est[l] = e;
      bucket[l] = b;
      early[l] = ex;
    }
  }
  if (lane == 0) {            // bucket m is counted by ballot only
    wh[m] += n_m;
    wmiss[warp] = n_miss;
  }
  if (!__syncthreads_or(seen)) return;     // no valid lane: nothing to add
  for (int i = threadIdx.x; i < m1; i += blockDim.x) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += whist[w * m1 + i];
    if (s) atomicAdd(hist + i, s);
  }
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += wmiss[w];
    if (s) atomicAdd(nmiss, s);
  }
}

template <int MC>
int launch_b1(const uint8_t* codes, const float* vectors, const uint8_t* valid,
              const float* lut, const float* q, const float* d_min,
              const float* delta, const int* ew_map, const int* tau_ptr,
              float* est, int* bucket, float* early, int* counts,
              int tau_val, int n, int M, int K, int d, int n_ew, int m,
              int tiles, int grid, int smem, cudaStream_t stream) {
  cudaError_t err = bbc::allow_smem(fused_scan_b1_kernel<MC>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(counts, 0, sizeof(int) * (m + 2), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_scan_b1_kernel<MC><<<grid, bbc::kThreads, smem, stream>>>(
      codes, vectors, valid, lut, q, d_min, delta, ew_map, tau_ptr, tau_val,
      est, bucket, early, counts, counts + m + 1, n, M, K, d, n_ew, m, tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The chunked-LUT kernel: a query's LUT past one block's shared memory
// ---------------------------------------------------------------------------

constexpr int kCThreads = 1024;                     // lanes a tile

// acc += LUT[c0 + mm, code[mm]] for mm ascending over one chunk of a code
// row (row: the chunk's first code byte; lut_s: the query's chunk).  VEC:
// the chunk is a whole number of 16-byte words on a 16-byte boundary.
template <bool VEC>
__device__ __forceinline__ float adc_chunk(const uint8_t* __restrict__ row,
                                           int cm, int K, const float* lut_s,
                                           float acc) {
  if constexpr (VEC) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    for (int t = 0; t < cm / 16; ++t) {
      const uint4 x = __ldg(r4 + t);
      const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int u = 0; u < 16; ++u)
        acc = __fadd_rn(acc, lut_s[(16 * t + u) * K +
                                   ((w[u >> 2] >> (8 * (u & 3))) & 0xffu)]);
    }
  } else {
    for (int mm = 0; mm < cm; ++mm)
      acc = __fadd_rn(acc, lut_s[mm * K + __ldg(row + mm)]);
  }
  return acc;
}

template <bool VEC>
__global__ void __launch_bounds__(kCThreads, 1)
fused_scan_chunked_kernel(const uint8_t* __restrict__ codes,
                          const float* __restrict__ vectors,
                          const uint8_t* __restrict__ valid,
                          const float* __restrict__ luts,
                          const float* __restrict__ qs,
                          const float* __restrict__ d_min,
                          const float* __restrict__ delta,
                          const int* __restrict__ ew_maps,
                          const int* __restrict__ tau_ptr, int tau_val,
                          float* est, int* __restrict__ bucket,
                          float* __restrict__ early, int* __restrict__ hist,
                          int* __restrict__ nmiss, int n, int M, int K, int d,
                          int n_ew, int m, int mc) {
  extern __shared__ __align__(16) float smemc[];
  const int q = blockIdx.x;
  const int m1 = m + 1;
  const int wl = threadIdx.x & 31;
  float* lut_s = smemc;                                  // mc * K
  float* q_s = lut_s + mc * K;                           // d
  float* par_s = q_s + d;                                // 2
  int* ew_s = reinterpret_cast<int*>(par_s + 2);         // n_ew
  int* hist_s = ew_s + n_ew;                             // m1
  int* tau_s = hist_s + m1;                              // 1
  int* miss_s = tau_s + 1;                               // 1
  int* binf_s = miss_s + 1;                              // 1

  bbc::stage_rows(q_s, qs, q, 1, d);
  bbc::stage_rows(ew_s, ew_maps, q, 1, n_ew);
  for (int i = threadIdx.x; i < m1; i += blockDim.x) hist_s[i] = 0;
  if (threadIdx.x == 0) {
    par_s[0] = d_min[q];
    par_s[1] = delta[q];
    tau_s[0] = tau_ptr ? tau_ptr[q] : tau_val;
    miss_s[0] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0)         // the bucket of a lane off the probe (+inf)
    binf_s[0] = bbc::bucket_of_inf(kInf, par_s[0], par_s[1],
                                   bbc::inf_to_m(par_s[0], par_s[1]), ew_s,
                                   n_ew, m);
  int cnt_m = 0, cnt_miss = 0;  // this warp's, in its lane 0
  const size_t row0 = static_cast<size_t>(q) * n;

  for (int c0 = 0; c0 < M; c0 += mc) {
    const int cm = min(mc, M - c0);
    const bool last = c0 + cm == M;
    __syncthreads();                // every read of the last chunk is done
    const float* src = luts + (static_cast<size_t>(q) * M + c0) * K;
    const int cnt = cm * K;
    if ((cnt & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(lut_s);
      for (int i = threadIdx.x; i < cnt / 4; i += blockDim.x)
        d4[i] = __ldg(s4 + i);
    } else {
      for (int i = threadIdx.x; i < cnt; i += blockDim.x)
        lut_s[i] = __ldg(src + i);
    }
    __syncthreads();

    for (int tile = blockIdx.y; tile * kCThreads < n; tile += gridDim.y) {
      const int lane = tile * kCThreads + threadIdx.x;
      const bool in = lane < n;
      const bool v = in && valid[row0 + lane];
      float acc = -0.f;
      if (v) {
        if (c0 > 0) acc = est[row0 + lane];   // this thread's partial sum
        acc = adc_chunk<VEC>(codes + static_cast<size_t>(lane) * M + c0, cm,
                             K, lut_s, acc);
        if (!last) est[row0 + lane] = acc;
      }
      if (!last) continue;        // uniform across the block

      float e = kInf;
      int b = binf_s[0];
      bool p = false;
      if (v) {
        e = bbc::clamp0_sqrt(acc);
        b = bbc::bucket_of(e, par_s[0], par_s[1], ew_s, n_ew, m);
        if (b != m) atomicAdd(&hist_s[b], 1);
        p = b <= tau_s[0];
      }
      // bucket m and the misses: by ballot, with no atomic a lane
      const unsigned bm = __ballot_sync(0xffffffffu, v && b == m);
      const unsigned bx = __ballot_sync(0xffffffffu, v && !p);
      if (wl == 0) {
        cnt_m += __popc(bm);
        cnt_miss += __popc(bx);
      }
      float sq[1] = {0.f};
      if (p)
        bbc::sq_dists<1>(vectors + static_cast<size_t>(lane) * d, q_s, d, sq);
      if (in) {
        est[row0 + lane] = e;
        bucket[row0 + lane] = b;
        early[row0 + lane] = p ? sqrtf(sq[0]) : kInf;
      }
    }
  }
  if (wl == 0) {
    if (cnt_m) atomicAdd(&hist_s[m], cnt_m);
    if (cnt_miss) atomicAdd(&miss_s[0], cnt_miss);
  }
  __syncthreads();
  bbc::flush_hist(hist_s, hist, q, 1, m1);
  if (threadIdx.x == 0 && miss_s[0]) atomicAdd(&nmiss[q], miss_s[0]);
}

template <bool VEC>
int launch_chunked(const uint8_t* codes, const float* vectors,
                   const uint8_t* valid, const float* luts, const float* qs,
                   const float* d_min, const float* delta, const int* ew_maps,
                   const int* tau_ptr, float* est, int* bucket, float* early,
                   int* counts, int tau_val, int n, int M, int K, int d, int B,
                   int n_ew, int m, int mc, int blocks, int smem,
                   cudaStream_t stream) {
  cudaError_t err = bbc::allow_smem(fused_scan_chunked_kernel<VEC>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(counts, 0, sizeof(int) * B * (m + 2), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, blocks);
  fused_scan_chunked_kernel<VEC><<<grid, kCThreads, smem, stream>>>(
      codes, vectors, valid, luts, qs, d_min, delta, ew_maps, tau_ptr,
      tau_val, est, bucket, early, counts, counts + B * (m + 1), n, M, K, d,
      n_ew, m, mc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes of one block of the chunked-LUT kernel (bq = 1, a
// chunk of M sub-quantizers).
extern "C" int fused_scan_smem_bytes(int bq, int M, int K, int d, int n_ew,
                                     int m) {
  return 4 * bq * (M * K + d + 2 + n_ew + (m + 1) + 3);
}

// Shared-memory bytes of one block of the batched kernel: a query's whole
// LUT, its row and ew_map, a histogram, a miss count, and its P lists'
// running sizes and starts.
extern "C" int fused_scan_batch_smem_bytes(int M, int K, int d, int n_ew,
                                           int m, int P) {
  return 4 * (M * K + d + n_ew + (m + 1) + 1 + 2 * P + 1);
}

extern "C" int fused_scan_batch_tile() { return bbc::kThreads; }

// The batched scan over each query's probed lists: probed (B, P) int64
// cluster ids, row q at probed + q * pstride (pstride 0: one list set for
// every query), offsets (C + 1) int64 lane starts; the lists of a query
// are distinct and every lane `valid` sets lies in one of them.  A
// (blocks, B) grid of kThreads lanes a block.  Outputs: est, bucket, early
// (B, n), written on the walked lanes only; counts (B * (m + 3) ints: the
// (B, m+1) histogram, nmiss (B,), then each query's walked lanes (B,)),
// zeroed here by one memset before the launch.  words: 16 or 8 to read
// the code rows as words of that many bytes (M a multiple of it, the codes
// on such a boundary), else 0.  Returns the CUDA error code (0 on
// success).
extern "C" int fused_scan_batch_launch(
    const uint8_t* codes, const float* vectors, const uint8_t* valid,
    const float* luts, const float* qs, const float* d_min,
    const float* delta, const int* ew_maps, const int* tau_pred,
    const int64_t* probed, const int64_t* offsets, float* est, int* bucket,
    float* early, int* counts, int n, int M, int K, int d, int B, int n_ew,
    int m, int P, int pstride, int words, int blocks, int smem,
    cudaStream_t stream) {
  switch (words) {
#define FS_BATCH(W)                                                         \
    case W: return launch<W>(codes, vectors, valid, luts, qs, d_min, delta, \
                             ew_maps, tau_pred, probed, offsets, est, bucket,\
                             early, counts, n, M, K, d, B, n_ew, m, P,      \
                             pstride, blocks, smem, stream);
    FS_BATCH(16)
    FS_BATCH(8)
    FS_BATCH(0)
#undef FS_BATCH
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared-memory bytes of one block of the one-query kernel.
extern "C" int fused_scan_b1_smem_bytes(int M, int K, int d, int n_ew,
                                        int m) {
  return 4 * (M * K + d + n_ew + kWarps * (m + 1) + kWarps);
}

extern "C" int fused_scan_b1_tile() { return kTile; }

// One query: one memset of counts (m + 2 ints: hist (m+1), then nmiss),
// then one launch of `grid` persistent blocks whose warps take the `tiles`
// work items of kTile lanes in turn (tile t to warp t % (grid * kWarps),
// counted block-fastest; tiles * kTile + grid * kWarps * kTile below
// 2^31).  tau_ptr: a device int, or null for tau_val.  mc: 16, 24 or 32
// when the code rows are M = mc bytes and aligned for whole-word loads (16
// bytes; 8 for 24), else 0.  Returns the CUDA error code.
extern "C" int fused_scan_b1_launch(
    const uint8_t* codes, const float* vectors, const uint8_t* valid,
    const float* lut, const float* q, const float* d_min, const float* delta,
    const int* ew_map, const int* tau_ptr, float* est, int* bucket,
    float* early, int* counts, int tau_val, int n, int M, int K, int d,
    int n_ew, int m, int tiles, int grid, int mc, int smem,
    cudaStream_t stream) {
  switch (mc) {
#define FS_B1(MC)                                                           \
    case MC: return launch_b1<MC>(codes, vectors, valid, lut, q, d_min,     \
                                  delta, ew_map, tau_ptr, est, bucket, early,\
                                  counts, tau_val, n, M, K, d, n_ew, m,     \
                                  tiles, grid, smem, stream);
    FS_B1(32)
    FS_B1(24)
    FS_B1(16)
    FS_B1(0)
#undef FS_B1
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fused_scan_chunked_tile() { return kCThreads; }

// The chunked-LUT scan (any B, one query included): the outputs as
// fused_scan_batch_launch's; a (B, blocks) grid of kCThreads lanes a block;
// each block stages its query's LUT mc sub-quantizers at a time
// (fused_scan_smem_bytes(1, mc, ...) bytes) and walks its lane tiles
// (blockIdx.y, then every `blocks`-th) once a chunk.  tau_ptr: B device
// ints, or null for tau_val.  vec: M and mc multiples of 16 and the codes
// on a 16-byte boundary.  Returns the CUDA error code.
extern "C" int fused_scan_chunked_launch(
    const uint8_t* codes, const float* vectors, const uint8_t* valid,
    const float* luts, const float* qs, const float* d_min,
    const float* delta, const int* ew_maps, const int* tau_ptr, float* est,
    int* bucket, float* early, int* counts, int tau_val, int n, int M, int K,
    int d, int B, int n_ew, int m, int mc, int blocks, int vec, int smem,
    cudaStream_t stream) {
  if (vec)
    return launch_chunked<true>(codes, vectors, valid, luts, qs, d_min, delta,
                                ew_maps, tau_ptr, est, bucket, early, counts,
                                tau_val, n, M, K, d, B, n_ew, m, mc, blocks,
                                smem, stream);
  return launch_chunked<false>(codes, vectors, valid, luts, qs, d_min, delta,
                               ew_maps, tau_ptr, est, bucket, early, counts,
                               tau_val, n, M, K, d, B, n_ew, m, mc, blocks,
                               smem, stream);
}
