// Shard collector: Eq. 6 bucketize + (B, m+1) histogram + stream-order
// compaction of the lanes at or below a provisional threshold tau_spec into
// a budget-wide position buffer, with the true (unclamped) match count; and
// the compaction alone over bucket ids that already exist.
//
// Replaces: src/repro/kernels/shard_collect.py::shard_collect_batch_pallas
// (fused) and ::spec_compact_batch_pallas (compaction only).
// Plain versions: kernels/ref.py shard_collect_batch, spec_compact_batch.
//
// What bounds it on an H100: device-memory bytes.  The fused form reads the
// (B, n) fp32 distances and validity bytes and writes (B, n) int32 bucket
// ids; the compaction-only form reads the (B, n) bucket ids and validity
// bytes; both write at most B * budget positions.  A few integer operations
// per lane.
//
// What the design does about it.  The Pallas kernel keeps the buffer, its
// fill count and the histogram as state carried from one grid step to the
// next, which is correct only because a TPU grid runs in order
// (shard_collect.py:33-35).  CUDA blocks run concurrently and in no order,
// so stream order comes from a prefix scan instead, in three launches:
//   1. count: one block per (query, chunk of kChunk lanes), coalesced reads;
//      the fused form bucketizes (bbc::bucket_of, the code bucket_hist.cu
//      runs), writes the bucket ids and counts the histogram with shared
//      atomics folded into the zeroed global histogram; every block writes
//      its chunk's match count;
//   2. scan: one block per query, the exclusive prefix of its chunk counts
//      (each chunk's offset in the buffer) and the total; it also writes
//      the sentinel n into the buffer past min(total, budget);
//   3. compact: one block per (query, chunk) whose offset is below the
//      budget re-reads its chunk in rounds of 256 lanes, ranks the matches
//      within a round by warp ballot and popcount, and writes each at
//      offset + rank while that is below the budget.
// Every output is a function of the input alone (integer atomics commute),
// so bucket, hist, pos and count equal the plain version's bit for bit
// under any block schedule.  Left behind: the (tile, tile) one-hot slot
// scatter, the budget + tile window buffer, the 128-lane padding of the
// histogram and counts, and the 8-query chunks.  A single pass with a
// decoupled look-back would drop pass 3's re-read; it is later work.
#include "scan_common.cuh"

namespace {

constexpr int kItems = 16;                          // rounds of 256 lanes
constexpr int kChunk = bbc::kThreads * kItems;      // lanes per chunk
constexpr int kWarps = bbc::kThreads / 32;

__device__ __forceinline__ int block_sum(int v, int* red_s) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red_s[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += red_s[w];
  __syncthreads();
  return total;                                     // valid in thread 0
}

// Pass 1.  FUSED: bucketize dists, write bucket, histogram the valid lanes.
// Otherwise: read the given bucket ids.  Either way: per-chunk match counts.
template <bool FUSED>
__global__ void __launch_bounds__(bbc::kThreads)
count_kernel(const float* __restrict__ dists, const int* __restrict__ bucket_in,
             const uint8_t* __restrict__ valid, const float* __restrict__ d_min,
             const float* __restrict__ delta, const int* __restrict__ ew_maps,
             const int* __restrict__ tau_spec, int* __restrict__ bucket_out,
             int* __restrict__ hist, int* __restrict__ counts, int n,
             int n_chunks, int n_ew, int m) {
  extern __shared__ int ismem[];
  __shared__ int red_s[kWarps];
  int* ew_s = ismem;                 // n_ew (FUSED)
  int* hist_s = ew_s + n_ew;         // m + 1 (FUSED)
  const int q = blockIdx.x;
  const size_t row = static_cast<size_t>(q) * n;
  float dm = 0.f, dl = 1.f;
  if constexpr (FUSED) {
    bbc::stage_rows(ew_s, ew_maps, q, 1, n_ew);
    for (int i = threadIdx.x; i < m + 1; i += blockDim.x) hist_s[i] = 0;
    __syncthreads();
    dm = d_min[q];
    dl = delta[q];
  }
  const int tau = tau_spec[q];
  for (int chunk = blockIdx.y; chunk < n_chunks; chunk += gridDim.y) {
    int c = 0;
#pragma unroll 4
    for (int r = 0; r < kItems; ++r) {
      const int lane = chunk * kChunk + r * bbc::kThreads + threadIdx.x;
      if (lane >= n) break;
      const bool v = valid[row + lane] != 0;
      int b;
      if constexpr (FUSED) {
        b = bbc::bucket_of(dists[row + lane], dm, dl, ew_s, n_ew, m);
        bucket_out[row + lane] = b;
        if (v) atomicAdd(&hist_s[b], 1);
      } else {
        b = bucket_in[row + lane];
      }
      c += (v && b <= tau) ? 1 : 0;
    }
    const int total = block_sum(c, red_s);
    if (threadIdx.x == 0)
      counts[static_cast<size_t>(q) * n_chunks + chunk] = total;
  }
  if constexpr (FUSED) {
    __syncthreads();
    bbc::flush_hist(hist_s, hist, q, 1, m + 1);
  }
}

// Pass 2.  One block per query: exclusive prefix of the chunk counts, the
// total, and the sentinel past the buffer's fill.
__global__ void __launch_bounds__(1024)
scan_kernel(const int* __restrict__ counts, int* __restrict__ offsets,
            int* __restrict__ count_out, int* __restrict__ pos, int n,
            int n_chunks, int budget) {
  __shared__ int warp_s[32];
  __shared__ int total_s;
  const int q = blockIdx.x;
  const int* c = counts + static_cast<size_t>(q) * n_chunks;
  int* o = offsets + static_cast<size_t>(q) * n_chunks;
  const int per = (n_chunks + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n_chunks);
  const int hi = min(lo + per, n_chunks);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += c[i];
  // inclusive scan of the per-thread sums: within warps, then warp totals
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = local;
  for (int o2 = 1; o2 < 32; o2 <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o2);
    if (lane >= o2) incl += t;
  }
  if (lane == 31) warp_s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? warp_s[lane] : 0;
    for (int o2 = 1; o2 < 32; o2 <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, o2);
      if (lane >= o2) w += t;
    }
    if (lane < nw) warp_s[lane] = w;               // inclusive warp totals
    if (lane == nw - 1) total_s = w;
  }
  __syncthreads();
  int run = incl - local + (warp > 0 ? warp_s[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    o[i] = run;
    run += c[i];
  }
  const int total = total_s;
  if (threadIdx.x == 0) count_out[q] = total;
  int* p = pos + static_cast<size_t>(q) * budget;
  for (int i = min(total, budget) + threadIdx.x; i < budget; i += blockDim.x)
    p[i] = n;
}

// Pass 3.  Stream-order writes of each chunk's matches below the budget.
__global__ void __launch_bounds__(bbc::kThreads)
compact_kernel(const int* __restrict__ bucket,
               const uint8_t* __restrict__ valid,
               const int* __restrict__ tau_spec,
               const int* __restrict__ counts,
               const int* __restrict__ offsets, int* __restrict__ pos, int n,
               int n_chunks, int budget) {
  __shared__ int warp_s[kWarps];
  const int q = blockIdx.x;
  const size_t row = static_cast<size_t>(q) * n;
  const int tau = tau_spec[q];
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane_id) - 1u;
  int* p = pos + static_cast<size_t>(q) * budget;
  for (int chunk = blockIdx.y; chunk < n_chunks; chunk += gridDim.y) {
    const size_t ci = static_cast<size_t>(q) * n_chunks + chunk;
    const int cnt = counts[ci];
    int run = offsets[ci];                 // uniform across the block
    if (cnt == 0 || run >= budget) continue;
    const int end = run + cnt;
    for (int r = 0; r < kItems && run < budget && run < end; ++r) {
      const int lane = chunk * kChunk + r * bbc::kThreads + threadIdx.x;
      const bool match = lane < n && valid[row + lane] != 0 &&
                         bucket[row + lane] <= tau;
      const unsigned ballot = __ballot_sync(0xffffffffu, match);
      if (lane_id == 0) warp_s[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int t = warp_s[w];
        before += w < warp ? t : 0;
        total += t;
      }
      const int at = run + before + __popc(ballot & below);
      if (match && at < budget) p[at] = lane;
      run += total;
      __syncthreads();                     // warp_s is rewritten next round
    }
  }
}

int grid_chunks(int n_chunks) { return n_chunks < 65535 ? n_chunks : 65535; }

}  // namespace

extern "C" int shard_collect_chunk() { return kChunk; }

extern "C" int shard_collect_smem_bytes(int n_ew, int m) {
  return 4 * (n_ew + m + 1);
}

// Fused form.  hist (B, m+1) must arrive zeroed; counts and offsets are
// (B, n_chunks) int32 scratch; pos (B, budget) and count (B,) are written
// in full.
extern "C" int shard_collect_batch_launch(
    const float* dists, const uint8_t* valid, const float* d_min,
    const float* delta, const int* ew_maps, const int* tau_spec, int* bucket,
    int* hist, int* pos, int* count, int* counts, int* offsets, int n, int B,
    int n_ew, int m, int budget, int n_chunks, int smem,
    cudaStream_t stream) {
  cudaError_t err = bbc::allow_smem(count_kernel<true>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, grid_chunks(n_chunks));
  count_kernel<true><<<grid, bbc::kThreads, smem, stream>>>(
      dists, nullptr, valid, d_min, delta, ew_maps, tau_spec, bucket, hist,
      counts, n, n_chunks, n_ew, m);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<B, 1024, 0, stream>>>(counts, offsets, count, pos, n,
                                      n_chunks, budget);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  compact_kernel<<<grid, bbc::kThreads, 0, stream>>>(
      bucket, valid, tau_spec, counts, offsets, pos, n, n_chunks, budget);
  return static_cast<int>(cudaGetLastError());
}

// Compaction only, over existing bucket ids.
extern "C" int spec_compact_batch_launch(
    const int* bucket, const uint8_t* valid, const int* tau_spec, int* pos,
    int* count, int* counts, int* offsets, int n, int B, int budget,
    int n_chunks, cudaStream_t stream) {
  const dim3 grid(B, grid_chunks(n_chunks));
  count_kernel<false><<<grid, bbc::kThreads, 0, stream>>>(
      nullptr, bucket, valid, nullptr, nullptr, nullptr, tau_spec, nullptr,
      nullptr, counts, n, n_chunks, 0, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<B, 1024, 0, stream>>>(counts, offsets, count, pos, n,
                                      n_chunks, budget);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  compact_kernel<<<grid, bbc::kThreads, 0, stream>>>(
      bucket, valid, tau_spec, counts, offsets, pos, n, n_chunks, budget);
  return static_cast<int>(cudaGetLastError());
}
