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
// bytes; both write the (B, budget) positions and their ok flags and the
// counts.  A few integer operations per lane.
//
// What the design does about it.  The Pallas kernel keeps the buffer, its
// fill count and the histogram as state carried from one grid step to the
// next, which is correct only because a TPU grid runs in order
// (shard_collect.py:33-35).  CUDA blocks run concurrently and in no order,
// so stream order comes from a single-pass prefix scan with a decoupled
// look-back, in one launch whose scratch one memset zeroed (the status
// words, the ticket counter and, fused, the histogram):
//   1. each block takes a ticket from an atomic counter, not blockIdx; the
//      first B * n_chunks tickets are (query, chunk of kChunk lanes),
//      chunk-major, so every earlier chunk of a query holds a smaller ticket
//      and is already running or done (waiting on it cannot deadlock), and
//      the blocks in flight spread their histogram adds over all queries;
//   2. each thread loads its 16 consecutive lanes once, by 16-byte loads
//      (four of the fp32 distances or int32 bucket ids, one of the validity
//      bytes) where the rows are 16-byte aligned, and keeps them in
//      registers: the fused form bucketizes (bbc::bucket_of, the code
//      bucket_hist.cu runs; a +inf distance, a lane off the probe, goes
//      straight to the overflow bucket, the value the division would give
//      for a finite d_min and a positive finite delta), writes the bucket ids
//      through shared memory so that a warp's stores are contiguous, and
//      histograms the valid lanes with shared atomics, folded into the
//      global histogram once per block; each lane's match bit (valid and
//      bucket <= tau_spec) stays in a register mask;
//   3. one block-wide scan ranks the chunk's matches in stream order;
//   4. the block publishes its aggregate as a 64-bit status word (flag and
//      value in one word, so a reader never sees one without the other),
//      then one warp looks back over the query's earlier chunks 32 at a
//      time, summing aggregates until it meets an inclusive prefix, and
//      publishes its own inclusive prefix; the other warps fold the
//      histogram meanwhile;
//   5. each thread writes its matches at prefix + rank from registers while
//      that is below the budget; nothing re-reads the stream; the block of
//      a query's last chunk writes the true count;
//   6. the remaining B * pieces tickets each own `fill_span` slots of one
//      query's buffer: the block waits for the query's last inclusive
//      prefix (the total) and writes the sentinel n (ok = false) into its
//      slots at or past min(total, budget), so the tail of sentinels, most
//      of the buffer when tau_spec undershoots, is written by many blocks
//      at once rather than by the last chunk's alone.
// Every output is a function of the input alone (integer atomics commute,
// each position is written once), so bucket, hist, pos, ok and count equal
// the plain version's bit for bit under any block schedule.  Left behind:
// the (tile, tile) one-hot slot scatter, the budget + tile window buffer,
// the 128-lane padding of the histogram and counts, and the 8-query chunks.
#include "scan_common.cuh"

namespace {

constexpr int kPer = 16;                            // lanes per thread
constexpr int kChunk = bbc::kThreads * kPer;        // lanes per chunk
constexpr int kVec = kPer / 4;                      // 16-byte words
constexpr int kWarps = bbc::kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Status word of a chunk: flag in the high half, match count in the low.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The exclusive prefix of chunk c in its query's status row, by one warp:
// lane i reads chunk end - i of a 32-chunk window, waits until each of them
// has published, and the warp sums the counts up to the nearest inclusive
// prefix; a window without one moves 32 chunks back.  Before chunk 0 reads
// as an inclusive prefix of 0.
__device__ __forceinline__ int look_back(const unsigned long long* st,
                                         int c) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int end = c - 1;; end -= 32) {
    const int j = end - lane;
    unsigned long long s = j >= 0 ? load_status(st + j) : kInclusive;
    while (__any_sync(kFull, (s >> 32) == 0)) {
      if ((s >> 32) == 0) {
        __nanosleep(32);
        s = load_status(st + j);
      }
    }
    const unsigned incl = __ballot_sync(kFull, (s >> 32) == 2);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(s & 0xffffffffu) : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    excl += v;
    if (incl) return excl;
  }
}

// Bit i set where byte i of the 16 is nonzero.
__device__ __forceinline__ unsigned byte_mask(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned mask = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    mask |= ((w[k >> 2] >> (8 * (k & 3))) & 0xffu) ? 1u << k : 0u;
  return mask;
}

// Step 6: one fill ticket.  Waits for the query's total, then writes
// pos = n, ok = false over its slots at or past min(total, budget): 16-byte
// stores between 16-slot boundaries of the flat buffers, single slots at
// the ends.
__device__ __forceinline__ void fill_piece(
    const unsigned long long* last, int* __restrict__ pos,
    bool* __restrict__ ok, int q, int piece, int n, int budget,
    int fill_span) {
  __shared__ int total_s;
  if (threadIdx.x == 0) {
    unsigned long long s = load_status(last);
    while ((s >> 32) != 2) {
      __nanosleep(64);
      s = load_status(last);
    }
    total_s = static_cast<int>(s & 0xffffffffu);
  }
  __syncthreads();
  const int from = max(piece * fill_span, min(total_s, budget));
  const int to = min((piece + 1) * fill_span, budget);
  if (from >= to) return;
  const size_t base = static_cast<size_t>(q) * budget;
  const size_t lo = base + from, hi = base + to;
  const bool vec = ((reinterpret_cast<uintptr_t>(pos) |
                     reinterpret_cast<uintptr_t>(ok)) & 15) == 0;
  size_t a = vec ? (lo + 15) & ~static_cast<size_t>(15) : hi;
  if (a > hi) a = hi;
  const size_t z = a + ((hi - a) & ~static_cast<size_t>(15));
  for (size_t i = lo + threadIdx.x; i < a; i += blockDim.x) {
    pos[i] = n;
    ok[i] = false;
  }
  const int4 s = make_int4(n, n, n, n);
  int4* p4 = reinterpret_cast<int4*>(pos);
  for (size_t i = a / 4 + threadIdx.x; i < z / 4; i += blockDim.x) p4[i] = s;
  uint4* o16 = reinterpret_cast<uint4*>(ok);
  for (size_t i = a / 16 + threadIdx.x; i < z / 16; i += blockDim.x)
    o16[i] = make_uint4(0u, 0u, 0u, 0u);
  for (size_t i = z + threadIdx.x; i < hi; i += blockDim.x) {
    pos[i] = n;
    ok[i] = false;
  }
}

// One ticket of either form.  FUSED: bucketize dists, write the bucket ids,
// histogram the valid lanes.  Otherwise: read the given bucket ids.  `vec`:
// every row and output is 16-byte aligned (n % 16 == 0).
template <bool FUSED>
__device__ __forceinline__ void collect(
    const float* __restrict__ dists, const int* __restrict__ bucket_in,
    const uint8_t* __restrict__ valid, const float* __restrict__ d_min,
    const float* __restrict__ delta, const int* __restrict__ ew_maps,
    const int* __restrict__ tau_spec, int* __restrict__ bucket_out,
    int* __restrict__ hist, int* __restrict__ pos, bool* __restrict__ ok,
    int* __restrict__ count, unsigned long long* __restrict__ status,
    int* __restrict__ ticket, int n, int nq, int n_chunks, int n_ew, int m,
    int budget, int fill_span, bool vec) {
  extern __shared__ int ismem[];
  __shared__ int warp_s[kWarps];
  __shared__ int ticket_s, prefix_s;
  if (threadIdx.x == 0) ticket_s = atomicAdd(ticket, 1);
  __syncthreads();
  const int t = ticket_s;
  const int chunks = nq * n_chunks;
  if (t >= chunks) {
    const int f = t - chunks, q = f % nq;
    fill_piece(status + static_cast<size_t>(q) * n_chunks + n_chunks - 1,
               pos, ok, q, f / nq, n, budget, fill_span);
    return;
  }
  const int c = t / nq, q = t - c * nq;
  const size_t row = static_cast<size_t>(q) * n;
  const int lane0 = c * kChunk + threadIdx.x * kPer;
  const bool whole = vec && lane0 + kPer <= n;

  // 1. the thread's lanes, loaded once
  unsigned vmask = 0;
  int b[kPer];
  float e[kPer];
  if (whole) {
    vmask = byte_mask(__ldg(reinterpret_cast<const uint4*>(valid + row +
                                                           lane0)));
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if constexpr (FUSED) {
        const float4 f =
            __ldg(reinterpret_cast<const float4*>(dists + row + lane0) + k);
        e[4 * k] = f.x;
        e[4 * k + 1] = f.y;
        e[4 * k + 2] = f.z;
        e[4 * k + 3] = f.w;
      } else {
        const int4 f =
            __ldg(reinterpret_cast<const int4*>(bucket_in + row + lane0) + k);
        b[4 * k] = f.x;
        b[4 * k + 1] = f.y;
        b[4 * k + 2] = f.z;
        b[4 * k + 3] = f.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int lane = lane0 + i;
      const bool in = lane < n;
      vmask |= (in && valid[row + lane] != 0) ? 1u << i : 0u;
      if constexpr (FUSED) e[i] = in ? dists[row + lane] : 0.f;
      else b[i] = in ? bucket_in[row + lane] : 0;
    }
  }

  // 2. fused: bucket ids out, histogram of the valid lanes in shared memory
  int* ew_s = ismem;            // n_ew
  int* hist_s = ew_s + n_ew;    // m + 1
  if constexpr (FUSED) {
    __shared__ int4 stage_s[kChunk / 4];
    bbc::stage_rows(ew_s, ew_maps, q, 1, n_ew);
    for (int i = threadIdx.x; i < m + 1; i += blockDim.x) hist_s[i] = 0;
    __syncthreads();
    const float dm = d_min[q], dl = delta[q];
    const bool inf_m = bbc::inf_to_m(dm, dl);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      b[i] = bbc::bucket_of_inf(e[i], dm, dl, inf_m, ew_s, n_ew, m);
    if (vec && (c + 1) * kChunk <= n) {
      // a whole chunk: through shared memory, so that each warp store
      // covers 512 contiguous bytes (slots rotated against bank clashes)
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        stage_s[threadIdx.x * kVec + ((k + threadIdx.x) & (kVec - 1))] =
            make_int4(b[4 * k], b[4 * k + 1], b[4 * k + 2], b[4 * k + 3]);
      __syncthreads();
      int4* out = reinterpret_cast<int4*>(bucket_out + row + c * kChunk);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int i = threadIdx.x + bbc::kThreads * k;
        const int owner = i / kVec;
        out[i] = stage_s[owner * kVec + ((i + owner) & (kVec - 1))];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (lane0 + i < n) bucket_out[row + lane0 + i] = b[i];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if ((vmask >> i) & 1u) atomicAdd(&hist_s[b[i]], 1);
  }
  const int tau = tau_spec[q];
  unsigned match = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    match |= (((vmask >> i) & 1u) && b[i] <= tau) ? 1u << i : 0u;
  const int cnt = __popc(match);

  // 3. rank within the chunk: block-wide exclusive scan of the counts
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_s[warp] = incl;
  __syncthreads();                 // also: every shared histogram add done
  int before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int y = warp_s[w];
    before += w < warp ? y : 0;
    agg += y;
  }
  const int rank = before + incl - cnt;

  // 4. publish the aggregate, look back, publish the inclusive prefix; the
  // other warps fold the histogram into the global one meanwhile
  unsigned long long* st = status + static_cast<size_t>(q) * n_chunks;
  if (warp == 0) {
    int prefix = 0;
    if (c == 0) {
      if (lane == 0) store_status(st, kInclusive | static_cast<unsigned>(agg));
    } else {
      if (lane == 0)
        store_status(st + c, kAggregate | static_cast<unsigned>(agg));
      prefix = look_back(st, c);
      if (lane == 0)
        store_status(st + c,
                     kInclusive | static_cast<unsigned>(prefix + agg));
    }
    if (lane == 0) prefix_s = prefix;
  } else if constexpr (FUSED) {
    int* h = hist + static_cast<size_t>(q) * (m + 1);
    for (int i = threadIdx.x - 32; i < m + 1; i += blockDim.x - 32) {
      const int v = hist_s[i];
      if (v) atomicAdd(&h[i], v);
    }
  }
  __syncthreads();
  const int prefix = prefix_s;

  // 5. the matches, from registers, at prefix + rank below the budget
  int at = prefix + rank;
  if (match && at < budget) {
    int* p = pos + static_cast<size_t>(q) * budget;
    bool* o = ok + static_cast<size_t>(q) * budget;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if ((match >> i) & 1u) {
        if (at < budget) {
          p[at] = lane0 + i;
          o[at] = true;
        }
        ++at;
      }
    }
  }
  if (c == n_chunks - 1 && threadIdx.x == 0) count[q] = prefix + agg;
}

__global__ void __launch_bounds__(bbc::kThreads)
shard_collect_kernel(const float* __restrict__ dists,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ d_min,
                     const float* __restrict__ delta,
                     const int* __restrict__ ew_maps,
                     const int* __restrict__ tau_spec,
                     int* __restrict__ bucket, int* __restrict__ hist,
                     int* __restrict__ pos, bool* __restrict__ ok,
                     int* __restrict__ count,
                     unsigned long long* __restrict__ status,
                     int* __restrict__ ticket, int n, int nq, int n_chunks,
                     int n_ew, int m, int budget, int fill_span, int vec) {
  collect<true>(dists, nullptr, valid, d_min, delta, ew_maps, tau_spec,
                bucket, hist, pos, ok, count, status, ticket, n, nq,
                n_chunks, n_ew, m, budget, fill_span, vec != 0);
}

__global__ void __launch_bounds__(bbc::kThreads)
spec_compact_kernel(const int* __restrict__ bucket,
                    const uint8_t* __restrict__ valid,
                    const int* __restrict__ tau_spec, int* __restrict__ pos,
                    bool* __restrict__ ok, int* __restrict__ count,
                    unsigned long long* __restrict__ status,
                    int* __restrict__ ticket, int n, int nq, int n_chunks,
                    int budget, int fill_span, int vec) {
  collect<false>(nullptr, bucket, valid, nullptr, nullptr, nullptr, tau_spec,
                 nullptr, nullptr, pos, ok, count, status, ticket, n, nq,
                 n_chunks, 0, 0, budget, fill_span, vec != 0);
}

}  // namespace

extern "C" int shard_collect_chunk() { return kChunk; }

extern "C" int shard_collect_smem_bytes(int n_ew, int m) {
  return 4 * (n_ew + m + 1);
}

// Fused form: one launch of `grid` blocks, one per ticket (B * n_chunks
// chunks, then the fill pieces).  hist (B, m+1), the (B, n_chunks) 64-bit
// status words and the ticket counter must arrive zeroed (one memset of the
// wrapper's scratch); bucket (B, n), pos and ok (B, budget) and count (B,)
// are written in full.
extern "C" int shard_collect_batch_launch(
    const float* dists, const uint8_t* valid, const float* d_min,
    const float* delta, const int* ew_maps, const int* tau_spec, int* bucket,
    int* hist, int* pos, bool* ok, int* count, unsigned long long* status,
    int* ticket, int n, int B, int n_ew, int m, int budget, int n_chunks,
    int fill_span, int grid, int vec, int smem, cudaStream_t stream) {
  cudaError_t err = bbc::allow_smem(shard_collect_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  shard_collect_kernel<<<grid, bbc::kThreads, smem, stream>>>(
      dists, valid, d_min, delta, ew_maps, tau_spec, bucket, hist, pos, ok,
      count, status, ticket, n, B, n_chunks, n_ew, m, budget, fill_span, vec);
  return static_cast<int>(cudaGetLastError());
}

// Compaction only, over existing bucket ids; the same scratch without the
// histogram.
extern "C" int spec_compact_batch_launch(
    const int* bucket, const uint8_t* valid, const int* tau_spec, int* pos,
    bool* ok, int* count, unsigned long long* status, int* ticket, int n,
    int B, int budget, int n_chunks, int fill_span, int grid, int vec,
    cudaStream_t stream) {
  spec_compact_kernel<<<grid, bbc::kThreads, 0, stream>>>(
      bucket, valid, tau_spec, pos, ok, count, status, ticket, n, B, n_chunks,
      budget, fill_span, vec);
  return static_cast<int>(cudaGetLastError());
}
