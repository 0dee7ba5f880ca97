// Batched Eq. 6 bucketize + (B, m+1) histogram of the valid lanes.
//
// Replaces: src/repro/kernels/bucket_hist.py::bucket_hist_batch_pallas
// (and, launched at B = 1, ::bucket_hist_pallas).
// Plain version: kernels/ref.py bucket_hist_batch.
//
// What bounds it on an H100: device-memory bytes: it reads the (B, n) fp32
// distances and the (B, n) validity bytes and writes (B, n) int32 bucket
// ids, 9 bytes a lane, with a handful of operations per lane.
//
// What the design does about it.  The Pallas kernel carries the histogram
// from one grid step to the next (bucket_hist.py:10-12), which CUDA's
// concurrent blocks forbid; the first port gave each (query, 256-lane tile)
// a block of its own (32,768 blocks at B = 32, n = 1M), each staging its
// query's ew_map and zeroing and flushing a histogram for four tiles of
// work.  Here:
//   1. persistent blocks, about as many as the SMs hold, each walk a run of
//      consecutive work items (query, chunk of kChunk lanes), query-major,
//      so a block stages a query's ew_map once per run, not once per tile;
//   2. a thread holds kGroups groups of 4 consecutive lanes: one 16-byte
//      load of distances, one 4-byte load of validity bytes and one 16-byte
//      store of bucket ids a group, a warp's access 512 contiguous bytes;
//      the next item's lanes are loaded before the current one is
//      bucketized; a ragged tail (or an unaligned row) is masked lane by
//      lane, not padded.  One group a thread (1,024-lane items): at one
//      query (262,144 lanes) that spreads the lanes' divisions over 256
//      blocks, where two groups gave 128 blocks twice the serial work each
//      and ran 1.6x longer than the one-lane-a-thread kernel before this
//      design (H100 80GB HBM3);
//   3. a +inf distance (each lane off the probe, 15 of 16 at n_probe 64 of
//      1024) goes straight to bucket m (bbc::bucket_of_inf) when d_min is
//      finite and delta finite and positive: the division's own value,
//      without the IEEE division's slow path on +inf;
//   4. each warp counts into its own shared histogram (no contention
//      between warps); at the end of a query's run the block sums its warps'
//      bins and adds the nonzero ones atomically into the query's total;
//   5. the blocks add into ``hist``, which one memset on the stream zeroes
//      first (cudaMemsetAsync in the launch function, no PyTorch call).  A
//      form with no memset, whose last block per query (by a ticket) moved
//      the totals from a cached scratch into ``hist``, spent more device
//      time on its fence, ticket and read-back than the memset costs.
// Integer adds commute, so bucket and hist equal the plain version's under
// any block schedule.
#include "scan_common.cuh"

namespace {

constexpr int kGroups = 1;                              // 4-lane groups
constexpr int kChunk = bbc::kThreads * 4 * kGroups;     // lanes per item
constexpr int kWarps = bbc::kThreads / 32;
constexpr int kBlocksPerSm = 4;                         // ops.BH_BLOCKS_PER_SM

// One thread's lanes of one work item: lane 4 * (k * kThreads + tid) + i
// of the chunk holds e[4 k + i] and validity byte i of v[k].
struct Lanes {
  float e[4 * kGroups];
  unsigned v[kGroups];
};

__device__ __forceinline__ int group_lane(int base, int k) {
  return base + 4 * (k * bbc::kThreads + static_cast<int>(threadIdx.x));
}

__device__ __forceinline__ void load_lanes(const float* __restrict__ dists,
                                           const uint8_t* __restrict__ valid,
                                           size_t row, int base, int n,
                                           bool vec, Lanes& x) {
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int l0 = group_lane(base, k);
    if (vec && l0 + 4 <= n) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(dists + row + l0));
      x.e[4 * k] = f.x;
      x.e[4 * k + 1] = f.y;
      x.e[4 * k + 2] = f.z;
      x.e[4 * k + 3] = f.w;
      x.v[k] = __ldg(reinterpret_cast<const unsigned*>(valid + row + l0));
    } else {
      unsigned vm = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = l0 + i < n;
        x.e[4 * k + i] = in ? __ldg(dists + row + l0 + i) : 0.f;
        vm |= (in && __ldg(valid + row + l0 + i)) ? 1u << (8 * i) : 0u;
      }
      x.v[k] = vm;
    }
  }
}

__device__ __forceinline__ void bucketize_lanes(
    const Lanes& x, int* __restrict__ bucket, size_t row, int base, int n,
    bool vec, float dm, float dl, bool inf_m, const int* ew_s, int n_ew,
    int m, int* wh) {
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int l0 = group_lane(base, k);
    int b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      b[i] = bbc::bucket_of_inf(x.e[4 * k + i], dm, dl, inf_m, ew_s, n_ew, m);
    if (vec && l0 + 4 <= n) {
      *reinterpret_cast<int4*>(bucket + row + l0) =
          make_int4(b[0], b[1], b[2], b[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (l0 + i < n) bucket[row + l0 + i] = b[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((x.v[k] >> (8 * i)) & 0xffu) atomicAdd(&wh[b[i]], 1);
  }
}

// Add the warps' bins of query q into its row of hist, zeroing them.
__device__ __forceinline__ void flush(int* whist, int m1, int q,
                                      int* hist) {
  __syncthreads();                       // every shared add of q is done
  int* row = hist + static_cast<size_t>(q) * m1;
  for (int i = threadIdx.x; i < m1; i += blockDim.x) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += whist[w * m1 + i];
      whist[w * m1 + i] = 0;
    }
    if (s) atomicAdd(row + i, s);
  }
}

__global__ void __launch_bounds__(bbc::kThreads, kBlocksPerSm)
bucket_hist_kernel(const float* __restrict__ dists,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ d_min,
                   const float* __restrict__ delta,
                   const int* __restrict__ ew_maps, int* __restrict__ bucket,
                   int* hist, int n, int chunks, int total, int per,
                   int n_ew, int m, int vec) {
  extern __shared__ int ismem[];
  const int m1 = m + 1;
  int* ew_s = ismem;                     // n_ew
  int* whist = ew_s + n_ew;              // kWarps x (m + 1)
  int* wh = whist + (threadIdx.x >> 5) * m1;
  const int i0 = blockIdx.x * per;
  const int count = min(per, total - i0);
  for (int i = threadIdx.x; i < kWarps * m1; i += blockDim.x) whist[i] = 0;

  // the current item is (query q, chunk c); the staged codebook is qs's
  int q = i0 / chunks;
  int c = i0 - q * chunks;
  int qs = -1;
  Lanes cur, nxt;
  load_lanes(dists, valid, static_cast<size_t>(q) * n, c * kChunk, n, vec,
             cur);
  float dm = 0.f, dl = 0.f;
  bool inf_m = false;
  for (int k = 0; k < count; ++k) {
    if (q != qs) {
      if (qs >= 0) flush(whist, m1, qs, hist);
      qs = q;
      bbc::stage_rows(ew_s, ew_maps, q, 1, n_ew);
      dm = d_min[q];
      dl = delta[q];
      inf_m = bbc::inf_to_m(dm, dl);
      __syncthreads();
    }
    int qn = q, cn = c + 1;
    if (cn == chunks) {
      cn = 0;
      ++qn;
    }
    if (k + 1 < count)                   // the next item's lanes in flight
      load_lanes(dists, valid, static_cast<size_t>(qn) * n, cn * kChunk, n,
                 vec, nxt);
    bucketize_lanes(cur, bucket, static_cast<size_t>(q) * n, c * kChunk, n,
                    vec, dm, dl, inf_m, ew_s, n_ew, m, wh);
    cur = nxt;
    q = qn;
    c = cn;
  }
  flush(whist, m1, qs, hist);
}

}  // namespace

extern "C" int bucket_hist_smem_bytes(int n_ew, int m) {
  return 4 * (n_ew + kWarps * (m + 1));
}

extern "C" int bucket_hist_chunk() { return kChunk; }

// One memset of hist (B, m+1), then one launch of `grid` blocks, each
// over `per` consecutive (query, chunk) items of the B * chunks (below
// 2^31 with `per` added).  vec: n % 4 == 0, dists and bucket 16-byte
// aligned, valid 4-byte aligned.  Returns the CUDA error code.
extern "C" int bucket_hist_batch_launch(const float* dists,
                                        const uint8_t* valid,
                                        const float* d_min,
                                        const float* delta,
                                        const int* ew_maps, int* bucket,
                                        int* hist, int n, int B, int n_ew,
                                        int m, int chunks, int per, int grid,
                                        int vec, int smem,
                                        cudaStream_t stream) {
  cudaError_t err = bbc::allow_smem(bucket_hist_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(hist, 0, sizeof(int) * B * (m + 1), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  bucket_hist_kernel<<<grid, bbc::kThreads, smem, stream>>>(
      dists, valid, d_min, delta, ew_maps, bucket, hist, n, chunks,
      B * chunks, per, n_ew, m, vec);
  return static_cast<int>(cudaGetLastError());
}
