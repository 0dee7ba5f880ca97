// The codebook sample's plan: a query batch's equal-depth codebooks and the
// bucket of each row's rank-th sampled value, one block a query, in one
// launch.
//
// Replaces no TPU kernel: the JAX package builds the plan with XLA ops
// (src/repro/core/buffer.py:82 build_codebook and :105
// build_codebook_from_topk, src/repro/core/rerank.py:372
// early_rerank_plan, src/repro/index/search.py:897 _rabitq_sample_plan),
// and the port did the same until this kernel: a sorted torch.topk, then
// some fifty elementwise launches, a kthvalue and a searchsorted a call
// (kernels/ref.py sample_plan_batch is that composition, the plain
// version).  Per query row of w values:
//   v = ok ? (sqrt_in ? sqrt(max(x, 0)) : x) : +inf     (NaN stays NaN)
//   t = the k smallest v ascending, in torch.topk's order (NaN last)
//   r(i) = t[i] if finite else the row's largest finite t (0 if none)
//   d_min = r(0), span = max(r(k-1) - d_min, 1e-6) * 1.02,
//   delta = span * (1 / n_ew), eps = span * 1e-7
//   edges[j] = r(lo) + (r(hi) - r(lo)) * frac + eps * j, at
//     pos = (k - 1) * (j * (1 / m)) (k - 1 at j = m), lo = floor(pos),
//     hi = min(lo + 1, k - 1), frac = pos - lo
//   ew_map[i] = clamp(searchsorted(edges, d_min + (i + 0.5) * delta,
//                                  right) - 1, 0, m - 1)
//   tau = min(bucket_of(t[rank - 1]) + margin, cap)   (with a rank)
//
// Numerics.  Every fp32 step is one __f*_rn rounding in the plain version's
// order: nvcc would otherwise contract r(lo) + d * frac and the rest into
// FMAs, which the plain version (one PyTorch operation a step) rounds
// twice.  PyTorch on the card divides a tensor by a Python scalar as a
// multiply by the scalar's fp32 reciprocal (span / n_ew, arange(m) / m), so
// the kernel does the same; Python-float constants (1.02, 1e-6, 1e-7) come
// in as the fp32 values PyTorch converts them to.  Rows sort by
// torch.topk's radix key (TopKTypeConfig<float>: -0 before +0, every NaN
// last), the rank-th value is that order's (kthvalue's), the binary search
// is searchsorted's and the bucket Eq. 6's bucket_of.  So edges, d_min,
// delta, ew_map and tau equal the plain version's on the card bitwise.
//
// What bounds it on an H100: launches, not bytes.  At the cells' shapes
// (B = 32, w = 16,384) it reads 2 MB of sample values and writes ~50 KB;
// the composition spent ~55 launches (and the host's time to issue them)
// on (B, <= 257) arrays, one top-k and one k-th value a row.  The kernel's
// own time is its sort's: 32 blocks, one a query, each through 105 stages
// of compare-exchanges, far above the bytes' bound of under a microsecond.
//
// What the design does about it.  A block serves one query.  Where the
// row's power of two of 4-byte keys fits shared memory beside the edges
// and the ew_map (w <= 32,768: 128 KB), the block loads the row, masks and
// takes the square root as it loads, and sorts the keys there (a bitonic
// network, values only: ties need no order; 16 keys a thread, so that every
// stride under 512 runs in a warp's registers and shuffles and only the
// longer ones pass through shared memory, 15 of the 105 stages at 16,384);
// the plan then reads the sorted prefix from shared memory.  Longer rows
// arrive already sorted (the wrapper narrows them with torch.topk: the
// long-row mode), and so do a caller's top-k rows; the plan reads them from
// device memory.  The plan's largest finite value is one block reduction,
// the m + 1 edges and the n_ew centres a thread each, and the rank-th
// bucket one thread's.
#include "scan_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr uint32_t kNanKey = 0xffffffffu;

// torch.topk's radix key of a float: ascending keys are ascending values,
// -0 before +0, and every NaN the largest key.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t x = __float_as_uint(v);
  const uint32_t mask = (x & 0x80000000u) ? 0xffffffffu : 0x80000000u;
  return v == v ? (x ^ mask) : kNanKey;
}

__device__ __forceinline__ float key_value(uint32_t key) {
  if (key == kNanKey) return __uint_as_float(0x7fffffffu);
  const uint32_t mask = (key & 0x80000000u) ? 0x80000000u : 0xffffffffu;
  return __uint_as_float(key ^ mask);
}

constexpr int kLaneKeys = 16;              // keys a lane holds in registers
constexpr int kWarpKeys = 32 * kLaneKeys;  // keys a warp sorts on its own

// One stage of a bitonic merge of `size` at stride `stride` over n keys in
// shared memory, a pair a thread, then a barrier.
__device__ __forceinline__ void smem_stage(uint32_t* keys, int n, int size,
                                           int stride) {
  for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
    const int lo = 2 * i - (i & (stride - 1));
    const int hi = lo + stride;
    const uint32_t a = keys[lo], c = keys[hi];
    if ((a > c) == ((lo & size) == 0)) {
      keys[lo] = c;
      keys[hi] = a;
    }
  }
  __syncthreads();
}

// A warp's segment of kWarpKeys keys in registers: lane l holds keys
// idx0 + 32 j (idx0 = the segment's start + l).  A stride of 32 R pairs a
// lane's registers j and j + R; a stride under 32 pairs lanes l and l ^ s.
template <int R>
__device__ __forceinline__ void reg_stage(uint32_t (&v)[kLaneKeys], int idx0,
                                          int size) {
#pragma unroll
  for (int j = 0; j < kLaneKeys; ++j) {
    if (j & R) continue;
    const bool up = ((idx0 + 32 * j) & size) == 0;
    const uint32_t a = v[j], c = v[j + R];
    const bool swap = (a > c) == up;
    v[j] = swap ? c : a;
    v[j + R] = swap ? a : c;
  }
}

__device__ __forceinline__ void shfl_stage(uint32_t (&v)[kLaneKeys], int idx0,
                                           int size, int s) {
  const bool lower = (threadIdx.x & s) == 0;
#pragma unroll
  for (int j = 0; j < kLaneKeys; ++j) {
    const uint32_t p = __shfl_xor_sync(0xffffffffu, v[j], s);
    const bool up = ((idx0 + 32 * j) & size) == 0;
    v[j] = (lower == up) ? min(v[j], p) : max(v[j], p);
  }
}

// The stages of the merge of `size` from stride `s` down to 1 (s < the
// segment) on a warp's segment in registers.
__device__ __forceinline__ void warp_merge(uint32_t (&v)[kLaneKeys], int idx0,
                                           int size, int s) {
  for (; s >= 32; s >>= 1) {
    if (s == 256) reg_stage<8>(v, idx0, size);
    else if (s == 128) reg_stage<4>(v, idx0, size);
    else if (s == 64) reg_stage<2>(v, idx0, size);
    else reg_stage<1>(v, idx0, size);
  }
  for (; s >= 1; s >>= 1) shfl_stage(v, idx0, size, s);
}

// Ascending bitonic sort of n (a power of two) keys in shared memory.  With
// kLaneKeys keys a thread (n = kLaneKeys blockDim.x, n >= kWarpKeys) every
// stage of stride under kWarpKeys runs in a warp's registers and shuffles,
// with no barrier; only the longer strides go through shared memory.  Else
// every stage does, a pair a thread.
__device__ void block_sort(uint32_t* keys, int n) {
  if (n < kWarpKeys || n != kLaneKeys * static_cast<int>(blockDim.x)) {
    for (int size = 2; size <= n; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1)
        smem_stage(keys, n, size, stride);
    return;
  }
  const int idx0 = (threadIdx.x >> 5) * kWarpKeys + (threadIdx.x & 31);
  uint32_t v[kLaneKeys];
#pragma unroll
  for (int j = 0; j < kLaneKeys; ++j) v[j] = keys[idx0 + 32 * j];
  for (int size = 2; size <= kWarpKeys; size <<= 1)
    warp_merge(v, idx0, size, size >> 1);
  for (int size = 2 * kWarpKeys; size <= n; size <<= 1) {
#pragma unroll
    for (int j = 0; j < kLaneKeys; ++j) keys[idx0 + 32 * j] = v[j];
    __syncthreads();
    for (int stride = size >> 1; stride >= kWarpKeys; stride >>= 1)
      smem_stage(keys, n, size, stride);
#pragma unroll
    for (int j = 0; j < kLaneKeys; ++j) v[j] = keys[idx0 + 32 * j];
    warp_merge(v, idx0, size, kWarpKeys >> 1);
  }
#pragma unroll
  for (int j = 0; j < kLaneKeys; ++j) keys[idx0 + 32 * j] = v[j];
  __syncthreads();
}

// The largest finite value of t[0, k) (-inf if none), for every thread.
__device__ float block_max_finite(const float* t, int k, float* red) {
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float v = t[i];
    if (isfinite(v) && v > mx) mx = v;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, mx, o);
    if (y > mx) mx = y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x < 32) {
    float y = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) {
      const float z = __shfl_xor_sync(0xffffffffu, y, o);
      if (z > y) y = z;
    }
    if (threadIdx.x == 0) red[32] = y;
  }
  __syncthreads();
  return red[32];
}

}  // namespace

__global__ void __launch_bounds__(kMaxThreads)
sample_plan_kernel(const float* __restrict__ vals,
                   const uint8_t* __restrict__ ok, long long ld, int w, int k,
                   int sort, int sqrt_in, int m, int n_ew, int rank,
                   int margin, int cap, float span_floor, float range_margin,
                   float eps_rel, float* __restrict__ edges,
                   float* __restrict__ d_min_out,
                   float* __restrict__ delta_out, int* __restrict__ ew_out,
                   int* __restrict__ tau_out, int padded) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem_raw);
  float* edges_s = reinterpret_cast<float*>(keys + padded);
  int* ew_s = reinterpret_cast<int*>(edges_s + m + 1);
  float* red = reinterpret_cast<float*>(ew_s + n_ew);     // 33 floats
  const int b = blockIdx.x;
  const float* row = vals + static_cast<size_t>(b) * ld;
  const float* t = row;
  if (sort) {
    const uint8_t* okr = ok ? ok + static_cast<size_t>(b) * w : nullptr;
    for (int i = threadIdx.x; i < padded; i += blockDim.x) {
      uint32_t key = kNanKey;                     // padding sorts last
      if (i < w) {
        float v = row[i];
        if (sqrt_in) v = bbc::clamp0_sqrt(v);
        if (okr && !okr[i]) v = INFINITY;
        key = order_key(v);
      }
      keys[i] = key;
    }
    __syncthreads();
    block_sort(keys, padded);
    float* sorted = reinterpret_cast<float*>(keys);
    for (int i = threadIdx.x; i < padded; i += blockDim.x)
      sorted[i] = key_value(keys[i]);
    __syncthreads();
    t = sorted;
  }

  const float mx = block_max_finite(t, k, red);
  const float top = isfinite(mx) ? mx : 0.f;
  auto fix = [top](float v) { return isfinite(v) ? v : top; };
  const float d_min = fix(t[0]);
  const float diff = __fsub_rn(fix(t[k - 1]), d_min);
  // torch.maximum: a NaN operand wins
  const float wide = (diff != diff || diff > span_floor) ? diff : span_floor;
  const float span = __fmul_rn(wide, range_margin);
  const float delta =
      __fmul_rn(span, __fdiv_rn(1.f, static_cast<float>(n_ew)));
  const float eps = __fmul_rn(span, eps_rel);
  const float inv_m = __fdiv_rn(1.f, static_cast<float>(m));
  const float km1 = static_cast<float>(k - 1);
  for (int j = threadIdx.x; j <= m; j += blockDim.x) {
    const float pos = j < m
        ? __fmul_rn(km1, __fmul_rn(static_cast<float>(j), inv_m)) : km1;
    const int lo = static_cast<int>(floorf(pos));
    const int hi = min(lo + 1, k - 1);
    const float frac = __fsub_rn(pos, static_cast<float>(lo));
    const float a = fix(t[lo]);
    const float e = __fadd_rn(a, __fmul_rn(__fsub_rn(fix(t[hi]), a), frac));
    const float edge = __fadd_rn(e, __fmul_rn(eps, static_cast<float>(j)));
    edges_s[j] = edge;
    edges[static_cast<size_t>(b) * (m + 1) + j] = edge;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_ew; j += blockDim.x) {
    const float c = __fadd_rn(
        d_min, __fmul_rn(__fadd_rn(static_cast<float>(j), 0.5f), delta));
    // torch.searchsorted(right=True)'s binary search: the first edge > c
    int lo = 0, hi = m + 1;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(edges_s[mid] > c)) lo = mid + 1;
      else hi = mid;
    }
    const int id = min(max(lo - 1, 0), m - 1);
    ew_s[j] = id;
    ew_out[static_cast<size_t>(b) * n_ew + j] = id;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    d_min_out[b] = d_min;
    delta_out[b] = delta;
    if (rank > 0)
      tau_out[b] = min(bbc::bucket_of(t[rank - 1], d_min, delta, ew_s, n_ew,
                                      m) + margin, cap);
  }
}

// The plan of B rows: `sort` rows of w values (row stride ld; `ok` (B, w)
// bytes or null; `sqrt_in` for squared estimates) sorted in `padded` (a
// power of two >= w) keys of shared memory, or sorted rows of w values
// read in place (`padded` 0; no mask, no root).  The codebooks span the k
// smallest; `rank` (1 to w) asks for the bucket, 0 for none.  `smem` must
// hold the keys, the m + 1 edges, the n_ew map and 33 floats.  Anything
// else is refused.
extern "C" int sample_plan_launch(
    const float* vals, const uint8_t* ok, long long ld, int w, int k,
    int sort, int sqrt_in, int B, int m, int n_ew, int rank, int margin,
    int cap, float span_floor, float range_margin, float eps_rel,
    float* edges, float* d_min, float* delta, int* ew_map, int* tau,
    int padded, int threads, int smem, cudaStream_t stream) {
  const long long need = 4LL * (padded + m + 1 + n_ew + 33);
  if (B < 1 || w < 1 || k < 1 || k > w || ld < w || m < 1 || n_ew < 1
      || rank < 0 || rank > w || (rank > 0 && !tau) || threads < 32
      || threads > kMaxThreads || threads % 32 != 0 || smem < need
      || (sort && (padded < w || (padded & (padded - 1)) != 0))
      || (!sort && (padded != 0 || ok || sqrt_in)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = bbc::allow_smem(sample_plan_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sample_plan_kernel<<<B, threads, smem, stream>>>(
      vals, ok, ld, w, k, sort, sqrt_in, m, n_ew, rank, margin, cap,
      span_floor, range_margin, eps_rel, edges, d_min, delta, ew_map, tau,
      padded);
  return static_cast<int>(cudaGetLastError());
}
