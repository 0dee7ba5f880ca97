// Batched bound-fused RaBitQ scan: estimate + lower/upper bounds + Eq. 6
// buckets of both bounds + their (B, m+1) histograms + the inline exact
// distance of bound-certified lanes + miss count, in one pass over the
// shared candidate stream.
//
// Replaces: src/repro/kernels/rabitq_fused.py::fused_rabitq_scan_batch_pallas.
// Plain version: kernels/ref.py fused_rabitq_scan_batch.
//
// Per query b and stream lane i (g = qs rot^T, the rotated queries, and
// s2[i] = code_i . (rot c_cl[i]), the query-independent centroid
// correction, come in from the caller and the stream):
//   s1 = sum_j code[i,j] g[b,j]            (ascending j, from 0)
//   ip = ((s1 - s2) / (sqrt(d) max(nq, 1e-12))) / f_o,  nq = ||q_b - c_cl[i]||
//   err = eps0 sqrt((1 - f_o^2) / (f_o^2 (d - 1)))
//   est, lb, ub = sqrt(max(base - scale (ip, ip + err, ip - err), 0))
//     with base = nq^2 + norm_o^2 and scale = (2 nq) norm_o; +inf off valid
//   certified = valid & bucket_lb <= tau_inline[b]; exact = ||q_b - x_i||
//   on certified lanes, +inf elsewhere; nmiss = valid lanes not certified.
//
// Numerics.  Every operation of the bound formulas is an explicit
// __f*_rn intrinsic in the plain version's order: nvcc would otherwise
// contract `base - scale * t` into an FMA, which the plain version (one
// PyTorch operation per step) rounds twice.  With s1 summed in the same
// order and the same fp32 inputs, est/lb/ub equal the plain version's
// bitwise, and so do both bucket ids, both histograms, `certified` and
// nmiss.  The exact leg is the direct sum of (x - q)^2 (scan_common.cuh).
//
// What bounds it on an H100: device-memory bytes.  It reads the int8 code
// row (d bytes) and 16 bytes of factors (s2, norm_o, f_o, cl) of each lane
// some query probes, the fp32 vector row of each lane some query
// certifies, and the (B, n) validity mask; it writes 25 bytes per (query,
// lane): est, lb, ub, exact (fp32), bucket_lb, bucket_ub (int32) and
// certified (byte).  The arithmetic, about 2d + 20 fp32 operations per
// probed (query, lane) pair and 3d per certified pair, needs far less
// time than the bytes; the outputs alone are 800 MB at the full-width
// shapes (B=32, n=1M).
//
// What the design does about it.
//  * One thread owns one lane for the BQ queries of its block: it reads
//    the lane's code row once (16-byte loads) and reuses it for every
//    query of the chunk; the rotated queries, the raw queries and the
//    ew_maps sit in shared memory and are read as broadcasts.
//  * The codes stay int8 (the Pallas path casts them to an fp32 stream,
//    4x the bytes), and the +-1 product is a multiply by the code value,
//    exact in fp32; no tensor cores are needed to be right.
//  * The per-query routing norms come in as (B, C) and are indexed by the
//    lane's cluster inside the kernel: the stream is cluster-major, so a
//    warp reads one or two words, where the Pallas wrapper materialises a
//    (B, n) copy.
//  * Lanes no query of the chunk probes are written as (+inf, +inf, +inf,
//    m, m, +inf, false) without reading their rows; a vector row is read
//    only if some query of the chunk certifies the lane.
//  * Both histograms and the miss counts are per-block shared-memory
//    atomics folded into zeroed globals: CUDA blocks run concurrently,
//    unlike the TPU grid the Pallas kernel's accumulate-at-program_id-0
//    relies on.
//  * blockIdx.x walks the query chunks fastest, so the chunks of one lane
//    tile run side by side and the later ones read the tile from L2.
#include "scan_common.cuh"

namespace {

// max(x, 0) that lets NaN through, as torch.clamp(min=0) does.
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float bound_dist(float base, float scale,
                                            float t) {
  return __fsqrt_rn(clamp0(__fsub_rn(base, __fmul_rn(scale, t))));
}

// The lane's error bound eps0 sqrt((1 - f_o^2) / (f_o^2 (d - 1))), dm1 =
// d - 1: numerics.lane_err's operations in its order.
__device__ __forceinline__ float lane_err(float fo, float eps0, float dm1) {
  const float ff = __fmul_rn(fo, fo);
  return __fmul_rn(eps0, __fsqrt_rn(__fdiv_rn(__fsub_rn(1.f, ff),
                                              __fmul_rn(ff, dm1))));
}

// What numerics.rabitq_bounds forms of one (query, lane) pair before its
// three bound_dist calls, in its order: the estimated inner product ip,
// scale = (2 nq) norm_o and base = nq^2 + norm_o^2.
struct BoundTerms {
  float ip, scale, base;
};

__device__ __forceinline__ BoundTerms bound_terms(float s1, float s2v,
                                                  float nqv, float no,
                                                  float fo, float sqrt_d) {
  const float den = __fmul_rn(fmaxf(nqv, 1e-12f), sqrt_d);
  return {__fdiv_rn(__fdiv_rn(__fsub_rn(s1, s2v), den), fo),
          __fmul_rn(__fmul_rn(2.f, nqv), no),
          __fadd_rn(__fmul_rn(nqv, nqv), __fmul_rn(no, no))};
}

template <int BQ>
__device__ __forceinline__ void add_code(float* s1, float c, const float* g_s,
                                         int d, int j) {
#pragma unroll
  for (int q = 0; q < BQ; ++q)
    s1[q] = __fadd_rn(s1[q], __fmul_rn(c, g_s[q * d + j]));
}

template <int BQ>
__global__ void __launch_bounds__(bbc::kThreads)
rabitq_fused_kernel(const int8_t* __restrict__ codes,
                    const float* __restrict__ vectors,
                    const float* __restrict__ s2,
                    const float* __restrict__ norm_o,
                    const float* __restrict__ f_o,
                    const int* __restrict__ cl,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ nq,
                    const float* __restrict__ g,
                    const float* __restrict__ qs,
                    const float* __restrict__ d_min,
                    const float* __restrict__ delta,
                    const int* __restrict__ ew_maps,
                    const int* __restrict__ tau_inline,
                    float* __restrict__ est, float* __restrict__ lb,
                    float* __restrict__ ub, int* __restrict__ bucket_lb,
                    int* __restrict__ bucket_ub, float* __restrict__ exact,
                    uint8_t* __restrict__ certified,
                    int* __restrict__ hist_lb, int* __restrict__ hist_ub,
                    int* __restrict__ nmiss, int n, int d, int B, int C,
                    int n_ew, int m, float sqrt_d, float eps0, float dm1) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * BQ;
  const int nqb = min(BQ, B - q0);
  const int m1 = m + 1;
  float* g_s = smem;                                     // BQ * d
  float* q_s = g_s + BQ * d;                             // BQ * d
  float* par_s = q_s + BQ * d;                           // BQ * 2
  int* ew_s = reinterpret_cast<int*>(par_s + 2 * BQ);    // BQ * n_ew
  int* hlb_s = ew_s + BQ * n_ew;                         // BQ * m1
  int* hub_s = hlb_s + BQ * m1;                          // BQ * m1
  int* tau_s = hub_s + BQ * m1;                          // BQ
  int* miss_s = tau_s + BQ;                              // BQ

  bbc::stage_rows(g_s, g, q0, nqb, d);
  bbc::stage_rows(q_s, qs, q0, nqb, d);
  bbc::stage_rows(ew_s, ew_maps, q0, nqb, n_ew);
  for (int i = threadIdx.x; i < 2 * BQ * m1; i += blockDim.x) hlb_s[i] = 0;
  if (threadIdx.x < BQ) {
    const int j = threadIdx.x;
    const bool live = j < nqb;
    par_s[2 * j] = live ? d_min[q0 + j] : 0.f;
    par_s[2 * j + 1] = live ? delta[q0 + j] : 1.f;
    tau_s[j] = live ? tau_inline[q0 + j] : -1;
    miss_s[j] = 0;
  }
  __syncthreads();

  const float inf = __int_as_float(0x7f800000);
  for (int tile = blockIdx.y; tile * bbc::kThreads < n; tile += gridDim.y) {
    const int lane = tile * bbc::kThreads + threadIdx.x;
    if (lane >= n) continue;
    bool v[BQ];
    bool any_v = false;
#pragma unroll
    for (int j = 0; j < BQ; ++j) {
      v[j] = j < nqb && valid[static_cast<size_t>(q0 + j) * n + lane];
      any_v |= v[j];
    }
    float s1[BQ];
#pragma unroll
    for (int j = 0; j < BQ; ++j) s1[j] = 0.f;
    float s2v = 0.f, no = 0.f, fo = 1.f, err = 0.f;
    int c = 0;
    if (any_v) {
      const int8_t* crow = codes + static_cast<size_t>(lane) * d;
      if ((d & 15) == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0) {
        const int4* c16 = reinterpret_cast<const int4*>(crow);
        for (int t = 0; t < d / 16; ++t) {
          const int4 w = __ldg(c16 + t);
          const int8_t* cb = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
          for (int u = 0; u < 16; ++u)
            add_code<BQ>(s1, static_cast<float>(cb[u]), g_s, d, 16 * t + u);
        }
      } else {
        for (int t = 0; t < d; ++t)
          add_code<BQ>(s1, static_cast<float>(__ldg(crow + t)), g_s, d, t);
      }
      s2v = __ldg(s2 + lane);
      no = __ldg(norm_o + lane);
      fo = __ldg(f_o + lane);
      c = __ldg(cl + lane);
      err = lane_err(fo, eps0, dm1);
    }
    bool cert[BQ];
    bool any_c = false;
#pragma unroll
    for (int j = 0; j < BQ; ++j) {
      cert[j] = false;
      if (j >= nqb) continue;
      const size_t o = static_cast<size_t>(q0 + j) * n + lane;
      float e = inf, l = inf, u = inf;
      int bl = m, bu = m;
      if (v[j]) {
        const float nqv = __ldg(nq + static_cast<size_t>(q0 + j) * C + c);
        const BoundTerms bt = bound_terms(s1[j], s2v, nqv, no, fo, sqrt_d);
        e = bound_dist(bt.base, bt.scale, bt.ip);
        l = bound_dist(bt.base, bt.scale, __fadd_rn(bt.ip, err));
        u = bound_dist(bt.base, bt.scale, __fsub_rn(bt.ip, err));
        const float dm = par_s[2 * j], dl = par_s[2 * j + 1];
        bl = bbc::bucket_of(l, dm, dl, ew_s + j * n_ew, n_ew, m);
        bu = bbc::bucket_of(u, dm, dl, ew_s + j * n_ew, n_ew, m);
        atomicAdd(&hlb_s[j * m1 + bl], 1);
        atomicAdd(&hub_s[j * m1 + bu], 1);
        cert[j] = bl <= tau_s[j];
        if (!cert[j]) atomicAdd(&miss_s[j], 1);
      }
      est[o] = e;
      lb[o] = l;
      ub[o] = u;
      bucket_lb[o] = bl;
      bucket_ub[o] = bu;
      certified[o] = cert[j];
      any_c |= cert[j];
    }
    float sq[BQ];
#pragma unroll
    for (int j = 0; j < BQ; ++j) sq[j] = 0.f;
    if (any_c)
      bbc::sq_dists<BQ>(vectors + static_cast<size_t>(lane) * d, q_s, d, sq);
#pragma unroll
    for (int j = 0; j < BQ; ++j) {
      if (j >= nqb) continue;
      exact[static_cast<size_t>(q0 + j) * n + lane] =
          cert[j] ? sqrtf(sq[j]) : inf;
    }
  }
  __syncthreads();
  bbc::flush_hist(hlb_s, hist_lb, q0, nqb, m1);
  bbc::flush_hist(hub_s, hist_ub, q0, nqb, m1);
  if (threadIdx.x < nqb && miss_s[threadIdx.x])
    atomicAdd(&nmiss[q0 + threadIdx.x], miss_s[threadIdx.x]);
}

struct Args {
  const int8_t* codes; const float* vectors; const float* s2;
  const float* norm_o; const float* f_o; const int* cl; const uint8_t* valid;
  const float* nq; const float* g; const float* qs; const float* d_min;
  const float* delta; const int* ew_maps; const int* tau_inline;
  float* est; float* lb; float* ub; int* bucket_lb; int* bucket_ub;
  float* exact; uint8_t* certified; int* hist_lb; int* hist_ub; int* nmiss;
};

template <int BQ>
int launch(const Args& a, int n, int d, int B, int C, int n_ew, int m,
           float sqrt_d, float eps0, float dm1, int tiles, int smem,
           cudaStream_t stream) {
  cudaError_t err = bbc::allow_smem(rabitq_fused_kernel<BQ>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + BQ - 1) / BQ, tiles);
  rabitq_fused_kernel<BQ><<<grid, bbc::kThreads, smem, stream>>>(
      a.codes, a.vectors, a.s2, a.norm_o, a.f_o, a.cl, a.valid, a.nq, a.g,
      a.qs, a.d_min, a.delta, a.ew_maps, a.tau_inline, a.est, a.lb, a.ub,
      a.bucket_lb, a.bucket_ub, a.exact, a.certified, a.hist_lb, a.hist_ub,
      a.nmiss, n, d, B, C, n_ew, m, sqrt_d, eps0, dm1);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The codebook sample's upper bounds: each query's ub over the lanes of its
// nearest probed clusters, each padded to cap lanes, before the scan runs.
//
// Replaces no TPU kernel: the JAX package computes the sample with XLA ops
// (src/repro/index/search.py _rabitq_sample_ub, a lax.map over queries),
// and the port did the same until this kernel, about a hundred launches a
// call (kernels/ref.py rabitq_sample_ub_batch is that composition, the
// plain version).  Query b's sample lane j = t cap + l is lane l of
// cluster clusters[b, t]: inside the cluster (ok) when l < its size, at
// stream position offsets[cluster] + l, as ivf.tile_positions places it.
// s1 = code . g[b] is added in numerics.ordered_sum's pairwise order (the
// first half plus the second, elementwise, until one column is left, an
// odd column riding along), every product and add one __f*_rn rounding;
// the ub is numerics.rabitq_bounds' with the scan's device functions
// above.  So ub equals the plain version's bitwise at every d.  Lanes off
// the sample are +inf and read nothing.
//
// What bounds it on an H100.  Bytes: each sampled lane's d bytes of codes
// and 16 bytes of factors (clusters shared by queries read again, mostly
// from L2), and the (B, w) ub and ok written; at B = 32, w = 16,384,
// d = 128 ~78 MB at most, ~0.02 ms.  The composition it replaces builds a
// (B, w, d) fp32 block of 64 MB a chunk and halves it in seven launches.
//
// What the design does about it.  A block serves one query (blockIdx.y)
// and stages its rotated query in shared memory once; each thread takes
// one lane at a time, with a stride of gridDim.x threads.  The thread
// forms the first halving round while it reads the code row (columns i and
// i + d/2 together, 16-byte words where d is a multiple of 32 and the
// codes start on a 16-byte boundary) into its own shared row of ceil(d/2)
// floats, then halves the row in place.  A row's odd stride puts a warp's
// 32 rows in 32 banks, and g is read as broadcasts.
template <bool kVec>
__global__ void __launch_bounds__(bbc::kThreads)
rabitq_sample_ub_kernel(const int8_t* __restrict__ codes,
                        const float* __restrict__ s2,
                        const float* __restrict__ norm_o,
                        const float* __restrict__ f_o,
                        const int* __restrict__ cl,
                        const int64_t* __restrict__ offsets,
                        const int64_t* __restrict__ clusters, int ld,
                        const float* __restrict__ g,
                        const float* __restrict__ nq,
                        float* __restrict__ ub, uint8_t* __restrict__ ok,
                        int d, int C, int cap, int w, int stride,
                        float sqrt_d, float eps0, float dm1) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  float* g_s = smem;                                     // d
  float* s = g_s + d + threadIdx.x * stride;             // this thread's row
  bbc::stage_rows(g_s, g, b, 1, d);
  __syncthreads();
  const int64_t* cls = clusters + static_cast<size_t>(b) * ld;
  const float* nq_b = nq + static_cast<size_t>(b) * C;
  const size_t row0 = static_cast<size_t>(b) * w;
  const int h0 = d >> 1;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < w;
       j += gridDim.x * blockDim.x) {
    const int t = j / cap;
    const int l = j - t * cap;
    const int64_t c = __ldg(cls + t);
    const int64_t off = __ldg(offsets + c);
    const bool in = l < __ldg(offsets + c + 1) - off;
    float u = INFINITY;
    if (in) {
      const int64_t pos = off + l;
      const int8_t* crow = codes + pos * d;
      // the first round: s[i] = p[i] + p[i + h0], p[i] = code[i] g[i]
      if constexpr (kVec) {
        const int4* c16 = reinterpret_cast<const int4*>(crow);
        const int hw = h0 / 16;
        for (int q = 0; q < hw; ++q) {
          const int4 lo = __ldg(c16 + q);
          const int4 hi = __ldg(c16 + q + hw);
          const int8_t* a = reinterpret_cast<const int8_t*>(&lo);
          const int8_t* z = reinterpret_cast<const int8_t*>(&hi);
#pragma unroll
          for (int v = 0; v < 16; ++v) {
            const int i = 16 * q + v;
            s[i] = __fadd_rn(__fmul_rn(static_cast<float>(a[v]), g_s[i]),
                             __fmul_rn(static_cast<float>(z[v]),
                                       g_s[i + h0]));
          }
        }
      } else {
        for (int i = 0; i < h0; ++i)
          s[i] = __fadd_rn(
              __fmul_rn(static_cast<float>(__ldg(crow + i)), g_s[i]),
              __fmul_rn(static_cast<float>(__ldg(crow + i + h0)),
                        g_s[i + h0]));
        if (d & 1)
          s[h0] = __fmul_rn(static_cast<float>(__ldg(crow + 2 * h0)),
                            g_s[2 * h0]);
      }
      // the later rounds, in place; an odd column moves down to s[h]
      for (int len = h0 + (d & 1); len > 1;) {
        const int h = len >> 1;
        for (int i = 0; i < h; ++i) s[i] = __fadd_rn(s[i], s[i + h]);
        if (len & 1) s[h] = s[2 * h];
        len = h + (len & 1);
      }
      const float fo = __ldg(f_o + pos);
      const BoundTerms bt = bound_terms(s[0], __ldg(s2 + pos),
                                        __ldg(nq_b + __ldg(cl + pos)),
                                        __ldg(norm_o + pos), fo, sqrt_d);
      u = bound_dist(bt.base, bt.scale,
                     __fsub_rn(bt.ip, lane_err(fo, eps0, dm1)));
    }
    ub[row0 + j] = u;
    ok[row0 + j] = in;
  }
}

}  // namespace

// Shared-memory bytes one block needs for a chunk of bq queries.
extern "C" int rabitq_fused_smem_bytes(int bq, int d, int n_ew, int m) {
  return 4 * bq * (2 * d + 2 + n_ew + 2 * (m + 1) + 2);
}

// Outputs hist_lb, hist_ub (B, m+1) and nmiss (B,) must arrive zeroed.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fused_rabitq_scan_batch_launch(
    const int8_t* codes, const float* vectors, const float* s2,
    const float* norm_o, const float* f_o, const int* cl,
    const uint8_t* valid, const float* nq, const float* g, const float* qs,
    const float* d_min, const float* delta, const int* ew_maps,
    const int* tau_inline, float* est, float* lb, float* ub, int* bucket_lb,
    int* bucket_ub, float* exact, uint8_t* certified, int* hist_lb,
    int* hist_ub, int* nmiss, int n, int d, int B, int C, int n_ew, int m,
    float sqrt_d, float eps0, float dm1, int bq, int tiles, int smem,
    cudaStream_t stream) {
  const Args a{codes, vectors, s2, norm_o, f_o, cl, valid, nq, g, qs, d_min,
               delta, ew_maps, tau_inline, est, lb, ub, bucket_lb, bucket_ub,
               exact, certified, hist_lb, hist_ub, nmiss};
  switch (bq) {
    case 8: return launch<8>(a, n, d, B, C, n_ew, m, sqrt_d, eps0, dm1, tiles,
                             smem, stream);
    case 4: return launch<4>(a, n, d, B, C, n_ew, m, sqrt_d, eps0, dm1, tiles,
                             smem, stream);
    case 2: return launch<2>(a, n, d, B, C, n_ew, m, sqrt_d, eps0, dm1, tiles,
                             smem, stream);
    case 1: return launch<1>(a, n, d, B, C, n_ew, m, sqrt_d, eps0, dm1, tiles,
                             smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The sample's upper bounds over (B, t*cap) lanes: `threads` lanes a block
// (32 to 256, a multiple of 32), `grid_x` blocks a query, `stride` floats
// a thread's shared row (odd, at least ceil(d/2)) and `smem` bytes of
// shared memory (at least the rotated query and the rows); `vec` takes
// 16-byte code words (d a multiple of 32, 16-byte aligned codes).  Anything
// else is refused.
extern "C" int rabitq_sample_ub_launch(
    const int8_t* codes, const float* s2, const float* norm_o,
    const float* f_o, const int* cl, const int64_t* offsets,
    const int64_t* clusters, int ld, const float* g, const float* nq,
    float* ub, uint8_t* ok, int d, int B, int C, int t, int cap, int vec,
    int threads, int grid_x, int stride, int smem, float sqrt_d, float eps0,
    float dm1, cudaStream_t stream) {
  const long long rows = 4LL * (d + static_cast<long long>(threads) * stride);
  if (d < 1 || B < 1 || B > 65535 || C < 1 || t < 1 || cap < 1
      || static_cast<long long>(t) * cap >= (1LL << 31) || grid_x < 1
      || threads < 32 || threads > bbc::kThreads || threads % 32 != 0
      || stride < (d + 1) / 2 || stride % 2 == 0 || smem < rows
      || (vec && (d % 32 != 0
                  || reinterpret_cast<uintptr_t>(codes) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vec ? rabitq_sample_ub_kernel<true>
                    : rabitq_sample_ub_kernel<false>;
  cudaError_t err = bbc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(grid_x, B), threads, smem, stream>>>(
      codes, s2, norm_o, f_o, cl, offsets, clusters, ld, g, nq, ub, ok, d, C,
      cap, t * cap, stride, sqrt_d, eps0, dm1);
  return static_cast<int>(cudaGetLastError());
}
