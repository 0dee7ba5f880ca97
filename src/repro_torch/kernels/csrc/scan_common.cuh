// Device functions shared by the port's kernels (fused_scan.cu, pq_adc.cu,
// l2_rerank.cu, bucket_hist.cu, rabitq_fused.cu, shard_collect.cu,
// rabitq_est.cu, sample_plan.cu, lane_mask.cu).
//
// Numerics.  Build without --use_fast_math: the bucket id of an estimate
// must equal the plain PyTorch version's for the same fp32 value, which
// holds only with IEEE division, floorf and IEEE sqrtf (nvcc's defaults
// -prec-div=true -prec-sqrt=true).  The ADC sum adds the sub-quantizer
// terms in ascending m in fp32, the order kernels/ref.py uses, so estimates
// are bit-identical to the plain version.
//
// The exact legs sum (x - q)^2 directly rather than the norm identity
// |x|^2 - 2 x.q + |q|^2 that the Pallas kernels compute as a matmul: a
// sequential fp32 norm identity cancels (on the clustered corpora, |x|^2 ~
// 500 beside a nearest distance ~1, it alone uses over half of the 1e-4
// bar).  Each coordinate is a subtract, a multiply and an add, written as
// __fsub_rn/__fmul_rn/__fadd_rn so that nvcc contracts nothing into an
// FMA, and the coordinates are added in ascending order from 0: the order
// and the roundings of core/numerics.py exact_dist.  The exact distances
// are therefore bit-identical to the plain version's, on the CPU and on the
// card, and near-ties at the k-th place rank alike on both.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace bbc {

constexpr int kThreads = 256;   // one lane per thread within a lane tile

// The plain version's sqrt(max(acc, 0)): torch.clamp keeps a NaN sum NaN
// (the reference's jnp.maximum too), where fmaxf would return 0.
__device__ __forceinline__ float clamp0_sqrt(float acc) {
  return sqrtf(acc < 0.f ? 0.f : acc);
}

// Eq. 6: ew_map[clamp(floor((e - d_min) / delta), 0, n_ew - 1)], or the
// overflow bucket m when the bin is past the equal-width range.  +inf
// estimates (masked lanes) land in m.
__device__ __forceinline__ int bucket_of(float e, float d_min, float delta,
                                         const int* ew, int n_ew, int m) {
  const float bf = floorf((e - d_min) / delta);
  if (bf >= static_cast<float>(n_ew)) return m;
  const int bi = bf >= 0.f ? static_cast<int>(bf) : 0;  // NaN maps to 0 too
  return ew[bi];
}

// Whether a +inf distance (a lane off the probe) may skip the division:
// for a finite d_min and a positive finite delta, (inf - d_min) / delta is
// +inf, past every bin, so bucket_of gives m; but the IEEE division takes
// its slow path on +inf.  Not for a degenerate codebook: with d_min = +inf
// the difference is NaN (bin 0), with delta = 0 it is the division's own.
__device__ __forceinline__ bool inf_to_m(float d_min, float delta) {
  return isfinite(d_min) && isfinite(delta) && delta > 0.f;
}

// bucket_of with the +inf shortcut where ``inf_m`` (inf_to_m of the
// query's codebook) allows it: the same bucket id for every input.
__device__ __forceinline__ int bucket_of_inf(float e, float d_min,
                                             float delta, bool inf_m,
                                             const int* ew, int n_ew, int m) {
  return (inf_m && e == INFINITY) ? m : bucket_of(e, d_min, delta, ew, n_ew, m);
}

// Sum of one shared-memory row of nq histograms into the zeroed global
// (B, m1) histogram.  Blocks run concurrently and in no order, so each
// block counts in shared memory and adds its nonzero bins atomically.
__device__ __forceinline__ void flush_hist(const int* hist_s, int* hist,
                                           int q0, int nq, int m1) {
  for (int i = threadIdx.x; i < nq * m1; i += blockDim.x) {
    const int c = hist_s[i];
    if (c) atomicAdd(&hist[static_cast<size_t>(q0 + i / m1) * m1 + i % m1], c);
  }
}

// Stage nq rows of `width` elements starting at row q0 into shared memory.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int q0,
                                           int nq, int width) {
  const T* base = src + static_cast<size_t>(q0) * width;
  for (int i = threadIdx.x; i < nq * width; i += blockDim.x) dst[i] = base[i];
}

// acc + (x - q)^2, rounded after each operation.
__device__ __forceinline__ float add_sq(float acc, float x, float q) {
  const float a = __fsub_rn(x, q);
  return __fadd_rn(acc, __fmul_rn(a, a));
}

// acc[j] += |x - q_j|^2 over one vector row for BQ staged queries (q_s:
// BQ rows of d floats), in ascending coordinate order with no contraction
// (see the note above), with 16-byte loads where the row allows them (d a
// multiple of 4 and the row on a 16-byte boundary: a view of the vectors
// may start anywhere).
template <int BQ>
__device__ __forceinline__ void sq_dists(const float* __restrict__ xr,
                                         const float* q_s, int d,
                                         float* acc) {
  if ((d & 3) == 0 && (reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int t = 0; t < d / 4; ++t) {
      const float4 x = __ldg(x4 + t);
#pragma unroll
      for (int j = 0; j < BQ; ++j) {
        const float* q = q_s + j * d + 4 * t;
        acc[j] = add_sq(acc[j], x.x, q[0]);
        acc[j] = add_sq(acc[j], x.y, q[1]);
        acc[j] = add_sq(acc[j], x.z, q[2]);
        acc[j] = add_sq(acc[j], x.w, q[3]);
      }
    }
  } else {
    for (int t = 0; t < d; ++t) {
      const float x = __ldg(xr + t);
#pragma unroll
      for (int j = 0; j < BQ; ++j) acc[j] = add_sq(acc[j], x, q_s[j * d + t]);
    }
  }
}

// Asynchronous global -> shared copies (cp.async) for the staged kernels
// (l2_rerank.cu, pq_adc.cu).  `src_bytes` below the copy's width fills the
// rest of the destination with zeros and reads nothing past it, so a
// ragged edge is zero-padded without a branch around the copy.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Launch helper: opt in to more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace bbc
