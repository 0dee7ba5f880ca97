// RaBitQ bounded estimator for one query over T probed cluster tiles at
// once: est, lb and ub of every member lane of every tile.
//
// Replaces: src/repro/kernels/rabitq_est.py::rabitq_est_pallas.  Plain
// version: kernels/ref.py rabitq_est_tiles (the JAX-signature form,
// ref.rabitq_est, is its T = 1 case).
//
// Per tile t and lane i (codes (T, cap, d) int8 +-1; norm_o, f_o, valid
// (T, cap); v (T, d) the tile's rotated unit query residual; norm_q (T,)):
//   s1 = sum_j code[t,i,j] v[t,j]              (ascending j, from 0)
//   ip = (s1 / sqrt(d)) / f_o
//   err = eps0 sqrt((1 - f_o^2) / (f_o^2 (d - 1)))
//   scale = (2 nq) norm_o,  base = nq^2 + norm_o^2
//   est, lb, ub = sqrt(max(base - scale (ip, ip + err, ip - err), 0))
// and +inf on lanes off ``valid`` (padding lanes of the member table; their
// f_o is read from a clamped id and never divided by).
//
// Numerics.  Every operation is an explicit __f*_rn intrinsic in the plain
// version's order (no contraction of base - scale * t into an FMA, IEEE
// division and square root), and s1 adds the exact +-v[j] terms in
// ascending j: est, lb and ub equal the plain version's bitwise.
//
// What bounds it on an H100: device-memory bytes.  Per lane it reads the
// d-byte code row, 8 bytes of factors and the validity byte, and writes
// 12 bytes; the tiles' v rows are T * d * 4 bytes more.  The arithmetic is
// d adds and ~20 operations per lane, far below the bytes' time.  At the
// single-query path's shapes (T = 64, cap ~ 4K, d = 128) that is ~40 MB,
// ~12 us at 3.35 TB/s: a launch of a few microseconds' work, so one launch
// per query covers every probed tile (a per-tile launch would be 64
// launches of ~4K lanes, pure launch overhead).
//
// What the design does about it.  One thread owns one lane; a block's
// lanes lie in one tile (blockIdx.y), whose v row is staged in shared
// memory and read as a broadcast.  The code row is read with 16-byte loads
// where d and the base allow it (d % 16 == 0), byte loads otherwise; the
// ragged edges in cap and d are masked in the kernel, not padded.  Lanes
// off ``valid`` write +inf without reading their row.
#include "scan_common.cuh"

namespace {

// max(x, 0) that lets NaN through, as torch.clamp(min=0) does.
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float bound_dist(float base, float scale,
                                            float t) {
  return __fsqrt_rn(clamp0(__fsub_rn(base, __fmul_rn(scale, t))));
}

__global__ void __launch_bounds__(bbc::kThreads)
rabitq_est_kernel(const int8_t* __restrict__ codes,
                  const float* __restrict__ norm_o,
                  const float* __restrict__ f_o,
                  const float* __restrict__ v,
                  const float* __restrict__ norm_q,
                  const uint8_t* __restrict__ valid,
                  float* __restrict__ est, float* __restrict__ lb,
                  float* __restrict__ ub, int cap, int d, float sqrt_d,
                  float eps0, float dm1) {
  extern __shared__ float v_s[];     // d
  const int t = blockIdx.y;
  bbc::stage_rows(v_s, v, t, 1, d);
  __syncthreads();
  const float nq = norm_q[t];
  const float inf = __int_as_float(0x7f800000);
  const bool vec16 = (d & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  for (int tile = blockIdx.x; tile * bbc::kThreads < cap;
       tile += gridDim.x) {
    const int lane = tile * bbc::kThreads + threadIdx.x;
    if (lane >= cap) continue;
    const size_t o = static_cast<size_t>(t) * cap + lane;
    if (!valid[o]) {
      est[o] = inf;
      lb[o] = inf;
      ub[o] = inf;
      continue;
    }
    const int8_t* crow = codes + o * d;
    float s1 = 0.f;
    if (vec16) {
      const int4* c16 = reinterpret_cast<const int4*>(crow);
      for (int w = 0; w < d / 16; ++w) {
        const int4 word = __ldg(c16 + w);
        const int8_t* cb = reinterpret_cast<const int8_t*>(&word);
#pragma unroll
        for (int u = 0; u < 16; ++u)
          s1 = __fadd_rn(s1, __fmul_rn(static_cast<float>(cb[u]),
                                       v_s[16 * w + u]));
      }
    } else {
      for (int j = 0; j < d; ++j)
        s1 = __fadd_rn(s1, __fmul_rn(static_cast<float>(__ldg(crow + j)),
                                     v_s[j]));
    }
    const float no = __ldg(norm_o + o);
    const float fo = __ldg(f_o + o);
    const float ip = __fdiv_rn(__fdiv_rn(s1, sqrt_d), fo);
    const float ff = __fmul_rn(fo, fo);
    const float err = __fmul_rn(eps0, __fsqrt_rn(__fdiv_rn(
        __fsub_rn(1.f, ff), __fmul_rn(ff, dm1))));
    const float scale = __fmul_rn(__fmul_rn(2.f, nq), no);
    const float base = __fadd_rn(__fmul_rn(nq, nq), __fmul_rn(no, no));
    est[o] = bound_dist(base, scale, ip);
    lb[o] = bound_dist(base, scale, __fadd_rn(ip, err));
    ub[o] = bound_dist(base, scale, __fsub_rn(ip, err));
  }
}

}  // namespace

extern "C" int rabitq_est_smem_bytes(int d) { return 4 * d; }

// Returns the CUDA error code of the launch (0 on success).
extern "C" int rabitq_est_launch(const int8_t* codes, const float* norm_o,
                                 const float* f_o, const float* v,
                                 const float* norm_q, const uint8_t* valid,
                                 float* est, float* lb, float* ub, int T,
                                 int cap, int d, float sqrt_d, float eps0,
                                 float dm1, int tiles, int smem,
                                 cudaStream_t stream) {
  cudaError_t err = bbc::allow_smem(rabitq_est_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles, T);
  rabitq_est_kernel<<<grid, bbc::kThreads, smem, stream>>>(
      codes, norm_o, f_o, v, norm_q, valid, est, lb, ub, cap, d, sqrt_d, eps0,
      dm1);
  return static_cast<int>(cudaGetLastError());
}
