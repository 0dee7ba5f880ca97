// Batched exact distances: shared (n, d) fp32 vectors x (B, d) queries ->
// (B, n) Euclidean distances, the function the Pallas kernel computes as
// sqrt(max(|x|^2 - 2 x.q + |q|^2, 0)); this kernel sums (x - q)^2
// directly, which does not cancel, in the plain version's order and
// roundings (scan_common.cuh).
//
// Replaces: src/repro/kernels/l2_rerank.py::l2_batch_pallas.  Plain
// version: kernels/ref.py l2_exact_batch.
//
// What bounds it on an H100: device-memory bytes, at the main path's
// B=32, n=1M, d=128.  It reads 4*n*d bytes and writes 4*B*n (0.19 ms at
// 3.35 TB/s); the function needs 3*B*n*d fp32 operations (subtract,
// multiply, add), 0.18 ms at 67 TFLOP/s, close behind.  Without
// contraction each coordinate issues three fp32 instructions, not a
// subtract and an FMA.
//
// What the design does about it.  The query chunk (BQ rows) sits in shared
// memory and every thread of a warp reads the same word of it (a
// broadcast).  One thread owns one lane: it reads the vector row once per
// chunk with 16-byte loads, keeps BQ sums in registers and writes BQ
// coalesced outputs.  blockIdx.x walks the query chunks fastest,
// so the chunks of one lane tile run side by side and the later ones find
// the tile in L2 rather than device memory.  A tensor-core form (the
// product in TF32 or split bf16) is later work.
#include "scan_common.cuh"

namespace {

template <int BQ>
__global__ void __launch_bounds__(bbc::kThreads)
l2_kernel(const float* __restrict__ x, const float* __restrict__ qs,
          float* __restrict__ out, int n, int d, int B) {
  extern __shared__ float q_s[];     // BQ * d
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, B - q0);
  bbc::stage_rows(q_s, qs, q0, nq, d);
  __syncthreads();
  for (int tile = blockIdx.y; tile * bbc::kThreads < n; tile += gridDim.y) {
    const int lane = tile * bbc::kThreads + threadIdx.x;
    if (lane >= n) continue;
    float sq[BQ];
#pragma unroll
    for (int j = 0; j < BQ; ++j) sq[j] = 0.f;
    bbc::sq_dists<BQ>(x + static_cast<size_t>(lane) * d, q_s, d, sq);
#pragma unroll
    for (int j = 0; j < BQ; ++j)
      if (j < nq) out[static_cast<size_t>(q0 + j) * n + lane] = sqrtf(sq[j]);
  }
}

template <int BQ>
int launch(const float* x, const float* qs, float* out, int n, int d, int B,
           int tiles, int smem, cudaStream_t stream) {
  cudaError_t err = bbc::allow_smem(l2_kernel<BQ>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + BQ - 1) / BQ, tiles);
  l2_kernel<BQ><<<grid, bbc::kThreads, smem, stream>>>(x, qs, out, n, d, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int l2_smem_bytes(int bq, int d) { return 4 * bq * d; }

extern "C" int l2_exact_batch_launch(const float* x, const float* qs,
                                     float* out, int n, int d, int B, int bq,
                                     int tiles, int smem,
                                     cudaStream_t stream) {
  switch (bq) {
    case 8: return launch<8>(x, qs, out, n, d, B, tiles, smem, stream);
    case 4: return launch<4>(x, qs, out, n, d, B, tiles, smem, stream);
    case 2: return launch<2>(x, qs, out, n, d, B, tiles, smem, stream);
    case 1: return launch<1>(x, qs, out, n, d, B, tiles, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
