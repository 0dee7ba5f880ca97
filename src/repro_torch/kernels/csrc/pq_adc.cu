// Batched ADC: shared (n, M) uint8 codes x per-query (B, M, K) LUTs ->
// (B, n) squared estimates.
//
// Replaces: src/repro/kernels/pq_adc.py::adc_batch_pallas.  Plain version:
// kernels/ref.py pq_adc_batch.
//
// What bounds it on an H100: device-memory bytes.  It reads n*M code bytes
// once and writes 4*B*n bytes of estimates; B*n*M fp32 adds and as many
// shared-memory lookups are cheap beside that.  At B=32, M=32 the write is
// four times the read.
//
// What the design does about it.  The B LUTs sit in shared memory (BQ
// queries per block) and are indexed by the code byte directly, not through
// the one-hot MXU matmul the Pallas kernel uses.  One thread owns one lane,
// reads its code row once per query chunk (contiguous rows, so the warp's
// reads are whole sectors through L1) and writes BQ coalesced outputs.  The
// sum runs in ascending m, as the plain version's does, so the two agree
// bit for bit.
#include "scan_common.cuh"

namespace {

template <int BQ>
__global__ void __launch_bounds__(bbc::kThreads)
pq_adc_kernel(const uint8_t* __restrict__ codes,
              const float* __restrict__ luts, float* __restrict__ out, int n,
              int M, int K, int B) {
  extern __shared__ float lut_s[];                       // BQ * M * K
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, B - q0);
  const int mk = M * K;
  bbc::stage_rows(lut_s, luts, q0, nq, mk);
  __syncthreads();
  for (int tile = blockIdx.y; tile * bbc::kThreads < n; tile += gridDim.y) {
    const int lane = tile * bbc::kThreads + threadIdx.x;
    if (lane >= n) continue;
    float acc[BQ];
#pragma unroll
    for (int j = 0; j < BQ; ++j) acc[j] = 0.f;
    const uint8_t* crow = codes + static_cast<size_t>(lane) * M;
    for (int mm = 0; mm < M; ++mm) {
      const float* l = lut_s + mm * K + crow[mm];
#pragma unroll
      for (int j = 0; j < BQ; ++j) acc[j] += l[j * mk];
    }
#pragma unroll
    for (int j = 0; j < BQ; ++j)
      if (j < nq) out[static_cast<size_t>(q0 + j) * n + lane] = acc[j];
  }
}

template <int BQ>
int launch(const uint8_t* codes, const float* luts, float* out, int n, int M,
           int K, int B, int tiles, int smem, cudaStream_t stream) {
  cudaError_t err = bbc::allow_smem(pq_adc_kernel<BQ>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + BQ - 1) / BQ, tiles);
  pq_adc_kernel<BQ><<<grid, bbc::kThreads, smem, stream>>>(codes, luts, out,
                                                           n, M, K, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pq_adc_smem_bytes(int bq, int M, int K) {
  return 4 * bq * M * K;
}

extern "C" int pq_adc_batch_launch(const uint8_t* codes, const float* luts,
                                   float* out, int n, int M, int K, int B,
                                   int bq, int tiles, int smem,
                                   cudaStream_t stream) {
  switch (bq) {
    case 8: return launch<8>(codes, luts, out, n, M, K, B, tiles, smem, stream);
    case 4: return launch<4>(codes, luts, out, n, M, K, B, tiles, smem, stream);
    case 2: return launch<2>(codes, luts, out, n, M, K, B, tiles, smem, stream);
    case 1: return launch<1>(codes, luts, out, n, M, K, B, tiles, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
