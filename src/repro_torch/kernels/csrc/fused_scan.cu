// Batched fused scan: ADC estimate + Eq. 6 bucket + (B, m+1) histogram +
// inline exact distance of the predicted lanes + miss count, in one pass
// over the shared candidate stream.
//
// Replaces: src/repro/kernels/fused_scan.py::fused_scan_batch_pallas (and
// its helper bucketize_hist_tile).  Plain version: kernels/ref.py
// fused_scan_batch.
//
// What bounds it on an H100: device-memory bytes.  Per batch it reads the
// uint8 code rows of the lanes some query probes, the fp32 vector rows of
// the lanes some query predicts, the (B, n) validity mask, and writes three
// (B, n) 4-byte outputs; the ADC adds and the exact leg's subtract,
// multiply and add per coordinate come to far less time than the bytes at
// 3.35 TB/s.  The exact leg is the direct sum of (x - q)^2 in the plain
// version's order (see scan_common.cuh).
//
// What the design does about it.
//  * The per-query ADC tables and ew_maps sit in shared memory and are
//    indexed directly (the Pallas kernel's one-hot MXU matmuls are a TPU
//    stand-in for exactly this gather).  Neighbouring threads read
//    neighbouring LUT words: no bank conflicts.
//  * One thread owns one lane and reads that lane's code row and (only if a
//    query predicts it) its vector row once for the BQ queries of its block.
//    Rows are contiguous, so a warp's row reads cover contiguous memory and
//    each 32-byte sector is used whole through L1.
//  * blockIdx.x walks the query chunks fastest, so the chunks of one lane
//    tile run side by side and the later ones read the tile from L2.
//  * Lanes no query probes are written as (+inf, m, +inf) without reading
//    their codes or vectors; that is what the Pallas kernel yields for them.
//  * The histogram and the miss counts are per-block shared-memory atomics
//    folded into zeroed globals with one atomicAdd per nonzero bin: CUDA
//    blocks run concurrently, unlike the TPU grid the Pallas kernel's
//    accumulate-at-program_id-0 relies on.
#include "scan_common.cuh"

namespace {

template <int BQ>
__global__ void __launch_bounds__(bbc::kThreads)
fused_scan_kernel(const uint8_t* __restrict__ codes,
                  const float* __restrict__ vectors,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ luts,
                  const float* __restrict__ qs,
                  const float* __restrict__ d_min,
                  const float* __restrict__ delta,
                  const int* __restrict__ ew_maps,
                  const int* __restrict__ tau_pred,
                  float* __restrict__ est, int* __restrict__ bucket,
                  float* __restrict__ early, int* __restrict__ hist,
                  int* __restrict__ nmiss, int n, int M, int K, int d, int B,
                  int n_ew, int m) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, B - q0);
  const int m1 = m + 1;
  const int mk = M * K;
  float* lut_s = smem;                                   // BQ * M * K
  float* q_s = lut_s + BQ * mk;                          // BQ * d
  float* par_s = q_s + BQ * d;                           // BQ * 2
  int* ew_s = reinterpret_cast<int*>(par_s + 2 * BQ);    // BQ * n_ew
  int* hist_s = ew_s + BQ * n_ew;                        // BQ * m1
  int* tau_s = hist_s + BQ * m1;                         // BQ
  int* miss_s = tau_s + BQ;                              // BQ

  bbc::stage_rows(lut_s, luts, q0, nq, mk);
  bbc::stage_rows(q_s, qs, q0, nq, d);
  bbc::stage_rows(ew_s, ew_maps, q0, nq, n_ew);
  for (int i = threadIdx.x; i < BQ * m1; i += blockDim.x) hist_s[i] = 0;
  if (threadIdx.x < BQ) {
    const int j = threadIdx.x;
    const bool live = j < nq;
    par_s[2 * j] = live ? d_min[q0 + j] : 0.f;
    par_s[2 * j + 1] = live ? delta[q0 + j] : 1.f;
    tau_s[j] = live ? tau_pred[q0 + j] : -1;
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
      v[j] = j < nq && valid[static_cast<size_t>(q0 + j) * n + lane];
      any_v |= v[j];
    }
    float acc[BQ];
#pragma unroll
    for (int j = 0; j < BQ; ++j) acc[j] = 0.f;
    if (any_v) {
      const uint8_t* crow = codes + static_cast<size_t>(lane) * M;
      for (int mm = 0; mm < M; ++mm) {
        const float* l = lut_s + mm * K + crow[mm];
#pragma unroll
        for (int j = 0; j < BQ; ++j) acc[j] += l[j * mk];
      }
    }
    bool p[BQ];
    bool any_p = false;
#pragma unroll
    for (int j = 0; j < BQ; ++j) {
      p[j] = false;
      if (j >= nq) continue;
      const size_t o = static_cast<size_t>(q0 + j) * n + lane;
      float e = inf;
      int b = m;
      if (v[j]) {
        e = sqrtf(fmaxf(acc[j], 0.f));
        b = bbc::bucket_of(e, par_s[2 * j], par_s[2 * j + 1],
                           ew_s + j * n_ew, n_ew, m);
        atomicAdd(&hist_s[j * m1 + b], 1);
        p[j] = b <= tau_s[j];
        if (!p[j]) atomicAdd(&miss_s[j], 1);
      }
      est[o] = e;
      bucket[o] = b;
      any_p |= p[j];
    }
    float sq[BQ];
#pragma unroll
    for (int j = 0; j < BQ; ++j) sq[j] = 0.f;
    if (any_p)
      bbc::sq_dists<BQ>(vectors + static_cast<size_t>(lane) * d, q_s, d, sq);
#pragma unroll
    for (int j = 0; j < BQ; ++j) {
      if (j >= nq) continue;
      early[static_cast<size_t>(q0 + j) * n + lane] =
          p[j] ? sqrtf(sq[j]) : inf;
    }
  }
  __syncthreads();
  bbc::flush_hist(hist_s, hist, q0, nq, m1);
  if (threadIdx.x < nq && miss_s[threadIdx.x])
    atomicAdd(&nmiss[q0 + threadIdx.x], miss_s[threadIdx.x]);
}

template <int BQ>
int launch(const uint8_t* codes, const float* vectors, const uint8_t* valid,
           const float* luts, const float* qs, const float* d_min,
           const float* delta, const int* ew_maps, const int* tau_pred,
           float* est, int* bucket, float* early, int* hist, int* nmiss,
           int n, int M, int K, int d, int B, int n_ew, int m, int tiles,
           int smem, cudaStream_t stream) {
  cudaError_t err = bbc::allow_smem(fused_scan_kernel<BQ>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + BQ - 1) / BQ, tiles);
  fused_scan_kernel<BQ><<<grid, bbc::kThreads, smem, stream>>>(
      codes, vectors, valid, luts, qs, d_min, delta, ew_maps, tau_pred, est,
      bucket, early, hist, nmiss, n, M, K, d, B, n_ew, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block needs for a chunk of bq queries.
extern "C" int fused_scan_smem_bytes(int bq, int M, int K, int d, int n_ew,
                                     int m) {
  return 4 * bq * (M * K + d + 2 + n_ew + (m + 1) + 2);
}

// Outputs hist (B, m+1) and nmiss (B,) must arrive zeroed.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int fused_scan_batch_launch(
    const uint8_t* codes, const float* vectors, const uint8_t* valid,
    const float* luts, const float* qs, const float* d_min,
    const float* delta, const int* ew_maps, const int* tau_pred, float* est,
    int* bucket, float* early, int* hist, int* nmiss, int n, int M, int K,
    int d, int B, int n_ew, int m, int bq, int tiles, int smem,
    cudaStream_t stream) {
  switch (bq) {
    case 8: return launch<8>(codes, vectors, valid, luts, qs, d_min, delta,
                             ew_maps, tau_pred, est, bucket, early, hist,
                             nmiss, n, M, K, d, B, n_ew, m, tiles, smem,
                             stream);
    case 4: return launch<4>(codes, vectors, valid, luts, qs, d_min, delta,
                             ew_maps, tau_pred, est, bucket, early, hist,
                             nmiss, n, M, K, d, B, n_ew, m, tiles, smem,
                             stream);
    case 2: return launch<2>(codes, vectors, valid, luts, qs, d_min, delta,
                             ew_maps, tau_pred, est, bucket, early, hist,
                             nmiss, n, M, K, d, B, n_ew, m, tiles, smem,
                             stream);
    case 1: return launch<1>(codes, vectors, valid, luts, qs, d_min, delta,
                             ew_maps, tau_pred, est, bucket, early, hist,
                             nmiss, n, M, K, d, B, n_ew, m, tiles, smem,
                             stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
