// Batched Eq. 6 bucketize + (B, m+1) histogram of the valid lanes.
//
// Replaces: src/repro/kernels/bucket_hist.py::bucket_hist_batch_pallas.
// Plain version: kernels/ref.py bucket_hist_batch.
//
// What bounds it on an H100: device-memory bytes: it reads the (B, n) fp32
// distances and the (B, n) validity bytes and writes (B, n) int32 bucket
// ids, with a handful of operations per lane.
//
// What the design does about it.  One block owns one query row and a
// strided set of lane tiles; the query's ew_map and histogram sit in shared
// memory, the map indexed directly (no one-hot matmul) and the histogram
// counted with shared atomics, then added into the zeroed global histogram
// once per nonzero bin.  Reads and writes are one coalesced word per
// thread.  The Pallas kernel's in-order grid accumulation (its comment at
// bucket_hist.py:10-12) is exactly what CUDA's concurrent blocks forbid.
#include "scan_common.cuh"

namespace {

__global__ void __launch_bounds__(bbc::kThreads)
bucket_hist_kernel(const float* __restrict__ dists,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ d_min,
                   const float* __restrict__ delta,
                   const int* __restrict__ ew_maps, int* __restrict__ bucket,
                   int* __restrict__ hist, int n, int n_ew, int m) {
  extern __shared__ int ismem[];
  int* ew_s = ismem;                 // n_ew
  int* hist_s = ew_s + n_ew;         // m + 1
  const int q = blockIdx.x;
  const int m1 = m + 1;
  bbc::stage_rows(ew_s, ew_maps, q, 1, n_ew);
  for (int i = threadIdx.x; i < m1; i += blockDim.x) hist_s[i] = 0;
  __syncthreads();
  const float dm = d_min[q];
  const float dl = delta[q];
  const size_t row = static_cast<size_t>(q) * n;
  for (int tile = blockIdx.y; tile * bbc::kThreads < n; tile += gridDim.y) {
    const int lane = tile * bbc::kThreads + threadIdx.x;
    if (lane >= n) continue;
    const int b = bbc::bucket_of(dists[row + lane], dm, dl, ew_s, n_ew, m);
    bucket[row + lane] = b;
    if (valid[row + lane]) atomicAdd(&hist_s[b], 1);
  }
  __syncthreads();
  bbc::flush_hist(hist_s, hist, q, 1, m1);
}

}  // namespace

extern "C" int bucket_hist_smem_bytes(int n_ew, int m) {
  return 4 * (n_ew + m + 1);
}

// hist (B, m+1) must arrive zeroed.
extern "C" int bucket_hist_batch_launch(const float* dists,
                                        const uint8_t* valid,
                                        const float* d_min,
                                        const float* delta,
                                        const int* ew_maps, int* bucket,
                                        int* hist, int n, int B, int n_ew,
                                        int m, int tiles, int smem,
                                        cudaStream_t stream) {
  cudaError_t err = bbc::allow_smem(bucket_hist_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, tiles);
  bucket_hist_kernel<<<grid, bbc::kThreads, smem, stream>>>(
      dists, valid, d_min, delta, ew_maps, bucket, hist, n, n_ew, m);
  return static_cast<int>(cudaGetLastError());
}
