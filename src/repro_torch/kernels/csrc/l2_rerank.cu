// Batched exact distances: shared (n, d) fp32 vectors x (B, d) queries ->
// (B, n) Euclidean distances, the function the Pallas kernel computes as
// sqrt(max(|x|^2 - 2 x.q + |q|^2, 0)); this kernel sums (x - q)^2
// directly, which does not cancel, in the plain version's order and
// roundings (scan_common.cuh).
//
// Replaces: src/repro/kernels/l2_rerank.py::l2_batch_pallas (B > 1) and
// l2_pallas (B = 1: the same kernel with a query tile of 8).  Plain
// version: kernels/ref.py l2_exact_batch.
//
// What bounds it on an H100.  By the roofline, device-memory bytes: at the
// main path's B=32, n=1M, d=128 it reads 4*n*d bytes and writes 4*B*n
// (0.19 ms at 3.35 TB/s).  By instruction issue, more: the numerics
// contract (ascending coordinates, __fsub_rn/__fmul_rn/__fadd_rn, no FMA)
// rules out a tensor-core product or the norm identity, so every (query,
// row, coordinate) costs three fp32 instructions.  132 SMs issue 128 fp32
// lanes a clock each, ~3.3e13 instructions/s at 1.98 GHz, so 3*B*n*d takes
// ~0.37 ms: the ceiling this kernel works against.
//
// What the design does about it.  A block owns 128 rows
// and a tile of QT = 8*TN queries (TN = 4 covers the paths' B = 32 whole;
// larger B loops over query tiles inside the block).  Rows and queries are
// staged in shared memory in chunks of 64 coordinates through a 2-stage
// cp.async ring (16-byte copies where d % 4 == 0), so every row is read
// from device memory once per call and the loads overlap the arithmetic;
// ragged rows, queries and coordinates are zero-filled by the copy, and
// add_sq(acc, 0, 0) == acc bit for bit.  Each thread keeps a 4 x TN
// register tile of sums: rows lane + 32i, queries warp + 8j.  Per four
// coordinates it issues 4 + TN 16-byte shared loads for 48*TN fp32
// instructions (8 per 192 at TN = 4), so the issue slots go to the
// arithmetic.  The row loads of a quarter warp hit eight consecutive rows
// at a padded stride of 68 floats (17 x 16 B, odd), so they are free of
// bank conflicts; the query loads are warp-wide broadcasts.  Each sum adds
// its coordinates in ascending order across chunks and stays in a register
// between them.  A warp's stores are 32 consecutive rows of one query: one
// 128-byte line each.  At B = 1 seven of the eight queries of the tile
// are zero padding: the call is bound by its bytes, not its arithmetic.
#include "scan_common.cuh"

namespace {

constexpr int kRows = 128;       // vector rows per block
constexpr int kDc = 64;          // coordinates per staged chunk
constexpr int kLd = kDc + 4;     // padded shared-memory row stride (floats)
constexpr int kStages = 2;       // cp.async ring depth

constexpr int tiled_smem_bytes(int tn) {
  return kStages * (kRows + 8 * tn) * kLd * 4;
}

// Rows [row0, row0 + ROWS) x coordinates [col0, col0 + kDc) of the
// row-major (total, d) matrix src into dst (ROWS x kLd floats), with zeros
// for rows at or past `total` and coordinates at or past d.
template <int ROWS>
__device__ __forceinline__ void stage_chunk(float* dst, const float* src,
                                            int row0, int total, int col0,
                                            int d, bool vec) {
  if (vec) {                         // d % 4 == 0, 16-byte aligned rows
    constexpr int kParts = kDc / 4;
    for (int i = threadIdx.x; i < ROWS * kParts; i += bbc::kThreads) {
      const int r = i / kParts, c = 4 * (i % kParts);
      const bool ok = row0 + r < total && col0 + c < d;
      const float* s =
          ok ? src + static_cast<size_t>(row0 + r) * d + col0 + c : src;
      bbc::cp_async16(dst + r * kLd + c, s, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * kDc; i += bbc::kThreads) {
      const int r = i / kDc, c = i % kDc;
      const bool ok = row0 + r < total && col0 + c < d;
      const float* s =
          ok ? src + static_cast<size_t>(row0 + r) * d + col0 + c : src;
      bbc::cp_async4(dst + r * kLd + c, s, ok ? 4 : 0);
    }
  }
}

template <int TN>
__global__ void __launch_bounds__(bbc::kThreads, 2)
l2_tiled_kernel(const float* __restrict__ x, const float* __restrict__ qs,
                float* __restrict__ out, int n, int d, int B, int vec) {
  constexpr int QT = 8 * TN;
  constexpr int kStage = (kRows + QT) * kLd;     // floats per ring stage
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRows;
  const int n_chunks = max(1, (d + kDc - 1) / kDc);
  const int steps = n_chunks * ((B + QT - 1) / QT);

  // step s: query tile s / n_chunks, coordinate chunk s % n_chunks
  auto load = [&](int s) {
    const int qt = s / n_chunks, col0 = (s - qt * n_chunks) * kDc;
    float* xs = sm + (s % kStages) * kStage;
    stage_chunk<kRows>(xs, x, r0, n, col0, d, vec);
    stage_chunk<QT>(xs + kRows * kLd, qs, qt * QT, B, col0, d, vec);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    bbc::cp_async_commit();
  }

  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < steps; ++s) {
    bbc::cp_async_wait<kStages - 2>();   // this thread's copies of step s
    __syncthreads();                     // everyone's; step s-1 is read
    if (s + kStages - 1 < steps) load(s + kStages - 1);
    bbc::cp_async_commit();
    const float* stage = sm + (s % kStages) * kStage;
    const float* xr = stage + lane * kLd;
    const float* qr = stage + (kRows + warp) * kLd;
#pragma unroll
    for (int c = 0; c < kDc; c += 4) {
      float4 xv[4], qv[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xr + 32 * i * kLd + c);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        qv[j] = *reinterpret_cast<const float4*>(qr + 8 * j * kLd + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float a = acc[i][j];
          a = bbc::add_sq(a, xv[i].x, qv[j].x);
          a = bbc::add_sq(a, xv[i].y, qv[j].y);
          a = bbc::add_sq(a, xv[i].z, qv[j].z);
          a = bbc::add_sq(a, xv[i].w, qv[j].w);
          acc[i][j] = a;
        }
    }
    const int qt = s / n_chunks;
    if (s - qt * n_chunks == n_chunks - 1) {     // last chunk: store, reset
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + lane + 32 * i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int q = qt * QT + warp + 8 * j;
          if (row < n && q < B)
            out[static_cast<size_t>(q) * n + row] = sqrtf(acc[i][j]);
          acc[i][j] = 0.f;
        }
      }
    }
  }
}

template <int TN>
int launch_tiled(const float* x, const float* qs, float* out, int n, int d,
                 int B, int vec, int grid, int smem, cudaStream_t stream) {
  if (smem < tiled_smem_bytes(TN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = bbc::allow_smem(l2_tiled_kernel<TN>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  l2_tiled_kernel<TN><<<grid, bbc::kThreads, smem, stream>>>(x, qs, out, n, d,
                                                            B, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// TN queries per thread (1, 2 or 4), grid = ceil(n / 128) row tiles.
// `vec` allows 16-byte copies (d % 4 == 0, aligned pointers).  A
// shared-memory size below the kernel's layout is refused.
extern "C" int l2_exact_batch_launch(const float* x, const float* qs,
                                     float* out, int n, int d, int B, int tn,
                                     int vec, int grid, int smem,
                                     cudaStream_t stream) {
  switch (tn) {
    case 4: return launch_tiled<4>(x, qs, out, n, d, B, vec, grid, smem,
                                   stream);
    case 2: return launch_tiled<2>(x, qs, out, n, d, B, vec, grid, smem,
                                   stream);
    case 1: return launch_tiled<1>(x, qs, out, n, d, B, vec, grid, smem,
                                   stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
