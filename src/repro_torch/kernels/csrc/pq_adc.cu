// Batched ADC: shared (n, M) uint8 codes x per-query (B, M, K) LUTs ->
// (B, n) squared estimates, summed from the m = 0 term in ascending m in
// fp32, the plain version's order, so the two agree bit for bit.
//
// Replaces: src/repro/kernels/pq_adc.py::adc_batch_pallas (B > 1) and
// adc_pallas (B = 1: the same kernel with one query a tile).  Plain
// version: kernels/ref.py pq_adc_batch.
//
// What bounds it on an H100.  By the roofline, device-memory bytes: n*M
// code bytes read once and 4*B*n bytes of estimates written (0.048 ms at
// B=32, n=1M, M=32, K=16).  Beyond that, shared memory: the B*n*M LUT
// lookups are gathers by code byte, and shared memory serves at most 32
// fp32 words per SM per clock, ~0.13 ms for 1.07e9 lookups on 132 SMs at
// 1.98 GHz: the ceiling this kernel works against.  The B*n*M fp32 adds
// (0.03 ms of issue) are cheaper.
//
// What the design does about it.  Persistent blocks (two per SM) stage
// the LUTs of a query tile in shared memory once, as
// [query][m][k] (all of B = 32 at M=32, K=16: 64 KB), then walk their row
// tiles of 256 code rows.  A tile's 256*M contiguous code bytes come
// through a 2-stage ring of 16-byte cp.async copies, so the codes are
// read from device memory once per query tile (once per call on the
// paths), coalesced, while the previous tile is summed.  A thread owns one
// row: it reads its M codes from shared memory 16 (M=32) or 8 (M=24) bytes
// at a time, and for each m computes the LUT offset m*K + code once and
// reads the TN queries' entries at the fixed stride M*K.  A warp's 32
// lanes read at most K = 16 distinct words of one (query, m) LUT row, one
// shared-memory wavefront, and their stores are 32 consecutive rows of
// one query, one 128-byte line.  The kernel is specialised on (M, K) =
// (32, 16) and (24, 16), the paths' shapes, so every offset is an
// immediate; a runtime-stride instantiation takes any other shape (the
// 8-bit K=256 regime too, with fewer queries per tile).  When a query's
// LUT leaves no room for the ring, that instantiation reads its codes
// from device memory directly.
#include "scan_common.cuh"

namespace {

constexpr int kRowsA = bbc::kThreads;   // code rows per tile: one a thread
constexpr int kStagesA = 2;              // code ring depth

__host__ __device__ inline int lut_words(int qt, int mk) {
  return (qt * mk + 3) & ~3;     // floats, rounded to 16 bytes
}

// The tiled kernel.  MS/KS: compile-time M and K, or 0 for runtime ones.
// flags: bit 0 codes staged through the ring, bit 1 16-byte code copies
// (16-byte aligned codes).
// Two blocks per SM: what the paths' 80 KB of shared memory allows, and a
// register budget (128) under which no instantiation spills.
template <int MS, int KS, int TN>
__global__ void __launch_bounds__(bbc::kThreads, 2)
pq_adc_tiled_kernel(const uint8_t* __restrict__ codes,
                    const float* __restrict__ luts, float* __restrict__ out,
                    int n, int m_rt, int k_rt, int B, int qt, int flags) {
  const int M = MS ? MS : m_rt;
  const int K = KS ? KS : k_rt;
  const int mk = M * K;
  const bool staged = flags & 1, vec = flags & 2;
  extern __shared__ uint4 smem_u4[];
  float* lut_s = reinterpret_cast<float*>(smem_u4);
  uint8_t* ring = reinterpret_cast<uint8_t*>(lut_s + lut_words(qt, mk));
  const int tile_bytes = kRowsA * M;               // a multiple of 16
  const size_t total = static_cast<size_t>(n) * M;
  const int n_tiles = (n + kRowsA - 1) / kRowsA;
  const int my_tiles = static_cast<int>(blockIdx.x) < n_tiles
      ? (n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int tid = threadIdx.x;

  auto load_codes = [&](int j) {
    const size_t base = static_cast<size_t>(blockIdx.x + j * gridDim.x)
                        * tile_bytes;
    uint8_t* dst = ring + (j & 1) * tile_bytes;
    if (vec) {
      for (int i = 16 * tid; i < tile_bytes; i += 16 * bbc::kThreads) {
        const size_t a = base + i;
        const int nb = a + 16 <= total ? 16
                       : a < total ? static_cast<int>(total - a) : 0;
        bbc::cp_async16(dst + i, nb ? codes + a : codes, nb);
      }
    } else {
      for (int i = tid; i < tile_bytes; i += bbc::kThreads) {
        const size_t a = base + i;
        dst[i] = a < total ? codes[a] : 0;
      }
    }
  };

  for (int q0 = 0; q0 < B; q0 += qt) {
    const int nq_words = min(qt, B - q0) * mk;
    const float* src = luts + static_cast<size_t>(q0) * mk;
    __syncthreads();                 // the previous query tile is summed
    for (int i = tid; i < qt * mk; i += bbc::kThreads)   // zeros past B
      bbc::cp_async4(lut_s + i, i < nq_words ? src + i : luts,
                     i < nq_words ? 4 : 0);
    if (staged && my_tiles > 0) load_codes(0);
    bbc::cp_async_commit();
    for (int j = 0; j < my_tiles; ++j) {
      if (staged && j + 1 < my_tiles) load_codes(j + 1);
      bbc::cp_async_commit();
      bbc::cp_async_wait<1>();       // the LUTs and tile j have landed
      __syncthreads();
      const int row = (blockIdx.x + j * gridDim.x) * kRowsA + tid;
      if (row < n) {
        const uint8_t* crow = staged
            ? ring + (j & 1) * tile_bytes + tid * M
            : codes + static_cast<size_t>(row) * M;
        [[maybe_unused]] uint32_t w[MS ? MS / 4 : 1];   // 4 codes a word
        if constexpr (MS == 32) {
          const uint4* c4 = reinterpret_cast<const uint4*>(crow);
          const uint4 a = c4[0], b = c4[1];
          w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
          w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
        } else if constexpr (MS == 24) {
          const uint2* c2 = reinterpret_cast<const uint2*>(crow);
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const uint2 a = c2[t];
            w[2 * t] = a.x;
            w[2 * t + 1] = a.y;
          }
        }
        for (int g = 0; g < qt; g += TN) {
          const float* lut = lut_s + g * mk;
          float acc[TN];
          if constexpr (MS != 0) {           // codes from registers
            const int c0 = w[0] & 0xff;
#pragma unroll
            for (int t = 0; t < TN; ++t) acc[t] = lut[t * mk + c0];
#pragma unroll
            for (int m = 1; m < MS; ++m) {
              const float* l =
                  lut + m * K + ((w[m >> 2] >> (8 * (m & 3))) & 0xff);
#pragma unroll
              for (int t = 0; t < TN; ++t)
                acc[t] = __fadd_rn(acc[t], l[t * mk]);
            }
          } else {                           // runtime M: code by code
            const int c0 = crow[0];
#pragma unroll
            for (int t = 0; t < TN; ++t) acc[t] = lut[t * mk + c0];
            for (int m = 1; m < M; ++m) {
              const float* l = lut + m * K + crow[m];
#pragma unroll
              for (int t = 0; t < TN; ++t)
                acc[t] = __fadd_rn(acc[t], l[t * mk]);
            }
          }
#pragma unroll
          for (int t = 0; t < TN; ++t)
            if (q0 + g + t < B)
              out[static_cast<size_t>(q0 + g + t) * n + row] = acc[t];
        }
      }
      __syncthreads();               // slot j & 1 is refilled for tile j + 2
    }
  }
}

template <int MS, int KS, int TN>
int launch_tiled(const uint8_t* codes, const float* luts, float* out, int n,
                 int M, int K, int B, int qt, int flags, int grid, int smem,
                 cudaStream_t stream) {
  auto kernel = pq_adc_tiled_kernel<MS, KS, TN>;
  cudaError_t err = bbc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, bbc::kThreads, smem, stream>>>(codes, luts, out, n, M, K, B,
                                                qt, flags);
  return static_cast<int>(cudaGetLastError());
}

template <int MS, int KS>
int launch_tn(const uint8_t* codes, const float* luts, float* out, int n,
              int M, int K, int B, int tn, int qt, int flags, int grid,
              int smem, cudaStream_t stream) {
  switch (tn) {
    case 8: return launch_tiled<MS, KS, 8>(codes, luts, out, n, M, K, B, qt,
                                           flags, grid, smem, stream);
    case 4: return launch_tiled<MS, KS, 4>(codes, luts, out, n, M, K, B, qt,
                                           flags, grid, smem, stream);
    case 2: return launch_tiled<MS, KS, 2>(codes, luts, out, n, M, K, B, qt,
                                           flags, grid, smem, stream);
    case 1: return launch_tiled<MS, KS, 1>(codes, luts, out, n, M, K, B, qt,
                                           flags, grid, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The shared memory the tiled kernel's layout needs: the query tile's LUTs
// (rounded to 16 bytes) and, when staged, the code ring.
extern "C" int pq_adc_tiled_smem_bytes(int qt, int M, int K, int staged) {
  return 4 * lut_words(qt, M * K) + (staged ? kStagesA * kRowsA * M : 0);
}

// The tiled kernel, TN queries per thread, qt per query tile, `grid`
// persistent blocks.  A shared-memory size below the layout's is refused.
extern "C" int pq_adc_batch_launch(const uint8_t* codes, const float* luts,
                                   float* out, int n, int M, int K, int B,
                                   int tn, int qt, int flags, int grid,
                                   int smem, cudaStream_t stream) {
  if (qt < 1 || qt % tn
      || smem < pq_adc_tiled_smem_bytes(qt, M, K, flags & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((flags & 1) && K == 16 && M == 32)
    return launch_tn<32, 16>(codes, luts, out, n, M, K, B, tn, qt, flags,
                             grid, smem, stream);
  if ((flags & 1) && K == 16 && M == 24)
    return launch_tn<24, 16>(codes, luts, out, n, M, K, B, tn, qt, flags,
                             grid, smem, stream);
  return launch_tn<0, 0>(codes, luts, out, n, M, K, B, tn, qt, flags, grid,
                         smem, stream);
}

// ---------------------------------------------------------------------------
// The codebook sample's ADC: per-query code rows under per-query LUTs.
//
// Replaces no TPU kernel: the JAX package sums the sample with XLA ops, one
// gather and add per sub-quantizer, and the port did the same until this
// kernel (kernels/ref.py pq_sample_adc_batch is that loop, the plain
// version).  Query b's sample lane j reads the shared stream's code row
// pos[b, j] where ok[b, j] and sums luts[b, m, code_m] from a -0.0 start
// in ascending m in fp32, one rounding an add and nothing contracted:
// -0.0 + x is x for every x, so the sum has the plain version's bits (its
// first term is the m = 0 entry itself).  Lanes off the sample are +inf.
// No (B, w, M) gather of the codes is ever made.
//
// What bounds it on an H100.  Bytes: the sampled rows' codes (w rows of M
// bytes a query, clusters shared by queries read again), the B*M*K LUT
// floats and the (B, w) estimates.  At B = 32, w ~ 2e4, M = 240 that is
// ~150 MB of code rows through L1/L2 at most, tens of microseconds; the
// ~720 launches of the loop it replaces cost milliseconds of host time.
//
// What the design does about it.  A block serves one query (blockIdx.y):
// it stages the query's M*K LUT floats in shared memory once (15 KB at
// M = 240, K = 16; read from device memory directly where a LUT exceeds a
// block's shared memory), then walks the query's lanes with a stride of
// gridDim.x * 256, one lane a thread.  A warp's 32 lanes read at most K
// distinct words of one LUT row per m: one shared-memory wavefront.  Code
// rows come in 16-byte words where M is a multiple of 16 and the codes
// start on a 16-byte boundary, else byte by byte.
namespace {

template <bool kVec>
__global__ void __launch_bounds__(bbc::kThreads)
pq_sample_adc_kernel(const uint8_t* __restrict__ codes,
                     const float* __restrict__ luts,
                     const int64_t* __restrict__ pos,
                     const uint8_t* __restrict__ ok,
                     float* __restrict__ out, int M, int K, int w,
                     int staged) {
  extern __shared__ uint4 smem_u4[];
  float* lut_s = reinterpret_cast<float*>(smem_u4);
  const int mk = M * K;
  const float* lut_g = luts + static_cast<size_t>(blockIdx.y) * mk;
  if (staged) {
    for (int i = threadIdx.x; i < mk; i += blockDim.x) lut_s[i] = lut_g[i];
    __syncthreads();
  }
  const float* lut = staged ? lut_s : lut_g;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * w;
  for (int j = blockIdx.x * bbc::kThreads + threadIdx.x; j < w;
       j += gridDim.x * bbc::kThreads) {
    float acc = INFINITY;
    if (ok[row0 + j]) {
      const uint8_t* crow = codes + pos[row0 + j] * M;
      acc = -0.0f;
      if constexpr (kVec) {
        const uint4* c4 = reinterpret_cast<const uint4*>(crow);
        for (int g = 0; g < M / 16; ++g) {
          const uint4 v = __ldg(c4 + g);
          const uint32_t word[4] = {v.x, v.y, v.z, v.w};
          const float* l = lut + 16 * g * K;
#pragma unroll
          for (int t = 0; t < 16; ++t)
            acc = __fadd_rn(
                acc, l[t * K + ((word[t >> 2] >> (8 * (t & 3))) & 0xff)]);
        }
      } else {
        for (int m = 0; m < M; ++m)
          acc = __fadd_rn(acc, lut[m * K + __ldg(crow + m)]);
      }
    }
    out[row0 + j] = acc;
  }
}

template <bool kVec>
int launch_sample(const uint8_t* codes, const float* luts, const int64_t* pos,
                  const uint8_t* ok, float* out, int M, int K, int B, int w,
                  int grid_x, int smem, cudaStream_t stream) {
  auto kernel = pq_sample_adc_kernel<kVec>;
  cudaError_t err = bbc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(grid_x, B), bbc::kThreads, smem, stream>>>(
      codes, luts, pos, ok, out, M, K, w, smem > 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The sample ADC over (B, w) lanes: `grid_x` blocks a query; `smem` 0 reads
// the LUTs from device memory, else it stages them and must hold M*K
// floats; `vec` takes 16-byte code words (M a multiple of 16, 16-byte
// aligned codes).  Anything else is refused.
extern "C" int pq_sample_adc_launch(const uint8_t* codes, const float* luts,
                                    const int64_t* pos, const uint8_t* ok,
                                    float* out, int M, int K, int B, int w,
                                    int vec, int grid_x, int smem,
                                    cudaStream_t stream) {
  if (M < 1 || K < 1 || B < 1 || B > 65535 || w < 1 || grid_x < 1
      || (vec && (M % 16 != 0
                  || reinterpret_cast<uintptr_t>(codes) % 16 != 0))
      || (smem != 0 && smem < 4 * M * K))
    return static_cast<int>(cudaErrorInvalidValue);
  return vec ? launch_sample<true>(codes, luts, pos, ok, out, M, K, B, w,
                                   grid_x, smem, stream)
             : launch_sample<false>(codes, luts, pos, ok, out, M, K, B, w,
                                    grid_x, smem, stream);
}
