// The routing's lane mask: (B, n) bytes, lane j of query b set iff the
// cluster of lane j is one that query b probes (and, with a tombstone mask,
// lane j is live).
//
// Replaces no TPU kernel: the JAX package builds the mask with XLA ops
// (src/repro/index/ivf.py:159 probe_mask: a (B, C + 1) scatter of the
// probed clusters, then the gather hit[:, cluster_of] and an AND with the
// layout's validity), and the port did the same until this kernel
// (kernels/ref.py probe_mask_batch is that composition, the plain
// version).  The AND with the layout's validity is left out: a padding
// lane's cluster is n_clusters, which no query probes, so the gather
// already gives it False.
//
// What bounds it on an H100: the bytes it writes.  Its output is B * n
// bools (320 MB at B = 32 over 10M lanes), its input each lane's int64
// cluster id read once (80 MB) and each query's probe list; at 3.35 TB/s
// that is 0.12 ms.  The composition read an int64 index for each of the
// B * n (query, lane) pairs in the gather and passed over the whole mask
// once more for the AND.
//
// What the design does about it.  Each block serves a group of 32 queries
// and first builds the group's bitset in shared memory from the probe
// lists, one atomicOr a (query, probe): bit q of word c says query q of the
// group probes cluster c (C + 1 words: 16 KB at C = 4,096; word C, the
// padding's cluster, stays 0).  Then, over a persistent grid, each thread
// takes 16 consecutive lanes: it reads their cluster ids once (16-byte
// loads), looks up 16 words, clears the words of dead lanes, and transposes
// the 16 words bytewise (__byte_perm) so that byte i of word (quad, plane)
// is byte `plane` of lane 4 * quad + i's word.  Query q's 16 bytes are then
// four shifts and masks of those words, and go out as one 16-byte store
// into row q: a warp writes 512 contiguous bytes of each of the group's
// rows.  Every mask byte is written once and nothing is read twice.  Where
// n is no multiple of 16 or a pointer is unaligned, a thread takes one lane
// and writes its bytes one by one.  Where the bitset outgrows a block's
// shared memory (C >= 58,112), one memset and a small kernel build every
// group's bitset in device memory first, and the mask kernel reads it
// there.  The mask is a function of its inputs alone, so it equals the
// plain version's bit for bit.
#include "scan_common.cuh"

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kGroup = 32;      // queries a bitset word holds
constexpr int kLanes = 16;      // lanes a thread takes at a time

// Bits of the probe lists of queries b0 .. b0 + nq - 1 into `bits` (zeroed,
// C + 1 words); ids outside [0, C) set nothing.
__device__ __forceinline__ void set_bits(uint32_t* bits,
                                         const int64_t* __restrict__ probed,
                                         long long ld, int b0, int nq, int p,
                                         int C, int first, int step) {
  for (int i = first; i < nq * p; i += step) {
    const int q = i / p;
    const int64_t c = probed[static_cast<size_t>(b0 + q) * ld + (i - q * p)];
    if (c >= 0 && c < C) atomicOr(bits + c, 1u << q);
  }
}

__device__ __forceinline__ uint32_t word_of(const uint32_t* bits, int64_t c,
                                            int C) {
  return static_cast<uint64_t>(c) <= static_cast<uint64_t>(C) ? bits[c] : 0u;
}

// Every group's bitset in device memory (zeroed by the launcher): block
// (x, g) takes a share of group g's (query, probe) pairs.
__global__ void __launch_bounds__(kThreads) probe_bits_kernel(
    const int64_t* __restrict__ probed, long long ld, uint32_t* bits, int B,
    int p, int C) {
  const int g = blockIdx.y, b0 = g * kGroup;
  set_bits(bits + static_cast<size_t>(g) * (C + 1), probed, ld, b0,
           min(kGroup, B - b0), p, C, blockIdx.x * blockDim.x + threadIdx.x,
           gridDim.x * blockDim.x);
}

// Block (x, g) writes its share of group g's rows.  kShared: the bitset is
// built in shared memory, else read from `gbits`.  kVec: 16 lanes a thread
// with 16-byte loads and stores, else one lane a thread.
template <bool kShared, bool kVec>
__global__ void __launch_bounds__(kThreads, 4) probe_mask_kernel(
    const int64_t* __restrict__ cluster_of,
    const int64_t* __restrict__ probed, long long ld,
    const uint8_t* __restrict__ live, const uint32_t* __restrict__ gbits,
    uint8_t* __restrict__ out, long long n, int B, int p, int C) {
  extern __shared__ uint32_t sbits[];
  const int g = blockIdx.y, b0 = g * kGroup;
  const int nq = min(kGroup, B - b0);
  const uint32_t* bits;
  if constexpr (kShared) {
    for (int c = threadIdx.x; c <= C; c += blockDim.x) sbits[c] = 0u;
    __syncthreads();
    set_bits(sbits, probed, ld, b0, nq, p, C, threadIdx.x, blockDim.x);
    __syncthreads();
    bits = sbits;
  } else {
    bits = gbits + static_cast<size_t>(g) * (C + 1);
  }
  uint8_t* rows = out + static_cast<size_t>(b0) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (kVec) {
    const long long chunks = n / kLanes;
    for (long long t = first; t < chunks; t += stride) {
      const long long j0 = t * kLanes;
      uint32_t w[kLanes];
      const longlong2* src = reinterpret_cast<const longlong2*>(cluster_of
                                                                + j0);
#pragma unroll
      for (int i = 0; i < kLanes / 2; ++i) {
        const longlong2 c = __ldg(src + i);
        w[2 * i] = word_of(bits, c.x, C);
        w[2 * i + 1] = word_of(bits, c.y, C);
      }
      if (live) {
        const uint4 l = __ldg(reinterpret_cast<const uint4*>(live + j0));
        const uint32_t lw[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
        for (int i = 0; i < kLanes; ++i)
          if (((lw[i >> 2] >> (8 * (i & 3))) & 0xffu) == 0u) w[i] = 0u;
      }
      // x[k][s]: byte i is byte s of lane 4k + i's word
      uint32_t x[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t a = w[4 * k], b = w[4 * k + 1];
        const uint32_t c = w[4 * k + 2], d = w[4 * k + 3];
        const uint32_t ab0 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
        const uint32_t ab1 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
        const uint32_t cd0 = __byte_perm(c, d, 0x5140);
        const uint32_t cd1 = __byte_perm(c, d, 0x7362);
        x[k][0] = __byte_perm(ab0, cd0, 0x5410);         // a0 b0 c0 d0
        x[k][1] = __byte_perm(ab0, cd0, 0x7632);         // a1 b1 c1 d1
        x[k][2] = __byte_perm(ab1, cd1, 0x5410);
        x[k][3] = __byte_perm(ab1, cd1, 0x7632);
      }
      uint8_t* dst = rows + j0;
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (q < nq) {
          const int s = q >> 3, r = q & 7;
          uint4 o;
          o.x = (x[0][s] >> r) & 0x01010101u;
          o.y = (x[1][s] >> r) & 0x01010101u;
          o.z = (x[2][s] >> r) & 0x01010101u;
          o.w = (x[3][s] >> r) & 0x01010101u;
          *reinterpret_cast<uint4*>(dst + static_cast<size_t>(q) * n) = o;
        }
      }
    }
  } else {
    for (long long j = first; j < n; j += stride) {
      uint32_t w = word_of(bits, cluster_of[j], C);
      if (live && !live[j]) w = 0u;
      for (int q = 0; q < nq; ++q)
        rows[static_cast<size_t>(q) * n + j] =
            static_cast<uint8_t>((w >> q) & 1u);
    }
  }
}

template <bool kShared, bool kVec>
cudaError_t launch(dim3 grid, int smem, cudaStream_t stream,
                   const int64_t* cluster_of, const int64_t* probed,
                   long long ld, const uint8_t* live, const uint32_t* gbits,
                   uint8_t* out, long long n, int B, int p, int C) {
  auto kernel = probe_mask_kernel<kShared, kVec>;
  cudaError_t err = bbc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(cluster_of, probed, ld, live,
                                           gbits, out, n, B, p, C);
  return cudaGetLastError();
}

}  // namespace

// The (B, n) lane mask of `cluster_of` (n int64, values in [0, C]) under
// the probe lists `probed` (B rows of p int64 at row stride ld), ANDed with
// `live` (n bytes) where it is not null, into `out` (B x n bytes).  `grid_x`
// blocks a group of 32 queries.  `scratch` null: each block builds its
// group's bitset in `smem` >= 4 (C + 1) bytes of shared memory; else
// `scratch` holds ceil(B / 32) (C + 1) words, which the call zeroes and
// fills first.  `vec` asks for 16-byte lanes (n % 16 == 0 and 16-byte
// aligned cluster_of, live and out).  Anything else is refused.
extern "C" int probe_mask_launch(
    const int64_t* cluster_of, const int64_t* probed, long long ld,
    const uint8_t* live, uint8_t* out, uint32_t* scratch, long long n, int B,
    int p, int C, int vec, int grid_x, int smem, cudaStream_t stream) {
  const int groups = (B + kGroup - 1) / kGroup;
  const bool shared = scratch == nullptr;
  if (B < 1 || n < 1 || p < 0 || C < 0 || ld < p || grid_x < 1
      || groups > 65535 || (shared && smem < 4LL * (C + 1))
      || (!shared && smem != 0)
      || (vec && (n % kLanes != 0
                  || reinterpret_cast<uintptr_t>(cluster_of) % 16 != 0
                  || reinterpret_cast<uintptr_t>(out) % 16 != 0
                  || reinterpret_cast<uintptr_t>(live) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, groups);
  if (!shared) {
    cudaError_t err = cudaMemsetAsync(
        scratch, 0, sizeof(uint32_t) * groups * (static_cast<size_t>(C) + 1),
        stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int bx = max(1, min(64, (kGroup * p + kThreads - 1) / kThreads));
    probe_bits_kernel<<<dim3(bx, groups), kThreads, 0, stream>>>(
        probed, ld, scratch, B, p, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err;
  if (shared)
    err = vec ? launch<true, true>(grid, smem, stream, cluster_of, probed, ld,
                                   live, nullptr, out, n, B, p, C)
              : launch<true, false>(grid, smem, stream, cluster_of, probed,
                                    ld, live, nullptr, out, n, B, p, C);
  else
    err = vec ? launch<false, true>(grid, 0, stream, cluster_of, probed, ld,
                                    live, scratch, out, n, B, p, C)
              : launch<false, false>(grid, 0, stream, cluster_of, probed, ld,
                                     live, scratch, out, n, B, p, C);
  return static_cast<int>(err);
}
