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
// What bounds it on an H100: device-memory bytes.  Per valid lane it
// reads the d-byte code row and 8 bytes of factors; per lane the validity
// byte, and it writes 12 bytes; the tiles' v rows are T * d * 4 bytes
// more.  The arithmetic is d adds and ~20 operations per valid lane, far
// below the bytes' time.  At the single-query path's shapes (T = 64, cap
// 4,096, d = 128, ~61K valid lanes) that is ~12 MB, ~3.5 us at 3.35 TB/s:
// a launch of a few microseconds' work, so one launch per query covers
// every probed tile (a per-tile launch would be 64 launches of ~4K lanes,
// pure launch overhead).
//
// What the design does about it.  One thread owns one lane; a block owns
// a chunk of blockDim.x lanes (128 where their rows fit shared memory) of
// one tile, and each warp its 32 lanes, whose code rows are contiguous in
// memory.  The grid runs the tiles fastest (blockIdx.x = tile, blockIdx.y
// = chunk), so the first chunks of every tile, which hold its valid lanes
// (the member table pads each tile at its end), are the first blocks
// scheduled: at the single-query path's shapes they all fit the first
// wave, and the padding chunks behind them are short.  (Tile-major, the
// first wave held whole tiles, padding included, and the later tiles'
// valid chunks waited for a second wave.)
//   1. Each warp finds its last valid lane (a ballot).  About three
//      quarters of the warps at the single-query path's shapes hold
//      padding only: such a warp writes its +inf with 16-byte stores and
//      reads no row.
//   2. Otherwise the warp brings its rows up to its last valid lane, and
//      the tile's v row, into its own shared memory by coalesced 16-byte
//      cp.async (byte copies where d % 16 or the bases forbid them), while
//      the lanes' factors load; no block-wide barrier.  A row takes
//      row_stride(d) bytes, an odd number of 16-byte words, so the 8
//      threads of a quarter-warp reading word w of their own rows hit 8
//      distinct bank groups: no conflicts.  (The first port read each row
//      straight from device memory, eight 16-byte loads a thread, so each
//      warp-wide load touched 32 lines 128 bytes apart.)
//   3. Each valid lane adds s1 from its row in shared memory, in ascending
//      j, and writes est, lb and ub; lanes off ``valid`` write +inf.  Each
//      code becomes an exact float by a byte permute and one add
//      (code_value), not the conversion unit's quarter-rate I2F, and v
//      comes in 16-byte shared loads.
// The ragged edges in cap and d are masked in the kernel, not padded.
#include "scan_common.cuh"

namespace {

// max(x, 0) that lets NaN through, as torch.clamp(min=0) does.
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float bound_dist(float base, float scale,
                                            float t) {
  return __fsqrt_rn(clamp0(__fsub_rn(base, __fmul_rn(scale, t))));
}

// The int8 code in byte u of ``q`` (a word of codes XOR 0x80808080, so
// byte u is code + 128) as an exact float, without the conversion unit:
// the bits 0x4B0000bb are the float 2^23 + bb, and 2^23 + 128 off it
// leaves the code exactly (both within 2^23 + [0, 255]).
__device__ __forceinline__ float code_value(unsigned q, int u) {
  return __fsub_rn(__uint_as_float(__byte_perm(q, 0x4B000000u, 0x7650u | u)),
                   8388736.f);
}

// Bytes between two code rows in shared memory: d rounded up to 16, plus
// 16 where that is an even number of 16-byte words.
__host__ __device__ inline int row_stride(int d) {
  const int s = (d + 15) & ~15;
  return ((s >> 4) & 1) ? s : s + 16;
}

__host__ __device__ inline int v_bytes(int d) { return (4 * d + 15) & ~15; }

// Shared memory of one warp: its copy of v, then its 32 code rows.
__host__ __device__ inline int warp_bytes(int d) {
  return v_bytes(d) + 32 * row_stride(d);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int l = threadIdx.x & 31;
  const int lane0 = blockIdx.y * blockDim.x + (threadIdx.x & ~31);
  const int lane = lane0 + l;
  const size_t base = static_cast<size_t>(t) * cap + lane0;  // the warp's
  const size_t o = base + l;
  const bool in = lane < cap;
  const bool ok = in && __ldg(valid + o);
  const float inf = __int_as_float(0x7f800000);

  // 1. the warp's rows up to its last valid lane
  const unsigned ballot = __ballot_sync(0xffffffffu, ok);
  if (ballot == 0) {                     // padding only
    if (lane0 + 32 <= cap && (base & 3) == 0 && aligned16(est) &&
        aligned16(lb) && aligned16(ub)) {
      if (l < 24) {
        float* out = l < 8 ? est : (l < 16 ? lb : ub);
        reinterpret_cast<float4*>(out + base)[l & 7] =
            make_float4(inf, inf, inf, inf);
      }
    } else if (in) {
      est[o] = inf;
      lb[o] = inf;
      ub[o] = inf;
    }
    return;
  }
  const int nrows = 32 - __clz(ballot);

  // 2. the rows and v into the warp's shared memory, the factors meanwhile
  const int stride = row_stride(d);
  unsigned char* warp_s = smem + (threadIdx.x >> 5) * warp_bytes(d);
  float* v_s = reinterpret_cast<float*>(warp_s);           // d
  unsigned char* rows_s = warp_s + v_bytes(d);             // 32 x stride
  const int8_t* src = codes + base * d;
  const float* vt = v + static_cast<size_t>(t) * d;
  const bool vec16 = (d & 15) == 0 && aligned16(codes) && aligned16(v);
  if (vec16) {
    const int words = d >> 4;
    for (int k = l; k < nrows * words; k += 32) {
      const int r = k / words;
      bbc::cp_async16(rows_s + r * stride + 16 * (k - r * words),
                      src + 16 * static_cast<size_t>(k), 16);
    }
    for (int k = l; k < d / 4; k += 32)
      bbc::cp_async16(v_s + 4 * k, vt + 4 * k, 16);
    bbc::cp_async_commit();
  } else {
    for (int k = l; k < nrows * d; k += 32) {
      const int r = k / d;
      rows_s[r * stride + (k - r * d)] = static_cast<unsigned char>(src[k]);
    }
    for (int k = l; k < d; k += 32) v_s[k] = __ldg(vt + k);
  }
  const float nq = __ldg(norm_q + t);
  const float no = ok ? __ldg(norm_o + o) : 0.f;
  const float fo = ok ? __ldg(f_o + o) : 1.f;
  if (vec16) bbc::cp_async_wait<0>();
  __syncwarp();
  if (!in) return;
  if (!ok) {
    est[o] = inf;
    lb[o] = inf;
    ub[o] = inf;
    return;
  }

  // 3. s1 in ascending j from the lane's row, then the bounds
  const unsigned char* crow = rows_s + l * stride;
  float s1 = 0.f;
  if (vec16) {
    const float4* v4 = reinterpret_cast<const float4*>(v_s);
    for (int w = 0; w < d / 16; ++w) {
      const uint4 word = *reinterpret_cast<const uint4*>(crow + 16 * w);
      const unsigned q[4] = {word.x ^ 0x80808080u, word.y ^ 0x80808080u,
                             word.z ^ 0x80808080u, word.w ^ 0x80808080u};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float4 vv = v4[4 * w + h];
        const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          s1 = __fadd_rn(s1, __fmul_rn(code_value(q[h], u), vj[u]));
      }
    }
  } else {
    for (int j = 0; j < d; ++j)
      s1 = __fadd_rn(s1, __fmul_rn(static_cast<float>(
                                       static_cast<int8_t>(crow[j])),
                                   v_s[j]));
  }
  const float ip = __fdiv_rn(__fdiv_rn(s1, sqrt_d), fo);
  const float ff = __fmul_rn(fo, fo);
  const float err = __fmul_rn(eps0, __fsqrt_rn(__fdiv_rn(
      __fsub_rn(1.f, ff), __fmul_rn(ff, dm1))));
  const float scale = __fmul_rn(__fmul_rn(2.f, nq), no);
  const float base2 = __fadd_rn(__fmul_rn(nq, nq), __fmul_rn(no, no));
  est[o] = bound_dist(base2, scale, ip);
  lb[o] = bound_dist(base2, scale, __fadd_rn(ip, err));
  ub[o] = bound_dist(base2, scale, __fsub_rn(ip, err));
}

}  // namespace

// Shared memory of a block of `lanes` lanes: each warp's v and rows.
extern "C" int rabitq_est_smem_bytes(int d, int lanes) {
  return lanes / 32 * warp_bytes(d);
}

// One block per (tile, chunk of `lanes` lanes, a multiple of 32): grid
// (T, ceil(cap / lanes)), the tiles fastest.  Returns the CUDA error code of the launch
// (0 on success).
extern "C" int rabitq_est_launch(const int8_t* codes, const float* norm_o,
                                 const float* f_o, const float* v,
                                 const float* norm_q, const uint8_t* valid,
                                 float* est, float* lb, float* ub, int T,
                                 int cap, int d, float sqrt_d, float eps0,
                                 float dm1, int lanes, int smem,
                                 cudaStream_t stream) {
  if (lanes <= 0 || lanes > bbc::kThreads || lanes % 32 != 0 ||
      smem < rabitq_est_smem_bytes(d, lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = bbc::allow_smem(rabitq_est_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(T, (cap + lanes - 1) / lanes);
  rabitq_est_kernel<<<grid, lanes, smem, stream>>>(
      codes, norm_o, f_o, v, norm_q, valid, est, lb, ub, cap, d, sqrt_d, eps0,
      dm1);
  return static_cast<int>(cudaGetLastError());
}
