// Three kernels of exact distances.  `l2_exact_batch` (below) gives every
// (query, row) pair of shared rows; `l2_gather_rows` (the second part of
// this file) gives the masked (query, slot) entries of per-query id rows,
// the re-rank's second pass; `l2_exact_masked` (the last part) gives the
// masked (query, row) pairs of shared rows with `l2_exact_batch`'s bits,
// RaBitQ's straggler pass.
//
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

// ---------------------------------------------------------------------------
// The second pass: (N, d) fp32 vectors, per-query id rows `ids` (B, w)
// int64 (any value off the mask), (B, d) queries and a (B, w)
// mask -> (B, w) exact distances of the rows ids[b, s] to query b on the
// mask, +inf off it.  Only the set entries' rows are read, once each, and
// nothing else is written but the (B, w) output.
//
// Replaces: the gather and PyTorch passes of kernels/ref.py l2_gather_rows
// (no TPU kernel: the JAX package gathers the rows in XLA).
//
// Numerics.  The plain version adds the squares by numerics.ordered_sum:
// the first half of the row's squares added to the second, elementwise, an
// odd last column carried into the next round, until one is left; then
// the IEEE root.  This kernel adds them in that order with __fsub_rn,
// __fmul_rn and __fadd_rn (no FMA), and takes __fsqrt_rn: the plain
// version's bits, on the card and on the CPU.
//
// What bounds it on an H100.  Device-memory bytes: each set entry's row is
// read once (3,840 B at d = 960; ~35,000 of 40,000 slots set a query on
// PQ's second pass), 1.12M rows and 4.3 GB a call at the d960 cell's B =
// 32, ~1.3 ms at 3.35 TB/s.  Rows that several queries share may come from
// L2.  A sparse mask (RaBitQ's stragglers: a few thousand of ~1M slots)
// costs the mask's bytes and the +inf writes.
//
// What the design does about it.  A block takes one query and a tile of
// kGatherTile slots: it stages the query in shared memory, writes +inf on
// the tile's unset slots and compacts the set ones into a shared list
// (a warp ballot, one shared atomic a warp).  Then groups of G lanes (G =
// 8, 16 or 32: the fewest that take the first round's pairs at kPairs a
// lane; 32 / G rows a warp in flight at once, four at d = 128) take the
// listed entries in turn.  A group issues all of its loads of the first
// round, up to kPairs 16-byte pairs (x[i..i+3], x[h+i..h+i+3]) a lane,
// before any arithmetic, so a warp keeps up to 4 KB of rows in flight
// (2 KB at d = 128), and writes the round's d/2 sums to its own shared
// buffer; the rounds above G values go through that buffer with
// __syncwarp, the last log2(G) by shuffles within the group.  Rows off
// 16-byte alignment or with d % 8 != 0 load 4-byte words, kScalarPairs
// pairs a lane (a kernel of their own: each form keeps its registers).
// Control flow is uniform across a warp: a group with no entry left
// repeats row 0's loads and stores nothing.
namespace {

constexpr int kGatherTile = 1024;   // slots of one query a block takes
constexpr int kPairs = 4;           // 16-byte pairs a lane loads at once
constexpr int kScalarPairs = 8;     // 4-byte pairs a lane loads at once

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Dynamic shared memory: the query (d floats), the slot list and one
// buffer of ceil(d / 2) floats a group, each rounded up to 16 bytes.
__host__ __device__ constexpr int gather_smem_floats(int d, int g) {
  return round4(d) + kGatherTile + (bbc::kThreads / g) * round4(d - d / 2);
}

__device__ __forceinline__ float sq_diff(float x, float q) {
  const float a = __fsub_rn(x, q);
  return __fmul_rn(a, a);
}

__device__ __forceinline__ float add_sq2(float x0, float q0, float x1,
                                         float q1) {
  return __fadd_rn(sq_diff(x0, q0), sq_diff(x1, q1));
}

template <bool VEC>
__global__ void __launch_bounds__(bbc::kThreads, 4)
l2_gather_rows_kernel(const float* __restrict__ x,
                      const long long* __restrict__ ids, long long ids_stride,
                      const float* __restrict__ qs,
                      const unsigned char* __restrict__ mask,
                      float* __restrict__ out, int d, int w, int g) {
  extern __shared__ float4 smem4[];
  __shared__ int n_set;
  float* q_s = reinterpret_cast<float*>(smem4);
  int* list = reinterpret_cast<int*>(q_s + round4(d));
  float* bufs = reinterpret_cast<float*>(list + kGatherTile);
  const int b = blockIdx.y, s0 = blockIdx.x * kGatherTile;
  const int lane = threadIdx.x & 31;
  const unsigned char* mrow = mask + static_cast<size_t>(b) * w;
  float* orow = out + static_cast<size_t>(b) * w;

  if (threadIdx.x == 0) n_set = 0;
  for (int i = threadIdx.x; i < d; i += bbc::kThreads)
    q_s[i] = qs[static_cast<size_t>(b) * d + i];
  __syncthreads();
  for (int k = 0; k < kGatherTile; k += bbc::kThreads) {
    const int s = s0 + k + threadIdx.x;
    const bool on = s < w && mrow[s];
    if (s < w && !on) orow[s] = INFINITY;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    int base = 0;
    if (lane == 0 && bal) base = atomicAdd(&n_set, __popc(bal));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (on) list[base + __popc(bal & ((1u << lane) - 1u))] = s;
  }
  __syncthreads();

  const int sl = lane & (g - 1), groups = bbc::kThreads / g;
  const int half = d >> 1, len1 = d - half;
  float* buf = bufs + (threadIdx.x / g) * round4(len1);
  const long long* irow = ids + b * ids_stride;
  const int count = n_set;
  for (int e0 = 0; e0 < count; e0 += groups) {
    const int e = e0 + static_cast<int>(threadIdx.x) / g;
    const bool act = e < count;
    const int s = act ? list[e] : 0;
    // a set entry's id is a row; -1 reads row 0, as the plain version's
    // clamp does
    const long long id = act ? irow[s] : 0;
    const float* xr = x + static_cast<size_t>(id > 0 ? id : 0) * d;
    // round 1 from device memory: buf[i] = sq[i] + sq[i + half], i < half
    if (VEC) {                       // d % 8 == 0, 16-byte aligned rows
      const int h4 = half >> 2;
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      const float4* q4 = reinterpret_cast<const float4*>(q_s);
      float4* b4 = reinterpret_cast<float4*>(buf);
      for (int t0 = sl; t0 < h4; t0 += kPairs * g) {
        float4 lo[kPairs], hi[kPairs];
#pragma unroll
        for (int u = 0; u < kPairs; ++u) {
          const int t = t0 + u * g;
          if (t < h4) {
            lo[u] = __ldg(x4 + t);
            hi[u] = __ldg(x4 + t + h4);
          }
        }
#pragma unroll
        for (int u = 0; u < kPairs; ++u) {
          const int t = t0 + u * g;
          if (t < h4) {
            const float4 qa = q4[t], qb = q4[t + h4];
            float4 r;
            r.x = add_sq2(lo[u].x, qa.x, hi[u].x, qb.x);
            r.y = add_sq2(lo[u].y, qa.y, hi[u].y, qb.y);
            r.z = add_sq2(lo[u].z, qa.z, hi[u].z, qb.z);
            r.w = add_sq2(lo[u].w, qa.w, hi[u].w, qb.w);
            b4[t] = r;
          }
        }
      }
    } else {
      for (int t0 = sl; t0 < half; t0 += kScalarPairs * g) {
        float lo[kScalarPairs], hi[kScalarPairs];
#pragma unroll
        for (int u = 0; u < kScalarPairs; ++u) {
          const int t = t0 + u * g;
          if (t < half) {
            lo[u] = __ldg(xr + t);
            hi[u] = __ldg(xr + t + half);
          }
        }
#pragma unroll
        for (int u = 0; u < kScalarPairs; ++u) {
          const int t = t0 + u * g;
          if (t < half) buf[t] = add_sq2(lo[u], q_s[t], hi[u], q_s[t + half]);
        }
      }
      if ((d & 1) && sl == 0)        // the odd column rides along
        buf[half] = sq_diff(__ldg(xr + d - 1), q_s[d - 1]);
    }
    __syncwarp();
    // the rounds above G values, in the group's buffer
    int len = len1;
    while (len > g) {
      const int h = len >> 1;
      for (int i = sl; i < h; i += g) buf[i] = __fadd_rn(buf[i], buf[i + h]);
      __syncwarp();
      if (len & 1) {
        if (sl == 0) buf[h] = buf[2 * h];
        __syncwarp();
      }
      len -= h;
    }
    // the last rounds in registers: value i in lane i of the group
    float v = sl < len ? buf[sl] : 0.f;
    while (len > 1) {
      const int h = len >> 1;
      const float o = __shfl_sync(0xffffffffu, v, sl < h ? sl + h : 2 * h, g);
      v = sl < h ? __fadd_rn(v, o) : o;    // lane h takes the odd column
      len -= h;
    }
    if (act && sl == 0) orow[s] = __fsqrt_rn(v);
    __syncwarp();                          // the buffer is free again
  }
}

}  // namespace

// Shared memory (bytes) the gather kernel's layout takes at width d with
// groups of g lanes.
extern "C" int l2_gather_rows_smem_bytes(int d, int g) {
  return 4 * gather_smem_floats(d, g);
}

// grid = (ceil(w / kGatherTile), B); `ids_stride` is the row stride of
// `ids` in elements (0 for a row broadcast over the queries; its column
// stride must be 1).  `g` lanes a row (8, 16 or 32); `vec` takes 16-byte
// loads (d % 8 == 0 and 16-byte aligned vectors).  A shared-memory size
// below the layout's is refused.
extern "C" int l2_gather_rows_launch(const float* x, const long long* ids,
                                     const float* qs,
                                     const unsigned char* mask, float* out,
                                     long long ids_stride, int d, int B,
                                     int w, int g, int vec, int smem,
                                     cudaStream_t stream) {
  if ((g != 8 && g != 16 && g != 32) || B > 65535 ||
      smem < 4 * gather_smem_floats(d, g))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = vec ? l2_gather_rows_kernel<true>
                          : l2_gather_rows_kernel<false>;
  cudaError_t err = bbc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kGatherTile - 1) / kGatherTile, B);
  kernel<<<grid, bbc::kThreads, smem, stream>>>(x, ids, ids_stride, qs, mask,
                                                out, d, w, g);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The masked pass: shared (n, d) fp32 vectors x (B, d) queries and a (B, n)
// bool mask -> (B, n) distances written at the set pairs alone, each with
// `l2_exact_batch`'s bits: its ascending coordinates, add_sq's
// __fsub_rn / __fmul_rn / __fadd_rn (no FMA) and sqrtf.  Nothing is written
// off the mask.  Beside it, one byte a (query round, row tile): 1 where the
// block staged the tile's rows for that round of 32 queries, else 0.
//
// Replaces no TPU kernel: the JAX package's RaBitQ searcher runs the dense
// l2_batch_pallas over every row and reads its stragglers from it (plain
// version: kernels/ref.py l2_exact_batch_masked, that pass under the mask).
//
// What bounds it on an H100.  RaBitQ's stragglers are the band lanes the
// scan did not certify, all inside each query's probed lists: at the
// GIST-width cell (B = 32, n = 1M, d = 960) ~53,000 of a query's ~57,000
// probed lanes, 5% of the (B, n) pairs.  The dense pass computes all
// 3·B·n·d fp32 instructions (92 G, 2.8 ms at the issue ceiling) for them.
// Here the work is what the mask leaves: the rows some query needs, each
// read once (4 bytes a coordinate; about half the rows at that cell, 0.59
// ms at 3.35 TB/s), the (B, n) mask read once (32 MB), and the arithmetic
// of the queries that need a tile.  A tile lies in one or two lists and a
// list is probed by about 32·64/1024 = 2 queries of a batch: most tiles
// that any query needs list one to four queries, so the arithmetic is a
// few per cent of the dense pass's and the bytes bound the kernel.
//
// What the design does about it.  A block owns 128 rows, as the dense
// kernel does; the stream is cluster-contiguous, so a tile lies in one or
// two lists.  It reads the tile's (32, 128) slice of the mask (16 bytes a
// thread) into shared memory and builds, by warp ballots, the list of
// queries with a set pair in the tile and the set of rows any of them
// needs.  A tile with no query exits after that read.  Otherwise the
// needed rows and the listed queries go through a 3-stage cp.async ring
// in chunks of 32 coordinates (a padded stride of 36 floats, 9 x 16 B,
// odd: the row loads of a quarter warp are free of bank conflicts); rows
// no query needs are not copied.  Each thread keeps one row and four
// queries of each group of eight listed queries (rows 32·(warp % 4) +
// lane, queries 8g + 4·(warp / 4) + j), so a group costs a 16-byte row
// load and four broadcast query loads per 48 fp32 instructions, and only
// the half groups that hold a listed query are computed: a tile that
// lists at most four queries keeps warps 4-7 out of the arithmetic (G =
// 1-4 groups, a template per count, chosen once per tile and warp half).
// The sums stay in registers across the chunks; a warp stores 32
// consecutive rows of one query where the mask (kept in shared memory) is
// set.  Past 32 queries the block takes them in rounds of 32, each round
// its own mask read and ring.  The ring's 69 KB and 80 registers a thread
// let three blocks share an SM, which hides the short tiles' mask read
// and ring fill; measured on the cell's own masks (H100 80GB HBM3, 700
// W), three blocks of a 3-stage ring ran 2-10% faster than two of a
// 4-stage one, 64-coordinate chunks no faster, one block of a 6-stage ring
// 40-70% slower, and the coordinate loop unrolled by two 0-6% faster than
// whole.
namespace {

constexpr int kRound = 32;        // queries whose mask slice a block reads
constexpr int kGroupQ = 8;        // queries of a group
constexpr int kMDc = 32;          // coordinates per staged chunk
constexpr int kMLd = kMDc + 4;    // padded shared-memory row stride (floats)
constexpr int kMStages = 3;       // cp.async ring depth

__host__ __device__ constexpr int masked_smem_bytes() {
  return kMStages * (kRows + kRound) * kMLd * 4;
}

// The sums of one staged chunk for G groups: this thread's row `xr` and
// the four queries of each group at `qr` (group g at 8g rows further).
template <int G>
__device__ __forceinline__ void masked_chunk(float (&acc)[4][4],
                                             const float* xr,
                                             const float* qr) {
#pragma unroll 2
  for (int c = 0; c < kMDc; c += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(xr + c);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(
            qr + (kGroupQ * g + j) * kMLd + c);
        float a = acc[g][j];
        a = bbc::add_sq(a, xv.x, qv.x);
        a = bbc::add_sq(a, xv.y, qv.y);
        a = bbc::add_sq(a, xv.z, qv.z);
        a = bbc::add_sq(a, xv.w, qv.w);
        acc[g][j] = a;
      }
  }
}

__global__ void __launch_bounds__(bbc::kThreads, 3)
l2_masked_kernel(const float* __restrict__ x, const float* __restrict__ qs,
                 const unsigned char* __restrict__ mask,
                 float* __restrict__ out, unsigned char* __restrict__ staged,
                 int n, int d, int B, int vec, int vec_mask) {
  constexpr int kStage = (kRows + kRound) * kMLd;   // floats per ring stage
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ __align__(16) unsigned char m_s[kRound * kRows];
  __shared__ unsigned q_bits[2];          // ping-pong by round
  __shared__ unsigned row_bits[kRows / 32];
  __shared__ int list[kRound];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, r0 = tile * kRows;
  const int rl = 32 * (warp & 3) + lane;  // this thread's row of the tile
  const int qh = 4 * (warp >> 2);         // its half of each group
  const int n_chunks = max(1, (d + kMDc - 1) / kMDc);
  if (threadIdx.x == 0) q_bits[0] = 0;

  for (int q0 = 0, round = 0; q0 < B; q0 += kRound, ++round) {
    const int slot = round & 1;
    __syncthreads();                      // the last round is read
    {                                     // the (32, 128) mask slice
      const int qi = threadIdx.x >> 3, c0 = 16 * (threadIdx.x & 7);
      const int q = q0 + qi;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q < B) {
        const unsigned char* src = mask + static_cast<size_t>(q) * n + r0 + c0;
        if (vec_mask && r0 + c0 + 16 <= n) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          unsigned w[4] = {0u, 0u, 0u, 0u};
          for (int i = 0; i < 16 && r0 + c0 + i < n; ++i)
            w[i >> 2] |= static_cast<unsigned>(src[i] != 0) << (8 * (i & 3));
          v = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      *reinterpret_cast<uint4*>(m_s + qi * kRows + c0) = v;
      const unsigned bal = __ballot_sync(0xffffffffu,
                                         (v.x | v.y | v.z | v.w) != 0u);
      if (lane == 0 && bal) {
        unsigned nib = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          nib |= static_cast<unsigned>(((bal >> (8 * j)) & 0xffu) != 0u) << j;
        atomicOr(&q_bits[slot], nib << (4 * warp));
      }
    }
    __syncthreads();
    const unsigned qb = q_bits[slot];
    if (threadIdx.x == 0) {
      q_bits[slot ^ 1] = 0;               // read last round, before the sync
      staged[static_cast<size_t>(round) * gridDim.x + tile] = qb != 0u;
    }
    if (qb == 0u) continue;               // no query needs this tile
    if (threadIdx.x < kRound && ((qb >> threadIdx.x) & 1u))
      list[__popc(qb & ((1u << threadIdx.x) - 1u))] = q0 + threadIdx.x;
    if (threadIdx.x < kRows) {            // warps 0-3: the rows needed
      bool need = false;
      for (int qi = 0; qi < kRound; ++qi)
        need |= m_s[qi * kRows + threadIdx.x] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, need);
      if (lane == 0) row_bits[warp] = bal;
    }
    __syncthreads();
    const int count = __popc(qb), groups = (count + kGroupQ - 1) / kGroupQ;
    // the groups that hold a listed query in this thread's half: a warp
    // whose half of every group lies past the list computes nothing
    const int mine = count > qh ? (count - qh + kGroupQ - 1) / kGroupQ : 0;

    // chunk s: the needed rows' and the listed queries' coordinates
    // [32s, 32s + 32), zero past d; rows not needed and group slots past
    // the list are not copied (their sums are never stored)
    auto load = [&](int s) {
      const int col0 = s * kMDc;
      float* xs = sm + (s % kMStages) * kStage;
      float* qs_s = xs + kRows * kMLd;
      const int q_rows = kGroupQ * groups;
      if (vec) {
        constexpr int kParts = kMDc / 4;
        for (int i = threadIdx.x; i < (kRows + q_rows) * kParts;
             i += bbc::kThreads) {
          const int r = i / kParts, c = 4 * (i % kParts);
          const float* row;
          float* dst;
          if (r < kRows) {
            if (!((row_bits[r >> 5] >> (r & 31)) & 1u)) continue;
            row = x + static_cast<size_t>(r0 + r) * d;
            dst = xs + r * kMLd + c;
          } else {
            const int qi = r - kRows;
            if (qi >= count) continue;
            row = qs + static_cast<size_t>(list[qi]) * d;
            dst = qs_s + qi * kMLd + c;
          }
          const bool ok = col0 + c < d;
          bbc::cp_async16(dst, ok ? row + col0 + c : row, ok ? 16 : 0);
        }
      } else {
        for (int i = threadIdx.x; i < (kRows + q_rows) * kMDc;
             i += bbc::kThreads) {
          const int r = i / kMDc, c = i % kMDc;
          const float* row;
          float* dst;
          if (r < kRows) {
            if (!((row_bits[r >> 5] >> (r & 31)) & 1u)) continue;
            row = x + static_cast<size_t>(r0 + r) * d;
            dst = xs + r * kMLd + c;
          } else {
            const int qi = r - kRows;
            if (qi >= count) continue;
            row = qs + static_cast<size_t>(list[qi]) * d;
            dst = qs_s + qi * kMLd + c;
          }
          const bool ok = col0 + c < d;
          bbc::cp_async4(dst, ok ? row + col0 + c : row, ok ? 4 : 0);
        }
      }
    };
#pragma unroll
    for (int s = 0; s < kMStages - 1; ++s) {
      if (s < n_chunks) load(s);
      bbc::cp_async_commit();
    }

    float acc[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;

    for (int s = 0; s < n_chunks; ++s) {
      bbc::cp_async_wait<kMStages - 2>();  // this thread's copies of chunk s
      __syncthreads();                     // everyone's; chunk s-1 is read
      if (s + kMStages - 1 < n_chunks) load(s + kMStages - 1);
      bbc::cp_async_commit();
      const float* stage = sm + (s % kMStages) * kStage;
      const float* xr = stage + rl * kMLd;
      const float* qr = stage + (kRows + qh) * kMLd;
      switch (mine) {
        case 0: break;
        case 1: masked_chunk<1>(acc, xr, qr); break;
        case 2: masked_chunk<2>(acc, xr, qr); break;
        case 3: masked_chunk<3>(acc, xr, qr); break;
        default: masked_chunk<4>(acc, xr, qr); break;
      }
    }
    bbc::cp_async_wait<0>();

    const int row = r0 + rl;
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = kGroupQ * g + qh + j;
        if (g < mine && qi < count && row < n) {
          const int q = list[qi];
          if (m_s[(q - q0) * kRows + rl])
            out[static_cast<size_t>(q) * n + row] = sqrtf(acc[g][j]);
        }
      }
  }
}

}  // namespace

// Shared memory (bytes) of the masked kernel's ring.
extern "C" int l2_exact_masked_smem_bytes() { return masked_smem_bytes(); }

// grid = ceil(n / 128) row tiles; `staged` holds ceil(B / 32) x grid bytes.
// `vec` allows 16-byte copies of x and qs (d % 4 == 0, aligned pointers),
// `vec_mask` 16-byte reads of the mask (n % 16 == 0, an aligned mask).  A
// shared-memory size below the kernel's ring is refused.
extern "C" int l2_exact_masked_launch(const float* x, const float* qs,
                                      const unsigned char* mask, float* out,
                                      unsigned char* staged, int n, int d,
                                      int B, int vec, int vec_mask, int grid,
                                      int smem, cudaStream_t stream) {
  if (smem < masked_smem_bytes())
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = bbc::allow_smem(l2_masked_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  l2_masked_kernel<<<grid, bbc::kThreads, smem, stream>>>(
      x, qs, mask, out, staged, n, d, B, vec, vec_mask);
  return static_cast<int>(cudaGetLastError());
}
