// SwitchBack int8 kernels for Hopper (sm_90a), forward and input gradient,
// bound through a plain C interface (loaded with ctypes by
// kernels/switchback/build.py).
//
// Eleven entry points, each replacing one Pallas TPU kernel (or one form of
// it) of the JAX package:
//
//   row_quantize            <- repro/kernels/switchback/switchback.py:row_quantize
//   col_quantize            <- repro/kernels/switchback/switchback.py:col_quantize
//   tensor_quantize         <- repro/kernels/switchback/switchback.py:tensor_quantize
//   fused_switchback_fwd    <- repro/kernels/switchback/switchback.py:fused_switchback_fwd
//   int8_matmul_dequant     <- repro/kernels/switchback/switchback.py:int8_matmul_dequant
//                              (row_scale epilogue, or with col_scale the
//                              rank-1 row x col epilogue of the colscale branch)
//   fused_switchback_dgrad  <- repro/kernels/switchback/switchback.py:fused_switchback_dgrad
//   int8_matmul_dequant_t   <- the same int8_matmul_dequant, transpose_w=True,
//                              either epilogue (the two-step dgrad of layers
//                              whose output width is above 2048, and the
//                              dgrad of the column-wise variants)
//   tensor_quantize_batched,  the same three under jax.vmap over experts
//   fused_switchback_fwd_batched,  (repro/models/moe.py:expert_linear): the
//   fused_switchback_dgrad_batched  kernels above on a grid one expert deep
//   wgrad_bf16              <- repro/kernels/switchback/switchback.py:wgrad_bf16
//                              (the 16-bit weight gradient, on bf16 wgmma; see
//                              its section: its numerics and its bound are its
//                              own)
//
// The fused forward and dgrad and both int8_matmul_dequant forms run one
// int8 wgmma mainloop (int8_matmul_kernel's; the fused pair's own kernel,
// fused_switchback_kernel, differs in where x's rows are quantized and in
// the epilogue's scale). The dgrad forms read the W tile the other way
// (template flag TW): dx[b, n] = sum_m g_q[b, m] * w_q[n, m] contracts over
// W's second, contiguous dim, so W (N, M) row-major is already K-major and
// each W tile is staged as it lies; the forward's (K, M) W is transposed
// tile by tile on its way into shared memory. No w_q^T is written to device
// memory anywhere, as on the TPU, where dot_general contracts over any dim
// pair.
//
// The quantizers read x once from device memory into registers:
// row_quantize and the fused pair's pass above 16 rows launch one row body
// (quantize_rows: a group of 32 to 256 threads a row); col_quantize gives a
// block a band of 32 columns over a slab of rows, the band's slabs the
// blocks of one thread block cluster, whose maxima meet in distributed
// shared memory, in one launch. tensor_quantize reads x once into the
// resident blocks' registers and meets their maxima at one grid barrier in
// one cooperative launch (kernels/csrc/tensor_absmax.cuh).
//
// Numerics copy the reference operation by operation, so every output is
// bitwise equal to the plain versions in ref.py:
//   * quantize: q = rint(x * (127 / absmax)), the division first, both
//     IEEE-rounded f32 (__fdiv_rn / __fmul_rn, so neither a fast-math flag
//     nor FMA contraction can change them), round half to even
//     (__float2int_rn); absmax floors at 1e-12.
//   * epilogue: y = f32(acc) * (s_x * (s_w / 16129)), rounded once to the
//     output type (__float2bfloat16_rn for bf16); with a column scale
//     y = f32(acc) * (row[b] * col[m]), the rank-1 product rounded once,
//     then the multiply.
//   * the int8 dot accumulates exactly in int32 (s32 wgmma), so the order
//     of the sum does not matter.
//
// Every entry point launches on the caller's stream, allocates nothing (the
// fused pair's workspaces come from the wrapper) and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

#include "../../csrc/tensor_absmax.cuh"
#include "../../csrc/wgmma.cuh"

namespace {

constexpr float kEps = 1e-12f;
constexpr float kQmax = 127.0f;
constexpr float kQmax2 = 16129.0f;  // 127 * 127, exact in f32
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  return static_cast<int8_t>(__float2int_rn(__fmul_rn(x, scale)));
}

// |x| >= 0, so 0 is the identity of every max below.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max over the block; `red` is 32 floats of shared memory. All threads get it.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_max(v);
  if (threadIdx.x == 0) red[0] = v;
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

// ---------------------------------------------------------------------------
// row_quantize: x (B, K) -> q (B, K) int8, s (B,) f32   (paper Eq. 1)
// col_quantize: x (R, C) -> q (R, C) int8, s (C,) f32   (paper Eq. 4, the
// per-output-unit weight scales of SwitchBackQ and LLM.int8)
//
// Both are bound by bytes: x read once in its type, q written once, the
// states. Each reads x once from device memory into registers, in chunks of
// kChunk values, every load issued before any is read, and quantizes from
// the registers.
//
// A chunk loads and stores in granules of G values, which the launchers
// choose from x's alignment and width: G = 8 (a 16-byte load of bf16, two
// of f32; an 8-byte store) where x is 16-byte aligned and the width W (K or
// C) is a multiple of 8; G = 4 (an 8-byte load of bf16, a 16-byte one of
// f32; 4-byte stores) where W % 4 == 0 and x is aligned to 4 values (the
// patch embedding's K = 588); else G = 1, value by value. A granule lies
// wholly inside or wholly past the row, so only whole granules are read.
// ---------------------------------------------------------------------------
constexpr int kChunk = 8;        // values of one chunk: 16 bytes of bf16
constexpr int kMaxChunks = 8;    // chunks a thread holds in registers: 64 values
static_assert(kThreads == 1 << 8, "the row groups shift by log2(kThreads) = 8");

template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {    // 8 bf16 values as 4 words, widened on use
  uint32_t w[4];
  // the first n values at p (n = 0 or a whole number of granules), the rest 0
  template <int G>
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int n) {
    w[0] = w[1] = w[2] = w[3] = 0u;
    if (G == 8) {
      if (n > 0) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
        w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
      }
    } else if (G == 4) {
      if (n > 0) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = u.x, w[1] = u.y;
      }
      if (n > 4) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + 4));
        w[2] = u.x, w[3] = u.y;
      }
    } else {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        if (e < n) w[e >> 1] |= static_cast<uint32_t>(__ldg(h + e)) << (16 * (e & 1));
    }
  }
  __device__ __forceinline__ float operator[](int e) const {   // a bf16 is the top half of its f32
    return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
  }
};

template <>
struct Chunk<float> {
  float v[kChunk];
  template <int G>
  __device__ __forceinline__ void load(const float* p, int n) {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) v[e] = 0.f;
    if (G > 1) {                               // 16-byte granules of 4 (G = 8: both)
      if (n > 0) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      }
      if (n > 4) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
        v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        if (e < n) v[e] = __ldg(p + e);
    }
  }
  __device__ __forceinline__ float operator[](int e) const { return v[e]; }
};

// four values' int8 codes, little-endian in one word
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d, float sa, float sb,
                                          float sc, float sd) {
  return static_cast<uint32_t>(static_cast<uint8_t>(quantize(a, sa))) |
         static_cast<uint32_t>(static_cast<uint8_t>(quantize(b, sb))) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(quantize(c, sc))) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(quantize(d, sd))) << 24;
}

// a chunk's n codes (as for Chunk::load) at p: one 8-byte store (G = 8),
// 4-byte words (G = 4) or bytes
template <int G>
__device__ __forceinline__ void store_chunk(int8_t* p, uint32_t lo, uint32_t hi, int n) {
  if (G == 8) {
    if (n > 0) *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  } else if (G == 4) {
    if (n > 0) *reinterpret_cast<uint32_t*>(p) = lo;
    if (n > 4) *reinterpret_cast<uint32_t*>(p + 4) = hi;
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (e < n) p[e] = static_cast<int8_t>((e < 4 ? lo : hi) >> (8 * (e & 3)));
  }
}

// the granule for an x of width W at x (and its codes at q): 8, 4 or 1
template <typename T>
int granule(const void* x, const void* q, int W) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x), b = reinterpret_cast<uintptr_t>(q);
  if (W % 8 == 0 && a % 16 == 0 && b % 8 == 0) return 8;
  if (W % 4 == 0 && a % (4 * sizeof(T)) == 0 && b % 4 == 0) return 4;
  return 1;
}

// ---------------------------------------------------------------------------
// The one row-quantize body (quantize_rows), launched by row_quantize and by
// the fused pair's first pass above 16 rows (fused_quantize_kernel, which
// quantizes x into the wrapper's workspace). A group of 2^gshift threads (32
// to 256; 256 / group groups a block) owns a row. Thread t of the group
// holds chunks t, t + group, ... of the row (np of them, at most
// kMaxChunks), so neighbouring threads read neighbouring bytes. The
// launcher takes the smallest group with np <= kMaxChunks: a warp a row up
// to K = 2,048 (the absmax a warp shuffle), two warps to 4,096, four to
// 8,192, eight to 16,384 (the group's warps meet in shared memory). Then one
// IEEE division a row and the codes from the registers. A longer row takes
// the wide path: a block a row, two passes over x, the second mostly from
// L2 (quantize_row_wide; no path has such rows).
// ---------------------------------------------------------------------------
struct Rows {
  int B, K;      // x (B, K), row-major
  int gshift;    // log2 of the threads that own a row: 5 to 8
  int np;        // chunks a thread: ceil(K / (kChunk << gshift)) <= kMaxChunks
};

template <typename T, int G>
__device__ __forceinline__ void quantize_rows(const T* __restrict__ x, int8_t* __restrict__ q,
                                              float* __restrict__ s, const Rows& p) {
  __shared__ float red[kThreads / 32];
  const int g = threadIdx.x >> p.gshift, t = threadIdx.x & ((1 << p.gshift) - 1);
  const int row = (blockIdx.x << (8 - p.gshift)) + g;        // kThreads = 2^8
  const bool live = row < p.B;
  const size_t base = static_cast<size_t>(row) * p.K;
  Chunk<T> v[kMaxChunks];
  int n[kMaxChunks];
  // every load issued before any is read
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int c = kChunk * (t + (j << p.gshift));
    n[j] = live && j < p.np && c < p.K ? min(kChunk, p.K - c) : 0;
    v[j].template load<G>(x + base + c, n[j]);
  }
  float m = 0.f;                                             // chunks not loaded hold 0
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j)
#pragma unroll
    for (int e = 0; e < kChunk; ++e) m = fmaxf(m, fabsf(v[j][e]));
  m = warp_max(m);
  if (p.gshift > 5) {                                        // the group's warps' maxima
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    const int w0 = (g << p.gshift) >> 5;
    for (int i = 0; i < 1 << (p.gshift - 5); ++i) m = fmaxf(m, red[w0 + i]);
  }
  const float absmax = fmaxf(m, kEps);
  const float scale = __fdiv_rn(kQmax, absmax);
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    if (n[j] == 0) continue;
    const uint32_t lo = pack4(v[j][0], v[j][1], v[j][2], v[j][3], scale, scale, scale, scale);
    const uint32_t hi = pack4(v[j][4], v[j][5], v[j][6], v[j][7], scale, scale, scale, scale);
    store_chunk<G>(q + base + kChunk * (t + (j << p.gshift)), lo, hi, n[j]);
  }
  if (live && t == 0) s[row] = absmax;
}

// the wide path: one block a row, the absmax a block reduction, then a
// second pass over the row
template <typename T>
__device__ __forceinline__ void quantize_row_wide(const T* __restrict__ x, int8_t* __restrict__ q,
                                                  float* __restrict__ s, int K) {
  __shared__ float red[32];
  const size_t base = static_cast<size_t>(blockIdx.x) * K;
  float m = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) m = fmaxf(m, fabsf(to_f32(x[base + k])));
  const float absmax = fmaxf(block_max(m, red), kEps);
  const float scale = __fdiv_rn(kQmax, absmax);
  for (int k = threadIdx.x; k < K; k += blockDim.x) q[base + k] = quantize(to_f32(x[base + k]), scale);
  if (threadIdx.x == 0) s[blockIdx.x] = absmax;
}

// G = 0: the wide path. Two entry kernels of one body, so that a profile
// tells row_quantize's launches from the fused pair's pass (TW: the dgrad's)
template <typename T, int G>
__device__ __forceinline__ void quantize_rows_at(const T* x, int8_t* q, float* s, const Rows& p) {
  if constexpr (G == 0)
    quantize_row_wide<T>(x, q, s, p.K);
  else
    quantize_rows<T, G>(x, q, s, p);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
row_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s, Rows p) {
  quantize_rows_at<T, G>(x, q, s, p);
}

template <typename T, int G, bool TW>
__global__ void __launch_bounds__(kThreads)
fused_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                      Rows p) {
  quantize_rows_at<T, G>(x, q, s, p);
}

enum { kRowQuantize = 0, kFusedFwd = 1, kFusedDgrad = 2 };   // who launches the row body

template <typename T, int G>
void launch_rows_at(int who, const T* x, int8_t* q, float* s, const Rows& p, int blocks,
                    cudaStream_t st) {
  if (who == kRowQuantize)
    row_quantize_kernel<T, G><<<blocks, kThreads, 0, st>>>(x, q, s, p);
  else if (who == kFusedFwd)
    fused_quantize_kernel<T, G, false><<<blocks, kThreads, 0, st>>>(x, q, s, p);
  else
    fused_quantize_kernel<T, G, true><<<blocks, kThreads, 0, st>>>(x, q, s, p);
}

// the group, the path and the grid (see above), then one launch
template <typename T>
int launch_rows(int who, const void* x, void* q, void* s, int B, int K, cudaStream_t st) {
  if (B <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  Rows p;
  p.B = B, p.K = K;
  const int chunks = (K + kChunk - 1) / kChunk;
  p.gshift = 5;
  while (p.gshift < 8 && chunks > kMaxChunks << p.gshift) ++p.gshift;
  p.np = (chunks + (1 << p.gshift) - 1) >> p.gshift;
  const int G = p.np > kMaxChunks ? 0 : granule<T>(x, q, K);
  const int blocks = G == 0 ? B : (B + (kThreads >> p.gshift) - 1) >> (8 - p.gshift);
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  if (G == 8)
    launch_rows_at<T, 8>(who, xp, qp, sp, p, blocks, st);
  else if (G == 4)
    launch_rows_at<T, 4>(who, xp, qp, sp, p, blocks, st);
  else if (G == 1)
    launch_rows_at<T, 1>(who, xp, qp, sp, p, blocks, st);
  else
    launch_rows_at<T, 0>(who, xp, qp, sp, p, blocks, st);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// col_quantize. The reduction runs down the columns, across the contiguous
// dimension's rows. A block owns a band of kBand columns (64 bytes of bf16 a
// row) over a slab of rows: thread t takes chunk column t % 4 of the band
// and rows t / 4, t / 4 + 64, ... of the slab (np chunks, at most
// kColChunks), so a warp reads 8 rows' whole band and each thread's chunks
// share its 8 columns. Its 8 column maxima meet by shuffles across the lanes
// of one chunk column (lane % 4), then across the warps in shared memory:
// the slab's band maxima. The band's slabs are the blocks of one thread
// block cluster (grid (slabs, bands), cluster (slabs, 1, 1), at most
// kMaxCluster, H100's non-portable limit). After the cluster barrier each
// block reads every slab's maxima through distributed shared memory (mapa;
// the reads all in flight at once), takes the band's absmax and 127 /
// absmax, and quantizes its slab from its registers; a second barrier keeps
// every block's maxima alive until its peers have read them. So x is read
// once from device memory, in one launch. A block holds its slab until its
// cluster's last block has loaded, so the launcher takes as few slabs as
// fit kColChunks a thread: the fewer blocks, the fewer clusters wait for a
// second wave. Ragged bands and slabs are masked, nothing is padded. Rows past kMaxCluster slabs (8,192) take the
// wide path: a block owns 32 columns, one per lane, over every row, and
// reads x twice, the second time mostly from L2 (no path has such rows).
// ---------------------------------------------------------------------------
constexpr int kBand = 32;                           // columns of a band
constexpr int kBandChunks = kBand / kChunk;         // chunk columns of a band: 4
constexpr int kSlabStep = kThreads / kBandChunks;   // rows a block reads a chunk step: 64
constexpr int kColChunks = 8;                       // chunk steps a slab at most
constexpr int kMaxCluster = 16;
constexpr int kColRowSplit = kThreads / kBand;      // the wide path: 8 warps over the rows

struct Cols {
  int R, C;      // x (R, C), row-major
  int np;        // chunks a thread: a slab is kSlabStep * np rows
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}
// the float at p in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float cluster_load(const float* p, uint32_t rank) {
  uint32_t a;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

template <typename T, int G>
__device__ __forceinline__ void quantize_cols(const T* __restrict__ x, int8_t* __restrict__ q,
                                              float* __restrict__ s, const Cols& p) {
  __shared__ float red[kThreads / 32][kBand];   // each warp's band maxima
  __shared__ float slab[kBand];                 // this slab's: read by the cluster's blocks
  __shared__ float peer[kMaxCluster][kBand];    // every slab's, read from its block
  __shared__ float scale[kBand];                // the band's 127 / absmax
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c0 = blockIdx.y * kBand, cc = t % kBandChunks;
  const int col = c0 + kChunk * cc, cols = min(kChunk, p.C - col);
  const int r0 = blockIdx.x * kSlabStep * p.np + t / kBandChunks;
  // chunk j is row r0 + 64 j: the first nj lie inside the slab and x
  const int nj = cols > 0 ? max(0, min(p.np, (p.R - r0 + kSlabStep - 1) / kSlabStep)) : 0;
  Chunk<T> v[kColChunks];
  // every load issued before any is read
#pragma unroll
  for (int j = 0; j < kColChunks; ++j)
    v[j].template load<G>(x + static_cast<size_t>(r0 + kSlabStep * j) * p.C + col,
                          j < nj ? cols : 0);
  float m[kChunk];
#pragma unroll
  for (int e = 0; e < kChunk; ++e) {
    m[e] = 0.f;                                 // chunks not loaded hold 0
#pragma unroll
    for (int j = 0; j < kColChunks; ++j) m[e] = fmaxf(m[e], fabsf(v[j][e]));
#pragma unroll
    for (int o = kBandChunks; o < 32; o <<= 1)  // the lanes of one chunk column
      m[e] = fmaxf(m[e], __shfl_xor_sync(0xffffffffu, m[e], o));
  }
  if (lane < kBandChunks)
#pragma unroll
    for (int e = 0; e < kChunk; ++e) red[warp][kChunk * lane + e] = m[e];
  __syncthreads();
  if (t < kBand) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) a = fmaxf(a, red[w][t]);
    slab[t] = a;
  }
  cluster_arrive();                             // release: this slab's maxima
  cluster_wait();                               // acquire: every slab's
  for (int i = t; i < static_cast<int>(gridDim.x) * kBand; i += kThreads)   // all at once
    peer[i / kBand][i % kBand] = cluster_load(&slab[i % kBand], i / kBand);
  cluster_arrive();                             // done with the peers' maxima
  __syncthreads();
  if (t < kBand) {
    float a = 0.f;
    for (uint32_t k = 0; k < gridDim.x; ++k) a = fmaxf(a, peer[k][t]);
    const float absmax = fmaxf(a, kEps);
    scale[t] = __fdiv_rn(kQmax, absmax);
    if (blockIdx.x == 0 && c0 + t < p.C) s[c0 + t] = absmax;
  }
  __syncthreads();
  float sc[kChunk];
#pragma unroll
  for (int e = 0; e < kChunk; ++e) sc[e] = scale[kChunk * cc + e];
#pragma unroll
  for (int j = 0; j < kColChunks; ++j) {
    if (j >= nj) break;
    const uint32_t lo = pack4(v[j][0], v[j][1], v[j][2], v[j][3], sc[0], sc[1], sc[2], sc[3]);
    const uint32_t hi = pack4(v[j][4], v[j][5], v[j][6], v[j][7], sc[4], sc[5], sc[6], sc[7]);
    store_chunk<G>(q + static_cast<size_t>(r0 + kSlabStep * j) * p.C + col, lo, hi, cols);
  }
  cluster_wait();                               // no block leaves while a peer reads it
}

// the wide path (see above): the 8 warps' partial column maxima meet in
// shared memory, then each thread quantizes its column's share of the rows
template <typename T>
__device__ __forceinline__ void quantize_cols_wide(const T* __restrict__ x, int8_t* __restrict__ q,
                                                   float* __restrict__ s, const Cols& p) {
  __shared__ float part[kColRowSplit][kBand];
  const int lane = threadIdx.x % kBand, split = threadIdx.x / kBand;
  const int c = blockIdx.x * kBand + lane;
  float m = 0.f;
  if (c < p.C)
    for (int r = split; r < p.R; r += kColRowSplit)
      m = fmaxf(m, fabsf(to_f32(x[static_cast<size_t>(r) * p.C + c])));
  part[split][lane] = m;
  __syncthreads();
  m = 0.f;
#pragma unroll
  for (int i = 0; i < kColRowSplit; ++i) m = fmaxf(m, part[i][lane]);
  if (c >= p.C) return;
  const float absmax = fmaxf(m, kEps);
  const float sc = __fdiv_rn(kQmax, absmax);
  for (int r = split; r < p.R; r += kColRowSplit) {
    const size_t i = static_cast<size_t>(r) * p.C + c;
    q[i] = quantize(to_f32(x[i]), sc);
  }
  if (split == 0) s[c] = absmax;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
col_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                    Cols p) {
  if constexpr (G == 0)
    quantize_cols_wide<T>(x, q, s, p);
  else
    quantize_cols<T, G>(x, q, s, p);
}

// one cluster launch: grid (slabs, bands), the cluster a band's slabs
template <typename T, int G>
cudaError_t launch_cols_at(const T* x, int8_t* q, float* s, const Cols& p, int slabs, int bands,
                           cudaStream_t st) {
  void (*kernel)(const T*, int8_t*, float*, Cols) = col_quantize_kernel<T, G>;
  static const cudaError_t allowed =      // once: clusters above 8 blocks
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slabs, bands, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slabs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, q, s, p);
}

// the slabs, the path and the grid (see above), then one launch
template <typename T>
int launch_cols(const void* x, void* q, void* s, int R, int C, cudaStream_t st) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  Cols p;
  p.R = R, p.C = C;
  const int bands = (C + kBand - 1) / kBand;
  const int steps = (R + kSlabStep - 1) / kSlabStep;         // chunk steps down a column
  const int slabs = (steps + kColChunks - 1) / kColChunks;
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  if (slabs > kMaxCluster || bands > 65535) {                 // the wide path
    col_quantize_kernel<T, 0><<<bands, kThreads, 0, st>>>(xp, qp, sp, p);
    return static_cast<int>(cudaGetLastError());
  }
  p.np = (steps + slabs - 1) / slabs;                        // the steps spread evenly
  cudaError_t err;
  switch (granule<T>(x, q, C)) {
    case 8: err = launch_cols_at<T, 8>(xp, qp, sp, p, slabs, bands, st); break;
    case 4: err = launch_cols_at<T, 4>(xp, qp, sp, p, slabs, bands, st); break;
    default: err = launch_cols_at<T, 1>(xp, qp, sp, p, slabs, bands, st); break;
  }
  const cudaError_t last = cudaGetLastError();               // cleared either way
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// ---------------------------------------------------------------------------
// tensor_quantize: x (n,) -> q (n,) int8, s (1,) f32   (paper Eq. 2)
//
// Bound by bytes. The skeleton of kernels/csrc/tensor_absmax.cuh (shared
// with the fp8 tensor_quantize): x read once into the registers of the
// blocks that can be resident at once, their maxima met at one grid-wide
// barrier inside one cooperative launch, the codes from the registers;
// two launches only past the registers (no path weight: about 8.7 M bf16
// values at two blocks an SM). The per-value arithmetic is the plain
// version's: q = rint(x * (127 / absmax)), both IEEE-rounded in f32.
// ---------------------------------------------------------------------------
struct Int8Four {                    // four values' codes at 127 / absmax
  float scale;
  __device__ __forceinline__ uint32_t four(float a, float b, float c, float d) const {
    return pack4(a, b, c, d, scale, scale, scale, scale);
  }
};

struct Int8Codec {
  template <int MODE, int G, typename T, int K>
  __device__ __forceinline__ static void cast(float absmax, tq::Vals<T> (&v)[K],
                                              const tq::Work<T>& w) {
    tq::cast_work<MODE, G>(Int8Four{__fdiv_rn(kQmax, absmax)}, v, w);
  }
};

// __launch_bounds__ 2 blocks an SM: at most 128 registers a thread, so 264
// blocks on 132 SMs hold 8.65 M values in one launch
template <typename T, int G, int MODE>
__global__ void __launch_bounds__(tq::kThreads, 2)
tensor_quantize_kernel(const T* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ s,
                       float* __restrict__ partial, unsigned* __restrict__ bar, tq::Plan p) {
  tq::quantize<T, G, MODE, Int8Codec>(x, q, s, partial, bar, p);
}

struct Int8Kernels {                 // the launcher's family (tq::run): one format
  template <typename T, int G, int MODE>
  static tq::Kernel<T> kernel(int) {
    return tensor_quantize_kernel<T, G, MODE>;
  }
};

// ---------------------------------------------------------------------------
// int8_matmul_dequant: x_q (B, K) int8, w_q (K, M) int8, row_scale (B,) f32
//   -> y (B, M) = f32(x_q . w_q) * row_scale[b]
// int8_matmul_dequant_t (TW): w_q (M, K) int8 -> y = f32(x_q . w_q^T) * row_scale[b]
// With col_scale (M,) f32 (not null), either orientation: the colscale
// branch of the TPU kernel (switchback.py:176), y = f32(acc) * (row_scale[b]
// * col_scale[m]), the per-output-column weight state of paper Eq. 4
// (forward: W's column scales; the dgrad of SwitchBackQ / LLM.int8: the
// per-row scales of the row-quantized W, which index the dgrad's output
// columns).
//
// fused_switchback_fwd: x (B, K) float/bf16, w_q (K, M) int8, s_w (1,) f32
//   -> y (B, M) = f32(x_q . w_q) * (absmax_row * (s_w / 127^2))   (paper Eq. 3)
// fused_switchback_dgrad (TW): g (B, K) float/bf16, w_q (M, K) int8 -- the
//   forward's (N, M) weight, here with K = the layer's output width and M =
//   its input width -- -> dx (B, M), the same arithmetic on the other
//   contraction. x's (or g's) rows are row-quantized as row_quantize does;
//   the scale is rounded once, then the multiply, in x's type.
//
// What bounds them on an H100: at the training paths' rows (2,048 smollm,
// 4,128 CLIP) the int8 operations, 2 B K M over 1,979 TOPS; at decode (8
// rows) the weight's bytes. They run on int8 wgmma (s32 += s8 . s8,
// m64nNk32, kernels/csrc/wgmma.cuh) in the fp8 GEMMs' shape:
//   * a block owns a 128 x 128 tile of y: one producer warpgroup and two
//     consumer warpgroups of 64 rows. Per stage (128 bytes of K, four k32
//     steps) the producer fills the x tile and W's K-major tile (128 output
//     columns x 128 bytes of K), 128-byte swizzled, with an mbarrier a
//     stage. 8-bit wgmma reads K-major operands only. x_q (B, K) is K-major
//     as it lies, and so is the dgrad's w_q (M, K): both go by TMA. The
//     forward's w_q (K, M) is M-major: TMA brings its (128 k x 128 m) tile
//     as it lies into a ring of raw buffers, and the producer warpgroup
//     transposes it into the stage, 4 x 4 bytes a thread with __byte_perm,
//     its lanes laid so that neither the reads nor the writes of shared
//     memory conflict. No pass over W and no launch is added.
//   * a shape TMA refuses (a row pitch off 16 bytes: the patch embedding's
//     x_q at K = 588) takes the masked path of the same kernel: the
//     producer warpgroup loads every tile itself, zeros past the matrix.
//     Rows, columns and K past the matrix arrive as zeros on both paths and
//     add nothing; the epilogue masks the ragged edge.
//   * decode (B <= 16 rows) swaps the operands: W's K-major tile is A (64
//     output columns a consumer) and the x rows are B (N = 16), so every
//     row count runs on the tensor cores; the epilogue writes y transposed.
//   * the s32 sum is exact (|acc| <= 127^2 * 5,120 < 2^31 at the widest K
//     on the paths), so the consumers chain every stage into one fragment
//     with no promotion, keeping one stage's steps in flight while the
//     next are issued. The epilogue is the plain version's operation for
//     operation: __int2float_rn(acc) times rs, or times __fmul_rn(rs,
//     col_scale[m]), rounded once. So every output is bit-equal to ref.py.
// The fused pair (fused_switchback_kernel) quantizes each row of x once,
// never once per column block (a 128-column block's producer quantizing
// its rows itself would re-read x's bf16 panel M / 128 times, 424 MB of L2
// reads at CLIP's w_up, where the product's int8 work takes about 55 us):
//   * above 16 rows, in a pass of its own first (fused_quantize_kernel,
//     row_quantize's body: x read once), into the wrapper's int8 (B, K) workspace and
//     its f32 absmax (B,); the GEMM then runs as int8_matmul_dequant's and
//     its epilogue forms the scale itself, __fmul_rn(absmax[b], __fdiv_rn(
//     s_w, 16129)), so nothing runs between the two launches;
//   * at <= 16 rows (decode, verify, short prefills), where the step is
//     the host's and a launch more would lengthen every token, in the one
//     launch: before the roles split, the block's 12 warps take the absmax
//     of its <= 16 rows over K (at most 64 KB, from L2 after the first
//     block) while W's first tiles are already on their way; then per stage
//     the producer warpgroup writes the 16 x 128 quantized bytes straight
//     into the swizzled B tile (thread t: row t / 8, bytes 16 (t % 8) .. +
//     15), fences them for the async proxy and arrives, beside W's tile
//     (TMA, or the raw ring and the transpose, or the masked loads).
//     M / 128 blocks (3 at smollm's K/V projections) cannot stream the
//     weight, so K's steps split over blocks (blockIdx.y) until the column
//     tiles' blocks about fill the card: each block adds its s32 sums into
//     the wrapper's zeroed workspace by atomicAdd (exact in any order, so
//     two launches give the same bits) and takes a ticket; the last block
//     of a tile takes the sums back out (atomicExch with 0), resets the
//     ticket and stores the tile.
// ---------------------------------------------------------------------------
constexpr int kI8Tile = 128 * 128;          // bytes of one operand's tile of a stage
constexpr int kI8SwapRows = 16;             // x rows of the swapped (decode) form: N = 16
constexpr int kI8Threads = 384;             // producer warpgroup + two consumer warpgroups
constexpr int kI8MaxStages = 6;
constexpr int kI8MaxRaws = 4;

struct I8Gemm {
  const int8_t* x;           // x_q (B, K); the fused decode form: null
  const int8_t* w;           // TW: (M, K); else (K, M)
  const float* row_scale;    // (B,): the caller's scale, or the fused pair's absmax
  const float* col_scale;    // (M,) or null
  const float* s_w;          // the fused pair's (1,) weight state, else null
  const void* xf;            // the fused decode form's x (B, K) in T, else null
  int* split;                // the fused decode form's s32 sums (16, M), then a ticket per
                             // column tile: zero, and left zero by every launch
  void* y;                   // (B, M), T
  int B, K, M;
  int tma, stages, raws;     // set by the launcher
  int xvec;                  // xf's rows load 16 bytes at a time (K % 8 == 0, aligned)
  int splits, per;           // the fused decode form: K's 128-byte steps split into `splits`
                             // ranges of `per` (blockIdx.y), else 1 and all of them
};

// The expert-batched forms (E matrices one after another: x (E, B, K), W
// (E, K, M) or, TW, (E, M, K), y (E, B, M), s_w (E,), the workspaces E
// deep) run the same kernels on a grid one expert deep (blockIdx.z): a
// block works on its expert's slices, which these give (expert 0 in the
// 2-D forms), and its TMA boxes take the expert as their outermost
// coordinate (expert_z) in 3-D maps of the stacked matrices.
__device__ __forceinline__ size_t expert() { return blockIdx.z; }
__device__ __forceinline__ int expert_z() { return static_cast<int>(blockIdx.z); }
__device__ __forceinline__ const int8_t* expert_x(const I8Gemm& g) {
  return g.x + expert() * g.B * g.K;
}
__device__ __forceinline__ const int8_t* expert_w(const I8Gemm& g) {
  return g.w + expert() * g.K * g.M;
}
template <typename T>
__device__ __forceinline__ const T* expert_xf(const I8Gemm& g) {
  return static_cast<const T*>(g.xf) + expert() * g.B * g.K;
}

size_t i8_smem_bytes(int stages, int raws) {
  return 1024 + (2 * static_cast<size_t>(stages) + raws) * kI8Tile +
         (2 * kI8MaxStages + kI8MaxRaws) * sizeof(uint64_t) + 2 * kI8SwapRows * sizeof(float) +
         4 * sizeof(int);
}

// the masked path: rows [r0, r0 + rows) x bytes [c0, c0 + 128) of an (R, C)
// byte matrix into a swizzled tile (row r at r * 128), zeros outside; one
// 16-byte chunk per step, in 4-byte words where C and the pointer allow
__device__ void load_tile(uint8_t* dst, const int8_t* __restrict__ src, int R, int C, int r0,
                          int c0, int rows, int t) {
  const bool words = (C & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3u) == 0;
  for (int c = t; c < rows * 8; c += 128) {
    const int r = c >> 3, ch = c & 7, row = r0 + r;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (row < R) {
      const uint8_t* p = reinterpret_cast<const uint8_t*>(src) + static_cast<size_t>(row) * C;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 16 * ch + 4 * e;
        if (words) {
          if (col < C) v[e] = *reinterpret_cast<const uint32_t*>(p + col);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (col + i < C) v[e] |= static_cast<uint32_t>(p[col + i]) << (8 * i);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + sw128(r * 128 + ch * 16)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// The forward's W tile made K-major: `raw` holds 128 rows of k, each 128
// bytes of m (as TMA writes a (K, M) tile, 128-byte swizzled); `dst` gets
// 128 rows of m, each 128 bytes of k, swizzled. Thread t (of 128) moves
// 4 x 4-byte blocks: lane l keeps m-word l (m = 4 l .. 4 l + 3) and walks
// the k-quads v = f(l) ^ i, i = warp + 4 j; f interleaves the lanes so that
// the 32 lanes of a load or a store reach 32 different banks.
__device__ __forceinline__ void transpose_tile(uint8_t* dst, const uint8_t* raw, int t) {
  const int l = t & 31, wq = t >> 5;
  const int f = 4 * ((l & 3) | ((l >> 4) << 2)) + ((l >> 2) & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int v = f ^ (wq + 4 * j);
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = *reinterpret_cast<const uint32_t*>(raw + sw128((4 * v + r) * 128 + 4 * l));
    // w[r] holds k = 4 v + r at m = 4 l .. 4 l + 3; word e of the output
    // holds m = 4 l + e at k = 4 v .. 4 v + 3
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
    const uint32_t out[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<uint32_t*>(dst + sw128((4 * l + e) * 128 + 4 * v)) = out[e];
  }
}

// the producer warpgroup: x's and W's K-major tiles of stage s for each
// 128-byte step of K, in order
template <bool TW, bool SWAP>
__device__ void i8_produce(const I8Gemm& g, const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                           uint8_t* xs, uint8_t* ws, uint8_t* raw, uint64_t* full,
                           uint64_t* empty, uint64_t* rawfull, int row0, int col0) {
  constexpr int kXRows = SWAP ? kI8SwapRows : 128;
  const int t = threadIdx.x;
  const int nk = (g.K + 127) / 128;
  int s = 0;
  uint32_t ph = 0;
  if (g.tma && TW) {
    if (t != 0) return;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&empty[s], ph ^ 1u);
      mbar_expect_tx(&full[s], kXRows * 128 + kI8Tile);
      tma_load_3d(xs + s * kI8Tile, tm_x, &full[s], 128 * kb, row0, expert_z());
      tma_load_3d(ws + s * kI8Tile, tm_w, &full[s], 128 * kb, col0, expert_z());
      if (++s == g.stages) {
        s = 0;
        ph ^= 1u;
      }
    }
    return;
  }
  if (g.tma) {
    // W's raw tiles run up to `raws` steps ahead of the transposes
    if (t == 0)
      for (int kb = 0; kb < min(g.raws, nk); ++kb) {
        mbar_expect_tx(&rawfull[kb], kI8Tile);
        tma_load_3d(raw + kb * kI8Tile, tm_w, &rawfull[kb], col0, 128 * kb, expert_z());
      }
    for (int kb = 0; kb < nk; ++kb) {
      const int r = kb % g.raws;
      mbar_wait(&empty[s], ph ^ 1u);
      if (t == 0) {
        mbar_expect_tx(&full[s], kXRows * 128);
        tma_load_3d(xs + s * kI8Tile, tm_x, &full[s], 128 * kb, row0, expert_z());
      }
      mbar_wait(&rawfull[r], (kb / g.raws) & 1u);
      transpose_tile(ws + s * kI8Tile, raw + r * kI8Tile, t);
      fence_proxy_async();
      mbar_arrive(&full[s]);
      named_sync(1, 128);                    // raw tile r fully read
      if (t == 0 && kb + g.raws < nk) {
        fence_proxy_async();
        mbar_expect_tx(&rawfull[r], kI8Tile);
        tma_load_3d(raw + r * kI8Tile, tm_w, &rawfull[r], col0, 128 * (kb + g.raws), expert_z());
      }
      if (++s == g.stages) {
        s = 0;
        ph ^= 1u;
      }
    }
    return;
  }
  // the masked path: every thread loads its share of each tile
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = 128 * kb;
    mbar_wait(&empty[s], ph ^ 1u);
    load_tile(xs + s * kI8Tile, expert_x(g), g.B, g.K, row0, k0, kXRows, t);
    if (TW) {
      load_tile(ws + s * kI8Tile, expert_w(g), g.M, g.K, col0, k0, 128, t);
    } else {
      load_tile(raw, expert_w(g), g.K, g.M, k0, col0, 128, t);
      named_sync(1, 128);
      transpose_tile(ws + s * kI8Tile, raw, t);
    }
    fence_proxy_async();
    mbar_arrive(&full[s]);
    if (!TW) named_sync(1, 128);             // the raw tile is free again
    if (++s == g.stages) {
      s = 0;
      ph ^= 1u;
    }
  }
}

// v = x's values at k = c .. c + 7 of one row (K of them), zeros past K:
// one or two 16-byte loads where `vec` (then K % 8 == 0, so c < K means the
// whole 8 lie inside), else one value at a time
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ row, int c, int K, bool vec,
                                      float (&v)[8]) {
  if (vec && c < K) {
    if constexpr (std::is_same<T, float>::value) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(row + c));
      const float4 b = __ldg(reinterpret_cast<const float4*>(row + c + 4));
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + c));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {             // a bf16 is the top half of its f32
        v[2 * e] = __uint_as_float(w[e] << 16);
        v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = c + e < K ? to_f32(row[c + e]) : 0.f;
}

// the fused decode form, before the roles split: the absmax of each of the
// block's kI8SwapRows rows of x over K (every warp of the block, a row at a
// time) and its 127 / absmax; rows past B get the floor (never stored)
template <typename T>
__device__ void swap_absmax(const I8Gemm& g, float* samax, float* sinv) {
  const T* x = expert_xf<T>(g);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kI8SwapRows; r += kI8Threads / 32) {
    float m = 0.f;
    if (r < g.B) {
      const T* row = x + static_cast<size_t>(r) * g.K;
      for (int c = 8 * lane; c < g.K; c += 8 * 32) {
        float v[8];
        load8<T>(row, c, g.K, g.xvec, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
      }
    }
    m = warp_max(m);
    if (lane == 0) {
      const float a = fmaxf(m, kEps);
      samax[r] = a;
      sinv[r] = __fdiv_rn(kQmax, a);
    }
  }
}

// the fused decode form's B tile of one stage: x's rows quantized at k =
// k0 .. k0 + 127; thread t (of 128) writes row t / 8, bytes 16 (t % 8) ..
// + 15, one 16-byte store at their swizzled place (zeros past B and K)
template <typename T>
__device__ __forceinline__ void quantize_stage(uint8_t* dst, const I8Gemm& g, const float* sinv,
                                               int k0, int t) {
  const int r = t >> 3, ch = t & 7, k = k0 + 16 * ch;
  uint32_t q[4] = {0u, 0u, 0u, 0u};
  if (r < g.B && k < g.K) {
    const T* row = expert_xf<T>(g) + static_cast<size_t>(r) * g.K;
    const float inv = sinv[r];
    float v[2][8];
    load8<T>(row, k, g.K, g.xvec, v[0]);
    load8<T>(row, k + 8, g.K, g.xvec, v[1]);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      q[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(quantize(v[e >> 3][e & 7], inv)))
                   << (8 * (e & 3));
  }
  *reinterpret_cast<uint4*>(dst + sw128(r * 128 + ch * 16)) = make_uint4(q[0], q[1], q[2], q[3]);
}

// the fused decode form: W's first tiles of the block's steps kb0 .. kb0 +
// n - 1, issued by the thread that made the barriers before the absmax pass
// (the dgrad's straight into the first `stages` stages; the forward's into
// the raw ring)
template <bool TW>
__device__ void i8_prefetch_w(const I8Gemm& g, const CUtensorMap* tm_w, uint8_t* ws, uint8_t* raw,
                              uint64_t* full, uint64_t* rawfull, int col0, int kb0, int n) {
  if (TW) {
    for (int i = 0; i < min(g.stages, n); ++i) {
      mbar_expect_tx(&full[i], kI8Tile);
      tma_load_3d(ws + i * kI8Tile, tm_w, &full[i], 128 * (kb0 + i), col0, expert_z());
    }
  } else {
    for (int i = 0; i < min(g.raws, n); ++i) {
      mbar_expect_tx(&rawfull[i], kI8Tile);
      tma_load_3d(raw + i * kI8Tile, tm_w, &rawfull[i], col0, 128 * (kb0 + i), expert_z());
    }
  }
}

// the fused decode form's producer warpgroup: per 128-byte step of K (the
// block's n steps from kb0), x's quantized rows (all 128 threads) and W's
// K-major tile as i8_produce brings it; the stage's full barrier counts the
// 128 threads (and, for the dgrad's TMA, the issuer's expect_tx)
template <typename T, bool TW>
__device__ void i8_produce_qx(const I8Gemm& g, const CUtensorMap* tm_w, uint8_t* xs, uint8_t* ws,
                              uint8_t* raw, uint64_t* full, uint64_t* empty, uint64_t* rawfull,
                              const float* sinv, int col0, int kb0, int n) {
  const int t = threadIdx.x;
  int s = 0;
  uint32_t ph = 0;
  for (int i = 0; i < n; ++i) {
    const int k0 = 128 * (kb0 + i);
    mbar_wait(&empty[s], ph ^ 1u);
    if (TW && g.tma && i >= g.stages && t == 0) {
      mbar_expect_tx(&full[s], kI8Tile);
      tma_load_3d(ws + s * kI8Tile, tm_w, &full[s], k0, col0, expert_z());
    }
    quantize_stage<T>(xs + s * kI8Tile, g, sinv, k0, t);
    if (TW) {
      if (!g.tma) load_tile(ws + s * kI8Tile, expert_w(g), g.M, g.K, col0, k0, 128, t);
    } else if (g.tma) {
      const int r = i % g.raws;
      mbar_wait(&rawfull[r], (i / g.raws) & 1u);
      transpose_tile(ws + s * kI8Tile, raw + r * kI8Tile, t);
    } else {
      load_tile(raw, expert_w(g), g.K, g.M, k0, col0, 128, t);
      named_sync(1, 128);
      transpose_tile(ws + s * kI8Tile, raw, t);
    }
    fence_proxy_async();
    mbar_arrive(&full[s]);
    if (!TW) {
      named_sync(1, 128);                    // the raw tile is free again
      const int r = i % g.raws;
      if (g.tma && t == 0 && i + g.raws < n) {
        fence_proxy_async();
        mbar_expect_tx(&rawfull[r], kI8Tile);
        tma_load_3d(raw + r * kI8Tile, tm_w, &rawfull[r], col0, k0 + 128 * g.raws, expert_z());
      }
    }
    if (++s == g.stages) {
      s = 0;
      ph ^= 1u;
    }
  }
}

// y[0] = v0 and, with `both`, y[1] = v1, each rounded once; one paired
// store where the row's pitch keeps pairs aligned
template <typename T>
__device__ __forceinline__ void store2(T* y, float v0, float v1, bool both, bool pairs) {
  if (both && pairs) {
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  y[0] = from_f32<T>(v0);
  if (both) y[1] = from_f32<T>(v1);
}

// a consumer warpgroup (cw = 0 or 1): A's rows 64 cw .. + 63 of the tile
// (x rows; W's rows, the output columns, when SWAP), the block's n stages
// chained into one s32 fragment; then the epilogue. Row b's scale:
// row_scale[b] (QX: the block's own absmax, samax[b]), times __fdiv_rn(s_w,
// 16129) for the fused pair, rounded once. QX with K split over the
// blocks of a column tile: each adds its sums into g.split (s32 adds,
// exact in any order) and takes a ticket; the last stores the tile from
// the whole sums, leaving g.split zero
template <typename T, bool SWAP, bool QX>
__device__ void i8_consume(const I8Gemm& g, const uint8_t* xs, const uint8_t* ws, uint64_t* full,
                           uint64_t* empty, const float* samax, int* sflag, int row0, int col0,
                           int cw, int n) {
  constexpr int N = SWAP ? kI8SwapRows : 128;
  const int t = threadIdx.x - 128 * (1 + cw);
  const int warp = t >> 5, lane = t & 31;
  const int a0 = (SWAP ? col0 : row0) + 64 * cw;           // first row of A
  const bool live = a0 < (SWAP ? g.M : g.B);
  const int f_lo = a0 + 16 * warp + (lane >> 2), f_hi = f_lo + 8;   // the fragment's rows
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  int s = 0, prev = 0;
  uint32_t ph = 0;
  for (int kb = 0; kb < n; ++kb) {
    mbar_wait(&full[s], ph);
    if (live) {
      const uint8_t* a = SWAP ? ws + s * kI8Tile + cw * 64 * 128 : xs + s * kI8Tile + cw * 64 * 128;
      const uint8_t* b = SWAP ? xs + s * kI8Tile : ws + s * kI8Tile;
      const uint64_t da = sw128_desc(smem_u32(a)), db = sw128_desc(smem_u32(b));
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_s8<N>(acc, desc_advance(da, 32 * j), desc_advance(db, 32 * j), 1);
      wgmma_commit();
      wgmma_wait<1>();                       // the previous stage's steps are done
      fence_frag(acc);
    }
    if (kb > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = s;
    if (++s == g.stages) {
      s = 0;
      ph ^= 1u;
    }
  }
  if (live) {
    wgmma_wait0();
    fence_frag(acc);
  }
  if constexpr (QX) {
    if (g.splits > 1) {
      // (QX is the swapped form: fragment rows are output columns m, its
      // columns the x rows)
      int* sums = g.split + expert() * (kI8SwapRows * g.M + gridDim.x);
      int* ticket = sums + kI8SwapRows * g.M + blockIdx.x;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int m = ((i >> 1) & 1) ? f_hi : f_lo, r = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (live && m < g.M && r < g.B) atomicAdd(&sums[r * g.M + m], acc[i]);
      }
      __threadfence();
      named_sync(2, 256);                      // both consumer warpgroups' sums are in
      if (t == 0 && cw == 0) *sflag = atomicAdd(ticket, 1) == g.splits - 1;
      named_sync(2, 256);
      if (!*sflag) return;
      __threadfence();
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int m = ((i >> 1) & 1) ? f_hi : f_lo, r = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (live && m < g.M && r < g.B) acc[i] = atomicExch(&sums[r * g.M + m], 0);
      }
      if (t == 0 && cw == 0) *ticket = 0;
    }
  }
  if (!live) return;
  T* y = static_cast<T*>(g.y) + expert() * g.B * g.M;
  const float sw = g.s_w ? __fdiv_rn(g.s_w[expert()], kQmax2) : 0.f;
  auto row_scale = [&](int b) {
    const float rs = QX ? samax[b] : g.row_scale[expert() * g.B + b];
    return g.s_w ? __fmul_rn(rs, sw) : rs;
  };
  if (SWAP) {
    // fragment rows are output columns m, its columns the x rows
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int m = ((i >> 1) & 1) ? f_hi : f_lo, r = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (m >= g.M || r >= g.B) continue;
      const float rs = row_scale(r);
      const float scale = g.col_scale ? __fmul_rn(rs, g.col_scale[m]) : rs;
      y[static_cast<size_t>(r) * g.M + m] = from_f32<T>(__fmul_rn(__int2float_rn(acc[i]), scale));
    }
    return;
  }
  const float rs_lo = f_lo < g.B ? row_scale(f_lo) : 0.f;
  const float rs_hi = f_hi < g.B ? row_scale(f_hi) : 0.f;
  const int c_base = col0 + 2 * (lane & 3);
  const bool pairs = (g.M & 1) == 0;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const bool hi = (i >> 1) & 1;
    const int row = hi ? f_hi : f_lo, col = c_base + 8 * (i >> 2);
    if (row >= g.B || col >= g.M) continue;
    const float rs = hi ? rs_hi : rs_lo;
    const bool both = col + 1 < g.M;
    const float s0 = g.col_scale ? __fmul_rn(rs, g.col_scale[col]) : rs;
    const float s1 = g.col_scale && both ? __fmul_rn(rs, g.col_scale[col + 1]) : rs;
    const float v0 = __fmul_rn(__int2float_rn(acc[i]), s0);
    const float v1 = __fmul_rn(__int2float_rn(acc[i + 1]), s1);
    store2<T>(y + static_cast<size_t>(row) * g.M + col, v0, v1, both, pairs);
  }
}

// one block of the GEMM; QX: the fused decode form (x's rows quantized in
// the block, SWAP only)
template <typename T, bool TW, bool SWAP, bool QX>
__device__ __forceinline__ void i8_gemm(uint8_t* smem_raw, const CUtensorMap* tm_x,
                                        const CUtensorMap* tm_w, const I8Gemm& g) {
  static_assert(!QX || SWAP, "x is quantized in the block only in the swapped form");
  uint8_t* xs = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);   // [stage]
  uint8_t* ws = xs + g.stages * kI8Tile;                                       // [stage]
  uint8_t* raw = ws + g.stages * kI8Tile;                                      // [raws]
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + g.raws * kI8Tile);
  uint64_t* empty = full + kI8MaxStages;
  uint64_t* rawfull = empty + kI8MaxStages;
  float* samax = reinterpret_cast<float*>(rawfull + kI8MaxRaws);               // [kI8SwapRows]
  float* sinv = samax + kI8SwapRows;
  int* sflag = reinterpret_cast<int*>(sinv + kI8SwapRows);
  const int row0 = SWAP ? 0 : blockIdx.y * 128, col0 = blockIdx.x * 128;
  // the block's 128-byte steps of K: QX, the blockIdx.y-th range of g.per
  const int nk = (g.K + 127) / 128;
  const int kb0 = QX ? blockIdx.y * g.per : 0, n = QX ? min(nk, kb0 + g.per) - kb0 : nk;
  if (threadIdx.x == 0) {
    // full: TMA's bytes with its issuer's arrival, and on the forward the
    // 128 transposing threads'; the masked path's 128 producer threads;
    // QX: the 128 quantizing threads, and the dgrad's TMA issuer;
    // empty: the 8 consumer warps
    const uint32_t n_full =
        QX ? 128u + (g.tma && TW ? 1u : 0u) : (g.tma ? (TW ? 1u : 129u) : 128u);
    for (int i = 0; i < g.stages; ++i) {
      mbar_init(&full[i], n_full);
      mbar_init(&empty[i], 8);
    }
    for (int i = 0; i < g.raws; ++i) mbar_init(&rawfull[i], 1);
    mbar_init_fence();
    if constexpr (QX)
      if (g.tma) i8_prefetch_w<TW>(g, tm_w, ws, raw, full, rawfull, col0, kb0, n);
  }
  if constexpr (QX) swap_absmax<T>(g, samax, sinv);
  __syncthreads();
  if (threadIdx.x < 128) {
    if constexpr (QX)
      i8_produce_qx<T, TW>(g, tm_w, xs, ws, raw, full, empty, rawfull, sinv, col0, kb0, n);
    else
      i8_produce<TW, SWAP>(g, tm_x, tm_w, xs, ws, raw, full, empty, rawfull, row0, col0);
  } else {
    i8_consume<T, SWAP, QX>(g, xs, ws, full, empty, samax, sflag, row0, col0,
                            threadIdx.x / 128 - 1, n);
  }
}

template <typename T, bool TW, bool SWAP>
__global__ void __launch_bounds__(kI8Threads, 1)
int8_matmul_kernel(__grid_constant__ const CUtensorMap tm_x, __grid_constant__ const CUtensorMap tm_w,
                   const I8Gemm g) {
  extern __shared__ uint8_t smem_raw[];
  i8_gemm<T, TW, SWAP, false>(smem_raw, &tm_x, &tm_w, g);
}

// the fused pair's GEMM: SWAP quantizes x in the block (one launch); else
// x_q and its absmax come from fused_quantize_kernel's workspace
template <typename T, bool TW, bool SWAP>
__global__ void __launch_bounds__(kI8Threads, 1)
fused_switchback_kernel(__grid_constant__ const CUtensorMap tm_x,
                        __grid_constant__ const CUtensorMap tm_w, const I8Gemm g) {
  extern __shared__ uint8_t smem_raw[];
  i8_gemm<T, TW, SWAP, SWAP>(smem_raw, &tm_x, &tm_w, g);
}

// FUSED: launch fused_switchback_kernel (g.s_w set; SWAP: g.xf, else g.x
// and g.row_scale the workspace), else int8_matmul_kernel
template <typename T, bool TW, bool SWAP, bool FUSED>
int launch_i8(I8Gemm g, int E, cudaStream_t st) {
  constexpr bool QX = FUSED && SWAP;
  // the TMA path: 16-byte row pitches and base addresses (QX: W's alone)
  const bool w_ok = (TW ? g.K % 16 == 0 : g.M % 16 == 0) && aligned16(g.w);
  g.tma = g.K > 0 && w_ok && (QX || (g.K % 16 == 0 && aligned16(g.x)));
  g.xvec = QX && g.K % 8 == 0 && aligned16(g.xf);
  g.stages = TW ? kI8MaxStages : 4;
  g.raws = TW ? 0 : (g.tma ? kI8MaxRaws : 1);
  const int nk = (g.K + 127) / 128, tiles = (g.M + 127) / 128;
  g.splits = 1;
  g.per = nk;
  if (QX && g.split) {
    // K split so that the column tiles' blocks about fill the card once
    static int sms = 0;
    if (!sms) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const int want = std::max(1, std::min(nk, sms / (tiles * E)));
    g.per = std::max(1, (nk + want - 1) / want);
    g.splits = std::max(1, (nk + g.per - 1) / g.per);
  }
  CUtensorMap mx, mw;
  memset(&mx, 0, sizeof(mx));
  memset(&mw, 0, sizeof(mw));
  if (g.tma &&
      !((QX || tma_map_3d(&mx, g.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, E, g.B, g.K, 128,
                          SWAP ? kI8SwapRows : 128)) &&
        (TW ? tma_map_3d(&mw, g.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, E, g.M, g.K, 128, 128)
            : tma_map_3d(&mw, g.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, E, g.K, g.M, 128, 128))))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = i8_smem_bytes(g.stages, g.raws);
  const int most = static_cast<int>(i8_smem_bytes(g.stages, TW ? 0 : kI8MaxRaws));
  static bool opted = false;          // the largest configuration, once per instantiation
  if (!opted) {
    cudaError_t err;
    if constexpr (FUSED)
      err = cudaFuncSetAttribute(fused_switchback_kernel<T, TW, SWAP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    else
      err = cudaFuncSetAttribute(int8_matmul_kernel<T, TW, SWAP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const dim3 grid(tiles, SWAP ? g.splits : (g.B + 127) / 128, E);
  if constexpr (FUSED)
    fused_switchback_kernel<T, TW, SWAP><<<grid, kI8Threads, bytes, st>>>(mx, mw, g);
  else
    int8_matmul_kernel<T, TW, SWAP><<<grid, kI8Threads, bytes, st>>>(mx, mw, g);
  return static_cast<int>(cudaGetLastError());
}

// decode (B <= kI8SwapRows) swaps the operands (see int8_matmul_kernel)
template <typename T, bool TW>
int launch_matmul(const void* x_q, const void* w_q, const void* row_scale, const void* col_scale,
                  void* y, int B, int K, int M, cudaStream_t st) {
  I8Gemm g;
  memset(&g, 0, sizeof(g));
  g.x = static_cast<const int8_t*>(x_q);
  g.w = static_cast<const int8_t*>(w_q);
  g.row_scale = static_cast<const float*>(row_scale);
  g.col_scale = static_cast<const float*>(col_scale);
  g.y = y;
  g.B = B;
  g.K = K;
  g.M = M;
  return B <= kI8SwapRows ? launch_i8<T, TW, true, false>(g, 1, st)
                          : launch_i8<T, TW, false, false>(g, 1, st);
}

// the fused pair on E experts (E = 1: the 2-D form): at <= kI8SwapRows rows
// an expert one launch (x quantized in the block; with `split`, K split over
// the blocks of a column tile); above, fused_quantize_kernel (launch_rows,
// over all E B rows) into the workspace x_q (E, B, K) int8 and absmax (E, B)
// f32, then the GEMM on them
template <typename T, bool TW>
int launch_fused(const void* x, const void* w_q, const void* s_w, void* y, void* x_q,
                 void* absmax, void* split, int E, int B, int K, int M, cudaStream_t st) {
  I8Gemm g;
  memset(&g, 0, sizeof(g));
  g.w = static_cast<const int8_t*>(w_q);
  g.s_w = static_cast<const float*>(s_w);
  g.y = y;
  g.B = B;
  g.K = K;
  g.M = M;
  if (B <= kI8SwapRows) {
    g.xf = x;
    g.split = static_cast<int*>(split);
    return launch_i8<T, TW, true, true>(g, E, st);
  }
  if (!x_q || !absmax) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_rows<T>(TW ? kFusedDgrad : kFusedFwd, x, x_q, absmax, E * B, K, st);
  if (err != cudaSuccess) return err;
  g.x = static_cast<const int8_t*>(x_q);
  g.row_scale = static_cast<const float*>(absmax);
  return launch_i8<T, TW, false, true>(g, E, st);
}


// ---------------------------------------------------------------------------
// wgrad_bf16: dw (K, M) f32 = x^T g, x (B, K) and g (B, M) bf16, contracted
// over the B rows (batch x sequence). Replaces the Pallas TPU kernel
// wgrad_bf16 (repro/kernels/switchback/switchback.py:364, body :348), the
// 16-bit matmul SwitchBack keeps for the weight gradient. No serve or train
// path launches it: the training path's Ẇ is one cuBLAS GEMM
// (core/switchback.wgrad_16bit), as the JAX package's is XLA's dot_general.
//
// What bounds it on an H100: operations, 2 B K M of them at bf16's
// tensor-core peak (989 TFLOP/s): 164 us for one CLIP vision layer's four
// weight gradients at 4,128 rows (1.62e11), whose bytes take 35 us. It runs
// on bf16 wgmma (kernels/csrc/wgmma.cuh), in the fp8 GEMMs' shape:
//   * a block owns a 128 x 128 tile of dw: two consumer warpgroups of 64
//     rows (x's columns) each and one producer warpgroup. Both operands
//     contract over their outer dimension (x (B, K) is K-contiguous, g (B, M)
//     M-contiguous), which bf16 wgmma reads as it lies: MN-major tiles
//     (tnspA = tnspB = 1), so nothing is transposed anywhere. The producer
//     fills a ring of up to 6 stages, each 64 rows of B of x's and g's 128
//     columns (two 64-column boxes each, 128-byte swizzled), by TMA with an
//     mbarrier per stage. A shape TMA refuses (a row pitch off 16 bytes: the
//     patch embedding's 588 columns) takes the masked path of the same
//     kernel: the producer warpgroup loads each stage itself, zeros past
//     the matrix. Rows past B arrive as zeros on both paths.
//   * per stage each consumer chains four m64n128k16 steps into a fresh
//     fragment (one window of WINDOW = 64 rows of B) and adds it on the
//     CUDA cores into its f32 accumulator, windows in B order (the
//     promotion): a step keeps 25 bits of each addend below the largest
//     exponent and 24 significant bits of its sum (truncated), so promoting
//     every 64 rows bounds what the chain drops.
//   * no split of B, no atomics: two launches give the same bits.
// The tensor cores change the order of each window's sum and truncate
// inside it, so the kernel and the in-order plain version (ref.py) agree to
// ref.wgrad_bound per output, bit for bit on inputs whose sums are exact
// (ref.py's exact entries), and kernels/fp8_matmul/wgmma_model.wgrad_rows
// (the steps' truncations chained over the windows) gives its bits on any
// input.
// ---------------------------------------------------------------------------
constexpr int kWgBM = 128;                  // rows of dw per block (two warpgroups of 64)
constexpr int kWgBN = 128;                  // columns of dw per block
constexpr int kWgWindow = 64;               // rows of B per stage: one window, 4 k16 steps
constexpr int kWgBox = 64 * kWgWindow * 2;  // bytes of a 64-column box of one stage: 8,192
constexpr int kWgTile = 2 * kWgBox;         // one operand's 128 columns of a stage
constexpr int kWgThreads = 384;             // producer warpgroup + two consumer warpgroups
constexpr int kWgMaxStages = 6;
constexpr int kWgSmemMax = 232448;          // dynamic shared memory a block may use

struct Wgrad {
  const __nv_bfloat16* x;  // (B, K)
  const __nv_bfloat16* g;  // (B, M)
  float* dw;               // (K, M)
  int B, K, M;
  int tma, stages;         // set by the launcher
};

size_t wgrad_smem_bytes(int stages) {
  return 1024 + 2 * static_cast<size_t>(stages) * kWgTile + 2 * kWgMaxStages * sizeof(uint64_t);
}

// the masked path: rows [b0, b0 + kWgWindow) x columns [c0, c0 + 128) of an
// (R, C) bf16 matrix into two swizzled 64-column boxes, zeros outside (one
// 16-byte chunk, 8 columns of one row, per step)
__device__ void load_mn(uint8_t* dst, const __nv_bfloat16* __restrict__ src, int R, int C,
                        int b0, int c0, int t) {
  for (int c = t; c < kWgWindow * 16; c += 128) {
    const int r = c >> 4, h = (c >> 3) & 1, ch = c & 7, row = b0 + r;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (row < R) {
      const __nv_bfloat16* p = src + static_cast<size_t>(row) * C;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = c0 + 64 * h + 8 * ch + e;
        if (col < C) v[e >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(p[col])) << (16 * (e & 1));
      }
    }
    *reinterpret_cast<uint4*>(dst + h * kWgBox + sw128(r * 128 + ch * 16)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
wgrad_bf16_kernel(__grid_constant__ const CUtensorMap tm_x, __grid_constant__ const CUtensorMap tm_g,
                  const Wgrad w) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* sa = base;                                   // x: [stage][2 boxes]
  uint8_t* sb = base + w.stages * kWgTile;              // g: [stage][2 boxes]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + w.stages * kWgTile);
  uint64_t* empty = full + kWgMaxStages;
  const int row0 = blockIdx.y * kWgBM, col0 = blockIdx.x * kWgBN;
  const int nk = (w.B + kWgWindow - 1) / kWgWindow;
  if (threadIdx.x == 0) {
    // full: the TMA bytes and their issuer's arrival, or the 128 producer
    // threads' arrivals on the masked path; empty: the 8 consumer warps
    for (int i = 0; i < w.stages; ++i) {
      mbar_init(&full[i], w.tma ? 1u : 128u);
      mbar_init(&empty[i], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    // the producer warpgroup: stage s for each window in B order
    regs_dec<56>();
    const int t = threadIdx.x;
    if (w.tma && t >= 32) return;
    int s = 0;
    uint32_t ph = 0;
    for (int kb = 0; kb < nk; ++kb) {
      const int b0 = kb * kWgWindow;
      uint8_t* a = sa + s * kWgTile;
      uint8_t* b = sb + s * kWgTile;
      mbar_wait(&empty[s], ph ^ 1u);
      if (w.tma) {
        if (t == 0) {
          // a box wholly past K or M is not loaded: its warpgroup idles, or
          // its columns of the fragment are never stored
          const bool a2 = row0 + 64 < w.K, b2 = col0 + 64 < w.M;
          mbar_expect_tx(&full[s], (2 + a2 + b2) * kWgBox);
          tma_load_2d(a, &tm_x, &full[s], row0, b0);
          if (a2) tma_load_2d(a + kWgBox, &tm_x, &full[s], row0 + 64, b0);
          tma_load_2d(b, &tm_g, &full[s], col0, b0);
          if (b2) tma_load_2d(b + kWgBox, &tm_g, &full[s], col0 + 64, b0);
        }
      } else {
        load_mn(a, w.x, w.B, w.K, b0, row0, t);
        load_mn(b, w.g, w.B, w.M, b0, col0, t);
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
      if (++s == w.stages) {
        s = 0;
        ph ^= 1u;
      }
    }
    return;
  }
  // a consumer warpgroup (cw = 0 or 1): rows row0 + 64 cw .. + 63 of dw
  regs_inc<224>();
  const int cw = threadIdx.x / 128 - 1, t = threadIdx.x - 128 * (1 + cw);
  const int warp = t >> 5, lane = t & 31;
  const int wrow0 = row0 + 64 * cw;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int s = 0;
  uint32_t ph = 0;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(&full[s], ph);
    if (wrow0 < w.K) {
      const uint64_t da = sw128_mn_desc(smem_u32(sa + s * kWgTile + cw * kWgBox), kWgBox);
      const uint64_t db = sw128_mn_desc(smem_u32(sb + s * kWgTile), kWgBox);
      wgmma_fence();
      fence_frag(part);
#pragma unroll
      for (int j = 0; j < kWgWindow / 16; ++j)
        wgmma_m64n128k16_bf16<1>(part, desc_advance(da, 2048 * j), desc_advance(db, 2048 * j), j);
      wgmma_commit();
      wgmma_wait0();
      fence_frag(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == w.stages) {
      s = 0;
      ph ^= 1u;
    }
  }
  // epilogue: the accumulator as it is, f32
  const int r_lo = wrow0 + 16 * warp + (lane >> 2), r_hi = r_lo + 8;
  const bool pairs = (w.M & 1) == 0;
  const int c_base = col0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = ((i >> 1) & 1) ? r_hi : r_lo, col = c_base + 8 * (i >> 2);
    if (row >= w.K || col >= w.M) continue;
    float* y = w.dw + static_cast<size_t>(row) * w.M + col;
    if (pairs && col + 1 < w.M) {
      *reinterpret_cast<float2*>(y) = make_float2(acc[i], acc[i + 1]);
    } else {
      y[0] = acc[i];
      if (col + 1 < w.M) y[1] = acc[i + 1];
    }
  }
}

int launch_wgrad(Wgrad w, cudaStream_t st) {
  // the TMA path: 16-byte row pitches and base addresses
  w.tma = w.B > 0 && w.K % 8 == 0 && w.M % 8 == 0 && aligned16(w.x) && aligned16(w.g);
  CUtensorMap mx, mg;
  memset(&mx, 0, sizeof(mx));
  memset(&mg, 0, sizeof(mg));
  if (w.tma && !(tma_map_2d(&mx, w.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w.B, w.K, 64,
                            kWgWindow) &&
                 tma_map_2d(&mg, w.g, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w.B, w.M, 64,
                            kWgWindow)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t fixed = wgrad_smem_bytes(0), per = wgrad_smem_bytes(1) - fixed;
  w.stages = static_cast<int>(std::min<size_t>(kWgMaxStages, (kWgSmemMax - fixed) / per));
  const size_t bytes = wgrad_smem_bytes(w.stages);
  cudaFuncSetAttribute(wgrad_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  dim3 grid((w.M + kWgBN - 1) / kWgBN, (w.K + kWgBM - 1) / kWgBM);
  wgrad_bf16_kernel<<<grid, kWgThreads, bytes, st>>>(mx, mg, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. `bf16` selects __nv_bfloat16 (1) or float (0) for the
// floating-point input / output; every pointer is a device pointer.
// ---------------------------------------------------------------------------
extern "C" {

int sb_row_quantize(const void* x, int bf16, void* q, void* s, int B, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_rows<__nv_bfloat16>(kRowQuantize, x, q, s, B, K, st)
              : launch_rows<float>(kRowQuantize, x, q, s, B, K, st);
}

int sb_col_quantize(const void* x, int bf16, void* q, void* s, int R, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_cols<__nv_bfloat16>(x, q, s, R, C, st)
              : launch_cols<float>(x, q, s, R, C, st);
}

// partial: scratch of tq::kMaxPartials floats; bar: the two-word barrier
// workspace, zero and left zero (see tensor_absmax.cuh)
int sb_tensor_quantize(const void* x, int bf16, int64_t n, void* partial, void* bar, void* q,
                       void* s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? tq::run<__nv_bfloat16, Int8Kernels>(x, q, s, partial, bar, n, 0, -1, st)
              : tq::run<float, Int8Kernels>(x, q, s, partial, bar, n, 0, -1, st);
}

// the control fault of the checks: block `drop`'s partial left out of the
// absmax (not a path's entry point)
int sb_tensor_quantize_drop(const void* x, int bf16, int64_t n, void* partial, void* bar, void* q,
                            void* s, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? tq::run<__nv_bfloat16, Int8Kernels>(x, q, s, partial, bar, n, 0, drop, st)
              : tq::run<float, Int8Kernels>(x, q, s, partial, bar, n, 0, drop, st);
}

// the expert-batched form: x (E, n) -> q (E, n) int8, s (E,) f32, one
// absmax an expert, in two passes; partial: E x tq::kBatchedPartials floats
// of scratch (see tensor_absmax.cuh)
int sb_tensor_quantize_batched(const void* x, int bf16, int64_t n, int E, void* partial, void* q,
                               void* s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? tq::run_batched<__nv_bfloat16, Int8Kernels>(x, q, s, partial, n, E, 0, st)
              : tq::run_batched<float, Int8Kernels>(x, q, s, partial, n, E, 0, st);
}

// out (5,) host ints: the plan tensor_quantize takes for these pointers and n
int sb_tensor_quantize_plan(const void* x, int bf16, const void* q, int64_t n, int* out) {
  return bf16 ? tq::plan<__nv_bfloat16, Int8Kernels>(x, q, n, out)
              : tq::plan<float, Int8Kernels>(x, q, n, out);
}

// x_q (B, K) int8 and absmax (B,) f32: the wrapper's workspace above 16
// rows (null at <= 16); split: at <= 16 rows, int32 (16 M + ceil(M / 128)),
// zero and left zero (the K-split sums and tickets; null: no split)
int sb_fused_switchback_fwd(const void* x, int bf16, const void* w_q, const void* s_w, void* y,
                            void* x_q, void* absmax, void* split, int B, int K, int M,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return static_cast<int>(cudaGetLastError());
  return bf16
             ? launch_fused<__nv_bfloat16, false>(x, w_q, s_w, y, x_q, absmax, split, 1, B, K, M, st)
             : launch_fused<float, false>(x, w_q, s_w, y, x_q, absmax, split, 1, B, K, M, st);
}

// col_scale (M,) f32, or null for the row-scale epilogue alone; on int8
// wgmma (int8_matmul_kernel).
int sb_int8_matmul_dequant(const void* x_q, const void* w_q, const void* row_scale,
                           const void* col_scale, void* y, int bf16, int B, int K, int M,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return static_cast<int>(cudaGetLastError());
  return bf16 ? launch_matmul<__nv_bfloat16, false>(x_q, w_q, row_scale, col_scale, y, B, K, M, st)
              : launch_matmul<float, false>(x_q, w_q, row_scale, col_scale, y, B, K, M, st);
}

// g (B, K) float/bf16, w_q (N, K) int8 (the forward's weight; K is its
// output width), s_w (1,) f32 -> dx (B, N) in g's type; g_q (B, K) int8,
// absmax (B,) f32 and split (16 N + ceil(N / 128)) int32 the workspace, as
// for the forward.
int sb_fused_switchback_dgrad(const void* g, int bf16, const void* w_q, const void* s_w,
                              void* dx, void* g_q, void* absmax, void* split, int B, int K,
                              int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  return bf16
             ? launch_fused<__nv_bfloat16, true>(g, w_q, s_w, dx, g_q, absmax, split, 1, B, K, N, st)
             : launch_fused<float, true>(g, w_q, s_w, dx, g_q, absmax, split, 1, B, K, N, st);
}

// The expert-batched fused pair: E experts' 2-D calls in one wrapper
// launch, each expert's operands one after another: x (E, B, K), w_q (E, K,
// M) (the dgrad's (E, M, K)), s_w (E,), y (E, B, M); the workspaces E deep
// (x_q (E, B, K), absmax (E, B); split E x (16 M + ceil(M / 128))).
int sb_fused_switchback_fwd_batched(const void* x, int bf16, const void* w_q, const void* s_w,
                                    void* y, void* x_q, void* absmax, void* split, int E, int B,
                                    int K, int M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || B <= 0 || M <= 0) return static_cast<int>(cudaGetLastError());
  return bf16
             ? launch_fused<__nv_bfloat16, false>(x, w_q, s_w, y, x_q, absmax, split, E, B, K, M, st)
             : launch_fused<float, false>(x, w_q, s_w, y, x_q, absmax, split, E, B, K, M, st);
}

int sb_fused_switchback_dgrad_batched(const void* g, int bf16, const void* w_q, const void* s_w,
                                      void* dx, void* g_q, void* absmax, void* split, int E, int B,
                                      int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  return bf16
             ? launch_fused<__nv_bfloat16, true>(g, w_q, s_w, dx, g_q, absmax, split, E, B, K, N, st)
             : launch_fused<float, true>(g, w_q, s_w, dx, g_q, absmax, split, E, B, K, N, st);
}

// x_q (B, K) int8, w_q (M, K) int8, row_scale (B,) f32, col_scale (M,) f32
// or null -> y (B, M) = f32(x_q . w_q^T) * row_scale[b] [* col_scale[m]].
int sb_int8_matmul_dequant_t(const void* x_q, const void* w_q, const void* row_scale,
                             const void* col_scale, void* y, int bf16, int B, int K, int M,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return static_cast<int>(cudaGetLastError());
  return bf16 ? launch_matmul<__nv_bfloat16, true>(x_q, w_q, row_scale, col_scale, y, B, K, M, st)
              : launch_matmul<float, true>(x_q, w_q, row_scale, col_scale, y, B, K, M, st);
}

// x (B, K) bf16, g (B, M) bf16 -> dw (K, M) f32 = x^T g on bf16 wgmma,
// windows of 64 rows promoted in B order (see wgrad_bf16_kernel).
int sb_wgrad_bf16(const void* x, const void* g, void* dw, int B, int K, int M, void* stream) {
  if (K <= 0 || M <= 0) return static_cast<int>(cudaGetLastError());
  Wgrad w;
  memset(&w, 0, sizeof(w));
  w.x = static_cast<const __nv_bfloat16*>(x);
  w.g = static_cast<const __nv_bfloat16*>(g);
  w.dw = static_cast<float*>(dw);
  w.B = B;
  w.K = K;
  w.M = M;
  return launch_wgrad(w, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
