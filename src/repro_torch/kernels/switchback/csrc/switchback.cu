// SwitchBack int8 kernels for Hopper (sm_90a), forward and input gradient,
// bound through a plain C interface (loaded with ctypes by
// kernels/switchback/build.py).
//
// Seven entry points, each replacing one Pallas TPU kernel (or one form of
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
//
// The two dgrad forms are the forward kernels with the W tile read the
// other way (template flag TW): dx[b, n] = sum_m g_q[b, m] * w_q[n, m]
// contracts over W's second, contiguous dim, so W (N, M) row-major is
// already K-major for __dp4a and each W tile is staged with plain row
// reads; no w_q^T is written anywhere, as on the TPU, where dot_general
// contracts over any dim pair.
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
//   * the int8 dot accumulates exactly in int32 (__dp4a), so the order of
//     the sum does not matter.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
//
// Bound by bytes (read x, write q). One block owns one row, so the row
// absmax is a block reduction and the second read of the row hits L1/L2.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
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

// ---------------------------------------------------------------------------
// col_quantize: x (R, C) -> q (R, C) int8, s (C,) f32   (paper Eq. 4, the
// per-output-unit weight scales of SwitchBackQ and LLM.int8)
//
// Bound by bytes (read x twice, the second time mostly from L2; write q).
// The TPU kernel gives each grid step whole columns so the column absmax
// stays in one VMEM block. Here a block owns 32 adjacent columns, one per
// lane, and its 8 warps split the rows: a warp reads 32 consecutive
// elements of one row per step (coalesced along the contiguous dim),
// each thread keeps its column's partial max, and the 8 partials meet in
// shared memory (a max, so their order does not matter). Then each thread
// quantizes its column's share of the rows. Ragged column edges are
// masked, nothing is padded.
// ---------------------------------------------------------------------------
constexpr int kColTile = 32;
constexpr int kColRowSplit = kThreads / kColTile;   // 8 warps over the rows

template <typename T>
__global__ void __launch_bounds__(kThreads)
col_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                    int R, int C) {
  __shared__ float part[kColRowSplit][kColTile];
  const int lane = threadIdx.x % kColTile, split = threadIdx.x / kColTile;
  const int c = blockIdx.x * kColTile + lane;
  float m = 0.f;
  if (c < C)
    for (int r = split; r < R; r += kColRowSplit)
      m = fmaxf(m, fabsf(to_f32(x[static_cast<size_t>(r) * C + c])));
  part[split][lane] = m;
  __syncthreads();
  m = 0.f;
#pragma unroll
  for (int i = 0; i < kColRowSplit; ++i) m = fmaxf(m, part[i][lane]);
  if (c >= C) return;
  const float absmax = fmaxf(m, kEps);
  const float scale = __fdiv_rn(kQmax, absmax);
  for (int r = split; r < R; r += kColRowSplit) {
    const size_t i = static_cast<size_t>(r) * C + c;
    q[i] = quantize(to_f32(x[i]), scale);
  }
  if (split == 0) s[c] = absmax;
}

// ---------------------------------------------------------------------------
// tensor_quantize: x (n,) -> q (n,) int8, s (1,) f32   (paper Eq. 2)
//
// Bound by bytes. The TPU kernel carries the max across a sequential grid;
// GPU blocks run in no order, so the reduction takes two launches: each
// block of pass 1 writes its partial max, and each block of pass 2 reduces
// the (at most kMaxPartials) partials itself before casting its share.
// No atomics and no memset, and the result does not depend on block order.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_partial_kernel(const T* __restrict__ x, int64_t n, float* __restrict__ partial) {
  __shared__ float red[32];
  float m = 0.f;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    m = fmaxf(m, fabsf(to_f32(x[i])));
  m = block_max(m, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cast_tensorwise_kernel(const T* __restrict__ x, int64_t n, const float* __restrict__ partial,
                       int n_partial, int8_t* __restrict__ q, float* __restrict__ s) {
  __shared__ float red[32];
  float m = 0.f;
  for (int i = threadIdx.x; i < n_partial; i += blockDim.x) m = fmaxf(m, partial[i]);
  const float absmax = fmaxf(block_max(m, red), kEps);
  const float scale = __fdiv_rn(kQmax, absmax);
  if (blockIdx.x == 0 && threadIdx.x == 0) s[0] = absmax;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    q[i] = quantize(to_f32(x[i]), scale);
}

// ---------------------------------------------------------------------------
// int8 GEMM core shared by fused_switchback_fwd and int8_matmul_dequant.
//
// acc[b, m] = sum_k x_q[b, k] * w_q[k, m], int32, with __dp4a on 4-byte
// groups of k. W is stored (K, M), M-contiguous, as the JAX package keeps
// it; __dp4a needs 4 consecutive k of one column, so each W tile is staged
// transposed in shared memory (ws[n][k]) while it is loaded with coalesced
// reads along M. No w_q^T is ever written to device memory.
//
// A block owns a BM x BN output tile and walks K in BK-byte steps; 256
// threads sit on a 16 x 16 grid and own rows ty + 16 i and columns
// tx + 16 j (strided, so the shared-memory word reads of one warp fall in
// distinct banks: the row pitch is 9 words).
//
// What bounds it on an H100: at decode (8 rows) the int8 weight read, K x M
// bytes at 3.35 TB/s, under a microsecond per linear; at prefill (1024 rows)
// the int8 tensor-core rate. This first kernel reaches neither: __dp4a runs
// on the CUDA cores, not the tensor cores, and at 8 rows the 16 x 32 tiles
// give only 10-80 blocks, each paying a global-load latency per 32-byte K
// step, so it sits about 100x above the decode bound (PERF.md). It is the
// simple, exact version; more blocks at decode (split-K) and wgmma on a
// K-major w_q^T at prefill are the later changes. No TMA, no wgmma.
// ---------------------------------------------------------------------------
constexpr int BK = 32;        // k bytes per shared-memory step
constexpr int LDS = BK + 4;   // padded row pitch in bytes (9 words)

template <int BM, int BN>
struct Tiles {
  alignas(16) int8_t xs[BM][LDS];
  alignas(16) int8_t ws[BN][LDS];
};

// Stage the W tile of output columns [col0, col0 + BN) and contraction
// indices [k0, k0 + BK) as ws[n][kk]. TW = false: w_q is (K, M), read
// along M (coalesced) and written transposed. TW = true: w_q is (M, K) --
// the forward's (N, M) weight seen from the dgrad, whose output columns
// are W's rows -- read along K, which is already the order ws wants.
template <bool TW, int BM, int BN>
__device__ __forceinline__ void load_w_tile(const int8_t* __restrict__ w_q, int K, int M,
                                            int k0, int col0, Tiles<BM, BN>& t) {
  if (TW) {
    for (int idx = threadIdx.x; idx < BK * BN; idx += kThreads) {
      const int n = idx / BK, kk = idx % BK;
      const int k = k0 + kk, c = col0 + n;
      t.ws[n][kk] = (k < K && c < M) ? w_q[static_cast<size_t>(c) * K + k] : int8_t(0);
    }
  } else {
    for (int idx = threadIdx.x; idx < BK * BN; idx += kThreads) {
      const int kk = idx / BN, n = idx % BN;
      const int k = k0 + kk, c = col0 + n;
      t.ws[n][kk] = (k < K && c < M) ? w_q[static_cast<size_t>(k) * M + c] : int8_t(0);
    }
  }
}

template <int BM, int BN>
__device__ __forceinline__ void dot_tile(const Tiles<BM, BN>& t, int (&acc)[BM / 16][BN / 16]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int kw = 0; kw < BK / 4; ++kw) {
    int a[BM / 16], b[BN / 16];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) a[i] = *reinterpret_cast<const int*>(&t.xs[ty + 16 * i][4 * kw]);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) b[j] = *reinterpret_cast<const int*>(&t.ws[tx + 16 * j][4 * kw]);
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// fused_switchback_fwd: x (B, K) float/bf16, w_q (K, M) int8, s_w (1,) f32
//   -> y (B, M) = (x_q . w_q) * (absmax_row * (s_w / 127^2))   (paper Eq. 3)
// fused_switchback_dgrad (TW): g (B, K) float/bf16, w_q (M, K) int8 -- the
//   forward's (N, M) weight, here with K = the layer's output width and M =
//   its input width -- -> dx (B, M) = (g_q . w_q^T) * (absmax_row * (s_w /
//   127^2)), the same arithmetic on the other contraction.
//
// X (or the output gradient) is row-quantized inside the kernel: the block
// first takes the absmax of each of its BM rows over the whole K, then
// quantizes each tile as it stages it into shared memory. It never goes to
// device memory as int8 and no state (B, 1) is written.
//
// What bounds the dgrad on an H100: at the training path's 2048 rows the
// int8 operations, 2 * B * K * M over 1,979 TOPS (a few us per linear);
// this __dp4a kernel on the CUDA cores sits far above that, as the forward
// does at prefill. mma/wgmma int8 on the tensor cores is the later change.
// ---------------------------------------------------------------------------
template <typename T, int BM, int BN, bool TW>
__global__ void __launch_bounds__(kThreads)
fused_fwd_kernel(const T* __restrict__ x, const int8_t* __restrict__ w_q,
                 const float* __restrict__ s_w, T* __restrict__ y, int B, int K, int M) {
  __shared__ Tiles<BM, BN> t;
  __shared__ float amax[BM];
  __shared__ float inv[BM];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int row = row0 + r;
    float m = 0.f;
    if (row < B)
      for (int k = lane; k < K; k += 32) m = fmaxf(m, fabsf(to_f32(x[static_cast<size_t>(row) * K + k])));
    m = warp_max(m);
    if (lane == 0) {
      const float a = fmaxf(m, kEps);
      amax[r] = a;
      inv[r] = __fdiv_rn(kQmax, a);
    }
  }
  __syncthreads();

  int acc[BM / 16][BN / 16] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += kThreads) {
      const int r = idx / BK, kk = idx % BK;
      const int row = row0 + r, k = k0 + kk;
      t.xs[r][kk] = (row < B && k < K)
                        ? quantize(to_f32(x[static_cast<size_t>(row) * K + k]), inv[r])
                        : int8_t(0);
    }
    load_w_tile<TW, BM, BN>(w_q, K, M, k0, col0, t);
    __syncthreads();
    dot_tile<BM, BN>(t, acc);
    __syncthreads();
  }

  const float sw = __fdiv_rn(s_w[0], kQmax2);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int r = ty + 16 * i, row = row0 + r;
    if (row >= B) continue;
    const float scale = __fmul_rn(amax[r], sw);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < M)
        y[static_cast<size_t>(row) * M + col] = from_f32<T>(__fmul_rn(__int2float_rn(acc[i][j]), scale));
    }
  }
}

// ---------------------------------------------------------------------------
// int8_matmul_dequant: x_q (B, K) int8, w_q (K, M) int8, row_scale (B,) f32
//   -> y (B, M) = f32(x_q . w_q) * row_scale[b]
// int8_matmul_dequant_t (TW): w_q (M, K) int8 -> y = f32(x_q . w_q^T) * row_scale[b]
// With col_scale (M,) f32 (not null), either orientation: the colscale
// branch of the TPU kernel, y = f32(acc) * (row_scale[b] * col_scale[m]),
// the per-output-column weight state of paper Eq. 4 (forward: W's column
// scales; the dgrad of SwitchBackQ / LLM.int8: the per-row scales of the
// row-quantized W, which index the dgrad's output columns). The epilogue
// reads one col_scale value per output column of the tile; the GEMM is
// the same __dp4a loop, so it is bound as the row-scale form is.
// ---------------------------------------------------------------------------
template <typename T, int BM, int BN, bool TW>
__global__ void __launch_bounds__(kThreads)
int8_matmul_dequant_kernel(const int8_t* __restrict__ x_q, const int8_t* __restrict__ w_q,
                           const float* __restrict__ row_scale,
                           const float* __restrict__ col_scale, T* __restrict__ y,
                           int B, int K, int M) {
  __shared__ Tiles<BM, BN> t;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  int acc[BM / 16][BN / 16] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += kThreads) {
      const int r = idx / BK, kk = idx % BK;
      const int row = row0 + r, k = k0 + kk;
      t.xs[r][kk] = (row < B && k < K) ? x_q[static_cast<size_t>(row) * K + k] : int8_t(0);
    }
    load_w_tile<TW, BM, BN>(w_q, K, M, k0, col0, t);
    __syncthreads();
    dot_tile<BM, BN>(t, acc);
    __syncthreads();
  }

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= B) continue;
    const float rs = row_scale[row];
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= M) continue;
      const float scale = col_scale ? __fmul_rn(rs, col_scale[col]) : rs;
      y[static_cast<size_t>(row) * M + col] = from_f32<T>(__fmul_rn(__int2float_rn(acc[i][j]), scale));
    }
  }
}

// Decode (a few rows) takes narrow tiles so more blocks stream the weight;
// prefill takes square 64 x 64 tiles.
constexpr int kSmallRows = 16;

template <typename T, bool TW>
void launch_fused(const void* x, const void* w_q, const void* s_w, void* y, int B, int K, int M,
                  cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w_q);
  const float* sp = static_cast<const float*>(s_w);
  T* yp = static_cast<T*>(y);
  if (B <= kSmallRows) {
    dim3 grid((M + 31) / 32, (B + 15) / 16);
    fused_fwd_kernel<T, 16, 32, TW><<<grid, kThreads, 0, st>>>(xp, wp, sp, yp, B, K, M);
  } else {
    dim3 grid((M + 63) / 64, (B + 63) / 64);
    fused_fwd_kernel<T, 64, 64, TW><<<grid, kThreads, 0, st>>>(xp, wp, sp, yp, B, K, M);
  }
}

template <typename T, bool TW>
void launch_matmul(const void* x_q, const void* w_q, const void* row_scale, const void* col_scale,
                   void* y, int B, int K, int M, cudaStream_t st) {
  const int8_t* xp = static_cast<const int8_t*>(x_q);
  const int8_t* wp = static_cast<const int8_t*>(w_q);
  const float* sp = static_cast<const float*>(row_scale);
  const float* cp = static_cast<const float*>(col_scale);
  T* yp = static_cast<T*>(y);
  if (B <= kSmallRows) {
    dim3 grid((M + 31) / 32, (B + 15) / 16);
    int8_matmul_dequant_kernel<T, 16, 32, TW><<<grid, kThreads, 0, st>>>(xp, wp, sp, cp, yp, B, K, M);
  } else {
    dim3 grid((M + 63) / 64, (B + 63) / 64);
    int8_matmul_dequant_kernel<T, 64, 64, TW><<<grid, kThreads, 0, st>>>(xp, wp, sp, cp, yp, B, K, M);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. `bf16` selects __nv_bfloat16 (1) or float (0) for the
// floating-point input / output; every pointer is a device pointer.
// ---------------------------------------------------------------------------
extern "C" {

int sb_row_quantize(const void* x, int bf16, void* q, void* s, int B, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0 && K > 0) {
    if (bf16)
      row_quantize_kernel<__nv_bfloat16><<<B, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), K);
    else
      row_quantize_kernel<float><<<B, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), K);
  }
  return static_cast<int>(cudaGetLastError());
}

int sb_col_quantize(const void* x, int bf16, void* q, void* s, int R, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > 0 && C > 0) {
    const int blocks = (C + kColTile - 1) / kColTile;
    if (bf16)
      col_quantize_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), R, C);
    else
      col_quantize_kernel<float><<<blocks, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), R, C);
  }
  return static_cast<int>(cudaGetLastError());
}

// `partial` is scratch of n_partial floats; the caller picks n_partial
// (1 <= n_partial <= 1024) and passes the same value to both passes.
int sb_tensor_quantize(const void* x, int bf16, int64_t n, void* partial, int n_partial, void* q,
                       void* s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  if (bf16) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    absmax_partial_kernel<__nv_bfloat16><<<n_partial, kThreads, 0, st>>>(xp, n, pp);
    cast_tensorwise_kernel<__nv_bfloat16><<<n_partial, kThreads, 0, st>>>(xp, n, pp, n_partial, qp, sp);
  } else {
    const float* xp = static_cast<const float*>(x);
    absmax_partial_kernel<float><<<n_partial, kThreads, 0, st>>>(xp, n, pp);
    cast_tensorwise_kernel<float><<<n_partial, kThreads, 0, st>>>(xp, n, pp, n_partial, qp, sp);
  }
  return static_cast<int>(cudaGetLastError());
}

int sb_fused_switchback_fwd(const void* x, int bf16, const void* w_q, const void* s_w, void* y,
                            int B, int K, int M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0 && M > 0) {
    if (bf16)
      launch_fused<__nv_bfloat16, false>(x, w_q, s_w, y, B, K, M, st);
    else
      launch_fused<float, false>(x, w_q, s_w, y, B, K, M, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// col_scale (M,) f32, or null for the row-scale epilogue alone.
int sb_int8_matmul_dequant(const void* x_q, const void* w_q, const void* row_scale,
                           const void* col_scale, void* y, int bf16, int B, int K, int M,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0 && M > 0) {
    if (bf16)
      launch_matmul<__nv_bfloat16, false>(x_q, w_q, row_scale, col_scale, y, B, K, M, st);
    else
      launch_matmul<float, false>(x_q, w_q, row_scale, col_scale, y, B, K, M, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// g (B, K) float/bf16, w_q (N, K) int8 (the forward's weight; K is its
// output width), s_w (1,) f32 -> dx (B, N) in g's type.
int sb_fused_switchback_dgrad(const void* g, int bf16, const void* w_q, const void* s_w,
                              void* dx, int B, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0 && N > 0) {
    if (bf16)
      launch_fused<__nv_bfloat16, true>(g, w_q, s_w, dx, B, K, N, st);
    else
      launch_fused<float, true>(g, w_q, s_w, dx, B, K, N, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// x_q (B, K) int8, w_q (M, K) int8, row_scale (B,) f32, col_scale (M,) f32
// or null -> y (B, M) = f32(x_q . w_q^T) * row_scale[b] [* col_scale[m]].
int sb_int8_matmul_dequant_t(const void* x_q, const void* w_q, const void* row_scale,
                             const void* col_scale, void* y, int bf16, int B, int K, int M,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0 && M > 0) {
    if (bf16)
      launch_matmul<__nv_bfloat16, true>(x_q, w_q, row_scale, col_scale, y, B, K, M, st);
    else
      launch_matmul<float, true>(x_q, w_q, row_scale, col_scale, y, B, K, M, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
