// fp8 training kernels for Hopper (sm_90a): the real-fp8 datapath of the
// `fp8` and `fp8_mixed` SwitchBack variants, bound through a plain C
// interface (loaded with ctypes by kernels/fp8_matmul/build.py).
//
// Five kernels, each replacing one Pallas TPU kernel of the JAX package
// (repro/kernels/fp8_matmul/fp8_matmul.py):
//
//   row_quantize          <- row_quantize (:47)     fp8 per row
//   tensor_quantize       <- tensor_quantize (:86)  fp8 per tensor, two passes
//   block_quantize        <- block_quantize (:128)  fp8 per (br x bc) tile
//   fp8_matmul_dequant    <- fp8_matmul_dequant (:176), both W orientations
//   fp8_mixed_matmul      <- fp8_mixed_matmul (:258), both W orientations
//
// Storage: one byte per value in the float8_e4m3fn or float8_e5m2 encoding
// (format 0 = E4M3: 3 mantissa bits, bias 7, max 448; format 1 = E5M2: 2,
// 15, 57344), as torch.float8_e4m3fn / torch.float8_e5m2 hold it.
//
// Numerics copy the plain versions (kernels/fp8_matmul/ref.py) step by step:
//   * rounding: grid_round is the JAX package's fp8_grid_round bit for bit
//     (clip; round half to even at the format's mantissa width by adding
//     half an ulp, less one, plus the kept lsb, to the magnitude's bits and
//     clearing the dropped bits; in the fp8-subnormal range the fixed step
//     2^(1 - bias - man)). Its result lies on the fp8 grid, so encoding it
//     as a byte is exact. The division x / absmax is one IEEE division
//     (__fdiv_rn): neither a reciprocal nor a fast-math flag may change it.
//   * fp8_matmul_dequant: each operand lies in [-1, 1] on the fp8 grid, so
//     E4M3 values are multiples of 2^-9 and E5M2 values of 2^-16. Every
//     partial sum of a k-block (at most 4096 products) is then a multiple
//     of 2^-25 below 2^12: exact in double. Each k-block is summed exactly
//     in double (DFMA), rounded once to f32 (__double2float_rn) and added
//     into the f32 accumulator in k order (__fadd_rn), as the JAX kernel
//     adds its k-block dots. Then y = acc * row_scale, rounded once to the
//     output type. The plain version sums each k-block with a float64
//     product: the two agree bit for bit.
//   * fp8_mixed_matmul: per (row tile, k tile) the clean operand
//     q * (s_blk * s_w) in f32 against the decoded fp8 W, or, for a
//     fallback tile, bf16(x) against bf16(w * s_w); each tile's sum in
//     double (both operand kinds have short significands: the products are
//     exact, and the sum is exact unless its products span more than about
//     18 binades), rounded once to f32 and added in k order.
//
// What bounds them on an H100, and what this first version does about it:
// the quantizers are bound by bytes (read x, write one byte per value and
// the state); a block owns a row or a tile so each absmax is one block
// reduction, and the second read of the row or tile hits L1/L2; no atomics
// anywhere, so two launches give the same bits. The matmuls are bound by
// operations at the training path's rows (2 B K M over the 1,979 TFLOP/s
// fp8 tensor-core peak); these kernels run double FMAs on the CUDA cores
// (64 per SM and clock) over 64 x 64 output tiles staged in shared memory,
// which is what exactness costs. wgmma fp8 with an exact blocked
// accumulation is the later change. No TMA, no wgmma.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr int kThreads = 256;

struct Fmt {
  int man, bias;
  float fmax;       // largest finite value
  float inv_step;   // 2^(bias + man - 1): 1 / the subnormal step
  float step;       // 2^(1 - bias - man): the subnormal step
  float min_normal; // 2^(1 - bias)
};

__device__ __forceinline__ Fmt fmt_of(int f) {
  return f ? Fmt{2, 15, 57344.f, 65536.f, 1.52587890625e-05f, 6.103515625e-05f}
           : Fmt{3, 7, 448.f, 512.f, 0.001953125f, 0.015625f};
}

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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float clip(float x, float m) { return fminf(fmaxf(x, -m), m); }

// core/quantization.py fp8_grid_round, bit for bit.
__device__ __forceinline__ float grid_round(float x, const Fmt& f) {
  const float xf = clip(x, f.fmax);
  const uint32_t bits = __float_as_uint(xf);
  const uint32_t sign = bits & 0x80000000u, mag = bits & 0x7fffffffu;
  const int shift = 23 - f.man;
  const uint32_t lsb = (mag >> shift) & 1u;
  const uint32_t magr = (mag + ((1u << (shift - 1)) - 1u) + lsb) & ~((1u << shift) - 1u);
  const float pre = __uint_as_float(sign | magr);
  // x / step is x * 2^(bias + man - 1): a power of two, exact either way
  const float sub = __fmul_rn(rintf(__fmul_rn(xf, f.inv_step)), f.step);
  return clip(fabsf(xf) < f.min_normal ? sub : pre, f.fmax);
}

// A value on the fp8 grid (grid_round's output) as its byte: exact.
__device__ __forceinline__ uint8_t encode(float v, const Fmt& f) {
  const uint32_t bits = __float_as_uint(v);
  const uint32_t sign = (bits >> 24) & 0x80u;
  const float a = fabsf(v);
  uint32_t code;
  if (a < f.min_normal) {       // zero or subnormal: a / step < 2^man
    code = static_cast<uint32_t>(__float2uint_rn(__fmul_rn(a, f.inv_step)));
  } else {
    const uint32_t ab = bits & 0x7fffffffu;
    const uint32_t e = (ab >> 23) - 127u + static_cast<uint32_t>(f.bias);
    code = (e << f.man) | ((ab >> (23 - f.man)) & ((1u << f.man) - 1u));
  }
  return static_cast<uint8_t>(sign | code);
}

// A byte as its value in f32: exact (no NaN code is ever written).
__device__ __forceinline__ float decode(uint8_t b, const Fmt& f) {
  const uint32_t sign = static_cast<uint32_t>(b & 0x80u) << 24;
  const uint32_t e = (b & 0x7fu) >> f.man;
  const uint32_t m = b & ((1u << f.man) - 1u);
  const float a = e == 0 ? __fmul_rn(static_cast<float>(m), f.step)
                         : __uint_as_float(((e - static_cast<uint32_t>(f.bias) + 127u) << 23) |
                                           (m << (23 - f.man)));
  return __uint_as_float(__float_as_uint(a) | sign);
}

__device__ __forceinline__ uint8_t quantize(float x, float absmax, const Fmt& f) {
  return encode(grid_round(__fdiv_rn(x, absmax), f), f);
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
// row_quantize: x (B, K) -> q (B, K) fp8, s (B,) f32. One block per row.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_quantize_kernel(const T* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ s,
                    int K, int fmt) {
  __shared__ float red[32];
  const Fmt f = fmt_of(fmt);
  const size_t base = static_cast<size_t>(blockIdx.x) * K;
  float m = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) m = fmaxf(m, fabsf(to_f32(x[base + k])));
  const float absmax = fmaxf(block_max(m, red), kEps);
  for (int k = threadIdx.x; k < K; k += blockDim.x) q[base + k] = quantize(to_f32(x[base + k]), absmax, f);
  if (threadIdx.x == 0) s[blockIdx.x] = absmax;
}

// ---------------------------------------------------------------------------
// tensor_quantize: x (n,) -> q (n,) fp8, s (1,) f32. The TPU kernel carries
// the max across a sequential grid; GPU blocks run in no order, so pass 1
// writes one partial max per block and each block of pass 2 reduces the
// partials itself before casting its share (no atomics, no memset).
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
                       int n_partial, uint8_t* __restrict__ q, float* __restrict__ s, int fmt) {
  __shared__ float red[32];
  const Fmt f = fmt_of(fmt);
  float m = 0.f;
  for (int i = threadIdx.x; i < n_partial; i += blockDim.x) m = fmaxf(m, partial[i]);
  const float absmax = fmaxf(block_max(m, red), kEps);
  if (blockIdx.x == 0 && threadIdx.x == 0) s[0] = absmax;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    q[i] = quantize(to_f32(x[i]), absmax, f);
}

// ---------------------------------------------------------------------------
// block_quantize: x (R, C) -> q (R, C) fp8, s (nbr, nbc) f32, one scale per
// (br x bc) tile; one block per tile, threads walk it along its rows
// (coalesced along C). The ragged edge tiles hold fewer elements: their
// absmax is that of their real elements, as a zero-padded tile's is.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
block_quantize_kernel(const T* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ s,
                      int R, int C, int br, int bc, int fmt) {
  __shared__ float red[32];
  const Fmt f = fmt_of(fmt);
  const int r0 = blockIdx.y * br, c0 = blockIdx.x * bc;
  const int rows = min(br, R - r0), cols = min(bc, C - c0);
  const int n = rows * cols;
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    m = fmaxf(m, fabsf(to_f32(x[static_cast<size_t>(r0 + i / cols) * C + c0 + i % cols])));
  const float absmax = fmaxf(block_max(m, red), kEps);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t at = static_cast<size_t>(r0 + i / cols) * C + c0 + i % cols;
    q[at] = quantize(to_f32(x[at]), absmax, f);
  }
  if (threadIdx.x == 0) s[static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x] = absmax;
}

// ---------------------------------------------------------------------------
// The matmul core shared by fp8_matmul_dequant and fp8_mixed_matmul.
//
// A block owns a 64 x 64 output tile; 256 threads sit on a 16 x 16 grid and
// own rows ty + 16 i and columns tx + 16 j (strided: a warp's reads of the
// W tile are 16 consecutive doubles, its reads of the X tile two broadcast
// addresses). Shared tiles are stored k-major, [k][row] and [k][col], their
// row pitch padded by one double against bank conflicts when staged.
// W is (K, M) (TW = false, read along M) or (M, K) (TW = true: the
// forward's weight seen from the input gradient, read along K); no
// transpose is written anywhere.
// ---------------------------------------------------------------------------
constexpr int TM = 64, TN = 64, PITCH = 65;

template <int BK>
struct DTiles {
  double xs[BK][PITCH];
  double ws[BK][PITCH];
};

// Stage W's columns [col0, col0 + TN) at contraction indices [k0, kend) as
// ws[kk][n] (zero outside), decoded from fp8; `wfn(v)` maps the decoded
// value to what is stored.
template <bool TW, int BK, typename F>
__device__ __forceinline__ void stage_w(const uint8_t* __restrict__ w_q, const Fmt& fw, int K,
                                        int M, int k0, int kend, int col0,
                                        double (&ws)[BK][PITCH], F wfn) {
  for (int idx = threadIdx.x; idx < BK * TN; idx += kThreads) {
    int kk, n;
    if (TW) {
      n = idx / BK;
      kk = idx % BK;
    } else {
      kk = idx / TN;
      n = idx % TN;
    }
    const int k = k0 + kk, c = col0 + n;
    double v = 0.0;
    if (k < kend && c < M)
      v = wfn(decode(w_q[TW ? static_cast<size_t>(c) * K + k : static_cast<size_t>(k) * M + c], fw));
    ws[kk][n] = v;
  }
}

// ---------------------------------------------------------------------------
// fp8_matmul_dequant: x_q (B, K) fp8 (format fx), w_q (K, M) or (M, K)
// fp8 (format fw), row_scale (B,) f32 -> y (B, M) = acc * row_scale[b],
// acc the f32 sum over k-blocks of width bk of each block's exact sum.
// ---------------------------------------------------------------------------
constexpr int BK_DQ = 32;

template <typename T, bool TW>
__global__ void __launch_bounds__(kThreads)
fp8_matmul_dequant_kernel(const uint8_t* __restrict__ x_q, int fx, const uint8_t* __restrict__ w_q,
                          int fw, const float* __restrict__ row_scale, T* __restrict__ y, int B,
                          int K, int M, int bk) {
  __shared__ DTiles<BK_DQ> t;
  const Fmt fxf = fmt_of(fx), fwf = fmt_of(fw);
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int kb = 0; kb < K; kb += bk) {
    const int kend = min(kb + bk, K);
    double d[4][4] = {};
    for (int k0 = kb; k0 < kend; k0 += BK_DQ) {
      for (int idx = threadIdx.x; idx < TM * BK_DQ; idx += kThreads) {
        const int r = idx / BK_DQ, kk = idx % BK_DQ;
        const int row = row0 + r, k = k0 + kk;
        t.xs[kk][r] = (row < B && k < kend)
                          ? static_cast<double>(decode(x_q[static_cast<size_t>(row) * K + k], fxf))
                          : 0.0;
      }
      stage_w<TW, BK_DQ>(w_q, fwf, K, M, k0, kend, col0, t.ws,
                         [](float v) { return static_cast<double>(v); });
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK_DQ; ++kk) {
        double a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = t.xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = t.ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) d[i][j] = __fma_rn(a[i], b[j], d[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], __double2float_rn(d[i][j]));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= B) continue;
    const float rs = row_scale[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < M) y[static_cast<size_t>(row) * M + col] = from_f32<T>(__fmul_rn(acc[i][j], rs));
    }
  }
}

// ---------------------------------------------------------------------------
// fp8_mixed_matmul: x16 (B, K) f32/bf16 (the unquantized operand), x_q
// (B, K) fp8 (format fx) with per-tile scale s_blk and fallback mask fb_blk
// (nbr, nbk) over tiles of br rows x bk columns, w_q (K, M) or (M, K) fp8
// (format fw) with tensor scale s_w (1,) -> y (B, M) in the output type.
// Rows of one block may lie in different row tiles, so both forms of each W
// element are staged (the decoded value and bf16(value * s_w)) and each
// thread picks, per row, the one its row's tile takes.
// ---------------------------------------------------------------------------
constexpr int BK_MX = 16;

template <typename Tin, typename Tout, bool TW>
__global__ void __launch_bounds__(kThreads)
fp8_mixed_matmul_kernel(const Tin* __restrict__ x16, const uint8_t* __restrict__ x_q, int fx,
                        const float* __restrict__ s_blk, const float* __restrict__ fb_blk,
                        const uint8_t* __restrict__ w_q, int fw, const float* __restrict__ s_w,
                        Tout* __restrict__ y, int B, int K, int M, int br, int bk) {
  __shared__ DTiles<BK_MX> t;
  __shared__ double w16s[BK_MX][PITCH];
  __shared__ int fb_row[TM];
  __shared__ float sc_row[TM];
  const Fmt fxf = fmt_of(fx), fwf = fmt_of(fw);
  const float sw = s_w[0];
  const int nbk = (K + bk - 1) / bk;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int kt = 0; kt < nbk; ++kt) {
    const int kb = kt * bk, kend = min(kb + bk, K);
    if (threadIdx.x < TM) {
      const int row = row0 + threadIdx.x;
      const size_t tile = static_cast<size_t>(min(row, B - 1) / br) * nbk + kt;
      fb_row[threadIdx.x] = fb_blk[tile] != 0.f;
      sc_row[threadIdx.x] = __fmul_rn(s_blk[tile], sw);
    }
    __syncthreads();
    bool fb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) fb[i] = fb_row[ty + 16 * i];
    double d[4][4] = {};
    for (int k0 = kb; k0 < kend; k0 += BK_MX) {
      for (int idx = threadIdx.x; idx < TM * BK_MX; idx += kThreads) {
        const int r = idx / BK_MX, kk = idx % BK_MX;
        const int row = row0 + r, k = k0 + kk;
        double v = 0.0;
        if (row < B && k < kend) {
          const size_t at = static_cast<size_t>(row) * K + k;
          v = fb_row[r] ? bf16_round(to_f32(x16[at])) : __fmul_rn(decode(x_q[at], fxf), sc_row[r]);
        }
        t.xs[kk][r] = v;
      }
      stage_w<TW, BK_MX>(w_q, fwf, K, M, k0, kend, col0, t.ws,
                         [](float v) { return static_cast<double>(v); });
      stage_w<TW, BK_MX>(w_q, fwf, K, M, k0, kend, col0, w16s,
                         [sw](float v) { return static_cast<double>(bf16_round(__fmul_rn(v, sw))); });
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK_MX; ++kk) {
        double a[4], b8[4], b16[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = t.xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b8[j] = t.ws[kk][tx + 16 * j];
          b16[j] = w16s[kk][tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) d[i][j] = __fma_rn(a[i], fb[i] ? b16[j] : b8[j], d[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], __double2float_rn(d[i][j]));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < M) y[static_cast<size_t>(row) * M + col] = from_f32<Tout>(acc[i][j]);
    }
  }
}

template <typename T, bool TW>
void launch_dequant(const void* x_q, int fx, const void* w_q, int fw, const void* row_scale,
                    void* y, int B, int K, int M, int bk, cudaStream_t st) {
  dim3 grid((M + TN - 1) / TN, (B + TM - 1) / TM);
  fp8_matmul_dequant_kernel<T, TW><<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(x_q), fx, static_cast<const uint8_t*>(w_q), fw,
      static_cast<const float*>(row_scale), static_cast<T*>(y), B, K, M, bk);
}

template <typename Tin, typename Tout, bool TW>
void launch_mixed(const void* x16, const void* x_q, int fx, const void* s_blk, const void* fb_blk,
                  const void* w_q, int fw, const void* s_w, void* y, int B, int K, int M, int br,
                  int bk, cudaStream_t st) {
  dim3 grid((M + TN - 1) / TN, (B + TM - 1) / TM);
  fp8_mixed_matmul_kernel<Tin, Tout, TW><<<grid, kThreads, 0, st>>>(
      static_cast<const Tin*>(x16), static_cast<const uint8_t*>(x_q), fx,
      static_cast<const float*>(s_blk), static_cast<const float*>(fb_blk),
      static_cast<const uint8_t*>(w_q), fw, static_cast<const float*>(s_w), static_cast<Tout*>(y),
      B, K, M, br, bk);
}

template <bool TW>
void dispatch_dequant(const void* x_q, int fx, const void* w_q, int fw, const void* row_scale,
                      void* y, int bf16, int B, int K, int M, int bk, cudaStream_t st) {
  if (bf16)
    launch_dequant<__nv_bfloat16, TW>(x_q, fx, w_q, fw, row_scale, y, B, K, M, bk, st);
  else
    launch_dequant<float, TW>(x_q, fx, w_q, fw, row_scale, y, B, K, M, bk, st);
}

template <bool TW>
void dispatch_mixed(const void* x16, int bf16_in, const void* x_q, int fx, const void* s_blk,
                    const void* fb_blk, const void* w_q, int fw, const void* s_w, void* y,
                    int bf16_out, int B, int K, int M, int br, int bk, cudaStream_t st) {
  if (bf16_in && bf16_out)
    launch_mixed<__nv_bfloat16, __nv_bfloat16, TW>(x16, x_q, fx, s_blk, fb_blk, w_q, fw, s_w, y,
                                                   B, K, M, br, bk, st);
  else if (bf16_in)
    launch_mixed<__nv_bfloat16, float, TW>(x16, x_q, fx, s_blk, fb_blk, w_q, fw, s_w, y, B, K, M,
                                           br, bk, st);
  else if (bf16_out)
    launch_mixed<float, __nv_bfloat16, TW>(x16, x_q, fx, s_blk, fb_blk, w_q, fw, s_w, y, B, K, M,
                                           br, bk, st);
  else
    launch_mixed<float, float, TW>(x16, x_q, fx, s_blk, fb_blk, w_q, fw, s_w, y, B, K, M, br, bk,
                                   st);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. `bf16` selects __nv_bfloat16 (1) or float (0) for a
// floating-point input or output; `fmt`, `fx`, `fw` select E4M3 (0) or
// E5M2 (1); every pointer is a device pointer.
// ---------------------------------------------------------------------------
extern "C" {

int f8_row_quantize(const void* x, int bf16, void* q, void* s, int B, int K, int fmt,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0 && K > 0) {
    if (bf16)
      row_quantize_kernel<__nv_bfloat16><<<B, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<uint8_t*>(q), static_cast<float*>(s),
          K, fmt);
    else
      row_quantize_kernel<float><<<B, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<uint8_t*>(q), static_cast<float*>(s), K, fmt);
  }
  return static_cast<int>(cudaGetLastError());
}

// `partial` is scratch of n_partial floats (1 <= n_partial <= 1024), the
// same value for both passes.
int f8_tensor_quantize(const void* x, int bf16, int64_t n, void* partial, int n_partial, void* q,
                       void* s, int fmt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  uint8_t* qp = static_cast<uint8_t*>(q);
  float* sp = static_cast<float*>(s);
  if (bf16) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    absmax_partial_kernel<__nv_bfloat16><<<n_partial, kThreads, 0, st>>>(xp, n, pp);
    cast_tensorwise_kernel<__nv_bfloat16><<<n_partial, kThreads, 0, st>>>(xp, n, pp, n_partial,
                                                                           qp, sp, fmt);
  } else {
    const float* xp = static_cast<const float*>(x);
    absmax_partial_kernel<float><<<n_partial, kThreads, 0, st>>>(xp, n, pp);
    cast_tensorwise_kernel<float><<<n_partial, kThreads, 0, st>>>(xp, n, pp, n_partial, qp, sp,
                                                                   fmt);
  }
  return static_cast<int>(cudaGetLastError());
}

// s (ceil(R / br), ceil(C / bc)) f32, row-major.
int f8_block_quantize(const void* x, int bf16, void* q, void* s, int R, int C, int br, int bc,
                      int fmt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > 0 && C > 0) {
    dim3 grid((C + bc - 1) / bc, (R + br - 1) / br);
    if (bf16)
      block_quantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<uint8_t*>(q), static_cast<float*>(s),
          R, C, br, bc, fmt);
    else
      block_quantize_kernel<float><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<uint8_t*>(q), static_cast<float*>(s), R, C,
          br, bc, fmt);
  }
  return static_cast<int>(cudaGetLastError());
}

// x_q (B, K), w_q (K, M), row_scale (B,) -> y (B, M); k-blocks of bk.
int f8_matmul_dequant(const void* x_q, int fx, const void* w_q, int fw, const void* row_scale,
                      void* y, int bf16, int B, int K, int M, int bk, void* stream) {
  if (B > 0 && M > 0)
    dispatch_dequant<false>(x_q, fx, w_q, fw, row_scale, y, bf16, B, K, M, bk,
                            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// the same with w_q (M, K), contracted over its second dim.
int f8_matmul_dequant_t(const void* x_q, int fx, const void* w_q, int fw, const void* row_scale,
                        void* y, int bf16, int B, int K, int M, int bk, void* stream) {
  if (B > 0 && M > 0)
    dispatch_dequant<true>(x_q, fx, w_q, fw, row_scale, y, bf16, B, K, M, bk,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// x16 (B, K), x_q (B, K), s_blk and fb_blk (ceil(B / br), ceil(K / bk)),
// w_q (K, M), s_w (1,) -> y (B, M).
int f8_mixed_matmul(const void* x16, int bf16_in, const void* x_q, int fx, const void* s_blk,
                    const void* fb_blk, const void* w_q, int fw, const void* s_w, void* y,
                    int bf16_out, int B, int K, int M, int br, int bk, void* stream) {
  if (B > 0 && M > 0)
    dispatch_mixed<false>(x16, bf16_in, x_q, fx, s_blk, fb_blk, w_q, fw, s_w, y, bf16_out, B, K,
                          M, br, bk, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// the same with w_q (M, K), contracted over its second dim.
int f8_mixed_matmul_t(const void* x16, int bf16_in, const void* x_q, int fx, const void* s_blk,
                      const void* fb_blk, const void* w_q, int fw, const void* s_w, void* y,
                      int bf16_out, int B, int K, int M, int br, int bk, void* stream) {
  if (B > 0 && M > 0)
    dispatch_mixed<true>(x16, bf16_in, x_q, fx, s_blk, fb_blk, w_q, fw, s_w, y, bf16_out, B, K, M,
                         br, bk, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
