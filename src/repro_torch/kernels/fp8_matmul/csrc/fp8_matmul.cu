// fp8 training kernels for Hopper (sm_90a): the real-fp8 datapath of the
// `fp8` and `fp8_mixed` SwitchBack variants, bound through a plain C
// interface (loaded with ctypes by kernels/fp8_matmul/build.py).
//
// Five kernels, each replacing one Pallas TPU kernel of the JAX package
// (repro/kernels/fp8_matmul/fp8_matmul.py):
//
//   row_quantize          <- row_quantize (:47)     fp8 per row
//   tensor_quantize       <- tensor_quantize (:86)  fp8 per tensor, read once
//   block_quantize        <- block_quantize (:128)  fp8 per (br x bc) tile
//   fp8_matmul_dequant    <- fp8_matmul_dequant (:176, body :158), both W
//                            orientations
//   fp8_mixed_matmul      <- fp8_mixed_matmul (:258, body :222), both W
//                            orientations
//
// plus wgmma_probe, one window's chain of the GEMMs' own wgmma steps (or of
// wgrad_bf16's transposed bf16 form) on given operands, which measures how
// the tensor cores add (chip_smoke.py's accumulator probe), encode_check
// and divide_check, which hold the quantizers' byte conversion and bf16
// division against grid_round + encode on every f32 and against __fdiv_rn
// on every pair they can meet, and transpose_bytes, the forward's K-major
// copy of W.
//
// Storage: one byte per value in the float8_e4m3fn or float8_e5m2 encoding
// (format 0 = E4M3: 3 mantissa bits, bias 7, max 448; format 1 = E5M2: 2,
// 15, 57344), as torch.float8_e4m3fn / torch.float8_e5m2 hold it.
//
// The quantizers agree with the plain versions (kernels/fp8_matmul/ref.py)
// bit for bit. x / absmax is one IEEE division there; here __fdiv_rn, or
// for bf16 inputs a reciprocal computed once a tile and an fma correction
// (div_fast: the same bytes as __fdiv_rn on every pair it can meet,
// divide_check). The plain versions then round with the JAX package's
// fp8_grid_round (here grid_round, kernels/csrc/fp8_grid.cuh, shared with
// fp8_cast.cu) and cast exactly. The quantizers take the byte from the
// card's conversion instead (cvt.rn.satfinite, two values an instruction:
// round to nearest even onto the fp8 grid, subnormals included, saturating
// at the format's max), after one fmaxf that maps NaN to -max as
// grid_round's clip does: encode_check finds the same byte as
// encode(grid_round(y)) for every f32 y, and |x / absmax| <= 1 needs no
// other clip. That is 2-3 instructions a value where grid_round and encode
// took ~25.
//
// row_quantize and block_quantize are one tile kernel (a row is a 1 x K
// tile), bound by bytes (x read once, one byte a value and the state
// written): a group of 32-256 threads owns a tile and holds all of it in
// registers (up to 8 loads of 8 values a thread, 16 bytes of bf16 each),
// so x is read once, every load issued before any is read; the group's
// absmax is a warp reduction, plus one exchange through shared memory
// above a warp; the bytes go out 8 at a time. A thread's (row, chunk) in
// the tile steps by a divmod computed once: no division per value. No
// atomics.
//
// The two matmuls are bound by operations (2 B K M at the 1,979 TFLOP/s fp8
// tensor-core peak; one CLIP layer's six at 4,128 rows: 82 us) and run on
// fp8 wgmma (kernels/csrc/wgmma.cuh):
//   * a block owns a 128 x 128 output tile (4,128 x 1,280 is 330 blocks,
//     2.5 waves on 132 SMs; 160 columns would fit 1,280 in 2.0 but 1,024 in
//     worse, and 256 needs more registers than two fragments of 128 leave):
//     two consumer warpgroups of 64 rows each, one producer warpgroup. The
//     contraction runs in windows of at most 128 (one 128-byte row of an
//     fp8 tile). The producer fills a ring of up to 6 shared-memory stages
//     (as many as 227 KB hold), each an A tile (x_q, 128 rows) and a W tile
//     (128 output columns), K-major and 128-byte swizzled, by TMA with an
//     mbarrier per stage. fp8 wgmma reads only K-major operands: the
//     input-gradient form's W (M, K) is K-major as it lies; for the
//     forward's W (K, M) the wrapper first launches transpose_bytes, a
//     K-major copy (transposing each W tile in shared memory instead put a
//     warp's 4-byte stores on two banks and ran the forward at a third of
//     the input gradient's rate). Rows and columns past the matrix arrive
//     as zeros. A shape whose rows are not 16-byte aligned (K % 16) or whose
//     scale tiles do not start on a window (bk % 128 with more than one k
//     tile) takes the masked path of the same kernel: the producer
//     warpgroup loads the stage itself, zero outside the window (so a scale
//     tile of any width, 48 say, is masked inside its last k32 step).
//   * per window each consumer runs up to four m64n128k32 wgmmas into a
//     fresh fragment and adds it on the CUDA cores into its f32
//     accumulator (the promotion): a wgmma step aligns its addends to the
//     largest exponent sum, keeps 13 bits of each below it and 14
//     significant bits of their sum (bf16: 25 and 24), not f32's 24;
//     promoting every 128 bounds what that costs (below).
//   * fp8_matmul_dequant: acc += fragment per window, in k order; then
//     y = acc * row_scale, rounded once to the output type. The plain
//     version adds exact k-block sums in f32; the windows lie inside its
//     k-blocks.
//   * fp8_mixed_matmul: windows start on the (row tile, k tile) grid of
//     the scales, whose values each thread loads one tile ahead; clean rows
//     take acc = fma(fragment, s_blk * s_w, acc) (the plain version scales
//     each product before its exact sum: one f32 rounding per product
//     apart); a warpgroup whose rows fall back in a tile (one bar.red.or)
//     also builds bf16(x16) and bf16(decode(w) * s_w) in its own swizzled
//     tiles, 64 k at a time, runs bf16 m64n128k16 wgmmas into the fragment
//     and adds it for those rows. Rows that disagree within a warpgroup
//     (tiles under 64 rows) run both products, each row taking its own.
//   * no split of the contraction, no atomics: two launches give the same
//     bits.
// The tensor cores change the order of each window's sum and drop bits
// inside it, so kernel and plain version agree to ref.matmul_bound, per
// output: |y - y_plain| <= |scale| * c * 2^-t * (|a| @ |w|) + 1 ulp of the
// output type, t the width the probe measured (fp8 13, bf16 23) and c the
// addends and sums a window truncates (ref.ADDENDS). Inputs whose window
// sums are exact at that width (ref.exact_entries) give the plain
// version's bits, and kernels/fp8_matmul/wgmma_model.py (the steps'
// truncations, the windows, the promotions in the kernels' order, in
// plain torch) gives these kernels' bits on any input.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue when a TMA
// descriptor cannot be made); the Python wrapper raises on a non-zero code.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

#include "../../csrc/fp8_grid.cuh"
#include "../../csrc/tensor_absmax.cuh"
#include "../../csrc/wgmma.cuh"

namespace {

constexpr float kEps = 1e-12f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// A value on the fp8 grid (grid_round's output) as its byte: exact. The
// plain construction that encode_check holds the quantizers' conversion to.
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

// y as it enters the conversion: NaN to -max, as grid_round's clip maps it
// (every other y the quantizers see lies in [-1, 1])
template <int F>
__device__ __forceinline__ float clip_nan(float y) {
  return fmaxf(y, F ? -57344.f : -448.f);
}

// lo and hi as fp8 bytes (lo in the low byte), rounded to nearest even and
// saturated at the format's max: encode(grid_round(y)) for every y that
// clip_nan leaves (encode_check)
template <int F>
__device__ __forceinline__ uint32_t fp8x2(float lo, float hi) {
  uint16_t r;
  if constexpr (F == 1)
    asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %2;" : "=h"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;" : "=h"(r) : "f"(hi), "f"(lo));
  return r;
}

// x / a for a bf16 x, with __fdiv_rn(x, a)'s bytes, from r = RN(1 / a)
// (once a tile): q = RN(x r), the residual x - a q (one fma, exact) and
// RN(q + (x - a q) r), then x's sign put back (x = -0 gives -0 where the
// last fma leaves +0). divide_check, on every bf16 x with |x| <= a (or NaN)
// and every absmax a bf16 tile can have below kFastMax (r then normal):
// the quotient is __fdiv_rn's bit for bit where |x| >= 2^-100 and the
// quotient is normal, and the bytes are the same in both formats
// everywhere (below that the residual x - a q underflows, but both
// quotients lie far under half the least fp8 step: the 1e-12 floor keeps
// x / a under 2^-60 there). f32
// inputs and larger absmax keep __fdiv_rn. 4 instructions a value, where
// __fdiv_rn takes ~12 with its check for the slow path.
constexpr float kFastMax = 8.507059173023462e37f;   // 2^126

__device__ __forceinline__ float div_fast(float x, float a, float r) {
  const float q = __fmul_rn(x, r);
  const float y = __fmaf_rn(__fmaf_rn(-a, q, x), r, q);
  return __uint_as_float(__float_as_uint(y) | (__float_as_uint(x) & 0x80000000u));
}

// four values x / absmax as their bytes, the first in the low byte; FAST:
// div_fast with r = RN(1 / absmax)
template <int F, bool FAST>
__device__ __forceinline__ uint32_t quantize4(float a, float b, float c, float d, float absmax,
                                              float r) {
  const auto y = [absmax, r](float v) {
    return clip_nan<F>(FAST ? div_fast(v, absmax, r) : __fdiv_rn(v, absmax));
  };
  return fp8x2<F>(y(a), y(b)) | fp8x2<F>(y(c), y(d)) << 16;
}

__device__ __forceinline__ uint8_t quantize(float x, float absmax, int fmt) {
  const float y = __fdiv_rn(x, absmax);
  return static_cast<uint8_t>(fmt ? fp8x2<1>(clip_nan<1>(y), 0.f) : fp8x2<0>(clip_nan<0>(y), 0.f));
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
// row_quantize and block_quantize: x (R, C) -> q (R, C) fp8, s f32, one
// absmax per (br x bc) tile of the tile grid (nbr, nbc), row-major;
// row_quantize's tiles are its rows (br = 1, bc = K: s (B, 1)). The ragged
// edge tiles hold fewer elements: their absmax is that of their real
// elements, as a zero-padded tile's is.
//
// A group of 2^gshift threads (32 to 256; 256 / group groups a block) owns
// a tile. The tile is read as chunks of 8 values along its rows, cpr =
// ceil(bc / 8) a tile row: chunk c is (row c / cpr, columns 8 (c % cpr) ..
// + 7), and thread t of the group takes chunks t, t + group, ... (np of
// them, at most kMaxChunks), so neighbouring threads read neighbouring 16
// bytes. The launcher takes the smallest group with np <= kMaxChunks: a
// warp a row up to K = 2,048, two warps to 4,096, four to 8,192; a 128 x
// 128 tile 256 threads. Where x is 16-byte aligned, C % 8 == 0 and bc % 8
// == 0 (PATH kVec), every chunk lies wholly inside or outside the tile and
// loads as one 16-byte load (two for f32) and stores as one 8-byte store;
// else (kMasked: K = 588, an odd offset) a chunk loads its values one by
// one, those past the tile's edge as 0, and stores byte by byte. A tile of
// more than 256 x kMaxChunks chunks, or whose br x C reaches 2^32 (the
// offsets from a tile's start are 32-bit; none on a path), takes kWide: a
// block a tile, two passes over x, the second mostly from L2.
// ---------------------------------------------------------------------------
constexpr int kChunk = 8;        // values of one chunk: 16 bytes of bf16
constexpr int kMaxChunks = 8;    // chunks a thread holds in registers: 64 values
enum { kMasked = 0, kVec = 1, kWide = 2 };
static_assert(kThreads == 1 << 8, "the tile kernels shift by log2(kThreads) = 8");

struct Tiles {
  int R, C;          // x (R, C), row-major
  int br, bc;        // the tile (each side at most the array's)
  int nbc, ntiles;   // tiles a row of the tile grid; tiles in all
  int gshift;        // log2 of the threads that own a tile
  int cpr;           // chunks a tile row: ceil(bc / kChunk)
  int dr, dc;        // divmod(group, cpr): from one of a thread's chunks to its next
  int np;            // chunks a thread: ceil(br * cpr / group) <= kMaxChunks
  int fmt;
};

template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {    // 8 bf16 values as 4 words, widened on use
  uint32_t w[4];
  __device__ __forceinline__ void zero() { w[0] = w[1] = w[2] = w[3] = 0u; }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  }
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int n) {   // the first n
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (e < n) w[e >> 1] |= static_cast<uint32_t>(__ldg(h + e)) << (16 * (e & 1));
  }
  __device__ __forceinline__ float operator[](int e) const {   // a bf16 is the top half of its f32
    return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
  }
};

template <>
struct Chunk<float> {
  float v[kChunk];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) v[e] = 0.f;
  }
  __device__ __forceinline__ void load(const float* p) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  __device__ __forceinline__ void load(const float* p, int n) {   // the first n
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (e < n) v[e] = __ldg(p + e);
  }
  __device__ __forceinline__ float operator[](int e) const { return v[e]; }
};

// the cast of a thread's chunks, from registers: n[j] values of chunk j at
// qt + off[j] (n[j] is 8 or 0 on kVec)
template <typename T, bool VEC, int F, bool FAST>
__device__ __forceinline__ void cast_chunks(const Chunk<T> (&v)[kMaxChunks],
                                            const uint32_t (&off)[kMaxChunks],
                                            const int (&n)[kMaxChunks], float absmax,
                                            uint8_t* __restrict__ qt) {
  const float r = FAST ? __frcp_rn(absmax) : 0.f;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    if (n[j] == 0) continue;
    const uint32_t lo = quantize4<F, FAST>(v[j][0], v[j][1], v[j][2], v[j][3], absmax, r);
    const uint32_t hi = quantize4<F, FAST>(v[j][4], v[j][5], v[j][6], v[j][7], absmax, r);
    if (VEC) {
      *reinterpret_cast<uint2*>(qt + off[j]) = make_uint2(lo, hi);
    } else {
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        if (e < n[j]) qt[off[j] + e] = static_cast<uint8_t>((e < 4 ? lo : hi) >> (8 * (e & 3)));
    }
  }
}

template <typename T, bool VEC, int F>
__device__ __forceinline__ void cast_format(const Chunk<T> (&v)[kMaxChunks],
                                            const uint32_t (&off)[kMaxChunks],
                                            const int (&n)[kMaxChunks], float absmax,
                                            uint8_t* __restrict__ qt) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (absmax < kFastMax) {                                   // uniform across the group
      cast_chunks<T, VEC, F, true>(v, off, n, absmax, qt);
      return;
    }
  }
  cast_chunks<T, VEC, F, false>(v, off, n, absmax, qt);
}

template <typename T, bool VEC>
__device__ __forceinline__ void quantize_tiles(const T* __restrict__ x, uint8_t* __restrict__ q,
                                               float* __restrict__ s, const Tiles& p) {
  __shared__ float red[kThreads / 32];
  const int g = threadIdx.x >> p.gshift, t = threadIdx.x & ((1 << p.gshift) - 1);
  const int tile = (blockIdx.x << (8 - p.gshift)) + g;       // kThreads = 2^8
  const bool live = tile < p.ntiles;
  const int tr = p.nbc == 1 ? tile : tile / p.nbc, tc = tile - tr * p.nbc;
  const int r0 = tr * p.br, c0 = tc * p.bc;
  const int rows = min(p.br, p.R - r0), cols = min(p.bc, p.C - c0);
  const size_t base = static_cast<size_t>(r0) * p.C + c0;    // the tile's first value
  int r = t / p.cpr, cc = t - r * p.cpr;                      // chunk t's place, once
  Chunk<T> v[kMaxChunks];
  uint32_t off[kMaxChunks];                                  // from base: br * C < 2^32
  int n[kMaxChunks];
  // every load issued before any is read
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int col = kChunk * cc;
    n[j] = live && j < p.np && r < rows && col < cols ? min(kChunk, cols - col) : 0;
    off[j] = static_cast<uint32_t>(r) * p.C + col;
    v[j].zero();
    if (n[j] > 0) {
      if (VEC)
        v[j].load(x + base + off[j]);
      else
        v[j].load(x + base + off[j], n[j]);
    }
    r += p.dr, cc += p.dc;                                     // chunk t + group (j + 1)
    if (cc >= p.cpr) cc -= p.cpr, ++r;
  }
  float m = 0.f;                                             // chunks not loaded hold 0
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j)
#pragma unroll
    for (int e = 0; e < kChunk; ++e) m = fmaxf(m, fabsf(v[j][e]));
  m = warp_max(m);
  if (p.gshift > 5) {                                          // the group's warps' maxima
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    const int w0 = (g << p.gshift) >> 5;
    for (int i = 0; i < 1 << (p.gshift - 5); ++i) m = fmaxf(m, red[w0 + i]);
  }
  const float absmax = fmaxf(m, kEps);
  if (p.fmt)
    cast_format<T, VEC, 1>(v, off, n, absmax, q + base);
  else
    cast_format<T, VEC, 0>(v, off, n, absmax, q + base);
  if (live && t == 0) s[tile] = absmax;
}

// kWide: one block a tile; element i of the tile is (i / cols, i % cols),
// a thread's stepped by divmod(kThreads, cols)
template <typename T>
__device__ __forceinline__ void quantize_wide(const T* __restrict__ x, uint8_t* __restrict__ q,
                                              float* __restrict__ s, const Tiles& p) {
  __shared__ float red[32];
  const int tr = blockIdx.x / p.nbc, tc = blockIdx.x - tr * p.nbc;
  const int r0 = tr * p.br, c0 = tc * p.bc;
  const int rows = min(p.br, p.R - r0), cols = min(p.bc, p.C - c0);
  const int dr = kThreads / cols, dc = kThreads - dr * cols;
  const int r1 = threadIdx.x / cols, c1 = threadIdx.x - r1 * cols;
  float m = 0.f;
  for (int r = r1, c = c1; r < rows;) {
    m = fmaxf(m, fabsf(to_f32(x[static_cast<size_t>(r0 + r) * p.C + c0 + c])));
    r += dr, c += dc;
    if (c >= cols) c -= cols, ++r;
  }
  const float absmax = fmaxf(block_max(m, red), kEps);
  for (int r = r1, c = c1; r < rows;) {
    const size_t at = static_cast<size_t>(r0 + r) * p.C + c0 + c;
    q[at] = quantize(to_f32(x[at]), absmax, p.fmt);
    r += dr, c += dc;
    if (c >= cols) c -= cols, ++r;
  }
  if (threadIdx.x == 0) s[blockIdx.x] = absmax;
}

// two entry kernels of one body, so that a profile tells the two wrappers'
// launches apart
template <typename T, int PATH>
__global__ void __launch_bounds__(kThreads)
fp8_row_quantize_kernel(const T* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ s,
                        Tiles p) {
  if constexpr (PATH == kWide)
    quantize_wide<T>(x, q, s, p);
  else
    quantize_tiles<T, PATH == kVec>(x, q, s, p);
}

template <typename T, int PATH>
__global__ void __launch_bounds__(kThreads)
fp8_block_quantize_kernel(const T* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ s,
                          Tiles p) {
  if constexpr (PATH == kWide)
    quantize_wide<T>(x, q, s, p);
  else
    quantize_tiles<T, PATH == kVec>(x, q, s, p);
}

template <typename T, int PATH>
void launch_tiles(bool row, const void* x, void* q, void* s, const Tiles& p, cudaStream_t st) {
  const int blocks = PATH == kWide ? p.ntiles : (p.ntiles + (kThreads >> p.gshift) - 1) >>
                                                    (8 - p.gshift);
  auto* k = row ? fp8_row_quantize_kernel<T, PATH> : fp8_block_quantize_kernel<T, PATH>;
  k<<<blocks, kThreads, 0, st>>>(static_cast<const T*>(x), static_cast<uint8_t*>(q),
                                 static_cast<float*>(s), p);
}

template <typename T>
void launch_path(bool row, int path, const void* x, void* q, void* s, const Tiles& p,
                  cudaStream_t st) {
  if (path == kVec)
    launch_tiles<T, kVec>(row, x, q, s, p, st);
  else if (path == kMasked)
    launch_tiles<T, kMasked>(row, x, q, s, p, st);
  else
    launch_tiles<T, kWide>(row, x, q, s, p, st);
}

// the tile grid, the group and the path (see above), then one launch
int quantize_tiles_launch(bool row, const void* x, int bf16, void* q, void* s, int R, int C,
                          int br, int bc, int fmt, cudaStream_t st) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  Tiles p;
  p.R = R, p.C = C, p.br = br, p.bc = bc, p.fmt = fmt;
  p.nbc = (C + bc - 1) / bc;
  p.ntiles = (R + br - 1) / br * p.nbc;
  p.cpr = (bc + kChunk - 1) / kChunk;
  const int64_t chunks = static_cast<int64_t>(br) * p.cpr;
  p.gshift = 5;
  while (p.gshift < 8 && chunks > (int64_t{kMaxChunks} << p.gshift)) ++p.gshift;
  p.np = static_cast<int>((chunks + (1 << p.gshift) - 1) >> p.gshift);
  p.dr = (1 << p.gshift) / p.cpr, p.dc = (1 << p.gshift) - p.dr * p.cpr;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && C % kChunk == 0 &&
                       bc % kChunk == 0;
  const bool fits = p.np <= kMaxChunks && static_cast<int64_t>(br) * C <= UINT32_MAX;
  const int path = !fits ? kWide : aligned ? kVec : kMasked;
  if (bf16)
    launch_path<__nv_bfloat16>(row, path, x, q, s, p, st);
  else
    launch_path<float>(row, path, x, q, s, p, st);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// tensor_quantize: x (n,) -> q (n,) fp8, s (1,) f32. The skeleton of
// kernels/csrc/tensor_absmax.cuh (shared with the int8 tensor_quantize):
// x read once into the resident blocks' registers, their maxima met at one
// grid-wide barrier inside one cooperative launch, the bytes from the
// registers; two launches only past the registers. The per-value
// arithmetic is the tile kernel's: quantize4<F, FAST>, for bf16 inputs
// with absmax below kFastMax the division by r = RN(1 / absmax) and an fma
// (div_fast), else __fdiv_rn.
// ---------------------------------------------------------------------------
template <int F, bool FAST>
struct Fp8Four {                     // four values' bytes of x / absmax
  float absmax, r;
  __device__ __forceinline__ uint32_t four(float a, float b, float c, float d) const {
    return quantize4<F, FAST>(a, b, c, d, absmax, r);
  }
};

template <int F>
struct Fp8Codec {
  template <int MODE, int G, typename T, int K>
  __device__ __forceinline__ static void cast(float absmax, tq::Vals<T> (&v)[K],
                                              const tq::Work<T>& w) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (absmax < kFastMax) {
        tq::cast_work<MODE, G>(Fp8Four<F, true>{absmax, __frcp_rn(absmax)}, v, w);
        return;
      }
    }
    tq::cast_work<MODE, G>(Fp8Four<F, false>{absmax, 0.f}, v, w);
  }

  // the K-major form's encoder: for bf16 inputs below kFastMax (fast) the
  // reciprocal's division, else __fdiv_rn
  template <typename T>
  __device__ __forceinline__ static bool fast(float absmax) {
    return std::is_same<T, __nv_bfloat16>::value && absmax < kFastMax;
  }
  template <bool FAST>
  __device__ __forceinline__ static Fp8Four<F, FAST> encoder(float absmax) {
    return Fp8Four<F, FAST>{absmax, FAST ? __frcp_rn(absmax) : 0.f};
  }
};

// __launch_bounds__ 2 blocks an SM: at most 128 registers a thread, so 264
// blocks on 132 SMs hold 8.65 M values in one launch
template <typename T, int G, int F, int MODE>
__global__ void __launch_bounds__(tq::kThreads, 2)
fp8_tensor_quantize_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
                           float* __restrict__ s, float* __restrict__ partial,
                           unsigned* __restrict__ bar, tq::Plan p) {
  tq::quantize<T, G, MODE, Fp8Codec<F>>(x, q, s, partial, bar, p);
}

// tensor_quantize_kt: the same codes and state, and qk (C, R), the K-major
// copy of q that the forward GEMMs read, from the same registers (the
// skeleton's tile split, tq::quantize_kt)
template <typename T, int G, int F, int MODE>
__global__ void __launch_bounds__(tq::kThreads, 2)
fp8_tensor_quantize_kt_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
                              uint8_t* __restrict__ qk, float* __restrict__ s,
                              float* __restrict__ partial, unsigned* __restrict__ bar,
                              tq::TilePlan p) {
  tq::quantize_kt<T, G, MODE, Fp8Codec<F>>(x, q, qk, s, partial, bar, p);
}

struct Fp8Kernels {                  // the launcher's family (tq::run): format 0 or 1
  template <typename T, int G, int MODE>
  static tq::Kernel<T> kernel(int fmt) {
    if (fmt) return fp8_tensor_quantize_kernel<T, G, 1, MODE>;
    return fp8_tensor_quantize_kernel<T, G, 0, MODE>;
  }
  template <typename T, int G, int MODE>
  static tq::KtKernel<T> kernel_kt(int fmt) {
    if (fmt) return fp8_tensor_quantize_kt_kernel<T, G, 1, MODE>;
    return fp8_tensor_quantize_kt_kernel<T, G, 0, MODE>;
  }
};

// ---------------------------------------------------------------------------
// The fp8 GEMMs (see the note at the top).
// ---------------------------------------------------------------------------
constexpr int BM = 128;                   // output rows of a block (two warpgroups of 64)
constexpr int BN = 128;                   // output columns of a block
constexpr int BK = 128;                   // the longest window: one 128-byte row of a tile
constexpr int TILE = BM * BK;             // bytes of a stage's A or W tile (BN == BM)
constexpr int kGemmThreads = 384;         // producer warpgroup + two consumer warpgroups
constexpr int kMaxStages = 6;
constexpr int kSmemMax = 232448;          // dynamic shared memory a block may use
constexpr int kFbBytes = 64 * 128 + BN * 128;  // one consumer's bf16 A (64 x 64) and W (BN x 64)

struct Gemm {
  const uint8_t* x;          // x_q (B, K) fp8, format fa
  const uint8_t* w;          // w_q (M, K) fp8, format fw: W K-major
  int B, K, M, fa, fw;
  int bk, nbk;               // the contraction's tiles: mixed's scale tiles, dequant's k-blocks
  int tma, stages;           // set by the launcher
  const float* row_scale;    // dequant: (B,)
  const void* x16;           // mixed: (B, K), f32 or bf16 (x16_bf16)
  int x16_bf16;
  const float* s_blk;        // mixed: (nbr, nbk)
  const float* fb_blk;       // mixed: (nbr, nbk), nonzero where the tile falls back
  const float* s_w;          // mixed: (1,)
  int br;                    // mixed: rows of a scale tile
  void* y;                   // (B, M), f32 or bf16 (y_bf16)
  int y_bf16;
};

struct Smem {
  uint8_t *a, *b, *fb;
  uint64_t *full, *empty;
};

// the stages' A and W tiles, the consumers' bf16 tiles and the barriers,
// every tile 1,024-byte aligned
__device__ __forceinline__ Smem carve(uint8_t* raw, int stages, bool mixed) {
  uint8_t* p = raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
  Smem s;
  s.a = p;
  s.b = p + stages * TILE;
  s.fb = s.b + stages * TILE;
  s.full = reinterpret_cast<uint64_t*>(s.fb + (mixed ? 2 * kFbBytes : 0));
  s.empty = s.full + kMaxStages;
  return s;
}

size_t gemm_smem_bytes(int stages, bool mixed) {
  return 1024 + 2 * static_cast<size_t>(stages) * TILE + (mixed ? 2 * kFbBytes : 0) +
         2 * kMaxStages * sizeof(uint64_t);
}

// the masked path: rows [r0, r0 + 128) x contraction [k0, k1) of an (R, K)
// K-major matrix into a swizzled tile, zeros elsewhere (one 16-byte chunk
// of the tile per step)
__device__ void load_rows(uint8_t* dst, const uint8_t* __restrict__ src, int R, int K, int r0,
                          int k0, int k1, int t) {
  for (int c = t; c < 128 * 8; c += 128) {
    const int r = c >> 3, ch = c & 7, row = r0 + r;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (row < R) {
      const uint8_t* p = src + static_cast<size_t>(row) * K;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int k = k0 + ch * 16 + e;
        if (k < k1) v[e >> 2] |= static_cast<uint32_t>(p[k]) << (8 * (e & 3));
      }
    }
    *reinterpret_cast<uint4*>(dst + sw128(r * 128 + ch * 16)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// the producer warpgroup: fills stage s for each window in order, by TMA
// from one thread (the other warps leave) or, on the masked path, by all
// 128 threads
__device__ void produce(const Gemm& g, const CUtensorMap* tm_a, const CUtensorMap* tm_w,
                        const Smem& sm, int row0, int col0) {
  const int t = threadIdx.x;
  if (g.tma && t >= 32) return;
  int s = 0;
  uint32_t ph = 0;
  for (int kt = 0; kt < g.nbk; ++kt) {
    const int kb = kt * g.bk, ke = min(kb + g.bk, g.K);
    for (int k0 = kb; k0 < ke; k0 += BK) {
      uint8_t* a = sm.a + s * TILE;
      uint8_t* b = sm.b + s * TILE;
      mbar_wait(&sm.empty[s], ph ^ 1u);
      if (g.tma) {
        if (t == 0) {
          mbar_expect_tx(&sm.full[s], 2 * TILE);
          tma_load_2d(a, tm_a, &sm.full[s], k0, row0);
          tma_load_2d(b, tm_w, &sm.full[s], k0, col0);
        }
      } else {
        const int k1 = min(k0 + BK, ke);
        load_rows(a, g.x, g.B, g.K, row0, k0, k1, t);
        load_rows(b, g.w, g.M, g.K, col0, k0, k1, t);
        fence_proxy_async();
        mbar_arrive(&sm.full[s]);
      }
      if (++s == g.stages) {
        s = 0;
        ph ^= 1u;
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// element (row, k) of x16 widened to f32 (bf16 values are exact in f32)
__device__ __forceinline__ float x16_at(const Gemm& g, size_t i) {
  return g.x16_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(g.x16)[i])
                    : static_cast<const float*>(g.x16)[i];
}

// fp8_mixed_matmul's fallback product of window [k0, k1) for one consumer
// warpgroup (rows wrow0..wrow0 + 63, thread t of 128): bf16(x16) against
// bf16(decode(w) * s_w), built 64 k at a time in the warpgroup's own
// swizzled tiles, into `part` (overwritten)
__device__ __forceinline__ void fallback_product(const Gemm& g, float (&part)[64], uint8_t* a16,
                                                 const uint8_t* b8, int wrow0, int k0, int k1,
                                                 float sw, int cw, int t) {
  uint8_t* w16 = a16 + 64 * 128;
  const Fmt fw = fmt_of(g.fw);
  for (int h = 0; h < 2; ++h) {
    const int h0 = k0 + 64 * h;
    if (h0 >= k1) break;
    const int h1 = min(h0 + 64, k1);
    for (int c = t; c < 64 * 8; c += 128) {
      const int r = c >> 3, ch = c & 7, row = wrow0 + r;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = h0 + ch * 8 + e;
        v[e] = row < g.B && k < h1 ? x16_at(g, static_cast<size_t>(row) * g.K + k) : 0.f;
      }
      *reinterpret_cast<uint4*>(a16 + sw128(r * 128 + ch * 16)) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                     pack_bf16(v[6], v[7]));
    }
    for (int c = t; c < BN * 8; c += 128) {
      const int n = c >> 3, ch = c & 7;
      const uint2 q = *reinterpret_cast<const uint2*>(b8 + sw128(n * 128 + 64 * h + 8 * ch));
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = __fmul_rn(decode(static_cast<uint8_t>((e < 4 ? q.x : q.y) >> (8 * (e & 3))), fw),
                         sw);
      *reinterpret_cast<uint4*>(w16 + sw128(n * 128 + ch * 16)) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                     pack_bf16(v[6], v[7]));
    }
    fence_proxy_async();
    named_sync(1 + cw, 128);
    const uint64_t da = sw128_desc(smem_u32(a16)), db = sw128_desc(smem_u32(w16));
    wgmma_fence();
    fence_frag(part);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (h0 + 16 * j < h1)
        wgmma_m64n128k16_bf16(part, desc_advance(da, 32 * j), desc_advance(db, 32 * j),
                              h > 0 || j > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_frag(part);
    named_sync(1 + cw, 128);               // the tiles are free for the next 64 k
  }
}

// a consumer warpgroup (cw = 0 or 1): rows row0 + 64 cw .. + 63, every
// window's fragment promoted into acc; then the epilogue
template <bool MIXED>
__device__ void consume(const Gemm& g, const Smem& sm, int row0, int col0, int cw) {
  const int t = threadIdx.x - 128 * (1 + cw);
  const int warp = t >> 5, lane = t & 31;
  const int wrow0 = row0 + 64 * cw;
  const int r_lo = wrow0 + 16 * warp + (lane >> 2), r_hi = r_lo + 8;
  const float sw = MIXED ? g.s_w[0] : 1.f;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int s = 0;
  uint32_t ph = 0;
  // mixed: each row's tile scale and fallback flag, loaded one tile ahead
  // of its use so that no window waits for them
  const size_t t_lo = MIXED ? static_cast<size_t>(min(r_lo, g.B - 1) / g.br) * g.nbk : 0;
  const size_t t_hi = MIXED ? static_cast<size_t>(min(r_hi, g.B - 1) / g.br) * g.nbk : 0;
  float s_lo_next = 1.f, s_hi_next = 1.f, f_lo_next = 0.f, f_hi_next = 0.f;
  if (MIXED && wrow0 < g.B && g.nbk > 0) {
    s_lo_next = g.s_blk[t_lo];
    s_hi_next = g.s_blk[t_hi];
    f_lo_next = g.fb_blk[t_lo];
    f_hi_next = g.fb_blk[t_hi];
  }
  for (int kt = 0; kt < g.nbk; ++kt) {
    const int kb = kt * g.bk, ke = min(kb + g.bk, g.K);
    bool fb_lo = false, fb_hi = false, need16 = false;
    float sc_lo = 1.f, sc_hi = 1.f;
    if (MIXED && wrow0 < g.B) {
      fb_lo = f_lo_next != 0.f;
      fb_hi = f_hi_next != 0.f;
      // a row that falls back adds 0 * fragment (acc is never -0)
      sc_lo = fb_lo ? 0.f : __fmul_rn(s_lo_next, sw);
      sc_hi = fb_hi ? 0.f : __fmul_rn(s_hi_next, sw);
      // the warpgroup runs the bf16 product when any of its rows falls back
      need16 = sync_any(fb_lo || fb_hi, 1 + cw, 128);
      if (kt + 1 < g.nbk) {
        s_lo_next = g.s_blk[t_lo + kt + 1];
        s_hi_next = g.s_blk[t_hi + kt + 1];
        f_lo_next = g.fb_blk[t_lo + kt + 1];
        f_hi_next = g.fb_blk[t_hi + kt + 1];
      }
    }
    for (int k0 = kb; k0 < ke; k0 += BK) {
      const int k1 = min(k0 + BK, ke), nslab = (k1 - k0 + 31) >> 5;
      mbar_wait(&sm.full[s], ph);
      if (wrow0 < g.B) {
        const uint64_t da = sw128_desc(smem_u32(sm.a + s * TILE + cw * 64 * 128));
        const uint64_t db = sw128_desc(smem_u32(sm.b + s * TILE));
        wgmma_fence();
        fence_frag(part);
        wgmma_fp8_steps(part, da, db, nslab, g.fa, g.fw);
        wgmma_commit();
        wgmma_wait0();
        fence_frag(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          if (!MIXED) {
            acc[i] = __fadd_rn(acc[i], part[i]);
          } else {
            acc[i] = __fmaf_rn(part[i], ((i >> 1) & 1) ? sc_hi : sc_lo, acc[i]);
          }
        }
      }
      if (need16) {
        fallback_product(g, part, sm.fb + cw * kFbBytes, sm.b + s * TILE, wrow0, k0, k1, sw, cw,
                         t);
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (((i >> 1) & 1) ? fb_hi : fb_lo) acc[i] = __fadd_rn(acc[i], part[i]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
      if (++s == g.stages) {
        s = 0;
        ph ^= 1u;
      }
    }
  }
  // epilogue: y = acc (* row_scale), rounded once to the output type
  const float rs_lo = !MIXED && r_lo < g.B ? g.row_scale[r_lo] : 1.f;
  const float rs_hi = !MIXED && r_hi < g.B ? g.row_scale[r_hi] : 1.f;
  const bool pairs = (g.M & 1) == 0;
  const int c_base = col0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const bool hi = (i >> 1) & 1;
    const int row = hi ? r_hi : r_lo, col = c_base + 8 * (i >> 2);
    if (row >= g.B || col >= g.M) continue;
    float v0 = acc[i], v1 = acc[i + 1];
    if (!MIXED) {
      v0 = __fmul_rn(v0, hi ? rs_hi : rs_lo);
      v1 = __fmul_rn(v1, hi ? rs_hi : rs_lo);
    }
    const size_t at = static_cast<size_t>(row) * g.M + col;
    const bool both = col + 1 < g.M;
    if (g.y_bf16) {
      __nv_bfloat16* y = static_cast<__nv_bfloat16*>(g.y);
      if (pairs && both) {
        *reinterpret_cast<__nv_bfloat162*>(y + at) = __floats2bfloat162_rn(v0, v1);
      } else {
        y[at] = __float2bfloat16_rn(v0);
        if (both) y[at + 1] = __float2bfloat16_rn(v1);
      }
    } else {
      float* y = static_cast<float*>(g.y);
      if (pairs && both) {
        *reinterpret_cast<float2*>(y + at) = make_float2(v0, v1);
      } else {
        y[at] = v0;
        if (both) y[at + 1] = v1;
      }
    }
  }
}

template <bool MIXED>
__global__ void __launch_bounds__(kGemmThreads, 1)
fp8_gemm_kernel(__grid_constant__ const CUtensorMap tm_a, __grid_constant__ const CUtensorMap tm_w,
                const Gemm g) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve(smem_raw, g.stages, MIXED);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  if (threadIdx.x == 0) {
    // full: the TMA bytes and their issuer's arrival, or the 128 producer
    // threads' arrivals on the masked path; empty: the 8 consumer warps
    for (int i = 0; i < g.stages; ++i) {
      mbar_init(&sm.full[i], g.tma ? 1u : 128u);
      mbar_init(&sm.empty[i], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // 128 x 56 + 256 x 224 registers = 384 x 168, the launch's allocation
  if (threadIdx.x < 128) {
    regs_dec<56>();
    produce(g, &tm_a, &tm_w, sm, row0, col0);
  } else {
    regs_inc<224>();
    consume<MIXED>(g, sm, row0, col0, threadIdx.x / 128 - 1);
  }
}

// the TMA map of a row-major (rows, cols) byte matrix in 128-byte-swizzled
// boxes of 128 x 128 (a stage tile)
bool tma_map(CUtensorMap* m, const void* p, int rows, int cols) {
  return tma_map_2d(m, p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, cols, 128, 128);
}

template <bool MIXED>
int launch_gemm(Gemm g, cudaStream_t st) {
  if (g.B <= 0 || g.M <= 0) return static_cast<int>(cudaGetLastError());
  // the TMA path: 16-byte row pitches and windows on 128-column boundaries
  g.tma = g.K > 0 && g.K % 16 == 0 && aligned16(g.x) && aligned16(g.w) &&
          (g.nbk == 1 || g.bk % BK == 0);
  CUtensorMap ma, mw;
  memset(&ma, 0, sizeof(ma));
  memset(&mw, 0, sizeof(mw));
  if (g.tma && !(tma_map(&ma, g.x, g.B, g.K) && tma_map(&mw, g.w, g.M, g.K)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t fixed = gemm_smem_bytes(0, MIXED), per = gemm_smem_bytes(1, MIXED) - fixed;
  g.stages = static_cast<int>(std::min<size_t>(kMaxStages, (kSmemMax - fixed) / per));
  const size_t bytes = gemm_smem_bytes(g.stages, MIXED);
  cudaFuncSetAttribute(fp8_gemm_kernel<MIXED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  dim3 grid((g.M + BN - 1) / BN, (g.B + BM - 1) / BM);
  fp8_gemm_kernel<MIXED><<<grid, kGemmThreads, bytes, st>>>(ma, mw, g);
  return static_cast<int>(cudaGetLastError());
}

Gemm gemm_args(const void* x_q, int fx, const void* w_q, int fw, void* y, int y_bf16, int B,
               int K, int M, int bk) {
  Gemm g;
  memset(&g, 0, sizeof(g));
  g.x = static_cast<const uint8_t*>(x_q);
  g.w = static_cast<const uint8_t*>(w_q);
  g.B = B;
  g.K = K;
  g.M = M;
  g.fa = fx;
  g.fw = fw;
  g.bk = bk > 0 ? bk : 1;
  g.nbk = (K + g.bk - 1) / g.bk;
  g.y = y;
  g.y_bf16 = y_bf16;
  return g;
}

// the forward's W (R = K, C = M) as the K-major (C, R) bytes the GEMMs read:
// 128 x 128 byte tiles through shared memory, 4-byte words where the rows
// allow (bound by bytes: W read once, written once)
__global__ void __launch_bounds__(256)
transpose_bytes_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int R, int C) {
  __shared__ uint8_t tile[128][132];
  const int r0 = blockIdx.y * 128, c0 = blockIdx.x * 128;
  const bool words_in = (C & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3u) == 0;
  const bool words_out = (R & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 3u) == 0;
  for (int i = threadIdx.x; i < 128 * 32; i += 256) {
    const int r = i >> 5, row = r0 + r, col = c0 + 4 * (i & 31);
    uint32_t v = 0u;
    if (row < R) {
      const uint8_t* p = src + static_cast<size_t>(row) * C + col;
      if (words_in && col < C) {
        v = *reinterpret_cast<const uint32_t*>(p);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < C) v |= static_cast<uint32_t>(p[e]) << (8 * e);
      }
    }
    *reinterpret_cast<uint32_t*>(&tile[r][4 * (i & 31)]) = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 128 * 32; i += 256) {
    const int c = i >> 5, w = i & 31, orow = c0 + c, ocol = r0 + 4 * w;
    if (orow >= C) continue;
    const uint32_t v = static_cast<uint32_t>(tile[4 * w][c]) |
                       (static_cast<uint32_t>(tile[4 * w + 1][c]) << 8) |
                       (static_cast<uint32_t>(tile[4 * w + 2][c]) << 16) |
                       (static_cast<uint32_t>(tile[4 * w + 3][c]) << 24);
    uint8_t* p = dst + static_cast<size_t>(orow) * R + ocol;
    if (words_out && ocol < R) {
      *reinterpret_cast<uint32_t*>(p) = v;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (ocol + e < R) p[e] = static_cast<uint8_t>(v >> (8 * e));
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma_probe: one warpgroup runs the GEMMs' own instruction chain on given
// operands: d (64 x 128 f32) = a . b^T, a 64 rows and b 128 rows of 128
// bytes, both K-major and swizzled as a stage tile. Mode 0: E4M3 x E4M3,
// `steps` chained m64n128k32 steps (wgmma_fp8_steps, one window of the
// GEMM); 1: E5M2 x E4M3; 2: bf16 x bf16, `steps` chained m64n128k16 steps
// of 64-value rows (as fallback_product); 3: the same bf16 values laid out
// MN-major (a and b transposed in shared memory, b in two 64-column blocks)
// through the transposed m64n128k16 form, as wgrad_bf16 issues it.
// Constructed operands show how wide the tensor cores add (chip_smoke.py).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                   float* __restrict__ d, int mode, int steps) {
  __shared__ uint8_t raw[1024 + 192 * 128];
  uint8_t* sa = raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
  uint8_t* sb = sa + 64 * 128;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (mode < 3) {
    for (int i = t; i < 64 * 128; i += 128) sa[sw128(i)] = a[i];
    for (int i = t; i < 128 * 128; i += 128) sb[sw128(i)] = b[i];
  } else {                       // bf16 (row, k) -> row k of its 64-column block
    const uint16_t* a16 = reinterpret_cast<const uint16_t*>(a);
    const uint16_t* b16 = reinterpret_cast<const uint16_t*>(b);
    for (int i = t; i < 64 * 64; i += 128) {
      const int r = i >> 6, k = i & 63;
      *reinterpret_cast<uint16_t*>(sa + sw128(k * 128 + 2 * r)) = a16[i];
    }
    for (int i = t; i < 128 * 64; i += 128) {
      const int r = i >> 6, k = i & 63;
      *reinterpret_cast<uint16_t*>(sb + 64 * 128 * (r >> 6) + sw128(k * 128 + 2 * (r & 63))) =
          b16[i];
    }
  }
  fence_proxy_async();
  __syncthreads();
  float f[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) f[i] = 0.f;
  const uint64_t da = sw128_desc(smem_u32(sa)), db = sw128_desc(smem_u32(sb));
  wgmma_fence();
  fence_frag(f);
  if (mode < 2) {
    wgmma_fp8_steps(f, da, db, steps, mode, 0);
  } else if (mode == 2) {
    for (int j = 0; j < steps; ++j)
      wgmma_m64n128k16_bf16(f, desc_advance(da, 32 * j), desc_advance(db, 32 * j), j > 0);
  } else {
    const uint64_t ta = sw128_mn_desc(smem_u32(sa), 64 * 128);
    const uint64_t tb = sw128_mn_desc(smem_u32(sb), 64 * 128);
    for (int j = 0; j < steps; ++j)
      wgmma_m64n128k16_bf16<1>(f, desc_advance(ta, 2048 * j), desc_advance(tb, 2048 * j), j > 0);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_frag(f);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    d[(16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1)) * 128 + 8 * (i >> 2) + 2 * (lane & 3) +
      (i & 1)] = f[i];
}

// encode_check: every f32 bit pattern y (and ~y beside it, so that both
// bytes of a conversion are read) through the quantizers' conversion,
// fp8x2(clip_nan(y)), against encode(grid_round(y)), the plain
// construction; counts the bytes that differ into *bad (zeroed by the
// caller). 2^32 patterns, a few milliseconds.
template <int F>
__global__ void __launch_bounds__(kThreads) encode_check_kernel(unsigned long long* bad) {
  const Fmt f = fmt_of(F);
  unsigned long long n = 0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < (uint64_t{1} << 32); i += stride) {
    const float y = __uint_as_float(static_cast<uint32_t>(i));
    const float z = __uint_as_float(~static_cast<uint32_t>(i));
    const uint32_t got = fp8x2<F>(clip_nan<F>(y), clip_nan<F>(z));
    n += (got & 0xffu) != encode(grid_round(y, f), f);
    n += (got >> 8) != encode(grid_round(z, f), f);
  }
  n = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(n));
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(bad, n);
}

// divide_check: every bf16 x against every absmax a bf16 tile can have
// below kFastMax (block b < kDivideBlocks - 1: the bf16 with bits b, when
// 1e-12 <= it < kFastMax; the last block: the floor 1e-12 itself), where
// |x| <= a or x is NaN (a tile's absmax is at least each |x|, and fmaxf
// passes NaN over): div_fast(x, a, RN(1 / a)) against __fdiv_rn(x, a). Counts
// into *bad (zeroed by the caller) the pairs whose E4M3 byte differs, whose
// E5M2 byte differs, and whose quotient's bits differ where |x| >= 2^-100
// and the quotient is normal. 1.4 G pairs, a few milliseconds.
constexpr int kDivideBlocks = 0x7f80 + 1;     // the positive finite bf16 patterns, then the floor

__global__ void __launch_bounds__(kThreads) divide_check_kernel(unsigned long long* bad) {
  const float a = blockIdx.x == kDivideBlocks - 1 ? kEps : __uint_as_float(blockIdx.x << 16);
  if (!(a >= kEps && a < kFastMax)) return;                  // the whole block
  const float r = __frcp_rn(a);
  unsigned n = 0;
  for (int i = threadIdx.x; i < 1 << 16; i += blockDim.x) {
    const float x = __uint_as_float(static_cast<uint32_t>(i) << 16);
    if (!(fabsf(x) <= a || isnan(x))) continue;
    const float y = div_fast(x, a, r), z = __fdiv_rn(x, a);
    n += fp8x2<0>(clip_nan<0>(y), 0.f) != fp8x2<0>(clip_nan<0>(z), 0.f);
    n += fp8x2<1>(clip_nan<1>(y), 0.f) != fp8x2<1>(clip_nan<1>(z), 0.f);
    n += fabsf(x) >= 7.88860905e-31f && fabsf(z) >= 1.17549435e-38f &&   // 2^-100, 2^-126
         __float_as_uint(y) != __float_as_uint(z);
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(bad, static_cast<unsigned long long>(n));
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
  return quantize_tiles_launch(true, x, bf16, q, s, B, K, 1, K, fmt,
                               static_cast<cudaStream_t>(stream));
}

// partial: scratch of tq::kMaxPartials floats; bar: the two-word barrier
// workspace, zero and left zero (see tensor_absmax.cuh)
int f8_tensor_quantize(const void* x, int bf16, int64_t n, void* partial, void* bar, void* q,
                       void* s, int fmt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? tq::run<__nv_bfloat16, Fp8Kernels>(x, q, s, partial, bar, n, fmt, -1, st)
              : tq::run<float, Fp8Kernels>(x, q, s, partial, bar, n, fmt, -1, st);
}

// the control fault of the checks: block `drop`'s partial left out of the
// absmax (not a path's entry point)
int f8_tensor_quantize_drop(const void* x, int bf16, int64_t n, void* partial, void* bar, void* q,
                            void* s, int fmt, int drop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? tq::run<__nv_bfloat16, Fp8Kernels>(x, q, s, partial, bar, n, fmt, drop, st)
              : tq::run<float, Fp8Kernels>(x, q, s, partial, bar, n, fmt, drop, st);
}

// out (5,) host ints: the plan tensor_quantize takes for these pointers and n
int f8_tensor_quantize_plan(const void* x, int bf16, const void* q, int64_t n, int* out) {
  return bf16 ? tq::plan<__nv_bfloat16, Fp8Kernels>(x, q, n, out)
              : tq::plan<float, Fp8Kernels>(x, q, n, out);
}

// x (R, C) -> q (R, C), qk (C, R) (q's bytes, K-major: the forward GEMMs'
// W), s (1,); partial and bar as f8_tensor_quantize
int f8_tensor_quantize_kt(const void* x, int bf16, int64_t R, int64_t C, void* partial,
                          void* bar, void* q, void* qk, void* s, int fmt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? tq::run_kt<__nv_bfloat16, Fp8Kernels>(x, q, qk, s, partial, bar, R, C, fmt, -1,
                                                      -1, st)
              : tq::run_kt<float, Fp8Kernels>(x, q, qk, s, partial, bar, R, C, fmt, -1, -1, st);
}

// the control faults of the checks: block `drop`'s partial left out of the
// absmax, block `skip`'s tile of qk left unwritten (-1: none; not a path's
// entry point)
int f8_tensor_quantize_kt_fault(const void* x, int bf16, int64_t R, int64_t C, void* partial,
                                void* bar, void* q, void* qk, void* s, int fmt, int drop,
                                int skip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? tq::run_kt<__nv_bfloat16, Fp8Kernels>(x, q, qk, s, partial, bar, R, C, fmt, drop,
                                                      skip, st)
              : tq::run_kt<float, Fp8Kernels>(x, q, qk, s, partial, bar, R, C, fmt, drop, skip,
                                              st);
}

// out (8,) host ints: the plan tensor_quantize_kt takes for these pointers
// and (R, C)
int f8_tensor_quantize_kt_plan(const void* x, int bf16, const void* q, const void* qk, int64_t R,
                               int64_t C, int* out) {
  return bf16 ? tq::plan_kt<__nv_bfloat16, Fp8Kernels>(x, q, qk, R, C, out)
              : tq::plan_kt<float, Fp8Kernels>(x, q, qk, R, C, out);
}

// s (ceil(R / br), ceil(C / bc)) f32, row-major; 1 <= br <= R, 1 <= bc <= C.
int f8_block_quantize(const void* x, int bf16, void* q, void* s, int R, int C, int br, int bc,
                      int fmt, void* stream) {
  return quantize_tiles_launch(false, x, bf16, q, s, R, C, br, bc, fmt,
                               static_cast<cudaStream_t>(stream));
}

// x_q (B, K), w_q (M, K), row_scale (B,) -> y (B, M) = (x_q . w_q^T) * row_scale;
// bk: the plain version's k-block (a multiple of 128, or K), which the
// windows respect. The forward (W (K, M)) comes here with the wrapper's
// K-major copy of W.
int f8_matmul_dequant_t(const void* x_q, int fx, const void* w_q, int fw, const void* row_scale,
                        void* y, int bf16, int B, int K, int M, int bk, void* stream) {
  Gemm g = gemm_args(x_q, fx, w_q, fw, y, bf16, B, K, M, bk);
  g.row_scale = static_cast<const float*>(row_scale);
  return launch_gemm<false>(g, static_cast<cudaStream_t>(stream));
}

// x16 (B, K), x_q (B, K), s_blk and fb_blk (ceil(B / br), ceil(K / bk)),
// w_q (M, K), s_w (1,) -> y (B, M); the forward, as above, with the
// wrapper's K-major copy of W.
int f8_mixed_matmul_t(const void* x16, int bf16_in, const void* x_q, int fx, const void* s_blk,
                      const void* fb_blk, const void* w_q, int fw, const void* s_w, void* y,
                      int bf16_out, int B, int K, int M, int br, int bk, void* stream) {
  Gemm g = gemm_args(x_q, fx, w_q, fw, y, bf16_out, B, K, M, bk);
  g.x16 = x16;
  g.x16_bf16 = bf16_in;
  g.s_blk = static_cast<const float*>(s_blk);
  g.fb_blk = static_cast<const float*>(fb_blk);
  g.s_w = static_cast<const float*>(s_w);
  g.br = br > 0 ? br : 1;
  return launch_gemm<true>(g, static_cast<cudaStream_t>(stream));
}

// src (R, C) bytes -> dst (C, R): the forward's W made K-major.
int f8_transpose_bytes(const void* src, void* dst, int R, int C, void* stream) {
  if (R > 0 && C > 0) {
    dim3 grid((C + 127) / 128, (R + 127) / 128);
    transpose_bytes_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), R, C);
  }
  return static_cast<int>(cudaGetLastError());
}

// a (64, 128) and b (128, 128) bytes, d (64, 128) f32, all on the card;
// steps 1-4, mode 0-3 (wgmma_probe_kernel)
int f8_wgmma_probe(const void* a, const void* b, void* d, int mode, int steps, void* stream) {
  wgmma_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), static_cast<float*>(d),
      mode, steps);
  return static_cast<int>(cudaGetLastError());
}

// bad (1,) uint64 on the card, zeroed: the bytes where the quantizers'
// conversion and encode(grid_round(y)) differ over every f32 y, format fmt
int f8_encode_check(int fmt, void* bad, void* stream) {
  auto* k = fmt ? encode_check_kernel<1> : encode_check_kernel<0>;
  k<<<132 * 16, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}

// bad (1,) uint64 on the card, zeroed: the differences between the bf16
// quantizers' division and __fdiv_rn that divide_check_kernel counts
int f8_divide_check(void* bad, void* stream) {
  divide_check_kernel<<<kDivideBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
