// The fp8 formats and the rounding onto their grid, shared by the fp8
// kernels (kernels/fp8_matmul/csrc/fp8_matmul.cu and
// kernels/fp8_cast/csrc/fp8_cast.cu): the one definition of grid_round.
//
// grid_round is the port's core/quantization.py fp8_grid_round (the JAX
// package's fp8_grid_round) bit for bit: clip; round half to even at the
// format's mantissa width by adding half an ulp, less one, plus the kept
// lsb, to the magnitude's bits and clearing the dropped bits; in the
// fp8-subnormal range the fixed step 2^(1 - bias - man). Its result lies
// on the fp8 grid, so encoding it as a byte, or widening that byte back
// to f32, is exact.
//
// kernels/build.py hashes this header into the name of every library
// whose source includes it, so an edit here rebuilds both.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// format 0 = E4M3 (3 mantissa bits, bias 7, max 448), 1 = E5M2 (2, 15, 57344)
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

__device__ __forceinline__ float clip(float x, float m) { return fminf(fmaxf(x, -m), m); }

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

}  // namespace
