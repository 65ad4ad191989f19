// Tensor-wise fp8 cast for Hopper (sm_90a), bound through a plain C
// interface (loaded with ctypes by kernels/fp8_cast/build.py).
//
// Replaces the Pallas TPU kernel fp8_cast_tensorwise
// (repro/kernels/fp8_cast/fp8_cast.py:32, body :22): the simulated-fp8
// cast of the paper (§2.2.1),
//
//   q = grid_round(clip(x * (1 / max(absmax, 1e-12)), -fmax, fmax))  in f32,
//
// x (n,) in f32 or bf16, absmax one f32 value in device memory, q (n,) f32
// holding exact fp8 values (E4M3 or E5M2).
//
// Numerics copy the Pallas kernel, not the JAX package's XLA path: the
// reciprocal first, one IEEE division (__fdiv_rn) per thread, then the
// product (__fmul_rn). The XLA path divides x / absmax, which rounds to
// the other fp8 neighbour wherever the two f32 values fall on opposite
// sides of an fp8 tie. grid_round is the shared one of
// kernels/csrc/fp8_grid.cuh; its result is an fp8 value, so the Pallas
// kernel's cast to the fp8 dtype and back is the identity here and q is
// stored as grid_round's f32. The plain version (kernels/fp8_cast/ref.py)
// does the same operations and agrees bit for bit.
//
// What bounds it on an H100: bytes. Each element is read once (4 or 2
// bytes) and written once (4 bytes), with a handful of integer and float
// operations between: at CLIP's shapes X 4,128 x 1,280 bf16 moves 31.7 MB
// (9.5 us at 3.35 TB/s) and W 1,280 x 5,120 f32 52.4 MB (15.6 us). The
// design: a grid-stride elementwise pass, each thread loading 16 bytes at
// a time (4 f32 or 8 bf16) and storing f32 four at a time, neighbouring
// threads on neighbouring addresses. absmax is read by the kernel itself
// (no host sync). The TPU kernel's 512-row blocks only size its VMEM
// tiles; the elementwise function has no row structure, so none is kept.
// A pointer off 16-byte alignment takes the same kernel one element at a
// time.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/fp8_grid.cuh"

namespace {

constexpr float kEps = 1e-12f;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;    // grid-stride beyond 132 SMs x 2048 threads

__device__ __forceinline__ float cast_one(float x, float inv, const Fmt& f) {
  return grid_round(clip(__fmul_rn(x, inv), f.fmax), f);
}

// VEC consecutive elements as f32: one 16-byte load when VEC > 1.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ x, int64_t i, float* v);

template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* __restrict__ x, int64_t i,
                                                   float* v) {
  v[0] = x[i];
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(const __nv_bfloat16* __restrict__ x,
                                                           int64_t i, float* v) {
  v[0] = __bfloat162float(x[i]);
}
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* __restrict__ x, int64_t i,
                                                   float* v) {
  const float4 r = reinterpret_cast<const float4*>(x)[i];
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 8>(const __nv_bfloat16* __restrict__ x,
                                                           int64_t i, float* v) {
  const uint4 r = reinterpret_cast<const uint4*>(x)[i];
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // a bf16 is the high half of its f32: widening is a shift
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ out, int64_t i, const float* v) {
  if constexpr (VEC == 1) {
    out[i] = v[0];
  } else {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j)
      reinterpret_cast<float4*>(out)[i * (VEC / 4) + j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
}

// VEC elements per thread per step over the n / VEC whole vectors, then
// the n % VEC tail one element per thread.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fp8_cast_kernel(const T* __restrict__ x, const float* __restrict__ absmax,
                float* __restrict__ out, int64_t n, int fmt) {
  const Fmt f = fmt_of(fmt);
  const float inv = __fdiv_rn(1.0f, fmaxf(*absmax, kEps));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_vec = n / VEC;
  for (int64_t i = first; i < n_vec; i += stride) {
    float v[VEC];
    load_vec<T, VEC>(x, i, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = cast_one(v[j], inv, f);
    store_vec<VEC>(out, i, v);
  }
  for (int64_t i = n_vec * VEC + first; i < n; i += stride) {
    float v[1];
    load_vec<T, 1>(x, i, v);
    out[i] = cast_one(v[0], inv, f);
  }
}

template <typename T, int VEC>
void launch(const void* x, const float* absmax, float* out, int64_t n, int fmt,
            cudaStream_t stream) {
  const int64_t work = n / VEC + n % VEC;
  const int blocks = static_cast<int>(
      work / kThreads + 1 < kMaxBlocks ? work / kThreads + 1 : kMaxBlocks);
  fp8_cast_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x), absmax,
                                                           out, n, fmt);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// x (n,) f32 (x_bf16 = 0) or bf16 (1); absmax one f32; out (n,) f32;
// fmt 0 = E4M3, 1 = E5M2.
int fc_fp8_cast_tensorwise(const void* x, int x_bf16, const float* absmax, float* out,
                           int64_t n, int fmt, cudaStream_t stream) {
  if (n > 0) {
    const bool vec = aligned16(x) && aligned16(out);
    if (x_bf16)
      vec ? launch<__nv_bfloat16, 8>(x, absmax, out, n, fmt, stream)
          : launch<__nv_bfloat16, 1>(x, absmax, out, n, fmt, stream);
    else
      vec ? launch<float, 4>(x, absmax, out, n, fmt, stream)
          : launch<float, 1>(x, absmax, out, n, fmt, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
