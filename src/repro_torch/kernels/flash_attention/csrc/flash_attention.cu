// Flash-attention forward kernels for Hopper (sm_90a), bound through a plain
// C interface (loaded with ctypes by kernels/flash_attention/build.py).
//
// Two kernels, each replacing one Pallas TPU kernel of the JAX package:
//
//   flash_fwd   <- repro/kernels/flash_attention/flash_attention.py:flash_fwd
//                  (_fwd_kernel): causal or full softmax attention, o and the
//                  per-row logsumexp, for prefill
//   decode_fwd  <- repro/kernels/flash_attention/flash_attention.py:decode_fwd
//                  (_decode_kernel): one query per slot against the ring KV
//                  cache, per-slot valid lengths, for every decode step
//
// What they compute (the plain versions are kernels/flash_attention/ref.py):
// scores s = (q * scale) . k in f32, q scaled in f32 before the product as
// the TPU kernel does; keys past the valid length, and with `causal` keys
// past the query's position, take the finite MASK_VALUE = -0.7 * FLT_MAX
// (never -inf: exp(-inf - -inf) is NaN); an online softmax over tiles of 32
// keys keeps a running max m, sum l and unnormalised output acc in f32:
//   m' = max(m, max_j s_j), p_j = exp(s_j - m'), alpha = exp(m - m'),
//   l' = l * alpha + sum_j p_j, acc' = acc * alpha + sum_j p_j v_j.
// A row with no live key yet has m == MASK_VALUE and p == 1; the first
// live tile corrects it through alpha = exp(MASK_VALUE - m_real) = 0. Key 0
// is always live (the wrappers ask kv_valid >= 1; causal rows hold key 0),
// and tile 0 is every row's first, so no final row is dry. At the end
// o = acc / l_safe (l_safe = 1 where l == 0), rounded once to the output
// type (__float2bfloat16_rn), and lse = m + log(l_safe) stays f32. All in
// IEEE f32: expf/logf, __fdiv_rn, no --use_fast_math.
//
// Layouts are the model's, read through the kernels' own offsets (no
// transposes, no padding): q, o (B, Sq, H, hd); k, v (B, Sk, KV, hd), the
// ring cache in its storage layout for decode; lse (B, H, Sq). GQA is
// native: query head h reads KV head h / (H / KV) (jnp.repeat order), and a
// block works on one KV head, so each K/V tile it loads serves the whole
// query group.
//
// What bounds them on this card: at the serve path's shapes both move a
// few MB (bytes over 3.35 TB/s is 1-2 us) and compute far less than the
// tensor cores could, so the bound is bytes; the real cost is latency and
// occupancy. These first kernels use f32 FMAs on the CUDA cores over tiles
// staged in shared memory as f32 (wgmma, TMA and split-KV across blocks
// are later work; an mma on bf16 for P.V would round p to bf16, which the
// reference does not). Their design answers occupancy:
//   * flash_fwd: a block owns one (batch, KV head) and 16 query rows of
//     the flattened (position, head-in-group) row space, so a block holds
//     16/group positions of the whole group. The TPU's 128-row q tiles
//     would give the path (B 8, KV 5, Sq <= 128) only 40 blocks for 132
//     SMs; 16 rows give 960 blocks at Sq = 128 and 240 at Sq = 32. Four
//     warps, four rows each; a lane owns one key of the 32-key tile for
//     the scores and dims lane + 32 i of the output. KV tiles past the
//     block's last live key (causal diagonal or kv_valid) are skipped.
//   * decode_fwd: a block owns one (slot, KV head): `group` query rows.
//     Its eight warps (four above hd 96, where eight warps' tiles would
//     overflow shared memory) split the slot's live tiles round-robin (a slot
//     kv_len tokens in walks ceil(kv_len / 32) tiles; dead tiles are
//     neither loaded nor computed; at S_max 256 each warp takes one), each
//     warp staging its own K and V tiles, and merge their (m, l, acc) at
//     the end. The cache's S_max need not be a multiple of the tile: the
//     ragged tile is masked.
//   Tiles are staged with 16-byte loads where the rows allow it, so a
//   tile costs one memory latency, not one per key.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

// the JAX package's MASK_VALUE (-0.7 * f32 max, rounded once to f32)
constexpr float kMask = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));
constexpr int kTile = 32;          // keys per tile: one per lane for the scores
constexpr int kFwdWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kFwdRows = kFwdWarps * kRowsPerWarp;   // flattened q rows per block
constexpr int kDecWarps = 8;       // 4 where 8 warps' tiles overflow shared memory
constexpr int kMaxGroup = 8;       // query heads per KV head (decode rows)
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// 16-byte loads: 8 bf16 or 4 f32 values widened to f32.
__device__ __forceinline__ void unpack(const uint4& raw, float* f, const float*) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* f, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Copy rows [0, n) of a (rows, hd) slab whose rows are `row_stride`
// elements apart into shared memory as f32 with pitch `pitch`; rows
// [n, kTile) are zeroed. Threads t, t + nt, ... of the block take part.
// Where every row starts on 16 bytes (the path's layouts do) each thread
// makes 16-byte loads, all independent, so one memory latency covers the
// tile; otherwise one element per load.
template <typename T>
__device__ __forceinline__ void stage_tile(float* dst, int pitch, const T* src,
                                           long long row_stride, int n, int hd,
                                           int t, int nt) {
  constexpr int kVec = 16 / sizeof(T);
  if (hd % kVec == 0 && row_stride % kVec == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int per_row = hd / kVec;
    for (int c = t; c < kTile * per_row; c += nt) {
      const int j = c / per_row, d0 = (c - j * per_row) * kVec;
      float f[kVec];
      if (j < n) {
        unpack(*reinterpret_cast<const uint4*>(src + j * row_stride + d0), f, src);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) f[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) dst[j * pitch + d0 + i] = f[i];
    }
    return;
  }
  for (int e = t; e < kTile * hd; e += nt) {
    const int j = e / hd, d = e - j * hd;
    dst[j * pitch + d] = j < n ? to_f32(src[j * row_stride + d]) : 0.f;
  }
}

// One warp, the first `rows` <= R rows (warp-uniform): scores of this
// lane's key (row `lane` of k_s, pitch hd + 1 so the 32 lanes read 32 banks
// for even hd) against pre-scaled q rows (rows q_row[r] of q_s, broadcast
// reads), in f32, summed over d in order.
template <int R>
__device__ __forceinline__ void scores(float (&s)[R], const float* q_s, const int (&q_row)[R],
                                       int rows, const float* k_s, int hd) {
  const int lane = threadIdx.x & 31;
  const float* kr = k_s + lane * (hd + 1);
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
  for (int d = 0; d < hd; ++d) {
    const float kd = kr[d];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < rows) s[r] = fmaf(q_s[q_row[r] * hd + d], kd, s[r]);
  }
}

// One warp, the first `rows` <= R rows: the online-softmax update with
// this tile's (masked) scores s[r] of this lane's key, and v rows j < n
// read through `v_at` (v_at(j, d) -> f32). acc[r][i] holds dim
// lane + 32 i of row r.
template <int R, int DPL, typename VAt>
__device__ __forceinline__ void online_update(const float (&s)[R], float (&m)[R], float (&l)[R],
                                              float (&acc)[R][DPL], int rows, int n, int hd,
                                              VAt v_at) {
  const int lane = threadIdx.x & 31;
  float p[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    p[r] = 0.f;
    if (r >= rows) continue;
    const float m_next = fmaxf(m[r], warp_max(s[r]));
    p[r] = expf(s[r] - m_next);
    const float alpha = expf(m[r] - m_next);
    l[r] = l[r] * alpha + warp_sum(p[r]);
    m[r] = m_next;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
  }
  for (int j = 0; j < n; ++j) {
    float vj[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      vj[i] = d < hd ? v_at(j, d) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) continue;
      const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vj[i], acc[r][i]);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_fwd: grid (ceil(Sq * group / 16), KV, B), 128 threads.
// Flattened row r of (b, hk) is query position r / group, head
// hk * group + r % group.
// ---------------------------------------------------------------------------
template <typename T, int DPL>
__global__ void __launch_bounds__(kFwdWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 int hd, int kv_valid, int causal, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                            // [kFwdRows][hd], scaled
  float* k_s = q_s + kFwdRows * hd;             // [kTile][hd + 1]
  float* v_s = k_s + kTile * (hd + 1);          // [kTile][hd]
  const int group = H / KV;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int n_rows = Sq * group;
  const int r0 = blockIdx.x * kFwdRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long kv_row = static_cast<long long>(KV) * hd;   // key stride
  const T* kb = k + static_cast<long long>(b) * Sk * kv_row + static_cast<long long>(hk) * hd;
  const T* vb = v + static_cast<long long>(b) * Sk * kv_row + static_cast<long long>(hk) * hd;

  for (int e = tid; e < kFwdRows * hd; e += blockDim.x) {
    const int rr = e / hd, d = e - rr * hd, r = r0 + rr;
    float x = 0.f;
    if (r < n_rows) {
      const int pos = r / group, h = hk * group + r % group;
      x = __fmul_rn(to_f32(q[(static_cast<long long>(b) * Sq + pos) * H * hd
                             + static_cast<long long>(h) * hd + d]), scale);
    }
    q_s[e] = x;
  }

  int q_row[kRowsPerWarp], pos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    q_row[i] = warp * kRowsPerWarp + i;
    pos[i] = (r0 + q_row[i]) / group;
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;
  }
  // live keys of the block: below kv_valid and, causal, up to its last row
  int n_live = min(kv_valid, Sk);
  if (causal) n_live = min(n_live, (min(r0 + kFwdRows, n_rows) - 1) / group + 1);
  const int n_tiles = (n_live + kTile - 1) / kTile;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j0 = kt * kTile, n = min(kTile, n_live - j0);
    __syncthreads();                            // previous tile fully used
    stage_tile(k_s, hd + 1, kb + j0 * kv_row, kv_row, n, hd, tid, blockDim.x);
    stage_tile(v_s, hd, vb + j0 * kv_row, kv_row, n, hd, tid, blockDim.x);
    __syncthreads();
    float s[kRowsPerWarp];
    scores(s, q_s, q_row, kRowsPerWarp, k_s, hd);
    const int key = j0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      if (key >= n_live || (causal && key > pos[i])) s[i] = kMask;
    online_update(s, m, l, acc, kRowsPerWarp, n, hd,
                  [&](int j, int d) { return v_s[j * hd + d]; });
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + q_row[i];
    if (r >= n_rows) continue;
    const int h = hk * group + r % group;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (static_cast<long long>(b) * Sq + pos[i]) * H * hd + static_cast<long long>(h) * hd;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) orow[d] = from_f32<T>(__fdiv_rn(acc[i][t], l_safe));
    }
    if (lane == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + pos[i]] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// decode_fwd: grid (KV, B), 128 threads. q, o (B, 1, H, hd); the cache
// k, v (B, S, KV, hd); kv_len (B,) int32 live cells per slot.
// ---------------------------------------------------------------------------
template <typename TQ, typename TC, int DPL>
__global__ void __launch_bounds__(kDecWarps * 32)
decode_fwd_kernel(const TQ* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
                  const int* __restrict__ kv_len, TQ* __restrict__ o, int S, int H, int KV,
                  int hd, float scale) {
  extern __shared__ float smem[];
  const int group = H / KV;
  float* q_s = smem;                            // [group][hd], scaled
  float* k_s = q_s + kMaxGroup * hd;            // per warp: K [kTile][hd + 1],
                                                //           V [kTile][hd]
  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const long long kv_row = static_cast<long long>(KV) * hd;
  const TC* kb = k + static_cast<long long>(b) * S * kv_row + static_cast<long long>(hk) * hd;
  const TC* vb = v + static_cast<long long>(b) * S * kv_row + static_cast<long long>(hk) * hd;
  const TQ* qb = q + (static_cast<long long>(b) * H + hk * group) * hd;
  const int n_live = max(0, min(kv_len[b], S));
  const int n_tiles = (n_live + kTile - 1) / kTile;

  for (int e = tid; e < kMaxGroup * hd; e += blockDim.x)
    q_s[e] = e < group * hd ? __fmul_rn(to_f32(qb[e]), scale) : 0.f;
  __syncthreads();

  int q_row[kMaxGroup];
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][DPL];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    q_row[g] = g;
    m[g] = kMask;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[g][t] = 0.f;
  }
  float* kw = k_s + warp * kTile * (2 * hd + 1);
  float* vw = kw + kTile * (hd + 1);
  for (int kt = warp; kt < n_tiles; kt += n_warps) {
    const int j0 = kt * kTile, n = min(kTile, n_live - j0);
    __syncwarp();                               // previous tile fully used
    stage_tile(kw, hd + 1, kb + j0 * kv_row, kv_row, n, hd, lane, 32);
    stage_tile(vw, hd, vb + j0 * kv_row, kv_row, n, hd, lane, 32);
    __syncwarp();
    float s[kMaxGroup];
    scores(s, q_s, q_row, group, kw, hd);
    if (j0 + lane >= n_live) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) s[g] = kMask;
    }
    online_update(s, m, l, acc, group, n, hd,
                  [&](int j, int d) { return vw[j * hd + d]; });
  }

  // merge the warps' partial states: M = max m_w, L = sum l_w e^(m_w - M),
  // A = sum acc_w e^(m_w - M); a warp with no tile holds (MASK, 0, 0)
  __syncthreads();
  float* red_m = k_s;                           // [n_warps][kMaxGroup]
  float* red_l = red_m + n_warps * kMaxGroup;
  float* red_a = red_l + n_warps * kMaxGroup;   // [n_warps][kMaxGroup][hd]
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= group) break;
    if (lane == 0) {
      red_m[warp * kMaxGroup + g] = m[g];
      red_l[warp * kMaxGroup + g] = l[g];
    }
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) red_a[(warp * kMaxGroup + g) * hd + d] = acc[g][t];
    }
  }
  __syncthreads();
  for (int e = tid; e < group * hd; e += blockDim.x) {
    const int g = e / hd, d = e - g * hd;
    float mx = kMask;
    for (int w = 0; w < n_warps; ++w) mx = fmaxf(mx, red_m[w * kMaxGroup + g]);
    float sum_l = 0.f, sum_a = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float c = expf(red_m[w * kMaxGroup + g] - mx);
      sum_l = fmaf(red_l[w * kMaxGroup + g], c, sum_l);
      sum_a = fmaf(red_a[(w * kMaxGroup + g) * hd + d], c, sum_a);
    }
    const float l_safe = sum_l == 0.f ? 1.f : sum_l;
    o[(static_cast<long long>(b) * H + hk * group + g) * hd + d] =
        from_f32<TQ>(__fdiv_rn(sum_a, l_safe));
  }
}

size_t fwd_smem(int hd) {
  return sizeof(float) * (kFwdRows * hd + kTile * (hd + 1) + kTile * hd);
}

size_t decode_smem(int hd, int warps) {
  const size_t tiles = static_cast<size_t>(warps) * kTile * (2 * hd + 1);
  const size_t merge = static_cast<size_t>(warps) * kMaxGroup * (hd + 2);
  return sizeof(float) * (kMaxGroup * hd + (tiles > merge ? tiles : merge));
}

template <typename T, int DPL>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int H, int KV, int hd, int kv_valid, int causal,
                       float scale, cudaStream_t st) {
  const dim3 grid((Sq * (H / KV) + kFwdRows - 1) / kFwdRows, KV, B);
  flash_fwd_kernel<T, DPL><<<grid, kFwdWarps * 32, fwd_smem(hd), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Sk, H, KV, hd, kv_valid, causal, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TC, int DPL>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const int* kv_len,
                          void* o, int B, int S, int H, int KV, int hd, float scale,
                          cudaStream_t st) {
  // above 48 KB of dynamic shared memory a kernel must opt in, once, up
  // to what the card allows a block
  static int max_smem = 0;
  if (max_smem == 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(decode_fwd_kernel<TQ, TC, DPL>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    max_smem = optin;
  }
  const int warps =
      decode_smem(hd, kDecWarps) <= static_cast<size_t>(max_smem) ? kDecWarps : kDecWarps / 2;
  decode_fwd_kernel<TQ, TC, DPL><<<dim3(KV, B), warps * 32, decode_smem(hd, warps), st>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v), kv_len,
      static_cast<TQ*>(o), S, H, KV, hd, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TC>
cudaError_t decode_by_hd(const void* q, const void* k, const void* v, const int* kv_len,
                         void* o, int B, int S, int H, int KV, int hd, float scale,
                         cudaStream_t st) {
  switch ((hd + 31) / 32) {
    case 1: return launch_decode<TQ, TC, 1>(q, k, v, kv_len, o, B, S, H, KV, hd, scale, st);
    case 2: return launch_decode<TQ, TC, 2>(q, k, v, kv_len, o, B, S, H, KV, hd, scale, st);
    case 3: return launch_decode<TQ, TC, 3>(q, k, v, kv_len, o, B, S, H, KV, hd, scale, st);
    default: return launch_decode<TQ, TC, 4>(q, k, v, kv_len, o, B, S, H, KV, hd, scale, st);
  }
}

template <typename T>
cudaError_t fwd_by_hd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int Sq, int Sk, int H, int KV, int hd, int kv_valid, int causal,
                      float scale, cudaStream_t st) {
  switch ((hd + 31) / 32) {
    case 1: return launch_fwd<T, 1>(q, k, v, o, lse, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
    case 2: return launch_fwd<T, 2>(q, k, v, o, lse, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
    case 3: return launch_fwd<T, 3>(q, k, v, o, lse, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
    default: return launch_fwd<T, 4>(q, k, v, o, lse, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k/v (B, Sk, KV, hd), all bf16 (bf16 != 0) or all f32;
// o like q, lse (B, H, Sq) f32. 1 <= hd <= 128, H % KV == 0,
// 1 <= kv_valid <= Sk (checked by the wrapper).
int fa_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bf16, int B,
                 int Sq, int Sk, int H, int KV, int hd, int kv_valid, int causal, float scale,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      bf16 ? fwd_by_hd<__nv_bfloat16>(q, k, v, o, l, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st)
           : fwd_by_hd<float>(q, k, v, o, l, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  return static_cast<int>(err);
}

// q, o (B, 1, H, hd) bf16 (q_bf16 != 0) or f32; the cache k, v
// (B, S, KV, hd) bf16 (c_bf16 != 0) or f32; kv_len (B,) int32.
// 1 <= hd <= 128, H % KV == 0, H / KV <= 8 (checked by the wrapper).
int fa_decode_fwd(const void* q, const void* k, const void* v, const void* kv_len, void* o,
                  int q_bf16, int c_bf16, int B, int S, int H, int KV, int hd, float scale,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const int* lens = static_cast<const int*>(kv_len);
  cudaError_t err;
  if (q_bf16 && c_bf16)
    err = decode_by_hd<__nv_bfloat16, __nv_bfloat16>(q, k, v, lens, o, B, S, H, KV, hd, scale, st);
  else if (q_bf16)
    err = decode_by_hd<__nv_bfloat16, float>(q, k, v, lens, o, B, S, H, KV, hd, scale, st);
  else if (c_bf16)
    err = decode_by_hd<float, __nv_bfloat16>(q, k, v, lens, o, B, S, H, KV, hd, scale, st);
  else
    err = decode_by_hd<float, float>(q, k, v, lens, o, B, S, H, KV, hd, scale, st);
  return static_cast<int>(err);
}

}  // extern "C"
