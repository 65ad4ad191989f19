// The tensor-core tile step of the attention kernels, shared by
// kernels/paged_attention/csrc/paged_attention.cu (paged_decode,
// paged_prefill) and kernels/flash_attention/csrc/flash_attention.cu
// (flash_fwd, flash_bwd_dkv): mma.sync m16n8k16 with bf16 operands and f32
// sums, a warp per 16-row tile, operands read from shared memory by
// ldmatrix.
//
// The arithmetic, as measured on an H100:
//   * An operand not exact in bf16 is split into bf16 terms (split_bf16:
//     each the nearest bf16 to what the earlier ones left; three hold every
//     f32 of the normal range exactly). A product of two split operands
//     takes the pairs of terms whose orders add up to at most 2 (n_pairs,
//     pair_term), the smallest pair first.
//   * Every k16 step lands in a fresh fragment (the mma from zero), and the
//     pairs' fragments and then the steps are added in f32 rounded to
//     nearest (pair_sum). Chaining mma steps on one fragment truncates the
//     running sum toward zero at every step, which biases a long sum low.
//   * Softmax weights P (and the backward's dS) take three terms: with two
//     (within 2^-16 of p) the served bf16 model drifts past its tolerance.
//
// tile_chunk is the online-softmax step of one warp's 16 query rows over a
// chunk of 16 staged keys. Both paged kernels, flash_fwd and decode_fwd
// run exactly it, so a paged prefill row computes what a decode at its
// position does. Its two products, chunk_scores (S = A K^T) and
// chunk_times (a 16 x 16 A times the chunk's staged rows), are also
// flash_bwd_dq's: S and dP = do V^T, then dQ += dS K.
//
// kernels/build.py hashes this header into the name of every library
// whose source includes it, so an edit here rebuilds both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

// the JAX package's MASK_VALUE (-0.7 * f32 max, rounded once to f32)
constexpr float kMask = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));
constexpr int kChunk = 16;           // keys per online-softmax update: one k16 of P V
constexpr int kTile = 16;            // rows of a warp's mma tile
constexpr int kPTerms = 3;           // bf16 terms of P and dS
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

// v as N bf16 terms, largest first: each the nearest bf16 to what the
// earlier ones left (the subtraction is exact); 3 terms hold every f32
// value of the normal range exactly, 2 within 2^-16 of |v|
template <int N>
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16 (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    t[i] = __float2bfloat16_rn(v);
    v = __fsub_rn(v, __bfloat162float(t[i]));
  }
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// two f32 values (the two columns a lane holds of a fragment row) as N
// packed bf16 terms each: t[i] holds term i of lo and of hi
template <int N>
__device__ __forceinline__ void split_pack(float lo, float hi, uint32_t (&t)[N]) {
  __nv_bfloat16 a[N], b[N];
  split_bf16<N>(lo, a);
  split_bf16<N>(hi, b);
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = pack2(a[i], b[i]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices from shared memory, rows given by lanes 8i..8i+7
// for matrix i; TRANS delivers each transposed
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// d += a . b: a 16 x 16 (row-major fragment), b 16 x 8 (column fragment),
// bf16 in, f32 out. Fragment of a 16 x 8 f32 tile, lane l (g = l / 4,
// q = l % 4): d[0], d[1] row g, columns 2q, 2q + 1; d[2], d[3] row g + 8.
// An A fragment: a[0] row g, k 2q and 2q + 1; a[1] row g + 8; a[2], a[3]
// the same at k + 8. So the fragments of two adjacent n8 tiles (columns
// 0-7 and 8-15) are, packed, the A fragment of their 16 x 16 product:
// (d0[0], d0[1]), (d0[2], d0[3]), (d1[0], d1[1]), (d1[2], d1[3]).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The pairs (t, u) of split terms a product takes, t of the left operand
// (NA terms), u of the right (NB), t + u <= 2, in order of t + u from 2
// down to 0 (the smallest first): pair p's t (or u with U).
__host__ __device__ constexpr int n_pairs(int na, int nb) {
  int n = 0;
  for (int s = 2; s >= 0; --s)
    for (int t = 0; t < na; ++t)
      if (s - t >= 0 && s - t < nb) ++n;
  return n;
}

__host__ __device__ constexpr int pair_term(int na, int nb, int p, bool u) {
  int n = 0;
  for (int s = 2; s >= 0; --s)
    for (int t = 0; t < na; ++t)
      if (s - t >= 0 && s - t < nb) {
        if (n == p) return u ? s - t : t;
        ++n;
      }
  return 0;
}

// One k16 step of a split product into x: every pair of terms (a of NA
// terms, b of NB) its own fresh fragment, the fragments added in f32
// rounded to nearest, the smallest pair first. b[u] is the column fragment
// (b0, b1) of term u.
template <int NA, int NB>
__device__ __forceinline__ void pair_sum(float (&x)[4], const uint32_t (&a)[NA][4],
                                         const uint32_t (&b)[NB][2]) {
  constexpr int NP = n_pairs(NA, NB);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int t = pair_term(NA, NB, p, false), u = pair_term(NA, NB, p, true);
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(f, a[t], b[u][0], b[u][1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = p == 0 ? f[i] : __fadd_rn(x[i], f[i]);
  }
}

// Shared-memory row pitch of a staged row, in bf16: the padded head dim HD
// plus 8, so rows start on 16 bytes (cp.async, ldmatrix) and the 8 rows an
// ldmatrix reads fall on distinct banks (HD 64, 80, 128: pitches of 36, 44
// and 68 words).
template <int HD>
__host__ __device__ constexpr int row_pitch() { return HD + 8; }

// The A fragment (16 rows x 16 columns at column c0) of a staged row-major
// bf16 plane with pitch P, by ldmatrix: matrix i is rows 8 (i & 1), columns
// c0 + 8 (i >> 1).
template <int P>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* base, int c0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  ldmatrix_x4<false>(a, base + (mr + 8 * (mi & 1)) * P + c0 + 8 * (mi >> 1));
}

// The column fragments of two n8 tiles from a staged plane whose rows are
// the tiles' columns (a key per row for S = Q K^T): rows 0-7 and 8-15,
// k = columns c0 .. c0 + 15. b[0], b[1] tile 0; b[2], b[3] tile 1.
template <int P>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const __nv_bfloat16* base,
                                            int c0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  ldmatrix_x4<false>(b, base + (mr + 8 * (mi >> 1)) * P + c0 + 8 * (mi & 1));
}

// The column fragments of two n8 tiles (columns c0 .. c0 + 7 and
// c0 + 8 .. c0 + 15) from a staged plane whose rows are the k16 contraction
// (a key per row for P V), by ldmatrix.trans.
template <int P>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const __nv_bfloat16* base,
                                            int c0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  ldmatrix_x4<true>(b, base + (mr + 8 * (mi & 1)) * P + c0 + 8 * (mi >> 1));
}

// One warp, one 16-row tile against a chunk of 16 staged keys: S = A K^T
// as two n8 tiles (keys 0-7, 8-15), A the rows' NA bf16 terms as A
// fragments per k16 step, K staged as NT terms (k_c at the chunk's first
// key in plane 0, planes `plane` apart). Each k16 step's pairs of terms
// are summed (pair_sum) and added to the running S, rounded to nearest.
template <int HD, int NA, int NT>
__device__ __forceinline__ void chunk_scores(float (&s)[2][4], const uint32_t (&a)[NA][HD / 16][4],
                                             const __nv_bfloat16* k_c, int plane) {
  constexpr int kPitch = row_pitch<HD>();
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t kf[NT][4], as[NA][4], b0[NT][2], b1[NT][2];
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      load_b_rows<kPitch>(kf[u], k_c + u * plane, 16 * ks);
      b0[u][0] = kf[u][0];
      b0[u][1] = kf[u][1];
      b1[u][0] = kf[u][2];
      b1[u][1] = kf[u][3];
    }
#pragma unroll
    for (int t = 0; t < NA; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) as[t][r] = a[t][ks][r];
    float x0[4], x1[4];
    pair_sum<NA, NT>(x0, as, b0);
    pair_sum<NA, NT>(x1, as, b1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[0][i] = __fadd_rn(s[0][i], x0[i]);
      s[1][i] = __fadd_rn(s[1][i], x1[i]);
    }
  }
}

// One warp: a 16-row x 16-key A (kPTerms bf16 terms, A fragments) times
// the chunk's 16 staged rows (NT terms, v_c at the chunk's first key in
// plane 0), two n8 tiles of columns 8 nt .. 8 nt + 15 (read by
// ldmatrix.trans): f[0], f[1] each the pairs' fresh fragments summed.
template <int HD, int NT>
__device__ __forceinline__ void chunk_times(float (&f)[2][4], const uint32_t (&pa)[kPTerms][4],
                                            const __nv_bfloat16* v_c, int plane, int nt) {
  constexpr int kPitch = row_pitch<HD>();
  uint32_t vf[NT][4], b0[NT][2], b1[NT][2];
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    load_b_cols<kPitch>(vf[u], v_c + u * plane, 8 * nt);
    b0[u][0] = vf[u][0];
    b0[u][1] = vf[u][1];
    b1[u][0] = vf[u][2];
    b1[u][1] = vf[u][3];
  }
  pair_sum<kPTerms, NT>(f[0], pa, b0);
  pair_sum<kPTerms, NT>(f[1], pa, b1);
}

// One warp, one 16-row tile: the online-softmax update with a chunk of
// n <= 16 staged keys at absolute positions kpos0 + [0, n) (k_c, v_c point
// at the chunk's first key in plane 0, planes `plane` apart). Lane l holds
// rows g = l / 4 and g + 8 of the tile (h = 0, 1), whose live-key limits
// are lim[h]: keys at or past them, or past n, are dead. qa: the rows'
// q * scale as NQ bf16 terms, A fragments per k16 step; K and V staged as
// NT terms. acc: the rows' unnormalised output, 16 x HD as HD / 8
// fragments. A chunk dead for a row leaves its m, l and acc bit for bit
// unchanged (max(m, MASK) = m, alpha = exp(0) = 1, its products are 0).
template <int HD, int NQ, int NT>
__device__ __forceinline__ void tile_chunk(const uint32_t (&qa)[NQ][HD / 16][4],
                                           const __nv_bfloat16* k_c, const __nv_bfloat16* v_c,
                                           int plane, int n, int kpos0, const int (&lim)[2],
                                           float (&m)[2], float (&l)[2],
                                           float (&acc)[HD / 8][4]) {
  const int lane = threadIdx.x & 31, q4 = lane & 3;

  float s[2][4];
  chunk_scores<HD, NQ, NT>(s, qa, k_c, plane);

  // the online softmax per row, its 16 scores on the 4 lanes of a quad
  float alpha[2], pv[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sv[4];
    bool live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = 8 * (j >> 1) + 2 * q4 + (j & 1);
      live[j] = key < n && kpos0 + key < lim[h];
      sv[j] = live[j] ? s[j >> 1][2 * h + (j & 1)] : kMask;
    }
    float mx = fmaxf(fmaxf(sv[0], sv[1]), fmaxf(sv[2], sv[3]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_next = fmaxf(m[h], mx);
#pragma unroll
    for (int j = 0; j < 4; ++j) pv[h][j] = live[j] ? expf(__fsub_rn(sv[j], m_next)) : 0.f;
    alpha[h] = expf(__fsub_rn(m[h], m_next));
    float rs = __fadd_rn(__fadd_rn(pv[h][0], pv[h][1]), __fadd_rn(pv[h][2], pv[h][3]));
    rs = __fadd_rn(rs, __shfl_xor_sync(kFull, rs, 1));
    rs = __fadd_rn(rs, __shfl_xor_sync(kFull, rs, 2));
    l[h] = __fmaf_rn(l[h], alpha[h], rs);
    m[h] = m_next;
  }

  // P~ as A fragments (16 rows x 16 keys), kPTerms terms: register r holds
  // row g (r even) or g + 8, keys 2 q4 (+ 8 for r >= 2) and the next
  uint32_t pa[kPTerms][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int h = r & 1, j = 2 * (r >> 1);
    uint32_t t[kPTerms];
    split_pack<kPTerms>(pv[h][j], pv[h][j + 1], t);
#pragma unroll
    for (int i = 0; i < kPTerms; ++i) pa[i][r] = t[i];
  }

  // the chunk's P~ V, two n8 tiles of dims at a time: the pairs' fresh
  // fragments summed, then acc = fma(acc, alpha, sum)
#pragma unroll
  for (int nt = 0; nt < HD / 8; nt += 2) {
    float f[2][4];
    chunk_times<HD, NT>(f, pa, v_c, plane, nt);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc[nt + (i >> 2)][i & 3] =
          __fmaf_rn(acc[nt + (i >> 2)][i & 3], alpha[(i & 3) >> 1], f[i >> 2][i & 3]);
  }
}

}  // namespace
