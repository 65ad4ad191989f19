// Paged-attention kernels for Hopper (sm_90a), bound through a plain C
// interface (loaded with ctypes by kernels/paged_attention/build.py).
//
// Two kernels, each replacing one Pallas TPU kernel of the JAX package:
//
//   paged_decode   <- repro/kernels/paged_attention/paged_attention.py:paged_decode_fwd
//                     (_paged_decode_kernel): one query per slot against the
//                     block-pool KV cache through the slot's block table,
//                     for every decode step of the paged serve path
//   paged_prefill  <- repro/kernels/paged_attention/paged_attention.py:paged_prefill_fwd
//                     (_paged_prefill_kernel): a chunk of queries per slot
//                     at per-slot absolute offsets q_off, for chunked and
//                     prefix-adopted prefill and the speculative verify pass
//
// What they compute (the plain versions are kernels/paged_attention/ref.py):
// cell j * bs + o of slot b is the pool cell (tables[b, j], o); scores
// s = (q * scale) . k in f32, q scaled in f32 before the product as the TPU
// kernels do; key j is live for a query at absolute position p iff j <= p
// and j < kv_len[b] (decode: p = kv_len[b] - 1). Dead keys take the finite
// MASK_VALUE = -0.7 * FLT_MAX and no weight. An online softmax keeps a
// running max m, sum l and unnormalised output acc in f32 per query row;
// o = acc / l_safe (l_safe = 1 where l == 0, so a slot with kv_len == 0
// gives exact zeros), rounded once to the output type. IEEE f32
// throughout: expf, __fdiv_rn and explicit __fmaf_rn/__fmul_rn, no
// --use_fast_math.
//
// Layouts are the model's, read through the kernels' own offsets (no
// transposes, no gathers, no padding): q, o (B, S, H, hd) (decode S = 1);
// the pools (N + 1, bs, KV, hd), block N the engine's trash block; tables
// (B, nb) int32; q_off, kv_len (B,) int32. GQA is native: query head h
// reads KV head h / (H / KV), and a block works on one KV head, so each
// K/V block it stages serves every query head of the group.
//
// What bounds them on this card: bytes. Each slot's live K/V blocks are
// read once per (KV head, query tile), and the scores are a few MFLOP per
// call, far below the tensor cores; at the serve path's shapes (8 slots,
// up to 1,024 live cells, 5 KV heads of 64) a decode step moves about 5 MB
// of K/V, 1.6 us at 3.35 TB/s. The real cost is latency and occupancy:
// a decode grid has 8 x 5 = 40 blocks for 132 SMs, and a block walks its
// slot's blocks in order. Splitting the key axis across blocks is later
// work. What the design does:
//   * A block owns one (slot, KV head) and, for prefill, 16 rows of the
//     flattened (position, head-in-group) row space. It reads its own
//     block table and kv_len (no scalar prefetch on this card) and walks
//     logical blocks j < cdiv(live, bs) only, where live is kv_len and,
//     for prefill, also the tile's causal horizon q_off + last row + 1.
//     Blocks past that are neither read nor computed, and their table
//     entries are never read (with kv_len == 0 not even tables[b, 0],
//     which the TPU kernel's index map reads). Live ids are clamped into
//     the pool, as JAX's gather clamps them.
//   * Whole blocks, up to 64 keys a round, are staged in shared memory in
//     the pool's own type, double-buffered: the next round's cp.async
//     copies (16 bytes each, all independent) land while the block
//     computes on this one. Each staged block serves every query head of
//     the GQA group (3 for smollm-360m).
//   * A warp owns one query row, so a decode block has one warp per query
//     head of the group and a prefill block 16.
//
// Decode and prefill are one template and share row_update. Row r of a
// prefill at absolute position p runs the same operations in the same
// order as a decode at kv_len = p + 1: the same 16-key chunks of the same
// blocks in the same order, the same dot, max, exp and sum trees. A block
// past p (inside the tile's horizon but past the row's own) is fully
// masked for the row and leaves m, l and acc bit for bit unchanged
// (max(m, MASK) = m, alpha = exp(0) = 1, p = 0 and its products skipped).
// So the verify pass and a recomputed prefill give a plain decode's bits.
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
constexpr int kChunk = 16;           // keys per online-softmax update
constexpr int kRoundKeys = 64;       // keys staged per round, whole blocks (bs <= 64)
constexpr int kPrefillRows = 16;     // flattened query rows per prefill block, a warp each
constexpr int kMaxThreads = kPrefillRows * 32;
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

// reductions over the 16 lanes of a half-warp (xor offsets below 16 stay
// inside it), in a fixed tree order
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory row pitch of a staged key, in elements: hd padded to a
// 16-byte multiple plus 16 bytes, so rows start on 16 bytes (cp.async) and
// the 16 keys of a chunk spread over the banks.
template <typename TC>
__host__ __device__ __forceinline__ int row_pitch(int hd) {
  constexpr int kVec = 16 / sizeof(TC);
  return (hd + kVec - 1) / kVec * kVec + kVec;
}

// Stage round `rd` (keys [0, n) of blocks rd * bpr ...) into `kb`/`vb` in
// the pool's own type: key t is row t % bs of pool block phys_s[rd * bpr +
// t / bs], KV head hk. With 16-byte alignment each thread issues cp.async
// copies that land while the block computes on the other buffer; otherwise
// plain element copies. Threads t, t + nt, ... take part.
template <typename TC>
__device__ __forceinline__ void stage_round(TC* kb, TC* vb, const TC* kp, const TC* vp,
                                            const int* phys, int n, int bs, int KV, int hd,
                                            int hk, int pitch, bool async, int tid, int nt) {
  constexpr int kVec = 16 / sizeof(TC);
  const long long cell = static_cast<long long>(KV) * hd;    // elements per pool cell
  if (async) {
    const int per_row = hd / kVec;
    for (int c = tid; c < n * per_row; c += nt) {
      const int t = c / per_row, d0 = (c - t * per_row) * kVec;
      const long long off = (static_cast<long long>(phys[t / bs]) * bs + t % bs) * cell +
                            static_cast<long long>(hk) * hd + d0;
      cp_async16(kb + t * pitch + d0, kp + off);
      cp_async16(vb + t * pitch + d0, vp + off);
    }
    return;
  }
  for (int e = tid; e < n * hd; e += nt) {
    const int t = e / hd, d = e - t * hd;
    const long long off = (static_cast<long long>(phys[t / bs]) * bs + t % bs) * cell +
                          static_cast<long long>(hk) * hd + d;
    kb[t * pitch + d] = kp[off];
    vb[t * pitch + d] = vp[off];
  }
}

// One warp, one query row: the online-softmax update with a chunk of
// n <= 16 staged keys at absolute positions kpos0 + [0, n) (k_c, v_c point
// at the chunk's first key, rows `pitch` apart); keys at or past `lim` are
// dead. Lane j and lane j + 16 own key j: each sums the products of the
// dims of its parity (two accumulators, d = h, h + 4, ... and h + 2, h + 6,
// ...), and the key's score is the sum of the two halves. acc[i] holds dim
// lane + 32 i. Both kernels run exactly this for every row, which is what
// makes a prefill row bit-equal to the decode at the same position.
template <int DPL, typename TC>
__device__ __forceinline__ void row_update(const float* q_row, const TC* k_c, const TC* v_c,
                                           int pitch, int n, int kpos0, int lim, int hd,
                                           float& m, float& l, float (&acc)[DPL]) {
  const int lane = threadIdx.x & 31, j = lane & 15, h = lane >> 4;
  const bool live = j < n && kpos0 + j < lim;
  float part = 0.f;
  if (live) {
    const TC* kr = k_c + j * pitch;
    float a0 = 0.f, a1 = 0.f;
    int d = h;
#pragma unroll 4
    for (; d + 2 < hd; d += 4) {
      a0 = __fmaf_rn(q_row[d], to_f32(kr[d]), a0);
      a1 = __fmaf_rn(q_row[d + 2], to_f32(kr[d + 2]), a1);
    }
    if (d < hd) a0 = __fmaf_rn(q_row[d], to_f32(kr[d]), a0);
    part = __fadd_rn(a0, a1);
  }
  const float other = __shfl_xor_sync(kFull, part, 16);
  const float s = live ? __fadd_rn(part, other) : kMask;
  const float m_next = fmaxf(m, half_max(s));
  const float p = live ? expf(__fsub_rn(s, m_next)) : 0.f;
  const float alpha = expf(__fsub_rn(m, m_next));
  l = __fmaf_rn(l, alpha, half_sum(p));
  m = m_next;
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = __fmul_rn(acc[i], alpha);
#pragma unroll
  for (int jj = 0; jj < kChunk; ++jj) {
    const float pj = __shfl_sync(kFull, p, jj);   // n and pj are the same on every lane
    if (jj >= n || pj == 0.f) continue;           // a dead key leaves acc untouched
    const TC* vr = v_c + jj * pitch;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) acc[i] = __fmaf_rn(pj, to_f32(vr[d]), acc[i]);
    }
  }
}

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// ---------------------------------------------------------------------------
// grid (tiles, KV, B), one warp per query row. Decode: one tile of `group`
// rows (the query heads of one KV head at the slot's one position).
// Prefill: tiles of 16 rows of the flattened (position, head-in-group)
// space (row r is position r / group, head hk * group + r % group).
// Shared memory: the block's live table entries, the rows' scaled queries,
// and K and V of two rounds in the pool's type.
// ---------------------------------------------------------------------------
template <typename TQ, typename TC, int DPL, bool DECODE>
__global__ void __launch_bounds__(kMaxThreads)
paged_attn_kernel(const TQ* __restrict__ q, const TC* __restrict__ kp, const TC* __restrict__ vp,
                  const int* __restrict__ tables, const int* __restrict__ q_off,
                  const int* __restrict__ kv_len, TQ* __restrict__ o, int S, int H, int KV,
                  int hd, int n_pool, int bs, int nb, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = H / KV;
  const int n_rows_cta = DECODE ? group : kPrefillRows;
  const int bpr = bs >= kRoundKeys ? 1 : kRoundKeys / bs;      // blocks per round
  const int round_keys = bpr * bs;
  const int pitch = row_pitch<TC>(hd);
  int* phys_s = reinterpret_cast<int*>(smem);                  // [nb]
  float* q_s = reinterpret_cast<float*>(smem + align16(sizeof(int) * nb));   // [rows][hd]
  TC* k_s = reinterpret_cast<TC*>(reinterpret_cast<unsigned char*>(q_s) +
                                  align16(sizeof(float) * n_rows_cta * hd));
  TC* v_s = k_s + 2 * round_keys * pitch;                      // each [2][round_keys][pitch]

  const int tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int n_rows = S * group;                                // flattened rows of the slot
  const int r0 = tile * n_rows_cta;
  const int len = kv_len[b];
  const int qo = DECODE ? 0 : q_off[b];

  // live keys of the block: below kv_len (and the table's reach) and, for
  // prefill, up to the tile's last row
  int n_live = min(len, nb * bs);
  if (!DECODE) n_live = min(n_live, qo + (min(r0 + n_rows_cta, n_rows) - 1) / group + 1);
  const int n_blk = n_live > 0 ? (n_live + bs - 1) / bs : 0;
  const int n_rounds = (n_blk + bpr - 1) / bpr;

  // the live table entries only, clamped into the pool
  const int* trow = tables + static_cast<long long>(b) * nb;
  for (int j = tid; j < n_blk; j += nt) phys_s[j] = min(max(trow[j], 0), n_pool - 1);
  for (int e = tid; e < n_rows_cta * hd; e += nt) {
    const int rr = e / hd, d = e - rr * hd, r = r0 + rr;
    float x = 0.f;
    if (r < n_rows) {
      const int pos = r / group, h = hk * group + r % group;
      x = __fmul_rn(to_f32(q[(static_cast<long long>(b) * S + pos) * H * hd +
                             static_cast<long long>(h) * hd + d]), scale);
    }
    q_s[e] = x;
  }

  // this warp's row: its position and its live-key limit
  const int r = r0 + warp;
  const bool has_row = warp < n_rows_cta && r < n_rows;
  const int pos = has_row ? r / group : 0;
  const int lim = !has_row ? 0 : (DECODE ? len : min(qo + pos + 1, len));
  const float* q_row = q_s + (warp < n_rows_cta ? warp : 0) * hd;
  float m = kMask, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  constexpr int kVec = 16 / sizeof(TC);
  const bool async = hd % kVec == 0 && (static_cast<long long>(KV) * hd) % kVec == 0 &&
                     reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  __syncthreads();                                             // phys_s, q_s
  auto stage = [&](int rd) {
    const int nbr = min(bpr, n_blk - rd * bpr);
    const int buf = (rd & 1) * round_keys * pitch;
    stage_round(k_s + buf, v_s + buf, kp, vp, phys_s + rd * bpr, nbr * bs, bs, KV, hd, hk,
                pitch, async, tid, nt);
  };
  if (async && n_rounds > 0) {
    stage(0);
    cp_async_commit();
  }
  for (int rd = 0; rd < n_rounds; ++rd) {
    if (async) {
      if (rd + 1 < n_rounds) {                                 // the next round lands
        stage(rd + 1);                                         // while this one computes
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      stage(rd);
    }
    __syncthreads();                                           // round rd staged
    const int nbr = min(bpr, n_blk - rd * bpr);
    const TC* kb = k_s + (rd & 1) * round_keys * pitch;
    const TC* vb = v_s + (rd & 1) * round_keys * pitch;
    for (int t0 = 0; t0 < nbr * bs; t0 += bs) {                // blocks in order,
      for (int c0 = 0; c0 < bs; c0 += kChunk) {                // chunks in order
        const int t = t0 + c0;
        row_update(q_row, kb + t * pitch, vb + t * pitch, pitch, min(kChunk, bs - c0),
                   rd * round_keys + t, lim, hd, m, l, acc);
      }
    }
    __syncthreads();                                           // round rd fully used
  }

  if (!has_row) return;
  const int h = hk * group + r % group;
  const float l_safe = l == 0.f ? 1.f : l;
  TQ* orow = o + (static_cast<long long>(b) * S + pos) * H * hd + static_cast<long long>(h) * hd;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) orow[d] = from_f32<TQ>(__fdiv_rn(acc[i], l_safe));
  }
}

template <typename TC>
size_t smem_bytes(int rows, int hd, int bs, int nb) {
  const int round_keys = (bs >= kRoundKeys ? 1 : kRoundKeys / bs) * bs;
  return align16(sizeof(int) * nb) + align16(sizeof(float) * rows * hd) +
         4 * sizeof(TC) * static_cast<size_t>(round_keys) * row_pitch<TC>(hd);
}

template <typename TQ, typename TC, int DPL, bool DECODE>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* q_off, const int* kv_len, void* o, int B, int S, int H, int KV,
                   int hd, int n_pool, int bs, int nb, float scale, cudaStream_t st) {
  // above 48 KB of dynamic shared memory a kernel must opt in, once, up to
  // what the card allows a block
  static int max_smem = 0;
  if (max_smem == 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(paged_attn_kernel<TQ, TC, DPL, DECODE>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    max_smem = optin;
  }
  const int group = H / KV;
  const int rows = DECODE ? group : kPrefillRows;
  const dim3 grid(DECODE ? 1 : (S * group + kPrefillRows - 1) / kPrefillRows, KV, B);
  paged_attn_kernel<TQ, TC, DPL, DECODE><<<grid, rows * 32, smem_bytes<TC>(rows, hd, bs, nb), st>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v), tables,
      q_off, kv_len, static_cast<TQ*>(o), S, H, KV, hd, n_pool, bs, nb, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TC, bool DECODE>
cudaError_t by_hd(const void* q, const void* k, const void* v, const int* tables,
                  const int* q_off, const int* kv_len, void* o, int B, int S, int H, int KV,
                  int hd, int n_pool, int bs, int nb, float scale, cudaStream_t st) {
  // dims per lane: ceil(hd / 32)
  switch ((hd + 31) / 32) {
    case 1: return launch<TQ, TC, 1, DECODE>(q, k, v, tables, q_off, kv_len, o, B, S, H, KV, hd, n_pool, bs, nb, scale, st);
    case 2: return launch<TQ, TC, 2, DECODE>(q, k, v, tables, q_off, kv_len, o, B, S, H, KV, hd, n_pool, bs, nb, scale, st);
    case 3: return launch<TQ, TC, 3, DECODE>(q, k, v, tables, q_off, kv_len, o, B, S, H, KV, hd, n_pool, bs, nb, scale, st);
    default: return launch<TQ, TC, 4, DECODE>(q, k, v, tables, q_off, kv_len, o, B, S, H, KV, hd, n_pool, bs, nb, scale, st);
  }
}

template <bool DECODE>
cudaError_t by_type(const void* q, const void* k, const void* v, const int* tables,
                    const int* q_off, const int* kv_len, void* o, int q_bf16, int c_bf16, int B,
                    int S, int H, int KV, int hd, int n_pool, int bs, int nb, float scale,
                    cudaStream_t st) {
  if (q_bf16 && c_bf16)
    return by_hd<__nv_bfloat16, __nv_bfloat16, DECODE>(q, k, v, tables, q_off, kv_len, o, B, S, H, KV, hd, n_pool, bs, nb, scale, st);
  if (q_bf16)
    return by_hd<__nv_bfloat16, float, DECODE>(q, k, v, tables, q_off, kv_len, o, B, S, H, KV, hd, n_pool, bs, nb, scale, st);
  if (c_bf16)
    return by_hd<float, __nv_bfloat16, DECODE>(q, k, v, tables, q_off, kv_len, o, B, S, H, KV, hd, n_pool, bs, nb, scale, st);
  return by_hd<float, float, DECODE>(q, k, v, tables, q_off, kv_len, o, B, S, H, KV, hd, n_pool, bs, nb, scale, st);
}

}  // namespace

extern "C" {

// q, o (B, 1, H, hd) bf16 (q_bf16 != 0) or f32; the pools k, v (n_pool, bs,
// KV, hd) bf16 (c_bf16 != 0) or f32; tables (B, nb) int32; kv_len (B,)
// int32. 1 <= hd <= 128, 1 <= bs <= 64, H % KV == 0, H / KV <= 16 (checked
// by the wrapper).
int pa_paged_decode_fwd(const void* q, const void* k, const void* v, const void* tables,
                        const void* kv_len, void* o, int q_bf16, int c_bf16, int B, int H,
                        int KV, int hd, int n_pool, int bs, int nb, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(by_type<true>(q, k, v, static_cast<const int*>(tables), nullptr,
                                        static_cast<const int*>(kv_len), o, q_bf16, c_bf16, B,
                                        1, H, KV, hd, n_pool, bs, nb, scale, st));
}

// q, o (B, S, H, hd); q_off (B,) int32; otherwise as pa_paged_decode_fwd,
// with any H / KV.
int pa_paged_prefill_fwd(const void* q, const void* k, const void* v, const void* tables,
                         const void* q_off, const void* kv_len, void* o, int q_bf16, int c_bf16,
                         int B, int S, int H, int KV, int hd, int n_pool, int bs, int nb,
                         float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(by_type<false>(q, k, v, static_cast<const int*>(tables),
                                         static_cast<const int*>(q_off),
                                         static_cast<const int*>(kv_len), o, q_bf16, c_bf16, B,
                                         S, H, KV, hd, n_pool, bs, nb, scale, st));
}

}  // extern "C"
