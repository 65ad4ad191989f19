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
// gives exact zeros), rounded once to the output type. IEEE f32 on the CUDA
// cores: expf, __fdiv_rn and explicit __fmaf_rn/__fadd_rn, no
// --use_fast_math.
//
// Layouts are the model's, read through the kernels' own offsets (no
// transposes, no gathers, no padding in memory): q, o (B, S, H, hd) (decode
// S = 1); the pools (N + 1, bs, KV, hd), block N the engine's trash block;
// tables (B, nb) int32; q_off, kv_len (B,) int32. GQA is native: query head
// h reads KV head h / (H / KV), and a block works on one KV head, so each
// K/V block it stages serves every query head of the group.
//
// What bounds them on this card: bytes. Each slot's live K/V blocks are
// read once per (KV head, 64-row tile), and the scores are a few GFLOP per
// call at most; at the serve path's shapes (8 slots, up to 1,024 live
// cells, 5 KV heads of 64) a decode step moves about 5 MB of K/V, 1.6 us at
// 3.35 TB/s. The real cost is instruction issue and latency, so the
// products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out),
// a warp per 16-row tile, not as f32 FMA chains a warp per query row.
// Decode, one block per (slot, KV head) up to a group of 64, is bound by
// its tiles' chains of dependent steps per chunk (40 blocks for 132 SMs at
// smollm's 5 KV heads); splitting the key axis across blocks is later
// work. The design:
//   * A block owns one (slot, KV head) and 4 warps, and 64 rows of the
//     flattened (position, head-in-group) row space, 16 a warp; decode is the
//     same at S = 1: its rows are the group's query heads (one tile up to a
//     group of 16, granite-20b's MQA 48 warps 0-2, past 64 more blocks; a
//     warp without rows helps stage). It reads its own block table and kv_len
//     (no scalar prefetch on this card) and walks logical blocks j <
//     cdiv(live, bs) only, where live is kv_len and, for prefill, also the
//     tile's causal horizon q_off + last row + 1. Blocks past that are
//     neither read nor computed, and their table entries are never read (with
//     kv_len == 0 not even tables[b, 0], which the TPU kernel's index map
//     reads). Live ids are clamped into the pool, as JAX's gather clamps
//     them.
//   * Whole blocks, up to 64 keys a round, are staged in shared memory as
//     bf16, double-buffered: the next round's cp.async copies (16 bytes
//     each; a thread keeps one 16-byte column and walks the keys, no
//     division per copy) land while the block computes on this one. An
//     f32 pool is split on the way in (plain loads) into three bf16
//     planes, hi + mid + lo.
//   * Per 16-key chunk of a round a warp runs tile_chunk
//     (kernels/csrc/mma_tile.cuh, shared with flash_fwd): S = Q~ K^T (hd /
//     16 k16 steps, ldmatrix from the staged K), the online-softmax update
//     on the S fragment (each row's 16 scores live in the 4 lanes of a quad:
//     max and sum over the quad in a fixed tree), then the chunk's P~ V
//     (ldmatrix.trans from the staged V), which acc = fma(acc, alpha, sum)
//     adds on the CUDA cores.
//   * Operands not exact in bf16 are split into bf16 terms: q * scale takes
//     one term when q is bf16 and scale a power of two (exact), else three
//     (hi + mid + lo: all 24 bits of the f32 value); P three; an f32 pool's
//     K and V three. Every k16 step, and every pair of terms in it (orders
//     adding up to at most 2), is a fresh fragment; they are added in f32
//     rounded to nearest, the smallest first (chaining steps on one
//     fragment truncates toward zero, and two terms of P are not enough for
//     the served bf16 model: see the header).
//
// Decode and prefill are one template and share tile_chunk. Row r of a
// prefill at absolute position p runs the same operations in the same
// order as a decode at kv_len = p + 1: the same 16-key chunks of the same
// blocks in the same order, the same splits and instructions, the same
// max, exp and sum trees. A tensor-core output depends on its own row of A
// and column of B only, so what else shares the tile does not matter. A
// chunk past p (inside the tile's horizon but past the row's own) is fully
// masked for the row and leaves m, l and acc bit for bit unchanged
// (max(m, MASK) = m, alpha = exp(0) = 1, p = 0, a fragment of zero
// products is 0 and acc + 0 = acc); a chunk dead for every row of a warp's
// tile is skipped. So the verify pass and a recomputed prefill give a plain
// decode's bits.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "../../csrc/mma_tile.cuh"

namespace {

constexpr int kRoundKeys = 64;       // keys staged per round, whole blocks (bs <= 64)
constexpr int kWarps = 4;            // warps per block
constexpr int kThreads = kWarps * 32;

// rows of one staged plane: a round's keys rounded up to whole chunks, so a
// chunk's ldmatrix never reads past its plane
__host__ __device__ __forceinline__ int plane_rows(int bs) {
  const int round_keys = (bs >= kRoundKeys ? 1 : kRoundKeys / bs) * bs;
  return (round_keys + kChunk - 1) / kChunk * kChunk;
}

// Stage `n` keys (blocks phys[0..], key t is row t % bs of pool block
// phys[t / bs], KV head hk) into the NT bf16 planes at kb / vb (`plane`
// elements apart): with 16-byte alignment of a bf16 pool as cp.async copies
// that land while the block computes on the other buffer; otherwise plain
// loads, an f32 pool split into hi, mid and lo. Dims past hd are never
// written (zero since the start).
template <typename TC, int HD, int NT>
__device__ __forceinline__ void stage_round(__nv_bfloat16* kb, __nv_bfloat16* vb, const TC* kp,
                                            const TC* vp, const int* phys, int n, int bs,
                                            int KV, int hd, int hk, int plane, bool async,
                                            int tid) {
  constexpr int kPitch = row_pitch<HD>();
  const long long cell = static_cast<long long>(KV) * hd;    // elements per pool cell
  if constexpr (std::is_same<TC, __nv_bfloat16>::value) {
    if (async) {
      // the first step * per_row threads: thread tid copies 16-byte column
      // d0 of keys t, t + step, ...; each key's block and row advance by
      // adds
      const int per_row = hd / 8, step = kThreads / per_row;
      if (tid >= step * per_row) return;
      const int d0 = (tid % per_row) * 8;
      const int dblk = step / bs, drow = step - dblk * bs;
      int t = tid / per_row, blk = t / bs, row = t - blk * bs;
      const long long head = static_cast<long long>(hk) * hd + d0;
      for (; t < n; t += step) {
        const long long off = (static_cast<long long>(phys[blk]) * bs + row) * cell + head;
        cp_async16(kb + t * kPitch + d0, kp + off);
        cp_async16(vb + t * kPitch + d0, vp + off);
        blk += dblk;
        row += drow;
        if (row >= bs) {
          row -= bs;
          ++blk;
        }
      }
      return;
    }
  }
  for (int e = tid; e < n * hd; e += kThreads) {
    const int t = e / hd, d = e - t * hd;
    const long long off = (static_cast<long long>(phys[t / bs]) * bs + t % bs) * cell +
                          static_cast<long long>(hk) * hd + d;
    __nv_bfloat16 ks[NT], vs[NT];
    split_bf16<NT>(to_f32(kp[off]), ks);
    split_bf16<NT>(to_f32(vp[off]), vs);
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      kb[u * plane + t * kPitch + d] = ks[u];
      vb[u * plane + t * kPitch + d] = vs[u];
    }
  }
}

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// rounds staged at once: the next one lands while the block computes on
// this one (a ring of four read slower at 8 x 256 rows: its 74 KB of
// shared memory a block halves the blocks an SM holds)
constexpr int kBufs = 2;

// ---------------------------------------------------------------------------
// grid (tiles, KV, B), kWarps warps a block: tiles of kWarps x 16 rows of
// the flattened (position, head-in-group) space (row r is position r /
// group, head hk * group + r % group), 16 a warp; decode is S = 1 with
// every row's limit kv_len (no q_off), any group. Shared
// memory: the block's live table entries, then K and V of kBufs rounds as
// NT bf16 planes each.
// ---------------------------------------------------------------------------
template <typename TQ, typename TC, int HD, int NQ, bool DECODE>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const TQ* __restrict__ q, const TC* __restrict__ kp, const TC* __restrict__ vp,
                  const int* __restrict__ tables, const int* __restrict__ q_off,
                  const int* __restrict__ kv_len, TQ* __restrict__ o, int S, int H, int KV,
                  int hd, int n_pool, int bs, int nb, float scale) {
  constexpr int NT = std::is_same<TC, float>::value ? 3 : 1;
  constexpr int kPitch = row_pitch<HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = H / KV;
  constexpr int rows_cta = kWarps * kTile;
  const int bpr = bs >= kRoundKeys ? 1 : kRoundKeys / bs;      // blocks per round
  const int round_keys = bpr * bs;
  const int plane = plane_rows(bs) * kPitch;                   // elements of one plane
  const int buf = NT * plane;                                  // one round's K (or V)
  int* phys_s = reinterpret_cast<int*>(smem);                  // [nb]
  __nv_bfloat16* k_s =
      reinterpret_cast<__nv_bfloat16*>(smem + align16(sizeof(int) * nb));   // [kBufs][NT][plane]
  __nv_bfloat16* v_s = k_s + kBufs * buf;

  const int tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_rows = S * group;                                // flattened rows of the slot
  const int r0 = tile * rows_cta;
  const int len = kv_len[b];
  const int qo = DECODE ? 0 : q_off[b];

  // live keys of the block: below kv_len (and the table's reach) and, for
  // prefill, up to the tile's last row
  int n_live = min(len, nb * bs);
  if (!DECODE) n_live = min(n_live, qo + (min(r0 + rows_cta, n_rows) - 1) / group + 1);
  const int n_blk = n_live > 0 ? (n_live + bs - 1) / bs : 0;
  const int n_rounds = (n_blk + bpr - 1) / bpr;

  // the live table entries only, clamped into the pool; with hd < HD the
  // staging buffers zeroed, so the dims past hd read as zeros (a key's
  // padding meets the query's zero padding: 0 x garbage could be NaN)
  const int* trow = tables + static_cast<long long>(b) * nb;
  for (int j = tid; j < n_blk; j += kThreads) phys_s[j] = min(max(trow[j], 0), n_pool - 1);
  if (hd < HD) {
    uint4* z = reinterpret_cast<uint4*>(k_s);
    const int n16 = static_cast<int>(2 * kBufs * buf * sizeof(__nv_bfloat16) / 16);
    for (int i = tid; i < n16; i += kThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  // this warp's tile: rows wr0 .. wr0 + 15 (decode: S = 1, the group's
  // query heads); lane's rows g and g + 8, their positions and live-key
  // limits
  const int wr0 = r0 + kTile * warp;
  const bool active = wr0 < n_rows;
  const int g = lane >> 2, q4 = lane & 3;
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    lim[h] = !(active && r < n_rows) ? 0 : (DECODE ? len : min(qo + r / group + 1, len));
  }
  // the warp's horizon: its last row's limit
  const int last = min(wr0 + kTile, n_rows) - 1;
  const int warp_lim = !active ? 0 : (DECODE ? len : min(qo + last / group + 1, len));

  // q * scale in f32, split into NQ bf16 terms, as A fragments: register r
  // of step ks holds row g (r even) or g + 8, dims 16 ks + 2 q4 (+ 8 for
  // r >= 2) and the next
  uint32_t qa[NQ][HD / 16][4];
  const TQ* qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + g + 8 * h;
    qrow[h] = !(active && row < n_rows) ? nullptr
              : q + (static_cast<long long>(b) * S + row / group) * H * hd +
                    static_cast<long long>(hk * group + row % group) * hd;
  }
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const TQ* qr = qrow[r & 1];
      const int d = 16 * ks + 2 * q4 + 8 * (r >> 1);
      __nv_bfloat16 t[2][NQ];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        split_bf16<NQ>(qr && d + e < hd ? __fmul_rn(to_f32(qr[d + e]), scale) : 0.f, t[e]);
#pragma unroll
      for (int i = 0; i < NQ; ++i) qa[i][ks][r] = pack2(t[0][i], t[1][i]);
    }

  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f}, acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  const bool async = std::is_same<TC, __nv_bfloat16>::value && hd % 8 == 0 &&
                     (static_cast<long long>(KV) * hd) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  __syncthreads();                                             // phys_s, zeroed buffers
  // round rd into its buffer; the rows past its keys zeroed (a chunk reads
  // 16 rows: dead keys' V rows must be finite, their weight is 0)
  const int prows = plane_rows(bs);
  auto stage = [&](int rd) {
    const int n = min(bpr, n_blk - rd * bpr) * bs;
    __nv_bfloat16* kb = k_s + (rd % kBufs) * buf;
    __nv_bfloat16* vb = v_s + (rd % kBufs) * buf;
    stage_round<TC, HD, NT>(kb, vb, kp, vp, phys_s + rd * bpr, n, bs, KV, hd, hk, plane, async,
                            tid);
    constexpr int kRow16 = kPitch * 2 / 16;                     // 16-byte words a row
    for (int i = tid; i < NT * (prows - n) * kRow16; i += kThreads) {
      const int u = i / ((prows - n) * kRow16), w = i - u * (prows - n) * kRow16;
      const int at = u * plane + n * kPitch;
      reinterpret_cast<uint4*>(kb + at)[w] = make_uint4(0u, 0u, 0u, 0u);
      reinterpret_cast<uint4*>(vb + at)[w] = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // async: rounds 0 .. kBufs - 2 in flight before the loop, and one more (a
  // commit group each, empty past the last round) as each is consumed
  if (async)
    for (int rd = 0; rd < kBufs - 1; ++rd) {
      if (rd < n_rounds) stage(rd);
      cp_async_commit();
    }
  for (int rd = 0; rd < n_rounds; ++rd) {
    if (async) {
      if (rd + kBufs - 1 < n_rounds) stage(rd + kBufs - 1);    // into the buffer round
      cp_async_commit();                                       // rd - 1 freed
      cp_async_wait<kBufs - 1>();                              // round rd has landed
    } else {
      stage(rd);
    }
    __syncthreads();                                           // round rd staged
    const int n = min(bpr, n_blk - rd * bpr) * bs;
    const __nv_bfloat16* kb = k_s + (rd % kBufs) * buf;
    const __nv_bfloat16* vb = v_s + (rd % kBufs) * buf;
    if (active) {
      for (int t0 = 0; t0 < n; t0 += kChunk) {                 // chunks in order
        const int kpos0 = rd * round_keys + t0;
        if (kpos0 >= warp_lim) break;                          // dead for every row of the tile
        tile_chunk<HD, NQ, NT>(qa, kb + t0 * kPitch, vb + t0 * kPitch, plane,
                               min(kChunk, n - t0), kpos0, lim, m, l, acc);
      }
    }
    __syncthreads();                                           // round rd fully used
  }

  if (!active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    if (r >= n_rows) continue;
    const int pos = r / group, head = hk * group + r % group;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    TQ* orow = o + (static_cast<long long>(b) * S + pos) * H * hd + static_cast<long long>(head) * hd;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * nt + 2 * q4 + e;
        if (d < hd) orow[d] = from_f32<TQ>(__fdiv_rn(acc[nt][2 * h + e], l_safe));
      }
  }
}

template <typename TC, int HD>
size_t smem_bytes(int bs, int nb) {
  constexpr int NT = std::is_same<TC, float>::value ? 3 : 1;
  return align16(sizeof(int) * nb) + 2 * kBufs * NT * sizeof(__nv_bfloat16) *
                                         static_cast<size_t>(plane_rows(bs)) * row_pitch<HD>();
}

template <typename TQ, typename TC, int HD, int NQ, bool DECODE>
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
      err = cudaFuncSetAttribute(paged_attn_kernel<TQ, TC, HD, NQ, DECODE>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    max_smem = optin;
  }
  const int group = H / KV;
  const dim3 grid((S * group + kWarps * kTile - 1) / (kWarps * kTile), KV, B);
  paged_attn_kernel<TQ, TC, HD, NQ, DECODE><<<grid, kThreads, smem_bytes<TC, HD>(bs, nb), st>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v), tables,
      q_off, kv_len, static_cast<TQ*>(o), S, H, KV, hd, n_pool, bs, nb, scale);
  return cudaGetLastError();
}

// the head dim padded to 64 or 128; q * scale in one bf16 term when q is
// bf16 and scale a power of two (the product is exact and bf16), else three
template <typename TQ, typename TC, bool DECODE>
cudaError_t by_hd(const void* q, const void* k, const void* v, const int* tables,
                  const int* q_off, const int* kv_len, void* o, int B, int S, int H, int KV,
                  int hd, int n_pool, int bs, int nb, float scale, cudaStream_t st) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value) {
    int e = 0;
    if (frexpf(scale, &e) == 0.5f) {
      if (hd <= 64)
        return launch<TQ, TC, 64, 1, DECODE>(q, k, v, tables, q_off, kv_len, o, B, S, H, KV, hd, n_pool, bs, nb, scale, st);
      return launch<TQ, TC, 128, 1, DECODE>(q, k, v, tables, q_off, kv_len, o, B, S, H, KV, hd, n_pool, bs, nb, scale, st);
    }
  }
  if (hd <= 64)
    return launch<TQ, TC, 64, 3, DECODE>(q, k, v, tables, q_off, kv_len, o, B, S, H, KV, hd, n_pool, bs, nb, scale, st);
  return launch<TQ, TC, 128, 3, DECODE>(q, k, v, tables, q_off, kv_len, o, B, S, H, KV, hd, n_pool, bs, nb, scale, st);
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
// int32. 1 <= hd <= 128, 1 <= bs <= 64, H % KV == 0, any H / KV (checked
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

// q, o (B, S, H, hd); q_off (B,) int32; otherwise as pa_paged_decode_fwd.
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
