// Flash-attention kernels for Hopper (sm_90a), forward and backward, bound
// through a plain C interface (loaded with ctypes by
// kernels/flash_attention/build.py).
//
// Four kernels, each replacing one Pallas TPU kernel of the JAX package:
//
//   flash_fwd      <- repro/kernels/flash_attention/flash_attention.py:flash_fwd
//                     (_fwd_kernel): causal or full softmax attention, o and
//                     the per-row logsumexp, for prefill and training
//   decode_fwd     <- repro/kernels/flash_attention/flash_attention.py:decode_fwd
//                     (_decode_kernel): one query per slot against the ring
//                     KV cache, per-slot valid lengths, for every decode step
//   flash_bwd_dq   <- repro/kernels/flash_attention/flash_attention.py:flash_bwd_dq
//                     (_bwd_dq_kernel): dq, recomputing p from (q, k, lse)
//   flash_bwd_dkv  <- repro/kernels/flash_attention/flash_attention.py:flash_bwd_dkv
//                     (_bwd_dkv_kernel): dk and dv, summed over each KV
//                     head's query group
//
// The two backward kernels and their design are described where they
// start, below decode_fwd.
//
// flash_fwd, flash_bwd_dq and flash_bwd_dkv each have an f32, a bf16 and
// an f16 form (the f16 forms run under the FP16 policy: the paper's fp16
// CLIP with loss scaling); decode_fwd has f32 and bf16 forms. The forms
// differ only in how a staged input value becomes bf16 mma operands
// (n_terms): f32 in three terms, f16 in two, bf16 as it is. The f16 split
// is exact: an f16 value has 11 significant bits, and f16's whole range,
// subnormals included, lies inside bf16's normal exponent range, so the
// first term rounds to bf16's 8 bits and the remainder (the f16 value
// less that term, at most 4 significant bits) is a bf16 value too. So an
// f16 form computes what the f32 form computes on the same values widened
// to f32, with fewer products: the S and dP products over two K, V or do
// terms, P V and dS K over P's three and V's or K's two. f16 inputs stage
// by plain loads, split in registers on their way to shared memory, as
// f32 inputs stage: cp.async copies bytes, and an f16 tile copied as it is
// would need a second pass over shared memory (read, split, write two
// planes, one more barrier) before a product could read it.
//
// What they compute (the plain versions are kernels/flash_attention/ref.py):
// scores s = (q * scale) . k in f32, q scaled in f32 before the product as
// the TPU kernel does; keys past the valid length, and with `causal` keys
// past the query's position, take the finite MASK_VALUE = -0.7 * FLT_MAX
// (never -inf: exp(-inf - -inf) is NaN); an online softmax over tiles of
// keys keeps a running max m, sum l and unnormalised output acc in f32:
//   m' = max(m, max_j s_j), p_j = exp(s_j - m'), alpha = exp(m - m'),
//   l' = l * alpha + sum_j p_j, acc' = acc * alpha + sum_j p_j v_j.
// Key 0 is always live (the wrappers ask kv_valid >= 1; causal rows hold
// key 0), and every row meets it first, so no final row is dry. At the end
// o = acc / l_safe (l_safe = 1 where l == 0), rounded once to the output
// type (__float2bfloat16_rn), and lse = m + log(l_safe) stays f32. All in
// IEEE f32: expf/logf, __fdiv_rn, no --use_fast_math.
//
// Layouts are the model's, read through the kernels' own offsets (no
// transposes, no padding in memory): q, o (B, Sq, H, hd); k, v (B, Sk, KV,
// hd), the ring cache in its storage layout for decode; lse (B, H, Sq).
// GQA is native: query head h reads KV head h / (H / KV) (jnp.repeat
// order), and a block works on one KV head, so each K/V tile it loads
// serves the whole query group.
//
// What bounds them on this card: at the serve and train paths' shapes each
// moves a few MB (bytes over 3.35 TB/s is 1-4 us) and computes far less
// than the tensor cores could, so the bound is bytes; the real cost is
// latency, instruction throughput and occupancy. All four run on the
// tensor cores, on the paged kernels' tile step (kernels/csrc/mma_tile.cuh:
// mma.sync m16n8k16, bf16 operands split into terms where a value is not
// exact in bf16, every k16 step a fresh fragment added rounded to
// nearest).
//   * flash_fwd: a block owns one (batch, KV head) and 64 rows of the
//     flattened (position, head-in-group) row space, 16 a warp: at
//     smollm's 8 x 256 tokens 480 blocks, at CLIP's vision tower 1,536. It
//     stages 64 keys a round in shared memory as bf16 (an f32 input split
//     into three planes), double-buffered by cp.async, and walks the rounds
//     up to its causal horizon and kv_valid only: tiles past them are
//     neither loaded nor computed, and a warp stops at its own last row's
//     horizon. q * scale takes one bf16 term where q is bf16 and the scale
//     a power of two (exact), else three (hd 80: 1 / sqrt(80)). The head
//     dim is padded in shared memory and registers to 64, 80 (CLIP's
//     vision tower: five k16 steps) or 128.
//   * flash_bwd_dq: flash_fwd's blocks, staging and walk, with the online
//     softmax replaced by the forward's lse: per chunk of 16 keys S and
//     dP = do V^T from fresh fragments, dS = P (dP - di) on them, and
//     dQ += dS K (see its kernel).
//   * decode_fwd: a split-key decode. Each slot's live keys are split into
//     parts of `part_keys` (16 while S_max <= 1,024), and the KV head's query
//     group into row tiles of 16 (T = ceil(group / 16): one up to
//     starcoder2's 12, three at granite's MQA 48); one warp a (part, row
//     tile), four warps a block, grid (KV, B, ceil(parts / 4) x T): at
//     smollm's 8 slots x 5 KV heads and S_max 256, 160 blocks of 64 keys. A
//     warp stages its part's keys as bf16 (16-byte cp.async, or an f32 cache
//     split into three planes) and walks them with tile_chunk, its row tile's
//     <= 16 query heads as the mma rows; parts past a slot's kv_len are
//     neither loaded nor computed. Each of the T warps of a part reads the
//     part's keys again (from L2 after the first). Each (part, row) writes
//     its (m, l, acc) to a workspace the wrapper allocates; the last block of
//     a (slot, KV head, row tile) to arrive on an integer ticket merges the
//     tile's live parts in part-index order by one formula per row, in the
//     same launch: the T tiles merge in parallel, each thread four output
//     elements at once (a first form that merged a slot's whole group in one
//     block, an element a thread at a time, read 50.8 us for granite's 48
//     rows at 8 slots). A row's arithmetic is its own (an mma output row
//     reads only its row of A), so a query head's output has the same bits at
//     any group that shares its launch. The cache's S_max need not be a
//     multiple of the part: the ragged part is masked.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); the Python wrapper raises on a non-zero code.
// decode_fwd's workspace and tickets come from its wrapper.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "../../csrc/mma_tile.cuh"

namespace {

__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// bf16 terms a staged input value of type T takes (split_bf16): f32 three
// (every f32 of the normal range exactly), f16 two (every f16 exactly, see
// the top of this file), bf16 one (itself)
template <typename T>
__host__ __device__ constexpr int n_terms() {
  return std::is_same<T, float>::value ? 3 : std::is_same<T, __half>::value ? 2 : 1;
}

// the C interface's dtype code of q, k, v and do (ops.DTYPE_CODE)
enum DtypeCode { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kDecWarps = 4;       // decode_fwd: warps (parts) per block
constexpr int kMaxParts = 64;      // decode_fwd: parts a slot's keys split into, at most
constexpr int kMaxGroup = 128;     // decode_fwd: query heads per KV head, at most
constexpr int kMmaWarps = 4;       // warps per block of flash_fwd and the backward (at most)
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kFwdRows = kMmaWarps * kTile;   // flash_fwd: flattened q rows per block
constexpr int kRoundKeys = 64;     // flash_fwd, flash_bwd_dq: keys staged per round
constexpr int kBwdKeys = kMmaWarps * kTile;   // flash_bwd_dkv: keys per block, 16 a warp
constexpr int kRoundRows = 32;     // flash_bwd_dkv: flattened q rows staged per round

// Above 48 KB of dynamic shared memory a kernel must opt in, up to what the
// card allows a block less the kernel's static shared memory: once per
// kernel, into the launcher's static max_smem (left 0 on failure).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int& max_smem) {
  if (max_smem != 0) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    optin -= static_cast<int>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  if (err == cudaSuccess) max_smem = optin;
  return err;
}

// A lane's rows g and g + 8 of a 16-row tile (rows[0], rows[1]; null for
// a dead row) as x * scale in f32 (scale 1: x itself), split into N bf16
// terms, as A fragments per k16 step: register r of step ks holds row g
// (r even) or g + 8, dims 16 ks + 2 q4 (+ 8 for r >= 2) and the next; dims
// past hd are zero.
template <int N, int HD, typename T>
__device__ __forceinline__ void row_fragments(uint32_t (&a)[N][HD / 16][4],
                                              const T* const (&rows)[2], int hd, float scale) {
  const int q4 = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const T* x = rows[r & 1];
      const int d = 16 * ks + 2 * q4 + 8 * (r >> 1);
      uint32_t t[N];
      split_pack<N>(x && d < hd ? __fmul_rn(to_f32(x[d]), scale) : 0.f,
                    x && d + 1 < hd ? __fmul_rn(to_f32(x[d + 1]), scale) : 0.f, t);
#pragma unroll
      for (int i = 0; i < N; ++i) a[i][ks][r] = t[i];
    }
}

// ---------------------------------------------------------------------------
// flash_fwd: grid (ceil(Sq * group / 64), KV, B), 128 threads. Flattened
// row r of (b, hk) is query position r / group, head hk * group + r % group;
// warp w owns rows r0 + 16 w .. r0 + 16 w + 15.
// ---------------------------------------------------------------------------

// Stage `n` <= kRoundKeys keys (key t's row at src + t * kv_row) of K and V
// into NT bf16 planes each at kd / vd (`plane` elements apart): with 16-byte
// alignment of a bf16 input as cp.async copies that land while the block
// computes on the other buffer; otherwise plain loads, an f32 input split
// into hi, mid and lo. Rows n .. kRoundKeys - 1 are zeroed (a chunk reads
// 16 rows: a dead key's V row must be finite, its weight is 0); dims past
// hd are never written (zero since the start). Threads tid, tid + nthreads,
// ... of the block take part.
template <typename T, int HD, int NT>
__device__ __forceinline__ void stage_keys(__nv_bfloat16* kd, __nv_bfloat16* vd, const T* ksrc,
                                           const T* vsrc, long long kv_row, int n, int hd,
                                           int plane, bool async, int tid,
                                           int nthreads) {
  constexpr int P = row_pitch<HD>();
  constexpr int kRow16 = P * 2 / 16;                           // 16-byte words a row
  for (int i = tid; i < NT * (kRoundKeys - n) * kRow16; i += nthreads) {
    const int u = i / ((kRoundKeys - n) * kRow16), w = i - u * (kRoundKeys - n) * kRow16;
    reinterpret_cast<uint4*>(kd + u * plane + n * P)[w] = make_uint4(0u, 0u, 0u, 0u);
    reinterpret_cast<uint4*>(vd + u * plane + n * P)[w] = make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (async) {
      const int per_row = hd / 8;
      for (int c = tid; c < n * per_row; c += nthreads) {
        const int t = c / per_row, d0 = (c - t * per_row) * 8;
        cp_async16(kd + t * P + d0, ksrc + t * kv_row + d0);
        cp_async16(vd + t * P + d0, vsrc + t * kv_row + d0);
      }
      return;
    }
  }
  for (int e = tid; e < n * hd; e += nthreads) {
    const int t = e / hd, d = e - t * hd;
    __nv_bfloat16 kt[NT], vt[NT];
    split_bf16<NT>(to_f32(ksrc[t * kv_row + d]), kt);
    split_bf16<NT>(to_f32(vsrc[t * kv_row + d]), vt);
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      kd[u * plane + t * P + d] = kt[u];
      vd[u * plane + t * P + d] = vt[u];
    }
  }
}

// The rounds of kRoundKeys keys [0, n_live) of one (batch, KV head) (key
// t's row at kb / vb + t * kv_row), staged by the block's nthreads threads
// into the two buffers of k_s and v_s (NT planes of kRoundKeys rows each,
// a buffer NT planes long): with `async` round rd + 1 in flight by cp.async
// while round rd is used, else each round by plain loads when its turn
// comes. body(rd, kr, vr, n) runs on round rd's n staged keys, between two
// barriers of the block.
template <typename T, int HD, int NT, typename Body>
__device__ __forceinline__ void walk_rounds(__nv_bfloat16* k_s, __nv_bfloat16* v_s, const T* kb,
                                            const T* vb, long long kv_row, int n_live, int hd,
                                            bool async, int tid, int nthreads, Body&& body) {
  constexpr int kPlane = kRoundKeys * row_pitch<HD>();
  constexpr int kBuf = NT * kPlane;
  const int n_rounds = (n_live + kRoundKeys - 1) / kRoundKeys;
  auto stage = [&](int rd) {
    const int j0 = rd * kRoundKeys;
    stage_keys<T, HD, NT>(k_s + (rd & 1) * kBuf, v_s + (rd & 1) * kBuf, kb + j0 * kv_row,
                          vb + j0 * kv_row, kv_row, min(kRoundKeys, n_live - j0), hd, kPlane,
                          async, tid, nthreads);
  };
  // async: round 0 in flight before the loop, and the next (a commit group
  // each, empty past the last round) as each is consumed
  if (async) {
    if (n_rounds > 0) stage(0);
    cp_async_commit();
  }
  for (int rd = 0; rd < n_rounds; ++rd) {
    if (async) {
      if (rd + 1 < n_rounds) stage(rd + 1);                    // into the buffer round
      cp_async_commit();                                       // rd - 1 freed
      cp_async_wait<1>();                                      // round rd has landed
    } else {
      stage(rd);
    }
    __syncthreads();                                           // round rd staged
    body(rd, k_s + (rd & 1) * kBuf, v_s + (rd & 1) * kBuf,
         min(kRoundKeys, n_live - rd * kRoundKeys));
    __syncthreads();                                           // round rd fully used
  }
}

template <typename T, int HD>
constexpr size_t fwd_smem() {
  constexpr int NT = n_terms<T>();
  // K and V of two rounds, NT planes of kRoundKeys rows each
  return 2 * 2 * NT * sizeof(__nv_bfloat16) * static_cast<size_t>(kRoundKeys) * row_pitch<HD>();
}

template <typename T, int HD, int NQ>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 int hd, int kv_valid, int causal, float scale) {
  constexpr int NT = n_terms<T>();
  constexpr int P = row_pitch<HD>();
  constexpr int kPlane = kRoundKeys * P;                       // elements of one plane
  constexpr int kBuf = NT * kPlane;                            // one round's K (or V)
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);    // [2][NT][kPlane]
  __nv_bfloat16* v_s = k_s + 2 * kBuf;
  const int group = H / KV, hk = blockIdx.y, b = blockIdx.z;
  const int n_rows = Sq * group, r0 = blockIdx.x * kFwdRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const long long kv_row = static_cast<long long>(KV) * hd;   // key stride
  const T* kb = k + static_cast<long long>(b) * Sk * kv_row + static_cast<long long>(hk) * hd;
  const T* vb = v + static_cast<long long>(b) * Sk * kv_row + static_cast<long long>(hk) * hd;

  // live keys of the block: below kv_valid and, causal, up to its last row
  const int n_valid = min(kv_valid, Sk);
  int n_live = n_valid;
  if (causal) n_live = min(n_live, (min(r0 + kFwdRows, n_rows) - 1) / group + 1);

  // with hd < HD the staging buffers zeroed, so the dims past hd read as
  // zeros (a key's padding meets the query's zero padding)
  if (hd < HD) {
    uint4* z = reinterpret_cast<uint4*>(k_s);
    const int n16 = static_cast<int>(2 * 2 * kBuf * sizeof(__nv_bfloat16) / 16);
    for (int i = tid; i < n16; i += kMmaThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  // this warp's rows wr0 .. wr0 + 15; lane's rows g and g + 8 and their
  // live-key limits; the warp's horizon, its last row's limit
  const int wr0 = r0 + kTile * warp;
  const bool active = wr0 < n_rows;
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    lim[h] = !(active && r < n_rows) ? 0 : (causal ? min(r / group + 1, n_valid) : n_valid);
  }
  const int last = min(wr0 + kTile, n_rows) - 1;
  const int warp_lim = !active ? 0 : (causal ? min(last / group + 1, n_valid) : n_valid);

  // q * scale in f32, split into NQ bf16 terms, as A fragments
  const T* qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    qrow[h] = !(active && r < n_rows) ? nullptr
              : q + (static_cast<long long>(b) * Sq + r / group) * H * hd +
                    static_cast<long long>(hk * group + r % group) * hd;
  }
  uint32_t qa[NQ][HD / 16][4];
  row_fragments<NQ, HD>(qa, qrow, hd, scale);

  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f}, acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  const bool async = std::is_same<T, __nv_bfloat16>::value && hd % 8 == 0 && kv_row % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0;
  __syncthreads();                                             // zeroed buffers
  walk_rounds<T, HD, NT>(k_s, v_s, kb, vb, kv_row, n_live, hd, async, tid, kMmaThreads,
                         [&](int rd, const __nv_bfloat16* kr, const __nv_bfloat16* vr, int n) {
    if (!active) return;
    for (int t0 = 0; t0 < n; t0 += kChunk) {                   // chunks in order
      const int kpos0 = rd * kRoundKeys + t0;
      if (kpos0 >= warp_lim) break;                            // dead for every row of the warp
      tile_chunk<HD, NQ, NT>(qa, kr + t0 * P, vr + t0 * P, kPlane, min(kChunk, n - t0), kpos0,
                             lim, m, l, acc);
    }
  });

  if (!active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    if (r >= n_rows) continue;
    const int pos = r / group, head = hk * group + r % group;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    T* orow = o + (static_cast<long long>(b) * Sq + pos) * H * hd + static_cast<long long>(head) * hd;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * nt + 2 * q4 + e;
        if (d < hd) orow[d] = from_f32<T>(__fdiv_rn(acc[nt][2 * h + e], l_safe));
      }
    if (q4 == 0)
      lse[(static_cast<long long>(b) * H + head) * Sq + pos] = __fadd_rn(m[h], logf(l_safe));
  }
}

// ---------------------------------------------------------------------------
// decode_fwd: grid (KV, B, ceil(parts / 4) x T), 128 threads, T =
// ceil(group / 16) row tiles. q, o (B, 1, H, hd); the cache k, v (B, S,
// KV, hd); kv_len (B,) int32 live cells per slot. Block z takes row tile
// t = z / ceil(parts / 4), and its warp w part p = 4 (z % ceil(parts / 4))
// + w: the keys p * part_keys .. up to (p + 1) * part_keys and the slot's
// live count, walked in chunks of 16 with tile_chunk. Tile row i is the
// group's row 16 t + i, query head hk * group + 16 t + i (q * scale as A
// fragments); rows past the group are dead. It writes the part's (m, l,
// acc) per query row to `work`: stats [B][KV][parts][group][2] (m, l),
// then acc [B][KV][parts][group][hd]. A part with no live key is neither
// loaded nor computed. Each block then takes an integer ticket of its
// (slot, KV head, row tile); the last of its ceil(parts / 4) blocks to
// arrive resets the ticket to 0 (ready for the next launch or graph
// replay) and merges the tile's rows' live parts in the dynamic shared
// memory the chunks were staged in (the T tiles merge in parallel): their
// (m, l) staged; per query row, the parts p = 0, 1, ...
// in order, M = max m_p, c_p = e^(m_p - M), L = sum l_p c_p; per output
// element A = sum acc_p c_p (each sum an fma in part order), o = A / L
// (L = 1 where it is 0: kv_len 0 gives o = 0). The order is fixed whichever
// block merges, so two launches give the same bits, and a row's result
// does not depend on the other rows of its group.
// ---------------------------------------------------------------------------
template <typename TC, int HD>
constexpr size_t decode_smem() {
  constexpr int NT = n_terms<TC>();
  // per warp K and V of one chunk, NT planes each
  return sizeof(__nv_bfloat16) * kDecWarps * 2 * NT * static_cast<size_t>(kChunk) * row_pitch<HD>();
}

// a row tile's merge arrays in the same dynamic shared memory: the live
// parts' (m, l) [parts][16][2], their weights c [parts][16], L [16]
__host__ __device__ constexpr size_t decode_merge_smem(int parts) {
  return sizeof(float) * (3 * static_cast<size_t>(parts) * kTile + kTile);
}

template <typename TQ, typename TC, int HD, int NQ>
__global__ void __launch_bounds__(kDecWarps * 32)
decode_fwd_kernel(const TQ* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
                  const int* __restrict__ kv_len, TQ* __restrict__ o, float* __restrict__ work,
                  int* __restrict__ tickets, int S, int H, int KV, int hd, int parts,
                  int part_keys, float scale) {
  constexpr int NT = n_terms<TC>();
  constexpr int P = row_pitch<HD>();
  constexpr int kPlane = kChunk * P;                           // elements of one plane
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ int last;
  const int group = H / KV, hk = blockIdx.x, b = blockIdx.y, B = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int part_blocks = (parts + kDecWarps - 1) / kDecWarps;
  const int part = (blockIdx.z % part_blocks) * kDecWarps + warp;
  const int row0 = (blockIdx.z / part_blocks) * kTile;         // the row tile's first group row
  const int n_live = max(0, min(kv_len[b], S));
  const int j0 = part * part_keys;
  const long long slot = static_cast<long long>(b) * KV + hk;
  const long long acc0 = 2LL * B * KV * parts * group;          // acc's offset in work

  if (part < parts && j0 < n_live) {                           // a live part
    const int j1 = min(j0 + part_keys, n_live);
    const long long kv_row = static_cast<long long>(KV) * hd;  // key stride
    const TC* kb = k + static_cast<long long>(b) * S * kv_row + static_cast<long long>(hk) * hd;
    const TC* vb = v + static_cast<long long>(b) * S * kv_row + static_cast<long long>(hk) * hd;
    __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(tc_smem) + warp * 2 * NT * kPlane;
    __nv_bfloat16* v_s = k_s + NT * kPlane;
    const bool async = std::is_same<TC, __nv_bfloat16>::value && hd % 8 == 0 &&
                       kv_row % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;

    // the chunk of n keys at c0 into this warp's planes, all 16 rows: rows
    // n .. 15 repeat key n - 1 (finite; their weights are 0), by 16-byte
    // cp.async (a bf16 cache with aligned rows) or plain loads split into
    // NT terms. Dims past hd are zeroed once, before the first chunk.
    if (hd < HD) {
      uint4* z = reinterpret_cast<uint4*>(k_s);
      constexpr int n16 = static_cast<int>(2 * NT * kPlane * sizeof(__nv_bfloat16) / 16);
      for (int i = lane; i < n16; i += 32) z[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncwarp();
    }
    auto stage = [&](int c0, int n) {
      __syncwarp();                                            // the previous chunk used
      const TC* ks = kb + c0 * kv_row;
      const TC* vs = vb + c0 * kv_row;
      if constexpr (std::is_same<TC, __nv_bfloat16>::value) {
        if (async) {
          const int per_row = hd / 8;
          for (int c = lane; c < kChunk * per_row; c += 32) {
            const int t = c / per_row, d0 = (c - t * per_row) * 8, src = min(t, n - 1);
            cp_async16(k_s + t * P + d0, ks + src * kv_row + d0);
            cp_async16(v_s + t * P + d0, vs + src * kv_row + d0);
          }
          cp_async_commit();
          return;
        }
      }
      for (int e = lane; e < kChunk * hd; e += 32) {
        const int t = e / hd, d = e - t * hd, src = min(t, n - 1);
        __nv_bfloat16 kt[NT], vt[NT];
        split_bf16<NT>(to_f32(ks[src * kv_row + d]), kt);
        split_bf16<NT>(to_f32(vs[src * kv_row + d]), vt);
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          k_s[u * kPlane + t * P + d] = kt[u];
          v_s[u * kPlane + t * P + d] = vt[u];
        }
      }
    };
    stage(j0, min(kChunk, j1 - j0));                           // in flight while q is read

    // q * scale of the tile's rows (group rows row0 + g and row0 + g + 8,
    // query heads hk * group + those; rows past the group are zero) as NQ
    // bf16 terms, A fragments
    const int rows[2] = {row0 + g, row0 + g + 8};
    const TQ* qrow[2] = {rows[0] < group ? q + (slot * group + rows[0]) * hd : nullptr,
                         rows[1] < group ? q + (slot * group + rows[1]) * hd : nullptr};
    uint32_t qa[NQ][HD / 16][4];
    row_fragments<NQ, HD>(qa, qrow, hd, scale);
    const int lim[2] = {rows[0] < group ? j1 : 0, rows[1] < group ? j1 : 0};
    float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f}, acc[HD / 8][4];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

    for (int c0 = j0; c0 < j1; c0 += kChunk) {
      const int n = min(kChunk, j1 - c0);
      if (c0 > j0) stage(c0, n);
      if (async) cp_async_wait<0>();
      __syncwarp();                                            // the chunk staged
      tile_chunk<HD, NQ, NT>(qa, k_s, v_s, kPlane, n, c0, lim, m, l, acc);
    }

    // the part's (m, l, acc) of the tile's rows in the group: lane holds
    // dims 8 nt + 2 q4 and the next of rows[0] (acc[nt][0, 1]) and rows[1]
    // (acc[nt][2, 3])
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= group) continue;
      const long long at = (slot * parts + part) * group + rows[h];
      if (q4 == 0) {
        work[2 * at] = m[h];
        work[2 * at + 1] = l[h];
      }
      float* wa = work + acc0 + at * hd;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * nt + 2 * q4 + e;
          if (d < hd) wa[d] = acc[nt][2 * h + e];
        }
    }
  }

  // the ticket of this row tile: this block's parts written and visible
  // before it arrives
  const int tiles = gridDim.z / part_blocks;
  int* ticket = tickets + slot * tiles + row0 / kTile;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(ticket, 1) == part_blocks - 1;
    if (last) *ticket = 0;                                     // for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block of the row tile merges its rows' live parts (loads from
  // L2: other blocks wrote them), in the shared memory its chunks were
  // staged in (every warp is past its last chunk: no copy is in flight)
  const int n_parts = (n_live + part_keys - 1) / part_keys;
  const int t_rows = min(kTile, group - row0);                 // the tile's rows in the group
  const float* stats = work + 2 * slot * parts * group;        // [parts][group][2]
  const float* accs = work + acc0 + slot * parts * group * hd;  // [parts][group][hd]
  float* st_s = reinterpret_cast<float*>(tc_smem);             // [parts][t_rows][2]: (m, l)
  float* c_s = st_s + 2 * parts * kTile;                       // [parts][t_rows]: e^(m_p - M)
  float* l_s = c_s + parts * kTile;                            // [t_rows]: L, 1 where it is 0
  for (int i = tid; i < 2 * n_parts * t_rows; i += blockDim.x) {
    const int p = i / (2 * t_rows);
    st_s[i] = __ldcg(stats + 2 * (p * group + row0) + (i - 2 * p * t_rows));
  }
  __syncthreads();
  for (int i = tid; i < t_rows; i += blockDim.x) {             // one thread a row, parts in order
    float mx = kMask;
    for (int p = 0; p < n_parts; ++p) mx = fmaxf(mx, st_s[2 * (p * t_rows + i)]);
    float sum_l = 0.f;
    for (int p = 0; p < n_parts; ++p) {
      const float c = expf(__fsub_rn(st_s[2 * (p * t_rows + i)], mx));
      c_s[p * t_rows + i] = c;
      sum_l = __fmaf_rn(st_s[2 * (p * t_rows + i) + 1], c, sum_l);
    }
    l_s[i] = sum_l == 0.f ? 1.f : sum_l;
  }
  __syncthreads();
  // A = sum_p acc_p c_p per output element, four elements a thread at once
  // so that each part's four loads are in flight together; each element's
  // sum still runs over the parts in order
  constexpr int kPer = 4;
  const int n_out = t_rows * hd;
  for (int e0 = tid; e0 < n_out; e0 += kPer * blockDim.x) {
    int ri[kPer], di[kPer];
    float sum_a[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = min(e0 + j * static_cast<int>(blockDim.x), n_out - 1);
      ri[j] = e / hd;
      di[j] = e - ri[j] * hd;
      sum_a[j] = 0.f;
    }
#pragma unroll 4
    for (int p = 0; p < n_parts; ++p)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        sum_a[j] = __fmaf_rn(
            __ldcg(accs + (static_cast<long long>(p) * group + row0 + ri[j]) * hd + di[j]),
            c_s[p * t_rows + ri[j]], sum_a[j]);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (e0 + j * static_cast<int>(blockDim.x) < n_out)
        o[(slot * group + row0 + ri[j]) * hd + di[j]] =
            from_f32<TQ>(__fdiv_rn(sum_a[j], l_s[ri[j]]));
  }
}

// ---------------------------------------------------------------------------
// Backward (training): recompute-style, as the TPU kernels and the plain
// version (ref.py flash_bwd_dq / flash_bwd_dkv) compute it. With s the
// forward's scores (the same (q * scale) . k in f32, the same masking with
// MASK_VALUE, so exp(MASK - lse) is exactly 0) and lse the forward's
// logsumexp:
//   p = exp(s - lse),  dp = do . v,  ds = p * (dp - di),
//   dq = scale * sum_j ds_j k_j,  dk = scale * sum_r ds_r q_r,
//   dv = sum_r p_r do_r,
// with di = sum_d o * do computed by the wrapper in f32, outside the
// kernels, as the JAX package does. Outputs are f32; the autograd function
// casts them once to the input types.
//
// No floating-point atomics: every output element is written by one thread,
// which sums its terms in one fixed order (chunks of 16 keys in order for
// dq, of 16 query rows for dk and dv; an mma sums a chunk in a fixed order
// too), so two launches on the same inputs give bit-identical results.
//
// What bounds them on an H100: at the training path's shapes (8 x 256
// tokens, 15 query heads over 5 KV heads, hd 64) each moves a few MB and
// does about 2.5x the forward's matmul work, far under the tensor cores'
// rate: the bound is bytes, the real cost is latency and instruction
// throughput. Both run their products on the tensor cores (see each
// kernel).

// ---------------------------------------------------------------------------
// flash_bwd_dq: grid (ceil(tiles / w), KV, B), 32 w threads, on the tensor
// cores (the tile step's products, kernels/csrc/mma_tile.cuh). The
// outputs' rows are query rows, so the block is flash_fwd's: w <= 4 tiles
// of 16 flattened (position, head-in-group) rows of one KV head, a warp
// each, so one staged K/V round serves the whole query group; K and V
// staged 64 keys a round as flash_fwd stages them, up to the block's
// causal horizon and kv_valid. The Sq * group rows make `tiles` tiles of
// 16, and the launcher spreads them evenly over the fewest blocks of at
// most four (CLIP's 129 vision rows: 3 + 3 + 3 tiles, not 4 + 4 + 1).
// A warp keeps q * scale (NQ bf16 terms) and do (NT terms) as A fragments
// for the whole walk, and dQ (16 x HD) in registers. Per chunk of 16 keys:
//   * S = (q * scale) K^T and dP = do V^T (chunk_scores: each k16 step's
//     pairs of terms a fresh fragment); S is the forward's, bit for bit;
//   * P = exp(S - lse), dS = P (dP - di) on the C fragments (dead keys and
//     rows past the end get p = 0);
//   * dS in three bf16 terms as the A operand of dQ += dS K, K the B
//     operand by ldmatrix.trans (chunk_times, as flash_fwd's P V), each
//     chunk's fresh fragments added in f32 rounded to nearest.
// A chunk whose keys all lie past the warp's last row (causal) contributes
// exactly 0 and is skipped, with every later one. dq = scale * acc, each
// element one lane's sum in one order: two launches give the same bits.
// ---------------------------------------------------------------------------
// flash_bwd_dq's blocks an SM must hold at 128 threads (__launch_bounds__,
// read on the card: each step up spills no more than 36 bytes): bf16 at
// HD 64 with one q term four (128 registers), at HD 80 three (168); the
// rest, with more terms or dims to hold, two.
template <typename T, int HD, int NQ>
constexpr int dq_min_blocks() {
  if (!std::is_same<T, __nv_bfloat16>::value) return 2;
  return HD == 64 && NQ == 1 ? 4 : HD == 80 ? 3 : 2;
}

template <typename T, int HD, int NQ>
__global__ void __launch_bounds__(kMmaThreads, dq_min_blocks<T, HD, NQ>())
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq, int Sq, int Sk, int H,
                    int KV, int hd, int kv_valid, int causal, float scale) {
  constexpr int NT = n_terms<T>();
  constexpr int P = row_pitch<HD>();
  constexpr int kPlane = kRoundKeys * P;                       // elements of one plane
  constexpr int kBuf = NT * kPlane;                            // one round's K (or V)
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);    // [2][NT][kPlane]
  __nv_bfloat16* v_s = k_s + 2 * kBuf;
  const int group = H / KV, hk = blockIdx.y, b = blockIdx.z;
  const int nthreads = blockDim.x, block_rows = kTile * (nthreads >> 5);
  const int n_rows = Sq * group, r0 = blockIdx.x * block_rows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const long long kv_row = static_cast<long long>(KV) * hd;   // key stride
  const T* kb = k + static_cast<long long>(b) * Sk * kv_row + static_cast<long long>(hk) * hd;
  const T* vb = v + static_cast<long long>(b) * Sk * kv_row + static_cast<long long>(hk) * hd;

  // live keys of the block: below kv_valid and, causal, up to its last row
  const int n_valid = min(kv_valid, Sk);
  int n_live = n_valid;
  if (causal) n_live = min(n_live, (min(r0 + block_rows, n_rows) - 1) / group + 1);

  if (hd < HD) {                                               // padded dims read as zeros
    uint4* z = reinterpret_cast<uint4*>(k_s);
    const int n16 = static_cast<int>(2 * 2 * kBuf * sizeof(__nv_bfloat16) / 16);
    for (int i = tid; i < n16; i += nthreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  // this warp's rows wr0 .. wr0 + 15; lane's rows g and g + 8 (h = 0, 1),
  // their live-key limits, lse and di; the warp's horizon
  const int wr0 = r0 + kTile * warp;
  const bool active = wr0 < n_rows;
  int lim[2];
  float row_lse[2], row_di[2];
  const T *qrow[2], *dorow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    const bool live = active && r < n_rows;
    lim[h] = !live ? 0 : (causal ? min(r / group + 1, n_valid) : n_valid);
    const long long row = (static_cast<long long>(b) * Sq + r / group) * H * hd +
                          static_cast<long long>(hk * group + r % group) * hd;
    qrow[h] = live ? q + row : nullptr;
    dorow[h] = live ? dout + row : nullptr;
    const long long at = (static_cast<long long>(b) * H + hk * group + r % group) * Sq + r / group;
    row_lse[h] = live ? lse[at] : 0.f;
    row_di[h] = live ? di[at] : 0.f;
  }
  const int last = min(wr0 + kTile, n_rows) - 1;
  const int warp_lim = !active ? 0 : (causal ? min(last / group + 1, n_valid) : n_valid);

  // q * scale (NQ terms) and do (NT terms) as A fragments
  uint32_t qa[NQ][HD / 16][4], da[NT][HD / 16][4];
  row_fragments<NQ, HD>(qa, qrow, hd, scale);
  row_fragments<NT, HD>(da, dorow, hd, 1.f);

  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  const bool async = std::is_same<T, __nv_bfloat16>::value && hd % 8 == 0 && kv_row % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0;
  __syncthreads();                                             // zeroed buffers
  walk_rounds<T, HD, NT>(k_s, v_s, kb, vb, kv_row, n_live, hd, async, tid, nthreads,
                         [&](int rd, const __nv_bfloat16* kr, const __nv_bfloat16* vr, int n) {
    if (!active) return;
    for (int t0 = 0; t0 < n; t0 += kChunk) {                   // chunks in order
      const int kpos0 = rd * kRoundKeys + t0;
      if (kpos0 >= warp_lim) break;                            // dead for every row of the warp
      const int nc = min(kChunk, n - t0);
      float s[2][4], dp[2][4];
      chunk_scores<HD, NQ, NT>(s, qa, kr + t0 * P, kPlane);
      chunk_scores<HD, NT, NT>(dp, da, vr + t0 * P, kPlane);
      // element i of tile j: row g + 8 (i >> 1), key kpos0 + 8 j + 2 q4 + (i & 1)
      float ds[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = 8 * j + 2 * q4 + (i & 1), h = i >> 1;
          const bool live = key < nc && kpos0 + key < lim[h];
          const float p = live ? expf(__fsub_rn(s[j][i], row_lse[h])) : 0.f;
          ds[j][i] = __fmul_rn(p, __fsub_rn(dp[j][i], row_di[h]));
        }
      // dS as A fragments (16 rows x 16 keys), three bf16 terms
      uint32_t sa[kPTerms][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = r >> 1, i = 2 * (r & 1);
        uint32_t t[kPTerms];
        split_pack<kPTerms>(ds[j][i], ds[j][i + 1], t);
#pragma unroll
        for (int u = 0; u < kPTerms; ++u) sa[u][r] = t[u];
      }
      // dQ += dS K, two n8 tiles of dims at a time
#pragma unroll
      for (int nt = 0; nt < HD / 8; nt += 2) {
        float f[2][4];
        chunk_times<HD, NT>(f, sa, kr + t0 * P, kPlane, nt);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[nt][i] = __fadd_rn(acc[nt][i], f[0][i]);
          acc[nt + 1][i] = __fadd_rn(acc[nt + 1][i], f[1][i]);
        }
      }
    }
  });

  if (!active) return;
  // lane holds rows g and g + 8, dims 8 nt + 2 q4 and the next
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    if (r >= n_rows) continue;
    float* drow = dq + (static_cast<long long>(b) * Sq + r / group) * H * hd +
                  static_cast<long long>(hk * group + r % group) * hd;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * nt + 2 * q4 + e;
        if (d < hd) drow[d] = __fmul_rn(scale, acc[nt][2 * h + e]);
      }
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_dkv: grid (ceil(Sk / 64), KV, B), 128 threads, on the tensor
// cores (mma.sync m16n8k16, the tile step's arithmetic of
// kernels/csrc/mma_tile.cuh). A block owns 64 keys of one KV head, a warp
// 16 of them, staged once. The outputs' rows are keys, so each warp keeps
// dV = P^T dO and dK = scale * dS^T Q of its 16 keys (16 x hd each) in
// registers and contracts over the flattened (position, head-in-group)
// query rows in k16 chunks: the GQA group sum comes free. The block walks
// the rows that can see its keys (from its first key's position on, when
// causal) in rounds of 32, staged by cp.async, double-buffered (bf16) or by
// plain loads split into three bf16 planes (f32): q (the B operand of
// dK), q * scale (of S: one bf16 term where q is bf16 and the scale a
// power of two, else three), do, lse and di. Per chunk of 16 rows a warp
//   * recomputes S^T = K (q * scale)^T and dP^T = V do^T (K and V as A
//     fragments by ldmatrix, q and do as B);
//   * P^T = exp(S^T - lse), dS^T = P^T (dP^T - di) on the fragments (dead
//     keys and rows past the end get p = 0);
//   * reuses those accumulator fragments as A operands, each split into
//     three bf16 terms in registers, for dV += P^T do and dK += dS^T q
//     (do and q by ldmatrix.trans).
// Every k16 step is a fresh fragment added in f32 rounded to nearest. No
// atomics and no split of the rows across blocks: each output element is
// one lane's sum in one order, so two launches give the same bits. A chunk
// whose rows all lie before the warp's first key (causal) contributes
// exactly 0 and is skipped. Keys at or past kv_valid see p = 0, so their dk
// and dv are 0, as in the TPU kernel.
// ---------------------------------------------------------------------------
template <typename T, int HD, int NQ>
constexpr size_t dkv_smem() {
  constexpr int NT = n_terms<T>();
  constexpr size_t P = row_pitch<HD>();
  constexpr size_t bufs = NT == 1 ? 2 : 1;
  return sizeof(__nv_bfloat16) * (2 * NT * kBwdKeys * P + bufs * (NQ + 2 * NT) * kRoundRows * P) +
         sizeof(float) * 2 * bufs * kRoundRows;
}

template <typename T, int HD, int NQ>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Sk, int H, int KV, int hd,
                     int kv_valid, int causal, float scale) {
  constexpr int NT = n_terms<T>();
  constexpr int P = row_pitch<HD>();
  constexpr int kKeyPlane = kBwdKeys * P;
  constexpr int kRowPlane = kRoundRows * P;
  constexpr int kBufs = NT == 1 ? 2 : 1;                       // f32 stages by plain loads
  constexpr int kBuf = (NQ + 2 * NT) * kRowPlane;              // q * scale, q, do
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);    // [NT][kKeyPlane]
  __nv_bfloat16* v_s = k_s + NT * kKeyPlane;                      // [NT][kKeyPlane]
  __nv_bfloat16* r_s = v_s + NT * kKeyPlane;                      // [kBufs][kBuf]
  float* lse_s = reinterpret_cast<float*>(r_s + kBufs * kBuf);    // [kBufs][kRoundRows]
  float* di_s = lse_s + kBufs * kRoundRows;
  const int group = H / KV, hk = blockIdx.y, b = blockIdx.z;
  const int j0 = blockIdx.x * kBwdKeys;
  const int n_rows = Sq * group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const long long kv_row = static_cast<long long>(KV) * hd;
  const int n_valid = min(kv_valid, Sk);
  const int n_keys = max(0, min(kBwdKeys, n_valid - j0));     // live keys of the block
  const int kw0 = j0 + kTile * warp;                           // the warp's first key

  float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[nt][i] = acc_v[nt][i] = 0.f;

  // causal: query positions before the block's first key see none of it
  const int row_start = causal ? min(j0, Sq) * group : 0;
  const int n_rounds = n_keys > 0 ? (n_rows - row_start + kRoundRows - 1) / kRoundRows : 0;
  const bool async = std::is_same<T, __nv_bfloat16>::value && hd % 8 == 0 && kv_row % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dout) % 16 == 0;

  if (n_rounds > 0) {
    // every staged byte zero first: dims past hd, keys past the live ones
    // and rows past the end then read as zeros
    {
      uint4* z = reinterpret_cast<uint4*>(tc_smem);
      const int n16 = static_cast<int>((2 * NT * kKeyPlane + kBufs * kBuf) *
                                       sizeof(__nv_bfloat16) / 16);
      for (int i = tid; i < n16; i += kMmaThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    // the block's live keys of K and V
    {
      const T* kb = k + (static_cast<long long>(b) * Sk + j0) * kv_row + static_cast<long long>(hk) * hd;
      const T* vb = v + (static_cast<long long>(b) * Sk + j0) * kv_row + static_cast<long long>(hk) * hd;
      if (async) {
        const int per_row = hd / 8;
        for (int c = tid; c < n_keys * per_row; c += kMmaThreads) {
          const int t = c / per_row, d0 = (c - t * per_row) * 8;
          cp_async16(k_s + t * P + d0, kb + t * kv_row + d0);
          cp_async16(v_s + t * P + d0, vb + t * kv_row + d0);
        }
      } else {
        for (int e = tid; e < n_keys * hd; e += kMmaThreads) {
          const int t = e / hd, d = e - t * hd;
          __nv_bfloat16 kt[NT], vt[NT];
          split_bf16<NT>(to_f32(kb[t * kv_row + d]), kt);
          split_bf16<NT>(to_f32(vb[t * kv_row + d]), vt);
#pragma unroll
          for (int u = 0; u < NT; ++u) {
            k_s[u * kKeyPlane + t * P + d] = kt[u];
            v_s[u * kKeyPlane + t * P + d] = vt[u];
          }
        }
      }
    }
  }

  // Stage round rd's rows row_start + 32 rd + [0, n) into its buffer:
  // planes q * scale (NQ), q (NT), do (NT); lse and di. Rows past n are
  // zero (since the start, or rewritten so here). The async path leaves
  // q * scale to scale_round, once q has landed.
  auto stage = [&](int rd) {
    const int rr0 = row_start + rd * kRoundRows, n = min(kRoundRows, n_rows - rr0);
    __nv_bfloat16* qt = r_s + (rd % kBufs) * kBuf;
    __nv_bfloat16* qp = qt + NQ * kRowPlane;
    __nv_bfloat16* dp = qp + NT * kRowPlane;
    if (tid < kRoundRows) {
      float ll = 0.f, dd = 0.f;
      if (tid < n) {
        const int r = rr0 + tid;
        const long long at = (static_cast<long long>(b) * H + hk * group + r % group) * Sq + r / group;
        ll = lse[at];
        dd = di[at];
      }
      lse_s[(rd % kBufs) * kRoundRows + tid] = ll;
      di_s[(rd % kBufs) * kRoundRows + tid] = dd;
    }
    if (n < kRoundRows) {                                      // the last round's tail
      constexpr int kRow16 = P * 2 / 16;
      const int tail = (kRoundRows - n) * kRow16;
      for (int i = tid; i < (NQ + 2 * NT) * tail; i += kMmaThreads) {
        const int u = i / tail, w = i - u * tail;
        reinterpret_cast<uint4*>(qt + u * kRowPlane + n * P)[w] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    auto row_at = [&](const T* base, int t) {
      const int r = rr0 + t;
      return base + (static_cast<long long>(b) * Sq + r / group) * H * hd +
             static_cast<long long>(hk * group + r % group) * hd;
    };
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (async) {
        const int per_row = hd / 8;
        for (int c = tid; c < n * per_row; c += kMmaThreads) {
          const int t = c / per_row, d0 = (c - t * per_row) * 8;
          cp_async16(qp + t * P + d0, row_at(q, t) + d0);
          cp_async16(dp + t * P + d0, row_at(dout, t) + d0);
        }
        return;
      }
    }
    for (int e = tid; e < n * hd; e += kMmaThreads) {
      const int t = e / hd, d = e - t * hd;
      const float x = to_f32(row_at(q, t)[d]);
      __nv_bfloat16 xt[NT], st[NQ], ot[NT];
      split_bf16<NT>(x, xt);
      split_bf16<NQ>(__fmul_rn(x, scale), st);
      split_bf16<NT>(to_f32(row_at(dout, t)[d]), ot);
#pragma unroll
      for (int u = 0; u < NQ; ++u) qt[u * kRowPlane + t * P + d] = st[u];
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        qp[u * kRowPlane + t * P + d] = xt[u];
        dp[u * kRowPlane + t * P + d] = ot[u];
      }
    }
  };
  // async: q * scale from the landed bf16 q plane (rows past n stay zero)
  auto scale_round = [&](int rd) {
    const int n = min(kRoundRows, n_rows - (row_start + rd * kRoundRows));
    __nv_bfloat16* qt = r_s + (rd % kBufs) * kBuf;
    const __nv_bfloat16* qp = qt + NQ * kRowPlane;
    for (int e = tid; e < n * hd; e += kMmaThreads) {
      const int t = e / hd, d = e - t * hd;
      __nv_bfloat16 st[NQ];
      split_bf16<NQ>(__fmul_rn(__bfloat162float(qp[t * P + d]), scale), st);
#pragma unroll
      for (int u = 0; u < NQ; ++u) qt[u * kRowPlane + t * P + d] = st[u];
    }
  };

  if (async) {
    if (n_rounds > 0) stage(0);
    cp_async_commit();                                         // with the keys
  }
  for (int rd = 0; rd < n_rounds; ++rd) {
    if (async) {
      if (rd + 1 < n_rounds) stage(rd + 1);                    // into the buffer round
      cp_async_commit();                                       // rd - 1 freed
      cp_async_wait<1>();                                      // round rd has landed
      __syncthreads();
      scale_round(rd);
    } else {
      stage(rd);
    }
    __syncthreads();                                           // round rd staged
    const __nv_bfloat16* qt = r_s + (rd % kBufs) * kBuf;
    const __nv_bfloat16* qp = qt + NQ * kRowPlane;
    const __nv_bfloat16* dp = qp + NT * kRowPlane;
    const float* ls = lse_s + (rd % kBufs) * kRoundRows;
    const float* ds_ = di_s + (rd % kBufs) * kRoundRows;
    const int rr0 = row_start + rd * kRoundRows;
    if (kw0 < j0 + n_keys) {                                   // the warp has live keys
#pragma unroll
      for (int c = 0; c < kRoundRows / kTile; ++c) {
        const int cr0 = rr0 + kTile * c;                       // the chunk's first row
        if (cr0 >= n_rows) break;
        if (causal && (min(cr0 + kTile, n_rows) - 1) / group < kw0) continue;
        // S^T and dP^T (16 keys x 16 rows, two n8 tiles of rows each)
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float dpt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          uint32_t ka[NT][4], va[NT][4], f[4];
          uint32_t qb0[NQ][2], qb1[NQ][2], ob0[NT][2], ob1[NT][2];
#pragma unroll
          for (int u = 0; u < NT; ++u) {
            load_a<P>(ka[u], k_s + u * kKeyPlane + kTile * warp * P, 16 * ks);
            load_a<P>(va[u], v_s + u * kKeyPlane + kTile * warp * P, 16 * ks);
            load_b_rows<P>(f, dp + u * kRowPlane + kTile * c * P, 16 * ks);
            ob0[u][0] = f[0];
            ob0[u][1] = f[1];
            ob1[u][0] = f[2];
            ob1[u][1] = f[3];
          }
#pragma unroll
          for (int u = 0; u < NQ; ++u) {
            load_b_rows<P>(f, qt + u * kRowPlane + kTile * c * P, 16 * ks);
            qb0[u][0] = f[0];
            qb0[u][1] = f[1];
            qb1[u][0] = f[2];
            qb1[u][1] = f[3];
          }
          float x[4][4];
          pair_sum<NT, NQ>(x[0], ka, qb0);
          pair_sum<NT, NQ>(x[1], ka, qb1);
          pair_sum<NT, NT>(x[2], va, ob0);
          pair_sum<NT, NT>(x[3], va, ob1);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[0][i] = __fadd_rn(s[0][i], x[0][i]);
            s[1][i] = __fadd_rn(s[1][i], x[1][i]);
            dpt[0][i] = __fadd_rn(dpt[0][i], x[2][i]);
            dpt[1][i] = __fadd_rn(dpt[1][i], x[3][i]);
          }
        }
        // P^T and dS^T: element i of tile j is key kw0 + g (+ 8 for i >= 2),
        // row cr0 + 8 j + 2 q4 + (i & 1)
        float p[2][4], ds[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = kw0 + g + 8 * (i >> 1), t = kTile * c + 8 * j + 2 * q4 + (i & 1);
            const int r = rr0 + t;
            const bool live = key < n_valid && r < n_rows && (!causal || key <= r / group);
            p[j][i] = live ? expf(__fsub_rn(s[j][i], ls[t])) : 0.f;
            ds[j][i] = __fmul_rn(p[j][i], __fsub_rn(dpt[j][i], ds_[t]));
          }
        // as A fragments (16 keys x 16 rows), three bf16 terms each
        uint32_t pa[kPTerms][4], sa[kPTerms][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = r >> 1, i = 2 * (r & 1);
          uint32_t tp[kPTerms], ts[kPTerms];
          split_pack<kPTerms>(p[j][i], p[j][i + 1], tp);
          split_pack<kPTerms>(ds[j][i], ds[j][i + 1], ts);
#pragma unroll
          for (int u = 0; u < kPTerms; ++u) {
            pa[u][r] = tp[u];
            sa[u][r] = ts[u];
          }
        }
        // dV += P^T do and dK += dS^T q, two n8 tiles of dims at a time
#pragma unroll
        for (int nt = 0; nt < HD / 8; nt += 2) {
          uint32_t f[4], ob0[NT][2], ob1[NT][2], qb0[NT][2], qb1[NT][2];
#pragma unroll
          for (int u = 0; u < NT; ++u) {
            load_b_cols<P>(f, dp + u * kRowPlane + kTile * c * P, 8 * nt);
            ob0[u][0] = f[0];
            ob0[u][1] = f[1];
            ob1[u][0] = f[2];
            ob1[u][1] = f[3];
            load_b_cols<P>(f, qp + u * kRowPlane + kTile * c * P, 8 * nt);
            qb0[u][0] = f[0];
            qb0[u][1] = f[1];
            qb1[u][0] = f[2];
            qb1[u][1] = f[3];
          }
          float x[4][4];
          pair_sum<kPTerms, NT>(x[0], pa, ob0);
          pair_sum<kPTerms, NT>(x[1], pa, ob1);
          pair_sum<kPTerms, NT>(x[2], sa, qb0);
          pair_sum<kPTerms, NT>(x[3], sa, qb1);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[nt][i] = __fadd_rn(acc_v[nt][i], x[0][i]);
            acc_v[nt + 1][i] = __fadd_rn(acc_v[nt + 1][i], x[1][i]);
            acc_k[nt][i] = __fadd_rn(acc_k[nt][i], x[2][i]);
            acc_k[nt + 1][i] = __fadd_rn(acc_k[nt + 1][i], x[3][i]);
          }
        }
      }
    }
    __syncthreads();                                           // round rd fully used
  }

  // dk = scale * acc_k, dv = acc_v; lane holds keys kw0 + g and + 8, dims
  // 8 nt + 2 q4 and the next
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw0 + g + 8 * h;
    if (key >= Sk) continue;
    const long long at = (static_cast<long long>(b) * Sk + key) * kv_row + static_cast<long long>(hk) * hd;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * nt + 2 * q4 + e;
        if (d < hd) {
          dk[at + d] = __fmul_rn(scale, acc_k[nt][2 * h + e]);
          dv[at + d] = acc_v[nt][2 * h + e];
        }
      }
  }
}

template <typename T, int HD, int NQ>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int H, int KV, int hd, int kv_valid, int causal,
                       float scale, cudaStream_t st) {
  static int max_smem = 0;
  const cudaError_t err = opt_in(flash_fwd_kernel<T, HD, NQ>, max_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq * (H / KV) + kFwdRows - 1) / kFwdRows, KV, B);
  flash_fwd_kernel<T, HD, NQ><<<grid, kMmaThreads, fwd_smem<T, HD>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Sk, H, KV, hd, kv_valid, causal, scale);
  return cudaGetLastError();
}

// The tensor-core kernels' variants: the head dim padded to 64, 80 or 128;
// q * scale in one bf16 term when q is bf16 and scale a power of two (the
// product is exact and bf16; 1 / sqrt(hd) is one only for hd 1, 4, 16 and
// 64, all padded to 64), else three.
bool pow2_scale(float scale) {
  int e = 0;
  return frexpf(scale, &e) == 0.5f;
}

template <typename T>
cudaError_t fwd_by_hd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int Sq, int Sk, int H, int KV, int hd, int kv_valid, int causal,
                      float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if (pow2_scale(scale) && hd <= 64)
      return launch_fwd<T, 64, 1>(q, k, v, o, lse, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  if (hd <= 64)
    return launch_fwd<T, 64, 3>(q, k, v, o, lse, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  if (hd <= 80)
    return launch_fwd<T, 80, 3>(q, k, v, o, lse, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  return launch_fwd<T, 128, 3>(q, k, v, o, lse, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
}

template <typename T, int HD, int NQ>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* di, float* dq, int B, int Sq, int Sk,
                          int H, int KV, int hd, int kv_valid, int causal, float scale,
                          cudaStream_t st) {
  static int max_smem = 0;
  const cudaError_t err = opt_in(flash_bwd_dq_kernel<T, HD, NQ>, max_smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Sq * (H / KV) + kTile - 1) / kTile;
  const int blocks = (tiles + kMmaWarps - 1) / kMmaWarps;
  const int warps = (tiles + blocks - 1) / blocks;             // tiles spread evenly
  const dim3 grid(blocks, KV, B);
  flash_bwd_dq_kernel<T, HD, NQ><<<grid, warps * 32, fwd_smem<T, HD>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, dq, Sq, Sk, H, KV, hd, kv_valid, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dq_by_hd(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* di, float* dq, int B, int Sq, int Sk,
                         int H, int KV, int hd, int kv_valid, int causal, float scale,
                         cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if (pow2_scale(scale) && hd <= 64)
      return launch_bwd_dq<T, 64, 1>(q, k, v, dout, lse, di, dq, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  if (hd <= 64)
    return launch_bwd_dq<T, 64, 3>(q, k, v, dout, lse, di, dq, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  if (hd <= 80)
    return launch_bwd_dq<T, 80, 3>(q, k, v, dout, lse, di, dq, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  return launch_bwd_dq<T, 128, 3>(q, k, v, dout, lse, di, dq, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
}

template <typename TQ, typename TC, int HD, int NQ>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const int* kv_len,
                          void* o, float* work, int* tickets, int B, int S, int H, int KV,
                          int hd, int parts, int part_keys, float scale, cudaStream_t st) {
  static int max_smem = 0;
  const cudaError_t err = opt_in(decode_fwd_kernel<TQ, TC, HD, NQ>, max_smem);
  if (err != cudaSuccess) return err;
  const int group = H / KV;
  const size_t smem = decode_smem<TC, HD>() > decode_merge_smem(parts)
                          ? decode_smem<TC, HD>() : decode_merge_smem(parts);
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  const dim3 grid(KV, B, (parts + kDecWarps - 1) / kDecWarps * ((group + kTile - 1) / kTile));
  decode_fwd_kernel<TQ, TC, HD, NQ><<<grid, kDecWarps * 32, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v), kv_len,
      static_cast<TQ*>(o), work, tickets, S, H, KV, hd, parts, part_keys, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TC>
cudaError_t decode_by_hd(const void* q, const void* k, const void* v, const int* kv_len,
                         void* o, float* work, int* tickets, int B, int S, int H, int KV, int hd,
                         int parts, int part_keys, float scale, cudaStream_t st) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value)
    if (pow2_scale(scale) && hd <= 64)
      return launch_decode<TQ, TC, 64, 1>(q, k, v, kv_len, o, work, tickets, B, S, H, KV, hd, parts, part_keys, scale, st);
  if (hd <= 64)
    return launch_decode<TQ, TC, 64, 3>(q, k, v, kv_len, o, work, tickets, B, S, H, KV, hd, parts, part_keys, scale, st);
  if (hd <= 80)
    return launch_decode<TQ, TC, 80, 3>(q, k, v, kv_len, o, work, tickets, B, S, H, KV, hd, parts, part_keys, scale, st);
  return launch_decode<TQ, TC, 128, 3>(q, k, v, kv_len, o, work, tickets, B, S, H, KV, hd, parts, part_keys, scale, st);
}

template <typename T, int HD, int NQ>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* di, float* dk, float* dv, int B,
                           int Sq, int Sk, int H, int KV, int hd, int kv_valid, int causal,
                           float scale, cudaStream_t st) {
  static int max_smem = 0;
  const cudaError_t err = opt_in(flash_bwd_dkv_kernel<T, HD, NQ>, max_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + kBwdKeys - 1) / kBwdKeys, KV, B);
  flash_bwd_dkv_kernel<T, HD, NQ><<<grid, kMmaThreads, dkv_smem<T, HD, NQ>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, dk, dv, Sq, Sk, H, KV, hd, kv_valid, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dkv_by_hd(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* di, float* dk, float* dv, int B,
                          int Sq, int Sk, int H, int KV, int hd, int kv_valid, int causal,
                          float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if (pow2_scale(scale) && hd <= 64)
      return launch_bwd_dkv<T, 64, 1>(q, k, v, dout, lse, di, dk, dv, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  if (hd <= 64)
    return launch_bwd_dkv<T, 64, 3>(q, k, v, dout, lse, di, dk, dv, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  if (hd <= 80)
    return launch_bwd_dkv<T, 80, 3>(q, k, v, dout, lse, di, dk, dv, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  return launch_bwd_dkv<T, 128, 3>(q, k, v, dout, lse, di, dk, dv, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
}

// ---------------------------------------------------------------------------
// The accumulator probe's mma.sync step (chip_smoke.py phase 28): one warp
// runs `steps` m16n8k16 bf16 steps chained on one fragment from zero, as
// the tile step's operands would meet them: a (16, 16 steps) row-major, b
// (8, 16 steps) with column n's k values contiguous, d (16, 8) f32.
// ---------------------------------------------------------------------------
__global__ void mma_probe_kernel(const __nv_bfloat16* __restrict__ a,
                                 const __nv_bfloat16* __restrict__ b, float* __restrict__ d,
                                 int steps) {
  const int lane = threadIdx.x, g = lane >> 2, q4 = lane & 3, K = 16 * steps;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < steps; ++s) {
    const __nv_bfloat16* as = a + 16 * s;
    const __nv_bfloat16* bs = b + 16 * s;
    uint32_t ar[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = g + 8 * (r & 1), col = 2 * q4 + 8 * (r >> 1);
      ar[r] = pack2(as[row * K + col], as[row * K + col + 1]);
    }
    const uint32_t b0 = pack2(bs[g * K + 2 * q4], bs[g * K + 2 * q4 + 1]);
    const uint32_t b1 = pack2(bs[g * K + 2 * q4 + 8], bs[g * K + 2 * q4 + 9]);
    mma_bf16(acc, ar, b0, b1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) d[(g + 8 * (i >> 1)) * 8 + 2 * q4 + (i & 1)] = acc[i];
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k/v (B, Sk, KV, hd), all of one dtype: `dtype` 0 f32,
// 1 bf16, 2 f16 (DtypeCode; another value is refused with
// cudaErrorInvalidValue); o like q, lse (B, H, Sq) f32. 1 <= hd <= 128,
// H % KV == 0, 1 <= kv_valid <= Sk (checked by the wrapper).
int fa_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                 int B, int Sq, int Sk, int H, int KV, int hd, int kv_valid, int causal,
                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kF32 && dtype != kBF16 && dtype != kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      dtype == kBF16 ? fwd_by_hd<__nv_bfloat16>(q, k, v, o, l, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st)
      : dtype == kF16 ? fwd_by_hd<__half>(q, k, v, o, l, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st)
                      : fwd_by_hd<float>(q, k, v, o, l, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  return static_cast<int>(err);
}

// q, o (B, 1, H, hd) bf16 (q_bf16 != 0) or f32; the cache k, v
// (B, S, KV, hd) bf16 (c_bf16 != 0) or f32; kv_len (B,) int32; work f32,
// at least B * KV * parts * (H / KV) * (hd + 2) elements; tickets int32,
// B * KV * ceil(H / KV / 16) elements (one a row tile), all 0 before the
// first launch (each launch leaves them
// 0: one buffer serves launches in stream order, not two at once). Keys
// split into `parts` <= 64 parts of `part_keys` (a multiple of 16, parts *
// part_keys >= S) and a query group H / KV past 128 are refused with
// cudaErrorInvalidValue. 1 <= hd <= 128 (checked by the wrapper).
int fa_decode_fwd(const void* q, const void* k, const void* v, const void* kv_len, void* o,
                  void* work, void* tickets, int q_bf16, int c_bf16, int B, int S, int H, int KV,
                  int hd, int parts, int part_keys, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (parts < 1 || parts > kMaxParts || part_keys % kChunk != 0 ||
      static_cast<long long>(parts) * part_keys < S || KV < 1 || H % KV != 0 ||
      H / KV > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const int* lens = static_cast<const int*>(kv_len);
  float* w = static_cast<float*>(work);
  int* t = static_cast<int*>(tickets);
  cudaError_t err;
  if (q_bf16 && c_bf16)
    err = decode_by_hd<__nv_bfloat16, __nv_bfloat16>(q, k, v, lens, o, w, t, B, S, H, KV, hd, parts, part_keys, scale, st);
  else if (q_bf16)
    err = decode_by_hd<__nv_bfloat16, float>(q, k, v, lens, o, w, t, B, S, H, KV, hd, parts, part_keys, scale, st);
  else if (c_bf16)
    err = decode_by_hd<float, __nv_bfloat16>(q, k, v, lens, o, w, t, B, S, H, KV, hd, parts, part_keys, scale, st);
  else
    err = decode_by_hd<float, float>(q, k, v, lens, o, w, t, B, S, H, KV, hd, parts, part_keys, scale, st);
  return static_cast<int>(err);
}

// q, do (B, Sq, H, hd), k/v (B, Sk, KV, hd), all of one dtype (`dtype` as
// in fa_flash_fwd); lse, di (B, H, Sq) f32; dq (B, Sq, H, hd) f32. Same
// limits as fa_flash_fwd (checked by the wrapper).
int fa_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* di, void* dq, int dtype, int B, int Sq, int Sk,
                    int H, int KV, int hd, int kv_valid, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kF32 && dtype != kBF16 && dtype != kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  float* out = static_cast<float*>(dq);
  const cudaError_t err =
      dtype == kBF16 ? bwd_dq_by_hd<__nv_bfloat16>(q, k, v, dout, l, d, out, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st)
      : dtype == kF16 ? bwd_dq_by_hd<__half>(q, k, v, dout, l, d, out, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st)
                      : bwd_dq_by_hd<float>(q, k, v, dout, l, d, out, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  return static_cast<int>(err);
}

// As fa_flash_bwd_dq; dk, dv (B, Sk, KV, hd) f32, every element written.
int fa_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* di, void* dk, void* dv, int dtype, int B, int Sq,
                     int Sk, int H, int KV, int hd, int kv_valid, int causal, float scale,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kF32 && dtype != kBF16 && dtype != kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sk == 0) return static_cast<int>(cudaGetLastError());
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  float* ok = static_cast<float*>(dk);
  float* ov = static_cast<float*>(dv);
  const cudaError_t err =
      dtype == kBF16 ? bwd_dkv_by_hd<__nv_bfloat16>(q, k, v, dout, l, d, ok, ov, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st)
      : dtype == kF16 ? bwd_dkv_by_hd<__half>(q, k, v, dout, l, d, ok, ov, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st)
                      : bwd_dkv_by_hd<float>(q, k, v, dout, l, d, ok, ov, B, Sq, Sk, H, KV, hd, kv_valid, causal, scale, st);
  return static_cast<int>(err);
}

// a (16, 16 steps), b (8, 16 steps) bf16, d (16, 8) f32; 1 <= steps <= 4
int fa_mma_probe(const void* a, const void* b, void* d, int steps, void* stream) {
  mma_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(d), steps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
