// The tensor-wise quantizers' one skeleton, shared by the int8
// tensor_quantize (kernels/switchback/csrc/switchback.cu) and the fp8 one
// (kernels/fp8_matmul/csrc/fp8_matmul.cu), templated on the per-value
// encoder: x (n,) -> one absmax over the whole tensor, then each value's
// byte from it.
//
// Bound by bytes: x read once in its type, one byte a value written, the
// state. The TPU kernels carry the max across a sequential grid; GPU
// blocks run in parallel and in no order, so the max needs every block
// before any can cast. Where the tensor fits the registers of the blocks
// that can be resident at once (the usual case: every weight of the serve
// and train paths in bf16), one launch does all of it:
//   * the grid: the resident blocks (the occupancy calculator times the
//     SMs), fewer where the tensor gives each thread less than one chunk of
//     8 values. Block b owns the chunks [b C / B, (b + 1) C / B) of the
//     flat tensor (C chunks, B blocks: spans that differ by at most one),
//     thread t chunks t, t + 256, ... of the span (at most kMaxChunks<T>:
//     64 registers of values a thread), so neighbouring threads read
//     neighbouring bytes;
//   * loading: every load of the span issued before any is read, in
//     granules of G values (16, 8, 4 or 2 bytes of x a load, as x's and q's
//     alignment allow; the launcher picks G). A chunk lies wholly inside x
//     but for the last one when n % 8 != 0, which loads its values one by
//     one (the ragged tail): only whole granules are read;
//   * the reduction: the block's max by warp shuffles and shared memory,
//     published to partial[b]; one grid-wide barrier (grid_barrier); then
//     each block reduces all B partials itself (from L2), so no atomics
//     touch values and the result does not depend on block order; absmax
//     = max(m, 1e-12); block 0 writes the state;
//   * the bytes: encoded from the registers (the codec's per-value
//     arithmetic, the plain version's operation for operation) and stored
//     in granules of G.
// The launch is cooperative (cudaLaunchAttributeCooperative through
// cudaLaunchKernelEx; it captures into a CUDA graph and replays): the card
// either runs every block at once or refuses the launch, which the
// wrapper raises; it never hangs. The barrier itself counts arrivals in a
// two-word workspace the wrapper keeps zeroed ([0] arrivals, [1] an
// epoch): the last block's arrival wraps the count to 0 and that block
// bumps the epoch, which the others wait on, so every launch leaves the
// count 0 for the next one (CUDA-graph replays included). One launch at a
// time may use a workspace: the wrappers keep one per stream.
// A tensor past the registers (n > B x 256 x kMaxChunks<T> x 8: about 8.7
// M bf16 values at two blocks an SM, half that in f32) takes two launches,
// chosen by size in the launcher: kMax, each block's max over its span in
// rounds of the same loads, then kCast, each block reduces the partials
// and re-reads its span (mostly from L2) to cast it.
//
// kernels/build.py hashes this header into the name of every library
// whose source includes it, so an edit here rebuilds both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {
namespace tq {

constexpr int kThreads = 256;
constexpr int kChunk = 8;            // values of a chunk: 16 bytes of bf16
constexpr int kMaxPartials = 1024;   // the wrapper's partial buffer: the most blocks
constexpr float kEps = 1e-12f;
enum { kOne = 0, kMax = 1, kCast = 2 };

// chunks a thread holds: 64 registers of values in either type
template <typename T>
__host__ __device__ constexpr int max_chunks() {
  return sizeof(T) == 2 ? 16 : 8;
}

struct Plan {
  int64_t n;        // values
  int64_t chunks;   // ceil(n / kChunk)
  int blocks;
  int rounds;       // 0: the one launch; else each pass's rounds of a block's span
  int G;            // values a granule: 8, 4, 2 or 1
  int drop;         // a test's control fault: the partial left out of the reduction, or -1
};

template <typename T>
struct Vals;

template <>
struct Vals<__nv_bfloat16> {     // 8 bf16 values as 4 words, widened on use
  uint32_t w[4];
  __device__ __forceinline__ void zero() { w[0] = w[1] = w[2] = w[3] = 0u; }
  template <int G>
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {   // all 8, G at a time
    if (G == 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else if (G == 4) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
      const uint2 b = __ldg(reinterpret_cast<const uint2*>(p + 4));
      w[0] = a.x, w[1] = a.y, w[2] = b.x, w[3] = b.y;
    } else if (G == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = __ldg(reinterpret_cast<const uint32_t*>(p) + i);
    } else {
      load_tail(p, kChunk);
    }
  }
  __device__ __forceinline__ void load_tail(const __nv_bfloat16* p, int m) {   // the first m
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (e < m) w[e >> 1] |= static_cast<uint32_t>(__ldg(h + e)) << (16 * (e & 1));
  }
  __device__ __forceinline__ float operator[](int e) const {   // a bf16 is the top half of its f32
    return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
  }
};

template <>
struct Vals<float> {
  float v[kChunk];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) v[e] = 0.f;
  }
  template <int G>
  __device__ __forceinline__ void load(const float* p) {
    if (G >= 4) {                                // 16-byte granules (G = 8: 8-byte stores)
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
      v[7] = b.w;
    } else if (G == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __ldg(reinterpret_cast<const float2*>(p) + i);
        v[2 * i] = a.x, v[2 * i + 1] = a.y;
      }
    } else {
      load_tail(p, kChunk);
    }
  }
  __device__ __forceinline__ void load_tail(const float* p, int m) {
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (e < m) v[e] = __ldg(p + e);
  }
  __device__ __forceinline__ float operator[](int e) const { return v[e]; }
};

// 8 codes (lo: the first four, little-endian) at p: G bytes a store, or
// the first m one by one (the ragged tail)
template <int G>
__device__ __forceinline__ void store8(uint8_t* p, uint32_t lo, uint32_t hi) {
  if (G == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  } else if (G == 4) {
    reinterpret_cast<uint32_t*>(p)[0] = lo;
    reinterpret_cast<uint32_t*>(p)[1] = hi;
  } else if (G == 2) {
    uint16_t* h = reinterpret_cast<uint16_t*>(p);
    h[0] = static_cast<uint16_t>(lo), h[1] = static_cast<uint16_t>(lo >> 16);
    h[2] = static_cast<uint16_t>(hi), h[3] = static_cast<uint16_t>(hi >> 16);
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      p[e] = static_cast<uint8_t>((e < 4 ? lo : hi) >> (8 * (e & 3)));
  }
}

__device__ __forceinline__ void store_tail(uint8_t* p, uint32_t lo, uint32_t hi, int m) {
#pragma unroll
  for (int e = 0; e < kChunk; ++e)
    if (e < m) p[e] = static_cast<uint8_t>((e < 4 ? lo : hi) >> (8 * (e & 3)));
}

// What a thread works on: x and q, its first chunk (its block's span's
// first plus t), the span's end, the tail chunk (n / 8: past every span
// when n % 8 == 0) and its values, the rounds of the two-pass form.
template <typename T>
struct Work {
  const T* x;
  uint8_t* q;
  int64_t first, hi, tail;
  int rem, rounds;
};

// chunks first + 256 j (j < kMaxChunks) inside the span into v, the rest 0:
// every load issued before any is read
template <int G, typename T, int K>
__device__ __forceinline__ void load_round(Vals<T> (&v)[K], const Work<T>& w, int64_t first) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t c = first + static_cast<int64_t>(kThreads) * j;
    v[j].zero();
    if (c < w.hi) {
      if (c == w.tail)
        v[j].load_tail(w.x + kChunk * c, w.rem);
      else
        v[j].template load<G>(w.x + kChunk * c);
    }
  }
}

// the codes of the chunks load_round read: E::four(a, b, c, d) gives four
// values' bytes, the first in the low byte
template <int G, class E, typename T, int K>
__device__ __forceinline__ void store_round(const E& e, const Vals<T> (&v)[K], const Work<T>& w,
                                            int64_t first) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t c = first + static_cast<int64_t>(kThreads) * j;
    if (c >= w.hi) break;
    const uint32_t lo = e.four(v[j][0], v[j][1], v[j][2], v[j][3]);
    const uint32_t hi = e.four(v[j][4], v[j][5], v[j][6], v[j][7]);
    if (c == w.tail)
      store_tail(w.q + kChunk * c, lo, hi, w.rem);
    else
      store8<G>(w.q + kChunk * c, lo, hi);
  }
}

// the cast with one encoder: from the registers (kOne), or each round
// loaded again (kCast). A codec's cast<MODE, G>(absmax, v, w) builds its
// encoder and calls this.
template <int MODE, int G, class E, typename T, int K>
__device__ __forceinline__ void cast_work(const E& e, Vals<T> (&v)[K], const Work<T>& w) {
  if constexpr (MODE == kOne) {
    store_round<G>(e, v, w, w.first);
  } else {
    for (int r = 0; r < w.rounds; ++r) {
      const int64_t first = w.first + static_cast<int64_t>(r) * kThreads * K;
      load_round<G>(v, w, first);
      store_round<G>(e, v, w, first);
    }
  }
}

// |x| >= 0, so 0 is the identity of every max below.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max over the block; `red` is 32 floats of shared memory. All threads get it.
__device__ __forceinline__ float block_max(float v, float* red) {
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

// Every block of the grid arrives here once, after its thread 0 wrote its
// partial; none leaves before all have arrived. bar[0] counts arrivals,
// bar[1] is the epoch: read before arriving; the arrival is one atom.inc
// wrapping at the grid's size, so the last block's own arrival puts the
// count back to 0 for the next launch, and that block then bumps the epoch,
// which the others wait on. Acquire and release order the partials: each
// arrival releases its block's partial, the last arrival acquires them all
// and releases them again with the bump, each waiter's acquire of the new
// epoch sees them. (The fenced form, a full fence before the arrival and
// after the wait and a separate reset, read about 0.2 µs more a call on an
// H100; PERF.md.) A wait
// that outlasts every launch by far (about 2^24 polls: seconds; a workspace
// that was not zero) traps, so the launch fails instead of hanging the card.
constexpr unsigned kMaxPolls = 1u << 24;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  if (threadIdx.x == 0) {
    const unsigned epoch = ld_acquire(&bar[1]);
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(bar), "r"(gridDim.x - 1) : "memory");
    if (old == gridDim.x - 1) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" :: "l"(bar + 1) : "memory");
    } else {
      for (unsigned polls = 0; ld_acquire(&bar[1]) == epoch; ++polls) {
        if (polls == kMaxPolls) __trap();
        __nanosleep(32);
      }
    }
  }
  __syncthreads();
}

// the absmax from every block's partial but drop's (the control fault),
// floored at kEps
__device__ __forceinline__ float reduce_partials(const float* partial, int blocks, int drop,
                                                 float* red) {
  float m = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kThreads)
    if (i != drop) m = fmaxf(m, __ldcg(partial + i));
  return fmaxf(block_max(m, red), kEps);
}

// The kernel body: MODE kOne (the one launch), kMax or kCast (the two
// passes). Codec::cast<MODE, G>(absmax, v, w) encodes and stores. The
// batched form (E tensors of n values one after another, a state and
// p.blocks partials each) runs the two passes on a grid E deep: block (b,
// e) is block b of tensor e (e = 0 in the one-tensor forms).
template <typename T, int G, int MODE, class Codec>
__device__ __forceinline__ void quantize(const T* __restrict__ x, uint8_t* __restrict__ q,
                                         float* __restrict__ s, float* __restrict__ partial,
                                         unsigned* __restrict__ bar, const Plan& p) {
  constexpr int K = max_chunks<T>();
  __shared__ float red[32];
  const int64_t b = blockIdx.x, e = blockIdx.y;
  x += e * p.n, q += e * p.n, s += e, partial += e * p.blocks;
  Work<T> w;
  w.x = x, w.q = q;
  w.first = b * p.chunks / p.blocks + threadIdx.x;
  w.hi = (b + 1) * p.chunks / p.blocks;
  w.tail = p.n / kChunk;
  w.rem = static_cast<int>(p.n % kChunk);
  w.rounds = p.rounds;
  Vals<T> v[K];
  if constexpr (MODE != kCast) {
    float m = 0.f;                                          // chunks not loaded hold 0
    const int rounds = MODE == kOne ? 1 : p.rounds;
    for (int r = 0; r < rounds; ++r) {
      load_round<G>(v, w, w.first + static_cast<int64_t>(r) * kThreads * K);
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int e = 0; e < kChunk; ++e) m = fmaxf(m, fabsf(v[j][e]));
    }
    m = block_max(m, red);
    if (threadIdx.x == 0) partial[blockIdx.x] = m;
    if constexpr (MODE == kMax) return;
    grid_barrier(bar);
  }
  const float absmax = reduce_partials(partial, p.blocks, p.drop, red);
  if (blockIdx.x == 0 && threadIdx.x == 0) s[0] = absmax;
  Codec::template cast<MODE, G>(absmax, v, w);
}

// ---------------------------------------------------------------------------
// The K-major form (the fp8 forward's W): x (R, C) row-major -> q (R, C)
// and its transpose qk (C, R), both written from the registers, so the
// GEMMs' K-major copy of W needs no launch of its own and the codes are
// never read back. The flat split above gives a block under five rows of a
// CLIP weight, runs of about 5 bytes in each row of qk; here block b owns
// tile b of a grid of h x w tiles (h a multiple of kTileRows, w of
// kTileCols; the launcher's choice, make_tile_plan):
//   * loading: the tile's chunks of 8 values along its rows, cw = w / 8 a
//     row; thread t holds chunks t, t + 256, ... (every load issued before
//     any is read), its (row, chunk) stepped by divmod(256, cw) from
//     divmod(t, cw); a chunk past the tile's last column (x's right edge)
//     is not loaded, one across it (C % 8 != 0) loads its values one by one;
//   * the max and the barrier as above (a max ignores order, so the state
//     and every code are the flat form's bits);
//   * the bytes: each chunk's 8 codes stored row-major into q (granules of
//     G) and staged in shared memory, the tile's rows at a pitch of an odd
//     number of words (w / 4 + 1); then each thread moves 4 x 4-byte
//     blocks (4 rows x 4 columns, __byte_perm) into qk: lane l of a warp
//     takes row block 8 a + (l & 7) and column block 4 b + (l >> 3) of its
//     warp's cell (32 rows x 16 columns), so its four reads of a staged
//     word meet 32 different banks (the odd pitch), and each of its four
//     4-byte stores puts 8 lanes on one 32-byte run of a row of qk (bytes
//     one by one where R % 4 or an edge forbids words). Chunk i of the
//     tile (row r) stages at words 2 i + r and 2 i + r + 1; of its two
//     stores the first takes the even one in the warp's first 16 lanes and
//     the odd one in its second, so a warp's 32 lanes meet 32 banks within
//     a row (at most 2 wavefronts where rows break inside the warp).
// Past the registers (the tile grid exceeds the resident blocks at the
// largest tile) the two passes walk a block's tiles b, b + B, ... in
// rounds: kMax their max, kCast loads each again and writes both copies.
// ---------------------------------------------------------------------------
constexpr int kTileRows = 32;      // h is a multiple: runs of qk of at least 32 bytes
constexpr int kTileCols = 16;      // w is a multiple: a warp cell's 4 column blocks
constexpr int kMaxTileRows = 1024;
// the staging buffer: h (w / 4 + 1) words at most, h w <= the registers
constexpr int kStageWords = kThreads * max_chunks<__nv_bfloat16>() * kChunk / 4 + kMaxTileRows;

struct TilePlan {
  int R, C;          // x (R, C), row-major
  int h, w;          // the tile
  int nc;            // tiles a row of the tile grid
  int tiles;         // tiles in all (row-major over the grid)
  int blocks;
  int rounds;        // 0: the one launch, one tile a block; else each pass's tiles a block
  int G;             // values a granule: 8, 4, 2 or 1 (x, q and C allow it)
  int cw, dr, dc;    // chunks a tile row; divmod(kThreads, cw)
  int pitch;         // words a staged row: w / 4 + 1, odd
  int kwords;        // 1: 4-byte stores into qk (R % 4 == 0, qk aligned)
  int drop;          // a check's control fault: the partial left out, or -1
  int skip;          // a check's control fault: the block that writes no qk, or -1
};

struct TileAt {      // a tile's first row and column, its rows and columns inside x
  int64_t r0, c0;
  int rows, cols;
};

__device__ __forceinline__ TileAt tile_at(const TilePlan& p, int tile) {
  const int tr = tile / p.nc, tc = tile - tr * p.nc;
  TileAt a;
  a.r0 = static_cast<int64_t>(tr) * p.h;
  a.c0 = static_cast<int64_t>(tc) * p.w;
  const int64_t rows = p.R - a.r0, cols = p.C - a.c0;
  a.rows = rows < p.h ? static_cast<int>(rows) : p.h;
  a.cols = cols < p.w ? static_cast<int>(cols) : p.w;
  return a;
}

// the tile's chunks of this thread into v, those outside x 0
template <int G, typename T, int K>
__device__ __forceinline__ void load_tile(Vals<T> (&v)[K], const T* x, const TilePlan& p,
                                          const TileAt& a) {
  int r = threadIdx.x / p.cw, c = threadIdx.x - r * p.cw;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    v[j].zero();
    const int col = kChunk * c;
    if (r < a.rows && col < a.cols) {
      const T* src = x + (a.r0 + r) * p.C + a.c0 + col;
      if (a.cols - col >= kChunk)
        v[j].template load<G>(src);
      else
        v[j].load_tail(src, a.cols - col);
    }
    r += p.dr, c += p.dc;
    if (c >= p.cw) c -= p.cw, ++r;
  }
}

// four staged words (rows k, columns 0-3 each, the first in the low byte)
// as four words of columns (column e's rows 0-3)
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410), out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410), out[3] = __byte_perm(t1, t3, 0x7632);
}

// the codes of the chunks load_tile read: row-major into q and staged, then
// the tile's K-major copy into qk (not by block p.skip, the control fault)
template <int G, class E, typename T, int K>
__device__ __forceinline__ void store_tile(const E& e, const Vals<T> (&v)[K], uint8_t* q,
                                           uint8_t* qk, uint32_t* stage, const TilePlan& p,
                                           const TileAt& a) {
  const int half = (threadIdx.x >> 4) & 1;
  int r = threadIdx.x / p.cw, c = threadIdx.x - r * p.cw;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int col = kChunk * c;
    if (r < a.rows && col < a.cols) {
      const uint32_t lo = e.four(v[j][0], v[j][1], v[j][2], v[j][3]);
      const uint32_t hi = e.four(v[j][4], v[j][5], v[j][6], v[j][7]);
      uint8_t* dst = q + (a.r0 + r) * p.C + a.c0 + col;
      if (a.cols - col >= kChunk)
        store8<G>(dst, lo, hi);
      else
        store_tail(dst, lo, hi, a.cols - col);
      uint32_t* st = stage + r * p.pitch + 2 * c;              // word 2 (r cw + c) + r
      const int odd = (r ^ half) & 1;                          // the first store's word:
      st[odd] = odd ? hi : lo;                                 // even in the warp's first
      st[odd ^ 1] = odd ? lo : hi;                             // half, odd in its second
    }
    r += p.dr, c += p.dc;
    if (c >= p.cw) c -= p.cw, ++r;
  }
  __syncthreads();
  if (static_cast<int>(blockIdx.x) != p.skip) {
    const int lane = threadIdx.x & 31;
    const int cells_r = p.h / 32, cells = cells_r * (p.w / 16);
    int ca = threadIdx.x >> 5, cb = 0;                       // this warp's first cell
    while (ca >= cells_r) ca -= cells_r, ++cb;
    for (int cell = threadIdx.x >> 5; cell < cells; cell += kThreads / 32) {
      const int row = 4 * (8 * ca + (lane & 7)), blk = 4 * cb + (lane >> 3), col = 4 * blk;
      if (row < a.rows && col < a.cols) {
        uint32_t w[4], out[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = stage[(row + k) * p.pitch + blk];
        transpose4(w, out);
        const bool words = p.kwords && row + 4 <= a.rows;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (col + i >= a.cols) break;
          uint8_t* d = qk + (a.c0 + col + i) * p.R + a.r0 + row;
          if (words) {
            *reinterpret_cast<uint32_t*>(d) = out[i];
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (row + k < a.rows) d[k] = static_cast<uint8_t>(out[i] >> (8 * k));
          }
        }
      }
      ca += kThreads / 32;
      while (ca >= cells_r) ca -= cells_r, ++cb;
    }
  }
  __syncthreads();                                           // the stage is free again
}

// a block's tiles b, b + B, ... (walk of them) cast with one encoder: from
// the registers (kOne), or each loaded again (kCast)
template <int MODE, int G, class E, typename T, int K>
__device__ __forceinline__ void cast_tiles(const E& e, Vals<T> (&v)[K], const T* x, uint8_t* q,
                                           uint8_t* qk, uint32_t* stage, const TilePlan& p,
                                           int walk) {
  for (int i = 0; i < walk; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    if (tile >= p.tiles) break;
    const TileAt a = tile_at(p, tile);
    if constexpr (MODE == kCast) load_tile<G>(v, x, p, a);
    store_tile<G>(e, v, q, qk, stage, p, a);
  }
}

// The K-major kernel body: MODE kOne (the one launch), kMax or kCast (the
// two passes). The codec gives the encoder: Codec::fast<T>(absmax) picks
// Codec::encoder<true or false>(absmax).
template <typename T, int G, int MODE, class Codec>
__device__ __forceinline__ void quantize_kt(const T* __restrict__ x, uint8_t* __restrict__ q,
                                            uint8_t* __restrict__ qk, float* __restrict__ s,
                                            float* __restrict__ partial,
                                            unsigned* __restrict__ bar, const TilePlan& p) {
  constexpr int K = max_chunks<T>();
  __shared__ float red[32];
  __shared__ uint32_t stage[kStageWords];
  const int walk = MODE == kOne ? 1 : p.rounds;             // tiles b, b + B, ...
  Vals<T> v[K];
  if constexpr (MODE != kCast) {
    float m = 0.f;                                          // chunks not loaded hold 0
    for (int i = 0; i < walk; ++i) {
      const int tile = blockIdx.x + i * gridDim.x;
      if (tile >= p.tiles) break;
      load_tile<G>(v, x, p, tile_at(p, tile));
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int e = 0; e < kChunk; ++e) m = fmaxf(m, fabsf(v[j][e]));
    }
    m = block_max(m, red);
    if (threadIdx.x == 0) partial[blockIdx.x] = m;
    if constexpr (MODE == kMax) return;
    grid_barrier(bar);
  }
  const float absmax = reduce_partials(partial, p.blocks, p.drop, red);
  if (blockIdx.x == 0 && threadIdx.x == 0) s[0] = absmax;
  if (Codec::template fast<T>(absmax))
    cast_tiles<MODE, G>(Codec::template encoder<true>(absmax), v, x, q, qk, stage, p, walk);
  else
    cast_tiles<MODE, G>(Codec::template encoder<false>(absmax), v, x, q, qk, stage, p, walk);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// values a granule: the largest G in {8, 4, 2} whose loads (G values of x,
// at most 16 bytes each) and stores (G bytes of q) are aligned, else 1
inline int granule(const void* x, const void* q, int tsize) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x), b = reinterpret_cast<uintptr_t>(q);
  for (int G = 8; G > 1; G >>= 1)
    if (a % std::min(G * tsize, 16) == 0 && b % G == 0) return G;
  return 1;
}

// the blocks an SM can hold of `kernel` times the SMs
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, 0) != cudaSuccess)
    return 0;
  return per * sms;
}

// One launch where the largest span fits a block's registers at the grid
// of min(resident, one block per 256 chunks) blocks; else the two passes
// over min(resident, kMaxPartials) blocks. `resident`: the one-launch
// kernel's resident blocks.
template <typename T>
Plan make_plan(int64_t n, int G, int resident, int drop) {
  Plan p;
  p.n = n, p.G = G, p.drop = drop;
  p.chunks = (n + kChunk - 1) / kChunk;
  const int64_t per_block = static_cast<int64_t>(kThreads) * max_chunks<T>();
  const int64_t cap = std::max(1, std::min(resident, kMaxPartials));
  const int64_t want = std::max<int64_t>(1, (p.chunks + kThreads - 1) / kThreads);
  p.blocks = static_cast<int>(std::min(want, cap));
  const int64_t span = (p.chunks + p.blocks - 1) / p.blocks;
  p.rounds = span <= per_block ? 0 : static_cast<int>((span + per_block - 1) / per_block);
  return p;
}

// a launch of `kernel` over `blocks` x `tensors` blocks on st, cooperative
// or not
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), int blocks, int tensors, bool cooperative,
                   cudaStream_t st, A&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, tensors, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cooperative ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<A&&>(args)...);
}

// The launcher of a family. Family::kernel<T, G, MODE>(fmt) is the
// family's kernel for format fmt (ignored where there is one). Its
// one-launch kernel's resident blocks are read once (every format's kernel
// launches the same grid).
template <typename T>
using Kernel = void (*)(const T*, uint8_t*, float*, float*, unsigned*, Plan);

template <typename T, int G, class Family>
int resident() {
  static const int r = resident_blocks(Family::template kernel<T, G, kOne>(0));
  return r;
}

template <typename T, int G, class Family>
int run_at(const T* x, uint8_t* q, float* s, float* partial, unsigned* bar, int64_t n, int fmt,
           int drop, cudaStream_t st) {
  const int r = resident<T, G, Family>();
  if (r <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Plan p = make_plan<T>(n, G, r, drop);
  cudaError_t err;
  if (p.rounds == 0) {
    err = launch(Family::template kernel<T, G, kOne>(fmt), p.blocks, 1, true, st, x, q, s, partial,
                 bar, p);
  } else {
    err = launch(Family::template kernel<T, G, kMax>(fmt), p.blocks, 1, false, st, x, q, s, partial,
                 bar, p);
    if (err == cudaSuccess)
      err = launch(Family::template kernel<T, G, kCast>(fmt), p.blocks, 1, false, st, x, q, s,
                   partial, bar, p);
  }
  const cudaError_t last = cudaGetLastError();               // cleared either way
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// x (n,) in T -> q (n,) bytes, s (1,): the granule, the plan, the launch
// (or the two); `drop`: the checks' control fault, else -1
template <typename T, class Family>
int run(const void* x, void* q, void* s, void* partial, void* bar, int64_t n, int fmt, int drop,
        cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  uint8_t* qp = static_cast<uint8_t*>(q);
  float* sp = static_cast<float*>(s);
  float* pp = static_cast<float*>(partial);
  unsigned* bp = static_cast<unsigned*>(bar);
  switch (granule(x, q, sizeof(T))) {
    case 8: return run_at<T, 8, Family>(xp, qp, sp, pp, bp, n, fmt, drop, st);
    case 4: return run_at<T, 4, Family>(xp, qp, sp, pp, bp, n, fmt, drop, st);
    case 2: return run_at<T, 2, Family>(xp, qp, sp, pp, bp, n, fmt, drop, st);
    default: return run_at<T, 1, Family>(xp, qp, sp, pp, bp, n, fmt, drop, st);
  }
}

// The batched form: E tensors of n values each (the experts' weights), one
// absmax and state each. Their blocks cannot all meet at one grid barrier
// (128 experts' weights are far past the registers), so it always takes the
// two passes, kMax then kCast, on a grid E deep (block (b, e): block b of
// tensor e), each tensor over ceil(resident / E) blocks (at most
// kBatchedPartials): the grid fills the card whatever E is.
constexpr int kBatchedPartials = 64;   // partials a tensor: the wrapper's E x 64 floats

template <typename T>
Plan make_batched_plan(int64_t n, int G, int resident, int E) {
  Plan p;
  p.n = n, p.G = G, p.drop = -1;
  p.chunks = (n + kChunk - 1) / kChunk;
  const int64_t per_block = static_cast<int64_t>(kThreads) * max_chunks<T>();
  const int64_t want = std::max<int64_t>(1, (p.chunks + kThreads - 1) / kThreads);
  const int64_t fill = std::max(1, (resident + E - 1) / E);
  p.blocks = static_cast<int>(std::min<int64_t>(want, std::min<int64_t>(fill, kBatchedPartials)));
  const int64_t span = (p.chunks + p.blocks - 1) / p.blocks;
  p.rounds = static_cast<int>(std::max<int64_t>(1, (span + per_block - 1) / per_block));
  return p;
}

template <typename T, int G, class Family>
int run_batched_at(const T* x, uint8_t* q, float* s, float* partial, int64_t n, int E, int fmt,
                   cudaStream_t st) {
  const int r = resident<T, G, Family>();
  if (r <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Plan p = make_batched_plan<T>(n, G, r, E);
  cudaError_t err = launch(Family::template kernel<T, G, kMax>(fmt), p.blocks, E, false, st, x,
                           q, s, partial, static_cast<unsigned*>(nullptr), p);
  if (err == cudaSuccess)
    err = launch(Family::template kernel<T, G, kCast>(fmt), p.blocks, E, false, st, x, q, s,
                 partial, static_cast<unsigned*>(nullptr), p);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// x (E, n) in T -> q (E, n) bytes, s (E,); partial: E x kBatchedPartials
// floats. The granule also divides n, so that every tensor starts on one.
template <typename T, class Family>
int run_batched(const void* x, void* q, void* s, void* partial, int64_t n, int E, int fmt,
                cudaStream_t st) {
  if (n <= 0 || E <= 0) return static_cast<int>(cudaGetLastError());
  const T* xp = static_cast<const T*>(x);
  uint8_t* qp = static_cast<uint8_t*>(q);
  float* sp = static_cast<float*>(s);
  float* pp = static_cast<float*>(partial);
  int G = granule(x, q, sizeof(T));
  while (G > 1 && n % G) G >>= 1;
  switch (G) {
    case 8: return run_batched_at<T, 8, Family>(xp, qp, sp, pp, n, E, fmt, st);
    case 4: return run_batched_at<T, 4, Family>(xp, qp, sp, pp, n, E, fmt, st);
    case 2: return run_batched_at<T, 2, Family>(xp, qp, sp, pp, n, E, fmt, st);
    default: return run_batched_at<T, 1, Family>(xp, qp, sp, pp, n, E, fmt, st);
  }
}

// the launcher's plan for x and q into out (5,): blocks, rounds (0: one
// launch), G, resident blocks, values a block holds in one round
template <typename T, class Family>
int plan(const void* x, const void* q, int64_t n, int* out) {
  const int G = granule(x, q, sizeof(T));
  const int r = G == 8   ? resident<T, 8, Family>()
                : G == 4 ? resident<T, 4, Family>()
                : G == 2 ? resident<T, 2, Family>()
                         : resident<T, 1, Family>();
  const Plan p = make_plan<T>(n, G, r, -1);
  out[0] = p.blocks, out[1] = p.rounds, out[2] = p.G, out[3] = r;
  out[4] = kThreads * max_chunks<T>() * kChunk;
  return r > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// ---------------------------------------------------------------------------
// host side of the K-major form
// ---------------------------------------------------------------------------

// values a granule of the K-major form: as granule(), and C % G == 0, so
// that every row of x and q starts on a granule
inline int granule_kt(const void* x, const void* q, int64_t C, int tsize) {
  int G = granule(x, q, tsize);
  while (G > 1 && C % G) G >>= 1;
  return G;
}

// The tile of the one launch: over h = 32, 64, ... (at most R rounded up
// to 32, and kMaxTileRows), w the narrowest multiple of kTileCols that
// keeps the tile grid within `cap` blocks; the tile whose h w (the values
// a block holds, each thread's share of them) is least and fits the
// registers, the squarer one (the larger of min(h, w)) on a tie. None fits
// (rounds > 0): the two passes over tiles of about 128 rows that fill the
// registers, each block walking its tiles in rounds.
template <typename T>
TilePlan make_tile_plan(int64_t R, int64_t C, int G, int resident, int drop, int skip, bool kw) {
  TilePlan p = {};
  p.R = static_cast<int>(R), p.C = static_cast<int>(C), p.G = G;
  p.drop = drop, p.skip = skip;
  p.kwords = kw && R % 4 == 0;
  const int64_t cap = std::max(1, std::min(resident, kMaxPartials));
  const int64_t vals = static_cast<int64_t>(kThreads) * max_chunks<T>() * kChunk;
  const int64_t hmax =
      std::min<int64_t>(kMaxTileRows, (R + kTileRows - 1) / kTileRows * kTileRows);
  const int64_t wmax = (C + kTileCols - 1) / kTileCols * kTileCols;
  int64_t best = 0;
  for (int64_t h = kTileRows; h <= hmax; h += kTileRows) {
    const int64_t nr = (R + h - 1) / h, ncmax = cap / nr;
    if (ncmax == 0) continue;
    const int64_t per = (C + ncmax - 1) / ncmax;
    const int64_t w = std::min(wmax, (per + kTileCols - 1) / kTileCols * kTileCols);
    if (h * w > vals) continue;
    if (best == 0 || h * w < best ||
        (h * w == best && std::min(h, w) > std::min<int64_t>(p.h, p.w)))
      best = h * w, p.h = static_cast<int>(h), p.w = static_cast<int>(w);
  }
  if (best == 0) {
    p.h = static_cast<int>(std::min<int64_t>(128, hmax));
    p.w = static_cast<int>(std::min(wmax, vals / p.h / kTileCols * kTileCols));
  }
  p.nc = static_cast<int>((C + p.w - 1) / p.w);
  const int64_t tiles = (R + p.h - 1) / p.h * p.nc;
  p.tiles = static_cast<int>(tiles);
  p.blocks = static_cast<int>(std::max<int64_t>(1, std::min(tiles, cap)));
  p.rounds = best ? 0 : static_cast<int>((tiles + p.blocks - 1) / p.blocks);
  p.cw = p.w / kChunk, p.dr = kThreads / p.cw, p.dc = kThreads % p.cw;
  p.pitch = p.w / 4 + 1;
  return p;
}

template <typename T>
using KtKernel = void (*)(const T*, uint8_t*, uint8_t*, float*, float*, unsigned*, TilePlan);

template <typename T, int G, class Family>
int resident_kt() {
  static const int r = resident_blocks(Family::template kernel_kt<T, G, kOne>(0));
  return r;
}

template <typename T, int G, class Family>
int run_kt_at(const T* x, uint8_t* q, uint8_t* qk, float* s, float* partial, unsigned* bar,
              int64_t R, int64_t C, int fmt, int drop, int skip, cudaStream_t st) {
  const int r = resident_kt<T, G, Family>();
  if (r <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool kw = reinterpret_cast<uintptr_t>(qk) % 4 == 0;
  const TilePlan p = make_tile_plan<T>(R, C, G, r, drop, skip, kw);
  cudaError_t err;
  if (p.rounds == 0) {
    err = launch(Family::template kernel_kt<T, G, kOne>(fmt), p.blocks, 1, true, st, x, q, qk, s,
                 partial, bar, p);
  } else {
    err = launch(Family::template kernel_kt<T, G, kMax>(fmt), p.blocks, 1, false, st, x, q, qk, s,
                 partial, bar, p);
    if (err == cudaSuccess)
      err = launch(Family::template kernel_kt<T, G, kCast>(fmt), p.blocks, 1, false, st, x, q, qk,
                   s, partial, bar, p);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// x (R, C) in T -> q (R, C) bytes, qk (C, R) bytes, s (1,); drop and skip:
// the checks' control faults, else -1
template <typename T, class Family>
int run_kt(const void* x, void* q, void* qk, void* s, void* partial, void* bar, int64_t R,
           int64_t C, int fmt, int drop, int skip, cudaStream_t st) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  uint8_t* qp = static_cast<uint8_t*>(q);
  uint8_t* kp = static_cast<uint8_t*>(qk);
  float* sp = static_cast<float*>(s);
  float* pp = static_cast<float*>(partial);
  unsigned* bp = static_cast<unsigned*>(bar);
  switch (granule_kt(x, q, C, sizeof(T))) {
    case 8: return run_kt_at<T, 8, Family>(xp, qp, kp, sp, pp, bp, R, C, fmt, drop, skip, st);
    case 4: return run_kt_at<T, 4, Family>(xp, qp, kp, sp, pp, bp, R, C, fmt, drop, skip, st);
    case 2: return run_kt_at<T, 2, Family>(xp, qp, kp, sp, pp, bp, R, C, fmt, drop, skip, st);
    default: return run_kt_at<T, 1, Family>(xp, qp, kp, sp, pp, bp, R, C, fmt, drop, skip, st);
  }
}

// the K-major launcher's plan for x, q and qk (R, C) into out (8,): blocks,
// rounds (0: one launch), G, resident blocks, values a block holds in one
// round, h, w, tiles
template <typename T, class Family>
int plan_kt(const void* x, const void* q, const void* qk, int64_t R, int64_t C, int* out) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int G = granule_kt(x, q, C, sizeof(T));
  const int r = G == 8   ? resident_kt<T, 8, Family>()
                : G == 4 ? resident_kt<T, 4, Family>()
                : G == 2 ? resident_kt<T, 2, Family>()
                         : resident_kt<T, 1, Family>();
  const TilePlan p = make_tile_plan<T>(R, C, G, r, -1, -1,
                                       reinterpret_cast<uintptr_t>(qk) % 4 == 0);
  out[0] = p.blocks, out[1] = p.rounds, out[2] = p.G, out[3] = r;
  out[4] = kThreads * max_chunks<T>() * kChunk;
  out[5] = p.h, out[6] = p.w, out[7] = p.tiles;
  return r > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace tq
}  // namespace
