"""The byte placements of the int8 GEMM's producer warpgroup, modelled in
numpy (no card, no JAX; a few milliseconds).

``kernels/switchback/csrc/switchback.cu`` writes two operand tiles itself
into 128-byte-swizzled shared memory (``sw128``, ``kernels/csrc/
wgmma.cuh``), which int8 ``wgmma`` then reads through a K-major descriptor:

* ``quantize_stage``, the fused pair's one-launch form (at most 16 rows):
  thread t of 128 writes row t / 8, bytes 16 (t % 8) .. + 15 of x's
  quantized rows as one 16-byte store at ``sw128(row * 128 + 16 (t % 8))``;
* ``transpose_tile``, the forward's W: TMA's (128 k x 128 m) tile made
  K-major, 4 x 4 bytes a thread by ``__byte_perm``.

The model checks that every (row, k) byte lands exactly once where the
descriptor's read of each k32 step finds it (the swizzle applied to the
address bits, the tile 1,024-byte aligned, 8-row groups 1,024 bytes
apart), and that the 32 lanes of a warp reach 32 different banks in each
shared-memory access.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "switchback"
       / "csrc" / "switchback.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+)", SRC).group(1))


SWAP_ROWS = _const("kI8SwapRows")
TILE = 128                       # bytes of K a stage holds per row


def sw128(off):
    """wgmma.cuh's sw128: chunk c of row r stored at chunk c ^ (r % 8)."""
    off = np.asarray(off)
    return off ^ ((off >> 3) & 0x70)


def descriptor_read(n, k):
    """Where a K-major, 128-byte-swizzled descriptor at a 1,024-byte-aligned
    tile reads byte k of row n: the k32 step j = k // 32 starts 32 j bytes
    in (``desc_advance``), rows n % 8 are 128 bytes apart, groups of 8 rows
    1,024 (the stride), and the swizzle XORs address bits 4-6 with 7-9."""
    j, b = k // 32, k % 32
    addr = 32 * j + (n % 8) * 128 + (n // 8) * 1024 + b
    return addr ^ (((addr >> 7) & 7) << 4)


def byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: result byte i is byte (s >> 4 i) & 7 of y:x."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def test_quantize_stage_places_every_byte_once_where_wgmma_reads_it():
    assert SWAP_ROWS * 8 == 128          # one 16-byte chunk per producer thread
    t = np.arange(128)
    r, ch = t >> 3, t & 7
    e = np.arange(16)
    # thread t's 16 bytes: row r, k = 16 ch + e, at its chunk's swizzled place
    addr = (sw128(r * TILE + 16 * ch)[:, None] + e[None, :]).ravel()
    rows = np.repeat(r, 16)
    ks = (16 * ch[:, None] + e[None, :]).ravel()
    assert sorted(addr.tolist()) == list(range(SWAP_ROWS * TILE))     # each byte once
    assert np.array_equal(addr, descriptor_read(rows, ks))
    # a 16-byte store serves 8 lanes at a time: each such group of a warp
    # covers the 32 banks once
    for w in range(4):
        for q in range(4):
            lanes = t[32 * w + 8 * q: 32 * w + 8 * q + 8]
            banks = ((sw128(r[lanes] * TILE + 16 * ch[lanes])[:, None] // 4
                      + np.arange(4)[None, :]) % 32).ravel()
            assert sorted(banks.tolist()) == list(range(32))


def test_transpose_tile_makes_w_k_major_without_bank_conflicts():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 256, size=(128, 128), dtype=np.uint8)   # w[k, m], as TMA brings it
    raw = np.zeros(128 * 128, np.uint8)
    kk, mm = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    raw[sw128(kk * TILE + mm)] = w
    dst = np.full(128 * 128, -1, np.int64)

    def word(buf, off):
        return int.from_bytes(bytes(buf[off:off + 4].astype(np.uint8)), "little")

    for j in range(8):
        loads = [[] for _ in range(4)]
        stores = [[] for _ in range(4)]
        for t in range(128):
            lane, wq = t & 31, t >> 5
            f = 4 * ((lane & 3) | ((lane >> 4) << 2)) + ((lane >> 2) & 3)
            v = f ^ (wq + 4 * j)
            words = []
            for r in range(4):
                off = int(sw128((4 * v + r) * TILE + 4 * lane))
                words.append(word(raw, off))
                if wq == 0:
                    loads[r].append(off // 4 % 32)
            t0, t1 = byte_perm(words[0], words[1], 0x5140), byte_perm(words[0], words[1], 0x7362)
            t2, t3 = byte_perm(words[2], words[3], 0x5140), byte_perm(words[2], words[3], 0x7362)
            out = (byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
                   byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632))
            for e_ in range(4):
                off = int(sw128((4 * lane + e_) * TILE + 4 * v))
                assert (dst[off:off + 4] == -1).all()                    # written once
                dst[off:off + 4] = list(out[e_].to_bytes(4, "little"))
                if wq == 0:
                    stores[e_].append(off // 4 % 32)
        for banks in loads + stores:                                     # one warp's access
            assert sorted(banks) == list(range(32))
    # dst holds W's row m as 128 bytes of k, read where the descriptor reads it
    got = dst[descriptor_read(mm, kk)]                     # got[k, m]: row m, byte k
    assert np.array_equal(got, w.astype(np.int64))
