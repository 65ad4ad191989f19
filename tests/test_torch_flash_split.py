"""A plain model of the attention kernels' tensor-core tile step, on the CPU.

All four flash kernels (``kernels/flash_attention/csrc/flash_attention.cu``)
and the paged kernels run their products on the tensor cores through one
tile step (``kernels/csrc/mma_tile.cuh``): mma.sync m16n8k16 with bf16
operands and f32 sums. Operands that are not exact in bf16 are split into
bf16 terms (``PREF.split_bf16``): q * scale one term when q is bf16 and
the scale a power of two, else three; an f32 K, V, q or do three; the
softmax weights P and the backward's dS three. A product takes the pairs
of terms whose orders add up to at most 2, each pair and each k16 step a
fresh fragment, added in f32 rounded to nearest, the smallest pair first.

``tile_fwd``, ``tile_decode``, ``tile_dq`` and ``tile_dkv`` below are that
arithmetic in plain torch: the forward's online softmax over chunks of 16
keys (the same max, exp and row-sum tree); the split-key decode, that
online softmax over each part of ``FA.decode_split``'s keys, the parts'
(m, l, acc) merged in part order by one formula; the backward's dq,
per chunk of 16 keys S and dP from fresh fragments, dS in three terms,
each chunk's dS K added rounded to nearest; and its dk and dv, recomputed
S^T and dP^T over chunks of 16 flattened (position, head-in-group) query
rows. One simplification: a k16 step's 16 products are summed exactly and
rounded once, where the card aligns and truncates them. They are held
against the JAX package's Pallas kernels (interpret mode, as its own tests
run them) within the tolerances ``chip_smoke.py`` holds the CUDA kernels
to (o 2^-7 of max|o| in bf16 and 1e-5 in f32, lse 1e-5, dq, dk and dv
1e-4 of max|grad|), at hd 64 and 80, causal and full, GQA group 3; the
decode at every dtype pair of q and the cache and lengths 1 to S_max.
Three bf16 terms hold P and dS exactly; two would not.
"""
from __future__ import annotations

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as JFA
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention import ref as FREF
from repro_torch.kernels.paged_attention import ref as PREF

JK = importlib.import_module("repro.kernels.flash_attention.flash_attention")

torch.set_num_threads(1)

MASK = torch.tensor(FREF.MASK_VALUE, dtype=torch.float32)
O_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
LSE_TOL = 1e-5
BWD_TOL = 1e-4
P_TERMS = 3


def _pairs(na: int, nb: int) -> list[tuple[int, int]]:
    """The kernels' term pairs (t, u), t + u <= 2, the smallest first."""
    return [(t, s - t) for s in (2, 1, 0) for t in range(na) if 0 <= s - t < nb]


def _step(a: list[torch.Tensor], b: list[torch.Tensor], eq: str) -> torch.Tensor:
    """One k16 step of a split product: every pair of terms a fresh
    fragment (its 16 products summed exactly, rounded once to f32), the
    fragments added in f32 from the smallest pair up."""
    x = None
    for t, u in _pairs(len(a), len(b)):
        f = torch.einsum(eq, a[t].double(), b[u].double()).float()
        x = f if x is None else x + f
    return x


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double() + c.double()).float()


def _terms(q: torch.Tensor, hd: int) -> tuple[float, int, int, int]:
    """(scale, the padded head dim, q * scale's terms, K/V/q's terms)."""
    scale = 1.0 / math.sqrt(hd)
    one = q.dtype == torch.bfloat16 and math.frexp(scale)[0] == 0.5
    return scale, 64 if hd <= 64 else 80 if hd <= 80 else 128, 1 if one else 3, \
        1 if q.dtype == torch.bfloat16 else 3


def _pad(x: torch.Tensor, HD: int, rows: int | None = None) -> torch.Tensor:
    """Zero-pad the last dim to HD (and dim -2 to ``rows``), f32."""
    x = torch.nn.functional.pad(x.float(), (0, HD - x.shape[-1]))
    if rows is not None:
        x = torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]))
    return x


def _online(qt, kt, vt, c0, live, m, l, acc, HD):
    """One chunk of 16 keys at c0 of the online softmax, as ``tile_chunk``
    computes it: rows' q * scale terms qt (..., rows, HD), K and V terms
    (..., keys, HD), ``live`` (..., rows, 16); returns (m, l, acc)."""
    s = 0.0
    for ks in range(0, HD, 16):
        s = s + _step([t[..., ks:ks + 16] for t in qt],
                      [t[..., c0:c0 + 16, ks:ks + 16] for t in kt], "bhqd,bhkd->bhqk")
    sv = torch.where(live, s, MASK)
    m_next = torch.maximum(m, sv.amax(-1))
    p = torch.where(live, torch.exp(sv - m_next[..., None]), 0.0)
    alpha = torch.exp(m - m_next)
    r = [(p[..., 2 * j] + p[..., 2 * j + 1]) + (p[..., 8 + 2 * j] + p[..., 9 + 2 * j])
         for j in range(4)]
    l = _fma(l, alpha, (r[0] + r[1]) + (r[2] + r[3]))
    f = _step(PREF.split_bf16(p, P_TERMS), [t[..., c0:c0 + 16, :] for t in vt],
              "bhqk,bhkd->bhqd")
    return m_next, l, _fma(acc, alpha[..., None], f)


def _kv_terms(k, v, H, HD, NT):
    """K and V head-expanded, (B, H, keys padded to 16, HD), as NT terms."""
    n_keys = -(-k.shape[1] // 16) * 16
    kx, vx = (_pad(FREF._expand_heads(t, H).transpose(1, 2), HD, n_keys) for t in (k, v))
    return PREF.split_bf16(kx, NT), PREF.split_bf16(vx, NT)


def tile_fwd(q, k, v, *, causal: bool, kv_valid: int):
    """(o in q's dtype, lse f32) as ``flash_fwd``'s tile step computes them:
    q (B, Sq, H, hd), k/v (B, Sk, KV, hd)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale, HD, NQ, NT = _terms(q, hd)
    qs = (q.float() * torch.tensor(scale, dtype=torch.float32)).transpose(1, 2)
    qt = PREF.split_bf16(_pad(qs, HD), NQ)                          # (B, H, Sq, HD)
    kt, vt = _kv_terms(k, v, H, HD, NT)                             # (B, H, n_keys, HD)
    m = MASK.expand(B, H, Sq).clone()
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, HD)
    qpos = torch.arange(Sq)[:, None]
    for c0 in range(0, min(kv_valid, Sk), 16):
        kpos = torch.arange(c0, c0 + 16)[None, :]
        live = (kpos < min(kv_valid, Sk)) & ((kpos <= qpos) if causal else True)
        m, l, acc = _online(qt, kt, vt, c0, live, m, l, acc, HD)
    l_safe = torch.where(l == 0, 1.0, l)
    o = (acc / l_safe[..., None])[..., :hd].transpose(1, 2)
    return o.to(q.dtype), m + torch.log(l_safe)


def tile_decode(q, k, v, kv_len):
    """o (B, 1, H, hd) in q's dtype as ``decode_fwd`` computes it: each part
    of ``FA.decode_split(S)`` keys walked by the online softmax from (MASK,
    0, 0), then per output the parts in order: M = max m_p, L = fma(l_p,
    c_p, L), A = fma(acc_p, c_p, A) with c_p = exp(m_p - M), o = A / L
    (L = 1 where it is 0). A part past a slot's kv_len keeps (MASK, 0, 0),
    which leaves M, L and A exactly as the kernel's skip of it does."""
    B, _, H, hd = q.shape
    S = k.shape[1]
    part_keys, parts = FA.decode_split(S)
    scale, HD, NQ, _ = _terms(q, hd)
    NT = 1 if k.dtype == torch.bfloat16 else 3
    qs = (q.float() * torch.tensor(scale, dtype=torch.float32)).transpose(1, 2)
    qt = PREF.split_bf16(_pad(qs, HD), NQ)                          # (B, H, 1, HD)
    kt, vt = _kv_terms(k, v, H, HD, NT)
    n_live = kv_len.long().clamp(0, S)[:, None, None, None]        # (B, 1, 1, 1)
    states = []
    for p in range(parts):
        m = MASK.expand(B, H, 1).clone()
        l = torch.zeros(B, H, 1)
        acc = torch.zeros(B, H, 1, HD)
        j0, j1 = p * part_keys, min((p + 1) * part_keys, S)
        for c0 in range(j0, j1, 16):
            kpos = torch.arange(c0, c0 + 16)[None, None, None, :]
            live = (kpos < j1) & (kpos < n_live)
            m, l, acc = _online(qt, kt, vt, c0, live, m, l, acc, HD)
        states.append((m, l, acc))
    M = MASK.expand(B, H, 1).clone()
    for m, _, _ in states:
        M = torch.maximum(M, m)
    L = torch.zeros(B, H, 1)
    A = torch.zeros(B, H, 1, HD)
    for m, l, acc in states:
        c = torch.exp(m - M)
        L = _fma(l, c, L)
        A = _fma(acc, c[..., None], A)
    L = torch.where(L == 0, 1.0, L)
    return (A / L[..., None])[..., :hd].transpose(1, 2).to(q.dtype)


def tile_dq(q, k, v, do, lse, di, *, causal: bool, kv_valid: int):
    """dq (B, Sq, H, hd) f32 as ``flash_bwd_dq``'s tile step computes it:
    per chunk of 16 keys S = (q scale) K^T and dP = do V^T from fresh
    fragments, P = exp(S - lse), dS = P (dP - di), then dQ += dS K with dS
    in three bf16 terms, each chunk's fragments added rounded to nearest;
    dq = scale times the sum. A chunk past a row's keys adds exact zeros,
    so every row walks every live chunk here."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    n_valid = min(kv_valid, Sk)
    scale, HD, NQ, NT = _terms(q, hd)
    qs = (q.float() * torch.tensor(scale, dtype=torch.float32)).transpose(1, 2)
    qt = PREF.split_bf16(_pad(qs, HD), NQ)                          # (B, H, Sq, HD)
    dot = PREF.split_bf16(_pad(do.float().transpose(1, 2), HD), NT)
    kt, vt = _kv_terms(k, v, H, HD, NT)
    acc = torch.zeros(B, H, Sq, HD)
    qpos = torch.arange(Sq)[:, None]
    for c0 in range(0, n_valid, 16):
        s = dp = 0.0
        for ks in range(0, HD, 16):
            kk = [t[..., c0:c0 + 16, ks:ks + 16] for t in kt]
            s = s + _step([t[..., ks:ks + 16] for t in qt], kk, "bhqd,bhkd->bhqk")
            dp = dp + _step([t[..., ks:ks + 16] for t in dot],
                            [t[..., c0:c0 + 16, ks:ks + 16] for t in vt], "bhqd,bhkd->bhqk")
        kpos = torch.arange(c0, c0 + 16)[None, :]
        live = (kpos < n_valid) & ((kpos <= qpos) if causal else True)
        p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
        ds = p * (dp - di[..., None])
        acc = acc + _step(PREF.split_bf16(ds, P_TERMS), [t[..., c0:c0 + 16, :] for t in kt],
                          "bhqk,bhkd->bhqd")
    dq = torch.tensor(scale, dtype=torch.float32) * acc
    return dq[..., :hd].transpose(1, 2)


def _flat(x: torch.Tensor, KV: int) -> torch.Tensor:
    """(B, Sq, H, d) -> (B, KV, Sq * group, d): flattened row r is position
    r // group, head-in-group r % group, as the kernels walk them."""
    B, Sq, H, d = x.shape
    return x.reshape(B, Sq, KV, H // KV, d).permute(0, 2, 1, 3, 4).reshape(B, KV, -1, d)


def tile_dkv(q, k, v, do, lse, di, *, causal: bool, kv_valid: int):
    """(dk, dv), each (B, Sk, KV, hd) f32, as ``flash_bwd_dkv``'s tile step
    computes them: per chunk of 16 flattened query rows S^T = K (q scale)^T
    and dP^T = V do^T, P^T = exp(S^T - lse), dS^T = P^T (dP^T - di), then
    dV += P^T do and dK += dS^T q, P and dS in three bf16 terms; dk = scale
    times the sum."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group, n_valid = H // KV, min(kv_valid, Sk)
    scale, HD, NQ, NT = _terms(q, hd)
    n_rows = Sq * group
    rows = -(-n_rows // 16) * 16
    qf = _flat(q.float(), KV)
    qt = PREF.split_bf16(_pad(qf * torch.tensor(scale, dtype=torch.float32), HD, rows), NQ)
    qu = PREF.split_bf16(_pad(qf, HD, rows), NT)
    dot = PREF.split_bf16(_pad(_flat(do.float(), KV), HD, rows), NT)
    row_terms = [_flat(t.transpose(1, 2)[..., None], KV)[..., 0] for t in (lse, di)]
    lse_f, di_f = (torch.nn.functional.pad(t, (0, rows - n_rows)) for t in row_terms)
    kt, vt = (PREF.split_bf16(_pad(t.transpose(1, 2), HD), NT) for t in (k, v))
    acc_k = torch.zeros(B, KV, Sk, HD)
    acc_v = torch.zeros(B, KV, Sk, HD)
    key = torch.arange(Sk)[:, None]
    for c0 in range(0, n_rows, 16):
        st = torch.zeros(B, KV, Sk, 16)
        dpt = torch.zeros(B, KV, Sk, 16)
        for ks in range(0, HD, 16):
            kk = [t[..., ks:ks + 16] for t in kt]
            st = st + _step(kk, [t[..., c0:c0 + 16, ks:ks + 16] for t in qt], "bkjd,bkrd->bkjr")
            dpt = dpt + _step([t[..., ks:ks + 16] for t in vt],
                              [t[..., c0:c0 + 16, ks:ks + 16] for t in dot], "bkjd,bkrd->bkjr")
        r = torch.arange(c0, c0 + 16)[None, :]
        live = (key < n_valid) & (r < n_rows) & ((key <= r // group) if causal else True)
        p = torch.where(live, torch.exp(st - lse_f[..., None, c0:c0 + 16]), 0.0)
        ds = p * (dpt - di_f[..., None, c0:c0 + 16])
        acc_v = acc_v + _step(PREF.split_bf16(p, P_TERMS), [t[..., c0:c0 + 16, :] for t in dot],
                              "bkjr,bkrd->bkjd")
        acc_k = acc_k + _step(PREF.split_bf16(ds, P_TERMS), [t[..., c0:c0 + 16, :] for t in qu],
                              "bkjr,bkrd->bkjd")
    dk = torch.tensor(scale, dtype=torch.float32) * acc_k
    return dk[..., :hd].transpose(1, 2), acc_v[..., :hd].transpose(1, 2)


# ---------------------------------------------------------------------------
# the JAX side, as the JAX package's and the port's tests run it
# ---------------------------------------------------------------------------

def _kl(x):
    """(B, S, H, hd) <-> (B, H, S, hd)."""
    return jnp.transpose(x, (0, 2, 1, 3))


def _jax(q, k, v, do, *, causal, kv_valid):
    """(o, lse, di, dk, dv, dq) of the Pallas kernels in interpret mode,
    padded to their blocks as the JAX ops pad; di = sum_d o * do in f32."""
    Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(hd)
    bq, bk = JFA.choose_attn_blocks(Sq, Sk)
    pad = JFA._pad_seq
    qk, kk, vk, dok = map(_kl, (q, k, v, do))
    kw = dict(causal=causal, kv_valid=kv_valid, scale=scale, block_q=bq, block_k=bk,
              interpret=True)
    o, lse = JK.flash_fwd(pad(qk, 2, bq), pad(kk, 2, bk), pad(vk, 2, bk), **kw)
    o, lse = o[:, :, :Sq], lse[:, :, :Sq]
    di = jnp.sum(o.astype(jnp.float32) * dok.astype(jnp.float32), axis=-1)
    args = (pad(qk, 2, bq), pad(kk, 2, bk), pad(vk, 2, bk), pad(dok, 2, bq), pad(lse, 2, bq),
            pad(di, 2, bq))
    dk, dv = JK.flash_bwd_dkv(*args, **kw)
    dq = JK.flash_bwd_dq(*args, **kw)
    return (_kl(o), lse, di, _kl(dk[:, :, :Sk]), _kl(dv[:, :, :Sk]), _kl(dq[:, :, :Sq]))


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), dtype=np.float64)
    return float(np.abs(got.double().numpy() - want).max() / np.abs(want).max())


# (B, S, Sk, H, KV, hd, kv_valid): GQA group 3, hd 64 (one term of q * scale
# in bf16) and 80 (three, CLIP's vision tower), Sk > S with kv_valid < Sk
SHAPES = [(1, 37, 37, 6, 2, 64, 37), (1, 21, 40, 6, 2, 80, 33)]
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _case(shape, dt, causal):
    B, S, Sk, H, KV, hd, kv_valid = shape
    rng = np.random.default_rng(S * 100 + hd + causal)
    q, do = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, KV, hd)).astype(np.float32) for _ in range(2))
    jdt, tdt = DTYPES[dt]
    want = _jax(*(jnp.asarray(a).astype(jdt) for a in (q, k, v, do)), causal=causal,
                kv_valid=kv_valid)
    return [torch.from_numpy(a).to(tdt) for a in (q, k, v, do)], want, kv_valid


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tile_fwd_matches_jax(shape, causal, dt):
    (q, k, v, _), (jo, jlse, *_), kv_valid = _case(shape, dt, causal)
    o, lse = tile_fwd(q, k, v, causal=causal, kv_valid=kv_valid)
    assert o.dtype == q.dtype and bool(torch.isfinite(o.float()).all())
    assert _rel(o, jo) <= O_TOL[q.dtype], _rel(o, jo)
    assert float(np.abs(lse.numpy() - np.asarray(jlse)).max()) <= LSE_TOL


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tile_dkv_matches_jax(shape, causal, dt):
    (q, k, v, do), (_, jlse, jdi, jdk, jdv, _), kv_valid = _case(shape, dt, causal)
    lse, di = (torch.from_numpy(np.array(t, dtype=np.float32)) for t in (jlse, jdi))
    dk, dv = tile_dkv(q, k, v, do, lse, di, causal=causal, kv_valid=kv_valid)
    assert dk.dtype == dv.dtype == torch.float32
    assert float(dk[:, kv_valid:].abs().sum()) == 0.0 == float(dv[:, kv_valid:].abs().sum())
    assert _rel(dk, jdk) <= BWD_TOL, _rel(dk, jdk)
    assert _rel(dv, jdv) <= BWD_TOL, _rel(dv, jdv)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tile_dq_matches_jax(shape, causal, dt):
    (q, k, v, do), (_, jlse, jdi, _, _, jdq), kv_valid = _case(shape, dt, causal)
    lse, di = (torch.from_numpy(np.array(t, dtype=np.float32)) for t in (jlse, jdi))
    dq = tile_dq(q, k, v, do, lse, di, causal=causal, kv_valid=kv_valid)
    assert dq.dtype == torch.float32 and dq.shape == q.shape
    assert _rel(dq, jdq) <= BWD_TOL, _rel(dq, jdq)


# decode: 7 slots at lengths 1 .. S_max over a 256-cell cache, GQA group 3
DECODE_LENS = [1, 2, 127, 128, 129, 200, 256]


@pytest.mark.parametrize("cache", list(DTYPES))
@pytest.mark.parametrize("qdt", list(DTYPES))
@pytest.mark.parametrize("hd", [64, 80])
def test_tile_decode_matches_jax(hd, qdt, cache):
    S, H, KV = DECODE_LENS[-1], 6, 2
    B = len(DECODE_LENS)
    rng = np.random.default_rng(hd * 10 + len(qdt) + 3 * len(cache))
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32) for _ in range(2))
    lens = np.array(DECODE_LENS, dtype=np.int32)
    (jq, tq), (jc, tc) = DTYPES[qdt], DTYPES[cache]
    want = JFA.decode_attention(jnp.asarray(q).astype(jq), jnp.asarray(k).astype(jc),
                                jnp.asarray(v).astype(jc), jnp.asarray(lens),
                                backend="pallas_interpret")
    o = tile_decode(torch.from_numpy(q).to(tq), torch.from_numpy(k).to(tc),
                    torch.from_numpy(v).to(tc), torch.from_numpy(lens))
    assert o.dtype == tq and bool(torch.isfinite(o.float()).all())
    assert _rel(o, want) <= O_TOL[tq], _rel(o, want)


@pytest.mark.parametrize("S", [1, 16, 96, 100, 256, 1024, 1025, 1500, 32768])
def test_decode_split_covers_the_cache(S):
    """Parts of a multiple of 16 keys, at most DECODE_MAX_PARTS, that cover
    the S_max cells with no part wholly past them."""
    part_keys, parts = FA.decode_split(S)
    assert part_keys % 16 == 0 and 1 <= parts <= FA.DECODE_MAX_PARTS
    assert (parts - 1) * part_keys < S <= parts * part_keys
    assert part_keys == 16 or S > 16 * FA.DECODE_MAX_PARTS


def test_three_terms_hold_p_and_ds_exactly():
    """P = exp(s - m) in (0, 1] and dS = P (dP - di) as the tile step forms
    them: three bf16 terms sum to each exactly, two do not."""
    gen = torch.Generator().manual_seed(21)
    s = torch.randn(40000, generator=gen) * 6
    p = torch.exp(s - s.max())
    ds = p * (torch.randn(40000, generator=gen) * 3 - torch.randn(40000, generator=gen))
    for x in (p, ds):
        terms = PREF.split_bf16(x, P_TERMS)
        assert all(t.dtype == torch.bfloat16 for t in terms)
        assert torch.equal(sum(t.double() for t in terms), x.double())
        assert not torch.equal(sum(t.double() for t in PREF.split_bf16(x, 2)), x.double())


def test_term_pairs_smallest_first():
    """The pairs a product takes: all with t + u <= 2, from 2 down to 0."""
    assert _pairs(1, 1) == [(0, 0)]
    assert _pairs(3, 1) == [(2, 0), (1, 0), (0, 0)]
    assert _pairs(3, 3) == [(0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0)]
