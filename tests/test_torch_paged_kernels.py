"""The port's paged-attention kernels' plain versions against the JAX
package's, on the CPU.

``repro_torch.kernels.paged_attention.ops`` runs its plain version
(``ref.py``) on a CPU tensor; the JAX side runs
``PA.paged_decode_attention`` / ``PA.paged_prefill_attention`` with
``backend="pallas_interpret"`` (the Pallas kernels interpreted) and
``backend="xla"`` (the gather-then-dense oracle), on the same numpy inputs.

Tolerance, relative to max|o|: the port takes one softmax over the
gathered cells, the Pallas kernels an online softmax block by block and
the XLA oracle one softmax with the scale applied after the product, so
in f32 the three agree to the order of their sums: TOL = 1e-5 (measured
below 1e-6). In bf16 the output rounds once to bf16 on every side, and
the f32 results an ulp apart may round to neighbouring values: one bf16
ulp at max|o|, 2^-7.

Covered: MHA, GQA (smollm-360m's 15 over 5 heads), MQA, block sizes 4 to
16, non-pow2 table widths, ragged lengths, dead table entries (pointing at
the trash block on the JAX side; any id, even outside the pool, for the
port, which never reads them on the card and clamps them in the plain
version), a dry slot (kv_len 0: exact zeros, as the Pallas kernels give),
fresh and resumed prefill chunks at block-unaligned offsets, and chunked
against monolithic prefill.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as JPA
from repro_torch.kernels.paged_attention import ops as PA

torch.set_num_threads(1)

TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BACKENDS = ("pallas_interpret", "xla")
# (H, KV, hd, bs, nb)
SHAPES = [(4, 4, 16, 8, 4), (15, 5, 64, 16, 4), (8, 2, 16, 4, 6), (4, 1, 8, 4, 5)]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _inputs(seed, B, Sq, H, KV, hd, bs, nb, dt):
    """q and pools from a seeded numpy generator, rounded to ``dt``;
    tables a permutation of the pool's blocks (block N is the trash)."""
    rng = np.random.default_rng(seed)
    N = B * nb + 2
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((N + 1, bs, KV, hd)).astype(np.float32)
    v = rng.standard_normal((N + 1, bs, KV, hd)).astype(np.float32)
    tables = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    tdt = DTYPES[dt][1]
    q, k, v = (torch.from_numpy(a).to(tdt).float().numpy() for a in (q, k, v))
    return q, k, v, tables, N


def _dead_to(tables, kv_len, bs, dead_id):
    live = -(-np.asarray(kv_len) // bs)
    j = np.arange(tables.shape[1])[None, :]
    return np.where(j < live[:, None], tables, dead_id).astype(np.int32)


def _jax(fn, dt, *arrays, **kw):
    jdt = DTYPES[dt][0]
    q, k, v, *rest = arrays
    out = fn(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
             *(jnp.asarray(a) for a in rest), **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(fn, dt, *arrays):
    tdt = DTYPES[dt][1]
    q, k, v, *rest = arrays
    out = fn(torch.from_numpy(np.ascontiguousarray(q)).to(tdt), torch.from_numpy(k).to(tdt),
             torch.from_numpy(v).to(tdt), *(torch.from_numpy(np.asarray(a)) for a in rest))
    assert out.dtype == tdt
    return out.float().numpy()


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("H,KV,hd,bs,nb", SHAPES)
def test_paged_decode_matches_jax(H, KV, hd, bs, nb, dt):
    """Ragged lengths (one cell, mid-block, full table), dead entries at
    the trash block; a dry slot gives zeros like the Pallas kernel."""
    B = 4
    q, k, v, tables, N = _inputs(H * hd + bs, B, 1, H, KV, hd, bs, nb, dt)
    kv_len = np.array([1, (nb - 1) * bs - 1, nb * bs, 0], np.int32)
    tables = _dead_to(tables, kv_len, bs, N)
    got = _port(PA.paged_decode_attention, dt, q, k, v, tables, kv_len)
    for backend in BACKENDS:
        want = _jax(JPA.paged_decode_attention, dt, q, k, v, tables, kv_len, backend=backend)
        live = slice(0, 3) if backend == "xla" else slice(None)   # the oracle's dry row
        assert _rel(got[live], want[live]) <= TOL[dt], backend    # is uniform, not 0
    assert not got[3].any()


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("H,KV,hd,bs,nb", SHAPES)
def test_paged_prefill_matches_jax(H, KV, hd, bs, nb, dt):
    """A fresh chunk (q_off 0), a resumed chunk at a block-unaligned cursor,
    a chunk ending mid-table with pad rows, and a dry slot (exact zeros on
    every side)."""
    B, Sq = 4, 8
    q, k, v, tables, N = _inputs(H + hd * bs, B, Sq, H, KV, hd, bs, nb, dt)
    q_off = np.array([0, 5, bs + 1, 0], np.int32)
    kv_len = np.array([Sq, 5 + Sq, bs + 4, 0], np.int32)        # slot 2: 3 pad rows
    tables = _dead_to(tables, kv_len, bs, N)
    got = _port(PA.paged_prefill_attention, dt, q, k, v, tables, q_off, kv_len)
    for backend in BACKENDS:
        want = _jax(JPA.paged_prefill_attention, dt, q, k, v, tables, q_off, kv_len,
                    backend=backend)
        assert _rel(got, want) <= TOL[dt], backend
        assert not want[3].any()
    assert not got[3].any()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_paged_prefill_chunked_matches_monolithic(dt):
    """Prefilling in chunks with block-unaligned edges reproduces the
    one-shot prefill row for row, on the port as on both JAX backends."""
    B, H, KV, hd, bs, nb, L = 2, 4, 2, 16, 4, 6, 24
    q, k, v, _, _ = _inputs(6, B, L, H, KV, hd, bs, nb, dt)
    tables = np.arange(B * nb, dtype=np.int32).reshape(B, nb)
    ones = np.ones((B,), np.int32)
    runs = [lambda *a: _port(PA.paged_prefill_attention, dt, *a)]
    runs += [lambda *a, b=b: _jax(JPA.paged_prefill_attention, dt, *a, backend=b)
             for b in BACKENDS]
    for fn in runs:
        mono = fn(q, k, v, tables, 0 * ones, L * ones)
        parts = [fn(q[:, a:b], k, v, tables, a * ones, b * ones)
                 for a, b in ((0, 5), (5, 13), (13, 24))]
        assert _rel(np.concatenate(parts, 1), mono) <= TOL[dt]


def test_dead_table_entries_are_never_read():
    """Entries past a slot's live blocks may hold any id, even one outside
    the pool: the outputs are the same bits as with the trash id."""
    H, KV, hd, bs, nb = 15, 5, 64, 16, 4
    q, k, v, tables, N = _inputs(3, 4, 5, H, KV, hd, bs, nb, "f32")
    q_off = np.array([0, 3, 20, 0], np.int32)
    kv_len = np.array([5, 8, 25, 0], np.int32)
    for fn, args in ((PA.paged_prefill_attention, (q_off, kv_len)),
                     (PA.paged_decode_attention, (kv_len,))):
        qq = q if fn is PA.paged_prefill_attention else np.ascontiguousarray(q[:, :1])
        a = _port(fn, "f32", qq, k, v, _dead_to(tables, kv_len, bs, N), *args)
        b = _port(fn, "f32", qq, k, v, _dead_to(tables, kv_len, bs, 10 ** 6), *args)
        np.testing.assert_array_equal(a, b)


def test_paged_wrappers_check_their_inputs():
    q = torch.zeros(2, 1, 6, 8)
    pool = torch.zeros(5, 4, 2, 8)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        PA.paged_decode_attention(q, pool, pool, tables.long(), lens)
    with pytest.raises(ValueError):                     # heads do not divide
        PA.paged_decode_attention(q, torch.zeros(5, 4, 4, 8), torch.zeros(5, 4, 4, 8),
                                  tables, lens)
    with pytest.raises(ValueError):                     # one query per slot
        PA.paged_decode_attention(torch.zeros(2, 2, 6, 8), pool, pool, tables, lens)
    with pytest.raises(ValueError):                     # block larger than staged
        PA.paged_prefill_attention(q, torch.zeros(5, 128, 2, 8), torch.zeros(5, 128, 2, 8),
                                   tables, lens, lens)
