"""The port's flash-attention kernel module against the JAX package's.

``repro_torch.kernels.flash_attention.ops`` on CPU tensors runs the plain
PyTorch versions (``ref.py``: one full softmax in f32); they are held
against the JAX package's Pallas kernels in interpret mode (an online
softmax over key tiles, the arithmetic of the TPU kernels and of the
port's CUDA kernels) and against its XLA reference, on the same inputs
made from a seeded numpy generator. The CUDA kernels themselves run only
on the card: ``tests/test_torch_cuda.py`` (marker ``cuda``) and
``chip_smoke.py`` hold them against these plain versions there.

Tolerances, with what was measured over these cases (relative errors are
relative to max|o| of the JAX side):

* f32, o: 2e-6 relative (measured up to 6.5e-7 for prefill, 4.2e-7 for
  decode): the online and the full softmax sum in another order, and the
  XLA reference scales the scores after the product where the kernels
  scale q before it (one ulp apart at hd 40; the same bits at hd 64,
  whose scale 1/8 is exact);
* bf16, o: 2^-7 relative, one bf16 ulp at the largest value (measured up
  to 1.5e-3 for prefill, 3.5e-4 for decode): the f32 results round to
  bf16 on different sides of a rounding boundary now and then;
* lse, f32 in both dtypes: 5e-6 absolute (measured up to 7.2e-7, about
  two ulps at |lse| ~ 5).
"""
from __future__ import annotations

import importlib
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as JFA
from repro.kernels.flash_attention import ref as JREF
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention import ref as FREF

JK = importlib.import_module("repro.kernels.flash_attention.flash_attention")

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
O_TOL = {"f32": 2e-6, "bf16": 2.0 ** -7}
LSE_TOL = 5e-6


def _kernel_layout(x):
    return jnp.transpose(x, (0, 2, 1, 3))


def _jax_fwd(q, k, v, *, causal, kv_valid, backend):
    """JAX (o, lse) for model-layout inputs. Its public op masks no key
    below Sk; for ``kv_valid < Sk`` the kernel (or the oracle) is called
    as the op calls it, with the padding the op does."""
    Sq, Sk = q.shape[1], k.shape[1]
    if kv_valid == Sk:
        return JFA.flash_fwd_lse(q, k, v, causal=causal, backend=backend)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qk, kk, vk = map(_kernel_layout, (q, k, v))
    if backend == "xla":
        o, lse = JREF.mha_fwd(qk, kk, vk, causal=causal, kv_valid=kv_valid, scale=scale)
        return _kernel_layout(o), lse
    bq, bk = JFA.choose_attn_blocks(Sq, Sk)
    o, lse = JK.flash_fwd(JFA._pad_seq(qk, 2, bq), JFA._pad_seq(kk, 2, bk),
                          JFA._pad_seq(vk, 2, bk), causal=causal, kv_valid=kv_valid,
                          scale=scale, block_q=bq, block_k=bk, interpret=True)
    return _kernel_layout(o[:, :, :Sq]), lse[:, :, :Sq]


def _inputs(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _check_o(got: torch.Tensor, want, dt: str):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape and np.isfinite(want).all()
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= O_TOL[dt], err


# (B, Sq, Sk, H, KV, hd, kv_valid): group 1 and 3, hd 40 and 64, Sq not a
# power of two, Sk > Sq with kv_valid < Sk, and the path's head layout
FWD_SHAPES = [
    (2, 37, 37, 3, 1, 40, 37),
    (2, 37, 37, 6, 6, 64, 37),
    (2, 20, 50, 3, 1, 64, 41),
    (1, 64, 64, 15, 5, 64, 64),
]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_fwd_lse_matches_jax(shape, causal, dt):
    B, Sq, Sk, H, KV, hd, kv_valid = shape
    rng = np.random.default_rng(Sq * 100 + Sk + H + hd)
    q, k, v = _inputs(rng, (B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))
    jdt, tdt = DTYPES[dt]
    o, lse = FA.flash_fwd_lse(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                              causal=causal, kv_valid=kv_valid)
    assert o.dtype == tdt and lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    for backend in ("pallas_interpret", "xla"):
        jo, jlse = _jax_fwd(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal,
                            kv_valid=kv_valid, backend=backend)
        _check_o(o, jo, dt)
        assert np.abs(lse.numpy() - np.asarray(jlse)).max() <= LSE_TOL


def _jax_decode(q, k, v, lens, jdt):
    return JFA.decode_attention(jnp.asarray(q, jdt), jnp.asarray(k, jnp.bfloat16),
                                jnp.asarray(v, jnp.bfloat16), jnp.asarray(lens),
                                backend="pallas_interpret")


# per-slot live lengths: every length 1..96 in one batch; at S_max 256 the
# tile edges and the full window; a wrapped ring (every slot at S_max)
DECODE_CASES = {
    "smax96-all-lengths": (96, np.arange(1, 97)),
    "smax256-edges": (256, np.array([1, 2, 31, 32, 33, 127, 128, 129, 200, 255, 256])),
    "smax96-wrapped": (96, np.full(4, 96)),
    "smax256-wrapped": (256, np.full(3, 256)),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_attention_matches_jax(case, dt):
    """Query in ``dt`` over a bf16 cache, as the engine holds it."""
    S, lens = DECODE_CASES[case]
    lens = lens.astype(np.int32)
    B, H, KV, hd = len(lens), 15, 5, 64
    rng = np.random.default_rng(S + B)
    q, k, v = _inputs(rng, (B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    jdt, tdt = DTYPES[dt]
    o = FA.decode_attention(torch.from_numpy(q).to(tdt),
                            torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(),
                            torch.from_numpy(lens))
    assert o.dtype == tdt
    _check_o(o, _jax_decode(q, k, v, lens, jdt), dt)


def test_decode_group1_hd40_matches_jax():
    """The reduced test config's shape: one KV head, group 3, hd 40."""
    rng = np.random.default_rng(11)
    S, lens = 16, np.array([1, 5, 16], np.int32)
    q, k, v = _inputs(rng, (3, 1, 3, 40), (3, S, 1, 40), (3, S, 1, 40))
    o = FA.decode_attention(torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
                            torch.from_numpy(v).bfloat16(), torch.from_numpy(lens))
    _check_o(o, _jax_decode(q, k, v, lens, jnp.float32), "f32")


def test_decode_matches_prefill_row():
    """Decode at length L equals the causal prefill's row L-1 over the same
    keys: the two plain versions agree with each other."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, (2, 9, 6, 64), (2, 9, 2, 64),
                                                     (2, 9, 2, 64)))
    o, _ = FA.flash_fwd_lse(q, k, v, causal=True)
    for L in (1, 5, 9):
        d = FA.decode_attention(q[:, L - 1:L].contiguous(), k, v,
                                torch.full((2,), L, dtype=torch.int32))
        torch.testing.assert_close(d[:, 0], o[:, L - 1], rtol=0, atol=2e-6)


def test_gqa_maps_query_head_to_kv_head_by_group():
    """Query head h reads KV head h // group (jnp.repeat order): with one
    distinct value per KV head, head h's output is KV head h // 3's value."""
    B, S, H, KV, hd = 1, 4, 6, 2, 8
    q = torch.zeros((B, S, H, hd))
    k = torch.zeros((B, S, KV, hd))
    v = torch.arange(KV, dtype=torch.float32)[None, None, :, None].expand(B, S, KV, hd)
    o, _ = FA.flash_fwd_lse(q, k, v.contiguous(), causal=True)
    assert torch.equal(o[0, 0, :, 0], torch.tensor([0., 0., 0., 1., 1., 1.]))


def test_wrappers_reject_bad_input():
    q = torch.zeros((1, 4, 6, 8))
    k = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError):                      # kv_valid outside [1, Sk]
        FA.flash_fwd_lse(q, k, k, causal=True, kv_valid=0)
    with pytest.raises(ValueError):                      # H % KV != 0
        FA.flash_fwd_lse(q, torch.zeros((1, 4, 4, 8)), torch.zeros((1, 4, 4, 8)),
                         causal=False)
    with pytest.raises(TypeError):                       # mixed dtypes
        FA.flash_fwd_lse(q, k.bfloat16(), k, causal=False)
    with pytest.raises(ValueError):                      # not contiguous
        FA.flash_fwd_lse(q.transpose(1, 2), k, k, causal=False)
    with pytest.raises(TypeError):                       # kv_len must be int32
        FA.decode_attention(q[:, :1], k, k, torch.ones(1, dtype=torch.int64))
    with pytest.raises(ValueError):                      # one query per slot
        FA.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))


def test_cpu_tensors_never_count_launches():
    FA.reset_launch_counts()
    q = torch.randn(2, 5, 6, 16)
    k = torch.randn(2, 5, 2, 16)
    FA.flash_fwd_lse(q, k, k, causal=True)
    FA.decode_attention(q[:, :1].contiguous(), k, k, torch.tensor([3, 5], dtype=torch.int32))
    o, lse = FA.flash_fwd_lse(q, k, k, causal=True)
    di = FREF.attention_di(o, q)
    FA.flash_bwd_dq(q, k, k, q, lse, di, causal=True)
    FA.flash_bwd_dkv(q, k, k, q, lse, di, causal=True)
    assert FA.launch_counts() == {"flash_fwd": 0, "decode_fwd": 0, "flash_bwd_dq": 0,
                                  "flash_bwd_dkv": 0}


def test_wrappers_have_no_backend_switch():
    for name, fn in FA.KERNELS.items():
        params = inspect.signature(fn).parameters
        assert "backend" not in params and not any(p.startswith("block") for p in params), name


def test_plain_versions_use_the_jax_mask_value():
    assert np.float32(FREF.MASK_VALUE) == np.float32(JK.MASK_VALUE)
