"""The port's paged serving slice against the JAX package's, on the CPU.

* The copied host modules (``BlockPool``, ``RadixPrefixCache``,
  ``PagedCacheManager``, ``NgramProposer``) against the JAX package's on
  the same seeded operation sequences: every return value, every raised
  exception's type, and the pool, table and cache state after each step.
* The model: ``paged_prefill`` (a fresh prefill with one slot not
  admitted, a resumed chunk at an unaligned cursor, and a prefix-adopted
  suffix with ``last_only``) and ``paged_decode_step`` against the JAX
  package's on the reduced smollm-360m, both sides starting from the same
  pools (the paged state is carried across as numpy). The JAX side runs
  its ``xla`` backend (the gather-then-dense oracle) under ``flash_scan``;
  the port its default ``flash_scan`` (the paged kernels' plain versions)
  and ``dense``. Tolerances, relative to max|logit| and as in
  ``tests/test_torch_serve.py``: 1e-5 in f32 compute (the order of sums),
  1e-3 in bf16 with XLA's excess precision off (both round to bf16 at the
  same places; the int8 quantizers absorb last-bit differences). The
  lengths must be equal and the committed pool cells within the same
  tolerance (the trash block, which takes racy writes, left out).
* The engine, token for token against the JAX paged engine (``xla``
  backend, f32 compute, int8_switchback) in the scenarios of
  ``tests/test_paged.py`` and ``tests/test_spec.py``: churn, shared-prefix
  reuse, no prefix cache, a small pool, chunked prefill with preemption, a
  tight pool that preempts, and n-gram speculative decoding (alone and
  under churn). The stats rows must have the same keys and the same value
  for every key that is not a time. On its ``xla`` backend the JAX engine
  attends through the gather-then-dense oracle, so the port runs its
  ``dense`` oracle, which computes it op for op: with int8 quantizers
  after every attention, one f32 ulp of difference (the kernels' online
  or full softmax, the scale before or after the product) can move an
  activation across a rounding step and a random-weight model's greedy
  argmax, whose top two logits lie as close as 5e-4 here. The port's
  default ``flash_scan`` engine is held token for token to the JAX xla
  engine in ``bf16`` mode (no quantizer to amplify an ulp), over churn,
  chunked prefill, preemption and n-gram drafts at once.
* The CLI with ``--cache-mode paged --spec-mode ngram`` on the CPU.

The port's paged prefill is held to the JAX package's ``paged_prefill``,
not bit for bit to the ring prefill (that reference test fails on jax
0.9.0, ROADMAP Queue 3).
"""
from __future__ import annotations

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ServeConfig as JServe
from repro.core.precision import QuantPolicy as JPolicy
from repro.launch.mesh import make_test_mesh
from repro.models import build as jax_build
from repro.models import transformer as JTF
from repro.models.params import init_params as jax_init_params
from repro.serve import BlockPool as JBlockPool
from repro.serve import NgramProposer as JNgram
from repro.serve import PagedCacheManager as JManager
from repro.serve import RadixPrefixCache as JRadix
from repro.serve import make_serve_engine as jax_engine
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ParallelConfig, ServeConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.models import build
from repro_torch.models import transformer as TTF
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.params import from_numpy_tree
from repro_torch.serve import (BlockPool, NgramProposer, PagedCacheManager,
                               RadixPrefixCache, make_serve_engine)

torch.set_num_threads(1)

ARCH = "smollm-360m"


# ---------------------------------------------------------------------------
# the copied host modules
# ---------------------------------------------------------------------------

def _both(a, b, name, *args, **kw):
    """Call ``name`` on the JAX object ``a`` and the port's ``b``: the same
    result, or the same exception type."""
    out = []
    for obj in (a, b):
        try:
            out.append(("ok", getattr(obj, name)(*args, **kw)))
        except Exception as e:                       # noqa: BLE001 - compared below
            out.append(("raised", type(e).__name__))
    assert out[0] == out[1], (name, args, out)
    return out[1]


def test_block_pool_matches_jax():
    """Alloc / retain / release churn with double frees and foreign ids."""
    a, b = JBlockPool(8), BlockPool(8)
    rng = np.random.default_rng(0)
    held = []
    for _ in range(300):
        op = rng.integers(0, 4)
        if op == 0:
            kind, bid = _both(a, b, "alloc")
            if kind == "ok":
                held.append(bid)
        elif op == 1 and held:
            _both(a, b, "retain", held[rng.integers(len(held))])
        elif op == 2 and held:
            _both(a, b, "release", held.pop(rng.integers(len(held))))
        else:                                        # any id: may double free
            _both(a, b, "release", int(rng.integers(0, 9)))
        assert (a.free, a.in_use) == (b.free, b.in_use)
        assert [a.refcount(i) for i in range(8)] == [b.refcount(i) for i in range(8)]


def test_radix_prefix_cache_matches_jax():
    """Insert / adopt / release / evict interleavings on a shared-prefix
    vocabulary of 3 tokens: matches, evictions and the evictable count."""
    (pa, pb) = JBlockPool(64), BlockPool(64)
    ca, cb = JRadix(pa, 2), RadixPrefixCache(pb, 2)
    rng = np.random.default_rng(7)
    adopted = []
    for _ in range(200):
        op = rng.integers(0, 4)
        if op == 0 and pa.free >= 4:                 # park a chain
            n = int(rng.integers(1, 5))
            toks = rng.integers(0, 3, size=2 * n).tolist()
            _, have = _both(ca, cb, "match", toks, max_blocks=n)
            fresh = [_both(pa, pb, "alloc")[1] for _ in range(n - len(have))]
            _both(ca, cb, "insert", toks, have + fresh)
            for bid in have + fresh:
                _both(pa, pb, "release", bid)
        elif op == 1:                                # adopt and hold
            toks = rng.integers(0, 3, size=2 * int(rng.integers(1, 5))).tolist()
            adopted.extend(_both(ca, cb, "match", toks, max_blocks=4)[1])
            _both(ca, cb, "match_len", toks, max_blocks=4)
        elif op == 2 and adopted:                    # an adopter finishes
            _both(pa, pb, "release", adopted.pop(rng.integers(len(adopted))))
        else:
            _both(ca, cb, "evict", int(rng.integers(1, 3)))
        assert (ca.evictable, ca.n_nodes, pa.free) == (cb.evictable, cb.n_nodes, pb.free)


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("preemption", [False, True])
def test_paged_cache_manager_matches_jax(prefix_cache, preemption):
    """A seeded admission / decode-growth / rollback / release sequence over
    3 slots and 12 blocks of 2 tokens: every return and exception alike,
    and the block tables, stats and live blocks after every step."""
    kw = dict(prefix_cache=prefix_cache, preemption=preemption)
    a, b = JManager(12, 2, 3, 6, **kw), PagedCacheManager(12, 2, 3, 6, **kw)
    rng = np.random.default_rng(11 + 2 * prefix_cache + preemption)
    slots = {}                                       # slot -> tokens written
    for _ in range(400):
        op = rng.integers(0, 4)
        free = [s for s in range(3) if s not in slots]
        if op == 0 and free:
            prompt = rng.integers(0, 3, size=int(rng.integers(1, 9))).tolist()
            new = int(rng.integers(1, 5))
            a.begin_wave()
            b.begin_wave()
            kind, ok = _both(a, b, "fits", len(prompt), new, prompt=prompt)
            if kind == "ok" and ok:
                _both(a, b, "admit", free[0], prompt, new)
                slots[free[0]] = prompt
        elif op == 1 and slots:
            s = list(slots)[rng.integers(len(slots))]
            if len(slots[s]) < 12:
                kind, _ = _both(a, b, "ensure_block", s, len(slots[s]))
                if kind == "ok":
                    slots[s] = slots[s] + [int(rng.integers(0, 3))]
        elif op == 2 and slots:
            s = list(slots)[rng.integers(len(slots))]
            keep = int(rng.integers(1, len(slots[s]) + 1))
            _both(a, b, "rollback", s, keep)
            slots[s] = slots[s][:keep]
        elif slots:
            s = list(slots)[rng.integers(len(slots))]
            _both(a, b, "release", s, slots.pop(s))
        np.testing.assert_array_equal(a.tables, b.tables)
        assert a.stats() == b.stats() and a.live_blocks == b.live_blocks
        assert a.peak_in_use == b.peak_in_use and a.pool.free == b.pool.free


def test_admission_wave_counts_adoption_pins():
    """The port's one repair to the copied manager: two promises in one
    admission wave may not both count the parked blocks the first one will
    pin by adopting them. Two parked blocks, two free ones: A adopts both
    parked blocks and needs one fresh; B needs three fresh. The JAX
    package promises B too and its admission then finds the pool empty;
    the port turns B away for this wave."""
    def wave(m):
        m.begin_wave()
        m.admit(0, [1, 2, 3, 4, 5], max_new_tokens=1)
        m.release(0, [1, 2, 3, 4, 5])                # parks [1, 2] and [3, 4]
        m.begin_wave()
        a, b = [1, 2, 3, 4, 9], [7, 7, 7, 7, 7]
        return m.fits(5, 1, prompt=a), m.fits(5, 1, prompt=b), a, b

    kw = dict(num_blocks=4, block_size=2, max_batch=2, blocks_per_slot=4, preemption=True)
    ja, jb, a, b = wave(JManager(**kw))
    assert ja and jb                                 # the reference promises both
    jm = JManager(**kw)
    wave(jm)
    jm.admit(0, a, max_new_tokens=1)
    with pytest.raises(Exception, match="exhausted"):
        jm.admit(1, b, max_new_tokens=1)
    m = PagedCacheManager(**kw)
    ta, tb, _, _ = wave(m)
    assert ta and not tb
    assert m.admit(0, a, max_new_tokens=1) == 4      # adopted, and the pool holds
    m.begin_wave()
    assert not m.fits(5, 1, prompt=b)                # one free block: B waits


def test_ngram_proposer_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(300):
        max_ngram = int(rng.integers(1, 5))
        kw = dict(k=int(rng.integers(1, 6)), max_ngram=max_ngram,
                  min_ngram=int(rng.integers(1, max_ngram + 1)))
        hist = rng.integers(0, 4, size=int(rng.integers(0, 30))).tolist()
        cap = int(rng.integers(0, 7))
        assert JNgram(**kw).propose(hist, cap) == NgramProposer(**kw).propose(hist, cap)
    for bad in (dict(k=0), dict(max_ngram=2, min_ngram=3), dict(min_ngram=0)):
        full = {**dict(k=2, max_ngram=3, min_ngram=1), **bad}
        kinds = []
        for cls in (JNgram, NgramProposer):
            try:
                cls(**full)
                kinds.append(None)
            except Exception as e:                   # noqa: BLE001
                kinds.append(type(e).__name__)
        assert kinds[0] == kinds[1], (bad, kinds)


# ---------------------------------------------------------------------------
# the model: paged prefill and decode
# ---------------------------------------------------------------------------

_PARAMS: dict = {}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CASES = {"f32": 1e-5, "bf16": 1e-3}                  # excess precision off


def _setup():
    if not _PARAMS:
        jcfg, tcfg = jax_reduced(ARCH), get_reduced_config(ARCH)
        jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
        _PARAMS["x"] = (jcfg, tcfg, jp, from_numpy_tree(jax.tree.map(np.asarray, jp),
                                                         device="cpu"))
    return _PARAMS["x"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def to_port_state(jstate) -> dict:
    """The JAX paged state -> the port's (numpy in between)."""
    def tensor(x):
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return {k: PagedKVCache(tensor(st.k), tensor(st.v), tensor(st.length))
            for k, st in jstate.items()}


def to_jax_state(tstate) -> dict:
    """The port's paged state -> the JAX package's."""
    from repro.models.attention import PagedKVCache as JPaged

    def arr(t):
        return (jnp.asarray(t.float().numpy(), jnp.bfloat16) if t.dtype == torch.bfloat16
                else jnp.asarray(t.numpy()))
    return {k: JPaged(arr(st.k), arr(st.v), arr(st.length)) for k, st in tstate.items()}


def _pools_close(tstate, jstate, tol, cells):
    """Lengths equal; the pool cells in ``cells`` (block ids) within tol."""
    for key, jst in jstate.items():
        tst = tstate[key]
        np.testing.assert_array_equal(tst.length.numpy(), np.asarray(jst.length))
        for t, j in ((tst.k, jst.k), (tst.v, jst.v)):
            assert _rel(t.float().numpy()[:, cells], np.asarray(j, np.float32)[:, cells]) <= tol


@pytest.mark.parametrize("impl", ["flash_scan", "dense"])
@pytest.mark.parametrize("dt", list(CASES))
def test_paged_prefill_and_decode_match_jax(dt, impl):
    """Both packages from the same pool: a fresh prefill (slot 2 not
    admitted), a resumed chunk at an unaligned cursor with last_only, then
    three decode steps; logits, lengths and the committed pool cells."""
    jcfg, tcfg, jp, tp = _setup()
    jdt, tdt = DTYPES[dt]
    tol = CASES[dt]
    jpol = JPolicy("int8_switchback", compute_dtype=jdt)
    tpol = QuantPolicy("int8_switchback", compute_dtype=tdt)
    jpar = JParallel(mesh_shape=(1, 1), remat="none")
    par = ParallelConfig(remat="none", attn_impl=impl)
    opts = {"xla_allow_excess_precision": False}
    B, bs, nb = 3, 4, 5
    rng = np.random.default_rng(3)
    tables = rng.permutation(B * nb + 2)[:B * nb].reshape(B, nb).astype(np.int32)
    cells = np.sort(tables.reshape(-1))               # every slot's blocks, no trash
    jst = JTF.init_paged_serve_state(jcfg, B * nb + 2, bs, B, dtype=jnp.bfloat16)
    tst = to_port_state(jst)
    jpre = functools.partial(JTF.paged_prefill, cfg=jcfg, policy=jpol, parallel=jpar)

    def both_prefill(toks, pref, lens, admit, last_only):
        nonlocal jst, tst
        args = [jnp.asarray(a) for a in (tables, toks, pref, lens, admit)]
        jlg, jst = jax.jit(functools.partial(jpre, last_only=last_only),
                           compiler_options=opts)(jp, jst, *args)
        with torch.inference_mode():
            tlg, tst = TTF.paged_prefill(tp, tst, *(torch.from_numpy(np.asarray(a)) for a in
                                                    (tables, toks.astype(np.int64), pref, lens,
                                                     admit)),
                                         tcfg, tpol, par, last_only=last_only)
        return np.asarray(jlg.astype(jnp.float32)), tlg.float().numpy()

    toks = rng.integers(0, jcfg.vocab_size, size=(B, 8)).astype(np.int32)
    lens = np.array([8, 5, 3], np.int32)
    admit = np.array([True, True, False])
    jlg, tlg = both_prefill(toks, np.zeros(B, np.int32), lens, admit, False)
    for b in (0, 1):
        assert _rel(tlg[b, :lens[b]], jlg[b, :lens[b]]) <= tol
    _pools_close(tst, jst, tol, cells)
    # resume: slot 0 from its cursor 8 (mid-block) by 7, slot 2 from 0 by 3
    toks2 = rng.integers(0, jcfg.vocab_size, size=(B, 8)).astype(np.int32)
    pref = np.array([8, 0, 0], np.int32)
    lens2 = np.array([15, 5, 3], np.int32)
    admit2 = np.array([True, False, True])
    jlg, tlg = both_prefill(toks2, pref, lens2, admit2, True)
    assert tlg.shape == (B, 1, jcfg.vocab_size)
    assert _rel(tlg[admit2], jlg[admit2]) <= tol
    _pools_close(tst, jst, tol, cells)
    jdec = jax.jit(functools.partial(JTF.paged_decode_step, cfg=jcfg, policy=jpol,
                                     parallel=jpar), compiler_options=opts)
    for _ in range(3):
        step = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        jlg, jst = jdec(jp, jst, jnp.asarray(tables), jnp.asarray(step))
        with torch.inference_mode():
            tlg, tst = TTF.paged_decode_step(tp, tst, torch.from_numpy(tables),
                                             torch.from_numpy(step).long(), tcfg, tpol, par)
        assert _rel(tlg.float().numpy(), np.asarray(jlg.astype(jnp.float32))) <= tol
    _pools_close(tst, jst, tol, cells)
    # and the state carried back: the JAX package decodes on from the port's
    jlg_back, _ = jdec(jp, to_jax_state(tst), jnp.asarray(tables), jnp.asarray(step))
    jlg_own, _ = jdec(jp, jst, jnp.asarray(tables), jnp.asarray(step))
    assert _rel(np.asarray(jlg_back, np.float32), np.asarray(jlg_own, np.float32)) <= tol


def test_prefix_adoption_matches_jax_and_full_prefill():
    """A suffix prefilled on top of two adopted blocks (pref 8, last_only)
    gives the full prompt's last logits, on both packages (f32)."""
    jcfg, tcfg, jp, tp = _setup()
    jpol = JPolicy("int8_switchback", compute_dtype=jnp.float32)
    tpol = QuantPolicy("int8_switchback", compute_dtype=torch.float32)
    jpar, par = JParallel(mesh_shape=(1, 1), remat="none"), ParallelConfig(remat="none")
    tables = np.arange(4, dtype=np.int32)[None]
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab_size, size=10).astype(np.int32)
    jst = JTF.init_paged_serve_state(jcfg, 4, 4, 1, dtype=jnp.float32)
    tst = to_port_state(jst)
    out = {}
    for name, toks, pref in (("full", prompt[None], 0),
                             ("adopt", np.pad(prompt[8:], (0, 2))[None], 8)):
        a = (tables, toks, np.array([pref], np.int32), np.array([10], np.int32),
             np.array([True]))
        jlg, jst = JTF.paged_prefill(jp, jst, *(jnp.asarray(x) for x in a), jcfg, jpol,
                                     jpar, last_only=True)
        with torch.inference_mode():
            tlg, tst = TTF.paged_prefill(tp, tst, *(torch.from_numpy(np.asarray(x)) for x in
                                                    (a[0], a[1].astype(np.int64), *a[2:])),
                                         tcfg, tpol, par, last_only=True)
        out[name] = (np.asarray(jlg), tlg.numpy())
        assert _rel(out[name][1], out[name][0]) <= CASES["f32"]
    assert _rel(out["adopt"][1], out["full"][1]) <= CASES["f32"]


# ---------------------------------------------------------------------------
# the engine, token for token
# ---------------------------------------------------------------------------

TIMES = ("wall_s", "prefill_s", "decode_s", "tokens_per_s", "decode_tokens_per_s")


def _not_times(stats: dict) -> dict:
    return {k: v for k, v in stats.items()
            if k not in TIMES and not k.endswith(("_p50_s", "_p95_s"))}


def _generate(prompts, max_new, quant="int8_switchback", impl="dense", **kw):
    """Both packages' paged engines on the same weights, f32 compute, the
    port under ``impl``: the same tokens and non-time stats. Returns the
    port's (generations, stats)."""
    jcfg, tcfg, jp, tp = _setup()
    scfg = dict(cache_mode="paged", quant_mode=quant, **kw)
    jeng = jax_engine(jax_build(jcfg), JServe(**scfg), make_test_mesh((1, 1)),
                      policy=JPolicy(quant, compute_dtype=jnp.float32, backend="xla"))
    teng = make_serve_engine(build(tcfg), ServeConfig(**scfg),
                             parallel=ParallelConfig(remat="none", attn_impl=impl),
                             policy=QuantPolicy(quant, compute_dtype=torch.float32),
                             device="cpu")
    jg, js = jeng.generate(jp, prompts, max_new_tokens=max_new)
    tg, ts = teng.generate(tp, prompts, max_new_tokens=max_new)
    assert [list(map(int, g)) for g in jg] == tg
    assert set(ts) == set(js)
    assert _not_times(ts) == _not_times(js)
    return tg, ts


def _random_prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in lens]


def _repetitive_prompts(n=4, period=3, lo=10):
    pat = np.random.default_rng(0).integers(0, 256, size=period).tolist()
    return [(pat * 8)[:lo + i] for i in range(n)]


def test_engine_churn_matches_jax():
    """7 mixed-length requests through 2 slots: admission and eviction
    waves, prefix parking and adoption."""
    _, s = _generate(_random_prompts(0, (6, 9, 3, 7, 5, 12, 4)), 5,
                     max_batch=2, max_len=32, block_size=4)
    assert s["prefill_calls"] >= 3 and s["peak_cache_bytes"] <= s["ring_equiv_cache_bytes"]


def test_engine_shared_prefix_reuse_matches_jax():
    rng = np.random.default_rng(1)
    sysp = rng.integers(0, 256, size=16).tolist()
    prompts = [sysp + rng.integers(0, 256, size=3).tolist() for _ in range(6)]
    _, s = _generate(prompts, 4, max_batch=2, max_len=48, block_size=4)
    assert s["prefix_hits"] > 0 and s["prefill_tokens_saved"] > 0


def test_engine_no_prefix_cache_matches_jax():
    _, s = _generate(_random_prompts(2, (5, 5, 5, 5)), 4, max_batch=2, max_len=32,
                     block_size=4, prefix_cache=False)
    assert s["prefix_lookups"] == 0


def test_engine_small_pool_matches_jax():
    """8 blocks for 3 slots of 32: admission waits for blocks (bf16 mode)."""
    g, s = _generate(_random_prompts(3, (6, 6, 6, 6)), 5, quant="bf16", max_batch=3,
                     max_len=32, block_size=4, num_blocks=8)
    assert all(len(x) == 5 for x in g) and s["peak_blocks_in_use"] <= 8


def test_engine_chunked_prefill_with_preemption_matches_jax():
    _, s = _generate(_random_prompts(6, (20, 3, 17, 4, 9, 5)), 6, max_batch=3, max_len=32,
                     block_size=4, prefill_chunk_tokens=6, preemption="recompute")
    assert s["prefill_chunks"] > 6


def test_engine_tight_pool_preemption_matches_jax():
    g, s = _generate(_random_prompts(8, (10, 10)), 20, max_batch=2, max_len=32,
                     block_size=4, num_blocks=8, preemption="recompute")
    assert s["sched_preempted"] >= 1 and all(len(x) == 20 for x in g)


@pytest.mark.parametrize("churn", [False, True], ids=["plain", "churn"])
def test_engine_ngram_spec_matches_jax(churn):
    """Repetitive prompts: drafts are accepted (more than one token per
    model pass); under churn with chunked prefill, preemption and a small
    pool too."""
    kw = (dict(prefill_chunk_tokens=6, preemption="recompute", num_blocks=14, spec_k=3)
          if churn else dict(spec_k=4))
    _, s = _generate(_repetitive_prompts(n=5 if churn else 4), 12, max_batch=2, max_len=48,
                     block_size=4, spec_mode="ngram", spec_min_ngram=1, **kw)
    assert s["spec_accepted"] > 0 and s["spec_verify_calls"] > 0
    assert s["tokens_per_model_pass"] > 1.0


def test_flash_engine_matches_jax_in_bf16_mode():
    """The port's default engine (the paged kernels' plain versions) in
    ``bf16`` mode: churn through 2 slots with chunked prefill, preemption
    on a small pool and n-gram drafts, token for token."""
    _, s = _generate(_repetitive_prompts(n=5) + _random_prompts(9, (13, 4)), 10,
                     quant="bf16", impl="flash_scan", max_batch=2, max_len=48, block_size=4,
                     prefill_chunk_tokens=6, preemption="recompute", num_blocks=14,
                     spec_mode="ngram", spec_k=3, spec_min_ngram=1)
    assert s["spec_accepted"] > 0 and s["prefill_chunks"] > 7


def test_paged_stats_keys_on_an_empty_generate():
    jcfg, tcfg, jp, tp = _setup()
    scfg = dict(cache_mode="paged", max_batch=2, max_len=16)
    jeng = jax_engine(jax_build(jcfg), JServe(**scfg), make_test_mesh((1, 1)))
    teng = make_serve_engine(build(tcfg), ServeConfig(**scfg), device="cpu")
    (jg, js), (tg, ts) = (e.generate(p, [[1, 2]], max_new_tokens=0)
                          for e, p in ((jeng, jp), (teng, tp)))
    assert tg == jg == [[]] and set(ts) == set(js) and _not_times(ts) == _not_times(js)


def test_engine_geometry_matches_jax():
    """num_blocks (auto and given), the table width and the byte counts."""
    jcfg, tcfg, _, _ = _setup()
    for kw in (dict(), dict(num_blocks=9, block_size=8)):
        scfg = dict(cache_mode="paged", max_batch=3, max_len=40, **kw)
        jeng = jax_engine(jax_build(jcfg), JServe(**scfg), make_test_mesh((1, 1)))
        teng = make_serve_engine(build(tcfg), ServeConfig(**scfg), device="cpu")
        for k in ("num_blocks", "blocks_per_slot", "block_bytes", "ring_equiv_cache_bytes"):
            assert getattr(teng, k) == getattr(jeng, k), k


def test_serve_cli_paged_smoke():
    """``python -m repro_torch.launch.serve --cache-mode paged --spec-mode
    ngram`` with chunked prefill and preemption on the CPU: exit 0 and the
    JAX CLI's paged, slo and spec lines."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--quant-mode", "int8_switchback", "--cache-mode", "paged", "--block-size", "4",
         "--prefill-chunk-tokens", "8", "--preemption", "recompute", "--spec-mode", "ngram",
         "--spec-min-ngram", "1", "--n-requests", "4", "--new-tokens", "8", "--max-len", "32"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert "paged blocks" in lines[0]
    for head, fields in (("[serve] paged:", ("prefix hits", "prefill tokens saved", "MB ring")),
                         ("[serve] slo:", ("prefill chunks", "preemptions")),
                         ("[serve] spec:", ("drafts accepted", "verify calls",
                                            "tokens per model pass"))):
        got = [ln for ln in lines if ln.startswith(head)]
        assert len(got) == 1 and all(f in got[0] for f in fields), (head, lines)
