"""The code models granite-20b (MQA: 48 query heads over one KV head) and
starcoder2-3b (24 over 2), and the wide-group forms of the decode kernels
they need, against the JAX package on the CPU.

Parameters come from the JAX package's ``init_params`` and cross with
``from_numpy_tree``; batches from ``BigramLM``, kernel inputs and prompts
from seeded numpy. The JAX side is jitted with XLA's excess precision off.

* ``CONFIG``, ``REDUCED`` and ``param_specs`` of both architectures equal
  to JAX's, field for field and leaf for leaf.
* The decode wrappers at query groups 12, 16, 17, 48 and 64 (hd 8 and
  128, one and two KV heads; q bf16 or f32 over a bf16 cache or pool,
  ragged lengths and a dry slot): ``decode_attention`` against JAX's
  ``decode_fwd`` (Pallas, interpreted), ``paged_decode_attention`` and
  ``paged_prefill_attention`` against JAX's paged kernels interpreted and
  its ``xla`` oracle, at ``tests/test_torch_flash_attention.py``'s and
  ``tests/test_torch_paged_kernels.py``'s tolerances; a dry slot gives
  exact zeros. On the CPU the wrappers run their plain versions:
  ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 35 hold the CUDA
  forms against them on the card.
* Loss and every leaf's gradient of both reduced configs, and of the
  reduced granite with 48 heads of 8 (a group of 48 at d_model 128), in
  ``bf16`` and ``int8_switchback``, dense attention: within the MoE model
  tests' tolerances.
* Greedy tokens of the ring and the paged ``ServeEngine`` against the JAX
  engine's: ``int8_switchback`` with f32 compute under dense attention
  (every config), and under ``flash_scan`` (the port's default engine: the
  decode wrappers' plain versions at the wide group; the JAX ring engine
  interprets its Pallas kernels, the JAX paged engine runs its ``xla``
  oracle, ``bf16`` mode as ``tests/test_torch_paged.py`` holds it).
* Two StableAdamW steps of both through the TrainEngine at world 1 (a
  spawned gloo rank) against the JAX engine's (f32 compute, JAX_TOL), and
  granite under ZeRO-3 over a gloo group of 2 against world 1 (the MQA
  ``kv_heads`` leaves of width 1 x 32 split on their ``embed`` dim).
* ``chip_smoke.py`` phase 35's exact launch counts (``code_generate_launches``
  for a ring or paged generate, ``mm_launches`` for a train step) equal the
  wrapper calls of both reduced configs, counted on the CPU with
  FUSED_MAX_CONTRACT lowered so that their widths take the full models'
  two-step forms.
* The serve and train CLIs run both reduced architectures.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as TR
from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ServeConfig as JServe
from repro.configs.base import TrainConfig as JTrain
from repro.core.precision import QuantPolicy as JPolicy
from repro.kernels.flash_attention import ops as JFA
from repro.kernels.paged_attention import ops as JPA
from repro.launch.mesh import make_test_mesh
from repro.models import build as jax_build
from repro.models import transformer as JTF
from repro.models.params import init_params as jax_init_params
from repro.serve import make_serve_engine as jax_engine
from repro.train import make_engine as jax_train_engine
from repro_torch.configs import ALL_ARCHS, get_config, get_reduced_config
from repro_torch.configs.base import ParallelConfig, ServeConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.data import BigramLM
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.paged_attention import ops as PA
from repro_torch.kernels.switchback import ops as KOPS
from repro_torch.models import build
from repro_torch.models import params as PRM
from repro_torch.models import transformer as TTF
from repro_torch.models.params import from_numpy_tree, tree_paths
from repro_torch.serve import make_serve_engine
from repro_torch.train import loss_and_grads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as C  # noqa: E402

torch.set_num_threads(1)

GRANITE, STARCODER = "granite-20b", "starcoder2-3b"
ARCHS = (GRANITE, STARCODER)
# the reduced granite with the full model's group: 48 heads of 8 over one
# KV head at d_model 128
WIDE = "granite-20b-wide"
WIDE_FIELDS = dict(n_heads=48, head_dim=8)
OPTS = {"xla_allow_excess_precision": False}
# kernels: tests/test_torch_flash_attention.py's O_TOL (ring decode) and
# tests/test_torch_paged_kernels.py's TOL (paged), relative to max|o|
DECODE_TOL = {"f32": 2e-6, "bf16": 2.0 ** -7}
PAGED_TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# models: tests/test_torch_moe_model.py's
LOSS_TOL = 1e-3            # relative
GRAD_TOL = (1e-1, 1e-2)    # per leaf (max, mean) |diff| / max|JAX|
# the engine: tests/test_torch_vlm.py's
JAX_TOL = 5e-3             # the engine's steps against the JAX engine's
SELF_TOL = 1e-5            # world 2 against world 1, f32 compute
PARAM_TOL = 1e-5
STEPS, BATCH, SEQ = 2, 4, 16
JPAR = JParallel(mesh_shape=(1, 1), remat="none", attn_impl="dense")
PAR = ParallelConfig(remat="none", attn_impl="dense")
# (group, KV, hd): groups 12 (starcoder2), 16 (one row tile), 17 (a second
# tile of one row), 48 (granite) and 64 (four tiles), hd 8 and 128, one
# and two KV heads
WIDE_SHAPES = [(g, kv, hd) for g in (12, 16, 17, 48, 64) for kv, hd in ((1, 128), (2, 8))]
WIDE_SHAPES += [(12, 2, 128), (48, 1, 8)]

_PARAMS: dict = {}


def _cfgs(which):
    """(JAX config, port config) of an arch's reduced config, or WIDE."""
    arch = GRANITE if which == WIDE else which
    jcfg, tcfg = jax_reduced(arch), get_reduced_config(arch)
    if which == WIDE:
        jcfg = dataclasses.replace(jcfg, **WIDE_FIELDS)
        tcfg = dataclasses.replace(tcfg, **WIDE_FIELDS)
    return jcfg, tcfg


def _setup(which):
    if which not in _PARAMS:
        jcfg, tcfg = _cfgs(which)
        jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
        _PARAMS[which] = (jcfg, tcfg, jp, jax.tree.map(np.asarray, jp))
    return _PARAMS[which]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree) -> dict:
    return {p: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v, np.float64)
            for p, v in tree_paths(tree)}


# ---------------------------------------------------------------------------
# the configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_specs_match_jax(arch):
    assert arch in ALL_ARCHS and len(ALL_ARCHS) == 11
    for mine, theirs in ((get_config(arch), jax_config(arch)),
                         (get_reduced_config(arch), jax_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        want = {jax.tree_util.keystr(k): (s.shape, s.logical, s.init, s.scale)
                for k, s in jax.tree_util.tree_leaves_with_path(
                    JTF.param_specs(theirs), is_leaf=lambda s: hasattr(s, "logical"))}
        got = {p: (s.shape, s.logical, s.init, s.scale)
               for p, s in tree_paths(TTF.param_specs(mine))}
        assert got == want
    full = get_config(arch)
    assert full.n_heads // full.n_kv_heads == {GRANITE: 48, STARCODER: 12}[arch]
    assert full.hd == 128 and full.act == "gelu" and full.norm == "layernorm"


# ---------------------------------------------------------------------------
# the decode wrappers at wide query groups
# ---------------------------------------------------------------------------

def _kernel_inputs(seed, B, Sq, H, KV, hd, S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("group,KV,hd", WIDE_SHAPES)
def test_decode_attention_wide_groups_match_jax(group, KV, hd, dt):
    """The ring decode: 5 slots over 40 cells at lengths 1, 16, 17, 40 and
    0 (dry: exact zeros; JAX's kernel is not asked for a dry slot)."""
    H, S = group * KV, 40
    lens = np.array([1, 16, 17, 40, 0], np.int32)
    q, k, v = _kernel_inputs(group * 10 + hd + KV, len(lens), 1, H, KV, hd, S)
    jdt, tdt = DTYPES[dt]
    o = FA.decode_attention(torch.from_numpy(q).to(tdt), torch.from_numpy(k).bfloat16(),
                            torch.from_numpy(v).bfloat16(), torch.from_numpy(lens))
    assert o.dtype == tdt and tuple(o.shape) == (len(lens), 1, H, hd)
    live = slice(0, 4)
    jo = JFA.decode_attention(jnp.asarray(q[live], jdt), jnp.asarray(k[live], jnp.bfloat16),
                              jnp.asarray(v[live], jnp.bfloat16), jnp.asarray(lens[live]),
                              backend="pallas_interpret")
    assert _rel(o[live].float().numpy(), np.asarray(jo.astype(jnp.float32))) <= DECODE_TOL[dt]
    assert not o[4].float().any()


def _pools(seed, B, Sq, H, KV, hd, bs, nb, dt):
    """q and pools rounded to ``dt``; tables a permutation of the pool's
    blocks, entries past a slot's live blocks at the trash block N."""
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


def _paged_both(jfn, tfn, dt, q, k, v, *rest, **kw):
    jdt, tdt = DTYPES[dt]
    got = tfn(torch.from_numpy(np.ascontiguousarray(q)).to(tdt), torch.from_numpy(k).to(tdt),
              torch.from_numpy(v).to(tdt), *(torch.from_numpy(np.asarray(a)) for a in rest))
    assert got.dtype == tdt
    want = {b: np.asarray(jfn(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                              *(jnp.asarray(a) for a in rest), backend=b).astype(jnp.float32))
            for b in ("pallas_interpret", "xla")}
    return got.float().numpy(), want


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("group,KV,hd", WIDE_SHAPES)
def test_paged_decode_wide_groups_match_jax(group, KV, hd, dt):
    """Blocks of 4: one cell, mid-block, the full table and a dry slot."""
    B, bs, nb = 4, 4, 5
    q, k, v, tables, N = _pools(group + hd + KV, B, 1, group * KV, KV, hd, bs, nb, dt)
    kv_len = np.array([1, (nb - 1) * bs - 1, nb * bs, 0], np.int32)
    tables = _dead_to(tables, kv_len, bs, N)
    got, want = _paged_both(JPA.paged_decode_attention, PA.paged_decode_attention, dt,
                            q, k, v, tables, kv_len)
    for backend, w in want.items():
        live = slice(0, 3) if backend == "xla" else slice(None)   # the oracle's dry row
        assert _rel(got[live], w[live]) <= PAGED_TOL[dt], backend  # is uniform, not 0
    assert not got[3].any()


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("group,KV,hd", WIDE_SHAPES)
def test_paged_prefill_wide_groups_match_jax(group, KV, hd, dt):
    """A fresh chunk, a resumed one off a block edge, one with pad rows, a
    dry slot; and every live row equal to the decode wrapper's at its
    position (the plain versions are the same softmax)."""
    B, Sq, bs, nb = 4, 5, 4, 5
    q, k, v, tables, N = _pools(group * hd + KV, B, Sq, group * KV, KV, hd, bs, nb, dt)
    q_off = np.array([0, 5, bs + 1, 0], np.int32)
    kv_len = np.array([Sq, 5 + Sq, bs + 3, 0], np.int32)          # slot 2: 3 pad rows
    tables = _dead_to(tables, kv_len, bs, N)
    got, want = _paged_both(JPA.paged_prefill_attention, PA.paged_prefill_attention, dt,
                            q, k, v, tables, q_off, kv_len)
    for backend, w in want.items():
        assert _rel(got, w) <= PAGED_TOL[dt], backend
    assert not got[3].any()
    tdt = DTYPES[dt][1]
    for r in range(Sq):
        lens = np.where(kv_len > 0, np.minimum(q_off + r + 1, kv_len), 0).astype(np.int32)
        d = PA.paged_decode_attention(torch.from_numpy(np.ascontiguousarray(q[:, r:r + 1]))
                                      .to(tdt), torch.from_numpy(k).to(tdt),
                                      torch.from_numpy(v).to(tdt), torch.from_numpy(tables),
                                      torch.from_numpy(lens)).float().numpy()
        rows = (q_off + r < kv_len)
        assert _rel(d[rows], got[rows, r:r + 1]) <= PAGED_TOL[dt], r


def test_decode_wrappers_take_wide_groups_and_refuse_past_the_limit():
    """The ring decode takes any group up to FA.MAX_GROUP (128) and refuses
    one past it; the paged decode has no group limit."""
    assert FA.MAX_GROUP == 128 and not hasattr(PA, "MAX_GROUP")
    lens = torch.ones(1, dtype=torch.int32)
    for group in (12, 48, 64, FA.MAX_GROUP):
        q, k = torch.zeros((1, 1, group, 8)), torch.zeros((1, 4, 1, 8))
        assert FA.decode_attention(q, k, k, lens).shape == q.shape
        assert PA.paged_decode_attention(q, k, k, torch.zeros((1, 1), dtype=torch.int32),
                                         lens).shape == q.shape
    q = torch.zeros((1, 1, FA.MAX_GROUP + 1, 8))
    with pytest.raises(ValueError, match="query group 129 > MAX_GROUP = 128"):
        FA.decode_attention(q, k, k, lens)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _batch(vocab, B=BATCH, S=SEQ, seed=0):
    return BigramLM(vocab, seed=seed, temperature=0.3).batch(B, S)


@pytest.mark.parametrize("mode", ["bf16", "int8_switchback"])
@pytest.mark.parametrize("which", [GRANITE, STARCODER, WIDE])
def test_loss_and_grads_match_jax(which, mode):
    jcfg, tcfg, jp, np_params = _setup(which)
    b = _batch(tcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    bundle, policy = jax_build(jcfg), JPolicy(mode)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, x: bundle.loss_fn(p, x, policy, JPAR), has_aux=True)).lower(jp, jb).compile(
            compiler_options=OPTS)(jp, jb)
    tg, tl, tm = loss_and_grads(build(tcfg), QuantPolicy(mode), PAR,
                                from_numpy_tree(np_params, device="cpu"),
                                {k: torch.from_numpy(v).long() for k, v in b.items()})
    assert set(tm) == set(jm)
    assert np.isfinite(float(tl)) and _rel(float(tl), float(jl)) <= LOSS_TOL
    want, got = _flat(jax.tree.map(np.asarray, jg)), _flat(tg)
    assert set(got) == set(want)
    for k, w in want.items():
        d = np.abs(got[k] - w)
        top = np.abs(w).max() or 1.0
        assert d.max() / top <= GRAD_TOL[0] and d.mean() / top <= GRAD_TOL[1], k


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lens]


def _engines(which, cache, impl):
    """Both packages' engines on the same weights, f32 compute: under
    ``dense`` int8_switchback on JAX's xla path; under ``flash_scan`` the
    port's default engine (the plain versions of its attention kernels)
    against JAX's ring engine interpreting its Pallas kernels, or its paged
    engine's xla oracle in bf16 mode."""
    jcfg, tcfg, jp, np_params = _setup(which)
    quant = "bf16" if impl == "flash_scan" and cache == "paged" else "int8_switchback"
    kw = dict(quant_mode=quant, max_batch=2, max_len=32, cache_mode=cache)
    if impl == "dense":
        jpar, backend, par = JPAR, "xla", PAR
    else:
        jpar = JParallel(mesh_shape=(1, 1), remat="none", attn_impl="flash_scan")
        backend, par = ("xla" if cache == "paged" else "pallas_interpret"), None
    jeng = jax_engine(jax_build(jcfg), JServe(**kw), make_test_mesh((1, 1)), parallel=jpar,
                      policy=JPolicy(quant, compute_dtype=jnp.float32, backend=backend))
    teng = make_serve_engine(build(tcfg), ServeConfig(**kw), parallel=par,
                             policy=QuantPolicy(quant, compute_dtype=torch.float32),
                             device="cpu")
    return jeng, teng, jp, from_numpy_tree(np_params, device="cpu"), tcfg


@pytest.mark.parametrize("impl", ["dense", "flash_scan"])
@pytest.mark.parametrize("cache", ["ring", "paged"])
@pytest.mark.parametrize("which", [GRANITE, STARCODER, WIDE])
def test_engine_greedy_tokens_match_jax(which, cache, impl):
    """5 requests through 2 slots (eviction and slot reuse), greedy: the
    same tokens and counts as the JAX engine."""
    jeng, teng, jp, tp, tcfg = _engines(which, cache, impl)
    prompts = _prompts(tcfg.vocab_size, (6, 11, 3, 9, 5))
    jg, js = jeng.generate(jp, prompts, max_new_tokens=5)
    tg, ts = teng.generate(tp, prompts, max_new_tokens=5)
    assert [list(map(int, g)) for g in jg] == tg
    for k in ("new_tokens", "prefill_tokens", "decode_steps", "prefill_calls"):
        assert ts[k] == js[k], k


def test_wide_group_reaches_the_decode_wrappers(monkeypatch):
    """The wide config's decode runs the ring and paged decode wrappers at a
    group of 48 (seen by a wrapper around each)."""
    _, tcfg, _, np_params = _setup(WIDE)
    assert tcfg.n_heads // tcfg.n_kv_heads == 48
    tp = from_numpy_tree(np_params, device="cpu")
    seen = set()
    for cache, mod, name in (("ring", FA, "decode_attention"),
                             ("paged", PA, "paged_decode_attention")):
        fn = getattr(mod, name)

        def spy(q, k, *a, _fn=fn, _name=name):
            seen.add((_name, q.shape[2] // k.shape[2]))
            return _fn(q, k, *a)
        monkeypatch.setattr(mod, name, spy)
        eng = make_serve_engine(build(tcfg), ServeConfig(max_batch=2, max_len=32,
                                                         cache_mode=cache), device="cpu")
        gens, _ = eng.generate(tp, _prompts(tcfg.vocab_size, (4, 7)), max_new_tokens=3)
        assert [len(g) for g in gens] == [3, 3]
    assert seen == {("decode_attention", 48), ("paged_decode_attention", 48)}


# ---------------------------------------------------------------------------
# training through the TrainEngine (spawned gloo ranks)
# ---------------------------------------------------------------------------

def _jax_engine_run(arch, batches):
    """The JAX engine on a (1, 1) mesh (f32 compute): its initial
    parameters (numpy) and (loss, grad norm) a step."""
    tc = JTrain(optimizer="stable_adamw", learning_rate=1e-3, warmup_steps=2, total_steps=100,
                loss_scaler="none", quant_mode="bf16")
    par = JParallel(mesh_shape=(1, 1), mesh_axes=("data", "model"), remat="block")
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    eng = jax_train_engine(jax_build(jax_reduced(arch)), tc, par, make_test_mesh((1, 1)), jb[0],
                           policy=JPolicy("bf16", compute_dtype=jnp.float32))
    state = eng.init_state(0)
    params = jax.tree.map(np.asarray, state.params)
    hist = []
    for b in jb:
        state, m = eng.step(state, eng.shard_batch(b))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return params, hist


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("code_lm_engine")
    out = dict(jax={}, p0={}, batches={})
    jobs1 = []
    for arch in ARCHS:
        batches = [_batch(get_reduced_config(arch).vocab_size, seed=1000 + i)
                   for i in range(STEPS)]
        params, out["jax"][arch] = _jax_engine_run(arch, batches)
        out["p0"][arch], out["batches"][arch] = params, batches
        jobs1.append((TR.Case(arch, (1, 1)), params, batches, None))
    zero3 = TR.Case(GRANITE, (2, 1), (("fsdp", True),))
    jobs1.append((zero3.at((1, 1)), out["p0"][GRANITE], out["batches"][GRANITE], None))
    out["one"] = TR.run_ranks(1, TR.engine_runs, (jobs1,), tmp)[0]
    two = TR.run_ranks(2, TR.engine_runs, ([(zero3, out["p0"][GRANITE],
                                             out["batches"][GRANITE], None)],), tmp)
    assert two[1][0][0] == two[0][0][0]                    # both ranks report the same
    out.update(two=two[0][0], zero3=zero3)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_train_steps_match_jax(arch, engine_runs):
    hist, _ = engine_runs["one"][ARCHS.index(arch)]
    want = engine_runs["jax"][arch]
    assert len(hist) == STEPS and all(np.isfinite(h).all() for h in hist)
    rel = np.abs(np.asarray(hist) - want) / np.abs(np.asarray(want))
    assert rel.max() <= JAX_TOL, (hist, want)


def test_zero3_engine_matches_world_one(engine_runs):
    """granite under fsdp over two gloo ranks: its MQA K/V projections
    ((embed, kv_heads) of 128 x 32, one KV head) split on ``embed`` and
    gathered at ``use_weight``; the losses, grad norms and final parameters
    within world 1's tolerance; world 1 bit for bit the direct step."""
    rules = PRM.default_rules(ParallelConfig(mesh_shape=(2, 1), fsdp=True))
    specs = dict(tree_paths(build(get_reduced_config(GRANITE)).param_specs))
    wk = next(s for p, s in specs.items() if p.endswith("['wk']"))
    assert wk.shape[-1] == get_reduced_config(GRANITE).hd
    assert PRM.logical_to_pspec(wk.logical, rules)[-2] == "data"
    (hist2, params2), (hist1, params1) = engine_runs["two"], engine_runs["one"][2]
    rel = np.abs(np.asarray(hist2) - hist1) / np.abs(np.asarray(hist1))
    assert rel.max() <= SELF_TOL, (hist2, hist1)
    for (path, g), (_, w) in zip(tree_paths(params2), tree_paths(params1)):
        top = float(np.abs(w).max()) or 1.0
        assert float(np.abs(g.astype(np.float64) - w).mean()) / top <= PARAM_TOL, path
    d_losses, d_params = TR._direct(engine_runs["zero3"].at((1, 1)), engine_runs["p0"][GRANITE],
                                    engine_runs["batches"][GRANITE])
    assert [h[0] for h in hist1] == d_losses
    assert all(np.array_equal(g, w) for (_, g), (_, w) in
               zip(tree_paths(params1), tree_paths(d_params)))


# ---------------------------------------------------------------------------
# chip_smoke.py phase 35's launch counts
# ---------------------------------------------------------------------------

# each wrapper's name as the launch counters key it
WRAPPERS = {KOPS: {n: n for n in ("tensor_quantize", "row_quantize", "col_quantize",
                                  "fused_switchback_fwd", "fused_switchback_dgrad",
                                  "int8_matmul_dequant", "int8_matmul_dequant_t")},
            FA: {"flash_fwd_lse": "flash_fwd", "decode_attention": "decode_fwd",
                 "flash_bwd_dq": "flash_bwd_dq", "flash_bwd_dkv": "flash_bwd_dkv"},
            PA: {"paged_decode_attention": "paged_decode_fwd",
                 "paged_prefill_attention": "paged_prefill_fwd"}}


def _counted(monkeypatch) -> dict:
    """Every kernel wrapper counting its calls (on the CPU the wrappers run
    their plain versions and count no launch)."""
    counts: dict = {}
    for mod, names in WRAPPERS.items():
        for fn_name, key in names.items():
            fn = getattr(mod, fn_name)

            def wrapper(*a, _fn=fn, _key=key, **kw):
                counts[_key] = counts.get(_key, 0) + 1
                return _fn(*a, **kw)
            monkeypatch.setattr(mod, fn_name, wrapper)
    return counts


@pytest.mark.parametrize("cache", ["ring", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_phase35_generate_launches_are_the_wrapper_calls(arch, cache, monkeypatch):
    monkeypatch.setattr(KOPS, "FUSED_MAX_CONTRACT", 64)
    counts = _counted(monkeypatch)
    cfg = get_reduced_config(arch)
    for mode in ("int8_switchback", "bf16"):
        eng = make_serve_engine(build(cfg), ServeConfig(
            max_batch=4, max_len=32, cache_mode=cache, quant_mode=mode, block_size=4),
            device="cpu")
        params = eng.init_params(0)
        counts.clear()
        gens, stats = eng.generate(params, _prompts(cfg.vocab_size, (5, 9, 3)),
                                   max_new_tokens=4)
        want = C.code_generate_launches(cfg, stats, cache, mode, 64)
        assert counts == {k: n for k, n in want.items() if n}, mode


@pytest.mark.parametrize("arch", ARCHS)
def test_phase35_train_launches_are_the_wrapper_calls(arch, monkeypatch):
    monkeypatch.setattr(KOPS, "FUSED_MAX_CONTRACT", 64)
    counts = _counted(monkeypatch)
    cfg = get_reduced_config(arch)
    _, _, _, np_params = _setup(arch)
    loss_and_grads(build(cfg), QuantPolicy("int8_switchback"), ParallelConfig(remat="none"),
                   from_numpy_tree(np_params, device="cpu"),
                   {k: torch.from_numpy(v).long() for k, v in _batch(cfg.vocab_size).items()})
    want = C.mm_launches(cfg, "train", 64)
    assert counts == {k: n for k, n in want.items() if n}
    assert "fused_switchback_fwd" not in counts and counts["int8_matmul_dequant"] > 0


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli", ["serve", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_clis_take_the_code_lms(arch, cli):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    args = (["--n-requests", "2", "--new-tokens", "3", "--max-len", "32", "--quant-mode",
             "int8_switchback"] if cli == "serve" else
            ["--steps", "2", "--batch", "2", "--seq", "16", "--quant-mode", "int8_switchback"])
    out = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{cli}", "--arch", arch,
                          "--device", "cpu", *args], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert ("final loss:" if cli == "train" else "tok/s") in out.stdout
