"""The mixture-of-experts family and fp16/fp32 serving, model level, against
the JAX package on the CPU.

Parameters come from the JAX package's ``init_params`` and cross with
``from_numpy_tree``; batches and prompts from seeded numpy. The JAX side is
jitted with XLA's excess precision off (``tests/test_torch_train.py``).

* Loss, ``moe_aux`` and the gradient of every leaf of the reduced
  qwen3-moe-30b-a3b (bf16 and ``int8_switchback``), arctic-480b (its dense
  residual MLP beside the experts) and the dense minitron-8b
  (``int8_switchback``), dense attention: loss and aux within LOSS_TOL,
  each leaf's gradient within GRAD_TOL of its max (the train tests' bound
  for the xla backend, where an activation can take the other side of a
  rounding).
* Two ``make_train_step`` steps of the reduced qwen3 in ``int8_switchback``
  against the JAX step: losses, grad norms and the final parameters within
  ``tests/test_torch_train.py``'s tolerances, the same metric keys
  (``moe_aux`` among them).
* The ``ServeEngine`` on the reduced qwen3, ring and paged caches,
  ``int8_switchback`` with f32 compute (where no rounding flip can decide
  an argmax, as in ``tests/test_torch_serve.py``): greedy tokens and the
  stats equal to the JAX engine's; ``serve_prefill`` and ``decode_step``
  logits within SERVE_TOL.
* fp16 and fp32 serving of the reduced smollm-360m: served ``fp16`` is the
  ``bf16`` computation bit for bit in both packages (bf16 compute, as the
  JAX engine builds its policy); ``fp32`` (f32 linears on bf16-rounded
  weights over the bf16 cache) held to the JAX package's prefill and
  decode logits within FP32_TOL and its greedy tokens; an explicit
  f16-compute policy raises, citing ROADMAP.md Queue 1 #14.
* The quant-health scalars read the 3-D expert weights as the JAX package
  does; every family builds and #9's code models are in the registry;
  both CLIs take the new archs.
"""
from __future__ import annotations

import dataclasses
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
from repro.configs.base import TrainConfig as JTrain
from repro.core.precision import QuantPolicy as JPolicy
from repro.launch.mesh import make_test_mesh
from repro.models import build as jax_build
from repro.models import transformer as JTF
from repro.models.params import init_params as jax_init_params
from repro.serve import make_serve_engine as jax_engine
from repro.telemetry import health as JH
from repro.train import train_step as JTS
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ParallelConfig, ServeConfig, TrainConfig
from repro_torch.core.precision import FP16, QuantPolicy
from repro_torch.data import BigramLM
from repro_torch.models import build
from repro_torch.models import transformer as TTF
from repro_torch.models.params import from_numpy_tree, tree_paths
from repro_torch.serve import make_serve_engine
from repro_torch.telemetry import health as TH
from repro_torch.train import init_train_state, loss_and_grads, make_train_setup, make_train_step

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QWEN = "qwen3-moe-30b-a3b"
OPTS = {"xla_allow_excess_precision": False}
LOSS_TOL = 1e-3            # loss and aux, relative
GRAD_TOL = (1e-1, 1e-2)    # per leaf (max, mean) |diff| / max|JAX|: test_torch_train's xla bound
GNORM_TOL = 1e-2
PARAM_MEAN_TOL = 2e-3
SERVE_TOL = 1e-5           # f32 compute: sums in another order (test_torch_serve)
FP32_TOL = 1e-3            # fp32 serving: bf16 weights and cache, f32 sums in another order
CACHE_TOL = 2.0 ** -7      # fp32 serving's bf16 cache: an f32 k on the other side of a rounding
JPAR = JParallel(mesh_shape=(1, 1), remat="none", attn_impl="dense")
# fp32 serving: the JAX package's scan over layer groups refuses a carry
# whose dtype changes (the bf16 embedding becomes f32 after the first f32
# linear), so its fp32 side runs the same layers as a Python loop, as the
# port always does (ROADMAP.md Queue 3)
JPAR_LOOP = dataclasses.replace(JPAR, scan_layers=False)
PAR = ParallelConfig(remat="none", attn_impl="dense")

_PARAMS: dict = {}


def _setup(arch):
    if arch not in _PARAMS:
        jcfg, tcfg = jax_reduced(arch), get_reduced_config(arch)
        jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
        _PARAMS[arch] = (jcfg, tcfg, jp, jax.tree.map(np.asarray, jp))
    return _PARAMS[arch]


def _flat(tree) -> dict:
    return {p: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v, np.float64)
            for p, v in tree_paths(tree)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))


def _batch(vocab, B=4, S=16, seed=0):
    return BigramLM(vocab, seed=seed, temperature=0.3).batch(B, S)


@pytest.mark.parametrize("arch,mode", [(QWEN, "bf16"), (QWEN, "int8_switchback"),
                                       ("arctic-480b", "int8_switchback"),
                                       ("minitron-8b", "int8_switchback")])
def test_loss_and_grads_match_jax(arch, mode):
    jcfg, tcfg, jp, np_params = _setup(arch)
    b = _batch(tcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    bundle, policy = jax_build(jcfg), JPolicy(mode)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, x: bundle.loss_fn(p, x, policy, JPAR), has_aux=True)).lower(jp, jb).compile(
            compiler_options=OPTS)(jp, jb)
    tg, tl, tm = loss_and_grads(build(tcfg), QuantPolicy(mode), PAR,
                                from_numpy_tree(np_params, device="cpu"),
                                {k: torch.from_numpy(v).long() for k, v in b.items()})
    assert set(tm) == set(jm) == {"ce", "moe_aux"}
    assert _rel(float(tl), float(jl)) <= LOSS_TOL
    if tcfg.moe is not None:
        assert float(tm["moe_aux"]) > 0
        assert _rel(float(tm["moe_aux"]), float(jm["moe_aux"])) <= LOSS_TOL
    else:
        assert float(tm["moe_aux"]) == 0.0
    want, got = _flat(jax.tree.map(np.asarray, jg)), _flat(tg)
    assert set(got) == set(want)
    for k, w in want.items():
        d = np.abs(got[k] - w)
        top = np.abs(w).max() or 1.0
        assert d.max() / top <= GRAD_TOL[0] and d.mean() / top <= GRAD_TOL[1], k


def test_train_steps_match_jax():
    mode, n = "int8_switchback", 2
    jcfg, tcfg, jp, np_params = _setup(QWEN)
    batches = [_batch(tcfg.vocab_size, seed=s) for s in range(n)]
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=n, quant_mode=mode)
    jtc = JTrain(**kw)
    opt, scaler = JTS.make_train_setup(jtc)
    jstep = jax.jit(JTS.make_train_step(jax_build(jcfg), JPolicy(mode), JPAR, jtc, opt, scaler))
    jstate = JTS.init_train_state(jp, opt, scaler)
    tc = TrainConfig(**kw)
    topt, tscaler = make_train_setup(tc)
    tstep = make_train_step(build(tcfg), QuantPolicy(mode), PAR, tc, topt, tscaler)
    tstate = init_train_state(from_numpy_tree(np_params, device="cpu"), topt, tscaler)
    compiled = None
    for b in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        compiled = compiled or jstep.lower(jstate, jb).compile(compiler_options=OPTS)
        jstate, jm = compiled(jstate, jb)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v).long() for k, v in b.items()})
        assert _rel(float(tm["loss"]), float(jm["loss"])) <= LOSS_TOL
        assert _rel(float(tm["grad_norm"]), float(jm["grad_norm"])) <= GNORM_TOL
        assert _rel(float(tm["moe_aux"]), float(jm["moe_aux"])) <= LOSS_TOL
    assert set(tm) == set(jm)
    want, got = _flat(jax.tree.map(np.asarray, jstate.params)), _flat(tstate.params)
    for k, w in want.items():
        assert np.abs(got[k] - w).mean() / (np.abs(w).max() or 1.0) <= PARAM_MEAN_TOL, k


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lens]


@pytest.mark.parametrize("cache", ["ring", "paged"])
def test_moe_engine_greedy_tokens_match_jax(cache):
    """5 requests through 2 slots (eviction and slot reuse; the idle slot
    rides in every decode batch and takes capacity as in the JAX engine)."""
    jcfg, tcfg, jp, np_params = _setup(QWEN)
    kw = dict(quant_mode="int8_switchback", max_batch=2, max_len=32, cache_mode=cache)
    jeng = jax_engine(jax_build(jcfg), JServe(**kw), make_test_mesh((1, 1)), parallel=JPAR,
                      policy=JPolicy("int8_switchback", compute_dtype=jnp.float32))
    teng = make_serve_engine(build(tcfg), ServeConfig(**kw), parallel=PAR,
                             policy=QuantPolicy("int8_switchback", compute_dtype=torch.float32),
                             device="cpu")
    prompts = _prompts(tcfg.vocab_size, (6, 11, 3, 9, 5))
    jg, js = jeng.generate(jp, prompts, max_new_tokens=5)
    tg, ts = teng.generate(from_numpy_tree(np_params, device="cpu"), prompts, max_new_tokens=5)
    assert [list(map(int, g)) for g in jg] == tg
    for k in ("new_tokens", "prefill_tokens", "decode_steps", "prefill_calls"):
        assert ts[k] == js[k], k


def _prefill_decode(arch, mode, tol, compute=None, jpar=JPAR, cache_tol=None):
    """serve_prefill over padded prompts (one slot not admitted), then 3
    decode steps: the logits at every valid position, the cache lengths
    and K/V (within ``cache_tol``, default ``tol``). Returns the port's
    logits."""
    jcfg, tcfg, jp, np_params = _setup(arch)
    jpol = JPolicy(mode) if compute is None else JPolicy(mode, compute_dtype=compute[0])
    tpol = QuantPolicy(mode) if compute is None else QuantPolicy(mode, compute_dtype=compute[1])
    j_prefill = jax.jit(functools.partial(JTF.serve_prefill, cfg=jcfg, policy=jpol,
                                          parallel=jpar), compiler_options=OPTS)
    j_decode = jax.jit(functools.partial(JTF.decode_step, cfg=jcfg, policy=jpol,
                                         parallel=jpar), compiler_options=OPTS)
    tp = from_numpy_tree(np_params, device="cpu")
    rng = np.random.default_rng(7)
    B, S, S_max = 3, 8, 16
    toks = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([8, 5, 3], np.int32)
    admit = np.array([True, True, False])
    jlg, jst = j_prefill(jp, JTF.init_serve_state(jcfg, B, S_max), jnp.asarray(toks),
                         jnp.asarray(lens), jnp.asarray(admit))
    tst = TTF.init_serve_state(tcfg, B, S_max, device="cpu")
    out = []
    with torch.inference_mode():
        tlg, tst = TTF.serve_prefill(tp, tst, torch.from_numpy(toks).long(),
                                     torch.from_numpy(lens), torch.from_numpy(admit),
                                     tcfg, tpol, PAR)
    out.append(tlg)
    for b in np.flatnonzero(admit):
        assert _rel(tlg[b, :lens[b]].float(), np.asarray(jlg[b, :lens[b]], np.float32)) <= tol
    for _ in range(3):
        step = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        jlg, jst = j_decode(jp, jst, jnp.asarray(step))
        with torch.inference_mode():
            tlg, tst = TTF.decode_step(tp, tst, torch.from_numpy(step).long(), tcfg, tpol, PAR)
        out.append(tlg)
        assert _rel(tlg.float(), np.asarray(jlg, np.float32)) <= tol
    jc, tc = jst["pos0"], tst["pos0"]
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    assert _rel(tc.k.float(), np.asarray(jc.k, np.float32)) <= (cache_tol or tol)
    return out


def test_moe_prefill_and_decode_logits_match_jax():
    _prefill_decode(QWEN, "int8_switchback", SERVE_TOL, (jnp.float32, torch.float32))


def test_fp32_serving_matches_jax():
    """fp32 serving as the JAX engine builds it (bf16 compute): f32 linears
    on bf16-rounded weights, q, k, v in f32 over the bf16 cache."""
    _prefill_decode("smollm-360m", "fp32", FP32_TOL, jpar=JPAR_LOOP, cache_tol=CACHE_TOL)


@pytest.mark.parametrize("cache", ["ring", "paged"])
def test_fp16_serving_is_bf16_and_fp32_tokens_match_jax(cache):
    """Served ``fp16`` gives ``bf16``'s tokens and logits bit for bit (both
    bf16 compute); served ``fp32`` gives the JAX engine's greedy tokens."""
    jcfg, tcfg, jp, np_params = _setup("smollm-360m")
    tp = from_numpy_tree(np_params, device="cpu")
    prompts = _prompts(tcfg.vocab_size, (6, 11, 3, 9))
    gens = {}
    for mode in ("bf16", "fp16", "fp32"):
        kw = dict(quant_mode=mode, max_batch=2, max_len=32, cache_mode=cache)
        teng = make_serve_engine(build(tcfg), ServeConfig(**kw), parallel=PAR, device="cpu")
        assert teng.policy == QuantPolicy(mode)
        gens[mode] = teng.generate(tp, prompts, max_new_tokens=5)[0]
    assert gens["fp16"] == gens["bf16"]
    kw = dict(quant_mode="fp32", max_batch=2, max_len=32, cache_mode=cache)
    jeng = jax_engine(jax_build(jcfg), JServe(**kw), make_test_mesh((1, 1)), parallel=JPAR_LOOP)
    jg, _ = jeng.generate(jp, prompts, max_new_tokens=5)
    assert [list(map(int, g)) for g in jg] == gens["fp32"]
    # the logits too, bit for bit, fp16 against bf16
    a = _prefill_decode_port("smollm-360m", "fp16")
    b = _prefill_decode_port("smollm-360m", "bf16")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _prefill_decode_port(arch, mode):
    _, tcfg, _, np_params = _setup(arch)
    tp = from_numpy_tree(np_params, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 8)))
    st = TTF.init_serve_state(tcfg, 2, 16, device="cpu")
    with torch.inference_mode():
        lg, st = TTF.serve_prefill(tp, st, toks, torch.tensor([8, 5], dtype=torch.int32),
                                   torch.tensor([True, True]), tcfg, QuantPolicy(mode), PAR)
        lg2, _ = TTF.decode_step(tp, st, toks[:, :1], tcfg, QuantPolicy(mode), PAR)
    return [lg, lg2]


def test_explicit_f16_policy_serving_raises_queue_14():
    tcfg = get_reduced_config("smollm-360m")
    for cache in ("ring", "paged"):
        with pytest.raises(NotImplementedError, match="Queue 1 #14"):
            make_serve_engine(build(tcfg), ServeConfig(max_batch=2, max_len=16, cache_mode=cache),
                              policy=FP16, device="cpu")


def test_quant_health_reads_expert_weights_as_jax():
    jcfg, tcfg, jp, np_params = _setup(QWEN)
    grads = jax.tree.map(lambda a: a * 0.5, jp)
    tc = TrainConfig(quant_mode="int8_switchback")
    jtc = JTrain(quant_mode="int8_switchback")
    want = {k: float(v) for k, v in JH.quant_health(jp, grads, jtc).items()}
    got = {k: float(v) for k, v in TH.quant_health(
        from_numpy_tree(np_params, device="cpu"),
        from_numpy_tree(jax.tree.map(np.asarray, grads), device="cpu"), tc).items()}
    assert set(got) == set(want) and "qh/other/w_absmax" in got
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-6 * max(abs(w), 1.0), k


def test_unported_families_still_raise_citing_queue_9():
    """#9 is done: granite-20b and starcoder2-3b build from the registry
    (tests/test_torch_code_lms.py) and an unknown name's KeyError cites no
    queue item. Every family builds: the multimodal and enc-dec stacks since
    their slice (tests/test_torch_vlm.py, tests/test_torch_encdec.py), the
    mixture of experts, and the SSM and hybrid stacks
    (tests/test_torch_ssm_model.py)."""
    from repro_torch.configs.base import EncDecConfig, MambaConfig, MoEConfig, RWKVConfig
    for arch in ("granite-20b", "starcoder2-3b"):
        cfg = get_reduced_config(arch)
        assert cfg.act == "gelu" and cfg.norm == "layernorm"
        assert "w_gate" not in build(cfg).param_specs["blocks"]["pos0"]["mlp"]
    with pytest.raises(KeyError) as err:
        get_reduced_config("granite-20b-xl")
    assert "Queue" not in str(err.value)
    base = get_reduced_config("smollm-360m")
    for cfg in (dataclasses.replace(base, family="vlm", frontend="vision_stub"),
                dataclasses.replace(base, family="audio", frontend="audio_stub")):
        assert build(cfg).param_specs["frontend_proj"].logical == ("embed", "embed")
    enc = build(dataclasses.replace(base, family="encdec",
                                    encdec=EncDecConfig(n_encoder_layers=2))).param_specs
    assert enc["frontend_proj"].logical == ("embed", "mlp")
    assert "xattn" in enc["dec_blocks"] and enc["enc_blocks"]["attn"]["wq"].shape[0] == 2
    moe = dataclasses.replace(base, family="moe", moe=MoEConfig(n_experts=4, top_k=2))
    assert "moe" in build(moe).param_specs["blocks"]["pos0"]
    ssm = dataclasses.replace(base, family="ssm", rwkv=RWKVConfig(head_dim=32, decay_lora=8,
                                                                  mix_lora=8))
    assert "rwkv" in build(ssm).param_specs["blocks"]["pos0"]
    hybrid = dataclasses.replace(base, family="hybrid", attn_layer_period=2,
                                 attn_layer_offset=1, mamba=MambaConfig(d_state=4))
    blocks = build(hybrid).param_specs["blocks"]
    assert "mamba" in blocks["pos0"] and "attn" in blocks["pos1"]


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_clis_take_the_moe_arch(cli):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    args = (["--n-requests", "2", "--new-tokens", "3", "--max-len", "32", "--quant-mode",
             "fp32"] if cli == "serve" else ["--steps", "2", "--batch", "2", "--seq", "16",
                                             "--quant-mode", "int8_switchback"])
    out = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{cli}", "--arch", QWEN,
                          "--device", "cpu", *args], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert ("final loss:" if cli == "train" else "tok/s") in out.stdout
