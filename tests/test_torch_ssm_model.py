"""The SSM and hybrid families, model level, against the JAX package on the
CPU: the reduced rwkv6-1.6b (three RWKV-6 layers) and jamba-v0.1-52b (one
period: seven Mamba layers, one attention layer, four MoE MLPs).

Parameters come from the JAX package's ``init_params`` and cross with
``from_numpy_tree``; batches from ``BigramLM``, decode tokens from seeded
numpy. The JAX side is jitted with XLA's excess precision off.

* Loss, ``moe_aux`` and every leaf's gradient (rwkv6 in ``bf16`` and
  ``int8_switchback`` over 64 tokens, its chunked form; jamba in
  ``int8_switchback``), dense attention: within the MoE model tests'
  tolerances (loss LOSS_TOL, each leaf's gradient GRAD_TOL of its max).
* Two StableAdamW steps through the TrainEngine at world 1 (spawned gloo
  rank, ``remat="block"``) against the JAX engine's, under the JAX engine
  tests' policy (``bf16`` with f32 compute): losses and grad norms within
  ``tests/test_torch_engine.py``'s JAX_TOL. (Under ``int8_switchback``
  with bf16 compute the first step's gradients already differ by the int8
  rounding flips above, 1.2% in rwkv6's grad norm, which the optimizer's
  step turns into 24% at the second: the f32-compute gradients agree
  within 3.4e-5 of each leaf's max, so the backward is JAX's.)
* ZeRO-3 on rwkv6 over a gloo group of 2 (every leaf with an ``embed`` axis
  sharded, the new projections gathered at ``use_weight``, the LoRAs and
  mixes gathered whole) against world 1, as the engine tests hold it; the
  world-1 engine bit for bit equal to the direct step.
* 8 tokens of ``decode_step`` from ``init_decode_state`` (f32 compute and
  state): logits against JAX's ``decode_step`` (DECODE_TOL) and against the
  port's own teacher-forced forward (rtol = atol = 2e-3, as
  ``tests/test_models_smoke.py`` holds JAX's); the final states against
  JAX's; every state tensor changes at every step (a state written back
  nowhere would not); the decode state's logical axes are JAX's.
* The serving engine's entry points raise JAX's ``NotImplementedError`` for
  both; the serve CLI enters ``decode_step_fallback`` for both (``--device
  cpu``) and prints its tok/s line; the train CLI trains both.
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

import torch_ranks as TR
from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.core.precision import QuantPolicy as JPolicy
from repro.launch.mesh import make_test_mesh as jax_mesh
from repro.models import build as jax_build
from repro.models import transformer as JTF
from repro.models.params import init_params as jax_init_params
from repro.train import make_engine as jax_engine
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ParallelConfig, ServeConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.data import BigramLM
from repro_torch.models import build
from repro_torch.models import params as PRM
from repro_torch.models import transformer as TTF
from repro_torch.models.params import from_numpy_tree, tree_paths
from repro_torch.serve import make_serve_engine
from repro_torch.train import loss_and_grads

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RWKV, JAMBA = "rwkv6-1.6b", "jamba-v0.1-52b"
OPTS = {"xla_allow_excess_precision": False}
LOSS_TOL = 1e-3            # loss and aux, relative (tests/test_torch_moe_model.py)
GRAD_TOL = (1e-1, 1e-2)    # per leaf (max, mean) |diff| / max|JAX|
JAX_TOL = 5e-3             # the engine's steps against the JAX engine's (tests/test_torch_engine.py)
SELF_TOL = 1e-5            # world 2 against world 1, f32 compute (tests/test_torch_engine.py)
PARAM_TOL = 1e-5
DECODE_TOL = 1e-4          # decode logits against JAX's, f32 compute: sums in another order
STEPS, BATCH, SEQ = 2, 4, 64
FSDP = (("fsdp", True),)
JPAR = JParallel(mesh_shape=(1, 1), remat="none", attn_impl="dense")
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


def _batch(vocab, B=BATCH, S=SEQ, seed=0):
    return BigramLM(vocab, seed=seed, temperature=0.3).batch(B, S)


@pytest.mark.parametrize("arch,mode,seq", [(RWKV, "bf16", SEQ), (RWKV, "int8_switchback", SEQ),
                                           (JAMBA, "int8_switchback", 16)])
def test_loss_and_grads_match_jax(arch, mode, seq):
    jcfg, tcfg, jp, np_params = _setup(arch)
    b = _batch(tcfg.vocab_size, S=seq)
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


# ---------------------------------------------------------------------------
# training through the TrainEngine (spawned gloo ranks)
# ---------------------------------------------------------------------------

def _batches(arch):
    vocab = get_reduced_config(arch).vocab_size
    return [_batch(vocab, seed=1000 + i) for i in range(STEPS)]


def _jax_engine_run(arch, mode, batches):
    """The JAX engine on a (1, 1) mesh, as ``torch_ranks._parts`` builds
    the port's: its initial parameters (numpy) and (loss, grad norm) a
    step."""
    tc = JTrain(optimizer="stable_adamw", learning_rate=1e-3, warmup_steps=2, total_steps=100,
                loss_scaler="none", quant_mode=mode)
    pol = JPolicy("bf16", compute_dtype=jnp.float32) if mode == "bf16" else JPolicy(mode)
    par = JParallel(mesh_shape=(1, 1), mesh_axes=("data", "model"), remat="block")
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    eng = jax_engine(jax_build(jax_reduced(arch)), tc, par, jax_mesh((1, 1)), jb[0], policy=pol)
    state = eng.init_state(0)
    params = jax.tree.map(np.asarray, state.params)
    hist = []
    for b in jb:
        state, m = eng.step(state, eng.shard_batch(b))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return params, hist


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """rwkv6 and jamba at world 1 with the JAX engine's runs, and rwkv6
    with fsdp at worlds 1 and 2; ``bf16`` with f32 compute."""
    tmp = tmp_path_factory.mktemp("ssm_engine")
    jax_side, jobs1 = {}, []
    for arch in (RWKV, JAMBA):
        batches = _batches(arch)
        params, hist = _jax_engine_run(arch, "bf16", batches)
        jax_side[arch] = hist
        jobs1.append((TR.Case(arch, (1, 1)), params, batches, None))
    batches = _batches(RWKV)
    p0 = PRM.tree_map(lambda t: t.numpy(), PRM.init_params(build(get_reduced_config(RWKV))
                                                           .param_specs, 0, device="cpu"))
    zero3 = TR.Case(RWKV, (2, 1), FSDP)
    jobs1.append((zero3.at((1, 1)), p0, batches, None))
    one = TR.run_ranks(1, TR.engine_runs, (jobs1,), tmp)[0]
    two = TR.run_ranks(2, TR.engine_runs, ([(zero3, p0, batches, None)],), tmp)
    assert two[1][0][0] == two[0][0][0]                    # both ranks report the same
    return dict(jax=jax_side, one=one, two=two[0][0], zero3=zero3, p0=p0, batches=batches)


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_engine_train_steps_match_jax(arch, engine_runs):
    hist, params = engine_runs["one"][(RWKV, JAMBA).index(arch)]
    want = engine_runs["jax"][arch]
    assert len(hist) == STEPS and all(np.isfinite(h).all() for h in hist)
    rel = np.abs(np.asarray(hist) - want) / np.abs(np.asarray(want))
    assert rel.max() <= JAX_TOL, (hist, want)


def test_zero3_engine_matches_world_one(engine_runs):
    """fsdp over two gloo ranks: the rwkv6 leaves shard by their logical
    axes (every one with ``embed``: its embed dim halved), the loss, grad
    norm and final parameters within world 1's tolerance; the world-1
    engine is the direct step bit for bit."""
    rules = PRM.default_rules(ParallelConfig(mesh_shape=(2, 1), fsdp=True))
    specs = dict(tree_paths(build(get_reduced_config(RWKV)).param_specs))

    class _Mesh:
        shape = {"data": 2, "model": 1}
    sharded = {p for p, s in specs.items()
               if any(PRM._divisible(s.shape, PRM.logical_to_pspec(s.logical, rules), _Mesh))}
    assert sharded == {p for p, s in specs.items() if "embed" in s.logical}
    for leaf in ("mix_lora_a", "mix_lora_b_w", "w_lora_a", "mu_r", "u", "wr", "w_key",
                 "w_value", "w_receptance"):
        assert f"['blocks']['pos0']['rwkv']['{leaf}']" in sharded, leaf
    (hist2, params2), (hist1, params1) = engine_runs["two"], engine_runs["one"][2]
    rel = np.abs(np.asarray(hist2) - hist1) / np.abs(np.asarray(hist1))
    assert rel.max() <= SELF_TOL, (hist2, hist1)
    for (path, g), (_, w) in zip(tree_paths(params2), tree_paths(params1)):
        top = float(np.abs(w).max()) or 1.0
        assert float(np.abs(g.astype(np.float64) - w).mean()) / top <= PARAM_TOL, path
    d_losses, d_params = TR._direct(engine_runs["zero3"].at((1, 1)), engine_runs["p0"],
                                    engine_runs["batches"])
    assert [h[0] for h in hist1] == d_losses
    assert all(np.array_equal(g, w) for (_, g), (_, w) in
               zip(tree_paths(params1), tree_paths(d_params)))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _state_leaves(states) -> dict:
    return {f"{key}.{f}": getattr(st, f) for key, st in states.items() for f in st._fields}


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_decode_matches_jax_and_forward(arch):
    jcfg, tcfg, jp, np_params = _setup(arch)
    jpol = JPolicy("bf16", compute_dtype=jnp.float32)
    tpol = QuantPolicy("bf16", compute_dtype=torch.float32)
    tp = from_numpy_tree(np_params, device="cpu")
    B, S = 2, 8
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, S))
    j_decode = jax.jit(functools.partial(JTF.decode_step, cfg=jcfg, policy=jpol,
                                         parallel=JPAR), compiler_options=OPTS)
    jst = JTF.init_decode_state(jcfg, B, 16, dtype=jnp.float32)
    tst = TTF.init_decode_state(tcfg, B, 16, dtype=torch.float32, device="cpu")
    outs = []
    with torch.inference_mode():
        full, _ = TTF.forward(tp, torch.from_numpy(toks), tcfg, tpol, PAR)
        for t in range(S):
            before = {k: v.clone() for k, v in _state_leaves(tst).items()}
            tlg, same = TTF.decode_step(tp, tst, torch.from_numpy(toks[:, t:t + 1]), tcfg,
                                        tpol, PAR)
            assert same is tst                                  # advanced in place
            for k, v in _state_leaves(tst).items():             # every state tensor moved
                assert not torch.equal(v, before[k]), (t, k)
            jlg, jst = j_decode(jp, jst, jnp.asarray(toks[:, t:t + 1], jnp.int32))
            assert _rel(tlg, np.asarray(jlg)) <= DECODE_TOL, t
            outs.append(tlg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), rtol=2e-3, atol=2e-3)
    for key, st in tst.items():
        for f in st._fields:
            got, want = getattr(st, f), np.asarray(getattr(jst[key], f))
            if f == "length":                   # the JAX package keeps one length a group
                np.testing.assert_array_equal(got.numpy(), np.repeat(want[:, None], B, 1))
            else:
                assert got.dtype == {np.dtype(np.float32): torch.float32}[want.dtype]
                assert _rel(got, want) <= DECODE_TOL, (key, f)


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_decode_state_layout_matches_jax(arch):
    jcfg, tcfg = jax_reduced(arch), get_reduced_config(arch)
    jst = JTF.init_decode_state(jcfg, 3, 16)
    tst = TTF.init_decode_state(tcfg, 3, 16, device="cpu")
    assert tst.keys() == jst.keys()
    for key, st in tst.items():
        assert type(st).__name__ == type(jst[key]).__name__ and st._fields == jst[key]._fields
        for f in st._fields:
            got, want = getattr(st, f), getattr(jst[key], f)
            shape = want.shape if f != "length" else want.shape + (3,)
            assert tuple(got.shape) == tuple(shape) and not got.any(), (key, f)
            assert str(got.dtype).split(".")[-1] == str(want.dtype), (key, f)
    assert {k: tuple(v) for k, v in TTF.decode_state_logical_axes(tcfg).items()} == \
        {k: tuple(v) for k, v in JTF.decode_state_logical_axes(jcfg).items()}


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_serving_engine_refuses_ssm_stacks(arch):
    cfg = get_reduced_config(arch)
    tp = PRM.init_params(build(cfg).param_specs, 0, device="cpu")
    for cache in ("ring", "paged"):
        with pytest.raises(TTF.NoEnginePath, match="make_serve_engine supports all-attention"):
            make_serve_engine(build(cfg), ServeConfig(max_batch=2, max_len=16, cache_mode=cache),
                              device="cpu")
    with pytest.raises(NotImplementedError, match="init_serve_state supports all-attention"):
        TTF.init_serve_state(cfg, 2, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="serve_prefill supports all-attention"):
        TTF.serve_prefill(tp, {}, torch.zeros((1, 4), dtype=torch.long),
                          torch.tensor([4]), torch.tensor([True]), cfg, QuantPolicy(), PAR)


@pytest.mark.parametrize("cli,arch", [("serve", RWKV), ("serve", JAMBA), ("train", RWKV),
                                      ("train", JAMBA)])
def test_clis_take_the_ssm_archs(cli, arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    args = (["--max-batch", "2", "--prompt-len", "4", "--new-tokens", "3", "--quant-mode",
             "int8_switchback"] if cli == "serve" else
            ["--steps", "2", "--batch", "2", "--seq", "64", "--quant-mode", "int8_switchback"])
    out = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{cli}", "--arch", arch,
                          "--device", "cpu", *args], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    if cli == "serve":
        assert "falling back to the decode_step loop" in out.stdout
        assert "tok/s, int8_switchback, batch 2, no continuous batching" in out.stdout
    else:
        assert "final loss:" in out.stdout


@pytest.mark.parametrize("flags,refusal", [
    (["--attn-block-q", "64"], "tile sizes"),
    (["--spec-mode", "ngram"], "spec_mode='ngram' verifies drafts"),
    pytest.param(["--arch", "internvl2-76b"], "multimodal frontends are a training-path feature",
                 id="vlm-falls-back"),
    pytest.param(["--arch", "seamless-m4t-large-v2"], "enc-dec decodes via models/encdec.py",
                 id="encdec-exits")])
def test_serve_cli_falls_back_only_for_ssm_stacks(flags, refusal):
    """An all-attention arch with a flag the port refuses still exits
    non-zero with its refusal: the decode_step loop is entered on the
    engine's no-path refusal alone. That refusal also takes the
    vision-language arch (a frontend), whose text the loop decodes, and
    the enc-dec arch, which then exits non-zero with the JAX engine's
    reason before any decoding, as the JAX CLI does."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "smollm-360m", "--device", "cpu", *flags, "--max-batch", "2",
                          "--prompt-len", "4", "--new-tokens", "3"], capture_output=True,
                         text=True, env=env, timeout=300)
    if "internvl2-76b" in flags:
        assert out.returncode == 0, out.stderr[-3000:]
        assert "falling back to the decode_step loop" in out.stdout and refusal in out.stdout
        assert "tok/s, bf16, batch 2, no continuous batching" in out.stdout
        return
    assert out.returncode != 0, out.stdout[-3000:]
    assert "falling back" not in out.stdout
    assert refusal in out.stderr, out.stderr[-3000:]


def test_serve_fallback_tokens_are_greedy_decode_steps():
    """``decode_step_fallback``'s tokens: the argmax of ``decode_step`` fed
    the seeded prompt, then its own tokens."""
    import argparse
    from repro_torch.launch.serve import decode_step_fallback
    cfg = get_reduced_config(JAMBA)
    args = argparse.Namespace(arch=JAMBA, device="cpu", quant_mode="int8_switchback",
                              max_batch=2, prompt_len=5, new_tokens=4, seed=3)
    params = PRM.init_params(build(cfg).param_specs, 3, device="cpu")
    res = decode_step_fallback(cfg, args, reason="test", params=params)
    assert tuple(res["tokens"].shape) == (2, 4) and res["new_tokens"] == 6
    pol = QuantPolicy("int8_switchback")
    st = TTF.init_decode_state(cfg, 2, 9, device="cpu")
    seq = res["prompts"]
    with torch.inference_mode():
        for t in range(5 + 3):
            lg, _ = TTF.decode_step(params, st, seq[:, t:t + 1], cfg, pol,
                                    ParallelConfig(remat="none"))
            if t >= 4:
                seq = torch.cat([seq, torch.argmax(lg[:, -1], -1)[:, None]], 1)
    assert torch.equal(seq[:, 5:], res["tokens"])
