"""The vision-language backbone against the JAX package on the CPU: the
reduced internvl2-76b (four dense layers, d 128, 8 heads over 2 KV heads,
16 frontend tokens, vocab 512) with the stub frontend's precomputed
features (``extra_embeds``) projected by ``frontend_proj`` and put in
front of the text.

Parameters come from the JAX package's ``init_params`` and cross with
``from_numpy_tree``; tokens from ``BigramLM``, the frontend features from
``models/frontends.synthetic_frontend_batch`` (seeded numpy; the JAX
launcher's threefry draw cannot be replayed). The JAX side is jitted with
XLA's excess precision off, but for ``embed_input``, held bit for bit
against JAX's eager XLA path.

* ``embed_input``: the 16 projected frontend rows, then the tokens'
  embeddings, bit for bit JAX's in ``bf16`` and ``int8_switchback``.
* The loss slices off the first 16 positions: it is the cross-entropy of
  the logits' last S rows exactly, and the control (the last 16 dropped
  instead) is not.
* Logits (B, 16 + S, V) within LOGIT_TOL (a bf16 ulp of max|logit|), the
  loss (LOSS_TOL) and each leaf's gradient (GRAD_TOL of its max), dense
  attention, in ``bf16`` and ``int8_switchback``.
* The serve CLI's path: the engine refuses the frontend (``NoEnginePath``,
  JAX's message) and ``decode_step`` decodes the text, 8 tokens against
  JAX's ``decode_step`` (f32 compute, DECODE_TOL) and the port's forward.
* Two StableAdamW steps through the TrainEngine at world 1 (a spawned gloo
  rank) against the JAX engine's (f32 compute, JAX_TOL); ZeRO-3 over a
  gloo group of 2 against world 1 (SELF_TOL; ``frontend_proj`` split and
  gathered at ``use_weight``), the world-1 engine bit for bit the direct
  step.
* The train CLI's batches (``make_data``) and the train CLI itself.
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
from repro_torch.data import BigramLM, SyntheticSeq2Seq
from repro_torch.launch.train import make_data
from repro_torch.models import build
from repro_torch.models import params as PRM
from repro_torch.models import transformer as TTF
from repro_torch.models.common import cross_entropy_loss
from repro_torch.models.frontends import frontend_embed_shape, synthetic_frontend_batch
from repro_torch.models.params import from_numpy_tree, tree_paths
from repro_torch.serve import make_serve_engine
from repro_torch.train import loss_and_grads

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "internvl2-76b"
OPTS = {"xla_allow_excess_precision": False}
LOSS_TOL = 1e-3            # relative (tests/test_torch_moe_model.py)
GRAD_TOL = (1e-1, 1e-2)    # per leaf (max, mean) |diff| / max|JAX|
LOGIT_TOL = 2.0 ** -7      # bf16 logits: one ulp of max|logit|
JAX_TOL = 5e-3             # the engine's steps against the JAX engine's (test_torch_engine)
SELF_TOL = 1e-5            # world 2 against world 1, f32 compute
PARAM_TOL = 1e-5
DECODE_TOL = 1e-4          # decode logits against JAX's, f32 compute: sums in another order
STEPS, BATCH, SEQ = 2, 4, 16
JPAR = JParallel(mesh_shape=(1, 1), remat="none", attn_impl="dense")
PAR = ParallelConfig(remat="none", attn_impl="dense")

_PARAMS: dict = {}


def _setup():
    if not _PARAMS:
        jcfg, tcfg = jax_reduced(ARCH), get_reduced_config(ARCH)
        jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
        _PARAMS.update(cfgs=(jcfg, tcfg), jp=jp, np=jax.tree.map(np.asarray, jp))
    return (*_PARAMS["cfgs"], _PARAMS["jp"], _PARAMS["np"])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _batch(seed=0, B=BATCH, S=SEQ) -> dict:
    """BigramLM tokens and labels with f32 frontend features (numpy)."""
    cfg = get_reduced_config(ARCH)
    b = BigramLM(cfg.vocab_size, seed=seed, temperature=0.3).batch(B, S)
    b["extra_embeds"] = np.random.default_rng(seed).standard_normal(
        frontend_embed_shape(cfg, B)).astype(np.float32)
    return b


def _torch_batch(b) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind in "iu" else torch.from_numpy(v)
            for k, v in b.items()}


@pytest.mark.parametrize("mode", ["bf16", "int8_switchback"])
def test_embed_input_matches_jax(mode):
    jcfg, tcfg, jp, np_params = _setup()
    b = _batch(seed=2)
    F = tcfg.frontend_tokens
    tp, tpol = from_numpy_tree(np_params, device="cpu"), QuantPolicy(mode)
    got = TTF.embed_input(tp, torch.from_numpy(b["tokens"]), tcfg, tpol,
                          torch.from_numpy(b["extra_embeds"]))
    want = JTF.embed_input(jp, jnp.asarray(b["tokens"]), jcfg, JPolicy(mode),
                           jnp.asarray(b["extra_embeds"]))
    assert got.shape == (BATCH, F + SEQ, tcfg.d_model) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    assert torch.equal(got[:, F:], tp["embed"][torch.from_numpy(b["tokens"])].bfloat16())
    assert not torch.equal(got[:, :F], got[:, SEQ:])


@pytest.mark.parametrize("mode", ["bf16", "int8_switchback"])
def test_forward_loss_and_grads_match_jax(mode):
    jcfg, tcfg, jp, np_params = _setup()
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    bundle, jpol = jax_build(jcfg), JPolicy(mode)

    def jit(fn):
        return jax.jit(fn).lower(jp, jb).compile(compiler_options=OPTS)
    (jl, jm), jg = jit(jax.value_and_grad(lambda p, x: bundle.loss_fn(p, x, jpol, JPAR),
                                          has_aux=True))(jp, jb)
    jlog = jit(lambda p, x: JTF.forward(p, x["tokens"], jcfg, jpol, JPAR,
                                        extra_embeds=x["extra_embeds"])[0])(jp, jb)
    tp, tb, tpol = from_numpy_tree(np_params, device="cpu"), _torch_batch(b), QuantPolicy(mode)
    with torch.no_grad():
        tlog, _ = TTF.forward(tp, tb["tokens"], tcfg, tpol, PAR, extra_embeds=tb["extra_embeds"])
    assert tlog.shape == (BATCH, tcfg.frontend_tokens + SEQ, tcfg.vocab_size)
    assert _rel(_np(tlog), _np(jlog)) <= LOGIT_TOL
    tg, tl, tm = loss_and_grads(build(tcfg), tpol, PAR, tp, tb)
    assert set(tm) == set(jm) == {"ce", "moe_aux"}
    assert _rel(float(tl), float(jl)) <= LOSS_TOL
    want = {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_leaves_with_path(jg)}
    got = {k: v.double().numpy() for k, v in tree_paths(tg)}
    assert set(got) == set(want) and "['frontend_proj']" in got
    for k, w in want.items():
        d, top = np.abs(got[k] - w), np.abs(w).max() or 1.0
        assert d.max() / top <= GRAD_TOL[0] and d.mean() / top <= GRAD_TOL[1], k


def test_loss_drops_the_first_frontend_positions():
    """The 16 frontend rows lead the logits and carry no target: the loss
    is the cross-entropy of the last S rows, bit for bit; dropping the last
    16 instead (the frontend appended, not prepended) reads another loss."""
    _, tcfg, _, np_params = _setup()
    tp, tb, tpol = from_numpy_tree(np_params, device="cpu"), _torch_batch(_batch()), QuantPolicy()
    with torch.no_grad():
        logits, _ = TTF.forward(tp, tb["tokens"], tcfg, tpol, PAR, extra_embeds=tb["extra_embeds"])
        loss, m = TTF.loss_fn(tp, tb, tcfg, tpol, PAR)
    F = tcfg.frontend_tokens
    assert torch.equal(m["ce"], cross_entropy_loss(logits[:, F:], tb["labels"]))
    assert torch.equal(loss, m["ce"])
    control = cross_entropy_loss(logits[:, :SEQ], tb["labels"])
    assert abs(float(control) - float(m["ce"])) > 1e-2


def test_serving_refuses_the_frontend_and_decodes_the_text():
    """The engine refuses a frontend stack (the CLI's fallback refusal,
    not an SSM one); ``decode_step`` then decodes the text alone, as the
    JAX CLI's fallback does: 8 tokens against JAX's ``decode_step`` and the
    port's own text-only forward."""
    jcfg, tcfg, jp, np_params = _setup()
    for cache in ("ring", "paged"):
        with pytest.raises(TTF.NoEnginePath, match="multimodal frontends are a training-path"):
            make_serve_engine(build(tcfg), ServeConfig(max_batch=2, max_len=16, cache_mode=cache),
                              device="cpu")
    with pytest.raises(NotImplementedError, match="init_serve_state: multimodal frontends"):
        TTF.init_serve_state(tcfg, 2, 16, device="cpu")
    jpol = JPolicy("bf16", compute_dtype=jnp.float32)
    tpol = QuantPolicy("bf16", compute_dtype=torch.float32)
    tp = from_numpy_tree(np_params, device="cpu")
    B, S = 2, 8
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, S))
    j_decode = jax.jit(functools.partial(JTF.decode_step, cfg=jcfg, policy=jpol, parallel=JPAR),
                       compiler_options=OPTS)
    jst = JTF.init_decode_state(jcfg, B, 16, dtype=jnp.float32)
    tst = TTF.init_decode_state(tcfg, B, 16, dtype=torch.float32, device="cpu")
    outs = []
    with torch.inference_mode():
        full, _ = TTF.forward(tp, torch.from_numpy(toks), tcfg, tpol, PAR)
        for t in range(S):
            tlg, _ = TTF.decode_step(tp, tst, torch.from_numpy(toks[:, t:t + 1]), tcfg, tpol, PAR)
            jlg, jst = j_decode(jp, jst, jnp.asarray(toks[:, t:t + 1], jnp.int32))
            assert _rel(_np(tlg), _np(jlg)) <= DECODE_TOL, t
            outs.append(tlg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_train_cli_batches():
    """``make_data``: a frontend arch's batches carry bf16 ``extra_embeds``
    (B, 16, d) drawn from numpy seeded (seed, step), the same for the same
    pair, another for another step or seed; an enc-dec arch's are
    SyntheticSeq2Seq's frames (f32), tokens and labels (int64)."""
    cfg = get_reduced_config(ARCH)
    a, again = make_data(cfg, 2, 8, "cpu", seed=1), make_data(cfg, 2, 8, "cpu", seed=1)
    b0, b1, c0 = a(0), a(1), again(0)
    assert set(b0) == {"tokens", "labels", "extra_embeds"} and b0["tokens"].dtype == torch.long
    e = b0["extra_embeds"]
    assert tuple(e.shape) == (2, cfg.frontend_tokens, cfg.d_model) and e.dtype == torch.bfloat16
    assert torch.equal(e, c0["extra_embeds"]) and not torch.equal(e, b1["extra_embeds"])
    assert torch.equal(e, synthetic_frontend_batch(np.random.default_rng((1, 0)), cfg, 2))
    assert not torch.equal(e, make_data(cfg, 2, 8, "cpu", seed=2)(0)["extra_embeds"])
    s2s = get_reduced_config("seamless-m4t-large-v2")
    got = make_data(s2s, 2, 8, "cpu")(0)
    want = SyntheticSeq2Seq(s2s.d_model, s2s.vocab_size).batch(2, s2s.frontend_tokens, 8)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == (torch.long if k != "frames" else torch.float32)
        np.testing.assert_array_equal(got[k].numpy(), v)


# ---------------------------------------------------------------------------
# training through the TrainEngine (spawned gloo ranks)
# ---------------------------------------------------------------------------

def _jax_engine_run(batches):
    """The JAX engine on a (1, 1) mesh (f32 compute): its initial
    parameters (numpy) and (loss, grad norm) a step."""
    tc = JTrain(optimizer="stable_adamw", learning_rate=1e-3, warmup_steps=2, total_steps=100,
                loss_scaler="none", quant_mode="bf16")
    par = JParallel(mesh_shape=(1, 1), mesh_axes=("data", "model"), remat="block")
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    eng = jax_engine(jax_build(jax_reduced(ARCH)), tc, par, jax_mesh((1, 1)), jb[0],
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
    tmp = tmp_path_factory.mktemp("vlm_engine")
    batches = [_batch(seed=1000 + i) for i in range(STEPS)]
    params, want = _jax_engine_run(batches)
    zero3 = TR.Case(ARCH, (2, 1), (("fsdp", True),))
    jobs = [(TR.Case(ARCH, (1, 1)), params, batches, None),
            (zero3.at((1, 1)), params, batches, None)]
    one = TR.run_ranks(1, TR.engine_runs, (jobs,), tmp)[0]
    two = TR.run_ranks(2, TR.engine_runs, ([(zero3, params, batches, None)],), tmp)
    assert two[1][0][0] == two[0][0][0]                    # both ranks report the same
    return dict(jax=want, one=one, two=two[0][0], zero3=zero3, p0=params, batches=batches)


def test_engine_train_steps_match_jax(engine_runs):
    hist, _ = engine_runs["one"][0]
    want = engine_runs["jax"]
    assert len(hist) == STEPS and all(np.isfinite(h).all() for h in hist)
    rel = np.abs(np.asarray(hist) - want) / np.abs(np.asarray(want))
    assert rel.max() <= JAX_TOL, (hist, want)


def test_zero3_engine_matches_world_one(engine_runs):
    """fsdp over two gloo ranks: ``frontend_proj`` ((embed, embed): its
    first dim split, the second a repeat of the axis) with every other
    leaf that has an ``embed`` axis; the losses, grad norms and final
    parameters within world 1's tolerance; world 1 bit for bit the direct
    step."""
    par = ParallelConfig(mesh_shape=(2, 1), fsdp=True)
    rules = PRM.default_rules(par)
    specs = dict(tree_paths(build(get_reduced_config(ARCH)).param_specs))
    assert PRM.logical_to_pspec(specs["['frontend_proj']"].logical, rules) == ("data", None)
    assert "frontend_proj" in PRM.USE_WEIGHT_LEAVES
    (hist2, params2), (hist1, params1) = engine_runs["two"], engine_runs["one"][1]
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


def test_train_cli_takes_the_vlm():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
                          "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                          "--quant-mode", "int8_switchback"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "final loss:" in out.stdout and ARCH in out.stdout
