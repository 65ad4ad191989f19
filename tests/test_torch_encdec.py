"""The encoder-decoder family against the JAX package on the CPU: the
reduced seamless-m4t-large-v2 (two encoder and two decoder layers, d 128,
4 heads of 32, 32 frames, vocab 512), and the configs of the multimodal
and enc-dec group.

Parameters come from the JAX package's ``init_params`` and cross with
``from_numpy_tree``; batches from ``SyntheticSeq2Seq`` (the same bits in
both packages), other inputs from seeded numpy. The JAX side is jitted
with XLA's excess precision off.

* The configs of seamless-m4t-large-v2 and internvl2-76b, full and
  reduced, and their parameter specs (shapes, logical axes, inits): JAX's.
* ``encode_cross_kv`` + ``cross_attention`` alone, the decoder's 6 rows
  against the encoder's 32 (Sq != Sk), output and every gradient: under
  ``flash_scan`` the plain flash kernels against JAX's Pallas kernels
  (interpreted), under ``dense`` against JAX's XLA oracle, in ``bf16``
  and ``int8_switchback``, within XATTN_TOL of max|JAX| (one bf16 ulp).
* The forward's logits (LOGIT_TOL of max|logit|: a bf16 ulp), the loss
  (LOSS_TOL) and each leaf's gradient (GRAD_TOL of its max), dense
  attention, in ``bf16`` and ``int8_switchback``.
* 8 tokens of ``decode_step`` from ``init_decode_state`` (f32 compute and
  cache): logits against JAX's ``decode_step`` (DECODE_TOL) and against
  the port's own teacher-forced forward (rtol = atol = 2e-3, as
  ``tests/test_models_smoke.py`` holds JAX's), under both attention
  implementations; the caches against JAX's; lengths (L, B) advancing.
* Two StableAdamW steps through the TrainEngine at world 1 (a spawned gloo
  rank) against the JAX engine's (f32 compute, JAX_TOL); ZeRO-3 over a
  gloo group of 2 against world 1 (SELF_TOL), the world-1 engine bit for
  bit the direct step.
* The serve engine refuses enc-dec (``NoEnginePath``, JAX's message); the
  train CLI trains it.
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
from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.core.precision import QuantPolicy as JPolicy
from repro.data.synthetic import SyntheticSeq2Seq as JSeq2Seq
from repro.launch.mesh import make_test_mesh as jax_mesh
from repro.models import attention as JATT
from repro.models import build as jax_build
from repro.models import encdec as JED
from repro.models.params import init_params as jax_init_params
from repro.train import make_engine as jax_engine
from repro_torch.configs import ALL_ARCHS, get_config, get_reduced_config
from repro_torch.configs.base import ParallelConfig, ServeConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.data import SyntheticSeq2Seq
from repro_torch.models import attention as TATT
from repro_torch.models import build
from repro_torch.models import encdec as TED
from repro_torch.models import params as PRM
from repro_torch.models import transformer as TTF
from repro_torch.models.params import from_numpy_tree, tree_paths
from repro_torch.serve import make_serve_engine
from repro_torch.train import loss_and_grads

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, VLM = "seamless-m4t-large-v2", "internvl2-76b"
OPTS = {"xla_allow_excess_precision": False}
LOSS_TOL = 1e-3            # relative (tests/test_torch_moe_model.py)
GRAD_TOL = (1e-1, 1e-2)    # per leaf (max, mean) |diff| / max|JAX|
LOGIT_TOL = 2.0 ** -7      # bf16 logits: one ulp of max|logit| (tests/test_torch_clip_kernels.py)
XATTN_TOL = 2.0 ** -7      # one bf16 ulp of max|JAX|
JAX_TOL = 5e-3             # the engine's steps against the JAX engine's (test_torch_engine)
SELF_TOL = 1e-5            # world 2 against world 1, f32 compute
PARAM_TOL = 1e-5
DECODE_TOL = 1e-4          # decode logits against JAX's, f32 compute: sums in another order
STEPS, BATCH, SEQ = 2, 4, 16
JPAR = JParallel(mesh_shape=(1, 1), remat="none", attn_impl="dense")
PAR = ParallelConfig(remat="none", attn_impl="dense")

_PARAMS: dict = {}


def _setup(arch=ARCH):
    if arch not in _PARAMS:
        jcfg, tcfg = jax_reduced(arch), get_reduced_config(arch)
        jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
        _PARAMS[arch] = (jcfg, tcfg, jp, jax.tree.map(np.asarray, jp))
    return _PARAMS[arch]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _batch(seed=3, B=BATCH, S=SEQ) -> dict:
    cfg = get_reduced_config(ARCH)
    return SyntheticSeq2Seq(cfg.d_model, cfg.vocab_size, seed=seed).batch(
        B, cfg.frontend_tokens, S)


def _torch_batch(b) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind in "iu" else torch.from_numpy(v)
            for k, v in b.items()}


def _spec_table(tree, keys) -> dict:
    return {p: (tuple(s.shape), tuple(s.logical), s.init, s.scale) for p, s in keys(tree)}


@pytest.mark.parametrize("arch", [ARCH, VLM])
def test_configs_and_specs_match_jax(arch):
    assert arch in ALL_ARCHS
    for mine, theirs in ((get_config(arch), jax_config(arch)),
                         (get_reduced_config(arch), jax_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert type(mine.encdec).__name__ == type(theirs.encdec).__name__
        want = _spec_table(jax_build(theirs).param_specs, lambda t: (
            (jax.tree_util.keystr(k), s) for k, s in jax.tree_util.tree_leaves_with_path(
                t, is_leaf=lambda s: hasattr(s, "logical"))))
        assert _spec_table(build(mine).param_specs, tree_paths) == want


def test_seq2seq_batches_match_jax():
    """The copy draws the reference's bits, batch after batch."""
    cfg = get_reduced_config(ARCH)
    mine, theirs = (cls(cfg.d_model, cfg.vocab_size, seed=5) for cls in (SyntheticSeq2Seq,
                                                                      JSeq2Seq))
    for _ in range(2):
        a, b = mine.batch(3, cfg.frontend_tokens, 12), theirs.batch(3, cfg.frontend_tokens, 12)
        assert a.keys() == b.keys() == {"frames", "tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("impl", ["flash_scan", "dense"])
@pytest.mark.parametrize("mode", ["bf16", "int8_switchback"])
def test_cross_attention_matches_jax(mode, impl):
    """Layer 0's cross attention, the decoder's 6 rows against the
    encoder's 32 frames: output and the gradients of x, the encoder output
    and wq, wk, wv, wo."""
    jcfg, tcfg, _, np_params = _setup()
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, tcfg.frontend_tokens, tcfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
    p = {k: v[0] for k, v in np_params["dec_blocks"]["xattn"].items()}
    backend = "pallas_interpret" if impl == "flash_scan" else "xla"
    jpol = JPolicy(mode, backend=backend)

    def jfn(xx, ee, pp):
        kv = JATT.encode_cross_kv(ee, pp, jcfg, jpol)
        return JATT.cross_attention(xx, kv, pp, jcfg, jpol, impl=impl)

    args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(enc, jnp.bfloat16),
            {k: jnp.asarray(v) for k, v in p.items()})
    jy, vjp = jax.vjp(jax.jit(jfn), *args)
    jgx, jge, jgp = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    te = torch.from_numpy(enc).to(torch.bfloat16).requires_grad_()
    tp = {k: torch.tensor(v).requires_grad_() for k, v in p.items()}
    tpol = QuantPolicy(mode)
    ty = TATT.cross_attention(tx, TATT.encode_cross_kv(te, tp, tcfg, tpol), tp, tcfg, tpol,
                              impl=impl)
    grads = torch.autograd.grad(ty, (tx, te, *tp.values()), torch.from_numpy(g).to(ty.dtype))
    assert ty.shape == (2, 6, tcfg.d_model) and ty.dtype == torch.bfloat16
    assert _rel(_np(ty), _np(jy)) <= XATTN_TOL
    for name, got, want in zip(("x", "enc_out", *tp), grads, (jgx, jge, *jgp.values())):
        assert _rel(_np(got), _np(want)) <= XATTN_TOL, (name, _rel(_np(got), _np(want)))


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
    jlog = jit(lambda p, x: JED.forward(p, x, jcfg, jpol, JPAR))(jp, jb)
    tp, tb, tpol = from_numpy_tree(np_params, device="cpu"), _torch_batch(b), QuantPolicy(mode)
    with torch.no_grad():
        tlog = TED.forward(tp, tb, tcfg, tpol, PAR)
    assert tlog.shape == (BATCH, SEQ, tcfg.vocab_size) and tlog.dtype == torch.bfloat16
    assert _rel(_np(tlog), _np(jlog)) <= LOGIT_TOL
    tg, tl, tm = loss_and_grads(build(tcfg), tpol, PAR, tp, tb)
    assert set(tm) == set(jm) == {"ce"}
    assert _rel(float(tl), float(jl)) <= LOSS_TOL
    want = {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_leaves_with_path(jg)}
    got = {k: v.double().numpy() for k, v in tree_paths(tg)}
    assert set(got) == set(want)
    for k, w in want.items():
        d, top = np.abs(got[k] - w), np.abs(w).max() or 1.0
        assert d.max() / top <= GRAD_TOL[0] and d.mean() / top <= GRAD_TOL[1], k


@pytest.mark.parametrize("impl", ["dense", "flash_scan"])
def test_decode_matches_jax_and_teacher_forcing(impl):
    """f32 compute and cache; the port's twin of
    ``tests/test_models_smoke.py::test_encdec_decode_matches_forward``,
    and the same steps against JAX's ``decode_step`` (dense: JAX's XLA
    oracle on both sides)."""
    jcfg, tcfg, jp, np_params = _setup()
    jpol = JPolicy("bf16", compute_dtype=jnp.float32)
    tpol = QuantPolicy("bf16", compute_dtype=torch.float32)
    par = ParallelConfig(remat="none", attn_impl=impl)
    tp = from_numpy_tree(np_params, device="cpu")
    B, S = 2, 8
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((B, tcfg.frontend_tokens, tcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, tcfg.vocab_size, (B, S))
    j_decode = jax.jit(functools.partial(JED.decode_step, cfg=jcfg, policy=jpol, parallel=JPAR),
                       compiler_options=OPTS)
    jst = JED.init_decode_state(jp, jnp.asarray(frames), jcfg, jpol, JPAR, B, 16,
                                dtype=jnp.float32)
    outs = []
    with torch.inference_mode():
        tf = torch.from_numpy(frames)
        full = TED.forward(tp, {"frames": tf, "tokens": torch.from_numpy(toks)}, tcfg, tpol, par)
        tst = TED.init_decode_state(tp, tf, tcfg, tpol, par, B, 16, dtype=torch.float32)
        assert _rel(_np(tst.enc_out), _np(jst.enc_out)) <= DECODE_TOL
        for t in range(S):
            tlg, same = TED.decode_step(tp, tst, torch.from_numpy(toks[:, t:t + 1]), tcfg, tpol,
                                        par)
            assert same is tst
            assert torch.equal(tst.self_caches.length,
                               torch.full((tcfg.n_layers, B), t + 1, dtype=torch.int32))
            jlg, jst = j_decode(jp, jst, jnp.asarray(toks[:, t:t + 1], jnp.int32))
            if impl == "dense":
                assert _rel(_np(tlg), _np(jlg)) <= DECODE_TOL, t
            outs.append(tlg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), rtol=2e-3, atol=2e-3)
    for f in ("k", "v"):
        assert _rel(_np(getattr(tst.self_caches, f)), _np(getattr(jst.self_caches, f))) \
            <= DECODE_TOL, f
    np.testing.assert_array_equal(tst.self_caches.length.numpy(),
                                  np.repeat(np.asarray(jst.self_caches.length)[:, None], B, 1))


def test_serving_engine_refuses_encdec():
    cfg = get_reduced_config(ARCH)
    for cache in ("ring", "paged"):
        with pytest.raises(TTF.NoEnginePath, match="enc-dec decodes via models/encdec.py"):
            make_serve_engine(build(cfg), ServeConfig(max_batch=2, max_len=16, cache_mode=cache),
                              device="cpu")


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
    tmp = tmp_path_factory.mktemp("encdec_engine")
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
    """fsdp over two gloo ranks: every leaf with an ``embed`` axis splits
    (the encoder's, the decoder's and the cross projections, the norms,
    frontend_proj and the head); the losses, grad norms and final
    parameters within world 1's tolerance; world 1 bit for bit the direct
    step."""
    rules = PRM.default_rules(ParallelConfig(mesh_shape=(2, 1), fsdp=True))
    specs = dict(tree_paths(build(get_reduced_config(ARCH)).param_specs))

    class _Mesh:
        shape = {"data": 2, "model": 1}
    sharded = {p for p, s in specs.items()
               if any(PRM._divisible(s.shape, PRM.logical_to_pspec(s.logical, rules), _Mesh))}
    assert sharded == {p for p, s in specs.items() if "embed" in s.logical}
    for leaf in ("['frontend_proj']", "['head']", "['dec_blocks']['xattn']['wq']",
                 "['enc_blocks']['attn']['wo']", "['dec_blocks']['norm_x']['bias']"):
        assert leaf in sharded, leaf
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


def test_train_cli_takes_encdec():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
                          "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                          "--quant-mode", "int8_switchback"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "final loss:" in out.stdout and ARCH in out.stdout
