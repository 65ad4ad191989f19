"""The port's serving slice against the JAX package's, on the CPU.

The JAX package's parameters (``init_params`` from a PRNG key) are carried
across with ``from_numpy_tree``, so both sides serve the same weights; the
tokens come from a seeded numpy generator. Two configs: the reduced
smollm-360m, whose linears all contract over at most 2048 (the fused
SwitchBack kernel), and the same with ``d_ff = 2304``, whose ``w_down``
crosses ``FUSED_MAX_CONTRACT`` and takes the two-step row-quantize +
int8 matmul path. Two attention implementations: ``dense``, where the
JAX side runs ``QuantPolicy("int8_switchback")`` (XLA) with
``ParallelConfig(remat="none", attn_impl="dense")``; and ``flash_scan``,
the port's default, where the JAX side runs its Pallas kernels in
interpret mode (``backend="pallas_interpret"``: the SwitchBack and the
flash-attention kernels) and the port the plain versions of its kernels.

Tolerances (relative to the largest |logit|). The JAX side is jitted as
the engine jits it; by default XLA may keep bf16 intermediates in f32
inside a fusion (``xla_allow_excess_precision``), which the port, running
op by op, never does. So the JAX side is compiled twice:

* excess precision off, f32 compute, 1e-5: sums run in another order and
  libm cos/sin/exp differ by an ulp (measured 5e-7);
* excess precision off, bf16 compute, 1e-3: then both round to bf16 at
  the same places, and the int8 quantizers absorb the last-bit
  differences (measured 0 for the fused config, 2e-5 for the two-step);
* XLA's default, bf16 compute, 1e-1: an activation XLA leaves in f32
  lands on the other side of a bf16 or int8 rounding than the port's
  (measured up to 4.8e-2 over these inputs; the JAX package's own int8
  parity tests allow 1.6e-2 for one such rounding).

The flash_scan cases hold to the same bounds (measured 5.2e-7 in f32; 0
and 2e-5 in bf16 without excess precision; 4.8e-2 with it): the port's
one full softmax and the JAX package's online softmax differ in the
order of their sums only.

Greedy ``generate`` tokens (f32 compute, where no rounding flip can
decide an argmax) must be identical, and so must the stats-row keys. The CLI (``python -m repro_torch.launch.serve``) runs once in a
subprocess and must print the JAX CLI's summary fields.
"""
from __future__ import annotations

import ast
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
from repro.core.precision import QuantPolicy as JPolicy
from repro.launch.mesh import make_test_mesh
from repro.models import build as jax_build
from repro.models import transformer as JTF
from repro.models.params import init_params as jax_init_params
from repro.serve import make_serve_engine as jax_engine
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ParallelConfig, ServeConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.models import build
from repro_torch.models import transformer as TTF
from repro_torch.models.params import from_numpy_tree
from repro_torch.serve import make_serve_engine

torch.set_num_threads(1)

ARCH = "smollm-360m"
CONFIGS = {"fused": {}, "two_step": {"d_ff": 2304}}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (compute dtype, XLA excess precision) -> tolerance (module docstring)
CASES = {("f32", False): 1e-5, ("bf16", False): 1e-3, ("bf16", True): 1e-1}
JPAR = JParallel(mesh_shape=(1, 1), remat="none", attn_impl="dense")
PAR = ParallelConfig(remat="none", attn_impl="dense")
# attn_impl -> (JAX parallel config, JAX kernel backend, port parallel config).
# flash_scan: the JAX package runs its flash kernels only on the Pallas
# backends, so its side interprets the Pallas kernels (SwitchBack and
# flash); the port runs its default, the flash wrappers' plain versions.
IMPLS = {
    "dense": (JPAR, "xla", PAR),
    "flash_scan": (JParallel(mesh_shape=(1, 1), remat="none", attn_impl="flash_scan"),
                   "pallas_interpret", ParallelConfig(remat="none")),
}

_PARAMS: dict = {}


def _setup(which: str):
    """(jax cfg, port cfg, jax params, port params) for one test config,
    built once per process."""
    if which not in _PARAMS:
        jcfg = dataclasses.replace(jax_reduced(ARCH), **CONFIGS[which])
        tcfg = dataclasses.replace(get_reduced_config(ARCH), **CONFIGS[which])
        jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
        tp = from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
        _PARAMS[which] = (jcfg, tcfg, jp, tp)
    return _PARAMS[which]


def _rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def test_configs_cover_both_forward_paths():
    from repro_torch.kernels.switchback.ops import FUSED_MAX_CONTRACT
    assert _setup("fused")[1].d_ff <= FUSED_MAX_CONTRACT < _setup("two_step")[1].d_ff


def test_from_numpy_tree_keeps_names_shapes_values():
    _, tcfg, jp, tp = _setup("fused")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jl:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    specs = TTF.param_specs(tcfg)
    assert jax.tree.structure(jax.tree.map(lambda s: 0, jax_build(
        _setup("fused")[0]).param_specs, is_leaf=lambda s: hasattr(s, "init"))) \
        == jax.tree.structure(jax.tree.map(lambda s: 0, specs,
                                           is_leaf=lambda s: hasattr(s, "init")))


def _prefill_and_decode(which, dt, excess, impl, tol):
    jcfg, tcfg, jp, tp = _setup(which)
    jdt, tdt = DTYPES[dt]
    jpar, backend, par = IMPLS[impl]
    jpol = JPolicy("int8_switchback", compute_dtype=jdt, backend=backend)
    tpol = QuantPolicy("int8_switchback", compute_dtype=tdt)
    opts = {"xla_allow_excess_precision": excess}
    j_prefill = jax.jit(functools.partial(JTF.serve_prefill, cfg=jcfg, policy=jpol,
                                          parallel=jpar), compiler_options=opts)
    j_decode = jax.jit(functools.partial(JTF.decode_step, cfg=jcfg, policy=jpol,
                                         parallel=jpar), compiler_options=opts)
    rng = np.random.default_rng(7)
    B, S, S_max = 3, 8, 16
    toks = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([8, 5, 3], np.int32)
    admit = np.array([True, True, False])

    jlg, jst = j_prefill(jp, JTF.init_serve_state(jcfg, B, S_max), jnp.asarray(toks),
                         jnp.asarray(lens), jnp.asarray(admit))
    tst = TTF.init_serve_state(tcfg, B, S_max, device="cpu")
    with torch.inference_mode():
        tlg, tst = TTF.serve_prefill(tp, tst, torch.from_numpy(toks).long(),
                                     torch.from_numpy(lens), torch.from_numpy(admit),
                                     tcfg, tpol, par)
    for b in np.flatnonzero(admit):
        assert _rel(_np(tlg[b, :lens[b]]), jlg[b, :lens[b]]) <= tol
    for _ in range(3):
        step = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        jlg, jst = j_decode(jp, jst, jnp.asarray(step))
        with torch.inference_mode():
            tlg, tst = TTF.decode_step(tp, tst, torch.from_numpy(step).long(),
                                       tcfg, tpol, par)
        assert _rel(_np(tlg), jlg) <= tol
    jc, tc = jst["pos0"], tst["pos0"]
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    assert _rel(_np(tc.k), jc.k) <= tol
    assert _rel(_np(tc.v), jc.v) <= tol


@pytest.mark.parametrize("dt,excess", list(CASES))
@pytest.mark.parametrize("which", list(CONFIGS))
def test_prefill_and_decode_match_jax(which, dt, excess):
    """serve_prefill over padded prompts (one slot not admitted), then 3
    decode steps, on both packages with dense attention: logits at every
    valid position, the cache lengths and the written K/V."""
    _prefill_and_decode(which, dt, excess, "dense", CASES[dt, excess])


@pytest.mark.parametrize("dt,excess", list(CASES))
@pytest.mark.parametrize("which", list(CONFIGS))
def test_flash_prefill_and_decode_match_jax(which, dt, excess):
    """The same with ``attn_impl="flash_scan"``: the JAX package's flash and
    SwitchBack Pallas kernels (interpret mode) against the port's default
    path on the CPU."""
    _prefill_and_decode(which, dt, excess, "flash_scan", CASES[dt, excess])


def _engines(which, impl="dense", **kw):
    """Both packages' engines, int8_switchback with f32 compute. The port's
    engine runs its default parallel config under ``flash_scan``."""
    jcfg, tcfg, jp, tp = _setup(which)
    jpar, backend, par = IMPLS[impl]
    jeng = jax_engine(jax_build(jcfg), JServe(quant_mode="int8_switchback", **kw),
                      make_test_mesh((1, 1)), parallel=jpar,
                      policy=JPolicy("int8_switchback", compute_dtype=jnp.float32,
                                     backend=backend))
    teng = make_serve_engine(build(tcfg), ServeConfig(quant_mode="int8_switchback", **kw),
                             parallel=None if impl == "flash_scan" else par,
                             policy=QuantPolicy("int8_switchback",
                                                compute_dtype=torch.float32),
                             device="cpu")
    return jeng, teng, jp, tp, jcfg


def _greedy_tokens_match(which, impl):
    jeng, teng, jp, tp, cfg = _engines(which, impl, max_batch=2, max_len=32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (6, 11, 3, 9, 5)]
    jg, js = jeng.generate(jp, prompts, max_new_tokens=5)
    tg, ts = teng.generate(tp, prompts, max_new_tokens=5)
    assert [list(map(int, g)) for g in jg] == tg
    assert set(ts) == set(js)
    for k in ("new_tokens", "prefill_tokens", "decode_steps", "prefill_calls"):
        assert ts[k] == js[k], k


@pytest.mark.parametrize("which", list(CONFIGS))
def test_generate_greedy_tokens_match_jax(which):
    """5 requests through 2 slots (eviction and slot reuse; prompt lengths
    across two prefill buckets), greedy, dense attention: identical tokens
    and identical stats-row keys."""
    _greedy_tokens_match(which, "dense")


@pytest.mark.parametrize("which", list(CONFIGS))
def test_flash_generate_greedy_tokens_match_jax(which):
    """The same with ``attn_impl="flash_scan"`` (the port's default engine)."""
    _greedy_tokens_match(which, "flash_scan")


def _rollover_tokens_match(impl):
    jeng, teng, jp, tp, cfg = _engines("fused", impl, max_batch=2, max_len=8,
                                       rollover=True)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (5, 7)]
    jg, _ = jeng.generate(jp, prompts, max_new_tokens=12)
    tg, _ = teng.generate(tp, prompts, max_new_tokens=12)
    assert [list(map(int, g)) for g in jg] == tg and all(len(g) == 12 for g in tg)


def test_rollover_ring_wrap_matches_jax():
    """rollover: sequences run past max_len, so the ring write wraps at
    ``length % max_len`` and RoPE is computed per call; tokens identical."""
    _rollover_tokens_match("dense")


def test_flash_rollover_ring_wrap_matches_jax():
    """The same through the decode kernel: a wrapped slot attends over its
    whole window (kv_len = max_len)."""
    _rollover_tokens_match("flash_scan")


def test_sampling_depends_on_seed_uid_and_step_only():
    """temperature > 0: a request's draws are a function of (seed, uid,
    step), so one slot and three slots give the same tokens, and another
    seed gives others. (They cannot match the JAX engine's threefry draws.)"""
    _, tcfg, _, tp = _setup("fused")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).tolist() for n in (4, 6, 5)]

    def run(max_batch, seed=None):
        eng = make_serve_engine(build(tcfg), ServeConfig(
            max_batch=max_batch, max_len=32, temperature=1.0,
            quant_mode="int8_switchback"), device="cpu")
        return eng.generate(tp, prompts, max_new_tokens=6, seed=seed)[0]

    one = run(1)
    assert run(3) == one
    assert run(3, seed=1) != one


def test_empty_generate_has_the_same_stats_keys():
    jeng, teng, jp, tp, _ = _engines("fused", max_batch=2, max_len=16)
    jg, js = jeng.generate(jp, [[1, 2]], max_new_tokens=0)
    tg, ts = teng.generate(tp, [[1, 2]], max_new_tokens=0)
    assert tg == jg == [[]]
    assert set(ts) == set(js)


def test_generate_clamps_bucket_to_non_pow2_max_len():
    """A 9-token prompt buckets to 16, past max_len 12: the bucket clamps
    (the scheduler guarantees the prompt itself fits)."""
    _, teng, _, tp, cfg = _engines("fused", max_batch=2, max_len=12)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 9).tolist()
    gens, stats = teng.generate(tp, [prompt], max_new_tokens=3)
    assert len(gens[0]) == 3 and stats["prefill_calls"] == 1


def test_serve_cli_smoke():
    """``python -m repro_torch.launch.serve`` on the CPU: exit 0 and the
    JAX CLI's summary fields. Tokens are not compared with the JAX CLI,
    which draws its weights from another generator."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--quant-mode", "int8_switchback",
         "--n-requests", "3", "--new-tokens", "4", "--max-len", "32"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    summary = [ln for ln in lines if ln.startswith("[serve]") and "tok/s" in ln]
    assert len(summary) == 1
    for field in ("new tokens", "prefilled", "tok/s", "decode steps",
                  "prefill calls", "ttft p50", "itl p50", "wall p95",
                  "prefill-stall p95"):
        assert field in summary[0], field
    sample = [ln for ln in lines if ln.startswith("sample:")]
    assert len(sample) == 1 and len(ast.literal_eval(sample[0][len("sample:"):])) == 4
