"""The port stands alone: no JAX, no ``repro``, no quiet CPU fallback.

* Every module of ``repro_torch`` (and ``chip_smoke.py``) imports in a
  process where ``import jax`` and ``import repro`` fail.
* No source file of the port, nor ``chip_smoke.py``, names ``jax``,
  ``jaxlib`` or ``repro`` in an import.
* On a host without a card, the entry points refuse to run unless the CPU
  is asked for; the paths the port does not take raise
  ``NotImplementedError``, and the ones a slice has brought (the fp8
  modes) run: the serve engine in ``fp8`` and ``fp8_mixed`` gives the JAX
  package's greedy tokens.
* ``make_serve_engine`` validates a serve config as the JAX package's
  does: the same configs raise, with the same exception type, and the
  same ones are accepted (the paged knobs on the ring engine among them).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ParallelConfig, ServeConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.fp8_cast import ops as FCOPS
from repro_torch.kernels.fp8_matmul import ops as F8OPS
from repro_torch.kernels.paged_attention import ops as PAOPS
from repro_torch.kernels.switchback import ops as KOPS
from repro_torch.models import build
from repro_torch.models import params as PRM
from repro_torch.serve import ServeEngine, make_serve_engine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


# the sharded engine's modules, the fp8 oracle, the op entry points'
# modules and the self-healing and flight-recorder modules: the walk must
# reach them
NAMED = ("repro_torch.models.encdec", "repro_torch.models.frontends",
         "repro_torch.distributed.sharding", "repro_torch.distributed.compression",
         "repro_torch.launch.mesh", "repro_torch.train.engine",
         "repro_torch.core.fp8", "repro_torch.kernels.fp8_cast.ops",
         "repro_torch.kernels.fp8_cast.ref", "repro_torch.kernels.fp8_cast.build",
         "repro_torch.kernels.switchback.ops", "repro_torch.checkpoint",
         "repro_torch.checkpoint.manager", "repro_torch.data.pipeline",
         "repro_torch.train.faults", "repro_torch.train.supervisor",
         "repro_torch.telemetry", "repro_torch.telemetry.sink",
         "repro_torch.telemetry.report")


def test_every_module_imports_without_jax_or_repro():
    assert set(NAMED) <= set(_modules())
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path.name}:{node.lineno} imports {n}"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a CUDA device")


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    _no_card()
    cfg = get_reduced_config("smollm-360m")
    scfg = ServeConfig(max_batch=2, max_len=16, quant_mode="int8_switchback")
    par = ParallelConfig(attn_impl="dense")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serve_engine("smollm-360m", scfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(build(cfg), scfg, par, QuantPolicy("int8_switchback"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PRM.init_params(build(cfg).param_specs, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PRM.from_numpy_tree({"w": torch.zeros(2).numpy()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--n-requests", "1", "--new-tokens", "1"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--steps", "1"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    # and chip_smoke.py prints no result without a card
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_kernel_wrappers_have_no_backend_switch():
    """Dispatch is by device only: no wrapper takes a backend argument, so
    a CUDA tensor cannot be sent to the plain version."""
    import inspect
    for fn in (*KOPS.KERNELS, *FA.KERNELS.values(), *F8OPS.KERNELS, F8OPS.mixed,
               *PAOPS.KERNELS.values(), *FCOPS.KERNELS):
        assert "backend" not in inspect.signature(fn).parameters
    assert "backend" not in {f.name for f in dataclasses.fields(QuantPolicy)}


@pytest.mark.parametrize("bad", [
    dict(serve=dict(spec_mode="ngram")),
    dict(serve=dict(prefill_chunk_tokens=8)),
    dict(serve=dict(preemption="recompute")),
    dict(parallel=ParallelConfig(attn_block_k=128)),
    dict(parallel=ParallelConfig(attn_impl="dense", attn_block_q=64)),
    dict(serve=dict(attn_block_k=128)),
    dict(policy=("fp16", torch.float16)),
    dict(policy=("fp32", torch.float16)),
])
def test_unported_paths_raise(bad):
    """Served ``fp16`` and ``fp32`` are ported (bf16 compute, as the JAX
    engine builds the policy); an explicit f16-compute policy, whatever its
    mode, still raises (ROADMAP.md Queue 1 #14)."""
    cfg = get_reduced_config("smollm-360m")
    scfg = ServeConfig(max_batch=2, max_len=16, quant_mode="int8_switchback",
                       **bad.get("serve", {}))
    policy = None
    if "policy" in bad:
        mode, cd = bad["policy"]
        policy = QuantPolicy(mode, compute_dtype=cd)
    with pytest.raises(NotImplementedError):
        make_serve_engine(build(cfg), scfg, parallel=bad.get("parallel"), policy=policy,
                          device="cpu")


@pytest.mark.parametrize("fields", [
    dict(cache_mode="paged", rollover=True),
    dict(cache_mode="paged", spec_mode="ngram", spec_k=0),
    dict(cache_mode="paged", spec_mode="ngram", spec_min_ngram=4),
    dict(cache_mode="paged", spec_mode="ngram", spec_min_ngram=0),
    dict(cache_mode="paged", preemption="bogus"),
    dict(cache_mode="paged", spec_mode="medusa"),
    dict(cache_mode="pagedd"),
    dict(spec_mode="ngram"),
    dict(prefill_chunk_tokens=8),
    dict(preemption="recompute"),
    dict(block_size=32),
    dict(num_blocks=64),
    dict(prefix_cache=False),
    dict(spec_k=2),
    dict(spec_min_ngram=1),
    dict(cache_mode="paged", block_size=8, num_blocks=20, prefix_cache=False,
         prefill_chunk_tokens=8, preemption="recompute", spec_mode="ngram", spec_k=2),
], ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()))
def test_serve_config_validation_matches_jax(fields):
    """The port's ``make_serve_engine`` raises what the JAX package's raises
    (paged + rollover, ring + chunked prefill, preemption or ngram:
    NotImplementedError; a bad cache_mode, preemption or spec_mode, spec_k
    < 1, spec_min_ngram out of range: ValueError) and accepts what it
    accepts, the paged knobs on the ring engine included."""
    from repro.configs import get_reduced_config as jax_reduced
    from repro.configs.base import ServeConfig as JServe
    from repro.launch.mesh import make_test_mesh
    from repro.models import build as jax_build
    from repro.serve import make_serve_engine as jax_engine

    def outcome(make):
        try:
            make()
        except Exception as e:                   # noqa: BLE001 - compared below
            return type(e).__name__
        return None

    base = dict(max_batch=2, max_len=16, quant_mode="int8_switchback")
    want = outcome(lambda: jax_engine(jax_build(jax_reduced("smollm-360m")),
                                      JServe(**base, **fields), make_test_mesh((1, 1))))
    got = outcome(lambda: make_serve_engine(build(get_reduced_config("smollm-360m")),
                                            ServeConfig(**base, **fields), device="cpu"))
    assert got == want


@pytest.mark.parametrize("mode", ["fp8", "fp8_mixed"])
def test_fp8_serve_engine_matches_jax(mode):
    """The fp8 modes, which raised until their slice, serve: the reduced
    smollm-360m through both packages' engines (f32 compute, dense
    attention, the JAX package on its ``xla`` backend: the fp8 kernels'
    reference), 4 requests through 2 slots, greedy: identical tokens and
    stats-row keys. ``fp8_mixed`` with 4 x 32 tiles and ratio 2, so that
    some tiles fall back."""
    import jax
    import numpy as np

    from repro.configs import get_reduced_config as jax_reduced
    from repro.configs.base import ParallelConfig as JParallel
    from repro.configs.base import ServeConfig as JServe
    from repro.core.precision import QuantPolicy as JPolicy
    from repro.launch.mesh import make_test_mesh
    from repro.models import build as jax_build
    from repro.models.params import init_params as jax_init_params
    from repro.serve import make_serve_engine as jax_engine
    kw = dict(fp8_block_rows=4, fp8_block_cols=32, fp8_fallback_ratio=2.0) \
        if mode == "fp8_mixed" else {}
    jcfg, tcfg = jax_reduced("smollm-360m"), get_reduced_config("smollm-360m")
    jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
    tp = PRM.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    jeng = jax_engine(jax_build(jcfg), JServe(quant_mode=mode, max_batch=2, max_len=32),
                      make_test_mesh((1, 1)),
                      parallel=JParallel(mesh_shape=(1, 1), remat="none", attn_impl="dense"),
                      policy=JPolicy(mode, compute_dtype=jax.numpy.float32, **kw))
    teng = make_serve_engine(build(tcfg), ServeConfig(quant_mode=mode, max_batch=2, max_len=32),
                             parallel=ParallelConfig(remat="none", attn_impl="dense"),
                             policy=QuantPolicy(mode, compute_dtype=torch.float32, **kw),
                             device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).tolist() for n in (6, 11, 3, 9)]
    jg, js = jeng.generate(jp, prompts, max_new_tokens=5)
    tg, ts = teng.generate(tp, prompts, max_new_tokens=5)
    assert [list(map(int, g)) for g in jg] == tg
    assert set(ts) == set(js) and ts["new_tokens"] == js["new_tokens"] == 20


def test_unported_model_families_raise():
    """Nothing is left unported: every model family builds (a multimodal
    stack with its ``frontend_proj``), the code models granite-20b and
    starcoder2-3b are in the registry, no refusal cites Queue 1 #9, and an
    unknown name still raises. The ring decode takes starcoder2's query
    group of 12 and refuses one past its limit of 128."""
    cfg = dataclasses.replace(get_reduced_config("smollm-360m"), family="vlm",
                              frontend="vision_stub")
    assert "frontend_proj" in build(cfg).param_specs
    for arch in ("granite-20b", "starcoder2-3b"):
        assert "attn" in build(get_reduced_config(arch)).param_specs["blocks"]["pos0"]
    with pytest.raises(KeyError) as err:
        get_reduced_config("no-such-arch")
    assert "#9" not in str(err.value) and "granite-20b" in str(err.value)
    q, k = torch.zeros((1, 1, 12, 8)), torch.zeros((1, 4, 1, 8))
    assert FA.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32)).shape == q.shape
    q = torch.zeros((1, 1, 129, 8))
    with pytest.raises(ValueError, match="query group 129 > MAX_GROUP = 128"):
        FA.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))


def _train_parts(cfg):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import make_train_setup
    tc = TrainConfig(quant_mode="int8_switchback")
    return (build(cfg), tc, *make_train_setup(tc))


@pytest.mark.parametrize("remat", ["block", "full"])
def test_training_needs_remat_none(remat):
    """Recomputation is ported (the name is kept from when it raised): a
    step under ``remat`` builds and runs (tests/test_torch_remat.py holds it
    bit for bit to ``"none"``)."""
    from repro_torch.train import init_train_state, make_train_step
    cfg = get_reduced_config("smollm-360m")
    bundle, tc, opt, scaler = _train_parts(cfg)
    step = make_train_step(bundle, QuantPolicy("int8_switchback"), ParallelConfig(remat=remat),
                           tc, opt, scaler)
    state = init_train_state(PRM.init_params(bundle.param_specs, 0, device="cpu"), opt, scaler)
    tokens = torch.zeros((2, 8), dtype=torch.long)
    state, m = step(state, {"tokens": tokens, "labels": tokens})
    assert bool(torch.isfinite(m["loss"])) and int(state.step) == 1


@pytest.mark.parametrize("flag", [["--mesh", "test", "--devices", "4"],
                                  ["--mesh", "single", "--devices", "4"],
                                  ["--mesh", "multi", "--devices", "8"],
                                  ["--mesh", "test", "--devices", "4", "--fsdp"],
                                  ["--kernel-backend", "pallas"]])
def test_unported_train_flags_raise(flag):
    """The sharding flags train on the data axes; a mesh whose ``model``
    axis is above 1 without ``--pure-dp`` (tensor parallelism, ROADMAP.md
    Queue 1 #13) raises before any rank starts, and so does
    ``--kernel-backend``."""
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError):
        train.main(["--device", "cpu", "--steps", "1", *flag])


def test_unported_training_options_raise():
    """The training options that raised until their slice now run:
    AdaFactor, the fp8 SwitchBack linear forward and backward, and the
    fp8_mixed quant-health gauge."""
    from repro_torch.core import switchback as SB
    from repro_torch.optim import make_optimizer
    from repro_torch.telemetry.health import quant_health
    opt = make_optimizer("adafactor", 1e-3)
    p = {"w": torch.ones(4, 3)}
    assert set(opt.init(p).moments["w"]) == {"vr", "vc"}
    x = torch.randn(2, 4, requires_grad=True)
    w = torch.randn(4, 3, requires_grad=True)
    y = SB.switchback_linear(x, w, variant="fp8")
    dx, dw = torch.autograd.grad(y.sum(), (x, w))
    assert y.shape == (2, 3) and bool(torch.isfinite(dx).all() and torch.isfinite(dw).all())
    g = {"blocks": {"mlp": {"w_up": torch.randn(2, 8, 8)}}}
    out = quant_health(g, g, dataclasses.replace(_train_parts(
        get_reduced_config("smollm-360m"))[1], quant_mode="fp8_mixed"))
    assert set(out) == {"qh/mlp/w_absmax", "qh/mlp/fp8_fallback_frac"}
