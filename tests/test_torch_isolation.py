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
from repro_torch.kernels.fp8_matmul import ops as F8OPS
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


def test_every_module_imports_without_jax_or_repro():
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
    for fn in (*KOPS.KERNELS, *FA.KERNELS.values(), *F8OPS.KERNELS, F8OPS.mixed):
        assert "backend" not in inspect.signature(fn).parameters
    assert "backend" not in {f.name for f in dataclasses.fields(QuantPolicy)}


@pytest.mark.parametrize("bad", [
    dict(serve=dict(cache_mode="paged")),
    dict(serve=dict(spec_mode="ngram")),
    dict(serve=dict(prefill_chunk_tokens=8)),
    dict(serve=dict(preemption="recompute")),
    dict(parallel=ParallelConfig(attn_block_k=128)),
    dict(parallel=ParallelConfig(attn_impl="dense", attn_block_q=64)),
    dict(serve=dict(attn_block_k=128)),
    dict(serve=dict(block_size=32)),
    dict(serve=dict(num_blocks=64)),
    dict(serve=dict(prefix_cache=False)),
    dict(serve=dict(spec_k=2)),
    dict(serve=dict(spec_min_ngram=1)),
    dict(policy="fp16"),
    dict(policy="fp32"),
])
def test_unported_paths_raise(bad):
    cfg = get_reduced_config("smollm-360m")
    scfg = ServeConfig(max_batch=2, max_len=16, quant_mode="int8_switchback",
                       **bad.get("serve", {}))
    with pytest.raises(NotImplementedError):
        make_serve_engine(build(cfg), scfg, parallel=bad.get("parallel"),
                          policy=QuantPolicy(bad["policy"]) if "policy" in bad else None,
                          device="cpu")


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
    from repro_torch.configs.base import MoEConfig
    cfg = dataclasses.replace(get_reduced_config("smollm-360m"), family="moe",
                              moe=MoEConfig(n_experts=4, top_k=2))
    with pytest.raises(NotImplementedError):
        build(cfg)


def _train_parts(cfg):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import make_train_setup
    tc = TrainConfig(quant_mode="int8_switchback")
    return (build(cfg), tc, *make_train_setup(tc))


@pytest.mark.parametrize("remat", ["block", "full"])
def test_training_needs_remat_none(remat):
    from repro_torch.train import make_train_step
    bundle, tc, opt, scaler = _train_parts(get_reduced_config("smollm-360m"))
    with pytest.raises(NotImplementedError, match="remat"):
        make_train_step(bundle, QuantPolicy("int8_switchback"), ParallelConfig(remat=remat),
                        tc, opt, scaler)


@pytest.mark.parametrize("kw", [dict(checkpoint_dir="ckpt"), dict(fault_plan=[]),
                                dict(telemetry=object())])
def test_unported_trainer_options_raise(kw):
    from repro_torch.train import Trainer
    with pytest.raises(NotImplementedError):
        Trainer(lambda s, b: (s, {}), None, **kw)


@pytest.mark.parametrize("flag", [["--mesh", "test"], ["--devices", "8"], ["--fsdp"],
                                  ["--pure-dp"], ["--supervise"], ["--fault-plan", "[]"],
                                  ["--ckpt-dir", "ckpt"], ["--telemetry", "run.jsonl"],
                                  ["--kernel-backend", "pallas"], ["--profile-steps", "1:2"]])
def test_unported_train_flags_raise(flag):
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError):
        train.main(["--device", "cpu", "--steps", "1", *flag])


def test_unported_training_options_raise():
    """AdaFactor still raises; the fp8 paths that raised until their slice
    now run: the fp8 SwitchBack linear forward and backward, and the
    fp8_mixed quant-health gauge."""
    from repro_torch.core import switchback as SB
    from repro_torch.optim import make_optimizer
    from repro_torch.telemetry.health import quant_health
    with pytest.raises(NotImplementedError):
        make_optimizer("adafactor", 1e-3)
    x = torch.randn(2, 4, requires_grad=True)
    w = torch.randn(4, 3, requires_grad=True)
    y = SB.switchback_linear(x, w, variant="fp8")
    dx, dw = torch.autograd.grad(y.sum(), (x, w))
    assert y.shape == (2, 3) and bool(torch.isfinite(dx).all() and torch.isfinite(dw).all())
    g = {"blocks": {"mlp": {"w_up": torch.randn(2, 8, 8)}}}
    out = quant_health(g, g, dataclasses.replace(_train_parts(
        get_reduced_config("smollm-360m"))[1], quant_mode="fp8_mixed"))
    assert set(out) == {"qh/mlp/w_absmax", "qh/mlp/fp8_fallback_frac"}
