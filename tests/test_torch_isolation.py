"""The port stands alone: no JAX, no ``repro``, no quiet CPU fallback.

* Every module of ``repro_torch`` (and ``chip_smoke.py``) imports in a
  process where ``import jax`` and ``import repro`` fail.
* No source file of the port, nor ``chip_smoke.py``, names ``jax``,
  ``jaxlib`` or ``repro`` in an import.
* On a host without a card, the entry points refuse to run unless the CPU
  is asked for; the paths the port does not take raise
  ``NotImplementedError``.
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
    for fn in (*KOPS.KERNELS, *FA.KERNELS.values()):
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
    dict(policy="fp8_mixed"),
    dict(policy="fp8"),
])
def test_unported_paths_raise(bad):
    cfg = get_reduced_config("smollm-360m")
    scfg = ServeConfig(max_batch=2, max_len=16, quant_mode="int8_switchback",
                       **bad.get("serve", {}))
    with pytest.raises(NotImplementedError):
        make_serve_engine(build(cfg), scfg, parallel=bad.get("parallel"),
                          policy=QuantPolicy(bad["policy"]) if "policy" in bad else None,
                          device="cpu")


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
    from repro_torch.core import switchback as SB
    from repro_torch.optim import make_optimizer
    from repro_torch.telemetry.health import quant_health
    with pytest.raises(NotImplementedError):
        make_optimizer("adafactor", 1e-3)
    with pytest.raises(NotImplementedError):
        SB.switchback_linear(torch.zeros(2, 4), torch.zeros(4, 3), variant="fp8")
    with pytest.raises(NotImplementedError):
        quant_health({}, {}, dataclasses.replace(_train_parts(
            get_reduced_config("smollm-360m"))[1], quant_mode="fp8_mixed"))
