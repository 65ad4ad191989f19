"""The port's sharding rules and meshes against the JAX package's.

* Rules: ``default_rules``, ``nofsdp_rules``, ``logical_to_pspec`` and
  ``_divisible`` give JAX's tables and pspecs entry for entry, on every
  ParamSpec of the full-width smollm-360m and CLIP ViT-H/14, over meshes
  (1, 1), (2, 1), (4, 1), (2, 2), (2, 4) and (2, 2, 2) with ``pod``, under
  plain, ``fsdp``, ``pure_dp``, both, and ``shard_kv_heads=False``. JAX's
  ``_divisible`` reads only ``mesh.shape``, so both take a stand-in
  mapping (this lane has one JAX device).
* The optimizers' ``state_logical_axes`` (StableAdamW, AdamW, AdaFactor
  with and without a first moment) equal JAX's on both configs.
* Meshes, on 4 gloo ranks spawned by the test: sizes, each rank's index
  along one and several axes (row-major, as a JAX pspec entry lays out a
  dim), the group's ranks in that order, the CLI's meshes (``auto`` (4,
  1), ``test`` (2, 2), ``single`` shrunk to (2, 2), ``multi`` refused
  below 8 ranks) and a leaf split over ("pod", "data") gathered back.
"""
from __future__ import annotations

import pytest
import torch

import torch_ranks as TR
from repro.configs import get_config as jax_config
from repro.configs.base import ParallelConfig as JParallel
from repro.models import build as jax_build
from repro.models import params as JP
from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro.optim import stable_adamw as jax_stable_adamw
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.models import build
from repro_torch.models import params as PRM
from repro_torch.optim import adafactor, adamw, stable_adamw

torch.set_num_threads(1)

ARCHS = ("smollm-360m", "clip-vit-huge", "rwkv6-1.6b", "jamba-v0.1-52b")
MESHES = {"1x1": ((1, 1), ("data", "model")), "2x1": ((2, 1), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
FLAGS = {"plain": {}, "fsdp": {"fsdp": True}, "pure_dp": {"pure_dp": True},
         "pure_dp-fsdp": {"pure_dp": True, "fsdp": True},
         "no_kv_shard": {"shard_kv_heads": False},
         "fsdp-no_kv_shard": {"fsdp": True, "shard_kv_heads": False}}


class _Shape:
    """A mesh's ``shape`` mapping alone (all ``_divisible`` reads)."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


_SPECS: dict = {}


def _specs(arch):
    if arch not in _SPECS:
        _SPECS[arch] = (dict(PRM.tree_paths(build(get_config(arch)).param_specs)),
                        dict(PRM.tree_paths(jax_build(jax_config(arch)).param_specs)))
    return _SPECS[arch]


def _jax_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_paths(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_pspecs_match_jax(arch, mesh, flags):
    shape, axes = MESHES[mesh]
    kw = dict(mesh_shape=shape, mesh_axes=axes, **FLAGS[flags])
    mine, theirs = ParallelConfig(**kw), JParallel(**kw)
    rules, jrules = PRM.default_rules(mine), JP.default_rules(theirs)
    assert rules == jrules
    assert mine.data_axes == theirs.data_axes
    assert PRM.nofsdp_rules(rules, rules["batch"]) == JP.nofsdp_rules(jrules, jrules["batch"])
    m = _Shape(shape, axes)
    specs, jspecs = _specs(arch)
    assert specs.keys() == dict(_jax_paths(jax_build(jax_config(arch)).param_specs)).keys()
    for path, s in specs.items():
        js = jspecs[path]
        assert (tuple(s.shape), tuple(s.logical)) == (tuple(js.shape), tuple(js.logical)), path
        ps = PRM.logical_to_pspec(s.logical, rules)
        assert ps == tuple(JP.logical_to_pspec(js.logical, jrules)), path
        assert PRM._divisible(s.shape, ps, m) == tuple(JP._divisible(js.shape, ps, m)), path


def _axes_items(tree, prefix=""):
    """(path, logical axes) of a state_logical_axes tree (NamedTuples and
    dicts of tuples)."""
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _axes_items(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _axes_items(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tuple(tree)


OPTIMIZERS = {"stable_adamw": (stable_adamw, jax_stable_adamw, {}),
              "adamw": (adamw, jax_adamw, {}),
              "adafactor": (adafactor, jax_adafactor, {}),
              "adafactor-beta1": (adafactor, jax_adafactor, {"beta1": 0.9})}


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_logical_axes_match_jax(arch, opt):
    mk, jmk, kw = OPTIMIZERS[opt]
    mine = mk(1e-3, **kw).state_logical_axes(build(get_config(arch)).param_specs)
    theirs = jmk(1e-3, **kw).state_logical_axes(jax_build(jax_config(arch)).param_specs)
    assert list(_axes_items(mine)) == list(_axes_items(theirs))


@pytest.fixture(scope="module")
def facts(tmp_path_factory):
    return TR.run_ranks(4, TR.mesh_facts, (), tmp_path_factory.mktemp("mesh"))


def test_mesh_indices_and_groups(facts):
    for rank, f in enumerate(facts):
        d, mo = divmod(rank, 2)
        assert f[("data",)][:2] == (2, d) and f[("model",)][:2] == (2, mo)
        assert f[("data", "model")][:2] == (4, rank)
        # a group's ranks come in index order: row-major over its axes
        assert f[("data",)][2] == [mo, 2 + mo] and f[("model",)][2] == [2 * d, 2 * d + 1]
        assert f[("data", "model")][2] == [0, 1, 2, 3]


def test_cli_meshes(facts):
    cli = facts[0]["cli"]
    assert cli["auto"] == {"data": 4, "model": 1}
    assert cli["test"] == {"data": 2, "model": 2}
    assert cli["single"] == {"data": 2, "model": 2}
    assert "needs >= 8 ranks" in cli["multi"]


def test_pod_axes_split_and_gather(facts):
    for rank, f in enumerate(facts):
        index, local, round_trip, order = f["pod"]
        assert index == rank and round_trip and order == [0, 1, 2, 3]
        assert local == [[6 * rank + j for j in range(3)], [6 * rank + 3 + j for j in range(3)]]
