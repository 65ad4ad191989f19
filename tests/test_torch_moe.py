"""The port's mixture-of-experts layer against the JAX package's, on the CPU.

``models/moe.py`` piece by piece, on inputs drawn from seeded numpy and
carried to both packages; the JAX side runs eagerly (op by op, so XLA keeps
no bf16 intermediate in f32) on its ``xla`` backend:

* the configs: each new CONFIG and REDUCED equal to JAX's field for field;
* the top k: indices and values bit for bit, ties toward the lower index
  (constructed ties, as ``jax.lax.top_k``);
* the router: experts bit for bit (a random batch, and one whose router
  weight has duplicated columns, so probabilities tie exactly); gates and
  the aux loss within ROUTER_TOL: XLA's exp and its softmax's sum differ
  from torch's in the last bit (measured 1.4e-7 and 2.2e-7 relative);
* the dispatch, fed the JAX router's gates and experts: the dispatched
  rows, each slot's token and gate, and so the drops, bit for bit, on a
  random batch and on one that overflows capacity;
* the combine: a token's output is the same bits when the other tokens of
  its group are permuted (capacity not crossed);
* ``expert_linear`` against JAX's (vmapped SwitchBack or ``dot_general``):
  forward, Ẋ and Ẇ; ``int8_switchback`` bit for bit where the arithmetic
  is exact (forward and Ẋ: s32 sums) and Ẇ (f32 sums in another order)
  within WGRAD_TOL; ``bf16`` (torch's bf16 product against XLA's) and
  ``fp8`` (the 2-D kernels' plain versions looped over experts) within
  their tolerances (every reading 0 at these shapes, Ẇ included);
* ``moe_block`` on the reduced qwen3-moe and arctic layers, bf16 and
  ``int8_switchback``: the output within BLOCK_TOL of max|out| (measured
  1.8e-3 for qwen3 in bf16, 0 in the other three) and the aux loss within
  ROUTER_TOL (1.2e-7).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.core.precision import QuantPolicy as JPolicy
from repro.models import build as jax_build
from repro.models import moe as JMOE
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import ALL_ARCHS, get_config, get_reduced_config
from repro_torch.core.precision import QuantPolicy
from repro_torch.models import moe as MOE
from repro_torch.models.params import from_numpy_tree

torch.set_num_threads(1)

NEW_ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b", "minitron-8b")
ROUTER_TOL = 1e-6          # gates and aux, relative to their max
WGRAD_TOL = 1e-6           # Ẇ against max|Ẇ|: f32 sums in another order
BF16_TOL = 2.0 ** -7       # one bf16 ulp of max|y|: torch's and XLA's bf16 products
FP8_TOL = 2.0 ** -3        # a quantization step moved by a last-bit difference
BLOCK_TOL = 2.0 ** -6      # moe_block's output: the router's last bits through bf16


def _j(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(
        {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[t.dtype])


def _np(a) -> np.ndarray:
    """A torch tensor or a JAX array as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_jax(arch):
    assert arch in ALL_ARCHS
    for mine, theirs in ((get_config(arch), jax_config(arch)),
                         (get_reduced_config(arch), jax_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert [mine.layer_is_moe(i) for i in range(mine.n_layers)] == \
            [theirs.layer_is_moe(i) for i in range(theirs.n_layers)]
        assert [mine.layer_kind(i) for i in range(mine.n_layers)] == \
            [theirs.layer_kind(i) for i in range(theirs.n_layers)]


def test_top_k_breaks_ties_toward_the_lower_index():
    rng = np.random.default_rng(0)
    p = rng.integers(0, 4, size=(64, 16)).astype(np.float32) / 4     # many ties
    vals, idx = MOE.stable_top_k(torch.from_numpy(p), 5)
    jv, ji = jax.lax.top_k(jnp.asarray(p), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def _router_inputs(T, D, E, tied, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32)).bfloat16()
    w = rng.standard_normal((D, E)).astype(np.float32) / np.sqrt(D)
    if tied:                          # experts 1, 5 and 6 copy 0, 2 and 2: exact ties
        w[:, 1], w[:, 5], w[:, 6] = w[:, 0], w[:, 2], w[:, 2]
    return x, torch.from_numpy(w).bfloat16()


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
def test_router_matches_jax(tied):
    E, K = 8, 2
    x, w = _router_inputs(96, 64, E, tied)
    gates, experts, aux = MOE.router(x, w, E, K)
    jg, je, jaux = JMOE._router(_j(x), _j(w), E, K)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(je))
    assert _rel(gates.numpy(), np.asarray(jg)) <= ROUTER_TOL
    assert _rel(float(aux), float(jaux)) <= ROUTER_TOL
    if tied:   # the tied pairs reach the top k, the lower index first
        both = experts.numpy()
        assert ((both[:, 0] == 0) & (both[:, 1] == 1)).any() or \
            ((both[:, 0] == 2) & (both[:, 1] == 5)).any()
        assert not ((both[:, 0] == 1) & (both[:, 1] == 0)).any()
        assert not ((both[:, 0] == 5) & (both[:, 1] == 2)).any()


@pytest.mark.parametrize("overflow", [False, True], ids=["random", "overflow"])
def test_dispatch_matches_jax(overflow):
    """Fed the JAX router's gates and experts, the dispatch's rows, slot
    tokens and slot gates bit for bit: at a capacity nothing crosses, and
    at the layer's capacity on a batch whose tokens lean to one expert, so
    that it drops many (and the drops must agree)."""
    T, D, E, K = 64, 32, 8, 2
    x, w = _router_inputs(T, D, E, tied=False, seed=3)
    if overflow:
        w[:, 3] = (x.float().sum(0) / 8).bfloat16()    # every token leans to expert 3
    jg, je, _ = JMOE._router(_j(x), _j(w), E, K)
    C = MOE.capacity(T, K, E, 1.25) if overflow else T * K   # random: no drops
    jx, jtok, jw = JMOE._group_dispatch(_j(x), jg, je, E, C)
    gates = torch.from_numpy(np.array(jg))
    experts = torch.from_numpy(np.array(je)).long()
    x_disp, slot_token, slot_w, token_slots = MOE.group_dispatch(x, gates, experts, E, C)
    np.testing.assert_array_equal(x_disp.float().numpy(), _np(jx))
    np.testing.assert_array_equal(slot_token.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(slot_w.numpy(), np.asarray(jw))
    kept = int((slot_token < T).sum())
    assert (kept < T * K) == overflow                  # the drops happen where asked
    # every kept assignment is in its token's slots, ascending, E*C after them
    assert int((token_slots < E * C).sum()) == kept
    assert torch.equal(token_slots, torch.sort(token_slots, dim=-1).values)


def test_combine_does_not_depend_on_the_other_tokens():
    """A token's output is the same bits whichever other tokens share its
    group, in whatever order (no capacity crossed): each token sums its own
    slots in ascending order, never in the order of an atomic add."""
    T, D, E, K = 48, 32, 8, 2
    x, w = _router_inputs(T, D, E, tied=False, seed=5)
    C = 4 * T                                          # nothing drops
    rng = np.random.default_rng(1)
    expert_w = torch.from_numpy(rng.standard_normal((E, D, D)).astype(np.float32)).bfloat16()

    def layer(xs):
        gates, experts, _ = MOE.router(xs, w, E, K)
        x_disp, _, slot_w, token_slots = MOE.group_dispatch(xs, gates, experts, E, C)
        y = torch.bmm(x_disp, expert_w)
        return MOE.combine(y.reshape(E * C, D), slot_w, token_slots, torch.bfloat16)

    base = layer(x)
    for seed in range(3):
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(T))
        out = layer(x[perm])
        assert torch.equal(out, base[perm])


def _expert_case(E=4, C=6, n=48, m=40, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((E, C, n)).astype(np.float32)).bfloat16()
    x[1, 2] = 0.0                                      # an empty slot's zero row
    w = torch.from_numpy((rng.standard_normal((E, n, m)) / np.sqrt(n)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((E, C, m)).astype(np.float32)).bfloat16()
    return x, w.bfloat16(), g


@pytest.mark.parametrize("mode", ["int8_switchback", "bf16", "fp8"])
def test_expert_linear_matches_jax(mode):
    x, w, g = _expert_case()
    jpol = JPolicy(mode)
    jy, vjp = jax.vjp(lambda a, b: JMOE.expert_linear(a, b, jpol), _j(x), _j(w))
    jdx, jdw = vjp(_j(g))
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = MOE.expert_linear(xa, wa, QuantPolicy(mode))
    y.backward(g)
    assert y.dtype == torch.bfloat16 and wa.grad.dtype == torch.bfloat16
    if mode == "int8_switchback":
        np.testing.assert_array_equal(_np(y), _np(jy))
        np.testing.assert_array_equal(_np(xa.grad), _np(jdx))
        assert _rel(_np(wa.grad), _np(jdw)) <= WGRAD_TOL
        return
    tol = BF16_TOL if mode == "bf16" else FP8_TOL
    assert _rel(_np(y), _np(jy)) <= tol
    assert _rel(_np(xa.grad), _np(jdx)) <= tol
    assert _rel(_np(wa.grad), _np(jdw)) <= BF16_TOL


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b"])
def test_moe_block_matches_jax(arch):
    jcfg = jax_reduced(arch)
    cfg = get_reduced_config(arch)
    jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: np.asarray(a)[0], jp["blocks"]["pos0"]["moe"])
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)).bfloat16()
    for mode in ("bf16", "int8_switchback"):
        jout, jaux = JMOE.moe_block(_j(x), jax.tree.map(jnp.asarray, lp), jcfg, JPolicy(mode))
        out, aux = MOE.moe_block(x, from_numpy_tree(lp, device="cpu"), cfg, QuantPolicy(mode))
        assert out.shape == x.shape and out.dtype == x.dtype
        assert _rel(out.float().numpy(), _np(jout)) <= BLOCK_TOL, mode
        assert _rel(float(aux), float(jaux)) <= ROUTER_TOL, mode
