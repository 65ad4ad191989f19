"""The port's int8-compressed gradient mean (``distributed/compression.py``)
against the JAX package's, on the CPU.

The JAX functions run under ``jax.vmap(..., axis_name="i")`` on one
device, each mapped slice a rank; the port's run on gloo groups of 2 and 4
ranks spawned by the test (``torch_ranks.py``), each rank with its slice.
Leaves of 300 values (a padded last block), 17 x 33 (padded, 2-D), 256 (one
whole block) and 2 x 128 (bf16), and the tree form with error feedback over
two rounds. The port adds the ranks' dequantized payloads in rank order
and divides once, the reference's order: every value is held bit for bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as TR
from repro.distributed import compression as JC
from repro_torch.distributed import compression as C

torch.set_num_threads(1)

SHAPES = {"a": (300,), "b": (17, 33), "c": (256,), "d": (2, 128)}


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(k, shape):
        x = rng.normal(size=shape).astype(np.float32) * 10.0 ** rng.integers(-3, 2)
        # bf16 values in an f32 array: the port's and JAX's bf16 leaf alike
        return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) if k == "d" else x
    gs = [{k: leaf(k, s) for k, s in SHAPES.items()} for _ in range(n)]
    efs = [{k: rng.normal(size=s).astype(np.float32) * 1e-3 for k, s in SHAPES.items()}
           for _ in range(n)]
    return gs, efs


def _stack(trees, k):
    return jnp.stack([jnp.asarray(t[k]) for t in trees])


def _jax(gs, efs):
    """The reference's results, one row per rank."""
    cast = lambda k, x: x.astype(jnp.bfloat16) if k == "d" else x
    single = {k: jax.vmap(lambda g: JC.compressed_allreduce_mean(g, "i"), axis_name="i")(
        cast(k, _stack(gs, k))) for k in SHAPES}
    G = {k: cast(k, _stack(gs, k)) for k in SHAPES}
    tree = jax.vmap(lambda g: JC.compressed_tree_allreduce_mean(g, "i"), axis_name="i")
    s1, ef1 = tree(G)
    ef = {k: ef1[k] + _stack(efs, k) for k in SHAPES}
    s2, ef2 = jax.vmap(lambda g, e: JC.compressed_tree_allreduce_mean(g, "i", e),
                       axis_name="i")(G, ef)
    return [jax.tree.map(np.asarray, t) for t in (single, s1, ef1, s2, ef2)]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"ranks{n}")
def runs(request, tmp_path_factory):
    n = request.param
    gs, efs = _inputs(n, seed=n)
    # the bf16 leaf goes to the port as bf16 too
    port_gs = [{k: (torch.from_numpy(v).to(torch.bfloat16) if k == "d" else v)
                for k, v in g.items()} for g in gs]
    ranks = TR.run_ranks(n, TR.compression, (port_gs, efs), tmp_path_factory.mktemp("c"))
    return n, _jax(gs, efs), ranks


@pytest.mark.parametrize("which", ["single", "tree", "error_feedback", "tree_round2",
                                   "error_feedback_round2"])
def test_compressed_mean_matches_jax_bitwise(runs, which):
    n, want, ranks = runs
    i = ["single", "tree", "error_feedback", "tree_round2", "error_feedback_round2"].index(which)
    for r, got in enumerate(ranks):
        for k in SHAPES:
            g = np.asarray(torch.as_tensor(got[i][k]).float())
            w = np.asarray(want[i][k][r], np.float32)
            assert g.shape == w.shape and np.array_equal(g, w), (which, r, k)
    if which.startswith("tree") or which == "single":      # the same mean on every rank
        for got in ranks[1:]:
            assert all(np.array_equal(got[i][k], ranks[0][i][k]) for k in SHAPES)


@pytest.mark.parametrize("n_params,n_ranks", [(1000, 2), (10**9, 8), (632_076_801, 4)])
def test_wire_bytes_saved_matches_jax(n_params, n_ranks):
    assert C.wire_bytes_saved(n_params, n_ranks) == JC.wire_bytes_saved(n_params, n_ranks)
