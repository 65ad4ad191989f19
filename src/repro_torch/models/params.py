"""ParamSpec machinery: one declarative tree drives parameter init.

The PyTorch counterpart of ``repro/models/params.py``, without the
sharding rules (one card, no mesh). Parameter trees are nested dicts of
tensors with the JAX package's leaf names, leading group dimension and
``(n_in, m_out)`` weight layout, so ``from_numpy_tree`` carries the JAX
package's parameters across unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # logical axis name per dim
    init: str = "normal"                 # normal|zeros|ones|constant|fan_in
    scale: float = 0.02                  # stddev for normal / value for constant
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more dict trees of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_paths(tree, prefix: str = ""):
    """(path, leaf) pairs in sorted key order, the order ``jax.tree``
    flattens dicts in (sums over leaves add in the same order); ``path``
    is JAX's ``keystr`` form, ``['blocks']['pos0']['attn']['wq']``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, by_path: dict, prefix: str = ""):
    """A tree shaped like ``like`` whose leaves come from ``by_path``
    (keyed as ``tree_paths`` names them)."""
    if isinstance(like, dict):
        return {k: tree_unflatten(v, by_path, f"{prefix}[{k!r}]") for k, v in like.items()}
    return by_path[prefix]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device. Asking for the card on a host that has
    none raises: an entry point never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def init_params(specs, generator: torch.Generator | int = 0, *, device="cuda"):
    """Random parameters for a spec tree, drawn from ``generator`` (a
    ``torch.Generator`` on ``device``, or an int seed for one) in sorted
    leaf order. Same init kinds and scales as the JAX package; the numbers
    differ, since torch's generator is not JAX's threefry."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)

    def one(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "constant":
            return torch.full(spec.shape, spec.scale, dtype=spec.dtype, device=device)
        std = spec.scale
        if spec.init == "fan_in":     # scale multiplies 1/sqrt(fan_in)
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale / math.sqrt(fan_in)
        w = torch.randn(spec.shape, dtype=spec.dtype, device=device, generator=generator)
        return w.mul_(std)

    # draw in sorted leaf order so the stream does not depend on dict order
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return one(tree)

    return walk(specs)


def from_numpy_tree(tree, device="cuda"):
    """The JAX package's parameter tree, as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's tree of tensors on
    ``device``: same leaf names, same shapes, same values."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def use_weight(w: torch.Tensor, logical: Tuple[Optional[str], ...] = (),
               dtype=None) -> torch.Tensor:
    """Prepare a weight for a matmul: cast to ``dtype`` when one is given.
    The JAX package also pins its sharding here; the port has none.
    ``logical`` is kept so call sites read as in the JAX package. The
    layers pass the compute dtype exactly where the JAX layers do, so the
    f32 weight gradient of ``quant_linear`` is cast to that dtype and
    widened back on its way to the f32 master: rounded through bf16, as
    ``jax.grad`` rounds it in the JAX package."""
    return w if dtype is None else w.to(dtype)
