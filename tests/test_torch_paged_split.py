"""The paged-attention kernels' bf16 split of their f32 operands, on the CPU.

The CUDA paged kernels (``kernels/paged_attention/csrc/paged_attention.cu``)
compute on the tensor cores, whose operands are bf16. An operand that is
not exact in bf16 is split into bf16 terms (``ref.split_bf16``, the
kernels' split): q * scale one term when q is bf16 and scale a power of
two, three otherwise; the softmax weights P three (two, within 2^-16 of
p, were too few for the served bf16 model); an f32 pool's K and V three.
Here each split is held to its stated width: three terms sum to the f32
value exactly, two within 2^-16 of it, one exactly where it is said to
be exact, and no fewer terms would do. ``tests/test_torch_flash_split.py``
models the whole tile step.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import softmax_scale
from repro_torch.kernels.paged_attention import ref as PREF

torch.set_num_threads(1)


def _f32(seed: int, n: int, lo: int, hi: int) -> torch.Tensor:
    """n f32 values, random significands over binades 2^lo .. 2^hi, both signs."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(1.0, 2.0, n) * np.exp2(rng.integers(lo, hi + 1, n)) * rng.choice([-1, 1], n)
    return torch.from_numpy(v.astype(np.float32))


def _sum(terms) -> torch.Tensor:
    return sum(t.double() for t in terms)


@pytest.mark.parametrize("lo,hi", [(-20, 20), (-100, 100), (-3, 0)])
def test_three_terms_are_exact(lo, hi):
    x = _f32(lo + 1000, 20000, lo, hi)
    terms = PREF.split_bf16(x, 3)
    assert all(t.dtype == torch.bfloat16 for t in terms)
    assert torch.equal(_sum(terms), x.double())
    # each term at most half a bf16 ulp of what the earlier ones left
    assert bool((terms[1].double().abs() <= x.double().abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("lo,hi", [(-20, 20), (-30, 0)])
def test_two_terms_within_2_to_minus_16(lo, hi):
    x = _f32(lo + 2000, 20000, lo, hi)
    err = (_sum(PREF.split_bf16(x, 2)) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -16
    assert float(err.max()) > 2.0 ** -18          # the width is what two terms give
    one = (_sum(PREF.split_bf16(x, 1)) - x.double()).abs() / x.double().abs()
    assert float(one.max()) > 2.0 ** -10           # one term would not do


def test_softmax_weights_in_two_terms():
    """P = exp(s - m) in (0, 1], as the online softmax makes it."""
    gen = torch.Generator().manual_seed(5)
    s = torch.randn(50000, generator=gen) * 6
    p = torch.exp(s - s.max())
    p = p[p > 0]
    err = (_sum(PREF.split_bf16(p, 2)) - p.double()).abs()
    assert bool((err <= p.double() * 2.0 ** -16).all())


@pytest.mark.parametrize("hd", [16, 64])
def test_bf16_q_times_a_power_of_two_scale_is_one_term(hd):
    scale = softmax_scale(hd)
    assert np.frexp(scale)[0] == 0.5
    gen = torch.Generator().manual_seed(hd)
    q = (torch.randn(4096, generator=gen) * 3).bfloat16()
    qs = q.float() * scale
    (hi,) = PREF.split_bf16(qs, 1)
    assert torch.equal(hi.double(), qs.double())


@pytest.mark.parametrize("hd,qdt", [(40, torch.bfloat16), (64, torch.float32)])
def test_other_q_needs_three_terms(hd, qdt):
    """f32 q, or a scale that is no power of two, leave bits one term
    drops: the kernels take three there, which are exact."""
    gen = torch.Generator().manual_seed(hd)
    qs = (torch.randn(4096, generator=gen) * 3).to(qdt).float() * softmax_scale(hd)
    assert not torch.equal(_sum(PREF.split_bf16(qs, 1)), qs.double())
    assert torch.equal(_sum(PREF.split_bf16(qs, 3)), qs.double())
