"""``wgrad_bf16``'s stated tolerance and its tensor-core model, on the CPU.

The CUDA ``wgrad_bf16`` (``kernels/switchback/csrc/switchback.cu``) sums on
bf16 wgmma: windows of ``ref.WGRAD_WINDOW`` rows of B, each a chain of k16
steps into a fresh fragment, promoted into an f32 accumulator in B order.
On the card it is held to the plain in-order version within
``ref.wgrad_bound``, bit for bit on exactly summable inputs, and bit for
bit to ``wgmma_model.wgrad_rows`` at chosen rows. Here, without a card:

* ``wgrad_rows`` against an independent chain of the same step rule in
  exact rationals (each addend truncated to 2^(E - 25) of the step's
  largest exponent, the sum to 24 significant bits, each window added into
  f32 rounded to nearest even);
* ``wgrad_bound`` containing the model's output, against the plain version
  and the exact sum, on random, wide-range, cancelling and
  in-order-adversarial inputs, with the counted coefficient;
* the model equal to the plain version (and to the exact sum) on exactly
  summable inputs (``fp8_matmul.ref.exact_entries``), where random inputs
  are not.
"""
from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.kernels.fp8_matmul import ref as F8REF
from repro_torch.kernels.fp8_matmul import wgmma_model as F8TC
from repro_torch.kernels.switchback import ref as TREF

torch.set_num_threads(1)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).bfloat16()


def _inputs(kind: str, B: int, K: int, M: int, seed: int):
    """x (B, K), g (B, M) as bf16, drawn by ``kind``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, K))
    g = rng.standard_normal((B, M))
    if kind == "wide":                 # 2^-30 .. 2^30 per entry
        x *= np.exp2(rng.integers(-30, 31, (B, K)))
        g *= np.exp2(rng.integers(-30, 31, (B, M)))
    elif kind == "cancel":             # row b + 1 undoes row b, then a small rest
        x[1::2] = x[0:B - B % 2:2]
        g[1::2] = -g[0:B - B % 2:2]
        g[-3:] *= 2.0 ** -12
    elif kind == "in_order":           # one large row first, many small after
        x[0] *= 2.0 ** 14
        g[0] *= 2.0 ** 6
    return _bf16(x), _bf16(g)


# ---- an independent chain of the step rule in exact rationals ------------

def _floor_log2(v: Fraction) -> int:
    v = abs(v)
    e = v.numerator.bit_length() - v.denominator.bit_length()
    return e if Fraction(2) ** e <= v else e - 1


def _trunc(v: Fraction, e: int) -> Fraction:
    q = Fraction(2) ** e
    return q * int(v / q)                      # int() truncates toward zero


def _round_f32(v: Fraction) -> Fraction:
    """To nearest even f32 (normal range)."""
    if v == 0:
        return v
    q = Fraction(2) ** (_floor_log2(v) - 23)
    n, r = divmod(v / q, 1)
    n = int(n)
    if r > Fraction(1, 2) or (r == Fraction(1, 2) and n % 2):
        n += 1
    return n * q


def _operand_exp(v: Fraction) -> int:
    return max(_floor_log2(v), -126)


def _step(a: list, w: list, frag: Fraction | None) -> Fraction:
    exps = [_operand_exp(x) + _operand_exp(y) for x, y in zip(a, w) if x != 0 and y != 0]
    if frag:
        exps.append(_floor_log2(frag))
    if not exps:
        return Fraction(0)
    e = max(exps) - 25
    s = sum((_trunc(x * y, e) for x, y in zip(a, w)), Fraction(0))
    if frag:
        s += _trunc(frag, e)
    return _trunc(s, _floor_log2(s) - 23) if s else Fraction(0)


def _rational_wgrad(x: torch.Tensor, g: torch.Tensor, row: int, col: int) -> Fraction:
    a = [Fraction(float(v)) for v in x[:, row].float()]
    w = [Fraction(float(v)) for v in g[:, col].float()]
    acc = Fraction(0)
    for k0 in range(0, len(a), TREF.WGRAD_WINDOW):
        frag = None
        for s0 in range(k0, min(k0 + TREF.WGRAD_WINDOW, len(a)), TREF.WGRAD_STEP):
            s1 = min(s0 + TREF.WGRAD_STEP, k0 + TREF.WGRAD_WINDOW, len(a))
            frag = _step(a[s0:s1], w[s0:s1], frag)
        acc = _round_f32(acc + frag)
    return acc


@pytest.mark.parametrize("kind", ["normal", "wide", "cancel"])
@pytest.mark.parametrize("B", [5, 64, 150])
def test_wgrad_model_matches_rational_chain(kind, B):
    x, g = _inputs(kind, B, 3, 4, seed=B)
    model = F8TC.wgrad_rows(x, g, [0, 1, 2])
    for r in range(3):
        for c in range(4):
            assert Fraction(float(model[r, c])) == _rational_wgrad(x, g, r, c), (r, c)


def test_wgrad_coefficient_is_counted():
    """64 products, 3 fragments and 4 step sums truncated per window; half
    an ulp per window add and per in-order add of the plain version; one
    f32 ulp at the bound."""
    assert TREF.WGRAD_ADDENDS == 64 + 3 + 4
    B = 4128
    x = torch.ones((B, 1), dtype=torch.bfloat16)
    g = torch.full((B, 1), 0.5, dtype=torch.bfloat16)
    terms = (71 + (65 - 1) / 2 + (B - 1) / 2) * 2.0 ** -23 * (B * 0.5)
    ulp = 2.0 ** (math.frexp(terms)[1] - 24)
    assert float(TREF.wgrad_bound(torch.zeros(1, 1), x, g)) == terms + ulp


@pytest.mark.parametrize("kind", ["normal", "wide", "cancel", "in_order"])
@pytest.mark.parametrize("B,K,M", [(8, 24, 16), (200, 16, 24), (700, 8, 12)])
def test_wgrad_bound_contains_the_model(kind, B, K, M):
    x, g = _inputs(kind, B, K, M, seed=B + K)
    plain = TREF.wgrad_bf16(x, g)
    model = F8TC.wgrad_rows(x, g, list(range(K)))
    exact = x.double().t() @ g.double()
    bound = TREF.wgrad_bound(plain, x, g)
    assert bool(((model.double() - plain.double()).abs() <= bound).all())
    # the model and the plain version each inside the bound of the exact sum
    assert bool(((model.double() - exact).abs() <= bound).all())
    assert bool(((plain.double() - exact).abs() <= bound).all())


def test_wgrad_bound_sees_a_row_shift():
    """Ẏ's rows shifted by one (phase 27's control fault) lands outside."""
    x, g = _inputs("normal", 256, 16, 16, seed=1)
    plain = TREF.wgrad_bf16(x, g)
    fault = F8TC.wgrad_rows(x, g.roll(1, dims=0), list(range(16)))
    assert not bool(((fault.double() - plain.double()).abs()
                     <= TREF.wgrad_bound(plain, x, g)).all())


@pytest.mark.parametrize("B,K,M", [(8, 24, 16), (130, 16, 24), (1000, 8, 12)])
def test_wgrad_model_is_plain_on_exact_entries(B, K, M):
    gen = torch.Generator().manual_seed(B)
    x = F8REF.exact_entries((B, K), gen).bfloat16()
    g = F8REF.exact_entries((B, M), gen).bfloat16()
    plain = TREF.wgrad_bf16(x, g)
    model = F8TC.wgrad_rows(x, g, list(range(K)))
    assert torch.equal(model.view(torch.int32), plain.view(torch.int32))
    assert torch.equal(plain.double(), x.double().t() @ g.double())


def test_random_entries_are_not_exact():
    """On random entries the model and the in-order sum part (what makes
    the exact-entry check above a check of layout, not a tautology)."""
    x, g = _inputs("wide", 300, 8, 12, seed=3)
    model = F8TC.wgrad_rows(x, g, list(range(8)))
    assert not torch.equal(model, TREF.wgrad_bf16(x, g))
