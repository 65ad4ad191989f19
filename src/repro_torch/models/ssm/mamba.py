"""Mamba selective SSM block (Gu & Dao 2023), for the Jamba hybrid.

The PyTorch counterpart of ``repro/models/ssm/mamba.py``, operation for
operation:

    x -> in_proj -> (x_ssm, z gate)
    x_ssm -> causal conv1d -> silu -> selective scan -> ·silu(z) -> out_proj

Selective scan per channel c with state dim N:
    h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t        (A diagonal, (d_inner, N))
    y_t = C_t · h_t + D x_t

The three projections (``w_in``, ``w_x_proj``, ``w_out``) go through
``quant_linear``, so under ``int8_switchback`` they run the SwitchBack
kernels. The rest is elementwise or a small-N contraction, which the JAX
package computes outside any Pallas kernel (the recurrence is a
``lax.scan`` in f32): here it is plain PyTorch, the recurrence a loop over
time. Decode keeps (conv window, h) as the recurrent state, O(1) a token.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.precision import QuantPolicy, quant_linear
from repro_torch.models import params as PRM


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, d_inner) the last raw inputs of the causal conv
    h: torch.Tensor      # (B, d_inner, N) f32 SSM state


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), with no threshold (``F.softplus`` returns x above
    20 and computes log1p(exp(x)) below it, other bits); the gradient is
    JAX's rule for logaddexp, g · exp(x - out), 0 where x is +inf."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        out = torch.where(torch.isnan(x), x, out)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        x = torch.where(x == float("inf"), torch.zeros_like(x), x)
        return g * torch.exp(x - out)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def _conv1d_causal(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                   prefix: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); kernel: (K, C); ``prefix``: the
    K - 1 inputs before x (zeros when None). Summed in f32 from zeros, tap
    0 first, the bias last, cast to x's dtype."""
    K, S = kernel.shape[0], x.shape[1]
    if prefix is None:
        prefix = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([prefix, x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + S].float() * kernel[i].float()
    return (out + bias.float()).to(x.dtype)


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, D: torch.Tensor, h0: torch.Tensor | None = None):
    """u, delta: (B, S, d); A: (d, N); B, C: (B, S, N); D: (d,). The
    recurrence in f32, one step a position. Returns (y (B, S, d) in u's
    dtype, h_final (B, d, N) f32)."""
    Bsz, S, d = u.shape
    N = A.shape[1]
    uf, df = u.float(), delta.float()
    dA = torch.exp(df[..., None] * A[None, None])                       # (B, S, d, N)
    dBu = df[..., None] * B[:, :, None, :].float() * uf[..., None]
    Cf = C.float()
    h = h0 if h0 is not None else torch.zeros((Bsz, d, N), dtype=torch.float32,
                                              device=u.device)
    ys = []
    for t in range(S):
        h = dA[:, t] * h + dBu[:, t]                                    # (B, d, N)
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + uf * D.float()[None, None]
    return y.to(u.dtype), h


def mamba_block(x: torch.Tensor, p: dict, cfg, policy: QuantPolicy, *,
                state: MambaState | None = None):
    """x: (B, S, D) -> (out (B, S, D), the new MambaState). The conv state
    is the last d_conv - 1 raw inputs (after the split, before the conv)."""
    mc = cfg.mamba
    B, S, D = x.shape
    d_inner = mc.expand * D
    N = mc.d_state
    dt_rank = mc.dt_rank or -(-D // 16)

    cd = policy.compute_dtype
    xz = quant_linear(x, PRM.use_weight(p["w_in"], ("embed", "mlp"), cd),
                      policy=policy)                                    # (B, S, 2 d_inner)
    xs_raw, z = torch.split(xz, d_inner, dim=-1)
    prefix = (state.conv.to(x.dtype) if state is not None else
              torch.zeros((B, mc.d_conv - 1, d_inner), dtype=x.dtype, device=x.device))
    xs_ = _conv1d_causal(xs_raw, p["conv_w"], p["conv_b"], prefix)
    hist = torch.cat([prefix, xs_raw.to(prefix.dtype)], dim=1)
    new_conv = hist[:, hist.shape[1] - (mc.d_conv - 1):]
    xs_ = F.silu(xs_.float()).to(x.dtype)

    # the data-dependent Δ, B, C
    dbc = quant_linear(xs_, PRM.use_weight(p["w_x_proj"], ("mlp", None), cd),
                       policy=policy)                                   # (B, S, dt_rank + 2N)
    dt, Bm, Cm = torch.split(dbc, [dt_rank, N, N], dim=-1)
    delta = softplus(torch.matmul(dt.float(), p["w_dt"].float())
                     + p["dt_bias"].float()).to(x.dtype)                # (B, S, d_inner)
    A = -torch.exp(p["A_log"].float())                                  # (d_inner, N)

    h0 = state.h if state is not None else None
    y, h_final = selective_scan(xs_, delta, A, Bm, Cm, p["D"], h0)
    y = y * F.silu(z.float()).to(x.dtype)
    out = quant_linear(y, PRM.use_weight(p["w_out"], ("mlp", "embed"), cd),
                       policy=policy)
    return out, MambaState(new_conv, h_final)
