"""RWKV-6 "Finch" time-mix block (arXiv:2404.05892): attention-free, with
a data-dependent decay per channel.

The PyTorch counterpart of ``repro/models/ssm/rwkv6.py``, operation for
operation. Per head with key/value dim hd and state S ∈ R^{hd×hd}:

    out_t = r_t · (diag(u)·(k_tᵀ v_t) + S_t)
    S_{t+1} = diag(w_t) S_t + k_tᵀ v_t

where w_t = exp(-exp(w0 + LoRA_w(x̃_t))) and x̃ are the token-shifted mixes
x̃ = lerp(x_t, x_{t-1}, μ + LoRA_μ(...)) of the r/k/v/w/g channels (one
shared LoRA-A for the mixes, as in the JAX package).

The r/k/v/g/output projections and the channel mix's three go through
``quant_linear`` (the SwitchBack kernels under ``int8_switchback``). The
recurrence, its chunked (matmul) form, the LoRA products and the group
norm are computed outside any Pallas kernel in the JAX package, and are
plain PyTorch here: the scan a loop over time in f32, the chunked form a
loop over chunks of 64.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.precision import QuantPolicy, quant_linear
from repro_torch.models import params as PRM
from repro_torch.models.common import group_norm_heads

#: the floor of w before its log, as the JAX package writes it (below f32's
#: smallest normal)
LOG_FLOOR = 1e-38


class RWKVState(NamedTuple):
    wkv: torch.Tensor        # (B, H, hd, hd) f32 recurrent state
    x_prev: torch.Tensor     # (B, D) the previous time-mix input (token shift)
    cm_x_prev: torch.Tensor  # (B, D) the previous channel-mix input (token shift)


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """The sequence shifted right by one; the first position takes x_prev."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, x_shift, mu, lora_a, lora_b):
    """x̃ = x + (x_shift - x)·(μ + tanh((x_shift - x)·A)·B), Finch's DDLerp:
    the LoRA in f32, cast back, the rest in x's dtype."""
    dx = x_shift - x
    dyn = torch.tanh(torch.matmul(dx.float(), lora_a.float()))
    dyn = torch.matmul(dyn, lora_b.float()).to(x.dtype)
    return x + dx * (mu.to(x.dtype) + dyn)


def _decay(xw: torch.Tensor, p: dict) -> torch.Tensor:
    """w_t = exp(-exp(w0 + tanh(x̃_w A_w) B_w)) ∈ (0, 1), per channel, f32."""
    low = torch.tanh(torch.matmul(xw.float(), p["w_lora_a"].float()))
    low = torch.matmul(low, p["w_lora_b"].float())
    logw = p["w0"].float() + low
    return torch.exp(-torch.exp(logw))


def _log_w(w: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp_min(w.float(), LOG_FLOOR))


def rwkv6_scan(r, k, v, w, u):
    """The recurrence, one step a position. r, k, v, w: (B, S, H, hd); u:
    (H, hd). Returns (out (B, S, H, hd) f32, final state (B, H, hd, hd))."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]                 # (B, H, hd, hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], uf * kv + state))
        state = wf[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def rwkv6_step(r, k, v, w, u, s0):
    """One token's update of the recurrence (a decode step). r, k, v, w:
    (B, H, hd); u: (H, hd); s0: (B, H, hd, hd) f32. Returns (out (B, H, hd)
    f32, the new state)."""
    kv = k[..., :, None].float() * v[..., None, :].float()
    out = torch.einsum("bhk,bhkv->bhv", r.float(), u.float()[None, :, :, None] * kv + s0)
    return out, w.float()[..., None] * s0 + kv


def rwkv6_chunked(r, k, v, w, u, chunk: int = 64):
    """The chunk-parallel form: S / chunk sequential steps of matmuls
    instead of S elementwise steps; equal to ``rwkv6_scan`` up to rounding.
    Within a chunk, with D the inclusive cumulative sum of log w and E the
    exclusive one: A[i, j] = Σ_d r_i k_j exp(E_i - D_j) for j < i, the
    diagonal takes u; across chunks the state carries with the chunk's
    total decay."""
    B, S, H, hd = r.shape
    assert S % chunk == 0, "pad sequence to a chunk multiple"
    n = S // chunk
    rf, kf, vf = (t.float() for t in (r, k, v))
    logw = _log_w(w)
    rc = rf.reshape(B, n, chunk, H, hd)
    kc = kf.reshape(B, n, chunk, H, hd)
    vc = vf.reshape(B, n, chunk, H, hd)
    lw = logw.reshape(B, n, chunk, H, hd)
    D = torch.cumsum(lw, dim=2)                                         # inclusive
    uf = u.float()

    E = D - lw                                                          # exclusive
    q_ = rc * torch.exp(E)
    k_ = kc * torch.exp(-D)
    A = torch.einsum("bnihd,bnjhd->bnhij", q_, k_)
    idx = torch.arange(chunk, device=r.device)
    A = torch.where((idx[:, None] > idx[None, :])[None, None, None], A,
                    torch.zeros((), dtype=A.dtype, device=A.device))
    diag = torch.einsum("bnihd,bnihd->bnih", rc * uf[None, None, None], kc)
    out = torch.einsum("bnhij,bnjhd->bnihd", A, vc)
    out = out + diag[..., None] * vc

    kv_chunk = torch.einsum("bnjhd,bnjhe->bnhde", kc * torch.exp(D[:, :, -1:] - D), vc)
    decay_chunk = torch.exp(D[:, :, -1])                                # (B, n, H, hd)
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    inter = []
    for i in range(n):
        inter.append(torch.einsum("bihd,bhde->bihe", q_[:, i], state))
        state = decay_chunk[:, i][..., None] * state + kv_chunk[:, i]
    out = out + torch.stack(inter, dim=1)
    return out.reshape(B, S, H, hd), state


def rwkv6_block(x: torch.Tensor, p: dict, cfg, policy: QuantPolicy, *,
                state: RWKVState | None = None):
    """The RWKV-6 time-mix sub-block. x: (B, S, D) -> (out (B, S, D), the
    new RWKVState). One token (S == 1) takes one recurrence update; a
    sequence of a multiple of 64 with no state the chunked form; any other
    the scan, with an initial state's contribution folded in after it."""
    B, S, D = x.shape
    hd = cfg.rwkv.head_dim
    H = D // hd
    x_prev = (state.x_prev if state is not None
              else torch.zeros((B, D), dtype=x.dtype, device=x.device))
    xs = _token_shift(x, x_prev)

    xr = _mix(x, xs, p["mu_r"], p["mix_lora_a"], p["mix_lora_b_r"])
    xk = _mix(x, xs, p["mu_k"], p["mix_lora_a"], p["mix_lora_b_k"])
    xv = _mix(x, xs, p["mu_v"], p["mix_lora_a"], p["mix_lora_b_v"])
    xw = _mix(x, xs, p["mu_w"], p["mix_lora_a"], p["mix_lora_b_w"])
    xg = _mix(x, xs, p["mu_g"], p["mix_lora_a"], p["mix_lora_b_g"])

    cd = policy.compute_dtype

    def proj(t, name):
        return quant_linear(t, PRM.use_weight(p[name], ("embed", "heads"), cd), policy=policy)

    r = proj(xr, "wr").reshape(B, S, H, hd)
    k = proj(xk, "wk").reshape(B, S, H, hd)
    v = proj(xv, "wv").reshape(B, S, H, hd)
    g = proj(xg, "wg")
    w = _decay(xw, p).reshape(B, S, H, hd)
    u = p["u"].reshape(H, hd)

    s0 = (state.wkv if state is not None
          else torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device))
    if S == 1:
        out, new_s = rwkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
        out = out[:, None]
    elif S % 64 == 0 and state is None:
        out, new_s = rwkv6_chunked(r, k, v, w, u)
    else:
        out, new_s = rwkv6_scan(r, k, v, w, u)
        if state is not None:
            # fold in the initial state's contribution (the scan starts from zeros)
            decay_prod = torch.exp(torch.cumsum(_log_w(w), dim=1))
            before = torch.cat([torch.ones_like(decay_prod[:, :1]), decay_prod[:, :-1]], dim=1)
            out = out + torch.einsum("bshk,bhkv->bshv", r.float() * before, s0)
            new_s = new_s + decay_prod[:, -1][..., None] * s0

    out = out.reshape(B, S, D).to(x.dtype)
    out = group_norm_heads(out, p["ln_x"], H)
    out = out * F.silu(g.float()).to(x.dtype)
    out = quant_linear(out, PRM.use_weight(p["wo"], ("heads", "embed"), cd), policy=policy)
    cm_prev = (state.cm_x_prev if state is not None
               else torch.zeros((B, D), dtype=x.dtype, device=x.device))
    return out, RWKVState(new_s, x[:, -1, :], cm_prev)


def rwkv_channel_mix(x: torch.Tensor, p: dict, cfg, policy: QuantPolicy, *,
                     x_prev: torch.Tensor | None = None):
    """RWKV's channel mix (the FFN's place): a squared-ReLU key, a sigmoid
    receptance gate. Returns (out (B, S, D), this call's last input)."""
    B, S, D = x.shape
    xp = x_prev if x_prev is not None else torch.zeros((B, D), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, xp)
    xk = _mix(x, xs, p["mu_ck"], p["mix_lora_a"], p["mix_lora_b_ck"])
    xr = _mix(x, xs, p["mu_cr"], p["mix_lora_a"], p["mix_lora_b_cr"])
    cd = policy.compute_dtype
    kk = quant_linear(xk, PRM.use_weight(p["w_key"], ("embed", "mlp"), cd), policy=policy)
    kk = torch.square(torch.relu(kk.float())).to(x.dtype)
    vv = quant_linear(kk, PRM.use_weight(p["w_value"], ("mlp", "embed"), cd), policy=policy)
    rr = torch.sigmoid(quant_linear(
        xr, PRM.use_weight(p["w_receptance"], ("embed", "heads"), cd), policy=policy).float())
    return rr.to(x.dtype) * vv, x[:, -1, :]
