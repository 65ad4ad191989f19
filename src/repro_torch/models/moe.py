"""Token-choice top-k mixture of experts with grouped dispatch.

The PyTorch counterpart of ``repro/models/moe.py``, operation for
operation:

* the router: bf16 (compute-dtype) operands with f32 accumulation, the
  softmax, the top k with ties broken toward the lower expert index (as
  ``jax.lax.top_k``; ``torch.topk`` promises no order among ties, so the
  order comes from a stable sort), the gates renormalised;
* the dispatch: one stable sort of the group's T·k assignments by expert
  (``jnp.argsort`` is stable), a slot per kept assignment, capacity
  ``C = max(4, ceil4(int(Tg·k/E·cf + 0.999)))`` per group; assignments past
  it are dropped (Switch/GShard semantics);
* the experts: ``expert_linear`` on (E, C, d) — SwitchBack per expert (the
  JAX package vmaps its custom VJP over E: a tensor-wise W scale and a
  row-wise x scale per expert), or the plain batched product;
* the combine: each slot's output times its gate in f32, rounded to the
  compute dtype, and a token's ≤ k contributions added in the compute dtype
  in ascending slot order, one rounding per add, the order of XLA's
  scatter-add. On the card a ``scatter_add_``/``index_add_`` in bf16 is an
  atomic add whose order, and so whose bits, are not fixed; here each token
  gathers its slots instead, so a token's output does not depend on what
  rides beside it in its group;
* the auxiliary load-balancing loss ``E · Σ_e density_e · mean_prob_e``, a
  product of two means over the global batch.

Groups. The JAX package uses G = (data shards) groups, each group's tokens
one data shard's, and G = 1 where a group would hold fewer than 2E tokens.
In the port each rank's tokens are its group (one rank: one group). Where
the JAX package would fall back to one global group at a world above 1
(fewer than 2E tokens a rank, or ``moe_grouped=False``), its one sort runs
over every rank's tokens; that is ROADMAP.md Queue 1 #13 and raises here.
Across ranks the aux loss's two means are all-reduced before the product,
so every rank's aux is the global batch's, as JAX's is.
"""
from __future__ import annotations

import torch

from repro_torch.core import switchback as SB
from repro_torch.core.precision import QuantPolicy, variant_for_mode
from repro_torch.core.quantization import div
from repro_torch.distributed import sharding as S
from repro_torch.models import params as PRM
from repro_torch.models.common import activation


def expert_linear(x: torch.Tensor, w: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """Batched expert matmul: x (E, C, din) @ w (E, din, dout).

    The quantized modes run SwitchBack per expert on x in the compute dtype
    (``core/switchback.expert_matmul``; as in the JAX package, with the
    policy's fp8 formats and ``fp8_mixed``'s default tile and ratio); the
    others the plain batched product of x and w in the compute dtype with
    f32 sums, rounded to it (the JAX package's ``dot_general``; under
    ``fp32`` too, as there, whose compute dtype is bf16)."""
    cd = policy.compute_dtype
    if policy.is_quantized:
        return SB.expert_matmul(x.to(cd).contiguous(), w, compute_dtype=cd,
                                variant=variant_for_mode(policy.mode),
                                fp8=SB.FP8Config(policy.fwd_fmt, policy.bwd_fmt))
    return torch.bmm(x.to(cd), w.to(cd))


def stable_top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, in descending
    order, ties toward the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` op for op: exp(x - max) over its sum, a division."""
    e = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def _router_logits(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w_router (d, E) with w in x's dtype and f32 sums -> f32:
    an f32 product of the operands widened (a 16-bit product is exact in
    f32; TF32 is off, ``core/precision.full_precision_products``)."""
    return x.float() @ w_router.to(x.dtype).float()


def _global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over every dim but the last, over the global batch: inside
    a sharded step whose batch is split over more than one rank, the local
    sums all-reduced (the gradient all-reduced back) and divided by the
    global count; else ``torch.mean``."""
    dims = tuple(range(t.dim() - 1))
    ctx = PRM.ShardCtx._current
    if ctx is None or not ctx.batch or ctx.mesh.size(ctx.batch) == 1:
        return torch.mean(t, dim=dims)
    n = ctx.mesh.size(ctx.batch)
    s = S.AllReduceSum.apply(torch.sum(t, dim=dims), ctx.mesh.group(ctx.batch))
    count = 1
    for d in dims:
        count *= t.shape[d]
    return div(s, float(count * n))


def router(x: torch.Tensor, w_router: torch.Tensor, n_experts: int, top_k: int):
    """x: (..., d). Returns (gates (..., k) f32, experts (..., k) int64, aux)."""
    probs = softmax(_router_logits(x, w_router))
    gates, experts = stable_top_k(probs, top_k)
    gates = gates / torch.clamp_min(torch.sum(gates, -1, keepdim=True), 1e-9)
    first = (experts[..., :1] == torch.arange(n_experts, device=x.device)).to(torch.float32)
    density = _global_mean(first)
    density_proxy = _global_mean(probs)
    aux = torch.sum(density * density_proxy) * n_experts
    return gates, experts, aux


def group_dispatch(xg: torch.Tensor, gates: torch.Tensor, experts: torch.Tensor,
                   E: int, C: int):
    """One group's slot assignment. xg: (Tg, d); gates/experts: (Tg, k).
    Returns (x_disp (E, C, d), slot_token (E*C,) int64 with Tg for an empty
    slot, slot_w (E*C,) f32, token_slots (Tg, k) int64: each token's kept
    slots in ascending order, E*C where an assignment was dropped)."""
    Tg, d = xg.shape
    k = experts.shape[-1]
    dev = xg.device
    flat_e = experts.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev), side="left")
    pos_in_e = torch.arange(Tg * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < C
    token_of = sort_idx // k
    # a dropped assignment writes the extra slot E*C, cut off after (the
    # JAX scatter's mode="drop"; no mask is read back to the host)
    target = torch.where(keep, sorted_e * C + pos_in_e, E * C)
    slot_token = torch.full((E * C + 1,), Tg, dtype=torch.int64, device=dev).scatter_(
        0, target, token_of)[:E * C]
    flat_gate = gates.reshape(-1)[sort_idx]
    slot_w = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev).scatter_(
        0, target, torch.where(keep, flat_gate, 0.0))[:E * C]
    x_pad = torch.cat([xg, torch.zeros((1, d), dtype=xg.dtype, device=dev)], dim=0)
    x_disp = x_pad[slot_token].reshape(E, C, d)
    # assignment j of token t sits at target[inverse(sort_idx)[t k + j]]
    addr = torch.empty((Tg * k,), dtype=torch.int64, device=dev).scatter_(0, sort_idx, target)
    token_slots = torch.sort(addr.reshape(Tg, k), dim=-1).values
    return x_disp, slot_token, slot_w, token_slots


def combine(y: torch.Tensor, slot_w: torch.Tensor, token_slots: torch.Tensor,
            cd: torch.dtype) -> torch.Tensor:
    """y (E*C, d) the experts' outputs; each token's output the sum, in
    ``cd``, of its slots' gated outputs in ascending slot order (a dropped
    assignment reads a zero row, which adds nothing)."""
    y_flat = (y.float() * slot_w[:, None]).to(cd)
    y_pad = torch.cat([y_flat, torch.zeros((1, y.shape[1]), dtype=cd, device=y.device)])
    out = torch.zeros((token_slots.shape[0], y.shape[1]), dtype=cd, device=y.device)
    for j in range(token_slots.shape[1]):
        out = out + y_pad[token_slots[:, j]]
    return out


def capacity(Tg: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots an expert a group, the JAX package's arithmetic in Python floats."""
    C = int((Tg * top_k / n_experts) * capacity_factor + 0.999)
    return max(4, -(-C // 4) * 4)


def require_local_groups(T: int, n_experts: int):
    """Raise where the JAX package would sort one global group over every
    rank's tokens: ``moe_grouped=False``, or fewer than 2E tokens a rank,
    at a world above 1 (ROADMAP.md Queue 1 #13)."""
    ctx = PRM.ShardCtx._current
    if ctx is None or not ctx.batch or ctx.mesh.size(ctx.batch) == 1:
        return
    if not ctx.moe_grouped:
        raise NotImplementedError(
            "moe_grouped=False at a world above 1 sorts one global group over every "
            "rank's tokens: ROADMAP.md Queue 1 #13")
    if T < 2 * n_experts:
        raise NotImplementedError(
            f"{T} tokens a rank < 2 x {n_experts} experts: the JAX package falls back to "
            "one global group over every rank's tokens there, ROADMAP.md Queue 1 #13")


def moe_block(x: torch.Tensor, p: dict, cfg, policy: QuantPolicy):
    """x: (B, S, D) -> (out (B, S, D), aux loss, an f32 scalar)."""
    moe = cfg.moe
    B, S_, D = x.shape
    T = B * S_
    E, K = moe.n_experts, moe.top_k
    require_local_groups(T, E)
    C = capacity(T, K, E, moe.capacity_factor)
    cd = policy.compute_dtype
    xg = x.reshape(T, D)
    w_router = PRM.use_weight(p["w_router"], ("embed", None), cd)
    gates, experts, aux = router(xg, w_router, E, K)
    x_disp, _, slot_w, token_slots = group_dispatch(xg, gates, experts, E, C)

    w_up = PRM.use_weight(p["w_up"], ("experts", "embed", "mlp"), cd)
    w_down = PRM.use_weight(p["w_down"], ("experts", "mlp", "embed"), cd)
    h = expert_linear(x_disp, w_up, policy)
    g = (expert_linear(x_disp, PRM.use_weight(p["w_gate"], ("experts", "embed", "mlp"), cd),
                       policy) if "w_gate" in p else None)
    h = activation(h, g, cfg.act)
    y = expert_linear(h, w_down, policy)

    out = combine(y.reshape(E * C, D), slot_w, token_slots, cd)
    return out.to(x.dtype).reshape(B, S_, D), aux.float()
