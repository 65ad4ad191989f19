"""Decoder-only LM: parameter specs, training forward and loss, prefill
and decode.

The PyTorch counterpart of ``repro/models/transformer.py`` for dense
all-attention stacks (smollm-360m). The parameter tree keeps the JAX
package's layout: ``blocks["pos{i}"]`` holds each position-in-period's
parameters stacked over the ``n_groups`` dimension. Where the JAX package
scans over that dimension, the port runs a Python loop and takes group
``g``'s parameters and cache as views (``tree[g]``; in training one
``unbind`` per leaf, whose backward stacks the groups' gradients once).

Serve states are updated in place: ``serve_prefill`` and ``decode_step``
write keys, values and lengths into the cache tensors they are given and
return the same state object.

Training runs with ``remat="none"`` only: ``"block"``/``"full"``
(activation recomputation) raise until they are ported. MoE, SSM, hybrid
and multimodal stacks come with their own slices.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.layer_scale import apply_layer_scale
from repro_torch.core.precision import QuantPolicy
from repro_torch.models import attention as ATT
from repro_torch.models import params as PRM
from repro_torch.models.common import apply_norm, cross_entropy_loss, embed_tokens
from repro_torch.models.mlp import mlp_block
from repro_torch.models.params import ParamSpec


def require_dense(cfg: ModelConfig, what: str = "the port"):
    """Raise for the model families this slice does not serve."""
    if (cfg.family not in ("dense",) or cfg.moe is not None
            or cfg.attn_layer_period or cfg.rwkv is not None
            or cfg.mamba is not None or cfg.encdec is not None
            or cfg.frontend is not None):
        raise NotImplementedError(
            f"{what}: {cfg.name} ({cfg.family}) is not ported yet; this slice "
            "serves dense all-attention decoders (ROADMAP.md Queue 1)")


def period(cfg: ModelConfig) -> int:
    p = 1
    if cfg.attn_layer_period:
        p = math.lcm(p, cfg.attn_layer_period)
    if cfg.moe is not None and cfg.moe.every_n_layers > 1:
        p = math.lcm(p, cfg.moe.every_n_layers)
    assert cfg.n_layers % p == 0, (cfg.n_layers, p)
    return p


def n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // period(cfg)


# ---------------------------------------------------------------------------
# parameter specs (dense stacks)
# ---------------------------------------------------------------------------

def _norm_spec(cfg) -> Dict[str, ParamSpec]:
    d = {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
    return d


def _attn_specs(cfg) -> Dict[str, ParamSpec]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamSpec((D, H * hd), ("embed", "heads"), "fan_in", 1.0),
        "wk": ParamSpec((D, KV * hd), ("embed", "kv_heads"), "fan_in", 1.0),
        "wv": ParamSpec((D, KV * hd), ("embed", "kv_heads"), "fan_in", 1.0),
        "wo": ParamSpec((H * hd, D), ("heads", "embed"), "fan_in", 1.0),
    }


def _mlp_specs(cfg) -> Dict[str, ParamSpec]:
    D, FF = cfg.d_model, cfg.d_ff
    s = {
        "w_up": ParamSpec((D, FF), ("embed", "mlp"), "fan_in", 1.0),
        "w_down": ParamSpec((FF, D), ("mlp", "embed"), "fan_in", 1.0),
    }
    if cfg.act == "swiglu":
        s["w_gate"] = ParamSpec((D, FF), ("embed", "mlp"), "fan_in", 1.0)
    return s


def layer_specs(cfg: ModelConfig, layer_idx: int) -> Dict[str, Any]:
    require_dense(cfg, "layer_specs")
    specs: Dict[str, Any] = {"norm1": _norm_spec(cfg), "norm2": _norm_spec(cfg),
                             "attn": _attn_specs(cfg), "mlp": _mlp_specs(cfg)}
    if cfg.layer_scale_init is not None:
        init = "zeros" if cfg.layer_scale_init == 0.0 else "constant"
        specs["gamma1"] = ParamSpec((cfg.d_model,), ("embed",), init,
                                    cfg.layer_scale_init)
        specs["gamma2"] = ParamSpec((cfg.d_model,), ("embed",), init,
                                    cfg.layer_scale_init)
    return specs


def _stack_specs(specs, n: int):
    return PRM.tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.logical,
                            s.init, s.scale, s.dtype), specs)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    require_dense(cfg, "param_specs")
    P, G = period(cfg), n_groups(cfg)
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           "normal", 0.02),
        "blocks": {f"pos{i}": _stack_specs(layer_specs(cfg, i), G)
                   for i in range(P)},
        "final_norm": _norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                  ("embed", "vocab"), "fan_in", 1.0)
    return specs


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer_apply(x: torch.Tensor, lp: Dict, cfg: ModelConfig,
                 policy: QuantPolicy, parallel: ParallelConfig, *,
                 state: ATT.KVCache, prefill=None, rope_cache=None):
    """One serving layer on its cache ``state`` (updated in place).

    ``prefill=(admit, prompt_lens)``: the attention runs
    ``attention_prefill`` and admitted slots' lengths reset to their prompt
    length; otherwise one decode step. ``rope_cache=(cos, sin)``: RoPE rows
    gathered once per step by the engine."""
    h = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    if prefill is not None:
        admit, prompt_lens = prefill
        a = ATT.attention_prefill(h, state, lp["attn"], cfg, policy,
                                  admit=admit, rope_cache=rope_cache,
                                  impl=parallel.attn_impl)
        state.length.copy_(torch.where(admit, prompt_lens, state.length))
    else:
        a = ATT.attention_decode_step(h, state, lp["attn"], cfg, policy,
                                      rope_cache=rope_cache,
                                      impl=parallel.attn_impl)
    x = x + apply_layer_scale(lp.get("gamma1"), a)
    h2 = apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
    m = mlp_block(h2, lp["mlp"], cfg, policy)
    return x + apply_layer_scale(lp.get("gamma2"), m)


def _train_layer_apply(x: torch.Tensor, lp: Dict, cfg: ModelConfig,
                       policy: QuantPolicy, parallel: ParallelConfig, *,
                       positions: torch.Tensor) -> torch.Tensor:
    """One layer with no cache (the JAX ``_layer_apply`` with state None)."""
    h = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    a = ATT.attention_block(h, lp["attn"], cfg, policy, positions=positions,
                            impl=parallel.attn_impl)
    x = x + apply_layer_scale(lp.get("gamma1"), a)
    h2 = apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
    m = mlp_block(h2, lp["mlp"], cfg, policy)
    return x + apply_layer_scale(lp.get("gamma2"), m)


def require_no_remat(parallel: ParallelConfig):
    if parallel.remat != "none":
        raise NotImplementedError(
            f"remat={parallel.remat!r} is not ported yet: training runs with "
            "remat='none' (activation recomputation is queued, ROADMAP.md "
            "Queue 1); full-width smollm-360m fits the card without it")


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            policy: QuantPolicy, parallel: ParallelConfig):
    """Training forward over the whole sequence: tokens (B, S) ->
    (logits (B, S, V), aux loss, a zero for dense stacks)."""
    require_dense(cfg, "forward")
    require_no_remat(parallel)
    x = embed_input(params, tokens, cfg, policy)
    positions = torch.arange(x.shape[1], device=x.device)
    layers = {key: PRM.tree_map(lambda t: t.unbind(0), blk)
              for key, blk in params["blocks"].items()}
    for g in range(n_groups(cfg)):
        for i in range(period(cfg)):
            lp = PRM.tree_map(lambda views: views[g], layers[f"pos{i}"])
            x = _train_layer_apply(x, lp, cfg, policy, parallel, positions=positions)
    logits = lm_head(params, x, cfg, policy)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            policy: QuantPolicy, parallel: ParallelConfig,
            aux_weight: float = 0.01):
    """(loss, {"ce", "moe_aux"}): mean next-token cross-entropy of
    ``batch["tokens"]`` against ``batch["labels"]``, both (B, S)."""
    logits, aux = forward(params, batch["tokens"], cfg, policy, parallel)
    ce = cross_entropy_loss(logits, batch["labels"], cfg.logit_softcap)
    return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}


def embed_input(params, tokens: torch.Tensor, cfg: ModelConfig,
                policy: QuantPolicy) -> torch.Tensor:
    return embed_tokens(params["embed"], tokens, policy.compute_dtype)


def lm_head(params, x: torch.Tensor, cfg: ModelConfig, policy: QuantPolicy):
    """Final norm, then the (tied or separate) vocabulary projection — a
    plain product, not quantized (the paper quantizes transformer
    linears, not the classifier)."""
    x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    cd = policy.compute_dtype
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].to(cd).t())
    return torch.matmul(x.to(cd), PRM.use_weight(params["head"],
                                                 ("embed", "vocab"), cd))


# ---------------------------------------------------------------------------
# serving (continuous batching: per-slot KV caches)
# ---------------------------------------------------------------------------

def init_serve_state(cfg: ModelConfig, max_batch: int, max_len: int,
                     dtype=torch.bfloat16, device="cuda"):
    """Per-slot KV caches stacked over groups: per position-in-period a
    ``KVCache`` with k/v (G, max_batch, max_len, n_kv_heads, hd) and
    lengths (G, max_batch) int32, all zero (every slot empty)."""
    require_dense(cfg, "init_serve_state")
    P, G = period(cfg), n_groups(cfg)
    shape = (G, max_batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {f"pos{i}": ATT.KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros((G, max_batch), dtype=torch.int32, device=device))
        for i in range(P)}


def _group(tree, g: int):
    """Group ``g``'s slice of a stacked parameter tree or serve state
    (views: writes land in the stacked tensors)."""
    if isinstance(tree, ATT.KVCache):
        return ATT.KVCache(tree.k[g], tree.v[g], tree.length[g])
    return PRM.tree_map(lambda t: t[g], tree)


def _run_layers(params, states, x, cfg, policy, parallel, **kw):
    for g in range(n_groups(cfg)):
        gp = _group(params["blocks"], g)
        for i in range(period(cfg)):
            key = f"pos{i}"
            x = _layer_apply(x, gp[key], cfg, policy, parallel,
                             state=_group(states[key], g), **kw)
    return x


def serve_prefill(params, states, tokens: torch.Tensor,
                  prompt_lens: torch.Tensor, admit: torch.Tensor,
                  cfg: ModelConfig, policy: QuantPolicy,
                  parallel: ParallelConfig, *, last_only: bool = False,
                  rope_cache=None):
    """Seed admitted slots' caches from their padded prompts (in place).

    tokens: (B, S) prompts right-padded to a common S <= max_len;
    prompt_lens: (B,) int32 true lengths; admit: (B,) bool. Returns
    (logits (B, S, V), states) — or (B, 1, V) with ``last_only``, each
    slot's last valid prompt position gathered before the head. Logits at
    pad positions and for non-admitted slots are garbage."""
    require_dense(cfg, "serve_prefill")
    x = embed_input(params, tokens, cfg, policy)
    x = _run_layers(params, states, x, cfg, policy, parallel,
                    prefill=(admit, prompt_lens), rope_cache=rope_cache)
    if last_only:
        rows = torch.arange(x.shape[0], device=x.device)
        x = x[rows, torch.clamp(prompt_lens.long() - 1, min=0)][:, None]
    return lm_head(params, x, cfg, policy), states


def decode_step(params, states, tokens: torch.Tensor, cfg: ModelConfig,
                policy: QuantPolicy, parallel: ParallelConfig, *,
                rope_cache=None):
    """One-token decode for every slot (in place). tokens: (B, 1).
    Returns (logits (B, 1, V), states). ``rope_cache=(cos, sin)``: this
    step's RoPE rows, (B, 1, hd/2)."""
    require_dense(cfg, "decode_step")
    x = embed_input(params, tokens, cfg, policy)
    x = _run_layers(params, states, x, cfg, policy, parallel,
                    rope_cache=rope_cache)
    return lm_head(params, x, cfg, policy), states
