"""Decoder-only LM: parameter specs, training forward and loss, prefill
and decode.

The PyTorch counterpart of ``repro/models/transformer.py`` for decoder
stacks: all-attention, dense (smollm-360m, minitron-8b) or with
mixture-of-experts MLPs (qwen3-moe-30b-a3b, arctic-480b with its parallel
dense residual MLP; ``models/moe.py``); attention-free RWKV-6 (rwkv6-1.6b,
``models/ssm/rwkv6.py``, its channel mix in place of the MLP); the
Mamba + attention hybrid with MoE every second layer (jamba-v0.1-52b,
``models/ssm/mamba.py``); and the vision-language backbone
(internvl2-76b): a dense decoder whose ``frontend_proj`` projects the stub
frontend's precomputed patch embeddings (``extra_embeds``), which
``embed_input`` puts in front of the text and ``loss_fn`` slices off
before the cross-entropy. Encoder-decoders are ``models/encdec.py``. The
parameter tree keeps the JAX package's layout: ``blocks["pos{i}"]`` holds each position-in-period's
parameters stacked over the ``n_groups`` dimension. Where the JAX package
scans over that dimension, the port runs a Python loop and takes group
``g``'s parameters and cache as views (``tree[g]``; in training one
``unbind`` per leaf, whose backward stacks the groups' gradients once).

Serve states are updated in place: ``serve_prefill``, ``decode_step``,
``paged_prefill`` and ``paged_decode_step`` write keys, values and
lengths into the cache tensors they are given and return the same state
object. ``decode_step`` also takes ``init_decode_state``'s tree, whose
SSM layers hold recurrent states (``MambaState``, ``RWKVState``): the
blocks compute a new state JAX style and the layer copies it into group
g's slice of the stacked state tensors, so those advance in place too.
The continuous-batching engine (``init_serve_state``, the prefills, the
paged functions) serves all-attention stacks only, as the JAX engine does
(``_require_all_attention``, which also refuses a frontend: it is a
training-path feature); SSM and hybrid stacks decode through
``decode_step`` one token at a time, and a frontend stack decodes its text
the same way (``launch/serve.decode_step_fallback``).

Training recomputes activations as the JAX package does: under
``remat="block"`` or ``"full"`` (the same in both packages) each layer
group runs under ``torch.utils.checkpoint`` (non-reentrant), so only the
groups' inputs are kept for the backward (``maybe_remat``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.layer_scale import apply_layer_scale
from repro_torch.core.precision import QuantPolicy, quant_linear
from repro_torch.models import attention as ATT
from repro_torch.models import params as PRM
from repro_torch.models.common import apply_norm, cross_entropy_loss, embed_tokens
from repro_torch.models.mlp import mlp_block
from repro_torch.models.moe import moe_block
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssm.mamba import MambaState, mamba_block
from repro_torch.models.ssm.rwkv6 import RWKVState, rwkv6_block, rwkv_channel_mix


class NoEnginePath(NotImplementedError):
    """A serving entry point's refusal of a model the continuous-batching
    engine does not serve (SSM and hybrid stacks, multimodal frontends,
    enc-dec and CLIP), apart from the port's other refusals: the serve CLI
    falls back to ``decode_step_fallback`` on this one only, which decodes
    a decoder stack one token at a time and exits with the reason for the
    rest, as the JAX CLI does on the JAX engine's refusal."""


def _require_all_attention(cfg: ModelConfig, what: str):
    """The JAX package's guard of its serving engine: all-attention stacks
    without a frontend only (SSM and hybrid stacks, and a frontend stack's
    text, decode through ``decode_step``)."""
    kinds = {cfg.layer_kind(i) for i in range(period(cfg))}
    if kinds != {"attn"}:
        raise NoEnginePath(
            f"{what} supports all-attention stacks only (got layer kinds "
            f"{sorted(kinds)} for {cfg.name}); ssm/hybrid archs decode "
            "through decode_step one token at a time")
    if cfg.frontend is not None:
        raise NoEnginePath(f"{what}: multimodal frontends are a "
                           "training-path feature")


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


def _mlp_specs(cfg, d_ff=None) -> Dict[str, ParamSpec]:
    D, FF = cfg.d_model, d_ff or cfg.d_ff
    s = {
        "w_up": ParamSpec((D, FF), ("embed", "mlp"), "fan_in", 1.0),
        "w_down": ParamSpec((FF, D), ("mlp", "embed"), "fan_in", 1.0),
    }
    if cfg.act == "swiglu":
        s["w_gate"] = ParamSpec((D, FF), ("embed", "mlp"), "fan_in", 1.0)
    return s


def _moe_specs(cfg) -> Dict[str, ParamSpec]:
    D, FF, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    s = {
        "w_router": ParamSpec((D, E), ("embed", None), "fan_in", 1.0),
        "w_up": ParamSpec((E, D, FF), ("experts", "embed", "mlp"), "fan_in", 1.0),
        "w_down": ParamSpec((E, FF, D), ("experts", "mlp", "embed"), "fan_in", 1.0),
    }
    if cfg.act == "swiglu":
        s["w_gate"] = ParamSpec((E, D, FF), ("experts", "embed", "mlp"), "fan_in", 1.0)
    return s


def _mamba_specs(cfg) -> Dict[str, ParamSpec]:
    mc = cfg.mamba
    D = cfg.d_model
    d_in = mc.expand * D
    dt_rank = mc.dt_rank or -(-D // 16)
    N = mc.d_state
    return {
        "w_in": ParamSpec((D, 2 * d_in), ("embed", "mlp"), "fan_in", 1.0),
        "conv_w": ParamSpec((mc.d_conv, d_in), ("conv", "mlp"), "normal", 0.02),
        "conv_b": ParamSpec((d_in,), ("mlp",), "zeros"),
        "w_x_proj": ParamSpec((d_in, dt_rank + 2 * N), ("mlp", None), "fan_in", 1.0),
        "w_dt": ParamSpec((dt_rank, d_in), ("lora", "mlp"), "fan_in", 1.0),
        "dt_bias": ParamSpec((d_in,), ("mlp",), "zeros"),
        "A_log": ParamSpec((d_in, N), ("mlp", "state"), "constant", 0.0),
        "D": ParamSpec((d_in,), ("mlp",), "ones"),
        "w_out": ParamSpec((d_in, D), ("mlp", "embed"), "fan_in", 1.0),
    }


def _rwkv_specs(cfg) -> Dict[str, ParamSpec]:
    rc = cfg.rwkv
    D = cfg.d_model
    lr, dr = rc.mix_lora, rc.decay_lora
    mixes = {}
    for nm in ("r", "k", "v", "w", "g", "ck", "cr"):
        mixes[f"mu_{nm}"] = ParamSpec((D,), ("embed",), "constant", 0.5)
        mixes[f"mix_lora_b_{nm}"] = ParamSpec((lr, D), ("lora", "embed"), "zeros")
    return {
        **mixes,
        "mix_lora_a": ParamSpec((D, lr), ("embed", "lora"), "fan_in", 1.0),
        "w0": ParamSpec((D,), ("embed",), "constant", -6.0),
        "w_lora_a": ParamSpec((D, dr), ("embed", "lora"), "fan_in", 1.0),
        "w_lora_b": ParamSpec((dr, D), ("lora", "embed"), "zeros"),
        "u": ParamSpec((D,), ("embed",), "normal", 0.5),
        "wr": ParamSpec((D, D), ("embed", "heads"), "fan_in", 1.0),
        "wk": ParamSpec((D, D), ("embed", "heads"), "fan_in", 1.0),
        "wv": ParamSpec((D, D), ("embed", "heads"), "fan_in", 1.0),
        "wg": ParamSpec((D, D), ("embed", "heads"), "fan_in", 1.0),
        "wo": ParamSpec((D, D), ("heads", "embed"), "fan_in", 1.0),
        "ln_x": ParamSpec((D,), ("embed",), "ones"),
        # the channel mix
        "w_key": ParamSpec((D, cfg.d_ff), ("embed", "mlp"), "fan_in", 1.0),
        "w_value": ParamSpec((cfg.d_ff, D), ("mlp", "embed"), "fan_in", 1.0),
        "w_receptance": ParamSpec((D, D), ("embed", "heads"), "fan_in", 1.0),
    }


def layer_specs(cfg: ModelConfig, layer_idx: int) -> Dict[str, Any]:
    kind = cfg.layer_kind(layer_idx)
    specs: Dict[str, Any] = {"norm1": _norm_spec(cfg), "norm2": _norm_spec(cfg)}
    if kind == "attn":
        specs["attn"] = _attn_specs(cfg)
    elif kind == "mamba":
        specs["mamba"] = _mamba_specs(cfg)
    else:
        specs["rwkv"] = _rwkv_specs(cfg)
    if kind != "rwkv":   # RWKV's channel-mix leaves live in its rwkv dict
        if cfg.layer_is_moe(layer_idx):
            specs["moe"] = _moe_specs(cfg)
            if cfg.moe.dense_residual:
                specs["dense_mlp"] = _mlp_specs(cfg, cfg.moe.dense_residual_ff)
        else:
            specs["mlp"] = _mlp_specs(cfg)
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
    if cfg.frontend is not None:
        # learned projection from the stub frontend features into d_model
        specs["frontend_proj"] = ParamSpec(
            (cfg.d_model, cfg.d_model), ("embed", "embed"), "fan_in", 1.0)
    return specs


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _ffn(h2: torch.Tensor, lp: Dict, cfg: ModelConfig, policy: QuantPolicy, layer_idx: int):
    """The layer's MLP: (out, aux loss). A mixture-of-experts layer adds its
    dense residual MLP when it has one (arctic); a dense layer's aux is None
    (the JAX package's zero)."""
    if cfg.layer_is_moe(layer_idx):
        m, aux = moe_block(h2, lp["moe"], cfg, policy)
        if cfg.moe.dense_residual:
            m = m + mlp_block(h2, lp["dense_mlp"], cfg, policy)
        return m, aux
    return mlp_block(h2, lp["mlp"], cfg, policy), None


def _write_state(state, new) -> None:
    """Copy a recurrent state's new tensors into ``state``'s (group g's
    views of the stacked decode state)."""
    for dst, src in zip(state, new):
        dst.copy_(src)


def _layer_apply(x: torch.Tensor, lp: Dict, cfg: ModelConfig,
                 policy: QuantPolicy, parallel: ParallelConfig, layer_idx: int, *,
                 state, prefill=None, rope_cache=None, paged=None):
    """One serving layer on its cache ``state`` (updated in place).

    An SSM layer (``MambaState`` or ``RWKVState``) takes one decode step of
    its block and writes the new recurrent state into ``state``; the RWKV
    channel mix's last input becomes its ``cm_x_prev``, as in the JAX
    ``_layer_apply``.

    ``prefill=(admit, prompt_lens)``: the attention runs
    ``attention_prefill`` and admitted slots' lengths reset to their prompt
    length; otherwise one decode step. ``rope_cache=(cos, sin)``: RoPE rows
    gathered once per step by the engine. ``paged=(tables, pref_lens)``
    switches both modes onto the block-pool cache (``state`` is then a
    ``PagedKVCache``): prefill runs the chunked ``attention_paged_prefill``
    (suffix only, the resident prefix read through the table), decode
    appends through the table; ``pref_lens`` is read in prefill only."""
    impl = parallel.attn_impl
    kind = cfg.layer_kind(layer_idx)
    h = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    if kind != "attn":
        x, new, _ = _ssm_layer_apply(x, h, lp, cfg, policy, layer_idx, kind, state)
        _write_state(state, new)
        return x
    if prefill is not None:
        admit, prompt_lens = prefill
        if paged is not None:
            tables, pref_lens = paged
            a = ATT.attention_paged_prefill(h, state, tables, lp["attn"], cfg, policy,
                                            admit=admit, pref_lens=pref_lens,
                                            prompt_lens=prompt_lens,
                                            rope_cache=rope_cache, impl=impl)
        else:
            a = ATT.attention_prefill(h, state, lp["attn"], cfg, policy,
                                      admit=admit, rope_cache=rope_cache, impl=impl)
        state.length.copy_(torch.where(admit, prompt_lens, state.length))
    elif paged is not None:
        a = ATT.attention_paged_decode_step(h, state, paged[0], lp["attn"], cfg,
                                            policy, rope_cache=rope_cache, impl=impl)
    else:
        a = ATT.attention_decode_step(h, state, lp["attn"], cfg, policy,
                                      rope_cache=rope_cache, impl=impl)
    x = x + apply_layer_scale(lp.get("gamma1"), a)
    h2 = apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
    m, _ = _ffn(h2, lp, cfg, policy, layer_idx)
    return x + apply_layer_scale(lp.get("gamma2"), m)


def _ssm_layer_apply(x, h, lp, cfg, policy, layer_idx, kind, state):
    """An SSM layer from its normed input ``h``, from ``state`` (None in
    training): (x, the new recurrent state, aux loss or None)."""
    if kind == "mamba":
        a, new = mamba_block(h, lp["mamba"], cfg, policy, state=state)
    else:
        a, new = rwkv6_block(h, lp["rwkv"], cfg, policy, state=state)
    x = x + apply_layer_scale(lp.get("gamma1"), a)
    h2 = apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
    if kind == "rwkv":
        m, cm_last = rwkv_channel_mix(h2, lp["rwkv"], cfg, policy,
                                      x_prev=state.cm_x_prev if state is not None else None)
        new, aux = new._replace(cm_x_prev=cm_last), None
    else:
        m, aux = _ffn(h2, lp, cfg, policy, layer_idx)
    return x + apply_layer_scale(lp.get("gamma2"), m), new, aux


def _train_layer_apply(x: torch.Tensor, lp: Dict, cfg: ModelConfig,
                       policy: QuantPolicy, parallel: ParallelConfig, layer_idx: int, *,
                       positions: torch.Tensor):
    """One layer with no cache (the JAX ``_layer_apply`` with state None):
    (x, aux loss or None)."""
    kind = cfg.layer_kind(layer_idx)
    h = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    if kind != "attn":
        x, _, aux = _ssm_layer_apply(x, h, lp, cfg, policy, layer_idx, kind, None)
        return x, aux
    a = ATT.attention_block(h, lp["attn"], cfg, policy, positions=positions,
                            impl=parallel.attn_impl)
    x = x + apply_layer_scale(lp.get("gamma1"), a)
    h2 = apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
    m, aux = _ffn(h2, lp, cfg, policy, layer_idx)
    return x + apply_layer_scale(lp.get("gamma2"), m), aux


def maybe_remat(fn, parallel: ParallelConfig):
    """``fn`` as it is under ``remat="none"``; else ``fn`` under
    ``torch.utils.checkpoint`` (non-reentrant, the RNG state preserved):
    its activations are dropped after the forward and recomputed in the
    backward, only its inputs kept. ``"block"`` and ``"full"`` are the same
    in the JAX package too (``jax.checkpoint`` of the unit)."""
    if parallel.remat == "none":
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn, use_reentrant=False)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            policy: QuantPolicy, parallel: ParallelConfig,
            extra_embeds: torch.Tensor | None = None):
    """Training forward over the whole sequence: tokens (B, S) ->
    (logits (B, S, V), aux loss: the MoE layers' sum, in the JAX package's
    order — a group's layers from zero, the groups onto a running zero —
    and a zero for dense stacks). ``extra_embeds`` (B, F, D), a frontend's
    features, make the logits (B, F + S, V) (``embed_input``). The unit of
    recomputation is a layer group, as in the JAX package."""
    x = embed_input(params, tokens, cfg, policy, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    layers = {key: PRM.tree_map(lambda t: t.unbind(0), blk)
              for key, blk in params["blocks"].items()}
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def group_fwd(x, gp):
        aux = zero
        for i in range(period(cfg)):
            x, a = _train_layer_apply(x, gp[f"pos{i}"], cfg, policy, parallel, i,
                                      positions=positions)
            if a is not None:
                aux = aux + a
        return x, aux

    blk = maybe_remat(group_fwd, parallel)
    aux = zero
    for g in range(n_groups(cfg)):
        x, a = blk(x, {key: PRM.tree_map(lambda views: views[g], lv)
                       for key, lv in layers.items()})
        aux = aux + a
    logits = lm_head(params, x, cfg, policy)
    return logits, aux


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            policy: QuantPolicy, parallel: ParallelConfig,
            aux_weight: float = 0.01):
    """(loss, {"ce", "moe_aux"}): mean next-token cross-entropy of
    ``batch["tokens"]`` against ``batch["labels"]``, both (B, S). With
    ``batch["extra_embeds"]`` the frontend's positions, prepended, carry no
    target: the first F of the logits are sliced off."""
    logits, aux = forward(params, batch["tokens"], cfg, policy, parallel,
                          extra_embeds=batch.get("extra_embeds"))
    n_front = logits.shape[1] - batch["labels"].shape[1]
    if n_front:
        logits = logits[:, n_front:]
    ce = cross_entropy_loss(logits, batch["labels"], cfg.logit_softcap)
    return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}


def embed_input(params, tokens: torch.Tensor, cfg: ModelConfig,
                policy: QuantPolicy, extra_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """The tokens' embeddings (B, S, D) in the compute dtype; with
    ``extra_embeds`` (B, F, D) their projection through ``frontend_proj``
    (a ``quant_linear``) in front: (B, F + S, D)."""
    cd = policy.compute_dtype
    x = embed_tokens(params["embed"], tokens, cd)
    if extra_embeds is not None:
        fe = quant_linear(extra_embeds.to(cd),
                          PRM.use_weight(params["frontend_proj"], ("embed", "embed"), cd),
                          policy=policy)
        x = torch.cat([fe, x], dim=1)
    return x


def lm_head(params, x: torch.Tensor, cfg: ModelConfig, policy: QuantPolicy):
    """Final norm, then the (tied or separate) vocabulary projection — a
    plain product, not quantized (the paper quantizes transformer
    linears, not the classifier)."""
    x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    cd = policy.compute_dtype
    if cfg.tie_embeddings:
        # the JAX einsum promotes (f32 activations under fp32 with bf16
        # compute meet the bf16 table in f32)
        dt = torch.promote_types(x.dtype, cd)
        return torch.matmul(x.to(dt), params["embed"].to(cd).to(dt).t())
    return torch.matmul(x.to(cd), PRM.use_weight(params["head"],
                                                 ("embed", "vocab"), cd))


# ---------------------------------------------------------------------------
# serving (continuous batching: per-slot KV caches)
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cuda"):
    """The recurrent state of every position-in-period, stacked over groups,
    all zero, in the JAX package's layout: an attention layer a ``KVCache``
    (k/v (G, batch, max_len, n_kv_heads, hd); lengths (G, batch) int32,
    where the JAX package keeps one length a group: every slot advances
    together, so each row holds that length), a Mamba layer a
    ``MambaState`` (conv window in ``dtype``, h in f32), an RWKV layer an
    ``RWKVState`` (wkv in f32, the shifted inputs in ``dtype``)."""
    device = PRM.resolve_device(device)
    P, G = period(cfg), n_groups(cfg)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    def one(i):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            shape = (G, batch, max_len, cfg.n_kv_heads, cfg.hd)
            return ATT.KVCache(zeros(shape, dtype), zeros(shape, dtype),
                               zeros((G, batch), torch.int32))
        if kind == "mamba":
            d_in = cfg.mamba.expand * cfg.d_model
            return MambaState(zeros((G, batch, cfg.mamba.d_conv - 1, d_in), dtype),
                              zeros((G, batch, d_in, cfg.mamba.d_state), torch.float32))
        hd = cfg.rwkv.head_dim
        return RWKVState(zeros((G, batch, cfg.d_model // hd, hd, hd), torch.float32),
                         zeros((G, batch, cfg.d_model), dtype),
                         zeros((G, batch, cfg.d_model), dtype))

    return {f"pos{i}": one(i) for i in range(P)}


def decode_state_logical_axes(cfg: ModelConfig):
    """Logical axes of ``init_decode_state``'s tree (the JAX package's;
    an attention layer's lengths keep JAX's one axis)."""
    def one(i):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            ax = ("layers", "batch", "cache_seq", "kv_heads", None)
            return ATT.KVCache(ax, ax, ("layers",))
        if kind == "mamba":
            return MambaState(("layers", "batch", None, "mlp"),
                              ("layers", "batch", "mlp", None))
        return RWKVState(("layers", "batch", "heads", None, None),
                         ("layers", "batch", "embed"), ("layers", "batch", "embed"))

    return {f"pos{i}": one(i) for i in range(period(cfg))}


def init_serve_state(cfg: ModelConfig, max_batch: int, max_len: int,
                     dtype=torch.bfloat16, device="cuda"):
    """Per-slot KV caches stacked over groups: per position-in-period a
    ``KVCache`` with k/v (G, max_batch, max_len, n_kv_heads, hd) and
    lengths (G, max_batch) int32, all zero (every slot empty)."""
    _require_all_attention(cfg, "init_serve_state")
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
    if isinstance(tree, (ATT.KVCache, ATT.PagedKVCache, MambaState, RWKVState)):
        return type(tree)(*(t[g] for t in tree))
    return PRM.tree_map(lambda t: t[g], tree)


def _run_layers(params, states, x, cfg, policy, parallel, **kw):
    for g in range(n_groups(cfg)):
        gp = _group(params["blocks"], g)
        for i in range(period(cfg)):
            key = f"pos{i}"
            x = _layer_apply(x, gp[key], cfg, policy, parallel, i,
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
    _require_all_attention(cfg, "serve_prefill")
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
    """One-token decode for every slot (in place). tokens: (B, 1);
    ``states`` from ``init_serve_state`` or, for any stack,
    ``init_decode_state``. Returns (logits (B, 1, V), states): the same
    state object, its caches and recurrent states advanced in place.
    ``rope_cache=(cos, sin)``: this step's RoPE rows, (B, 1, hd/2)."""
    x = embed_input(params, tokens, cfg, policy)
    x = _run_layers(params, states, x, cfg, policy, parallel,
                    rope_cache=rope_cache)
    return lm_head(params, x, cfg, policy), states


def init_paged_serve_state(cfg: ModelConfig, num_blocks: int, block_size: int,
                           max_batch: int, dtype=torch.bfloat16, device="cuda"):
    """Block-pool KV caches stacked over groups: per position-in-period a
    ``PagedKVCache`` with k/v pools (G, num_blocks + 1, block_size,
    n_kv_heads, hd) — the extra block at index ``num_blocks`` is the trash
    block — and per-slot lengths (G, max_batch) int32, all zero. The
    footprint scales with ``num_blocks`` (live tokens), not max_batch ×
    max_len; which slot owns which block is the host-side block table."""
    _require_all_attention(cfg, "init_paged_serve_state")
    P, G = period(cfg), n_groups(cfg)
    shape = (G, num_blocks + 1, block_size, cfg.n_kv_heads, cfg.hd)
    return {f"pos{i}": ATT.PagedKVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros((G, max_batch), dtype=torch.int32, device=device))
        for i in range(P)}


def set_serve_lengths(states, lens: torch.Tensor):
    """Overwrite every group's per-slot lengths with ``lens`` (B,), in
    place. The host scheduler knows how many K/V cells per slot are valid;
    a speculative verify call commits draft K/V optimistically, and a
    partial rejection leaves the lengths over-counting until this re-sync
    (run lazily, before the next plain decode step reads them)."""
    for st in states.values():
        st.length.copy_(lens.to(st.length)[None, :].expand_as(st.length))
    return states


def paged_prefill(params, states, tables: torch.Tensor, tokens: torch.Tensor,
                  pref_lens: torch.Tensor, prompt_lens: torch.Tensor,
                  admit: torch.Tensor, cfg: ModelConfig, policy: QuantPolicy,
                  parallel: ParallelConfig, *, last_only: bool = False,
                  rope_cache=None):
    """Seed admitted slots' block-table caches from their prompt *suffixes*
    (the part the prefix cache or an earlier chunk did not hold), in place.

    tokens: (B, S) suffix tokens right-padded to a common S; pref_lens (B,)
    resident prefix lengths; prompt_lens (B,) prefill targets; admit (B,)
    bool; tables (B, n_blocks_per_slot) int32. Returns (logits, states):
    logits (B, S, V), or (B, 1, V) with ``last_only`` (each slot's last
    valid suffix position, gathered before the head)."""
    _require_all_attention(cfg, "paged_prefill")
    x = embed_input(params, tokens, cfg, policy)
    x = _run_layers(params, states, x, cfg, policy, parallel,
                    prefill=(admit, prompt_lens), rope_cache=rope_cache,
                    paged=(tables, pref_lens))
    if last_only:
        rows = torch.arange(x.shape[0], device=x.device)
        idx = torch.clamp(prompt_lens.long() - pref_lens.long() - 1, 0, x.shape[1] - 1)
        x = x[rows, idx][:, None]
    return lm_head(params, x, cfg, policy), states


def paged_decode_step(params, states, tables: torch.Tensor, tokens: torch.Tensor,
                      cfg: ModelConfig, policy: QuantPolicy,
                      parallel: ParallelConfig, *, rope_cache=None):
    """One-token decode over the block-pool cache (in place). tokens (B, 1);
    tables (B, n_blocks_per_slot) int32. Returns (logits (B, 1, V),
    states); every slot's length advances by one, as in ``decode_step``."""
    _require_all_attention(cfg, "paged_decode_step")
    x = embed_input(params, tokens, cfg, policy)
    x = _run_layers(params, states, x, cfg, policy, parallel,
                    rope_cache=rope_cache, paged=(tables, None))
    return lm_head(params, x, cfg, policy), states
