"""Encoder-decoder transformer (seamless-m4t-large-v2 backbone).

The PyTorch counterpart of ``repro/models/encdec.py``, in its names. The
audio frontend is a stub: the batch holds precomputed frame embeddings
(B, S_src, d_model) and a learned projection (``frontend_proj``) maps them
into the encoder. Encoder: bidirectional self-attention + MLP. Decoder:
causal self-attention, cross-attention to the encoder output, MLP. Every
linear routes through the precision policy, so SwitchBack applies to the
encoder's, the decoder's and the cross projections.

``frontend_proj`` is handed to ``quant_linear`` as the JAX package hands
it, the f32 master with no cast of its own (``_bare_weight``): the
quantized modes quantize its f32 values and return Ẇ unrounded, the plain
modes multiply in the compute dtype (f32 under ``fp32``). The head is cast
to the compute dtype, as ``jnp.asarray(params["head"], cd)`` casts it.
Both go through ``use_weight``, where a ZeRO-3 step gathers them.

Decoding: ``init_decode_state`` runs the encoder once and keeps a
self-attention KV cache for each decoder layer, stacked over the layers;
``decode_step`` advances it in place and recomputes every layer's cross
K/V from the encoder output at each step, as the JAX package does. The
JAX cache keeps one length a layer ((L,)); the port's per-slot attention
takes (B,) lengths, so its cache holds (L, B), every slot advancing
together. Writes land at ``length % max_len`` (the JAX package's
``dynamic_update_slice`` at ``length``: the same cells while the cache has
room). The serving engine refuses enc-dec stacks, as the JAX engine does.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.layer_scale import apply_layer_scale
from repro_torch.core.precision import QuantPolicy, quant_linear
from repro_torch.models import attention as ATT
from repro_torch.models import params as PRM
from repro_torch.models import transformer as TF
from repro_torch.models.common import apply_norm, cross_entropy_loss, embed_tokens
from repro_torch.models.mlp import mlp_block
from repro_torch.models.params import ParamSpec


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    ec = cfg.encdec
    enc_layer = {"norm1": TF._norm_spec(cfg), "attn": TF._attn_specs(cfg),
                 "norm2": TF._norm_spec(cfg), "mlp": TF._mlp_specs(cfg)}
    dec_layer = {"norm1": TF._norm_spec(cfg), "attn": TF._attn_specs(cfg),
                 "norm_x": TF._norm_spec(cfg), "xattn": TF._attn_specs(cfg),
                 "norm2": TF._norm_spec(cfg), "mlp": TF._mlp_specs(cfg)}
    if cfg.layer_scale_init is not None:
        init = "zeros" if cfg.layer_scale_init == 0.0 else "constant"
        for d in (enc_layer, dec_layer):
            d["gamma1"] = ParamSpec((cfg.d_model,), ("embed",), init, cfg.layer_scale_init)
            d["gamma2"] = ParamSpec((cfg.d_model,), ("embed",), init, cfg.layer_scale_init)
        dec_layer["gamma_x"] = ParamSpec((cfg.d_model,), ("embed",), init,
                                         cfg.layer_scale_init)
    return {
        "frontend_proj": ParamSpec((cfg.d_model, cfg.d_model), ("embed", "mlp"), "fan_in", 1.0),
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), "normal", 0.02),
        "enc_blocks": TF._stack_specs(enc_layer, ec.n_encoder_layers),
        "dec_blocks": TF._stack_specs(dec_layer, cfg.n_layers),
        "enc_norm": TF._norm_spec(cfg),
        "final_norm": TF._norm_spec(cfg),
        "head": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), "fan_in", 1.0),
    }


def _bare_weight(w: torch.Tensor, logical, policy: QuantPolicy) -> torch.Tensor:
    """``w`` as the JAX package's ``quant_linear`` takes an f32 master it
    was handed without a cast: widened to f32 in the quantized modes and
    under ``fp32`` (no rounding), cast to the compute dtype otherwise (so
    Ẇ comes back rounded through it, as ``jax.grad`` rounds it there)."""
    keep = policy.is_quantized or policy.mode == "fp32"
    return PRM.use_weight(w, logical, None if keep else policy.compute_dtype)


def _enc_layer(x, lp, cfg, policy, parallel, positions):
    h = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    a = ATT.attention_block(h, lp["attn"], cfg, policy, positions=positions, causal=False,
                            impl=parallel.attn_impl)
    x = x + apply_layer_scale(lp.get("gamma1"), a)
    h = apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
    m = mlp_block(h, lp["mlp"], cfg, policy)
    return x + apply_layer_scale(lp.get("gamma2"), m)


def _dec_layer(x, lp, enc_out, cfg, policy, parallel, positions, self_cache=None):
    """One decoder layer: causal self-attention (training) or one decode
    step on ``self_cache`` (advanced in place), then cross-attention to
    ``enc_out``, then the MLP."""
    h = apply_norm(x, lp["norm1"], cfg.norm, cfg.norm_eps)
    if self_cache is None:
        a = ATT.attention_block(h, lp["attn"], cfg, policy, positions=positions, causal=True,
                                impl=parallel.attn_impl)
    else:
        a = ATT.attention_decode_step(h, self_cache, lp["attn"], cfg, policy,
                                      impl=parallel.attn_impl)
    x = x + apply_layer_scale(lp.get("gamma1"), a)
    h = apply_norm(x, lp["norm_x"], cfg.norm, cfg.norm_eps)
    enc_kv = ATT.encode_cross_kv(enc_out, lp["xattn"], cfg, policy)
    c = ATT.cross_attention(h, enc_kv, lp["xattn"], cfg, policy, impl=parallel.attn_impl)
    x = x + apply_layer_scale(lp.get("gamma_x"), c)
    h = apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
    m = mlp_block(h, lp["mlp"], cfg, policy)
    return x + apply_layer_scale(lp.get("gamma2"), m)


def _layers(blocks, n: int):
    """Layer i's parameters of a stacked block tree, for i < n (views; in
    training one ``unbind`` a leaf, as ``transformer.forward`` takes them)."""
    views = PRM.tree_map(lambda t: t.unbind(0), blocks)
    return [PRM.tree_map(lambda v: v[i], views) for i in range(n)]


def _logits(params, x: torch.Tensor, cfg: ModelConfig, policy: QuantPolicy) -> torch.Tensor:
    """Final norm, then the head cast to the compute dtype (a plain
    product; the JAX einsum promotes an f32 ``x`` under ``fp32``)."""
    x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    w = PRM.use_weight(params["head"], ("embed", "vocab"), policy.compute_dtype)
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def encode(params, frames: torch.Tensor, cfg: ModelConfig, policy: QuantPolicy,
           parallel: ParallelConfig) -> torch.Tensor:
    """frames: (B, S_src, d_model) stub features -> the encoder output."""
    x = quant_linear(frames.to(policy.compute_dtype),
                     _bare_weight(params["frontend_proj"], ("embed", "mlp"), policy),
                     policy=policy)
    positions = torch.arange(x.shape[1], device=x.device)
    blk = TF.maybe_remat(functools.partial(_enc_layer, cfg=cfg, policy=policy,
                                           parallel=parallel, positions=positions), parallel)
    for lp in _layers(params["enc_blocks"], cfg.encdec.n_encoder_layers):
        x = blk(x, lp)
    return apply_norm(x, params["enc_norm"], cfg.norm, cfg.norm_eps)


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            policy: QuantPolicy, parallel: ParallelConfig) -> torch.Tensor:
    """Training forward: encode ``batch["frames"]``, decode the target
    ``batch["tokens"]`` (B, S). Returns the logits (B, S, V). The unit of
    recomputation is a layer, as in the JAX package."""
    enc_out = encode(params, batch["frames"], cfg, policy, parallel)
    x = embed_tokens(params["embed"], batch["tokens"], policy.compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    blk = TF.maybe_remat(functools.partial(_dec_layer, cfg=cfg, policy=policy,
                                           parallel=parallel, positions=positions), parallel)
    for lp in _layers(params["dec_blocks"], cfg.n_layers):
        x = blk(x, lp, enc_out)
    return _logits(params, x, cfg, policy)


def loss_fn(params, batch, cfg, policy, parallel):
    """(loss, {"ce"}): mean cross-entropy of the decoder's logits against
    ``batch["labels"]``."""
    logits = forward(params, batch, cfg, policy, parallel)
    ce = cross_entropy_loss(logits, batch["labels"], cfg.logit_softcap)
    return ce, {"ce": ce}


class EncDecDecodeState(NamedTuple):
    self_caches: Any          # KVCache stacked over decoder layers: k/v (L, B, S, KV, hd), (L, B)
    enc_out: torch.Tensor     # (B, S_src, D) encoder output (fixed)


def init_decode_state(params, frames: torch.Tensor, cfg: ModelConfig, policy: QuantPolicy,
                      parallel: ParallelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16) -> EncDecDecodeState:
    """Encode ``frames`` once; empty self-attention caches of ``max_len``
    cells for every decoder layer, on the frames' device."""
    enc_out = encode(params, frames, cfg, policy, parallel)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dev = frames.device
    caches = ATT.KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                         torch.zeros(shape, dtype=dtype, device=dev),
                         torch.zeros((cfg.n_layers, batch), dtype=torch.int32, device=dev))
    return EncDecDecodeState(caches, enc_out)


def decode_step(params, state: EncDecDecodeState, tokens: torch.Tensor, cfg: ModelConfig,
                policy: QuantPolicy, parallel: ParallelConfig):
    """One decoder token for every row (in place): tokens (B, 1) ->
    (logits (B, 1, V), the same state, its caches advanced)."""
    x = embed_tokens(params["embed"], tokens, policy.compute_dtype)
    caches = state.self_caches
    for i in range(cfg.n_layers):
        lp = PRM.tree_map(lambda t: t[i], params["dec_blocks"])
        x = _dec_layer(x, lp, state.enc_out, cfg, policy, parallel, None,
                       self_cache=ATT.KVCache(*(t[i] for t in caches)))
    return _logits(params, x, cfg, policy), state
