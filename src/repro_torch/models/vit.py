"""Vision Transformer tower (the paper's experimental substrate).

The PyTorch counterpart of ``repro/models/vit.py``: the OpenCLIP ViT the
paper trains. Conv patch embedding expressed as a linear over flattened
patches (identical math; the layer whose out-of-date second moment causes
the loss spikes, §3.4), class token, learned positional embedding, a
LayerNorm after the patch embedding (§3.2), pre-norm blocks with biased
linears and optional zero-init layer-scale (§2.3), and patch dropout
(§2.2.2).

Every linear goes through ``quant_linear`` with the weight cast to the
compute dtype by ``use_weight``, as the JAX layers do. The stacked block
parameters run as a Python loop over one ``unbind`` per leaf (the JAX
package scans over the stack); under ``remat`` other than ``"none"`` each
block is the unit of recomputation, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import CLIPConfig, ParallelConfig
from repro_torch.core.layer_scale import apply_layer_scale
from repro_torch.core.precision import QuantPolicy, quant_linear
from repro_torch.models import params as PRM
from repro_torch.models.attention import _core_attention
from repro_torch.models.common import layer_norm
from repro_torch.models.params import ParamSpec
from repro_torch.models.transformer import _stack_specs, maybe_remat
from repro_torch.stability.feature_stats import block_feature_magnitude


def _ln_spec(width):
    return {"scale": ParamSpec((width,), ("embed",), "ones"),
            "bias": ParamSpec((width,), ("embed",), "zeros")}


def _block_specs(width, ff, layer_scale_init):
    s = {
        "norm1": _ln_spec(width),
        "attn": {
            "wq": ParamSpec((width, width), ("embed", "heads"), "fan_in", 1.0),
            "wk": ParamSpec((width, width), ("embed", "heads"), "fan_in", 1.0),
            "wv": ParamSpec((width, width), ("embed", "heads"), "fan_in", 1.0),
            "wo": ParamSpec((width, width), ("heads", "embed"), "fan_in", 1.0),
            "bq": ParamSpec((width,), ("heads",), "zeros"),
            "bk": ParamSpec((width,), ("heads",), "zeros"),
            "bv": ParamSpec((width,), ("heads",), "zeros"),
            "bo": ParamSpec((width,), ("embed",), "zeros"),
        },
        "norm2": _ln_spec(width),
        "mlp": {
            "w_up": ParamSpec((width, ff), ("embed", "mlp"), "fan_in", 1.0),
            "b_up": ParamSpec((ff,), ("mlp",), "zeros"),
            "w_down": ParamSpec((ff, width), ("mlp", "embed"), "fan_in", 1.0),
            "b_down": ParamSpec((width,), ("embed",), "zeros"),
        },
    }
    if layer_scale_init is not None:
        init = "zeros" if layer_scale_init == 0.0 else "constant"
        s["gamma1"] = ParamSpec((width,), ("embed",), init, layer_scale_init)
        s["gamma2"] = ParamSpec((width,), ("embed",), init, layer_scale_init)
    return s


def vision_param_specs(cfg: CLIPConfig) -> Dict[str, Any]:
    W = cfg.vision_width
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    return {
        # conv1 as a linear over flattened patches: `visual.conv1.weight`,
        # the paper's loss-spike layer
        "patch_embed": ParamSpec((patch_dim, W), ("embed", "heads"), "fan_in", 1.0),
        "cls_token": ParamSpec((1, 1, W), (None, None, "embed"), "normal", 0.02),
        "pos_embed": ParamSpec((1, cfg.n_patches + 1, W), (None, "seq", "embed"),
                               "normal", 0.02),
        "post_embed_norm": _ln_spec(W),
        "blocks": _stack_specs(_block_specs(W, cfg.vision_ff, cfg.layer_scale_init),
                               cfg.vision_layers),
        "final_norm": _ln_spec(W),
        "proj": ParamSpec((W, cfg.embed_dim), ("embed", "heads"), "fan_in", 1.0),
    }


def _attn(x, p, heads, policy, causal, impl="flash_scan"):
    """Multi-head self-attention with biased Q/K/V/out projections and no
    RoPE (learned positions are added at the embedding); KV heads = heads."""
    B, S, W = x.shape
    hd = W // heads
    cd = policy.compute_dtype
    uw = lambda nm, lg: PRM.use_weight(p[nm], lg, cd)
    q = quant_linear(x, uw("wq", ("embed", "heads")), p["bq"], policy=policy).reshape(B, S, heads, hd)
    k = quant_linear(x, uw("wk", ("embed", "heads")), p["bk"], policy=policy).reshape(B, S, heads, hd)
    v = quant_linear(x, uw("wv", ("embed", "heads")), p["bv"], policy=policy).reshape(B, S, heads, hd)
    o = _core_attention(q, k, v, causal=causal, impl=impl).reshape(B, S, W)
    return quant_linear(o, uw("wo", ("heads", "embed")), p["bo"], policy=policy)


def _mlp(x, p, policy):
    cd = policy.compute_dtype
    h = quant_linear(x, PRM.use_weight(p["w_up"], ("embed", "mlp"), cd), p["b_up"],
                     policy=policy)
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return quant_linear(h, PRM.use_weight(p["w_down"], ("mlp", "embed"), cd), p["b_down"],
                        policy=policy)


def vit_block(x, lp, heads: int, policy: QuantPolicy, causal: bool = False,
              collect_stats: bool = False, impl: str = "flash_scan"):
    """Pre-norm block (paper Eqs. 5-6): returns (x, mean |x| after the block
    when ``collect_stats``, else a 0)."""
    h = layer_norm(x, lp["norm1"]["scale"], lp["norm1"]["bias"])
    a = _attn(h, lp["attn"], heads, policy, causal, impl)
    x = x + apply_layer_scale(lp.get("gamma1"), a)
    h = layer_norm(x, lp["norm2"]["scale"], lp["norm2"]["bias"])
    m = _mlp(h, lp["mlp"], policy)
    x = x + apply_layer_scale(lp.get("gamma2"), m)
    stat = (block_feature_magnitude(x) if collect_stats
            else torch.zeros((), dtype=torch.float32, device=x.device))
    return x, stat


def run_blocks(x, blocks, n_layers: int, heads: int, policy: QuantPolicy,
               parallel: ParallelConfig, *, causal: bool = False,
               collect_stats: bool = False):
    """The stacked blocks in order (one ``unbind`` per leaf, whose backward
    stacks the layers' gradients once), each block recomputed in the
    backward unless ``parallel.remat`` is ``"none"`` (its stat comes out of
    the recomputed body). Returns (x, per-layer stats (L,))."""
    layers = PRM.tree_map(lambda t: t.unbind(0), blocks)

    def body(x, lp):
        return vit_block(x, lp, heads, policy, causal=causal, collect_stats=collect_stats,
                         impl=parallel.attn_impl)

    blk = maybe_remat(body, parallel)
    stats = []
    for i in range(n_layers):
        x, s = blk(x, PRM.tree_map(lambda views: views[i], layers))
        stats.append(s)
    return x, torch.stack(stats)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, 3·p·p), patches in row-major order, each
    flattened (p, p, C) as in the JAX package."""
    B, H, W, C = images.shape
    x = images.reshape(B, H // patch, patch, W // patch, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // patch) * (W // patch), patch * patch * C)


def vision_forward(params, images_or_patches: torch.Tensor, cfg: CLIPConfig,
                   policy: QuantPolicy, parallel: ParallelConfig, *,
                   patch_keep: Optional[torch.Tensor] = None,
                   collect_stats: bool = False):
    """Returns (pooled embedding (B, embed_dim), per-block |x| stats).

    ``images_or_patches``: (B, H, W, 3) images or (B, N, 3p²) patches.
    ``patch_keep``: the kept patches' indices for patch dropout, in the
    order they are kept (the JAX package draws
    ``permutation(key, N)[:n_keep]``, unsorted); None or a config without
    patch dropout keeps every patch.
    """
    patches = (patchify(images_or_patches, cfg.patch_size)
               if images_or_patches.dim() == 4 else images_or_patches)
    B, N, _ = patches.shape
    cd = policy.compute_dtype
    x = quant_linear(patches.to(cd),
                     PRM.use_weight(params["patch_embed"], ("embed", "heads"), cd),
                     policy=policy)
    x = x + params["pos_embed"][:, 1:N + 1].to(x.dtype)
    if patch_keep is not None and cfg.patch_dropout > 0:
        x = x[:, patch_keep]
    cls = params["cls_token"].to(x.dtype) + params["pos_embed"][:, :1].to(x.dtype)
    x = torch.cat([cls.expand(B, 1, x.shape[-1]), x], dim=1)
    if cfg.post_embed_norm:   # paper §3.2: LN after patch embed
        x = layer_norm(x, params["post_embed_norm"]["scale"], params["post_embed_norm"]["bias"])
    x, stats = run_blocks(x, params["blocks"], cfg.vision_layers, cfg.vision_heads, policy,
                          parallel, collect_stats=collect_stats)
    x = layer_norm(x, params["final_norm"]["scale"], params["final_norm"]["bias"])
    pooled = x[:, 0]    # CLS
    return pooled @ params["proj"].to(pooled.dtype), stats
