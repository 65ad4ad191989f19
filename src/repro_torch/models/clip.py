"""Two-tower CLIP (the paper's own model) with its contrastive loss.

The PyTorch counterpart of ``repro/models/clip.py``. Image tower: the ViT
of ``vit.py``; text tower: the same pre-norm blocks, causal, pooled at the
final position ``x[:, -1]`` (as the JAX package pools, not OpenCLIP's
argmax over the EOT token). Symmetric InfoNCE in f32 with the learned
``logit_scale`` clipped at ±ln(100) (paper §3.2). The loss is over the
global batch: in a sharded step the embeddings are gathered from every
rank first (``models.params.gather_rows``), as GSPMD gathers them for the
B x B logits of the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import CLIPConfig, ParallelConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.models.common import embed_tokens, layer_norm
from repro_torch.models import params as PRM
from repro_torch.models.params import ParamSpec
from repro_torch.models.transformer import _stack_specs
from repro_torch.models.vit import _block_specs, _ln_spec, run_blocks, vision_forward, \
    vision_param_specs


def param_specs(cfg: CLIPConfig) -> Dict[str, Any]:
    W = cfg.text_width
    return {
        "visual": vision_param_specs(cfg),
        "text": {
            "embed": ParamSpec((cfg.text_vocab, W), ("vocab", "embed"), "normal", 0.02),
            "pos_embed": ParamSpec((1, cfg.text_ctx, W), (None, "seq", "embed"), "normal", 0.01),
            "blocks": _stack_specs(_block_specs(W, cfg.text_ff, cfg.layer_scale_init),
                                   cfg.text_layers),
            "final_norm": _ln_spec(W),
            "proj": ParamSpec((W, cfg.embed_dim), ("embed", "heads"), "fan_in", 1.0),
        },
        "logit_scale": ParamSpec((), (), "constant", cfg.logit_scale_init),
    }


def n_kept_patches(cfg: CLIPConfig) -> int:
    """Patches kept by patch dropout at train time (the JAX package's
    ``max(1, int(N * (1 - p)))``)."""
    return max(1, int(cfg.n_patches * (1 - cfg.patch_dropout)))


def patch_keep_sampler(cfg: CLIPConfig):
    """``draw(generator) -> kept patch indices`` for one loss call, a random
    permutation of the N patches cut to ``n_kept_patches`` (unsorted, the
    order the JAX package keeps them in); None without patch dropout. The
    numbers differ from JAX's threefry draw; the parity tests feed JAX's
    indices in."""
    if cfg.patch_dropout <= 0:
        return None
    n, keep = cfg.n_patches, n_kept_patches(cfg)
    return lambda gen: torch.randperm(n, generator=gen, device=gen.device)[:keep]


def text_forward(params, tokens: torch.Tensor, cfg: CLIPConfig,
                 policy: QuantPolicy, parallel: ParallelConfig) -> torch.Tensor:
    tp = params["text"]
    x = embed_tokens(tp["embed"], tokens, policy.compute_dtype)
    x = x + tp["pos_embed"][:, :x.shape[1]].to(x.dtype)
    x, _ = run_blocks(x, tp["blocks"], cfg.text_layers, cfg.text_heads, policy, parallel,
                      causal=True)
    x = layer_norm(x, tp["final_norm"]["scale"], tp["final_norm"]["bias"])
    pooled = x[:, -1]   # last token (EOT)
    return pooled @ tp["proj"].to(pooled.dtype)


def clip_forward(params, batch: Dict[str, torch.Tensor], cfg: CLIPConfig,
                 policy: QuantPolicy, parallel: ParallelConfig, *,
                 patch_keep: Optional[torch.Tensor] = None,
                 collect_stats: bool = False):
    """(image features (B, E) f32, text features (B, E) f32, both L2
    normalised, per-block vision stats)."""
    img, stats = vision_forward(params["visual"], batch["images"], cfg, policy, parallel,
                                patch_keep=patch_keep, collect_stats=collect_stats)
    txt = text_forward(params, batch["texts"], cfg, policy, parallel)
    img = img.float() / torch.linalg.norm(img.float(), dim=-1, keepdim=True)
    txt = txt.float() / torch.linalg.norm(txt.float(), dim=-1, keepdim=True)
    return img, txt, stats


def clip_loss(params, batch, cfg: CLIPConfig, policy: QuantPolicy,
              parallel: ParallelConfig, *, patch_keep: Optional[torch.Tensor] = None,
              collect_stats: bool = False):
    """Symmetric InfoNCE. Returns (loss, {contrastive_acc, logit_scale,
    feature_stats})."""
    img, txt, stats = clip_forward(params, batch, cfg, policy, parallel,
                                   patch_keep=patch_keep, collect_stats=collect_stats)
    img, txt = PRM.gather_rows(img), PRM.gather_rows(txt)   # the global batch
    # paper §3.2: clip the logit_scale parameter (ln 100 cap)
    scale = torch.exp(torch.clamp(params["logit_scale"].float(),
                                  -cfg.logit_scale_max, cfg.logit_scale_max))
    logits = scale * (img @ txt.t())
    labels = torch.arange(logits.shape[0], device=logits.device)
    l_i = -torch.mean(torch.log_softmax(logits, dim=-1)[labels, labels])
    l_t = -torch.mean(torch.log_softmax(logits.t(), dim=-1)[labels, labels])
    loss = 0.5 * (l_i + l_t)
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).float())
    return loss, {"contrastive_acc": acc, "logit_scale": scale, "feature_stats": stats}


def zero_shot_accuracy(img_embs: torch.Tensor, class_embs: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Zero-shot classification: cosine similarity against class prototype
    embeddings (the 80-prompt-template average in the paper's eval)."""
    sims = img_embs @ class_embs.t()
    return torch.mean((torch.argmax(sims, dim=-1) == labels).float())
