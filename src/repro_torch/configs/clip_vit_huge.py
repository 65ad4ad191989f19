"""clip-vit-huge — the paper's own model (OpenCLIP ViT-H/14, ~1B params):
vision 32L width 1280, text 24L width 1024, patch 14, 224px, patch-dropout
0.5, LN after patch embed, logit_scale clipped at ln(100).

A copy of ``repro/configs/clip_vit_huge.py``."""
from repro_torch.configs.base import CLIPConfig

CONFIG = CLIPConfig(
    name="clip-vit-huge",
    image_size=224,
    patch_size=14,
    vision_layers=32,
    vision_width=1280,
    vision_heads=16,
    vision_ff=5120,
    text_layers=24,
    text_width=1024,
    text_heads=16,
    text_ff=4096,
    text_vocab=49408,
    text_ctx=77,
    embed_dim=1024,
    patch_dropout=0.5,
)

REDUCED = CLIPConfig(
    name="clip-vit-huge-reduced",
    image_size=32,
    patch_size=8,
    vision_layers=3,
    vision_width=96,
    vision_heads=3,
    vision_ff=192,
    text_layers=2,
    text_width=64,
    text_heads=2,
    text_ff=128,
    text_vocab=256,
    text_ctx=16,
    embed_dim=64,
    patch_dropout=0.5,
)
