"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT frontend (STUB: precomputed patch embeddings) +
LLaMA-arch backbone. [arXiv:2404.16821; unverified]

A copy of ``repro/configs/internvl2_76b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision_stub",
    frontend_tokens=256,     # ViT patch embeddings prepended per image
    rope_theta=1e6,
    act="swiglu",
)

REDUCED = ModelConfig(
    name="internvl2-76b-reduced",
    family="vlm",
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    frontend="vision_stub",
    frontend_tokens=16,
    rope_theta=1e4,
    act="swiglu",
)
