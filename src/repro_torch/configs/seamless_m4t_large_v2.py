"""seamless-m4t-large-v2 [audio]: enc-dec, 24L d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206 — multimodal; audio frontend STUB provides
precomputed frame embeddings. [arXiv:2308.11596; hf]

A copy of ``repro/configs/seamless_m4t_large_v2.py``."""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,             # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    encdec=EncDecConfig(n_encoder_layers=24),
    frontend="audio_stub",
    frontend_tokens=4096,    # audio frames per utterance (train shape)
    rope_theta=1e4,
    act="gelu",
    norm="layernorm",
)

REDUCED = ModelConfig(
    name="seamless-m4t-large-v2-reduced",
    family="encdec",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    encdec=EncDecConfig(n_encoder_layers=2),
    frontend="audio_stub",
    frontend_tokens=32,
    rope_theta=1e4,
    act="gelu",
    norm="layernorm",
)
