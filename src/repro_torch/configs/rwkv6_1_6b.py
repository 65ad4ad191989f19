"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.
RWKV-6 "Finch" — data-dependent decay. [arXiv:2404.05892; unverified]

A copy of ``repro/configs/rwkv6_1_6b.py``."""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,              # 2048 / head_dim 64
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    act="gelu",              # unused by rwkv channel-mix (sq-relu inside)
)

REDUCED = ModelConfig(
    name="rwkv6-1.6b-reduced",
    family="ssm",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    rwkv=RWKVConfig(head_dim=32, decay_lora=16, mix_lora=8),
    act="gelu",
)
