"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
— llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]

A copy of ``repro/configs/smollm_360m.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=1e4,
    act="swiglu",
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="smollm-360m-reduced",
    family="dense",
    n_layers=4,
    d_model=120,
    n_heads=3,
    n_kv_heads=1,
    d_ff=320,
    vocab_size=512,
    rope_theta=1e4,
    act="swiglu",
    tie_embeddings=True,
)
