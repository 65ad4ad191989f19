"""Config dataclasses for the train and serve paths.

Copies of the JAX package's ``repro/configs/base.py`` (the port imports
nothing of ``repro``), cut to what the port reads:

* ``ModelConfig`` — the whole dataclass, so the configs read the same;
  the mixture-of-experts, SSM, enc-dec and frontend fields are carried but
  their model families are not ported yet (``models.model_zoo`` raises).
* ``CLIPConfig`` — the whole dataclass (the paper's own two-tower model).
* ``ParallelConfig`` — only the fields the train and serve paths read.
  Sharding, meshes and scan-over-layers do not exist in the port: layers
  run as a Python loop over the stacked group dimension on one card.
* ``TrainConfig`` — the JAX fields and defaults, minus ``kernel_backend``
  (the port dispatches on the device of its tensors).
* ``ServeConfig`` — the engine knobs, minus the JAX ``kernel_backend``:
  the port dispatches on the device of its tensors instead.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    every_n_layers: int = 1
    dense_residual: bool = False
    dense_residual_ff: int = 0
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|encdec|vlm|audio|clip
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // n_heads
    moe: Optional[MoEConfig] = None
    mamba: Optional[object] = None
    rwkv: Optional[object] = None
    encdec: Optional[object] = None
    attn_layer_period: int = 0       # jamba: 1 attn layer per this many
    attn_layer_offset: int = 4
    frontend: Optional[str] = None   # "vision_stub" | "audio_stub"
    frontend_tokens: int = 256
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    act: str = "swiglu"              # "swiglu" | "gelu"
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    tie_embeddings: bool = False
    layer_scale_init: Optional[float] = None   # None = off; 0.0 = paper's zero-init
    logit_softcap: float = 0.0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Two-tower CLIP (the paper's own model)."""
    name: str
    image_size: int = 224
    patch_size: int = 14
    vision_layers: int = 32
    vision_width: int = 1280
    vision_heads: int = 16
    vision_ff: int = 5120
    text_layers: int = 24
    text_width: int = 1024
    text_heads: int = 16
    text_ff: int = 4096
    text_vocab: int = 49408
    text_ctx: int = 77
    embed_dim: int = 1024
    patch_dropout: float = 0.5       # paper §2.2.2
    layer_scale_init: Optional[float] = None
    post_embed_norm: bool = True     # paper §3.2: LN after patch embedding
    logit_scale_init: float = 2.659  # ln(1/0.07)
    logit_scale_max: float = 4.6052  # ln(100), clipped per §3.2
    family: str = "clip"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


ATTN_IMPLS = ("flash_scan", "dense")


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The train and serve paths' fields of the JAX ``ParallelConfig``,
    with its defaults. ``attn_impl="flash_scan"`` (the default here and in
    the JAX package) runs the flash-attention kernels, as the JAX package
    does on its Pallas backends; ``"dense"`` runs the materialised oracle.

    ``scan_layers`` only sets how XLA compiles the layer stack (the port
    always runs a Python loop) and takes any value. ``remat`` acts only
    under a gradient: serving takes any value, training only ``"none"``
    (``"block"``/``"full"`` raise until activation recomputation is
    ported). ``attn_block_q``/``attn_block_k`` are the TPU kernels' tile
    sizes; the card's kernels choose their own tiles, so the engine and
    the trainer reject any value but 0.
    """
    scan_layers: bool = True
    remat: str = "block"             # none|block|full
    attn_impl: str = "flash_scan"    # flash_scan | dense
    attn_block_q: int = 0            # flash-attention tile sizes; 0 = auto
    attn_block_k: int = 0

    def __post_init__(self):
        if self.remat not in ("none", "block", "full"):
            raise ValueError(f"remat {self.remat!r} not in ('none', 'block', 'full')")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX ``TrainConfig`` that the port reads, with the
    same defaults. ``optimizer``: stable_adamw | adamw (adafactor raises
    until it is ported); ``loss_scaler``: none | fixed_tensor | dynamic;
    ``quant_mode``: a ``core.precision`` mode (the unported ones raise when
    the policy is built); the ``fp8_*`` fields are ``fp8_mixed``'s tile
    and fallback ratio (``QuantPolicy.from_train_config``, and the
    fallback gauge of ``telemetry/health.py``). Left out until something
    reads them: ``checkpoint_every`` /
    ``keep_checkpoints`` (with ``checkpoint/manager.py``), and ``seed``,
    ``global_batch`` and ``seq_len``, which the JAX package does not read
    either (the caller seeds the parameters; the batch sets its shape)."""
    optimizer: str = "stable_adamw"
    learning_rate: float = 2e-3
    warmup_steps: int = 5000
    total_steps: int = 20000
    weight_decay: float = 0.2
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip_norm: float = 0.0      # 0 = off (paper default: no grad clip)
    loss_scaler: str = "none"        # none|fixed_tensor|dynamic
    quant_mode: str = "bf16"         # precision policy for all linears
    fp8_block_rows: int = 128        # fp8_mixed: blockwise-quantization tile
    fp8_block_cols: int = 128        # over X / Ẏ (one scale + fallback bit each)
    fp8_fallback_ratio: float = 8.0  # tile absmax > ratio x median -> bf16
    microbatch_steps: int = 1        # gradient accumulation
    quant_health_metrics: bool = True  # quantized modes: per-group device
    # health scalars (telemetry/health.py) ride the metrics dict


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs for the continuously-batched inference engine.

    ``max_batch`` × ``max_len`` fixes the preallocated ring KV cache; the
    scheduler admits queued requests into free slots and evicts finished
    ones. The flash-tile, paged-cache, chunked-prefill, preemption and
    speculative fields exist so a config reads the same as in the JAX
    package; the port serves the ring cache, its flash kernels choose
    their own tiles, and ``make_serve_engine`` raises on any of these
    fields set to other than its default.
    """
    max_batch: int = 8               # decode-batch slots (ring cache rows)
    max_len: int = 256               # cache cells per slot (ring capacity)
    prefill_bucket: int = 8          # prompts pad to pow2 buckets >= this
    temperature: float = 0.0         # 0 = greedy argmax
    cache_dtype: str = "bfloat16"    # KV cache storage dtype
    rollover: bool = False           # keep decoding past max_len (sliding
    # window via the ring cache) instead of evicting at the cache edge
    quant_mode: str = "bf16"         # precision policy for all linears
    attn_block_q: int = 0
    attn_block_k: int = 0
    cache_mode: str = "ring"         # ring|paged (paged: a later slice)
    block_size: int = 16
    num_blocks: int = 0
    prefix_cache: bool = True
    prefill_chunk_tokens: int = 0
    preemption: str = "off"
    spec_mode: str = "off"           # off|ngram (ngram: a later slice)
    spec_k: int = 4
    spec_ngram: int = 3
    spec_min_ngram: int = 2
    seed: int = 0                    # temperature>0 sampling seed
