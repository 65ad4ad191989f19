"""Config dataclasses for the serving path.

Copies of the JAX package's ``repro/configs/base.py`` (the port imports
nothing of ``repro``), cut to what this slice reads:

* ``ModelConfig`` — the whole dataclass, so the configs read the same;
  the mixture-of-experts, SSM, enc-dec and frontend fields are carried but
  their model families are not ported yet (``models.model_zoo`` raises).
* ``ParallelConfig`` — only the fields the serve path reads. Sharding,
  meshes and scan-over-layers do not exist in the port: layers run as a
  Python loop over the stacked group dimension on one card.
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


ATTN_IMPLS = ("flash_scan", "dense")


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The serve path's fields of the JAX ``ParallelConfig``, with its
    defaults. ``attn_impl="flash_scan"`` (the JAX default, which runs the
    flash kernels on the Pallas backends) is not ported yet and raises in
    ``make_serve_engine``; the port's engine defaults to ``"dense"``.

    ``scan_layers`` and ``remat`` take any of their values and change
    nothing that serving computes, in the JAX package as here: ``remat``
    acts only under a gradient, and ``scan_layers`` only sets how XLA
    compiles the layer stack (the port always runs a Python loop).
    ``attn_block_q``/``attn_block_k`` are the flash kernels' tile sizes;
    ``make_serve_engine`` rejects any value but 0 until those kernels land.
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
class ServeConfig:
    """Knobs for the continuously-batched inference engine.

    ``max_batch`` × ``max_len`` fixes the preallocated ring KV cache; the
    scheduler admits queued requests into free slots and evicts finished
    ones. The flash-tile, paged-cache, chunked-prefill, preemption and
    speculative fields exist so a config reads the same as in the JAX
    package; this slice serves the ring cache with dense attention, and
    ``make_serve_engine`` raises on any of them set to other than its
    default.
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
