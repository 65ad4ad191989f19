"""Config dataclasses for the train and serve paths.

Copies of the JAX package's ``repro/configs/base.py`` (the port imports
nothing of ``repro``), cut to what the port reads:

* ``MoEConfig``, ``MambaConfig``, ``RWKVConfig``, ``EncDecConfig`` — whole.
* ``ModelConfig`` — the whole dataclass, so the configs read the same,
  with ``layer_kind``, ``layer_is_moe`` and ``supports_long_context``.
* ``CLIPConfig`` — the whole dataclass (the paper's own two-tower model).
* ``ParallelConfig`` — the JAX fields and defaults; the mesh fields act
  through the sharded ``TrainEngine`` on the data axes (``train/engine.py``),
  and the fields of what is not ported raise on any value but their
  default. Scan-over-layers does not exist in the port: layers run as a
  Python loop over the stacked group dimension.
* ``TrainConfig`` — the JAX fields and defaults, minus ``kernel_backend``
  (the port dispatches on the device of its tensors).
* ``ServeConfig`` — the engine knobs, minus the JAX ``kernel_backend``:
  the port dispatches on the device of its tensors instead.
* ``SupervisorConfig`` and ``TelemetryConfig`` — whole, with the JAX
  fields and defaults (the profiler window is ``torch.profiler``'s).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    every_n_layers: int = 1          # MoE MLP every N layers (1 = all)
    dense_residual: bool = False     # arctic: dense FFN in parallel with the MoE
    dense_residual_ff: int = 0       # width of the parallel dense FFN
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                 # 0 => ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64             # LoRA rank of the data-dependent decay
    mix_lora: int = 32               # LoRA rank of the token-shift mixes


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 24
    encoder_is_causal: bool = False


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
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encdec: Optional[EncDecConfig] = None
    attn_layer_period: int = 0       # jamba: 1 attn layer per this many
    attn_layer_offset: int = 4
    frontend: Optional[str] = None   # "vision_stub" | "audio_stub"
    frontend_tokens: int = 256       # patches / frames the stub provides
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

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing: the long_500k shape applies."""
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, i: int) -> str:
        """'attn' | 'mamba' | 'rwkv': the sequence mixer of layer i."""
        if self.rwkv is not None:
            return "rwkv"
        if self.attn_layer_period:
            return ("attn" if i % self.attn_layer_period == self.attn_layer_offset
                    else "mamba")
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        return i % self.moe.every_n_layers == (self.moe.every_n_layers - 1)


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


def _only_defaults(cfg, names, why: str):
    """Raise on a field the port does not take set to other than its
    default, rather than ignore it."""
    defaults = {f.name: f.default for f in dataclasses.fields(cfg)}
    for name in names:
        if getattr(cfg, name) != defaults[name]:
            raise NotImplementedError(
                f"{type(cfg).__name__}.{name}={getattr(cfg, name)!r}: {why}; "
                f"the port takes only the default {defaults[name]!r}")


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The JAX ``ParallelConfig``: its fields and defaults.

    The mesh fields act through the sharded ``TrainEngine``
    (``train/engine.py``) on the data axes: ``fsdp`` shards the weights'
    embed axis over data (ZeRO-3), ``fsdp_gather_weights`` with
    ``gather_wire`` ("bf16" or "int8") is the JAX package's explicit
    weight gather (``models.params.use_weight``), ``pure_dp`` folds the
    ``model`` axis into data, ``shard_kv_heads`` sets the rule of
    ``kv_heads``. A ``model`` axis above 1 without ``pure_dp`` raises in
    the engine (tensor parallelism, ROADMAP.md Queue 1 #13).
    ``grad_compression`` is carried and read by no train step, as in the
    JAX package (``distributed/compression.py`` is a library).
    ``sequence_parallel`` (#13) raises on any value but its default.
    ``moe_grouped`` (``models/moe.py``): at world 1 both settings are one
    computation; ``False`` at a world above 1 is the JAX package's one
    global sort over every rank's tokens, which the engine refuses (#13).

    ``attn_impl="flash_scan"`` (the default here and in the JAX package)
    runs the flash-attention kernels, as the JAX package does on its Pallas
    backends; ``"dense"`` runs the materialised oracle. ``scan_layers``
    only sets how XLA compiles the layer stack (the port always runs a
    Python loop) and takes any value. ``remat`` acts only under a
    gradient, and training takes each of ``"none"``, ``"block"`` and
    ``"full"`` (``models.transformer.maybe_remat``). ``attn_block_q``/
    ``attn_block_k`` are the TPU kernels' tile sizes; the card's kernels
    choose their own tiles, so the engine and the trainer reject any value
    but 0.
    """
    mesh_shape: Tuple[int, ...] = (16, 16)
    mesh_axes: Tuple[str, ...] = ("data", "model")
    fsdp: bool = False               # shard weights over data too (ZeRO-3)
    fsdp_gather_weights: bool = False  # explicit weight all-gather at use
    gather_wire: str = "bf16"        # bf16|int8: the weights' wire format
    pure_dp: bool = False            # fold the model axis into data parallelism
    moe_grouped: bool = True         # grouped MoE dispatch: a group per data shard
    shard_kv_heads: bool = True      # False: replicate K/V projections
    scan_layers: bool = True
    remat: str = "block"             # none|block|full
    sequence_parallel: bool = False  # shard seq over model (#13)
    grad_compression: str = "none"   # none|int8_rowwise (no step reads it)
    attn_impl: str = "flash_scan"    # flash_scan | dense
    attn_block_q: int = 0            # flash-attention tile sizes; 0 = auto
    attn_block_k: int = 0

    def __post_init__(self):
        if self.remat not in ("none", "block", "full"):
            raise ValueError(f"remat {self.remat!r} not in ('none', 'block', 'full')")
        if self.gather_wire not in ("bf16", "int8"):
            raise ValueError(f"gather_wire {self.gather_wire!r} not in ('bf16', 'int8')")
        if self.grad_compression not in ("none", "int8_rowwise"):
            raise ValueError(f"grad_compression {self.grad_compression!r} not in "
                             "('none', 'int8_rowwise')")
        _only_defaults(self, ("sequence_parallel",),
                       "sequence parallelism is ROADMAP.md Queue 1 #13")

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Mesh axes that jointly form the batch/data dimension (pod folds in)."""
        return tuple(a for a in self.mesh_axes if a in ("pod", "data"))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX ``TrainConfig`` that the port reads, with the
    same defaults. ``optimizer``: stable_adamw | adamw | adafactor;
    ``loss_scaler``: none | fixed_tensor | dynamic;
    ``quant_mode``: a ``core.precision`` mode (the unported ones raise when
    the policy is built); the ``fp8_*`` fields are ``fp8_mixed``'s tile
    and fallback ratio (``QuantPolicy.from_train_config``, and the
    fallback gauge of ``telemetry/health.py``). Left out: ``checkpoint_every``
    / ``keep_checkpoints`` (the Trainer and ``SupervisorConfig`` carry the
    checkpoint knobs), ``seed``, ``global_batch`` and ``seq_len``, which the
    JAX package does not read either (the caller seeds the parameters; the
    batch sets its shape)."""
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
class SupervisorConfig:
    """Knobs for the self-healing ``TrainSupervisor``
    (``repro_torch.train.supervisor``). Detection runs at the trainer's
    flush points on the metrics it already fetches; recovery restores the
    last good checkpoint and skips past the offending data window (the
    pipeline is a pure function of the data index). Repeat failures
    escalate: rewind one checkpoint earlier and skip wider, then abort."""
    checkpoint_every: int = 10       # the supervisor requires checkpoints
    keep_checkpoints: int = 4        # escalation rewinds need depth > 1
    max_retries: int = 3             # rewinds per incident before abort
    max_total_rewinds: int = 12      # global bound across all incidents
    skip_margin: int = 1             # data steps skipped past the fault
    skip_widen: int = 8              # extra skip per escalation attempt
    grad_norm_ratio: float = 20.0    # grad_norm > ratio x running EMA
    grad_norm_abs: float = float("inf")  # absolute grad-norm ceiling
    loss_jump_ratio: float = 3.0     # loss > ratio x running EMA
    detect_warmup: int = 10          # steps of EMA before ratio checks
    spike_min_history: int = 20      # LossSpikeDetector.min_history
    spike_z: float = 3.2             # LossSpikeDetector.z_threshold
    log_every: int = 10


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs for the continuously-batched inference engine.

    ``max_batch`` × ``max_len`` fixes the preallocated ring KV cache (or
    the block tables' reach under ``cache_mode="paged"``); the scheduler
    admits queued requests into free slots and evicts finished ones. The
    fields and their meaning are the JAX package's (its comments say more);
    the flash-tile fields exist so a config reads the same, and
    ``make_serve_engine`` raises on them set to other than 0: the card's
    kernels choose their own tiles.
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
    cache_mode: str = "ring"         # ring|paged (block pool + prefix cache)
    block_size: int = 16             # paged: tokens per physical KV block
    num_blocks: int = 0              # paged: pool size; 0 = ring capacity
    prefix_cache: bool = True        # paged: park finished requests' blocks
    prefill_chunk_tokens: int = 0    # paged: per-step token budget; 0 = off
    preemption: str = "off"          # paged: off|recompute (preempt-to-queue)
    spec_mode: str = "off"           # off|ngram (paged, greedy only)
    spec_k: int = 4                  # spec: max drafted tokens per slot
    spec_ngram: int = 3              # spec: longest history n-gram matched
    spec_min_ngram: int = 2          # spec: shortest n-gram accepted
    seed: int = 0                    # temperature>0 sampling seed


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Flight-recorder knobs (``repro_torch.telemetry``). ``path=None``
    disables the JSONL sink; ``profile_steps`` is an inclusive (start,
    stop) step window wrapped in ``torch.profiler`` (the ``--profile-steps
    A:B`` flag), whose Chrome trace lands in ``profile_dir``."""
    path: Optional[str] = None       # JSONL event file (None = off)
    profile_steps: Optional[Tuple[int, int]] = None
    profile_dir: str = "/tmp/repro-profile"
