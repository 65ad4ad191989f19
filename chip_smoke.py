#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure (run in the order 1-7,
24-26, 29, 9-17, 28, 19, 20, 8, 18, 23, 27, 21, 22, 30, 31, 32, 33, 34, 35):

1. environment: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, the four product flags ``full_precision_products``
   turns off (TF32 for matmuls and cuDNN, bf16 and f16 reduced-precision
   reductions), as the launchers do;
2. build: compile the five kernel libraries from this checkout with nvcc,
   in parallel (``csrc/switchback.cu``, ``csrc/flash_attention.cu``,
   ``csrc/fp8_matmul.cu``, ``csrc/paged_attention.cu``,
   ``csrc/fp8_cast.cu``);
3. kernels vs plain: each SwitchBack kernel bit-equal to its plain PyTorch
   version at the serve path's shapes (decode rows 8, prefill rows 1024,
   K in {960, 2560}, M in {320, 960, 2560}, exact half-way ties and an
   all-zero row); each flash forward kernel within a stated tolerance of
   its plain version (one full softmax where the kernel takes an online
   one) in bf16 and f32: prefill at 8 slots, Sq in {32, 64, 96, 128},
   causal and full, and Sk > Sq with kv_valid < Sk; decode at S_max in
   {96, 256} with slot lengths 1, 2, 127, 128, 129, 200 and S_max in one
   batch. At the training path's shapes (``compare_linear_kernels``,
   ``compare_flash_train``): every SwitchBack kernel of the tensor-wise
   modes, forward and dgrad, bit-equal at 2048, 8 and 1000 rows over
   every linear's widths; ``flash_fwd``, ``flash_bwd_dq`` and
   ``flash_bwd_dkv`` within stated tolerances of their plain versions at
   8 sequences of 64, 200 and 256 tokens, causal and full, kv_valid < Sk,
   bf16 and f32 (``flash_fwd``'s mean signed error of o and lse printed);
   each run twice must give the same bits. A control fault
   (KV head h % KV instead of h // group) must read at least 10x outside
   each flash tolerance;
4. serve: full-width smollm-360m (32 layers, d 960, vocab 49152; random
   weights from a seeded torch.Generator) through the ring-cache
   ``ServeEngine`` with ``quant_mode="int8_switchback"`` and the engine's
   default ``attn_impl="flash_scan"``: a warm-up, then a timed
   ``generate`` of 16 requests (prompts of 32-96 tokens, 32 new tokens).
   Every kernel's launch counter is zeroed just before the timed run and
   must be exactly what the run's prefill and decode calls imply just
   after (flash_fwd 32 per prefill call, decode_fwd 32 per decode step);
5. whole model, kernels vs plain: the served engine's logits (prefill
   plus three decode steps) with the kernels and with the plain versions
   swapped in on the card: with ``attn_impl="dense"`` (the four SwitchBack
   forward kernels) bit-equal, with ``flash_scan`` within a stated
   tolerance;
6. reference: the same engine at full width and two layers on the card
   and on the CPU (plain versions, which the CPU tests hold against the
   JAX package), prefill plus three decode steps, under ``dense`` and
   ``flash_scan``: card kernels against card plain (bit-equal under
   dense, within tolerance under flash_scan), card within stated
   tolerances of the CPU, and a control fault on the CPU (KV heads tiled
   instead of repeated) outside them;
7. decode profile, under ``flash_scan`` and ``dense`` in turns (flash,
   dense, dense, flash): one decode step's wall time, its wrapper
   launches (counted over ten steps, each kernel exactly its per-layer
   count times the layers), its device time and CUDA launches by kernel
   (torch.profiler), at the serve run's batch; ``tensor_quantize``'s
   CUDA kernels no more than its wrapper calls (224 a step);
8. timing: each kernel, its plain version and (where one exists) one
   PyTorch library call, with CUDA events at the path's shapes (the
   serve kernels at decode and prefill rows, the train kernels at 8 x 256
   tokens), beside the least time the card could take (bytes over 3.35
   TB/s, operations over the peak for their type); each
   ``int8_matmul_dequant`` form's TOPS and the bound's share of its time;
9. train (the training path): full-width smollm-360m with
   ``int8_switchback``, ``flash_scan`` and StableAdamW through
   ``make_train_setup``, ``make_train_step`` and ``Trainer``, on BigramLM
   batches of 8 x 256: a warm-up step, then 6 timed steps with every
   launch counter zeroed just before and read just after, each exactly
   its per-layer count times the layers times the steps; every loss
   finite;
10. one train step, kernels vs plain: loss and every gradient at 2 layers
    (full width, three seeds) under flash_scan in f32 and bf16 and under
    dense in f32, and at 32 layers under flash_scan in bf16, within stated tolerances,
    with a control fault outside (KV heads tiled; under dense the weight
    gradient rounded through bf16);
11. card vs CPU: 3 train steps at full width and 2 layers from the same
    parameters and batches (three seeds): loss trajectory and the final
    parameters' per-leaf mean difference within stated tolerances, the control fault (KV heads tiled) outside;
12. train-step profile: wall time, device time and idle share, CUDA
    launches and device time by kernel (torch.profiler), tokens trained
    per second; ``tensor_quantize``'s CUDA kernels no more than its
    wrapper calls;
13. CLIP kernels vs plain: every SwitchBack kernel of the four modes
    (the fused forward and dgrad, ``row_quantize`` with
    ``int8_matmul_dequant`` and its transposed form, ``tensor_quantize``,
    ``col_quantize`` and the colscale matmul in both orientations)
    bit-equal to its plain version at the shapes phase 15 gives it (every
    weight of both towers, batch 32: 4,128 vision rows, 8,192 patch rows
    at K = 588, 2,464 text rows), ties and an all-zero row, each run twice
    with the same bits; then the four ``int8_matmul_dequant`` forms (int8
    wgmma) at the new paths' edges, bit-equal and twice the same bits: rows
    1 and 8 (the swapped decode form), 17 and 1,000 against K = 588 (the
    masked producer), M = 320 (a ragged tile) and 2,560 -> 960, and
    all-±127 operands at K = 5,120 (the widest s32 sum, checked exactly);
    then ``row_quantize`` and ``col_quantize`` at their edges
    (``compare_int8_quantizer_edges``: every group size and granule, the
    wide paths, ragged bands and slabs, aligned and unaligned bases, ties,
    all-zero rows and columns, a lone outlier in the last row), bit-equal
    and twice the same bits, the control fault (a band's last slab left out
    of its absmax) outside in every case; then ``tensor_quantize``
    (``compare_tensor_quantizer_edges``: every path weight, each on the one
    launch in bf16 and one CUDA kernel a call (the kernel nodes of a CUDA
    graph of these calls), ragged and small n, the one-launch limit and a granule
    either side, offsets of 0, 1, 2 and 4 elements, the absmax first, last,
    inside the last block's span and at a span's edge, negative, ties, an
    all-zero tensor) bit-equal and twice the same bits, the control fault
    (the absmax's block's partial left out) outside in every case with more
    than one block; phase 15 also fails a mode whose profile groups (the
    quantizers it runs) match none of their wrapper's kernels, by name,
    read exactly from the nodes of a CUDA graph of one call;
14. the flash kernels at CLIP's attention shapes, vision (32, 129, 16, 80)
    with no mask and text (32, 77, 16, 64) causal, forward and both
    backward kernels, bf16 and f32, within the tolerances of phase 3; the
    control faults (lanes past 64 dropped at hd 80, the mask dropped at
    hd 64) at least 10x outside;
15. CLIP train (the paper's own model): ViT-H/14 at full width and
    CLIP_TRAIN_LAYERS (8 + 6) of its 32 + 24 layers (the depth cut to
    keep the script inside its time; random weights from a seeded
    torch.Generator) through
    ``make_train_setup``, ``make_train_step`` and ``Trainer`` in each of
    ``int8_switchback`` (zero-init layer-scale), ``int8_switchback_m``,
    ``int8_switchback_q`` and ``int8_llm``: SyntheticCLIP batches of 32
    pairs at 224 px, patch dropout 0.5, StableAdamW; a warm-up step, then
    3 timed steps with every launch counter zeroed just before and read
    just after, each exactly the count worked out from the layer shapes
    (``clip_launches_per_step``); every loss finite; peak memory; one
    step profiled, ``tensor_quantize``'s CUDA kernels no more than its
    wrapper calls (85 a step in ``int8_switchback`` and ``_m`` at 8 + 6
    layers);
16. one CLIP train step at 2 + 2 layers and full width, kernels vs plain,
    in each int8 mode: under flash_scan from three seeds within stated
    tolerances, the control fault (the positional embedding read one row
    off) outside; under dense bit-equal;
17. CLIP card vs CPU: 3 train steps at 2 + 2 layers and full width from
    three seeds, which take the two column-wise modes in turn, the same
    fault outside;
18. timing of the CLIP kernels: one vision layer's calls at 4,128 rows,
    beside their bound, plain version and ``torch._int_mm`` + scale (the
    int8 forms' TOPS and bound share); the column-wise modes'
    ``row_quantize`` and ``col_quantize`` calls and the tensor-wise modes'
    ``tensor_quantize`` of the weights at each tower's layer (vision,
    text, the patch embedding); ``flash_fwd`` at the two attention
    shapes of phase 14 beside SDPA, ``flash_bwd_dq`` and ``flash_bwd_dkv``
    there beside SDPA's backward;
19. fp8 kernels vs plain at every CLIP main-path shape (phase 13's table,
    both formats) and at 37 x 130 -> 70: ``row_quantize``,
    ``tensor_quantize``, ``block_quantize``, ``transpose_bytes`` (an op
    entry point) and ``tensor_quantize_kt`` (the fp8 paths' quantizer of W:
    the codes and, from the same registers, the forward's K-major W; its q
    and state the flat kernel's bits, its q_k ``transpose_bytes``') bit-equal;
    both forwards given the fold's ``w_k`` bit-equal to the same call
    through ``transpose_bytes``; the four matmul forms
    (``fp8_matmul_dequant``, ``fp8_mixed_matmul``, each with its ``_t``
    form, on fp8 wgmma) within ``F8REF.matmul_bound`` per output (a worst
    case) and, at ``F8TC.check_rows``, bit-equal to ``F8TC``
    (``kernels/fp8_matmul/wgmma_model.py``, the model of their tensor-core
    arithmetic), on rows of many scales with outlier tiles (both of
    fp8_mixed's branches run) and on rows of one scale; their control
    faults (one k32 slab of A read one row off; the fallback bits dropped)
    at least 10 output ulps off the model; bit-equal on
    ``F8REF.exact_entries`` inputs (fallback tiles in a checkerboard); fp8
    ties, an all-zero row and an all-zero tile; each run twice with the
    same bits; ``tensor_quantize`` at phase 13's edges in both formats, and
    ``tensor_quantize_kt`` at them and at its own (37 x 5, 130 x 70, a bf16
    3,000 x 3,000 past the registers), both copies bit-equal, one CUDA
    kernel a call, its control faults (the absmax's block's partial left
    out; that block's K-major tile left unwritten) caught;
20. CLIP fp8 train: as phase 15 in ``fp8_sim`` (zero-init layer-scale,
    the paper's recipe), ``fp8``, ``fp8_mixed`` and ``fp8_switchback``;
    every launch counter (the seven fp8 kernel forms and transpose_bytes
    included) exactly its worked-out count (transpose_bytes 0: the fold
    gives the forward's W); the fp8 ``tensor_quantize``'s CUDA kernels (the
    fold's) no more than its wrapper calls (169 a step in ``fp8`` and
    ``fp8_mixed`` at phase 15's depth), the transpose_bytes profile group
    empty;
21. one CLIP step at 2 + 2 layers and full width, kernels vs plain, in
    ``fp8`` and ``fp8_mixed`` from three seeds (as phase 16), under
    flash_scan and under dense (the tensor cores' sums are not the plain
    versions'), within CLIP_FP8_STEP_TOL (per-leaf relative norms); two
    control faults, the positional embedding read a row off and the fp8
    matmuls reading a k32 slab of A a row off, outside on every key;
22. CLIP fp8 card vs CPU: 3 steps at 2 + 2 layers, ``fp8`` and
    ``fp8_mixed`` in turn across three seeds (as phase 17), the final
    parameters' worst per-leaf mean within CLIP_FP8_CARD_CPU_TOL; three
    control faults outside it at every seed: the positional embedding read
    a row off (on the card), the plain fp8 matmuls reading a k32 slab of A
    a row off and the text tower's causal mask dropped (both on the CPU);
23. timing of the fp8 kernels: one vision layer's calls at 4,128 rows
    beside their bound (the matmuls' operations at the fp8 peak), plain
    version and ``torch._scaled_mm`` with row-wise scales (transpose_bytes
    beside ``w_q.t().contiguous()``); the matmuls' TFLOP/s and the bound's
    share of their time; the fold (``tensor_quantize_kt``) beside the flat
    ``tensor_quantize``, the parent's pair (``tensor_quantize`` +
    ``transpose_bytes``) and the library pair, also at the text layer's and
    the patch embedding's weights; the forwards given ``w_k`` beside the
    same calls through ``transpose_bytes``;
24. paged kernels vs plain at the paged serve path's shapes (8 slots,
    tables of 64 blocks of 16, ragged lengths 0 to 1,024, dead table
    entries outside the pool, a dry slot): ``paged_decode_fwd`` and
    ``paged_prefill_fwd`` (Sq in {1, 5, 128, 300}, ragged offsets off the
    block edges) within FLASH_O_TOL of their plain versions, q in bf16 and
    f32 over bf16 pools, two launches the same bits, the control fault
    (table rows rotated by one) 10x outside; every prefill row bit-equal to
    the decode kernel at kv_len = its position + 1; the mean signed error
    of o printed (the tensor cores' sums). Then each kernel timed
    at served shapes beside its bound, its plain version and SDPA over the
    gathered cache (the gather timed beside it);
25. paged serve (the paged main path): smollm-360m at full width and
    PAGED_LAYERS (16) of its 32 layers (the depth cut to keep the script
    inside its time) through the
    ``ServeEngine`` with ``cache_mode="paged"``, ``int8_switchback``, 8
    slots of 1,024 cells in blocks of 16, ``prefill_chunk_tokens=256``: a
    warm-up, then 32 requests sharing a 256-token system prompt with a
    32-512-token suffix each, 64 new tokens, greedy; every launch counter
    exactly its worked-out count (paged_decode 16 per decode step,
    paged_prefill 16 per prefill or verify call, the SwitchBack kernels as
    phase 4 counts them, the flash kernels 0); the stats row. The served
    model's logits (prefill + 3 decode steps, three seeds) kernels vs plain
    within PAGED_MODEL_TOL, the control fault (KV heads tiled) outside;
26. the paged features at phase 25's width and depth: a tight pool with
    ``preemption="recompute"`` preempts and gives every request the roomy
    pool's tokens; ``spec_mode="ngram"`` on repetitive prompts accepts
    drafts and gives spec off's tokens; launch counts exact; a verify
    pass's logit rows against decode steps' (printed);
27. the op entry points ``wgrad_bf16`` (``kernels/switchback/ops.py``),
    ``fp8_cast_tensorwise`` (``kernels/fp8_cast/ops.py``) and
    ``transpose_bytes`` (``kernels/fp8_matmul/ops.py``, at every CLIP fp8
    weight shape and 130 x 70, 37 x 5: byte for byte the plain copy), which
    no serve or train path calls (their counters read 0 in every phase
    above): each
    driven once at every shape below with the counters zeroed just before
    and read just after, then run again for the same bits and held against
    its plain version: ``fp8_cast_tensorwise`` bit-equal; ``wgrad_bf16``
    (bf16 wgmma) within ``REF.wgrad_bound``, bit-equal on exactly summable
    inputs at the same shape and bit-equal to the tensor-core model
    (``F8TC.wgrad_rows``) at ``F8TC.check_rows``. ``fp8_cast_tensorwise`` in both
    formats at the JAX package's test shapes (17, 257, 512 and 1,030 rows
    x 130) and CLIP's (X 4,128 x 1,280 and 4,128 x 5,120 bf16, W 1,280 x
    3,840 and 1,280 x 5,120 f32), with the tensor's absmax, a larger stale
    one and one under which values clip; fp8 ties after scaling, fp8
    subnormals, zeros of both signs; an all-zero tensor with absmax 0; the
    two inputs where the JAX kernel and its XLA path differ, at the
    kernel's values. ``wgrad_bf16`` at smollm's training shapes (2,048
    rows, and 8 and 1,000), one CLIP vision layer's four weight gradients
    (4,128 rows), the text layer's (2,464) and the patch embedding (8,192
    x 588 -> 1,280); also against cuBLAS (``wgrad_16bit``) within
    WGRAD_BOUND, with the control fault (Ẏ's rows shifted by one) outside
    it and outside ``REF.wgrad_bound``.
    Then both timed at CLIP's shapes (and wgrad at smollm's) beside their
    bound, plain version and library call;
28. the accumulator probe, before phase 19: one window of each form the
    fp8 matmuls and wgrad_bf16 issue (E4M3 x E4M3 and E5M2 x E4M3
    m64n128k32, bf16 m64n128k16 with K-major operands and with MN-major
    ones, wgrad_bf16's), chained over up to four steps as the GEMMs chain them, on
    constructed operands against the exact sums: how many bits below the
    largest addend each keeps, in a step and into the fragment, whether it
    truncates or rounds, whether small addends are dropped one by one,
    whether the fragment itself is truncated, subnormal products; fails if
    a form keeps fewer bits than ``F8REF.ACC_BITS`` (what matmul_bound and
    the model assume). Beside them the attention kernels' mma.sync
    m16n8k16 bf16 step: the widths of a step's sum and of its addends;
29. self-healing CLIP training and the flight recorder (after phase 26):
    CLIP ViT-H/14 at full width and 2 + 2 layers, ``int8_switchback`` with
    zero-init layer-scale, batch 32, patch dropout 0.5, StableAdamW, data
    index j a ``DeterministicBatcher`` over ``SyntheticCLIP(seed=2900 +
    j)``, checkpoints in a temporary directory the phase removes; every
    launch counter exactly the CLIP step's count times the steps each run
    took. (a) 12 steps, a checkpoint every 3 (4 kept): losses and a SHA-256
    of the final state; (b) the same run crashed at step 7
    (``SimulatedCrash``), a fresh Trainer resumes at 6: losses and digest
    bit-equal to (a); a leaf of the newest checkpoint truncated and a stray
    ``.tmp`` left: resume warns, falls back to 9, replays to (a)'s digest;
    (c) a ``TrainSupervisor`` under a NaN gradient at index 7, checkpoint
    6 bit-flipped, checkpoint 9's write failing and a gradient explosion at
    index 13 (detection only the faults can trip): its report equal to
    SELFHEAL_REPORT (pinned against the JAX supervisor on the CPU), every
    loss finite; (d) a plain Trainer without checkpoints fed the shifted
    indices (c)'s rewind log implies reaches (c)'s losses and digest bit
    for bit; (e) two control faults break (d)'s equality: a restore that
    leaves the generator as it was, a skip one index short; (f) (c) again
    with telemetry and a ``torch.profiler`` window over steps 2-3: the file
    valid, its event kinds and steps equal to SELFHEAL_EVENTS (pinned as
    the report), the trace naming the fused SwitchBack and flash kernels,
    losses, digest and metric fetches those of (c); the median
    ``checkpoint_save``, ``rewind`` and ``flush`` spans and the wall time
    a step with and without checkpoints; (g) phase 25's paged engine
    serves 8 requests with telemetry on and (c)'s supervisor as
    ``stability_source``: the telemetry-off run's tokens, every request's
    submitted and finished events, prefill and decode wave spans, launches
    exact, the stats row's ``supervisor_*`` (c)'s counters; (h) the state
    at ROUND_TRIP_LAYERS (8 + 6) layers, one step, then ``save_async``,
    ``wait``, ``verify`` and ``restore`` into a fresh state: every leaf and
    the generator's state bit-equal; bytes, free disk (too little fails
    the phase) and seconds of each part.

30. the paper's remaining training options, CLIP ViT-H/14 at full width
    and depth, batch 32 (after phase 22; each part prints its seconds):
    (a) the f16 forms of ``flash_fwd``, ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` against their plain versions at CLIP's vision and
    text attention (causal and full) and phase 3's smollm edges (o within
    2^-10 of max|o|, the backward within FLASH_BWD_TOL, twice the same
    bits, the case faults 10x outside), two control faults that must fail
    (o rounded through bf16; a one-term split), and their times beside
    the bound and SDPA at f16; (b) the ``FP16`` policy (f16 compute) with
    the ``fixed_tensor`` and then the ``dynamic`` loss scaler, 3 steps
    each with the kernels (launches exact) and with the plain attention:
    the loss-scale sequence and the skipped-tensor counts equal, losses
    finite where nothing was skipped, a step that updates, each leaf's
    change within FP16_DELTA_TOL; (c) ``fp32`` with bf16 and with f32
    compute under ``remat="block"``, 2 steps each, one step's loss and
    gradient with the kernels against the plain versions within
    FP32_STEP_TOL; (d) ``int8_switchback`` under ``remat="block"`` against
    ``"none"``: losses and every parameter bit-equal, peak GiB, device ms,
    wall ms and launches a step of each, then batch 128 under ``"block"``,
    at REMAT_LAYERS (4 + 3) layers (the depth cut to keep the script
    inside its time);
    (e) AdaFactor: 3 finite steps, its state's bytes beside StableAdamW's,
    its state through ``CheckpointManager`` bit for bit; (f) App. C's
    measured and predicted variance of the Eq. 3 product on the card's
    kernels at k = 1,280, 5,120 and 65,536 (b = m = 256): each ratio in
    [0.3, 3], growing with k, the kernels bit-equal to the plain
    functions.

31. data-parallel and ZeRO-3 training through the ``TrainEngine``
    (``make_engine``) on a world-1 NCCL group, CLIP ViT-H/14 at full width
    and ENGINE_LAYERS (2 + 2) layers, ``int8_switchback``, batch 32,
    ENGINE_STEPS steps a run (last): (a) without fsdp, the losses, final
    state and launch counts of the direct ``make_train_step`` exactly; (b)
    fsdp with the explicit weight gather and pure_dp (bf16 wire): (a)'s
    exactly; (c) the same over the int8 wire: the direct step whose
    weights pass through ``models.params.int8_wire`` exactly, and a
    control fault (an absmax per half of each weight) that must not be;
    (d) device ms and CUDA launches a step of each (torch.profiler), NCCL's
    kernels apart, peak memory, and the per-rank state bytes predicted
    from the leaf sizes at world 4 under fsdp (full depth).

32. the mixture-of-experts family and fp16/fp32 serving (last; each part
    prints its seconds): (a) the three expert-batched SwitchBack forms
    (``tensor_quantize_batched``, ``fused_switchback_fwd_batched``,
    ``fused_switchback_dgrad_batched``) at qwen3-moe-30b-a3b's expert
    shapes (128 experts, 2,048 -> 768 and 768 -> 2,048) at decode's C = 4
    and train's C = 160, bf16 and f32, bit-equal to their plain versions
    and to the 2-D kernels looped over the experts, twice the same bits,
    one wrapper launch a call; their times at one layer's three expert
    linears beside the bound, the plain version and a ``torch._int_mm``
    loop over the experts (a hint: no single PyTorch call runs a batched
    int8 GEMM); (b) qwen3-moe-30b-a3b at full width and 2 layers,
    ``int8_switchback``, the ring and the paged engine: 8 prompts of
    32-128 tokens, 32 new tokens, every launch counter exact (the experts
    on the batched forms only), the tokens equal to the same engine's with
    the SwitchBack plain versions swapped in, a decode step's device ms
    and CUDA kernels (the nodes of a CUDA graph of it); (c) qwen3 at full
    width and 2 layers through ``make_engine`` on a world-1 NCCL group, 3
    steps of 8 x 256 tokens: launches exact, losses and ``moe_aux`` finite,
    peak memory, device ms; the reduced qwen3 card vs CPU over three seeds
    (phase 11's readings) within MOE_CARD_CPU_TOL, a control fault (the
    router's top k taken from the bottom, on the CPU) outside; (d)
    minitron-8b at full width and 2 layers, ``int8_switchback``, and
    smollm-360m at full width and 8 layers in ``bf16``, ``fp16`` and
    ``fp32`` on both caches: launches exact, served ``fp16`` bf16's tokens
    bit for bit.

33. the SSM and hybrid families (last; each part prints its seconds):
    first every SwitchBack kernel at the new paths' shapes bit-equal to its
    plain version (``ssm_linear_shapes``: rwkv6's 2,048 x 2,048 and 2,048 x
    7,168 at decode and train rows, jamba's linears with w_x_proj's 8,192
    -> 288, the reduced configs' with the reduced w_x_proj's 24 outputs),
    and the expert-batched forward at jamba's expert shapes; (a)
    rwkv6-1.6b at full width and RWKV_SERVE_LAYERS (12 of 24) layers and
    (b) jamba-v0.1-52b at full width and one period (8 layers: 7 Mamba, 1
    attention, 4 MoE),
    random weights from the seed, each refused by ``make_serve_engine``
    and served by ``launch/serve.decode_step_fallback`` (8 rows, a prompt
    of 32, 32 new tokens) in ``int8_switchback`` (every launch counter
    exactly RWKV_DECODE_PER_LAYER x 12 or JAMBA_DECODE_PER_PERIOD a step,
    tokens equal to the loop's with the SwitchBack plain versions swapped
    in) and ``bf16`` (no SwitchBack launch); a decode step's device ms and
    CUDA kernels (a CUDA graph of it) and the plain recurrences' share of
    both; the peak (jamba's under 80 GB); (c) rwkv6 at full width and depth
    through ``make_engine`` on a world-1 NCCL group, 3 StableAdamW steps of
    8 x 256 tokens (the chunked form): launches exact, losses finite, the
    peak under RWKV_TRAIN_PEAK_GIB, device ms; (d) both reduced configs
    card vs CPU over three seeds, 2 steps, within SSM_CARD_CPU_TOL, a
    control fault on the CPU (rwkv6's token shift dropped; jamba's conv
    taps reversed) outside. jamba at full width does not train on one
    card (one period's 13.3 B parameters with StableAdamW's state are
    ~213 GB): its training is the reduced config's here and the CPU
    tests'.

34. the multimodal and enc-dec group (each part prints its seconds): (a)
    every SwitchBack kernel at internvl2-76b's and seamless-m4t-large-v2's
    linear shapes bit-equal to its plain version (``mm_linear_shapes``:
    decode, frontend and train rows, both reduced configs; seamless's f32
    frontend_proj quantized from its f32 values), the flash kernels at the
    new attention shapes (``mm_flash_cases``: seamless's 4,096-frame
    encoder, its cross attention at 64 and 1 queries over 4,096 frames,
    internvl2's causal 320 over 64/8 heads of 128, the reduced shapes;
    forward and both backward kernels, bf16 and f32, each case a control
    fault FAULT_MARGIN x out), ``decode_fwd`` at query groups 8 and 1; their
    times beside the bound, the plain version and the library call
    (``time_mm_kernels``); (b) internvl2 at full width and 8 layers refused
    by ``make_serve_engine`` (a frontend) and served by
    ``decode_step_fallback`` (text only) as phase 33 serves an SSM stack;
    (c) seamless at full width and depth: 8 rows of 4,096 frames through
    ``init_decode_state``, 32 greedy tokens by ``decode_step``; in (b) and
    (c) ``int8_switchback`` (launches exact, tokens equal to the plain
    versions') and ``bf16`` (the attention kernels only), a step's device ms
    and CUDA kernels by graph replay; (d) seamless (full depth, 2 x 4,096
    frames and 64 targets, StableAdamW) and internvl2 (1 layer, 8 x (256 +
    64), AdaFactor: StableAdamW's out-of-place update does not fit one card
    at its 3.02 B parameters) trained through ``make_engine`` on a world-1
    NCCL group: launches exact (``mm_launches``), losses finite, peaks under
    MM_PEAK_GIB; (e) both reduced configs card vs CPU over three seeds, 2
    steps, within MM_CARD_CPU_TOL, a control fault on the CPU outside
    (seamless's cross attention fed the decoder's own states; internvl2's
    frontend tokens appended instead of prepended).

35. the code models granite-20b (48 query heads over one KV head of 128)
    and starcoder2-3b (24 over 2) on the wide-group forms of ``decode_fwd``
    and the paged template (last; each part prints its seconds): (a) every
    SwitchBack kernel at both models' linears bit-equal to its plain
    version (``code_linear_shapes``: decode, prefill and train rows, both
    reduced configs), the flash kernels at their causal 8 x 256 training
    shapes (``code_flash_cases``), ``decode_fwd`` at groups 48 and 12 over
    the served 256-cell ring at every length and a ragged set, q bf16 and
    f32 (``compare_wide_decode``), both paged kernels at the same groups
    (``compare_wide_paged``: phase 24's checks with the prefill-row =
    decode-row bits), each wide launch bit for bit the launches of the
    same heads in groups of 8 (ring) and 16 (paged), and the wide control
    fault (heads from 16 on written one head off) FAULT_MARGIN x out; the
    narrow groups' output digests (``narrow_digests``); times beside the
    bound, the plain version and SDPA (``time_code_kernels``); (b)
    granite-20b at full width and 8 of 52 layers and (c) starcoder2-3b at
    full width and depth through the ring and the paged ``ServeEngine`` in
    ``int8_switchback`` (launches exact, tokens equal to the plain
    versions') and ``bf16``: 8 prompts of 32, 32 new; tokens/s, TTFT, ITL,
    a decode step's device ms and CUDA kernels, the peak; (d) granite at 2
    layers and starcoder2 at 12 trained through ``make_engine`` on a
    world-1 NCCL group (StableAdamW, 8 x 256): launches exact
    (``mm_launches``), losses finite, peaks under CODE_PEAK_GIB; (e) both
    reduced configs card vs CPU over three seeds, 2 steps, within
    CODE_CARD_CPU_TOL, a control fault on the CPU outside (granite's
    LayerNorm uncentred; starcoder2's KV heads tiled).

Each phase prints its seconds (``[time]``), and all of them together
before the result. The line before the last holds ``{"kernels": [...]}``;
the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (dense): HBM bandwidth, int8, fp8 and bf16
# tensor-core ops, f32 ops outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

SB_SOURCE = "src/repro_torch/kernels/switchback/csrc/switchback.cu"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
F8_SOURCE = "src/repro_torch/kernels/fp8_matmul/csrc/fp8_matmul.cu"
PA_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
FC_SOURCE = "src/repro_torch/kernels/fp8_cast/csrc/fp8_cast.cu"
PA_PY = "src/repro/kernels/paged_attention/paged_attention.py"
# the fp8 wrappers' launch-count keys (kernels/fp8_matmul/ops.py)
FP8_KERNELS = ("fp8_row_quantize", "fp8_tensor_quantize", "fp8_block_quantize",
               "fp8_matmul_dequant", "fp8_matmul_dequant_t", "fp8_mixed_matmul",
               "fp8_mixed_matmul_t", "fp8_transpose_bytes")
F8_PY = "src/repro/kernels/fp8_matmul/fp8_matmul.py"
SOURCE = {"tensor_quantize": SB_SOURCE, "fused_switchback_fwd": SB_SOURCE,
          "row_quantize": SB_SOURCE, "int8_matmul_dequant": SB_SOURCE,
          "fused_switchback_dgrad": SB_SOURCE, "int8_matmul_dequant_t": SB_SOURCE,
          "col_quantize": SB_SOURCE, "int8_matmul_dequant_colscale": SB_SOURCE,
          "int8_matmul_dequant_colscale_t": SB_SOURCE,
          "flash_fwd": FA_SOURCE, "decode_fwd": FA_SOURCE,
          "flash_bwd_dq": FA_SOURCE, "flash_bwd_dkv": FA_SOURCE,
          **dict.fromkeys(FP8_KERNELS, F8_SOURCE),
          "paged_decode_fwd": PA_SOURCE, "paged_prefill_fwd": PA_SOURCE,
          "wgrad_bf16": SB_SOURCE, "fp8_cast_tensorwise": FC_SOURCE}
REPLACES = {
    "tensor_quantize": "src/repro/kernels/switchback/switchback.py:124",
    "fused_switchback_fwd": "src/repro/kernels/switchback/switchback.py:269",
    "row_quantize": "src/repro/kernels/switchback/switchback.py:44",
    "int8_matmul_dequant": "src/repro/kernels/switchback/switchback.py:197",
    "fused_switchback_dgrad": "src/repro/kernels/switchback/switchback.py:315",
    "int8_matmul_dequant_t": "src/repro/kernels/switchback/switchback.py:197",
    "col_quantize": "src/repro/kernels/switchback/switchback.py:83",
    "int8_matmul_dequant_colscale": "src/repro/kernels/switchback/switchback.py:176",
    "int8_matmul_dequant_colscale_t": "src/repro/kernels/switchback/switchback.py:176",
    "flash_fwd": "src/repro/kernels/flash_attention/flash_attention.py:123",
    "decode_fwd": "src/repro/kernels/flash_attention/flash_attention.py:384",
    "flash_bwd_dq": "src/repro/kernels/flash_attention/flash_attention.py:216",
    "flash_bwd_dkv": "src/repro/kernels/flash_attention/flash_attention.py:302",
    "fp8_row_quantize": F8_PY + ":47", "fp8_tensor_quantize": F8_PY + ":86",
    "fp8_block_quantize": F8_PY + ":128", "fp8_matmul_dequant": F8_PY + ":176",
    "fp8_matmul_dequant_t": F8_PY + ":176", "fp8_mixed_matmul": F8_PY + ":258",
    "fp8_mixed_matmul_t": F8_PY + ":258",
    # the forward matmuls' K-major copy of W, part of their port (both
    # fp8_matmul_dequant :176 and fp8_mixed_matmul :258 run it)
    "fp8_transpose_bytes": F8_PY + ":176",
    "paged_decode_fwd": PA_PY + ":214", "paged_prefill_fwd": PA_PY + ":148",
    "wgrad_bf16": "src/repro/kernels/switchback/switchback.py:364",
    "fp8_cast_tensorwise": "src/repro/kernels/fp8_cast/fp8_cast.py:32",
}
# the op entry points' kernels, which no serve or train path launches: every
# phase that checks exact launch counts expects 0 of each
OP_KERNELS = ("wgrad_bf16", "fp8_cast_tensorwise")
# the SwitchBack wrappers, forward and input gradient (kernels/switchback/ops.py)
SB_KERNELS = ("tensor_quantize", "fused_switchback_fwd", "row_quantize", "col_quantize",
              "int8_matmul_dequant", "fused_switchback_dgrad", "int8_matmul_dequant_t")
# launches per layer per model call (prefill or decode step): every
# linear quantizes its weight; wq, wk, wv, wo, w_up, w_gate contract over
# K = 960 <= 2048 (fused); w_down over K = 2560 (row_quantize + matmul)
PER_LAYER = {"tensor_quantize": 7, "fused_switchback_fwd": 6,
             "row_quantize": 1, "int8_matmul_dequant": 1}
# under flash_scan: launches per layer per prefill call and per decode step
FLASH_PER_LAYER = {"flash_fwd": {"prefill": 1, "decode": 0},
                   "decode_fwd": {"prefill": 0, "decode": 1}}
# flash kernel vs plain: o relative to max|o| (one ulp at the largest value
# in bf16 and in f16: both sides compute in f32 and round once), lse
# absolute; the control fault must read 10x outside
FLASH_O_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5, "float16": 2.0 ** -10}
FLASH_LSE_TOL = 1e-5
FAULT_MARGIN = 10.0

DECODE_ROWS, PREFILL_ROWS = 8, 8 * 128

# the training path: BigramLM batches of 8 x 256 tokens, one microbatch
TRAIN_BATCH, TRAIN_SEQ = 8, 256
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ
# the data chain's vocabulary: BigramLM keeps a dense (V, V) float64
# transition table, 19 GB at the model's 49,152 ids; the chain spans the
# first 8,192 ids (512 MB), the model and its head keep all 49,152
DATA_VOCAB = 8192
# wrapper launches per layer of one train step (forward and backward,
# remat "none"): every linear quantizes its weight once; the forward as
# serving; the dgrad of wq, wk, wv, wo and w_down contracts over the
# layer's output width (960 or 320 <= 2048: fused), that of w_up and
# w_gate over 2560 (row_quantize + the transposed matmul); attention runs
# flash_fwd once and each backward kernel once
TRAIN_PER_LAYER = {"tensor_quantize": 7, "fused_switchback_fwd": 6, "row_quantize": 3,
                   "int8_matmul_dequant": 1, "int8_matmul_dequant_t": 2,
                   "fused_switchback_dgrad": 5, "flash_fwd": 1, "flash_bwd_dq": 1,
                   "flash_bwd_dkv": 1, "decode_fwd": 0, **dict.fromkeys(OP_KERNELS, 0)}
# flash backward kernel vs plain, relative to max|grad|: the same
# recomputed p on both sides, the sums over keys and query rows in another
# order (f32 in every dtype: bf16 and f16 inputs are exact in f32)
FLASH_BWD_TOL = {"bfloat16": 1e-4, "float32": 1e-4, "float16": 1e-4}


class Failure(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise Failure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs at the path's shapes
# ---------------------------------------------------------------------------

def path_shapes(cfg):
    """The (K, M) of every linear of one layer, in call order (a GELU MLP
    has no w_gate)."""
    D, FF = cfg.d_model, cfg.d_ff
    Hd, KVd = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    gate = {"w_gate": (D, FF)} if cfg.act == "swiglu" else {}
    return {"wq": (D, Hd), "wk": (D, KVd), "wv": (D, KVd), "wo": (Hd, D),
            "w_up": (D, FF), **gate, "w_down": (FF, D)}


def activations(torch, gen, R, K, dev, dtype=None):
    """Random bf16-valued rows; from 3 rows on, row 1 holds exact half-way
    ties at scale 1 (absmax 127), row 2 is all zero."""
    dtype = dtype or torch.bfloat16
    x = torch.randn((R, K), generator=gen, device=dev) * 3
    if R >= 3:
        ties = (torch.arange(K, device=dev, dtype=torch.float32) % 8) - 3.5
        ties[0] = 127.0
        x[1] = ties
        x[2] = 0.0
    return x.to(torch.bfloat16).to(dtype)


def weight(torch, gen, K, M, dev, ties=False):
    """A bf16 weight as ``use_weight`` hands it to the quantizer. With
    ``ties`` the absmax is 127/128, so the scale is exactly 128 and the
    odd multiples of 1/256 land on .5."""
    w = torch.randn((K, M), generator=gen, device=dev) / K ** 0.5
    if ties:
        w[0, 0] = 127.0 / 128.0
        w[1, :16] = (2 * torch.arange(16, device=dev, dtype=torch.float32) - 15) / 256
    return w.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def max_abs_diff(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def compare_kernels(torch, KOPS, REF, cfg, dev, seed):
    """Bitwise kernel-vs-plain at the path's shapes. Returns the largest
    |kernel - plain| per kernel (0.0 when bit-equal)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {k: 0.0 for k in PER_LAYER}
    n = 0

    def same(name, got, ref, what):
        nonlocal n
        d = max_abs_diff(torch, got, ref)
        worst[name] = max(worst[name], d)
        check(got.dtype == ref.dtype and got.shape == ref.shape
              and torch.equal(got, ref),
              f"{name} {what}: kernel != plain (max |diff| {d:g})")
        n += 1

    wq = {}
    for lin, (K, M) in path_shapes(cfg).items():
        for ties in (False, True):
            w = weight(torch, gen, K, M, dev, ties)
            q, s = KOPS.tensor_quantize(w)
            rq, rs = REF.tensor_quantize(w)
            same("tensor_quantize", q, rq, f"{lin} {tuple(w.shape)} ties={ties}")
            same("tensor_quantize", s, rs, f"{lin} state")
            wq[lin] = (q, s)
    # f32 compute hands the quantizer the f32 master weight itself
    w = torch.randn((960, 2560), generator=gen, device=dev) / 960 ** 0.5
    same("tensor_quantize", KOPS.tensor_quantize(w)[0], REF.tensor_quantize(w)[0],
         "f32 (960, 2560)")
    zero = torch.zeros((960, 320), dtype=torch.bfloat16, device=dev)
    same("tensor_quantize", KOPS.tensor_quantize(zero)[1],
         REF.tensor_quantize(zero)[1], "all-zero state")

    for R in (DECODE_ROWS, PREFILL_ROWS):
        for dt in (torch.bfloat16, torch.float32):
            for lin in ("wq", "wk", "wo", "w_up"):
                K = wq[lin][0].shape[0]
                x = activations(torch, gen, R, K, dev, dt)
                same("fused_switchback_fwd",
                     KOPS.fused_switchback_fwd(x, *wq[lin]),
                     REF.fused_switchback_fwd(x, *wq[lin]),
                     f"{lin} R={R} {dt}")
            w_q, s_w = wq["w_down"]
            x = activations(torch, gen, R, w_q.shape[0], dev, dt)
            x_q, s_x = KOPS.row_quantize(x)
            rxq, rsx = REF.row_quantize(x)
            same("row_quantize", x_q, rxq, f"R={R} {dt}")
            same("row_quantize", s_x, rsx, f"state R={R} {dt}")
            scale = s_x * REF.div(s_w, 127.0 * 127.0)
            same("int8_matmul_dequant",
                 KOPS.int8_matmul_dequant(x_q, w_q, scale, out_dtype=dt),
                 REF.int8_matmul_dequant(x_q, w_q, scale, out_dtype=dt),
                 f"w_down R={R} {dt}")
    torch.cuda.synchronize()
    return worst, n


def rel_err(torch, got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def plain_flash_fwd(M):
    """The plain version behind the wrapper's signature."""
    def fwd(q, k, v, *, causal, kv_valid=None):
        return M.FREF.mha_fwd(q, k, v, causal=causal,
                              kv_valid=k.shape[1] if kv_valid is None else kv_valid,
                              scale=M.FA.softmax_scale(q.shape[-1]))
    return fwd


def plain_decode(M):
    def dec(q, k, v, kv_len):
        return M.FREF.decode_fwd(q, k, v, kv_len, scale=M.FA.softmax_scale(q.shape[-1]))
    return dec


def kv_heads_by_modulo(k, n_heads):
    """The control fault's K/V: (B, S, KV, hd) -> (B, S, H, hd) with query
    head h reading KV head h % KV instead of h // group (the KV heads
    tiled, 0,1,2,0,1,2, where the model repeats each, 0,0,1,1,2,2)."""
    return k.repeat(1, 1, n_heads // k.shape[2], 1)


def compare_flash(torch, M, cfg, dev, seed):
    """Each flash kernel against its plain version on the card at the
    path's shapes and edges, bf16 and f32, within FLASH_O_TOL /
    FLASH_LSE_TOL; the control fault must read FAULT_MARGIN x outside.
    Returns per kernel the largest |kernel - plain| and relative error,
    the smallest fault/tolerance ratio, and the number of comparisons."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = M.FA.softmax_scale(hd)
    out = {k: dict(max_abs_err=0.0, max_rel_err=0.0, max_lse_err=0.0,
                   fault_over_tol=math.inf) for k in ("flash_fwd", "decode_fwd")}
    n = 0

    def record(name, dt, got, want, fault, what, lse=None):
        nonlocal n
        r = out[name]
        tol = FLASH_O_TOL[str(dt).replace("torch.", "")]
        err = rel_err(torch, got, want)
        r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(torch, got, want))
        r["max_rel_err"] = max(r["max_rel_err"], err)
        check(got.dtype == want.dtype and got.shape == want.shape
              and bool(torch.isfinite(got).all()), f"{name} {what}: bad output")
        check(err <= tol, f"{name} {what}: kernel vs plain {err:g} > {tol:g}")
        if lse is not None:
            e = float((lse[0] - lse[1]).abs().max())
            r["max_lse_err"] = max(r["max_lse_err"], e)
            check(e <= FLASH_LSE_TOL, f"{name} {what}: lse off by {e:g} > {FLASH_LSE_TOL:g}")
        if fault is not None:
            f = rel_err(torch, got, fault) / tol
            r["fault_over_tol"] = min(r["fault_over_tol"], f)
            check(f >= FAULT_MARGIN, f"{name} {what}: the control fault reads only {f:g} x "
                  "the tolerance, which so could barely see it")
        n += 1

    def rand(*shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    for dt in (torch.bfloat16, torch.float32):
        cases = [(8, S, S, S, c) for S in (32, 64, 96, 128) for c in (True, False)]
        cases += [(8, 64, 160, 150, c) for c in (True, False)]
        for B, Sq, Sk, kv_valid, causal in cases:
            q, k, v = rand(B, Sq, H, hd, dt=dt), rand(B, Sk, KV, hd, dt=dt), rand(B, Sk, KV, hd, dt=dt)
            o, lse = M.FA.flash_fwd_lse(q, k, v, causal=causal, kv_valid=kv_valid)
            ro, rlse = M.FREF.mha_fwd(q, k, v, causal=causal, kv_valid=kv_valid, scale=scale)
            fo, _ = M.FREF.mha_fwd(q, kv_heads_by_modulo(k, H),
                                   kv_heads_by_modulo(v, H), causal=causal,
                                   kv_valid=kv_valid, scale=scale)
            record("flash_fwd", dt, o, ro, fo,
                   f"B{B} Sq{Sq} Sk{Sk} kv_valid{kv_valid} causal={causal} {dt}", (lse, rlse))
        for S in (96, 256):
            lens = torch.tensor([1, 2, 127, 128, 129, 200, S, S], dtype=torch.int32,
                                device=dev).clamp(max=S)
            for cache_dt in dict.fromkeys((torch.bfloat16, dt)):
                q = rand(8, 1, H, hd, dt=dt)
                k, v = rand(8, S, KV, hd, dt=cache_dt), rand(8, S, KV, hd, dt=cache_dt)
                o = M.FA.decode_attention(q, k, v, lens)
                ro = M.FREF.decode_fwd(q, k, v, lens, scale=scale)
                fo = M.FREF.decode_fwd(q, kv_heads_by_modulo(k, H),
                                       kv_heads_by_modulo(v, H), lens, scale=scale)
                record("decode_fwd", dt, o, ro, fo,
                       f"S_max{S} lens {lens.tolist()} q {dt} cache {cache_dt}")
    torch.cuda.synchronize()
    return out, n


# ---------------------------------------------------------------------------
# phase 7: timing
# ---------------------------------------------------------------------------

def graph_ms(torch, fn, n_sets, reps=20, stream=None):
    """Device ms per ``fn(i)``: the calls for all ``n_sets`` input sets (more
    bytes than the 50 MB L2, as a decode step finds each layer's weights
    cold) captured once in a CUDA graph and replayed ``reps`` times, so the
    time is the card's and not the host's launch rate. With ``stream`` the
    warm-up and the capture both run on it: an autograd backward launches its
    kernels on the stream its forward ran on, so ``fn`` may be the backward
    of a forward run there."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up outside capture
        for i in range(n_sets):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(n_sets):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * n_sets)


def eager_ms(torch, fn, n_sets, iters=30):
    """ms per ``fn(i)`` called eagerly, as the engine calls it: CUDA events
    around the calls, so the host's launch time counts where it is longer
    than the card's work."""
    for i in range(n_sets):
        fn(i)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i % n_sets)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(bytes_, int8_ops=0.0, f32_ops=0.0, bf16_ops=0.0, fp8_ops=0.0):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the peak of their type."""
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = (int8_ops / INT8_OPS_PER_S + fp8_ops / FP8_OPS_PER_S + bf16_ops / BF16_OPS_PER_S
             + f32_ops / F32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_work(torch, KOPS, REF, sets, work, what):
    """Each entry of ``work`` (name: (calls, call(set, ops module), library
    call or None, bytes, int8 ops, f32 ops)) over ``sets``: the kernels'
    and the plain versions' (none without ``REF``) device ms by CUDA-graph
    replay, the library call's, the kernels' eager ms, and the bound;
    ``what(calls)`` names the work timed."""
    out, n = {}, len(sets)
    for name, (calls, call, library, bytes_, i8, f32) in work.items():
        r = out[name] = dict(
            ms=graph_ms(torch, lambda i: call(sets[i], KOPS), n),
            plain_ms=graph_ms(torch, lambda i: call(sets[i], REF), n) if REF else None,
            library_ms=graph_ms(torch, lambda i: library(sets[i]), n) if library else None,
            eager_ms=eager_ms(torch, lambda i: call(sets[i], KOPS), n),
            bound=bound(bytes_, int8_ops=i8, f32_ops=f32), calls=calls, work=what(calls))
        if name.startswith(("int8_matmul_dequant", "fused_switchback")):
            # the int8 GEMM's rate and the share of the card's least time it reaches
            r["tops"] = i8 / (r["ms"] * 1e-3) / 1e12
            r["bound_share"] = r["bound"][0] / r["ms"]
    return out


def int8_rates(tag, results):
    """One line of each int8 GEMM form's TOPS and bound share (the fused
    pair's with its two-step yardstick beside)."""
    print(f"[timing] int8 forms, {tag}: " + json.dumps(
        {k: {x: r[x] for x in ("ms", "tops", "bound_share", "library_ms", "two_step_ms")
             if x in r} for k, r in results.items() if "tops" in r}))


def two_step(KOPS, REF, x, w_q, s_w, transposed):
    """The fused pair's function by the port's own two-step path (as
    ``core/switchback`` runs it above FUSED_MAX_CONTRACT): row_quantize,
    the scale, then int8_matmul_dequant (or _t)."""
    x_q, s_x = KOPS.row_quantize(x)
    mm = KOPS.int8_matmul_dequant_t if transposed else KOPS.int8_matmul_dequant
    return mm(x_q, w_q, s_x * REF.div(s_w, 127.0 * 127.0), out_dtype=x.dtype)


def add_two_step(torch, KOPS, REF, r, sets, calls, transposed):
    """The yardstick of a fused reading ``r``: the two-step path at the
    same calls (``calls(set)``: [(x, w_q, s_w)]), by graph replay over the
    same sets, first checked bit-equal to the fused kernel on set 0."""
    fused = KOPS.fused_switchback_dgrad if transposed else KOPS.fused_switchback_fwd
    for a in calls(sets[0]):
        check(torch.equal(two_step(KOPS, REF, *a, transposed), fused(*a)),
              "the two-step yardstick disagrees with the fused kernel")
    r["two_step_ms"] = graph_ms(torch, lambda i: [two_step(KOPS, REF, *a, transposed)
                                                  for a in calls(sets[i])], len(sets))
    return r


def fused_calls(linears, fused_max):
    """The fused pair's calls over one layer's ``linears`` [(K, M, needs
    Ẋ)]: the forward's (K, M) where K fits ``fused_max``, the dgrad's (M,
    N = K) where the output width M does."""
    return ([(K, Mw) for K, Mw, _ in linears if K <= fused_max],
            [(Mw, K) for K, Mw, dx in linears if dx and Mw <= fused_max])


def clip_layer(lins):
    """One layer's linears of a ``clip_shapes`` entry, in call order
    (``w_qkvo`` stands for four)."""
    return [km for k, km in lins.items() for _ in range(4 if k == "w_qkvo" else 1)]


def time_fused(torch, M, gen, dev, R, fwd, dgrad, what, plain=True):
    """The fused pair at ``R`` rows over one layer's calls: ``fwd`` the
    forward's (K, M), ``dgrad`` the dgrad's (M, N) (g (R, M) against W (N,
    M)); each beside its plain version (``plain``), the two-step yardstick
    and the bound. Returns {kernel: reading}."""
    KOPS, REF = M.KOPS, M.REF

    def one_set():
        s = {"fwd": [], "dgrad": []}
        for K, Mw in fwd:
            w_q, s_w = KOPS.tensor_quantize(weight(torch, gen, K, Mw, dev))
            s["fwd"].append((activations(torch, gen, R, K, dev), w_q, s_w))
        for Mw, N in dgrad:
            w_q, s_w = KOPS.tensor_quantize(weight(torch, gen, N, Mw, dev))
            s["dgrad"].append((activations(torch, gen, R, Mw, dev), w_q, s_w))
        return s

    if not fwd + dgrad:
        return {}
    per_set = sum(3 * R * a + a * b + 2 * R * b for a, b in fwd + dgrad)
    sets = [one_set() for _ in range(max(2, int(120e6 // per_set) + 1))]
    torch.cuda.synchronize()
    keys = {"fused_switchback_fwd": "fwd", "fused_switchback_dgrad": "dgrad"}
    work = {}
    for name, key in keys.items():
        shapes = fwd if key == "fwd" else dgrad
        if shapes:
            # name: (calls, call(set, ops module), library call, bytes, int8 ops, f32 ops)
            work[name] = (len(shapes),
                          lambda s, m, name=name, key=key: [getattr(m, name)(*a) for a in s[key]],
                          None, sum(R * a * 2 + a * b + 4 + R * b * 2 for a, b in shapes),
                          sum(2 * R * a * b for a, b in shapes), sum(4 * R * a for a, _ in shapes))
    return {name: add_two_step(torch, KOPS, REF, r, sets, lambda s, key=keys[name]: s[key],
                               keys[name] == "dgrad")
            for name, r in time_work(torch, KOPS, REF if plain else None, sets, work,
                                     what).items()}


def time_kernels(torch, KOPS, REF, cfg, dev, seed, R):
    """One layer's calls of each kernel at ``R`` rows (the calls one decode
    step (R=8) or one prefill (R=1024) makes per layer): the kernel, its
    plain version and a library call, with the bound for the same work."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = path_shapes(cfg)
    fused = [k for k in shapes if k != "w_down"]
    D, FF = cfg.d_model, cfg.d_ff
    K, M = shapes["w_down"]
    layer_w = sum(k * m for k, m in shapes.values())
    n_sets = max(2, int(120e6 // (layer_w * 3 + R * (D + FF) * 2)) + 1)
    sets = []
    for _ in range(n_sets):
        ws = {k: weight(torch, gen, *km, dev) for k, km in shapes.items()}
        qs = {k: KOPS.tensor_quantize(w) for k, w in ws.items()}
        xd = activations(torch, gen, R, FF, dev)
        x_q, s_x = KOPS.row_quantize(xd)
        sets.append(dict(ws=ws, qs=qs, x=activations(torch, gen, R, D, dev), xd=xd,
                         x_q=x_q, scale=s_x * REF.div(qs["w_down"][1], 127.0 * 127.0)))
    torch.cuda.synchronize()
    # the library yardstick for int8_matmul_dequant: torch._int_mm
    # (cuBLASLt int8) plus the row scale. It needs more than 16 rows, so
    # below that its input is zero-padded to 32 rows.
    pad = 32 - R if R <= 16 else 0

    def int_mm(s):
        xq = torch.cat([s["x_q"], s["x_q"].new_zeros((pad, K))]) if pad else s["x_q"]
        acc = torch._int_mm(xq, s["qs"]["w_down"][0])[:R]
        return (acc.float() * s["scale"]).to(torch.bfloat16)

    s0 = sets[0]
    check(torch.equal(int_mm(s0), KOPS.int8_matmul_dequant(s0["x_q"], s0["qs"]["w_down"][0],
                                                           s0["scale"])),
          "torch._int_mm yardstick disagrees with int8_matmul_dequant")

    n = layer_w
    work = {
        # name: (calls, call(set, ops module), library call, bytes, int8 ops, f32 ops)
        "tensor_quantize": (
            7, lambda s, op: [op.tensor_quantize(w) for w in s["ws"].values()], None,
            n * 2 + n + 7 * 4, 0, 4 * n),
        "fused_switchback_fwd": (
            len(fused),
            lambda s, op: [op.fused_switchback_fwd(s["x"], *s["qs"][k]) for k in fused], None,
            sum(R * shapes[k][0] * 2 + shapes[k][0] * shapes[k][1] + 4 + R * shapes[k][1] * 2
                for k in fused),
            sum(2 * R * shapes[k][0] * shapes[k][1] for k in fused), 4 * R * D * len(fused)),
        "row_quantize": (
            1, lambda s, op: op.row_quantize(s["xd"]), None,
            R * FF * 2 + R * FF + R * 4, 0, 4 * R * FF),
        "int8_matmul_dequant": (
            1, lambda s, op: op.int8_matmul_dequant(s["x_q"], s["qs"]["w_down"][0], s["scale"]),
            int_mm, R * K + K * M + R * 4 + R * M * 2, 2 * R * K * M, 0),
    }
    out = time_work(torch, KOPS, REF, sets, work, lambda c: f"one layer's {c} call(s) at {R} rows")
    for name, r in out.items():
        if r["library_ms"] is not None:
            r["library_rows"] = R + pad
    add_two_step(torch, KOPS, REF, out["fused_switchback_fwd"], sets,
                 lambda s: [(s["x"], *s["qs"][k]) for k in fused], False)
    return out


def time_flash(torch, M, cfg, dev, seed, served_lens):
    """Each flash kernel at the path's shapes: flash_fwd at one prefill
    call's shape (8 slots x 128, causal), decode_fwd at one decode step's
    (8 slots, S_max 256) with every slot at S_max and at ``served_lens``.
    Per case: the kernel, its plain version, its eager time, the library
    call (SDPA with GQA, a boolean key mask for decode) and the bound:
    bytes (each input read once, each output written once; for decode the
    live cache cells only) against the matmul operations of the live
    (query, key) pairs at the bf16 tensor-core peak."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bf = torch.bfloat16
    B, S = 8, 128

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def sets_for(per_set_bytes, make):
        return [make() for _ in range(max(2, int(120e6 // per_set_bytes) + 1))]

    def sdpa_fwd(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True,
                                              enable_gqa=True).transpose(1, 2)

    def timed(fn, plain, library, sets, bytes_, flops, work):
        n = len(sets)
        return dict(ms=graph_ms(torch, lambda i: fn(*sets[i]), n),
                    plain_ms=graph_ms(torch, lambda i: plain(*sets[i]), n),
                    library_ms=graph_ms(torch, lambda i: library(*sets[i]), n),
                    eager_ms=eager_ms(torch, lambda i: fn(*sets[i]), n),
                    bound=bound(bytes_, bf16_ops=flops), work=work, calls=1)

    out = {}
    qkv_bytes = (B * S * H * hd + 2 * B * S * KV * hd) * 2
    pf_sets = sets_for(qkv_bytes, lambda: (rand(B, S, H, hd), rand(B, S, KV, hd),
                                           rand(B, S, KV, hd)))
    o = M.FA.flash_fwd_lse(*pf_sets[0], causal=True)[0]
    sdpa_err = rel_err(torch, sdpa_fwd(*pf_sets[0]), o)
    check(sdpa_err <= 2e-2, f"SDPA yardstick disagrees with flash_fwd ({sdpa_err:g})")
    pairs = B * H * S * (S + 1) // 2                      # causal live pairs
    plain_fwd = plain_flash_fwd(M)
    out["flash_fwd"] = timed(
        lambda q, k, v: M.FA.flash_fwd_lse(q, k, v, causal=True),
        lambda q, k, v: plain_fwd(q, k, v, causal=True), sdpa_fwd, pf_sets,
        qkv_bytes + B * S * H * hd * 2 + B * H * S * 4, 4.0 * pairs * hd,
        f"one prefill call per layer: {B} slots x {S} tokens, causal, bf16")
    out["flash_fwd"]["sdpa_rel_err"] = sdpa_err

    S_max = 256
    for tag, lens in (("full", [S_max] * B), ("served", served_lens)):
        out[f"decode_fwd_{tag}"] = time_decode(torch, M, gen, dev, S_max, H, KV, hd, lens)
    return out


def time_decode(torch, M, gen, dev, S_max, H, KV, hd, lens):
    """``decode_fwd`` at one decode step's call per layer: len(lens) slots
    of a bf16 cache of ``S_max`` cells at lengths ``lens``, bf16 q. The
    kernel, its plain version, its eager time, SDPA with GQA and a boolean
    key mask, and the bound: bytes (q and o once, the live cache cells
    only) against the live pairs' matmul operations at the bf16 peak."""
    import torch.nn.functional as F
    bf, B = torch.bfloat16, len(lens)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def sdpa_decode(q, k, v, mask):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask,
                                              enable_gqa=True).transpose(1, 2)

    plain_dec = plain_decode(M)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(S_max, device=dev)[None, :] < lens_t[:, None])[:, None, None, :]
    sets = [(rand(B, 1, H, hd), rand(B, S_max, KV, hd), rand(B, S_max, KV, hd))
            for _ in range(max(2, int(120e6 // (2 * B * S_max * KV * hd * 2)) + 1))]
    live, n = sum(lens), len(sets)
    r = dict(ms=graph_ms(torch, lambda i: M.FA.decode_attention(*sets[i], lens_t), n),
             plain_ms=graph_ms(torch, lambda i: plain_dec(*sets[i], lens_t), n),
             library_ms=graph_ms(torch, lambda i: sdpa_decode(*sets[i], mask), n),
             eager_ms=eager_ms(torch, lambda i: M.FA.decode_attention(*sets[i], lens_t), n),
             bound=bound(2 * B * H * hd * 2 + live * KV * hd * 2 * 2 + B * 4,
                         bf16_ops=4.0 * live * H * hd),
             work=f"one decode step per layer: {B} slots, S_max {S_max}, ({H}/{KV}, {hd}), "
                  f"lengths {lens}", calls=1)
    r["sdpa_rel_err"] = rel_err(torch, sdpa_decode(*sets[0], mask),
                                M.FA.decode_attention(*sets[0], lens_t))
    check(r["sdpa_rel_err"] <= 2e-2,
          f"SDPA yardstick disagrees with decode_fwd ({r['sdpa_rel_err']:g})")
    return r


# ---------------------------------------------------------------------------
# phases 4-6: the serve path
# ---------------------------------------------------------------------------

# whole model under flash_scan, kernels against plain and card against CPU:
# (max, mean) |difference| relative to max|logit|. The online softmax sums
# in another order than the plain version's one full softmax; the int8
# quantizers amplify such last-bit differences (an activation on the other
# side of a rounding boundary moves its row's product by one quantization
# step), most in f32. The control fault (KV heads tiled) must land outside.
FLASH_MODEL_TOL = {"float32": (5e-2, 5e-3), "bfloat16": (2e-2, 1e-3)}
# the same for the served engine at full depth (32 layers, bf16), which
# carries such a difference through 16x more quantized linears: two exact
# plain formulations of the same attention (flash's and dense's) already
# read about 3e-2 / 2e-3 apart there (phase 5 prints this yardstick)
SERVED_FLASH_TOL = (1e-1, 1.5e-2)


def launch_counts(M) -> dict:
    return {**M.KOPS.launch_counts(), **M.FA.launch_counts(), **M.F8.launch_counts(),
            **M.PA.launch_counts(), **M.FC.launch_counts()}


def reset_launch_counts(M):
    for family in (M.KOPS, M.FA, M.F8, M.PA, M.FC):
        family.reset_launch_counts()


def expected_launches(cfg, prefill_calls: int, decode_steps: int, impl: str) -> dict:
    """Each wrapper's launches for so many model calls of the engine."""
    want = {k: per * cfg.n_layers * (prefill_calls + decode_steps)
            for k, per in PER_LAYER.items()}
    for k, per in FLASH_PER_LAYER.items():
        want[k] = 0 if impl == "dense" else cfg.n_layers * (
            per["prefill"] * prefill_calls + per["decode"] * decode_steps)
    want.update(paged_decode_fwd=0, paged_prefill_fwd=0)      # the ring cache's path
    want.update(dict.fromkeys(OP_KERNELS, 0))
    return want


def serve(torch, M, cfg, dev, seed):
    import numpy as np

    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve import make_serve_engine

    scfg = ServeConfig(max_batch=8, max_len=256, quant_mode="int8_switchback")
    t = time.perf_counter()
    eng = make_serve_engine("smollm-360m", scfg, device=dev)   # the engine's defaults
    check(eng.parallel.attn_impl == "flash_scan",
          f"the engine's default attn_impl is {eng.parallel.attn_impl!r}")
    params = eng.init_params(seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"[serve] engine ({eng.parallel.attn_impl}) + {n_params / 1e6:.1f} M params "
          f"on {dev} in {time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(seed)
    lens = rng.integers(32, 97, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    eng.generate(params, prompts, max_new_tokens=2)              # warm-up

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(M)
    gens, stats = eng.generate(params, prompts, max_new_tokens=32)
    counts = launch_counts(M)

    check(len(gens) == len(prompts) and all(len(g) == 32 for g in gens),
          f"not every request got 32 tokens: {[len(g) for g in gens]}")
    check(all(0 <= t < cfg.vocab_size for g in gens for t in g),
          "a token outside the vocabulary")
    want = expected_launches(cfg, stats["prefill_calls"], stats["decode_steps"],
                             eng.parallel.attn_impl)
    for k, n in want.items():
        check(counts[k] > 0 or n == 0, f"{k} never launched on the serve path")
        check(counts[k] == n,
              f"{k}: {counts[k]} launches, expected {n} for {cfg.n_layers} layers x "
              f"({stats['prefill_calls']} prefill calls, {stats['decode_steps']} decode steps)")
    print(f"[serve] {stats['new_tokens']} new tokens ({stats['prefill_tokens']} "
          f"prefilled) in {stats['wall_s']:.3f} s: {stats['tokens_per_s']:.1f} tok/s, "
          f"decode {stats['decode_tokens_per_s']:.1f} tok/s; "
          f"{stats['decode_steps']} decode steps, {stats['prefill_calls']} prefill calls; "
          f"ttft p50 {stats['ttft_p50_s'] * 1e3:.1f} ms p95 {stats['ttft_p95_s'] * 1e3:.1f} ms; "
          f"itl p50 {stats['itl_p50_s'] * 1e3:.2f} ms p95 {stats['itl_p95_s'] * 1e3:.2f} ms; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("[serve] launches:", json.dumps(counts))
    print("[serve] stats:", json.dumps(stats))
    print("[serve] sample:", gens[0][:12])
    return eng, params, prompts, stats, counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@contextlib.contextmanager
def swapped(patches):
    """Set ``(module, name, value)`` attributes for the block, then restore."""
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, value in patches:
        setattr(m, name, value)
    try:
        yield
    finally:
        for m, name, value in saved:
            setattr(m, name, value)


def plain_flash_bwd(M, which):
    """The plain backward behind the wrapper's signature."""
    fn = getattr(M.FREF, which)

    def bwd(q, k, v, do, lse, di, *, causal, kv_valid=None):
        return fn(q, k, v, do, lse, di, causal=causal,
                  kv_valid=k.shape[1] if kv_valid is None else kv_valid,
                  scale=M.FA.softmax_scale(q.shape[-1]))
    return bwd


def plain_ops(M, flash: bool):
    """Send the model's kernel calls to their plain versions, for the
    whole-model kernels-vs-plain checks only (the package has no such
    switch: its wrappers launch the kernel on a CUDA tensor or raise): the
    SwitchBack and fp8 kernels, and with ``flash`` the four flash kernels
    and the two paged kernels."""
    patches = [(M.KOPS, name, getattr(M.REF, name)) for name in SB_KERNELS]
    patches += [(M.F8, name, fn) for name, fn in plain_fp8(M).items()]
    if flash:
        patches += [(M.FA, "flash_fwd_lse", plain_flash_fwd(M)),
                    (M.FA, "decode_attention", plain_decode(M)),
                    (M.FA, "flash_bwd_dq", plain_flash_bwd(M, "flash_bwd_dq")),
                    (M.FA, "flash_bwd_dkv", plain_flash_bwd(M, "flash_bwd_dkv"))]
        patches += [(M.PA, name, fn) for name, fn in plain_paged(M).items()]
    return swapped(patches)


def tiled_kv_heads(M):
    """The control fault in the model, a one-word wiring slip: GQA
    expansion by ``kv_heads_by_modulo`` in the dense path and in the flash
    kernels' plain versions."""
    from repro_torch.models import attention as A
    return swapped([(A, "_expand_kv", kv_heads_by_modulo),
                    (M.FREF, "_expand_heads", kv_heads_by_modulo)])


def run_logits(eng, params, toks, lens, fed=None):
    """Prefill plus three decode steps. The decode inputs are ``fed``, or
    this run's own greedy tokens when it is None. Returns the last-position
    logits of each call and the tokens the run fed itself."""
    import numpy as np
    cache = eng.init_cache()
    lg, cache = eng.prefill(params, cache, toks, lens, np.ones((len(lens),), bool))
    steps, own = [lg[:, 0]], []
    for i in range(3):
        own.append(lg[:, 0].argmax(-1).cpu().numpy()[:, None])
        lg, cache = eng.decode(params, cache, own[i] if fed is None else fed[i])
        steps.append(lg[:, 0])
    return steps, own


def rel_errs(got, want):
    """(max, mean) |got - want| relative to max|want|, worst over calls."""
    return (max(float((a.float().cpu() - b.float().cpu()).abs().max()
                      / b.float().cpu().abs().max()) for a, b in zip(got, want)),
            max(float((a.float().cpu() - b.float().cpu()).abs().mean()
                      / b.float().cpu().abs().max()) for a, b in zip(got, want)))


def prompt_batch(prompts, B, S):
    import numpy as np
    toks = np.zeros((B, S), np.int64)
    lens = np.zeros((B,), np.int32)
    for b in range(B):
        p = prompts[b][:S]
        toks[b, :len(p)] = p
        lens[b] = len(p)
    return toks, lens


def whole_model(torch, M, engines, params, prompts):
    """The served engine (full depth, bf16 compute) with the kernels and
    with the plain versions swapped in: under dense attention the logits
    are bit-equal at every call, under flash_scan within
    SERVED_FLASH_TOL. Beside it, the plain flash path against the dense
    path (both exact plain arithmetic, the softmax taken in another
    order): how far the served model carries a last-bit difference in
    attention, the yardstick the flash tolerance is read against."""
    res, plain = {}, {}
    eng = engines["flash_scan"]
    toks, lens = prompt_batch(prompts, eng.serve_cfg.max_batch, 128)
    _, fed = run_logits(engines["dense"], params, toks, lens)      # fed to every run
    for impl, e in engines.items():
        kern, _ = run_logits(e, params, toks, lens, fed)
        with plain_ops(M, flash=impl != "dense"):
            plain[impl], _ = run_logits(e, params, toks, lens, fed)
        check(all(bool(torch.isfinite(a).all()) for a in kern), f"{impl}: non-finite logits")
        rel, mean = rel_errs(kern, plain[impl])
        res[impl] = dict(bitwise=all(torch.equal(a, b) for a, b in zip(kern, plain[impl])),
                         max_rel_err=rel, mean_rel_err=mean,
                         per_call=[rel_errs([a], [b]) for a, b in zip(kern, plain[impl])],
                         argmax_agree=float(sum(float((a.argmax(-1) == b.argmax(-1)).float().mean())
                                                for a, b in zip(kern, plain[impl])) / len(kern)))
        if impl == "dense":
            check(res[impl]["bitwise"], f"served model, dense: kernel logits != plain logits "
                  f"(max |diff| per call {[max_abs_diff(torch, a, b) for a, b in zip(kern, plain[impl])]})")
        else:
            res[impl]["tolerance"] = SERVED_FLASH_TOL
            check(rel <= SERVED_FLASH_TOL[0] and mean <= SERVED_FLASH_TOL[1],
                  f"served model, {impl}: kernel vs plain logits {rel:g}/{mean:g} > "
                  f"{SERVED_FLASH_TOL[0]:g}/{SERVED_FLASH_TOL[1]:g}")
    res["plain_flash_vs_plain_dense"] = dict(zip(("max_rel_err", "mean_rel_err"),
                                                 rel_errs(plain["flash_scan"], plain["dense"])))
    print(f"[whole model] prefill + 3 decode steps, {len(lens)} slots, "
          f"{eng.cfg.n_layers} layers, kernels vs plain: " + json.dumps(res))
    return res


def reference(torch, M, cfg, dev, seed):
    """Full width, two layers, prefill + 3 decode steps on the same weights
    and tokens, under dense and flash_scan: card kernels against card plain
    (bit-equal under dense, within FLASH_MODEL_TOL under flash_scan), card
    against the CPU's plain path (within tolerance), and a control fault on
    the CPU against the CPU (outside the tolerance)."""
    import numpy as np

    from repro_torch.configs.base import ParallelConfig, ServeConfig
    from repro_torch.core.precision import QuantPolicy
    from repro_torch.models import build
    from repro_torch.models import params as PRM
    from repro_torch.serve import make_serve_engine

    small = build(dataclasses.replace(cfg, n_layers=2))
    params_cpu = PRM.init_params(small.param_specs, seed, device="cpu")
    params_dev = PRM.tree_map(lambda t: t.to(dev), params_cpu)
    rng = np.random.default_rng(seed + 1)
    B, S = 4, 64
    toks = rng.integers(0, cfg.vocab_size, size=(B, S))
    lens = np.array([64, 40, 17, 33], np.int32)
    # Tolerances (max, mean), relative to max|logit|, card against CPU.
    # Card and CPU differ in the order of sums in the attention and head
    # products and in libm ulps; the int8 quantizers amplify such last-bit
    # differences in f32, where an activation on the other side of a
    # rounding boundary moves its row's product by one quantization step.
    # bf16 absorbs most of them. The control fault (KV heads tiled) must
    # land outside both bounds.
    tolerances = {"dense": {torch.float32: (5e-2, 5e-3), torch.bfloat16: (2e-2, 1e-4)},
                  "flash_scan": {torch.float32: FLASH_MODEL_TOL["float32"],
                                 torch.bfloat16: FLASH_MODEL_TOL["bfloat16"]}}

    res = {}
    for impl, by_dtype in tolerances.items():
        for cd, tol in by_dtype.items():
            name = f"{impl}_{str(cd).replace('torch.', '')}"

            def engine(where):
                return make_serve_engine(
                    small, ServeConfig(max_batch=B, max_len=128, quant_mode="int8_switchback"),
                    parallel=ParallelConfig(remat="none", attn_impl=impl),
                    policy=QuantPolicy("int8_switchback", compute_dtype=cd), device=where)

            cpu_eng, dev_eng = engine("cpu"), engine(dev)
            cpu, fed = run_logits(cpu_eng, params_cpu, toks, lens)   # fed to every run
            with tiled_kv_heads(M):
                fault, _ = run_logits(cpu_eng, params_cpu, toks, lens, fed)
            card, _ = run_logits(dev_eng, params_dev, toks, lens, fed)
            with plain_ops(M, flash=impl != "dense"):
                card_plain, _ = run_logits(dev_eng, params_dev, toks, lens, fed)
            bitwise = all(torch.equal(a, b) for a, b in zip(card, card_plain))
            k_rel, k_mean = rel_errs(card, card_plain)
            rel, mean = rel_errs(card, cpu)
            f_rel, f_mean = rel_errs(fault, cpu)
            agree = float(np.mean([float((a.cpu().argmax(-1) == b.argmax(-1)).float().mean())
                                   for a, b in zip(card, cpu)]))
            res[name] = dict(card_kernels_eq_card_plain=bitwise,
                             card_kernels_vs_plain_max_rel_err=k_rel,
                             card_kernels_vs_plain_mean_rel_err=k_mean,
                             max_rel_err=rel, mean_rel_err=mean, tolerance=tol,
                             argmax_agree=agree, control_fault_max_rel_err=f_rel,
                             control_fault_mean_rel_err=f_mean)
            check(all(bool(torch.isfinite(a).all()) and tuple(a.shape) == (B, cfg.vocab_size)
                      for a in card), f"reference {name}: non-finite or misshapen logits")
            if impl == "dense":
                check(bitwise, f"reference {name}: card kernel logits != card plain logits")
            else:
                check(k_rel <= tol[0] and k_mean <= tol[1],
                      f"reference {name}: card kernels vs card plain {k_rel:g}/{k_mean:g} "
                      f"> {tol[0]:g}/{tol[1]:g}")
            check(rel <= tol[0] and mean <= tol[1],
                  f"reference {name}: card vs CPU max/mean rel err {rel:g}/{mean:g} "
                  f"> {tol[0]:g}/{tol[1]:g}")
            check(f_rel > tol[0] and f_mean > tol[1],
                  f"reference {name}: the control fault ({f_rel:g}/{f_mean:g}) lies within "
                  f"the tolerance {tol[0]:g}/{tol[1]:g}, which so could not see it")
    print("[reference]", json.dumps(res))
    return res


# the decode step's kernel families, by name (before PyTorch's "gemm": both
# int8 GEMM kernels take an ``I8Gemm``)
KERNEL_GROUPS = ("row_quantize", "tensor_quantize", "fused_switchback_kernel",
                 "int8_matmul_kernel", "flash_fwd", "decode_fwd")
# the tensor quantizers, whose one-launch form runs one CUDA kernel a
# wrapper call on every path weight (each exactly, in phases 13 and 19:
# ``tq_kernels_a_call``). A step's profile (phases 7, 12, 15, 20) loses
# about 1% of its kernel records (on an H100: 222 of 224 tensor_quantize a
# decode step, 190.2 of 192 fused_switchback_kernel; PERF.md), so there
# each one's group (named as its wrapper's count) must launch no more
# kernels a step than its wrapper counted calls: the two-launch form would
# read twice as many
ONE_KERNEL_A_CALL = ("tensor_quantize", "fp8_tensor_quantize")


def check_one_kernel_a_call(prof, per_step, what):
    """Each ONE_KERNEL_A_CALL group of a profile (device time by kernel
    family) launched no more CUDA kernels a step than its wrapper counted
    calls, where the profile read device time."""
    if not prof["device_ms_per_step"]:
        return
    for name in ONE_KERNEL_A_CALL:
        calls = per_step.get(name, 0)
        got = prof["groups"].get(name, {}).get("launches", 0)
        check(got <= calls, f"{what}: {name}: {got} CUDA kernels a step for {calls} wrapper "
              "calls (the one-launch form runs one a call)")


def kernel_times(torch, fn, n):
    """{CUDA kernel: (device ms, launches) per step} of one ``fn()`` that
    runs ``n`` steps, from torch.profiler recording the card's activity
    only (the host's operator events cost seconds to record and are not
    read)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us and getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type):
            by_kernel[e.key] = (us / n / 1e3, e.count / n)
    return by_kernel


def decode_profile(torch, M, cfg, eng, params, prompts):
    """Wall time and wrapper launches of one full-batch decode step over 10
    steps, and the device time and CUDA launches by kernel over 5
    (torch.profiler). Also returns the batch's cache lengths at the end."""
    import numpy as np

    impl = eng.parallel.attn_impl
    B = eng.serve_cfg.max_batch
    cache = eng.init_cache()
    toks, lens = prompt_batch(prompts, B, 128)
    lg, cache = eng.prefill(params, cache, toks, lens, np.ones((B,), bool))
    cur = lg[:, 0].argmax(-1).cpu().numpy()[:, None]
    for _ in range(3):
        lg, cache = eng.decode(params, cache, cur)
    torch.cuda.synchronize()
    n = 10
    reset_launch_counts(M)
    t = time.perf_counter()
    for _ in range(n):
        lg, cache = eng.decode(params, cache, cur)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / n * 1e3
    per_step = {k: v / n for k, v in launch_counts(M).items()}
    for k, want in expected_launches(cfg, 0, 1, impl).items():
        check(per_step[k] == want,
              f"{impl}: {k}: {per_step[k]} launches per decode step, expected {want}")

    box = [cache]

    def steps(n=5):
        for _ in range(n):
            box[0] = eng.decode(params, box[0], cur)[1]

    by_kernel = kernel_times(torch, steps, 5)
    cache = box[0]
    dev_ms = sum(v[0] for v in by_kernel.values())
    groups = {}
    for key, (ms, cnt) in by_kernel.items():
        g = next((k for k in KERNEL_GROUPS if k in key), None)
        g = g or ("gemm" if "gemm" in key.lower() or "sm90" in key.lower() else "other")
        a = groups.setdefault(g, [0.0, 0])
        a[0] += ms
        a[1] += cnt
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    prof_out = dict(
        attn_impl=impl, step_ms=step_ms, launches_per_step=per_step,
        device_ms_per_step=dev_ms,
        cuda_launches_per_step=sum(v[1] for v in by_kernel.values()),
        device_idle_share=(max(0.0, 1 - dev_ms / step_ms) if dev_ms else None),
        groups={g: {"ms": v[0], "launches": v[1]} for g, v in
                sorted(groups.items(), key=lambda kv: -kv[1][0])},
        top=[{"kernel": k[:90], "ms": v[0], "launches": v[1]} for k, v in top])
    if not dev_ms:
        print(f"[profile] {impl}: torch.profiler saw no device time; step wall time only")
    print("[profile]", json.dumps(prof_out))
    check_one_kernel_a_call(prof_out, per_step, f"decode profile {impl}")
    lengths = next(iter(cache.values())).length[0].tolist()
    return prof_out, lengths


# ---------------------------------------------------------------------------
# phases 3b and 13: a training path's SwitchBack kernels against their plain
# versions, at that path's shapes
# ---------------------------------------------------------------------------

COLSCALE_KERNELS = ("int8_matmul_dequant_colscale", "int8_matmul_dequant_colscale_t")


def smollm_train_shapes(cfg):
    """Phase 3b's table: one layer's seven linears ``{name: (K, M, needs
    Ẋ)}`` at 2,048 rows and the ragged 8 and 1,000, bf16 and f32, exact
    half-way ties in the weights at 8 rows; tensor-wise modes only."""
    lin = {k: (K, Mw, True) for k, (K, Mw) in path_shapes(cfg).items()}
    dts = ("bfloat16", "float32")
    return [("smollm", R, dts, R == 8, False, lin) for R in (TRAIN_ROWS, 8, 1000)]


def compare_linear_kernels(torch, M, table, dev, seed):
    """Every SwitchBack kernel a training path runs, bit-equal to its plain
    version at the path's shapes. ``table``: (tower, rows, dtypes, ties in
    the weights, column-wise modes too, ``{linear: (K, M, needs Ẋ)}``).
    Per linear: ``tensor_quantize(W)``; per dtype the forward both ways the
    modes take it (fused when K <= FUSED_MAX_CONTRACT, and ``row_quantize``
    + ``int8_matmul_dequant`` at every K, as ``int8_switchback_m`` does)
    and the dgrad (fused when M <= FUSED_MAX_CONTRACT, else
    ``row_quantize`` + ``int8_matmul_dequant_t``); column-wise also
    ``col_quantize(W)``, ``row_quantize(W)``, the colscale forward and the
    transposed colscale dgrad. Inputs hold exact half-way ties and an
    all-zero row. Each kernel run twice on the same inputs must give the
    same bits. Returns the largest |kernel - plain| per kernel and the
    number of comparisons."""
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = dict.fromkeys(SB_KERNELS + COLSCALE_KERNELS, 0.0)
    n = 0
    fused_max = KOPS.FUSED_MAX_CONTRACT

    def same(name, fn, ref, what):
        nonlocal n
        got, again = fn(), fn()
        d = max_abs_diff(torch, got, ref)
        worst[name] = max(worst[name], d)
        check(got.dtype == ref.dtype and got.shape == ref.shape and torch.equal(got, ref),
              f"{name} {what}: kernel != plain (max |diff| {d:g})")
        check(torch.equal(got, again), f"{name} {what}: two launches differ")
        n += 1

    def quantized(name, t, what):
        """The kernel's (int8, scale) of ``t``, each bit-equal to plain."""
        fn = getattr(KOPS, name)
        ref = getattr(REF, name)(t)
        for i in (0, 1):
            same(name, lambda: fn(t)[i], ref[i], f"{what} {'state' if i else 'int8'}")
        return fn(t)

    for tower, R, dts, ties, colwise, linears in table:
        for lin, (K, Mw, dx) in linears.items():
            what = f"{tower} {lin} {K}x{Mw}"
            w = weight(torch, gen, K, Mw, dev, ties)
            w_q, s_w = quantized("tensor_quantize", w, what)
            if colwise:
                c_q, c_s = quantized("col_quantize", w, what)
                w_n, s_n = quantized("row_quantize", w, f"{what} W per input unit")
            for dt in (getattr(torch, d) for d in dts):
                at = f"{what} R={R} {dt}"
                x = activations(torch, gen, R, K, dev, dt)
                if K <= fused_max:
                    same("fused_switchback_fwd", lambda: KOPS.fused_switchback_fwd(x, w_q, s_w),
                         REF.fused_switchback_fwd(x, w_q, s_w), at)
                x_q, s_x = quantized("row_quantize", x, f"{at} X")
                scale = s_x * REF.div(s_w, 127.0 * 127.0)
                same("int8_matmul_dequant",
                     lambda: KOPS.int8_matmul_dequant(x_q, w_q, scale, out_dtype=dt),
                     REF.int8_matmul_dequant(x_q, w_q, scale, out_dtype=dt), at)
                if colwise:
                    row = REF.div(s_x, 127.0 * 127.0)
                    same("int8_matmul_dequant_colscale",
                         lambda: KOPS.int8_matmul_dequant(x_q, c_q, row, col_scale=c_s,
                                                          out_dtype=dt),
                         REF.int8_matmul_dequant(x_q, c_q, row, col_scale=c_s, out_dtype=dt), at)
                if not dx:                        # the patch embedding: data input
                    continue
                g = activations(torch, gen, R, Mw, dev, dt)
                if Mw <= fused_max:
                    same("fused_switchback_dgrad",
                         lambda: KOPS.fused_switchback_dgrad(g, w_q, s_w),
                         REF.fused_switchback_dgrad(g, w_q, s_w), f"{at} dgrad")
                g_q, s_g = quantized("row_quantize", g, f"{at} Ẏ")
                if Mw > fused_max:
                    scale = s_g * REF.div(s_w, 127.0 * 127.0)
                    same("int8_matmul_dequant_t",
                         lambda: KOPS.int8_matmul_dequant_t(g_q, w_q, scale, out_dtype=dt),
                         REF.int8_matmul_dequant_t(g_q, w_q, scale, out_dtype=dt),
                         f"{at} dgrad")
                if colwise:
                    row, col = REF.div(s_g, 127.0 * 127.0), s_n.reshape(1, -1)
                    same("int8_matmul_dequant_colscale_t",
                         lambda: KOPS.int8_matmul_dequant_t(g_q, w_n, row, col_scale=col,
                                                            out_dtype=dt),
                         REF.int8_matmul_dequant_t(g_q, w_n, row, col_scale=col, out_dtype=dt),
                         f"{at} dgrad")
    torch.cuda.synchronize()
    return worst, n


# phase 13's edges of int8_matmul_dequant's wgmma paths: (rows, K, M) with
# rows 1, 8 (the swapped decode form), 17 and 1,000 (the first row tile and
# a ragged one) against K = 588 (the masked producer), M = 320 (a ragged
# 128-wide tile) and smollm's w_down; and the widest s32 sums
INT8_EDGE_ROWS = (1, 8, 17, 1000)
INT8_EDGE_KM = ((588, 1280), (960, 320), (2560, 960))
INT8_WIDE = ((8, 5120, 1280), (300, 5120, 1280))
# and the fused pair's: rows 1, 15, 16 (the one-launch form, x quantized in
# the block) and 17, 1,000 (the quantize pass, then the GEMM) against K =
# 588 (the masked producer), the widest fused contraction (2,048), a ragged
# 130 -> 70 and smollm's 960 -> 320; each also on all-zero rows
FUSED_EDGE_ROWS = (1, 15, 16, 17, 1000)
FUSED_EDGE_KM = ((588, 1280), (2048, 960), (130, 70), (960, 320))


def int8_forms(KOPS, REF, x_q, s_x, w, dt):
    """The four forms of int8_matmul_dequant on x_q (B, K) and the weight w
    (K, M), as (counter key, call(ops module)): the row-scale forward on W
    tensor-quantized, the colscale forward on W column-quantized, and the
    transposed (dgrad) forms on W^T (M, K) tensor- and row-quantized (the
    column scale its row state)."""
    wt = w.t().contiguous()
    w_q, s_w = KOPS.tensor_quantize(w)
    w_c, s_c = KOPS.col_quantize(w)
    w_t, s_t = KOPS.tensor_quantize(wt)
    w_n, s_n = KOPS.row_quantize(wt)
    row, row_t = s_x * REF.div(s_w, 127.0 * 127.0), s_x * REF.div(s_t, 127.0 * 127.0)
    unit, col = REF.div(s_x, 127.0 * 127.0), s_n.reshape(1, -1)
    return [
        ("int8_matmul_dequant", lambda op: op.int8_matmul_dequant(x_q, w_q, row, out_dtype=dt)),
        ("int8_matmul_dequant_colscale",
         lambda op: op.int8_matmul_dequant(x_q, w_c, unit, col_scale=s_c, out_dtype=dt)),
        ("int8_matmul_dequant_t",
         lambda op: op.int8_matmul_dequant_t(x_q, w_t, row_t, out_dtype=dt)),
        ("int8_matmul_dequant_colscale_t",
         lambda op: op.int8_matmul_dequant_t(x_q, w_n, unit, col_scale=col, out_dtype=dt))]


def compare_int8_edges(torch, M, dev, seed):
    """Phase 13's edges: the four int8_matmul_dequant forms bit-equal to
    their plain versions, twice the same bits, at INT8_EDGE_ROWS x
    INT8_EDGE_KM in bf16 and f32, and on all-±127 operands at K = 5,120
    (a row and a column of +127 meet there: the s32 sum 127^2 * 5,120);
    the fused forward and dgrad the same way at FUSED_EDGE_ROWS x
    FUSED_EDGE_KM, on random rows (ties and a zero row among them) and on
    all-zero ones. Returns the largest |kernel - plain| per form and the
    number of comparisons."""
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = dict.fromkeys(("int8_matmul_dequant",) + COLSCALE_KERNELS[:1]
                          + ("int8_matmul_dequant_t",) + COLSCALE_KERNELS[1:]
                          + ("fused_switchback_fwd", "fused_switchback_dgrad"), 0.0)
    n = 0

    def hold(forms, what):
        nonlocal n
        for name, call in forms:
            got, again, want = call(KOPS), call(KOPS), call(REF)
            d = max_abs_diff(torch, got, want)
            worst[name] = max(worst[name], d)
            check(got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want),
                  f"{name} {what}: kernel != plain (max |diff| {d:g})")
            check(torch.equal(got, again), f"{name} {what}: two launches differ")
            n += 1

    for R in FUSED_EDGE_ROWS:
        for K, Mw in FUSED_EDGE_KM:
            w_q, s_w = KOPS.tensor_quantize(weight(torch, gen, K, Mw, dev, ties=True))
            for dt in (torch.bfloat16, torch.float32):
                for zero in (False, True):
                    x = activations(torch, gen, R, K, dev, dt)
                    g = activations(torch, gen, R, Mw, dev, dt)
                    if zero:
                        x, g = torch.zeros_like(x), torch.zeros_like(g)
                    hold([("fused_switchback_fwd",
                           lambda op: op.fused_switchback_fwd(x, w_q, s_w)),
                          ("fused_switchback_dgrad",
                           lambda op: op.fused_switchback_dgrad(g, w_q, s_w))],
                         f"R={R} K={K} M={Mw} {dt} zero={zero}")

    for R in INT8_EDGE_ROWS:
        for K, Mw in INT8_EDGE_KM:
            w = weight(torch, gen, K, Mw, dev, ties=True)
            x_q, s_x = KOPS.row_quantize(activations(torch, gen, R, K, dev))
            for dt in (torch.bfloat16, torch.float32):
                hold(int8_forms(KOPS, REF, x_q, s_x, w, dt), f"R={R} K={K} M={Mw} {dt}")
    for R, K, Mw in INT8_WIDE:
        x_q = (torch.randint(0, 2, (R, K), generator=gen, device=dev, dtype=torch.int8) * 2 - 1) * 127
        x_q[0] = 127
        s_x = torch.rand((R, 1), generator=gen, device=dev) + 0.5
        w = (torch.randint(0, 2, (K, Mw), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
        w[:, 0] = 1.0
        hold(int8_forms(KOPS, REF, x_q, s_x, w, torch.float32), f"all ±127 R={R} K={K} M={Mw}")
        acc = KOPS.int8_matmul_dequant(x_q, KOPS.tensor_quantize(w)[0],
                                       torch.ones((R, 1), device=dev), out_dtype=torch.float32)
        check(float(acc[0, 0]) == 127.0 * 127.0 * K,
              f"int8_matmul_dequant all ±127 R={R}: the widest sum reads {float(acc[0, 0])}")
    torch.cuda.synchronize()
    return worst, n


# phase 13's edges of the int8 row and column quantizers (bf16 and f32):
# row_quantize at rows 1, 17, 1,000 and CLIP's 4,128 x K = 1 and 7, the
# patch embedding's 588 (the 4-value granules), smollm's 960, CLIP's 1,280,
# a warp's last 2,048 and the first past it, the two-, four- and eight-warp
# groups' 4,096, 5,120 and 8,192, and the first K past the register path
# (16,385: the wide path); col_quantize at R = 1, 17, 588, 1,025, 5,120
# (ten slabs a band) and the first R past a cluster of 16 slabs (8,193: the
# wide path) x C = 1, 33, 70 (ragged bands), 1,024, 1,280 and 5,120. Each
# from an aligned base, an odd offset (values one by one) and 4 values in
# (bf16: 8-byte aligned, so the 4-value granules at every K % 4 == 0)
INT8_ROW_EDGE_ROWS = (1, 17, 1000, 4128)
INT8_ROW_EDGE_K = (1, 7, 588, 960, 1280, 2048, 2049, 4096, 5120, 8192, 16385)
INT8_COL_EDGE_R = (1, 17, 588, 1025, 5120, 8193)
INT8_COL_EDGE_C = (1, 33, 70, 1024, 1280, 5120)
INT8_EDGE_OFFSETS = (0, 1, 4)
# col_quantize's cluster launch (switchback.cu, launch_cols): bands of 32
# columns, 64 rows a chunk step, as few slabs a band as hold at most 8 steps
# each, at most 16 slabs
COL_BAND, COL_STEP, COL_MAX_STEPS, COL_MAX_CLUSTER = 32, 64, 8, 16


def col_last_slab(R, C):
    """The first row of the last slab of a band in ``col_quantize``'s
    cluster launch, or None where the launcher takes the wide path."""
    steps = -(-R // COL_STEP)
    slabs = -(-steps // COL_MAX_STEPS)
    if slabs > COL_MAX_CLUSTER:
        return None
    return (slabs - 1) * COL_STEP * -(-steps // slabs)


def int8_edge_input(torch, gen, R, C, dev, dtype, offset=0):
    """Random values over many binades (a scale e^-4..e^4 a row) with the
    cases the quantizers must keep: exact half-way ties at scale 1 in row 1
    and column 1 (absmax 127), an all-zero row 2 and column 2, and a lone
    outlier (1,000) in the last row, column 3 (or the last): the last slab's
    of its band, the last chunk's of its row. ``offset``: the elements the
    contiguous view starts after its buffer's start."""
    x = torch.randn((R, C), generator=gen, device=dev) * 3
    x = x * torch.exp(torch.empty((R, 1), device=dev).uniform_(-4, 4, generator=gen))
    ties = lambda n: (torch.arange(n, device=dev, dtype=torch.float32) % 8) - 3.5
    if C >= 3:
        x[:, 1] = ties(R)
        x[0, 1] = 127.0
        x[:, 2] = 0.0
    if R >= 3:
        x[1] = ties(C)
        x[1, 0] = 127.0
        x[2] = 0.0
    x[-1, min(3, C - 1)] = 1000.0
    x = x.to(dtype)
    if offset:
        buf = torch.empty(R * C + offset, dtype=dtype, device=dev)
        buf[offset:] = x.reshape(-1)
        x = buf[offset:].view(R, C)
        check(x.is_contiguous(), "an offset view")
    return x


def dropped_slab(torch, REF, x, start):
    """The control fault of the column edges: ``col_quantize`` with the
    maxima of the rows from ``start`` on (a band's last slab) left out of
    each column's absmax."""
    a = x[:start].float().abs().amax(0, keepdim=True) if start else torch.zeros_like(x[:1]).float()
    s = a.clamp_min(1e-12)
    return torch.round(x.float() * REF.div(127.0, s)).to(torch.int8), s


# the tensor quantizers' edges (int8 in phase 13, both fp8 formats in phase
# 19; bf16 and f32): every weight of the serve and train paths (smollm's
# seven a layer, CLIP's vision and text layers' six, the patch embedding),
# where each must take the one launch in bf16; n = 1, 7, 9, 15, 257 chunks
# (two blocks), 33 blocks, ~700 K values with n % 8 = 5; the one-launch
# limit (every resident block's registers, from the launcher's plan), one
# granule either side of it and 3 values under it. Each from offsets of 0,
# 1, 2 and 4 elements (the granules of 16, 2, 4 and 8 bytes of bf16)
TQ_PATH_SHAPES = ((960, 960), (960, 320), (960, 2560), (2560, 960), (1280, 1280), (1280, 5120),
                  (5120, 1280), (1024, 1024), (1024, 4096), (4096, 1024), (588, 1280))
TQ_SMALL_SHAPES = ((1, 1), (1, 7), (1, 9), (3, 5), (1, 2049), (1, 65541), (7, 100003))
TQ_OFFSETS = (0, 1, 2, 4)
TQ_LIBRARY = "none: no single PyTorch call takes a tensor's absmax and casts by it"


def tq_family(M, family):
    """(kernel, plain version, control fault, plan) of a tensor quantizer:
    ``family`` "int8" or an fp8 format."""
    if family == "int8":
        O, R, args = M.KOPS, M.REF, ()
    else:
        O, R, args = M.F8, M.F8REF, (family,)
    return (lambda x: O.tensor_quantize(x, *args), lambda x: R.tensor_quantize(x, *args),
            lambda x, b: O.tensor_quantize_drop(x, *args, b), O.tensor_quantize_plan)


def tq_input(torch, gen, R, C, dev, dtype, family, at, offset=0):
    """Random values over many binades below the absmax A (127 for int8, 1
    for fp8, where the scale is exact), A alone at the flat index ``at``
    (negative at odd ``at``), and where room allows 256 exact rounding ties
    at that scale (int8: k + 0.5; fp8: k / 64, midpoints of both grids) and
    seven bf16 subnormals. ``offset``: the elements the contiguous view
    starts after its buffer's start."""
    n = R * C
    A = 127.0 if family == "int8" else 1.0
    x = torch.randn(n, generator=gen, device=dev)
    x = x * torch.exp(torch.empty(n, device=dev).uniform_(-4, 4, generator=gen))
    x = x / x.abs().max() * (0.9 * A)
    if n >= 1024:
        k = torch.arange(256, device=dev, dtype=torch.float32)
        x[n // 3:n // 3 + 256] = (k % 8) - 3.5 if family == "int8" else ((k % 127) - 63) / 64
        x[n // 2:n // 2 + 7] = (torch.arange(7, device=dev) - 3).float() * 2.0 ** -133
    x[at] = -A if at % 2 else A
    x = x.to(dtype)
    if offset:
        buf = torch.empty(n + offset, dtype=dtype, device=dev)
        buf[offset:] = x
        x = buf[offset:]
    return x.view(R, C)


def tq_spans(n, blocks):
    """The first chunk of 8 values of each block's span: block b owns
    [b C / B, (b + 1) C / B) of the C chunks (tensor_absmax.cuh)."""
    chunks = -(-n // 8)
    return [b * chunks // blocks for b in range(blocks)]


def tq_spots(n, blocks):
    """Where the absmax goes: the first value, the last, inside the last
    block's span, the last value before it (a span's edge)."""
    last = 8 * tq_spans(n, blocks)[-1]
    return {"first": 0, "last": n - 1, "last block": min(n - 1, last + (n - last) // 2),
            "span edge": max(0, min(n - 1, last - 1))}


def compare_tensor_quantizer_edges(torch, M, dev, seed, families):
    """Each tensor quantizer of ``families`` ("int8", "e4m3", "e5m2") at
    TQ_PATH_SHAPES, TQ_SMALL_SHAPES and the one-launch limit's edges from
    each of TQ_OFFSETS, bf16 and f32, on ``tq_input``'s cases with the
    absmax at each of ``tq_spots`` (from offset 0; inside the last block's
    span from the others) and on an all-zero tensor: codes and state
    bit-equal to the plain version and bit-identical over two launches;
    every path weight in bf16 on the one launch, one CUDA kernel a call
    (``tq_kernels_a_call``). The control fault (the
    partial of the absmax's block left out) must differ from the plain
    version in every case with more than one block. Returns the largest
    |kernel - plain| by family, the comparisons and the faults caught."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = dict.fromkeys(families, 0.0)
    n_cmp = caught = 0
    bits = lambda t: t.view(torch.uint8) if t.element_size() == 1 else t
    for family in families:
        quant, plain, drop, plan = tq_family(M, family)
        a_call = tq_kernels_a_call(torch, quant, dev)
        check(a_call == 1, f"{family} tensor_quantize: {a_call} CUDA kernels a call on the path "
              "weights, not the one launch")
        for dt in (torch.bfloat16, torch.float32):
            lim = plan(torch.empty((1, 8), dtype=dt, device=dev))
            L = lim["resident"] * lim["block_values"]
            for R, C in TQ_PATH_SHAPES + TQ_SMALL_SHAPES + ((1, L - 8), (1, L - 3), (1, L),
                                                             (1, L + 8)):
                n = R * C
                p = plan(torch.empty((R, C), dtype=dt, device=dev))
                check(p["rounds"] == (0 if n <= L else 2),
                      f"{family} tensor_quantize {R}x{C} {dt}: plan {p} against the limit {L}")
                check((R, C) not in TQ_PATH_SHAPES or dt != torch.bfloat16 or p["rounds"] == 0,
                      f"{family} tensor_quantize {R}x{C} bf16, a path weight: two launches {p}")
                spots = tq_spots(n, p["blocks"])
                cases = [(0, w, at) for w, at in spots.items()]
                cases += [(o, "last block", spots["last block"]) for o in TQ_OFFSETS[1:]]
                cases.append((0, "all zero", None))
                for offset, where, at in cases:
                    what = f"{family} tensor_quantize {R}x{C} {dt} offset {offset} absmax {where}"
                    x = (torch.zeros((R, C), dtype=dt, device=dev) if at is None else
                         tq_input(torch, gen, R, C, dev, dt, family, at, offset))
                    got, again, want = quant(x), quant(x), plain(x)
                    for g, a, w, part in zip(got, again, want, ("codes", "state")):
                        check(g.dtype == w.dtype and g.shape == w.shape
                              and torch.equal(bits(g), bits(w)),
                              f"{what} {part}: kernel != plain (max |diff| "
                              f"{max_abs_diff(torch, g.float(), w.float()):g})")
                        check(torch.equal(bits(g), bits(a)), f"{what} {part}: two launches differ")
                        worst[family] = max(worst[family],
                                            max_abs_diff(torch, g.float(), w.float()))
                        n_cmp += 1
                    if at is not None and offset == 0 and p["blocks"] > 1:
                        block = max(b for b, lo in enumerate(tq_spans(n, p["blocks"]))
                                    if lo <= at // 8)
                        q_f, s_f = drop(x, block)
                        check(not (torch.equal(bits(q_f), bits(want[0]))
                                   and torch.equal(s_f, want[1])),
                              f"{what}: the control fault (block {block}'s partial left out) "
                              "reads as the plain version")
                        caught += 1
                    del x, got, again, want
    torch.cuda.synchronize()
    return worst, n_cmp, caught


def graph_kernels(torch, fn):
    """CUDA kernels one ``fn()`` launches: the kernel nodes of a CUDA graph
    that captures it (``kernels/build.graph_kernels``: ``cuGraphGetNodes``,
    ``cuGraphNodeGetType``). Exact, where torch.profiler's CUPTI records
    can go missing (one window of an H100 read 10 of 11, and a run read
    none in three windows), and blind to kernel names: a torch kernel the
    wrapper launched beside its own would count."""
    from repro_torch.kernels import build as KBUILD
    return len(KBUILD.graph_kernels(fn))


def tq_kernels_a_call(torch, quant, dev):
    """CUDA kernels a ``quant`` call launches on the weights of
    TQ_PATH_SHAPES in bf16, a call a weight (``graph_kernels``): 1 for the
    one launch, 2 for the two-pass form."""
    ws = [torch.randn(shape, device=dev).to(torch.bfloat16) for shape in TQ_PATH_SHAPES]
    return graph_kernels(torch, lambda: [quant(w) for w in ws]) / len(ws)


# the K-major fp8 quantizer's own edges beside TQ_PATH_SHAPES and
# TQ_SMALL_SHAPES: the cuda tests' ragged transposes, and a bf16 tensor past
# the registers of 264 blocks (the two passes, on no path)
KT_EDGE_SHAPES = ((37, 5), (130, 70), (3000, 3000))


def kt_spots(p, R, C):
    """Where the absmax goes in the K-major form (flat indices): the first
    value, the last, the last tile's first value and the value before it
    in x (another tile's, or another row's)."""
    h, w = p["tile_rows"], p["tile_cols"]
    nc = -(-C // w)
    r0, c0 = (p["tiles"] - 1) // nc * h, (p["tiles"] - 1) % nc * w
    first = r0 * C + c0
    return {"first": 0, "last": R * C - 1, "last tile": first, "tile edge": max(0, first - 1)}


def kt_block_of(p, at, C):
    """The block that holds flat index ``at``: its tile (row-major over the
    grid of h x w tiles), modulo the blocks (the two passes' rounds)."""
    r, c = divmod(at, C)
    nc = -(-C // p["tile_cols"])
    return (r // p["tile_rows"] * nc + c // p["tile_cols"]) % p["blocks"]


def kt_kernels_a_call(torch, F8, dev):
    """CUDA kernels a ``tensor_quantize_kt`` call launches on the weights
    of TQ_PATH_SHAPES in bf16 (as ``tq_kernels_a_call``)."""
    return tq_kernels_a_call(torch, lambda w: F8.tensor_quantize_kt(w, "e4m3"), dev)


def compare_kt_edges(torch, M, dev, seed):
    """The fp8 K-major quantizer (``tensor_quantize_kt``, the fp8 paths'
    quantizer of W) in both formats, bf16 and f32, at TQ_PATH_SHAPES,
    TQ_SMALL_SHAPES and KT_EDGE_SHAPES, on ``tq_input``'s cases with the
    absmax at each of ``kt_spots`` (from offset 0; at the last tile's first
    value from offsets 1, 2 and 4) and on an all-zero tensor: q and the
    state bit-equal to ``F8REF.tensor_quantize``, q_k to q's bytes
    transposed, both copies the same over two launches. The plan: its grid
    within the resident blocks, its tile of whole 32-row runs and 16-column
    cells inside the registers; every path weight in bf16 on the one
    launch, one CUDA kernel a call. Two control faults at offset 0: the
    partial of the absmax's block left out (caught where there is more than
    one block) and the K-major tile of that block left unwritten (always).
    Returns the largest |kernel - plain| (decoded), the comparisons and the
    faults caught."""
    F8 = M.F8
    gen = torch.Generator(device=dev).manual_seed(seed)
    a_call = kt_kernels_a_call(torch, F8, dev)
    check(a_call == 1, f"fp8 tensor_quantize_kt: {a_call} CUDA kernels a call on the path "
          "weights, not the one launch")
    worst, n_cmp, caught = 0.0, 0, 0
    for fmt in ("e4m3", "e5m2"):
        for dt in (torch.bfloat16, torch.float32):
            for R, C in TQ_PATH_SHAPES + TQ_SMALL_SHAPES + KT_EDGE_SHAPES:
                n = R * C
                p = F8.tensor_quantize_kt_plan(torch.empty((R, C), dtype=dt, device=dev))
                check(p["blocks"] <= min(p["resident"], F8.MAX_PARTIALS)
                      and p["tile_rows"] % 32 == 0 and p["tile_cols"] % 16 == 0
                      and p["tile_rows"] * p["tile_cols"] <= p["block_values"]
                      and (p["rounds"] > 0 or p["blocks"] == p["tiles"]),
                      f"tensor_quantize_kt {R}x{C} {dt}: plan {p}")
                check((R, C) not in TQ_PATH_SHAPES or dt != torch.bfloat16 or p["rounds"] == 0,
                      f"tensor_quantize_kt {R}x{C} bf16, a path weight: two launches {p}")
                check(n <= p["resident"] * p["block_values"] or p["rounds"] > 0,
                      f"tensor_quantize_kt {R}x{C} {dt}: one launch past the registers {p}")
                spots = kt_spots(p, R, C)
                cases = [(0, w, at) for w, at in spots.items()]
                cases += [(o, "last tile", spots["last tile"]) for o in TQ_OFFSETS[1:]]
                cases.append((0, "all zero", None))
                for offset, where, at in cases:
                    what = f"tensor_quantize_kt {fmt} {R}x{C} {dt} offset {offset} absmax {where}"
                    x = (torch.zeros((R, C), dtype=dt, device=dev) if at is None else
                         tq_input(torch, gen, R, C, dev, dt, fmt, at, offset))
                    got, again = F8.tensor_quantize_kt(x, fmt), F8.tensor_quantize_kt(x, fmt)
                    want = plain_kt(torch, M, x, fmt)
                    want = (want[0].view(torch.uint8), *want[1:])
                    got = (got[0].view(torch.uint8), got[1], got[2])
                    again = (again[0].view(torch.uint8), again[1], again[2])
                    for g, a, w, part in zip(got, again, want, ("codes", "state", "K-major")):
                        check(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w),
                              f"{what} {part}: kernel != plain")
                        check(torch.equal(g, a), f"{what} {part}: two launches differ")
                        n_cmp += 1
                    worst = max(worst, max_abs_diff(torch, got[1], want[1]))
                    if at is not None and offset == 0:
                        b = kt_block_of(p, at, C)
                        if p["blocks"] > 1:
                            q_f, s_f, _ = F8.tensor_quantize_kt_fault(x, fmt, drop=b)
                            check(not (torch.equal(q_f.view(torch.uint8), want[0])
                                       and torch.equal(s_f, want[1])),
                                  f"{what}: the control fault (block {b}'s partial left out) "
                                  "reads as the plain version")
                            caught += 1
                        _, _, k_f = F8.tensor_quantize_kt_fault(x, fmt, skip=b)
                        check(not torch.equal(k_f, want[2]), f"{what}: the control fault "
                              f"(block {b}'s K-major tile left unwritten) reads as the plain "
                              "version")
                        caught += 1
                    del x, got, again, want
    torch.cuda.synchronize()
    return worst, n_cmp, caught


def time_tensor_quantize(torch, quant, plain, gen, dev, shapes, what, k_major=False):
    """A tensor quantizer over one layer's weights ``shapes`` [(K, M)], bf16
    as the paths give them: its device ms by graph replay over input sets
    larger than L2, the plain version's (with ``plain``), the eager ms and
    the bound (each value read once in bf16 and written once in 8 bits, and
    with ``k_major`` once more K-major, and the state)."""
    n_el = sum(K * Mw for K, Mw in shapes)
    sets = [[weight(torch, gen, K, Mw, dev) for K, Mw in shapes]
            for _ in range(max(2, int(120e6 // (3 * n_el)) + 1))]
    call = lambda i, fn: [fn(w) for w in sets[i]]
    out = dict(ms=graph_ms(torch, lambda i: call(i, quant), len(sets)),
               plain_ms=graph_ms(torch, lambda i: call(i, plain), len(sets)) if plain else None,
               library_ms=None, library=TQ_LIBRARY,
               eager_ms=eager_ms(torch, lambda i: call(i, quant), len(sets)),
               bound=bound((4 if k_major else 3) * n_el + 4 * len(shapes), f32_ops=2 * n_el),
               calls=len(shapes), work=f"{what}: {len(shapes)} calls")
    del sets
    return out


def tower_weights(lins):
    """The weights (K, M) of one layer of a ``clip_shapes`` entry."""
    return [(K, Mw) for K, Mw, _ in clip_layer(lins)]


def compare_int8_quantizer_edges(torch, M, dev, seed):
    """Phase 13: ``row_quantize`` at INT8_ROW_EDGE_ROWS x INT8_ROW_EDGE_K
    and ``col_quantize`` at INT8_COL_EDGE_R x INT8_COL_EDGE_C, bf16 and f32,
    from each of INT8_EDGE_OFFSETS, on ``int8_edge_input``'s cases: the
    codes and the states bit-equal to the plain versions and bit-identical
    over two launches. The control fault (``dropped_slab``, every column
    case on the cluster path) must differ from the plain version. Then
    ``tensor_quantize`` at its edges (``compare_tensor_quantizer_edges``),
    where the module has the entry points for them. Returns the largest
    |kernel - plain| by kernel, the number of comparisons and of faults
    caught."""
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {"row_quantize": 0.0, "col_quantize": 0.0}
    n = caught = 0
    cases = [("row_quantize", R, K) for R in INT8_ROW_EDGE_ROWS for K in INT8_ROW_EDGE_K]
    cases += [("col_quantize", R, C) for R in INT8_COL_EDGE_R for C in INT8_COL_EDGE_C]
    for name, R, C in cases:
        for dt in (torch.bfloat16, torch.float32):
            for offset in INT8_EDGE_OFFSETS:
                x = int8_edge_input(torch, gen, R, C, dev, dt, offset)
                what = f"{name} {R}x{C} {dt} offset {offset}"
                got, again = getattr(KOPS, name)(x), getattr(KOPS, name)(x)
                want = getattr(REF, name)(x)
                for g, a, w, part in zip(got, again, want, ("int8", "state")):
                    check(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w),
                          f"{what} {part}: kernel != plain (max |diff| "
                          f"{max_abs_diff(torch, g, w):g})")
                    check(torch.equal(g, a), f"{what} {part}: two launches differ")
                    worst[name] = max(worst[name], max_abs_diff(torch, g, w))
                    n += 1
                start = col_last_slab(R, C) if name == "col_quantize" else None
                if start is not None and offset == 0:
                    q_f, s_f = dropped_slab(torch, REF, x, start)
                    check(not (torch.equal(q_f, want[0]) and torch.equal(s_f, want[1])),
                          f"{what}: the control fault (the last slab's maxima, rows "
                          f"{start}.., left out) reads as the plain version")
                    caught += 1
                del x, got, again, want
    if getattr(KOPS, "tensor_quantize_plan", None):
        t_worst, t_n, t_caught = compare_tensor_quantizer_edges(torch, M, dev, seed + 1, ("int8",))
        worst["tensor_quantize"] = t_worst["int8"]
        n, caught = n + t_n, caught + t_caught
    torch.cuda.synchronize()
    return worst, n, caught


def int8_quantizer_calls(lins, rows):
    """The int8 quantizers' calls over one layer of a ``clip_shapes`` entry
    in the column-wise modes (``_q``, ``int8_llm``), as (rows, width, a
    weight): ``row_quantize`` of X (rows, K) of each linear and, where it
    has an input gradient, of Ẏ (rows, M) and of W (K, M); ``col_quantize``
    of each W (K, M)."""
    layer = clip_layer(lins)
    row = ([(rows, K, False) for K, _, _ in layer] + [(rows, Mw, False) for _, Mw, dx in layer if dx]
           + [(K, Mw, True) for K, Mw, dx in layer if dx])
    return row, [(K, Mw, True) for K, Mw, _ in layer]


def time_int8_quantizers(torch, M, gen, dev, calls, what, plain=True):
    """``row_quantize`` and ``col_quantize`` over one layer's ``calls``
    (``int8_quantizer_calls``), bf16 as the path gives them: each kernel's
    device ms by graph replay over input sets larger than L2, the plain
    version's (with ``plain``), the eager ms and the bound (each value read
    once in bf16 and written once in 8 bits, and the states)."""
    KOPS, REF = M.KOPS, M.REF
    row, col = calls
    make = lambda a, b, w: weight(torch, gen, a, b, dev) if w else activations(torch, gen, a, b, dev)
    n_el = sum(a * b for a, b, _ in row + col)
    sets = [{"row_quantize": [make(*c) for c in row], "col_quantize": [make(*c) for c in col]}
            for _ in range(max(2, int(120e6 // (3 * n_el)) + 1))]
    work = {"row_quantize": (row, sum(3 * a * b + 4 * a for a, b, _ in row)),
            "col_quantize": (col, sum(3 * a * b + 4 * b for a, b, _ in col))}
    out = {}
    for name, (shapes, bytes_) in work.items():
        if not shapes:
            continue

        def call(i, op, name=name):
            return [getattr(op, name)(x) for x in sets[i][name]]
        out[name] = dict(
            ms=graph_ms(torch, lambda i: call(i, KOPS), len(sets)),
            plain_ms=graph_ms(torch, lambda i: call(i, REF), len(sets)) if plain else None,
            library_ms=None, eager_ms=eager_ms(torch, lambda i: call(i, KOPS), len(sets)),
            bound=bound(bytes_, f32_ops=2 * sum(a * b for a, b, _ in shapes)),
            calls=len(shapes), work=f"{what}: {len(shapes)} calls")
    del sets
    return out


def kv_grads_by_modulo(dk_heads, n_kv):
    """The control fault's dk/dv: a gradient over H query heads' own K/V
    copies (B, S, H, hd) summed onto KV head h % KV (the tiled wiring)."""
    B, S, H, hd = dk_heads.shape
    return dk_heads.reshape(B, S, H // n_kv, n_kv, hd).sum(dim=2)


def gqa_fault(H, KV):
    """The control fault of the GQA shapes: K/V head h % KV instead of
    h // group, its dk/dv summed back onto the KV heads the same way."""
    def fault(q, k, v, causal):
        return (q, kv_heads_by_modulo(k, H), kv_heads_by_modulo(v, H), causal,
                lambda dq, dk, dv: (dq, kv_grads_by_modulo(dk, KV), kv_grads_by_modulo(dv, KV)))
    return fault


def lanes_fault(q, k, v, causal):
    """A control fault at hd > 64: the head dims past 64 dropped."""
    fq, fk, fv = (t.clone() for t in (q, k, v))
    for t in (fq, fk, fv):
        t[..., 64:] = 0
    return fq, fk, fv, causal, lambda *g: g


def mask_fault(q, k, v, causal):
    """A control fault: the causal mask dropped (or added)."""
    return q, k, v, not causal, lambda *g: g


def smollm_flash_cases(cfg):
    """Phase 3c's table: (tower, B, Sq, Sk, kv_valid, H, KV, hd, causal,
    fault): 8 sequences of 64, 200 and 256 tokens, causal and full, and 256
    with kv_valid 200; smollm's 15 query heads over 5 KV heads of 64."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    fault = gqa_fault(H, KV)
    cases = [(S, S, c) for S in (64, 200, TRAIN_SEQ) for c in (True, False)]
    cases += [(TRAIN_SEQ, 200, c) for c in (True, False)]
    return [("smollm", TRAIN_BATCH, S, S, kv, H, KV, hd, c, fault) for S, kv, c in cases]


def compare_flash_train(torch, M, cases, dev, seed, dtypes=None):
    """The flash kernels a training path runs against their plain versions
    at its attention shapes (``cases``, see ``smollm_flash_cases``; Sq and
    Sk apart for cross attention), bf16
    and f32: ``flash_fwd`` (o within FLASH_O_TOL of max|o|, lse within
    FLASH_LSE_TOL), ``flash_bwd_dq`` / ``flash_bwd_dkv`` (f32, within
    FLASH_BWD_TOL of max|grad|, from the kernel forward's o and lse against
    ``ref.mha_bwd``). Each backward kernel run twice must give the same
    bits, keys past kv_valid get no gradient, and each case's control fault
    (the plain versions on faulty inputs) must read FAULT_MARGIN x outside
    every tolerance. ``dtypes`` (default bf16 and f32) are the forms held.
    Returns the readings per kernel (for ``flash_fwd`` also the mean signed
    error of o and of lse, by dtype) and the number of comparisons."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {k: dict(max_abs_err=0.0, max_rel_err=0.0, fault_over_tol=math.inf)
           for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    signed = {}                                   # "o bfloat16" ... -> [sum, count]
    n = 0

    def record(name, got, want, fault, tol, what):
        nonlocal n
        r = out[name]
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} {what}: bad output")
        err = rel_err(torch, got, want)
        r["max_rel_err"] = max(r["max_rel_err"], err)
        r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(torch, got, want))
        check(err <= tol, f"{name} {what}: kernel vs plain {err:g} > {tol:g}")
        f = rel_err(torch, got, fault) / tol
        r["fault_over_tol"] = min(r["fault_over_tol"], f)
        check(f >= FAULT_MARGIN, f"{name} {what}: the control fault reads only {f:g} x the "
              "tolerance")
        n += 1

    def rand(*shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    for dt in dtypes or (torch.bfloat16, torch.float32):
        key = str(dt).replace("torch.", "")
        for tower, B, S, Sk, kv_valid, H, KV, hd, causal, fault in cases:
            scale = M.FA.softmax_scale(hd)
            q, do = rand(B, S, H, hd, dt=dt), rand(B, S, H, hd, dt=dt)
            k, v = rand(B, Sk, KV, hd, dt=dt), rand(B, Sk, KV, hd, dt=dt)
            kw = dict(causal=causal, kv_valid=kv_valid)
            what = (f"{tower} B{B} Sq{S} Sk{Sk} kv_valid{kv_valid} H{H}/{KV} hd{hd} "
                    f"causal={causal} {dt}")
            o, lse = M.FA.flash_fwd_lse(q, k, v, **kw)
            ro, rlse = M.FREF.mha_fwd(q, k, v, scale=scale, **kw)
            fq, fk, fv, fcausal, back = fault(q, k, v, causal)
            fo, flse = M.FREF.mha_fwd(fq, fk, fv, causal=fcausal, kv_valid=kv_valid, scale=scale)
            record("flash_fwd", o, ro, fo, FLASH_O_TOL[key], what)
            for part, got, want in (("o", o, ro), ("lse", lse, rlse)):
                acc = signed.setdefault(f"{part} {key}", [0.0, 0])
                acc[0] += float((got.double() - want.double()).sum())
                acc[1] += got.numel()
            e = float((lse - rlse).abs().max())
            check(e <= FLASH_LSE_TOL, f"flash_fwd {what}: lse off by {e:g}")
            di = M.FREF.attention_di(o, do)
            dq = M.FA.flash_bwd_dq(q, k, v, do, lse, di, **kw)
            dk, dv = M.FA.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
            check(torch.equal(dq, M.FA.flash_bwd_dq(q, k, v, do, lse, di, **kw)),
                  f"flash_bwd_dq {what}: two launches differ")
            check(all(torch.equal(a, b) for a, b in
                      zip((dk, dv), M.FA.flash_bwd_dkv(q, k, v, do, lse, di, **kw))),
                  f"flash_bwd_dkv {what}: two launches differ")
            check(all(t.dtype == torch.float32 for t in (dq, dk, dv)),
                  f"flash backward {what}: gradients not f32")
            rdq, rdk, rdv = M.FREF.mha_bwd(q, k, v, o, lse, do, scale=scale, **kw)
            fdq, fdk, fdv = back(*M.FREF.mha_bwd(fq, fk, fv, fo, flse, do, causal=fcausal,
                                                 kv_valid=kv_valid, scale=scale))
            btol = FLASH_BWD_TOL[key]
            record("flash_bwd_dq", dq, rdq, fdq, btol, what)
            record("flash_bwd_dkv", dk, rdk, fdk, btol, what)
            record("flash_bwd_dkv", dv, rdv, fdv, btol, what)
            check(float(dk[:, kv_valid:].abs().sum()) == 0.0 == float(dv[:, kv_valid:].abs().sum()),
                  f"flash_bwd_dkv {what}: keys past kv_valid got a gradient")
    torch.cuda.synchronize()
    out["flash_fwd"]["mean_signed_err"] = {k: t / c for k, (t, c) in signed.items()}
    return out, n


# ---------------------------------------------------------------------------
# phases 9-12: the training path
# ---------------------------------------------------------------------------

def train_parts(torch, cfg, dev, *, mode="int8_switchback", compute_dtype=None,
                impl="flash_scan", steps=100, lr=2e-3, warmup=4, scaler="none",
                remat="none", optimizer="stable_adamw"):
    """(bundle, policy, parallel, TrainConfig, train_step, opt, scaler) of
    a training path: StableAdamW (warm-up ``warmup``, cosine over
    ``steps``), no loss scaling, remat "none", unless phase 30 asks for
    another ``optimizer``, ``scaler`` or ``remat``."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.precision import QuantPolicy
    from repro_torch.models import build
    from repro_torch.train import make_train_setup, make_train_step
    bundle = build(cfg)
    policy = QuantPolicy(mode, compute_dtype=compute_dtype or torch.bfloat16)
    parallel = ParallelConfig(remat=remat, attn_impl=impl)
    tc = TrainConfig(learning_rate=lr, warmup_steps=warmup, total_steps=steps, quant_mode=mode,
                     loss_scaler=scaler, optimizer=optimizer)
    opt, scaler = make_train_setup(tc)
    step = make_train_step(bundle, policy, parallel, tc, opt, scaler)
    return bundle, policy, parallel, tc, step, opt, scaler


def bigram_batches(torch, n, batch, seq, dev, seed):
    """``n`` BigramLM batches (the data chain over DATA_VOCAB ids), on ``dev``."""
    from repro_torch.data import BigramLM
    data = BigramLM(DATA_VOCAB, seed=seed, temperature=0.2)
    return [{k: torch.from_numpy(v).to(device=dev, dtype=torch.long)
             for k, v in data.batch(batch, seq).items()} for _ in range(n)]


def train(torch, M, cfg, dev, seed, timed_steps=6):
    """Full-width training through ``Trainer``: a warm-up step, then
    ``timed_steps`` steps with every launch counter zeroed just before and
    read just after; each must be exactly its per-layer count x the layers
    x the steps, and every loss finite."""
    from repro_torch.models import params as PRM
    from repro_torch.train import Trainer, init_train_state
    bundle, policy, parallel, tc, step, opt, scaler = train_parts(torch, cfg, dev)
    t = time.perf_counter()
    params = PRM.init_params(bundle.param_specs, seed, device=dev)
    state = init_train_state(params, opt, scaler)
    batches = bigram_batches(torch, 1 + timed_steps, TRAIN_BATCH, TRAIN_SEQ, dev, seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"[train] {cfg.n_layers} layers, {n_params / 1e6:.1f} M params, "
          f"{len(batches)} BigramLM batches of {TRAIN_BATCH} x {TRAIN_SEQ} on {dev} "
          f"in {time.perf_counter() - t:.1f} s")
    trainer = Trainer(step, state, log_every=1000)
    trainer.run(lambda i: batches[i], 1)                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(M)
    t = time.perf_counter()
    trainer.run(lambda i: batches[i], timed_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = launch_counts(M)
    losses = [h["loss"] for h in trainer.history]
    check(len(losses) == 1 + timed_steps and all(math.isfinite(x) for x in losses),
          f"non-finite or missing losses: {losses}")
    for k, per in TRAIN_PER_LAYER.items():
        want = per * cfg.n_layers * timed_steps
        check(per == 0 or counts[k] > 0, f"{k} never launched on the train path")
        check(counts[k] == want, f"{k}: {counts[k]} launches in {timed_steps} train steps, "
              f"expected {want} ({per} per layer x {cfg.n_layers} layers x {timed_steps})")
    res = dict(step_ms=wall / timed_steps * 1e3,
               tokens_per_s=timed_steps * TRAIN_ROWS / wall, losses=losses,
               grad_norms=[h["grad_norm"] for h in trainer.history],
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches_per_step={k: v / timed_steps for k, v in counts.items()},
               stability=trainer.stability_report())
    print("[train]", json.dumps(res))
    return trainer, batches, counts, res


def grad_errs(torch, got, want, skip=()):
    """Readings between two (loss, grads) pairs, leaves whose path holds a
    pattern of ``skip`` left out: the loss's relative error; per leaf the
    max and the mean |diff| over the leaf's max|want| (the worst leaf of
    each, and the leaf of that mean) and the norm ||diff|| / ||want|| (the
    worst leaf, the median leaf, and the leaf of that worst)."""
    from repro_torch.models.params import tree_paths
    (gg, gl), (wg, wl) = got[:2], want[:2]
    mx, mean, leaf = tree_errs(gg, wg, skip)
    norms = {path: float((a.double() - b.double()).norm()) / (float(b.double().norm()) or 1.0)
             for (path, a), b in zip(tree_paths(gg), (leaf for _, leaf in tree_paths(wg)))
             if not any(p in path for p in skip)}
    return dict(loss_rel_err=abs(float(gl) - float(wl)) / abs(float(wl)), grad_max_rel_err=mx,
                grad_mean_rel_err=mean, grad_norm_rel_err=max(norms.values()),
                grad_median_norm_rel_err=statistics.median(norms.values()),
                worst_mean_leaf=leaf, worst_norm_leaf=max(norms, key=norms.get))


def tree_errs(got, want, skip=()):
    """Worst per-leaf (max, mean) |got - want| over the leaf's max|want|,
    and the path of the leaf with the worst mean; leaves whose path holds
    a pattern of ``skip`` are left out."""
    from repro_torch.models.params import tree_paths
    mx = mean = 0.0
    worst = ""
    for (path, a), b in zip(tree_paths(got), (leaf for _, leaf in tree_paths(want))):
        if any(p in path for p in skip):
            continue
        a, b = a.double(), b.double()
        top = float(b.abs().max()) or 1.0
        mx = max(mx, float((a - b).abs().max()) / top)
        m = float((a - b).abs().mean()) / top
        if m >= mean:
            mean, worst = m, path
    return mx, mean, worst


# the 2-layer comparisons of phases 10 and 11 run from this many seeds
CHECK_SEEDS = 3


def check_seeds(seed, offset):
    return [seed + offset + 100 * j for j in range(CHECK_SEEDS)]


# one train step's loss and gradients, kernels against plain versions:
# (loss relative, per-leaf max and mean |diff| relative to the leaf's max).
# Under flash_scan the flash kernels sum in another order than the plain
# versions; the int8 quantizers turn a last-bit difference in an activation
# into one quantization step of its row now and then, more often in f32
# (see SERVED_FLASH_TOL). Under dense attention every kernel on the path
# is bit-equal to its plain version, so only the order of the embedding's
# scatter-add could differ. Each flash_scan limit is the geometric mean of
# the worst sound reading and the smallest control-fault reading over
# three seeds on an H100, rounded to one digit (readings in PERF.md,
# Findings): sound up to 2.1e-5 / 3.7e-2 / 4.4e-3, the fault at
# least 1.4e-3 / 1.5 / 2.4e-1. Under dense every sound reading was 0.
STEP_KEYS = ("loss_rel_err", "grad_max_rel_err", "grad_mean_rel_err")
STEP_TOL = {"flash_scan": dict(zip(STEP_KEYS, (2e-4, 2e-1, 3e-2))),
            "dense": dict(zip(STEP_KEYS, (1e-6, 1e-5, 1e-6)))}


def step_reading(torch, kern, plain, faults, skip=()):
    """One whole-step case's readings (``grad_errs``), (loss, grads) with
    the kernels and under each control fault (``faults``: description ->
    (loss, grads)) against the plain versions' (leaves whose path holds a
    pattern of ``skip`` left out), and whether the kernels' loss and
    gradients are finite."""
    from repro_torch.models import params as PRM
    r = dict(loss=float(kern[1]), loss_plain=float(plain[1]), **grad_errs(torch, kern, plain, skip),
             faults={name: {k: v for k, v in grad_errs(torch, f, plain, skip).items()
                            if not k.startswith("worst")} for name, f in faults.items()})
    finite = math.isfinite(float(kern[1])) and all(
        bool(torch.isfinite(g).all()) for g in PRM.tree_leaves(kern[0]))
    return r, finite


def check_readings(tag, res, finite, every_key=False):
    """Each reading within its ``tolerance`` and each of its control
    faults outside, on at least one of its keys (on every key with
    ``every_key``); called after all are printed."""
    for name, r in res.items():
        tol = r["tolerance"]
        check(finite[name], f"{tag} {name}: non-finite loss or gradient")
        check(all(r[k] <= t for k, t in tol.items()),
              f"{tag} {name}: kernels vs plain outside {tol}: {r}")
        for fault, fr in r["faults"].items():
            seen = [fr[k] > t for k, t in tol.items()]
            check(all(seen) if every_key else any(seen),
                  f"{tag} {name}: the control fault ({fault}) lies within {tol} on "
                  f"{'a key' if every_key else 'every key'}, which so could not see it: {r}")


def whole_step(torch, M, cfg, dev, seed, params32, batch):
    """One train step's loss and gradients with the kernels and with their
    plain versions swapped in: at 2 layers (full width) under flash_scan
    in f32 and bf16 and under dense in f32, from CHECK_SEEDS seeds of
    parameters and batches, and at full depth under flash_scan in bf16
    (the trained parameters). Each within STEP_TOL; the control faults
    must land outside: the KV heads tiled under flash_scan, and under dense
    in f32 the weight gradient rounded through bf16 (what a cast before the
    autograd function would do). Every reading is printed before any is
    checked."""
    from repro_torch.core import switchback as SB
    from repro_torch.models import params as PRM
    from repro_torch.train import loss_and_grads
    small = dataclasses.replace(cfg, n_layers=2)
    cases = []
    for s in check_seeds(seed, 3):
        p_small = PRM.init_params(param_specs_of(small), s, device=dev)
        b_small = bigram_batches(torch, 1, TRAIN_BATCH, TRAIN_SEQ, dev, s)[0]
        cases += [(f"2L_flash_scan_float32_seed{s}", small, p_small, b_small, "flash_scan",
                   torch.float32),
                  (f"2L_flash_scan_bfloat16_seed{s}", small, p_small, b_small, "flash_scan",
                   torch.bfloat16),
                  (f"2L_dense_float32_seed{s}", small, p_small, b_small, "dense", torch.float32)]
    cases.append((f"{cfg.n_layers}L_flash_scan_bfloat16", cfg, params32, batch, "flash_scan",
                  torch.bfloat16))
    orig_wgrad = SB.wgrad_16bit
    res, finite = {}, {}
    for name, c, params, b, impl, cd in cases:
        bundle, policy, parallel, *_ = train_parts(torch, c, dev, compute_dtype=cd, impl=impl)
        run = lambda: loss_and_grads(bundle, policy, parallel, params, b)
        kern = run()
        with plain_ops(M, flash=impl != "dense"):
            plain = run()
            if impl == "dense":
                fault_patch = [(SB, "wgrad_16bit",
                                lambda x, g: orig_wgrad(x, g).to(torch.bfloat16).float())]
            else:
                fault_patch = [(M.FREF, "_expand_heads", kv_heads_by_modulo)]
            with swapped(fault_patch):
                fault = run()
        desc = "dw rounded through bf16" if impl == "dense" else "KV head h % KV"
        res[name], finite[name] = step_reading(torch, kern, plain, {desc: fault})
        res[name].update(tolerance=STEP_TOL[impl])
        del kern, plain, fault
    print("[whole step]", json.dumps(res))
    check_readings("whole step", res, finite)
    return res


def param_specs_of(cfg):
    from repro_torch.models import build
    return build(cfg).param_specs


# card against CPU, 3 steps at full width and 2 layers: (loss relative per
# step, final parameters' worst per-leaf mean |diff| relative to the
# leaf's max). The card runs the kernels, the CPU their plain versions
# (which the CPU tests hold against the JAX package); they differ in the
# order of f32 sums (GEMMs, softmax), which the int8 quantizers and Adam's
# normalised step carry into the parameters. The parameters' per-leaf max
# is printed but not bounded: an element whose gradient is near 0 moves by
# about +-lr either way, so the max is a few lr whatever the cause (sound
# 2.0e-2, the control fault 2.8e-2 on an H100). Each limit is the
# geometric mean of the worst sound reading and the smallest reading of
# the control fault (KV heads tiled) over three seeds on an H100, rounded
# to one digit: loss 1.1e-4 against 1.3e-3, mean 1.8e-4 against 9.3e-3
# (readings in PERF.md, Findings).
CARD_CPU_TOL = {"loss_rel_err": 4e-4, "param_mean_rel_err": 1e-3}


def smollm_check_path(torch, M, cfg):
    """Phase 11's path: smollm at 2 layers in int8_switchback, BigramLM
    batches of 4 x 64, the control fault the KV heads tiled."""
    return types.SimpleNamespace(
        tag="card vs cpu", small=dataclasses.replace(cfg, n_layers=2),
        modes=("int8_switchback",), seed_offset=5, tol=CARD_CPU_TOL, opt={},
        batches=lambda n, where, s: bigram_batches(torch, n, 4, 64, where, s),
        keeps=lambda n, s: None,
        faults={"KV heads tiled (CPU)": control_fault("cpu", lambda: tiled_kv_heads(M))})


def control_fault(where, context=contextlib.nullcontext, params=None, back=None):
    """A control fault of ``card_vs_cpu``: run on ``where`` (the card when
    None: a fault in the parameters shows on either device, one patched
    into the plain versions only on the CPU) under ``context``, from
    ``params(p0)``, its final parameters turned back by ``back`` so that
    every leaf is compared with its own."""
    same = lambda t: t
    return types.SimpleNamespace(where=where, context=context, params=params or same,
                                 back=back or same)


def path_run(torch, path, where, mode, p0, batches, keeps, fault=None):
    """``len(batches)`` train steps of ``path`` in ``mode`` on ``where`` from
    the parameters ``p0`` (on the CPU), batches and kept patches (``keeps``,
    CLIP) made on the CPU, under ``fault`` (a ``control_fault``) when given:
    (each step's loss, the final parameters on the CPU)."""
    from repro_torch.models import params as PRM
    from repro_torch.train import init_train_state, make_train_step
    bundle, policy, parallel, tc, step, opt, scaler = train_parts(
        torch, path.small, where, mode=mode, **path.opt)
    if keeps is not None:       # the same kept patches on both devices
        feed = iter(keeps)
        step = make_train_step(
            dataclasses.replace(bundle, patch_keep=lambda g: next(feed).to(where)),
            policy, parallel, tc, opt, scaler)
    start = fault.params(p0) if fault else p0
    state = init_train_state(PRM.tree_map(lambda t: t.clone().to(where), start), opt, scaler)
    losses = []
    with (fault.context() if fault else contextlib.nullcontext()):
        for b in batches:
            state, m = step(state, {k: v.to(where) for k, v in b.items()})
            losses.append(float(m["loss"]))
    params = PRM.tree_map(lambda t: t.cpu(), state.params)
    return losses, fault.back(params) if fault else params


def run_errs(a, b, p0):
    """Readings between two ``path_run`` results: the loss's relative error,
    the largest over every step and over the steps before the third (a
    third step that spikes turns last bits into percents, PERF.md); the
    final parameters' worst per-leaf max and mean |diff| over the leaf's
    max|b|, leaves that start at zero (biases) left out: Adam moves an
    element whose gradient is about 0 by +-lr either way in a sound run, so
    such a leaf's max is a few lr and its reading noise."""
    from repro_torch.models import params as PRM
    zero = tuple(p for p, t in PRM.tree_paths(p0) if not bool(t.abs().max() > 0))
    mx, mean, leaf = tree_errs(a[1], b[1], zero)
    loss = [abs(x - y) / abs(y) for x, y in zip(a[0], b[0])]
    return dict(loss_rel_err=max(loss), early_loss_rel_err=max(loss[:2]),
                param_max_rel_err=mx, param_mean_rel_err=mean, worst_mean_leaf=leaf)


def cpu_half(torch, path, seed, steps=3):
    """``card_vs_cpu``'s CPU runs, which need no kernel: for each of its
    seeds the mode, the parameters, batches and kept patches, the plain run
    and the runs under the faults that run on the CPU. ``main`` runs phase
    22's while the kernels build."""
    from repro_torch.models import params as PRM
    out = []
    for j, s in enumerate(check_seeds(seed, path.seed_offset)):
        mode = path.modes[j % len(path.modes)]
        p_cpu = PRM.init_params(param_specs_of(path.small), s, device="cpu")
        batches, keeps = path.batches(steps, "cpu", s), path.keeps(steps, s)
        out.append(dict(seed=s, mode=mode, p_cpu=p_cpu, batches=batches, keeps=keeps,
                        cpu=path_run(torch, path, "cpu", mode, p_cpu, batches, keeps),
                        faults={name: path_run(torch, path, "cpu", mode, p_cpu, batches, keeps, f)
                                for name, f in path.faults.items() if f.where == "cpu"}))
    return out


def card_vs_cpu(torch, M, path, dev, seed, steps=3, cpu_runs=None):
    """The same ``steps`` train steps at full width and reduced depth on the
    card and on the CPU from the same parameters, batches and (CLIP) kept
    patches, from CHECK_SEEDS seeds, the seeds taking ``path.modes`` in
    turn (readings: ``run_errs``); each control fault of ``path.faults``
    (name -> ``control_fault``) must land outside the tolerance against the
    CPU on every key of it, at every seed. The CPU's runs are ``cpu_runs``
    where ``cpu_half`` made them before, else made here. Every reading is
    printed before any is checked."""
    res = {}
    for r in cpu_runs or cpu_half(torch, path, seed, steps):
        s, mode, p_cpu, batches, keeps, cpu = (r[k] for k in ("seed", "mode", "p_cpu", "batches",
                                                               "keeps", "cpu"))
        card = path_run(torch, path, dev, mode, p_cpu, batches, keeps)
        faults = {}
        for name, f in path.faults.items():
            run = r["faults"][name] if f.where == "cpu" else path_run(
                torch, path, f.where or dev, mode, p_cpu, batches, keeps, f)
            faults[name] = dict(losses=run[0], **run_errs(run, cpu, p_cpu))
        res[f"{mode}_seed{s}"] = dict(losses_card=card[0], losses_cpu=cpu[0],
                                      **run_errs(card, cpu, p_cpu), faults=faults)
    print(f"[{path.tag}]", json.dumps(dict(tolerance=path.tol, **res)))
    for name, r in res.items():
        check(all(math.isfinite(x) for x in r["losses_card"]),
              f"{path.tag} {name}: non-finite loss on the card")
        check(all(r[k] <= t for k, t in path.tol.items()),
              f"{path.tag} {name}: {r} outside {path.tol}")
        for fault, fr in r["faults"].items():
            check(all(fr[k] > t for k, t in path.tol.items()),
                  f"{path.tag} {name}: the control fault ({fault}) lies within {path.tol}: {r}")
    return res


# (pattern, flag, group): a kernel whose name holds both lands in the group,
# the first that matches. The int8 GEMM's kernels are ``<T, TW, SWAP>``:
# ", true," reads TW (the transposed, dgrad forms), "true>" would read SWAP.
# The fused pair's kernels (its row-quantize pass above 16 rows, either
# form, then its GEMM) count under the pair's own names; the fp8 row and
# tile quantizers (one body, two kernel names) under theirs, before the
# int8 ``row_quantize``; the fp8 tensor quantizer before the int8 one,
# whose name its own holds.
TRAIN_KERNEL_GROUPS = (
    ("fused_quantize", "true>", "fused_switchback_dgrad"),
    ("fused_quantize", "", "fused_switchback_fwd"),
    ("fused_switchback_kernel", ", true,", "fused_switchback_dgrad"),
    ("fused_switchback_kernel", "", "fused_switchback_fwd"),
    ("int8_matmul_kernel", ", true,", "int8_matmul_dequant_t (row or column scale)"),
    ("int8_matmul_kernel", "", "int8_matmul_dequant (row or column scale)"),
    ("fp8_gemm_kernel", "true>", "fp8_mixed_matmul and _t (one wgmma kernel)"),
    ("fp8_gemm_kernel", "", "fp8_matmul_dequant and _t (one wgmma kernel)"),
    ("transpose_bytes", "", "fp8 forward's K-major W (transpose_bytes)"),
    ("fp8_block_quantize", "", "fp8_block_quantize"),
    ("fp8_row_quantize", "", "fp8_row_quantize"),
    ("fp8_tensor_quantize", "", "fp8_tensor_quantize"),
    ("col_quantize", "", "col_quantize"),
    ("row_quantize", "", "row_quantize"),
    ("tensor_quantize", "", "tensor_quantize"),
    ("flash_bwd_dq", "", "flash_bwd_dq"),
    ("flash_bwd_dkv", "", "flash_bwd_dkv"),
    ("flash_fwd", "", "flash_fwd"),
)


# groups that a mode's profile (phases 15 and 20) must read device time in:
# a pattern that no longer matches its kernel's name leaves its group empty
PROFILE_GROUPS = {"fp8": ("fp8_tensor_quantize", "fp8_row_quantize",
                          "fp8_matmul_dequant and _t (one wgmma kernel)"),
                  "fp8_mixed": ("fp8_tensor_quantize", "fp8_block_quantize",
                                "fp8_mixed_matmul and _t (one wgmma kernel)"),
                  "int8_switchback": ("tensor_quantize",),
                  "int8_switchback_m": ("tensor_quantize",),
                  "int8_switchback_q": ("row_quantize", "col_quantize"),
                  "int8_llm": ("row_quantize", "col_quantize")}
# groups that a mode's profile must read no kernel in: the fp8 forward's W
# comes K-major from its quantizer (tensor_quantize_kt, in the
# fp8_tensor_quantize group), so transpose_bytes is on no path
PROFILE_IDLE_GROUPS = dict.fromkeys(("fp8", "fp8_mixed"),
                                    ("fp8 forward's K-major W (transpose_bytes)",))


# PyTorch's own kernels on the train step, by family (lower-case patterns)
TORCH_KERNEL_GROUPS = (
    (("gemm", "nvjet", "xmma", "cutlass", "cublas"),
     "gemm (wgrad, lm head, the simulated fp8 products)"),
    (("reduce_kernel",), "torch reductions (norms, loss, optimizer means, health)"),
    (("index",), "torch gather/scatter (embedding, loss)"),
    (("elementwise", "copy"), "torch elementwise (casts, norms, RoPE, optimizer)"),
)


def train_profile(torch, M, trainer, batches, n_steps=3, rows=TRAIN_ROWS, tag="train profile"):
    """One train step's wall time (over ``n_steps``, ending in a
    synchronize), then its device time, CUDA launches and the device time
    by kernel family from torch.profiler over another ``n_steps``. ``rows``:
    tokens (or image-text pairs) a step trains, for the rate."""
    start = int(trainer.state.step)
    data = lambda i: batches[(i - start) % len(batches)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.run(data, n_steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / n_steps * 1e3
    by_kernel = kernel_times(torch, lambda: trainer.run(data, n_steps), n_steps)
    dev_ms = sum(v[0] for v in by_kernel.values())
    groups = {}
    for key, (ms, cnt) in by_kernel.items():
        g = kernel_group(key)
        if g is None:
            low = key.lower()
            g = next((name for pats, name in TORCH_KERNEL_GROUPS
                      if any(pat in low for pat in pats)), "other")
        a = groups.setdefault(g, [0.0, 0])
        a[0] += ms
        a[1] += cnt
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    res = dict(step_ms=step_ms, tokens_per_s=rows / step_ms * 1e3,
               device_ms_per_step=dev_ms,
               cuda_launches_per_step=sum(v[1] for v in by_kernel.values()),
               device_idle_share=(max(0.0, 1 - dev_ms / step_ms) if dev_ms else None),
               groups={g: {"ms": v[0], "launches": v[1]} for g, v in
                       sorted(groups.items(), key=lambda kv: -kv[1][0])},
               top=[{"kernel": k[:90], "ms": v[0], "launches": v[1]} for k, v in top])
    if not dev_ms:
        print(f"[{tag}] torch.profiler saw no device time; step wall time only")
    print(f"[{tag}]", json.dumps(res))
    return res


def time_flash_bwd(torch, M, gen, dev, B, S, H, KV, hd, causal, dt=None, Sk=None):
    """``flash_bwd_dq`` and ``flash_bwd_dkv`` at one layer's attention
    shape (``S`` queries over ``Sk`` keys, default S), in ``dt`` (default
    bf16): each kernel, its plain version, SDPA's whole backward (dq,
    dk and dv together: the library yardstick of both) by CUDA-graph replay
    over the same input sets (its eager time beside, ``library_eager_ms``)
    and the bound (bytes against the live pairs' matmul operations at the
    bf16 peak). Returns the readings and the input sets (q, k, v, do, lse,
    di)."""
    import torch.nn.functional as F
    bf = dt or torch.bfloat16
    Sk = Sk or S

    def attn_set():
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(bf) for shape in
                       ((B, S, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd), (B, S, H, hd)))
        o, lse = M.FA.flash_fwd_lse(q, k, v, causal=causal)
        return q, k, v, do, lse, M.FREF.attention_di(o, do)

    per = (2 * B * S * H * hd + 2 * B * Sk * KV * hd) * 2 + 2 * B * H * S * 4
    asets = [attn_set() for _ in range(max(2, int(120e6 // per) + 1))]
    pairs = B * H * (S * (S + 1) // 2 if causal else S * Sk)   # live pairs
    plain = {k: plain_flash_bwd(M, k) for k in ("flash_bwd_dq", "flash_bwd_dkv")}

    # the library yardstick: SDPA's backward (dq, dk, dv together) on every
    # input set, its forward run once beforehand on the stream the graph
    # then captures
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sdpa_sets = []
        for q, k, v, do, _, _ in asets:
            ins = tuple(t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            o_s = F.scaled_dot_product_attention(*ins, is_causal=causal, enable_gqa=H != KV)
            sdpa_sets.append((ins, o_s, do.transpose(1, 2)))
    torch.cuda.current_stream().wait_stream(side)

    def sdpa_bwd(i):
        ins, o_s, do_s = sdpa_sets[i]
        return torch.autograd.grad(o_s, ins, do_s, retain_graph=True)

    sdpa_dq = sdpa_bwd(0)[0].transpose(1, 2)
    dq0 = M.FA.flash_bwd_dq(*asets[0], causal=causal)
    sdpa_err = rel_err(torch, sdpa_dq.float(), dq0)
    check(sdpa_err <= 2e-2, f"SDPA backward yardstick disagrees with flash_bwd_dq ({sdpa_err:g})")
    sdpa_ms = graph_ms(torch, sdpa_bwd, len(asets), stream=side)
    sdpa_eager_ms = eager_ms(torch, sdpa_bwd, len(asets))
    del sdpa_sets
    dkv_bytes = per + 2 * B * Sk * KV * hd * 4
    dq_bytes = per + B * S * H * hd * 4
    out = {}
    for name, bytes_, flops in (("flash_bwd_dq", dq_bytes, 6.0 * pairs * hd),
                                ("flash_bwd_dkv", dkv_bytes, 8.0 * pairs * hd)):
        fn = getattr(M.FA, name)
        out[name] = dict(
            ms=graph_ms(torch, lambda i: fn(*asets[i], causal=causal), len(asets)),
            plain_ms=graph_ms(torch, lambda i: plain[name](*asets[i], causal=causal),
                              len(asets)),
            library_ms=sdpa_ms, library_eager_ms=sdpa_eager_ms,
            library="SDPA backward (dq, dk, dv together)", sdpa_rel_err=sdpa_err,
            eager_ms=eager_ms(torch, lambda i: fn(*asets[i], causal=causal), len(asets)),
            bound=bound(bytes_, bf16_ops=flops), calls=1,
            work=f"one layer's call: ({B}, {S}{'' if Sk == S else f' x {Sk}'}, {H}/{KV}, "
                 f"{hd}), {'causal' if causal else 'no mask'}, {str(bf).replace('torch.', '')}")
    return out, asets


def time_train_kernels(torch, M, cfg, dev, seed):
    """The training path's kernels at its shapes, one layer's calls: the
    int8 dgrad pair at 2048 rows (5 fused calls, 2 transposed), the flash
    backward pair at 8 x 256 causal bf16 (one call each); each with its
    plain version, a library call where one exists and the bound. Also the
    two forward kernels whose library call has a train-shape yardstick:
    ``int8_matmul_dequant`` at w_down's 2048 x 2560 -> 960 (``torch._int_mm``
    + scale) and ``flash_fwd`` at 8 x 256 causal (SDPA)."""
    import torch.nn.functional as F
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    R = TRAIN_ROWS
    D, FF = cfg.d_model, cfg.d_ff
    KVd = cfg.n_kv_heads * cfg.hd
    fused = [(D, D), (KVd, D), (KVd, D), (D, D), (D, FF)]     # (M, N): wq wk wv wo w_down
    two = [(FF, D), (FF, D)]                                  # w_up, w_gate

    def one_set():
        s = {"fused": [], "two": []}
        for Mw, N in fused:
            w_q, s_w = KOPS.tensor_quantize(weight(torch, gen, N, Mw, dev))
            s["fused"].append((activations(torch, gen, R, Mw, dev), w_q, s_w))
        for Mw, N in two:
            w_q, s_w = KOPS.tensor_quantize(weight(torch, gen, N, Mw, dev))
            g_q, s_g = KOPS.row_quantize(activations(torch, gen, R, Mw, dev))
            s["two"].append((g_q, w_q, s_g * REF.div(s_w, 127.0 * 127.0)))
        x_q, s_x = KOPS.row_quantize(activations(torch, gen, R, FF, dev))
        w_q, s_w = KOPS.tensor_quantize(weight(torch, gen, FF, D, dev))
        s["down"] = (x_q, w_q, s_x * REF.div(s_w, 127.0 * 127.0))
        return s

    per_set = (sum(R * m * 2 + m * n for m, n in fused) + sum(R * m + m * n for m, n in two)
               + R * FF + FF * D)
    sets = [one_set() for _ in range(max(2, int(120e6 // per_set) + 1))]
    torch.cuda.synchronize()

    def int_mm(g_q, w_q, scale):
        return (torch._int_mm(g_q, w_q.t()).float() * scale).to(torch.bfloat16)

    def int_mm_fwd(x_q, w_q, scale):
        return (torch._int_mm(x_q, w_q).float() * scale).to(torch.bfloat16)

    g_q, w_q, sc = sets[0]["two"][0]
    check(torch.equal(int_mm(g_q, w_q, sc), KOPS.int8_matmul_dequant_t(g_q, w_q, sc)),
          "torch._int_mm yardstick disagrees with int8_matmul_dequant_t")
    check(torch.equal(int_mm_fwd(*sets[0]["down"]), KOPS.int8_matmul_dequant(*sets[0]["down"])),
          "torch._int_mm yardstick disagrees with int8_matmul_dequant")
    out = {}
    # name: (calls, call(set, ops module), library call, bytes, int8 ops, f32 ops)
    work = {
        "fused_switchback_dgrad": (
            len(fused), lambda s, op: [op.fused_switchback_dgrad(*a) for a in s["fused"]], None,
            sum(R * m * 2 + m * n + 4 + R * n * 2 for m, n in fused),
            sum(2 * R * m * n for m, n in fused), sum(4 * R * m for m, _ in fused)),
        "int8_matmul_dequant_t": (
            len(two), lambda s, op: [op.int8_matmul_dequant_t(*a) for a in s["two"]],
            lambda s: [int_mm(*a) for a in s["two"]],
            sum(R * m + m * n + R * 4 + R * n * 2 for m, n in two),
            sum(2 * R * m * n for m, n in two), 0),
        "int8_matmul_dequant": (
            1, lambda s, op: op.int8_matmul_dequant(*s["down"]),
            lambda s: int_mm_fwd(*s["down"]), R * FF + FF * D + R * 4 + R * D * 2,
            2 * R * FF * D, 0),
    }
    out.update(time_work(torch, KOPS, REF, sets, work,
                         lambda c: f"one layer's {c} call(s) at {R} rows"))
    add_two_step(torch, KOPS, REF, out["fused_switchback_dgrad"], sets, lambda s: s["fused"], True)
    del sets

    # the flash backward pair at one layer's shape: 8 x 256, causal, bf16
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, S = TRAIN_BATCH, TRAIN_SEQ
    bwd, asets = time_flash_bwd(torch, M, gen, dev, B, S, H, KV, hd, True)
    out.update(bwd)
    pairs = B * H * S * (S + 1) // 2                          # causal live pairs

    # flash_fwd at the same shape beside SDPA's forward
    def sdpa_fwd(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True,
                                              enable_gqa=True).transpose(1, 2)

    fwd_err = rel_err(torch, sdpa_fwd(*asets[0][:3]),
                      M.FA.flash_fwd_lse(*asets[0][:3], causal=True)[0])
    check(fwd_err <= 2e-2, f"SDPA yardstick disagrees with flash_fwd ({fwd_err:g})")
    plain_fwd = plain_flash_fwd(M)
    kern_fwd = lambda i: M.FA.flash_fwd_lse(*asets[i][:3], causal=True)
    out["flash_fwd"] = dict(
        ms=graph_ms(torch, kern_fwd, len(asets)),
        plain_ms=graph_ms(torch, lambda i: plain_fwd(*asets[i][:3], causal=True), len(asets)),
        library_ms=graph_ms(torch, lambda i: sdpa_fwd(*asets[i][:3]), len(asets)),
        library="SDPA forward (is_causal, enable_gqa)", sdpa_rel_err=fwd_err,
        eager_ms=eager_ms(torch, kern_fwd, len(asets)),
        bound=bound((2 * B * S * H * hd + 2 * B * S * KV * hd) * 2 + B * H * S * 4,
                    bf16_ops=4.0 * pairs * hd), calls=1,
        work=f"one layer's call: {B} x {S} tokens, causal, bf16")
    print("[timing] train kernels:", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 13-18: CLIP ViT-H/14, the paper's own model, in the four int8 modes
# ---------------------------------------------------------------------------

CLIP_MODES = ("int8_switchback", "int8_switchback_m", "int8_switchback_q", "int8_llm")
# the CLIP training path: SyntheticCLIP batches of 32 image-text pairs at
# 224 px, patch dropout 0.5 (129 vision tokens with the CLS), 77 text tokens
CLIP_BATCH = 32
CLIP_STEPS = 3            # timed steps per mode, after one warm-up step
# phases 15 and 20's depth, vision + text: a quarter of ViT-H/14's 32 + 24,
# to keep the script inside its time (their checks are exact at any depth)
CLIP_TRAIN_LAYERS = (8, 6)
# the 2 + 2 layer comparisons of phases 16 and 17: batch (pairs)
CHECK_BATCH, CPU_BATCH = 8, 4


def clip_linears(cfg):
    """(K, M, needs Ẋ) of every SwitchBack linear of one CLIP train step:
    the patch embedding (its input is data: no Ẋ), then each vision and
    text layer's wq, wk, wv, wo (W, W), w_up (W, FF) and w_down (FF, W)."""
    out = [(3 * cfg.patch_size ** 2, cfg.vision_width, False)]
    for L, W, FF in ((cfg.vision_layers, cfg.vision_width, cfg.vision_ff),
                     (cfg.text_layers, cfg.text_width, cfg.text_ff)):
        out += ([(W, W, True)] * 4 + [(W, FF, True), (FF, W, True)]) * L
    return out


def clip_launches_per_step(cfg, mode, fused_max):
    """Each wrapper's launches in one CLIP train step, worked out from the
    layer shapes and the variant's kernel path (``core/switchback.py``):

    * int8_switchback: tensor_quantize(W); forward fused when K <= 2048,
      else row_quantize + int8_matmul_dequant; dgrad fused when M <= 2048,
      else row_quantize + int8_matmul_dequant_t;
    * int8_switchback_m: row_quantize(X), tensor_quantize(W),
      int8_matmul_dequant (never fused); the same dgrad;
    * int8_switchback_q / int8_llm: row_quantize(X), col_quantize(W), the
      colscale matmul; dgrad row_quantize(Ẏ), row_quantize(W), the
      transposed colscale matmul;
    * fp8: fp8 tensor_quantize_kt(W) (counted as fp8_tensor_quantize; its
      K-major copy is the forward's W, so transpose_bytes runs 0 times),
      row_quantize(X), fp8_matmul_dequant; dgrad row_quantize(Ẏ),
      fp8_matmul_dequant_t;
    * fp8_mixed: fp8 tensor_quantize_kt(W), block_quantize(X),
      fp8_mixed_matmul; dgrad block_quantize(Ẏ), fp8_mixed_matmul_t;
    * fp8_sim / fp8_switchback: none (plain products);
    * each layer of both towers: flash_fwd, flash_bwd_dq, flash_bwd_dkv."""
    c = dict.fromkeys(("tensor_quantize", "fused_switchback_fwd", "row_quantize",
                       "col_quantize", "int8_matmul_dequant", "int8_matmul_dequant_colscale",
                       "fused_switchback_dgrad", "int8_matmul_dequant_t",
                       "int8_matmul_dequant_colscale_t", "flash_fwd", "decode_fwd",
                       "flash_bwd_dq", "flash_bwd_dkv", *FP8_KERNELS, *OP_KERNELS), 0)
    colwise = mode in ("int8_switchback_q", "int8_llm")
    fp8 = {"fp8": ("fp8_row_quantize", "fp8_matmul_dequant", "fp8_matmul_dequant_t"),
           "fp8_mixed": ("fp8_block_quantize", "fp8_mixed_matmul", "fp8_mixed_matmul_t")}
    for K, Mw, dx in clip_linears(cfg):
        if mode in fp8:
            quant, fwd, dgrad = fp8[mode]
            c["fp8_tensor_quantize"] += 1
            c[quant] += 1 + dx
            c[fwd] += 1
            c[dgrad] += dx
            continue
        if mode.startswith("fp8"):
            continue
        if colwise:
            for k in ("row_quantize", "col_quantize", "int8_matmul_dequant_colscale"):
                c[k] += 1
        elif mode == "int8_switchback_m":
            for k in ("row_quantize", "tensor_quantize", "int8_matmul_dequant"):
                c[k] += 1
        else:
            c["tensor_quantize"] += 1
            if K <= fused_max:
                c["fused_switchback_fwd"] += 1
            else:
                c["row_quantize"] += 1
                c["int8_matmul_dequant"] += 1
        if not dx:
            continue
        if colwise:
            c["row_quantize"] += 2
            c["int8_matmul_dequant_colscale_t"] += 1
        elif Mw <= fused_max:
            c["fused_switchback_dgrad"] += 1
        else:
            c["row_quantize"] += 1
            c["int8_matmul_dequant_t"] += 1
    layers = cfg.vision_layers + cfg.text_layers
    c.update(flash_fwd=layers, flash_bwd_dq=layers, flash_bwd_dkv=layers)
    return c


# the CLIP path's optimizer settings (``train_parts``): lr 1e-3, warm-up 2
CLIP_OPT = dict(lr=1e-3, warmup=2)


def clip_batches(torch, cfg, n, batch, dev, seed):
    """``n`` SyntheticCLIP batches (32 latent classes) on ``dev``."""
    from repro_torch.data import SyntheticCLIP
    data = SyntheticCLIP(cfg.image_size, cfg.text_ctx, cfg.text_vocab, n_classes=32, seed=seed)
    out = []
    for _ in range(n):
        b = data.batch(batch)
        out.append({"images": torch.from_numpy(b["images"]).to(dev),
                    "texts": torch.from_numpy(b["texts"]).to(device=dev, dtype=torch.long)})
    return out


def clip_shapes(cfg):
    """Phase 13's table (see ``compare_linear_kernels``): per tower the
    rows of the main path (phase 15) at CLIP_BATCH, 4,128 vision (129
    tokens after patch dropout), 8,192 patches for the patch embedding
    (before dropout; no Ẋ) and 2,464 text, and ``{name: (K, M, needs Ẋ)}``;
    bf16 as the path runs, the vision tower in f32 too; all four modes."""
    from repro_torch.models.clip import n_kept_patches
    W, FF, Wt, FFt = cfg.vision_width, cfg.vision_ff, cfg.text_width, cfg.text_ff
    bf, both = ("bfloat16",), ("bfloat16", "float32")
    return [
        ("vision", CLIP_BATCH * (n_kept_patches(cfg) + 1), both, True, True,
         {"w_qkvo": (W, W, True), "w_up": (W, FF, True), "w_down": (FF, W, True)}),
        ("patch_embed", CLIP_BATCH * cfg.n_patches, bf, True, True,
         {"patch_embed": (3 * cfg.patch_size ** 2, W, False)}),
        ("text", CLIP_BATCH * cfg.text_ctx, bf, True, True,
         {"w_qkvo": (Wt, Wt, True), "w_up": (Wt, FFt, True), "w_down": (FFt, Wt, True)}),
    ]


def clip_flash_cases(cfg):
    """Phase 14's table (see ``smollm_flash_cases``): the vision tower's
    (32, 129, 16, 80) with no mask, its control fault the lanes past 64
    dropped, and the text tower's (32, 77, 16, 64) causal, its fault the
    mask dropped; no GQA."""
    from repro_torch.models.clip import n_kept_patches
    Sv, Hv, Ht, St = n_kept_patches(cfg) + 1, cfg.vision_heads, cfg.text_heads, cfg.text_ctx
    return [("vision", CLIP_BATCH, Sv, Sv, Sv, Hv, Hv, cfg.vision_width // Hv, False,
             lanes_fault),
            ("text", CLIP_BATCH, St, St, St, Ht, Ht, cfg.text_width // Ht, True, mask_fault)]


def clip_train(torch, M, cfg, dev, seed, modes=CLIP_MODES, tag="clip train"):
    """Phases 15 and 20: full-width CLIP ViT-H/14 through
    ``make_train_setup``, ``make_train_step`` and ``Trainer`` in each of
    ``modes`` (``int8_switchback`` and ``fp8_sim`` with zero-init
    layer-scale, the paper's recipe, the others with none):
    a warm-up step, then CLIP_STEPS timed steps with every launch counter
    zeroed just before and read just after, each exactly
    ``clip_launches_per_step`` x the steps; every loss finite; peak memory
    over the timed steps; then one step profiled. Returns per mode the
    readings and the counts."""
    from repro_torch.models import params as PRM
    from repro_torch.train import Trainer, init_train_state, loss_and_grads
    res, counts_by_mode = {}, {}
    probes = group_probes(torch, M, dev)
    for mode in modes:
        c = dataclasses.replace(cfg, layer_scale_init=0.0) if mode in ZERO_INIT_MODES else cfg
        bundle, policy, parallel, tc, step, opt, scaler = train_parts(torch, c, dev, mode=mode,
                                                                     **CLIP_OPT)
        t = time.perf_counter()
        params = PRM.init_params(bundle.param_specs, seed, device=dev)
        state = init_train_state(params, opt, scaler, seed=seed)
        batches = clip_batches(torch, c, 1 + CLIP_STEPS, CLIP_BATCH, dev, seed)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in _leaves(params))
        setup_s = time.perf_counter() - t
        del params
        trainer = Trainer(step, state, log_every=1000)
        # the trainer holds the only reference to the state, so the peak
        # below is the steps' own (the initial state, 11 GiB at full depth,
        # is not kept beside it)
        del state
        trainer.run(lambda i: batches[i], 1)                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts(M)
        t = time.perf_counter()
        trainer.run(lambda i: batches[i], CLIP_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launch_counts(M)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [h["loss"] for h in trainer.history]
        check(len(losses) == 1 + CLIP_STEPS and all(math.isfinite(x) for x in losses),
              f"CLIP {mode}: non-finite or missing losses {losses}")
        want = clip_launches_per_step(c, mode, M.KOPS.FUSED_MAX_CONTRACT)
        for k, per in want.items():
            check(per == 0 or counts[k] > 0, f"CLIP {mode}: {k} never launched")
            check(counts[k] == per * CLIP_STEPS,
                  f"CLIP {mode}: {k}: {counts[k]} launches in {CLIP_STEPS} steps, expected "
                  f"{per * CLIP_STEPS} ({per} per step)")
        prof = train_profile(torch, M, trainer, batches[1:], n_steps=1, rows=CLIP_BATCH,
                             tag=f"clip profile {mode}")
        groups = check_profile_groups(torch, M, dev, mode, probes)
        for g in PROFILE_IDLE_GROUPS.get(mode, ()):
            check(g not in prof["groups"], f"CLIP {mode}: the profile's group {g!r} ran on the "
                  f"path: {prof['groups'].get(g)}")
        check_one_kernel_a_call(prof, want, f"CLIP {mode} profile")
        # activation memory: the peak of one forward and backward (the
        # gradients included) above what the trainer holds, without the
        # optimizer's copies, which set the step's peak in every mode
        gc.collect()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = loss_and_grads(bundle, policy, parallel, trainer.state.params, batches[1],
                               patch_keep=bundle.patch_keep(trainer.state.rng))
        torch.cuda.synchronize()
        fwd_bwd = (torch.cuda.max_memory_allocated() - base) / 2**30
        del grads
        res[mode] = dict(layer_scale_init=c.layer_scale_init, n_params=n_params,
                         setup_s=setup_s, step_ms=wall / CLIP_STEPS * 1e3,
                         pairs_per_s=CLIP_STEPS * CLIP_BATCH / wall, losses=losses,
                         grad_norms=[h["grad_norm"] for h in trainer.history],
                         peak_memory_gib=peak, fwd_bwd_peak_gib_above_state=fwd_bwd,
                         launches_per_step={k: v / CLIP_STEPS for k, v in counts.items()},
                         profile_group_kernels=groups,
                         profile={k: prof[k] for k in ("step_ms", "device_ms_per_step",
                                                       "device_idle_share",
                                                       "cuda_launches_per_step", "groups")})
        counts_by_mode[mode] = counts
        print(f"[{tag}] {mode}: " + json.dumps({k: v for k, v in res[mode].items()
                                                if k != "profile"}))
        del trainer, batches, step, opt
        gc.collect()                 # the autograd graph's cycles hold card memory
        torch.cuda.empty_cache()
    print(f"[{tag}] peak memory GiB (step; one forward and backward above the state): "
          + json.dumps({m: [r["peak_memory_gib"], r["fwd_bwd_peak_gib_above_state"]]
                        for m, r in res.items()}))
    return res, counts_by_mode


def rolled_pos_embed(torch, tree, shift=-1):
    """The control fault of phases 16-17, a one-character slip: the vision
    tower reads its positional embedding one row off (the CLS takes row 1,
    patch i row i + 2, the last patch row 0). ``shift=1`` turns a
    parameter or gradient tree of the faulty run back into the sound
    run's row order, so every leaf is compared with its own."""
    pos = tree["visual"]["pos_embed"]
    return dict(tree, visual=dict(tree["visual"],
                                  pos_embed=torch.roll(pos, shift, dims=1).contiguous()))


# one CLIP train step at 2 + 2 layers (full width), kernels against plain
# versions under flash_scan in bf16: per-leaf max and mean |diff| of the
# gradient relative to the leaf's max. Each limit is the geometric mean of
# the worst sound reading and the smallest reading of the control fault
# (the positional embedding read one row off) over three seeds on an H100,
# one digit (the rule of phase 10; readings in PERF.md): max 1.22e-1
# against 1.36, mean 2.10e-2 against 1.91e-1. The loss is printed, not
# bounded: at random weights it sits at chance (ln 8), and the sound
# readings (up to 6.2e-4) overlap the fault's (from 3.5e-4). Two leaves are
# printed apart, not read per leaf: the key bias, whose exact gradient is 0
# (softmax ignores a per-query constant), and the 0-d logit_scale, whose
# gradient at chance is a sum that nearly cancels (sound readings up to
# 1.0e-1 of its own size). Under dense every kernel on the path is
# bit-equal to its plain version, so the step is.
CLIP_STEP_TOL = {"grad_max_rel_err": 4e-1, "grad_mean_rel_err": 6e-2}
CLIP_NOISE_LEAVES = ("['attn']['bk']", "['logit_scale']")


def slab_fault_fp8(torch, M):
    """Patches over ``plain_ops``'s fp8 matmuls: each reads one k32 slab of
    A one row off (``slab_fault``, phase 19's control fault: what a wrong
    kernel would do)."""
    def faulty(fn, i):
        def f(*a, **kw):
            a = list(a)
            a[i] = slab_fault(torch, a[i], 32 * (a[i].shape[1] // 64))
            return fn(*a, **kw)
        return f
    plain = plain_fp8(M)
    return [(M.F8, name, faulty(plain[name], 1 if "mixed" in name else 0))
            for name in MATMUL_FORMS]


def clip_whole_step(torch, M, cfg, dev, seed, modes=CLIP_MODES, tol=CLIP_STEP_TOL,
                    tag="clip whole step"):
    """Phases 16 and 21: one train step's loss and gradients at 2 + 2
    layers and full width, kernels against their plain versions swapped
    in, in each of ``modes`` from CHECK_SEEDS seeds (layer_scale_init None:
    with γ = 0 every block linear's Ẏ is exactly 0 at step 0), within
    ``tol``; the control fault (``rolled_pos_embed``, plain) outside on at
    least one key. Under dense attention the int8 modes are bit-equal at
    one seed; the fp8 modes (FP8_KERNEL_MODES), whose matmuls agree with
    their plain versions to F8REF.matmul_bound, are held to ``tol`` at
    every seed under both attentions, with a second control fault, the
    plain fp8 matmuls reading one k32 slab of A a row off
    (``slab_fault_fp8``), and every key of ``tol`` must see each fault.
    Every reading is printed before any is checked."""
    from repro_torch.models import params as PRM
    from repro_torch.models.clip import patch_keep_sampler
    from repro_torch.train import loss_and_grads
    small = dataclasses.replace(cfg, vision_layers=2, text_layers=2)
    draw = patch_keep_sampler(small)
    seeds = check_seeds(seed, 7)
    res, bitwise, finite = {}, {}, {}
    for s in seeds:
        params = PRM.init_params(param_specs_of(small), s, device=dev)
        fault_params = rolled_pos_embed(torch, params)
        batch = clip_batches(torch, small, 1, CHECK_BATCH, dev, s)[0]
        keep = draw(torch.Generator(device=dev).manual_seed(s))
        for mode in modes:
            fp8 = mode in FP8_KERNEL_MODES
            for impl in ("flash_scan", "dense"):
                if impl == "dense" and not fp8 and s != seeds[0]:
                    continue
                bundle, policy, parallel, *_ = train_parts(torch, small, dev, mode=mode,
                                                           impl=impl, **CLIP_OPT)
                run = lambda p: loss_and_grads(bundle, policy, parallel, p, batch,
                                               patch_keep=keep)
                kern = run(params)
                with plain_ops(M, flash=impl == "flash_scan"):
                    plain = run(params)
                    if impl == "dense" and not fp8:
                        bitwise[mode] = bool(torch.equal(kern[1], plain[1])) and all(
                            torch.equal(a, b) for a, b in zip(PRM.tree_leaves(kern[0]),
                                                              PRM.tree_leaves(plain[0])))
                        del kern, plain
                        continue
                    rolled = run(fault_params)
                    faults = {"pos_embed rolled": (rolled_pos_embed(torch, rolled[0], 1),
                                                   *rolled[1:])}
                    if fp8:
                        with swapped(slab_fault_fp8(torch, M)):
                            faults["fp8 matmuls read a k32 slab a row off"] = run(params)
                name = f"{mode}_seed{s}" + ("_dense" if impl == "dense" else "")
                res[name], finite[name] = step_reading(torch, kern, plain, faults,
                                                       CLIP_NOISE_LEAVES)
                res[name].update(tolerance=tol,
                                 logit_scale_grad=[float(g[0]["logit_scale"])
                                                   for g in (kern, plain)])
                del kern, plain, rolled, faults
    print(f"[{tag}]", json.dumps(dict(dense_bitwise=bitwise, **res)))
    for mode, ok in bitwise.items():
        check(ok, f"{tag} {mode}, dense: kernels != plain")
    check_readings(tag, res, finite, every_key=any(m in FP8_KERNEL_MODES for m in modes))
    return res


# card against CPU (``card_vs_cpu``) at 2 + 2 layers and full width, in
# the int8 modes (phase 17): (loss relative per step, the final parameters'
# worst per-leaf mean |diff| over the leaf's max, the leaves that start at
# zero left out). The parameters' per-leaf max is printed, not bounded
# (sound up to 5.4e-2, the fault from 5.6e-2). Limits by the rule of phase
# 10 over three seeds and both modes on an H100, the fault then run on the
# CPU (readings in PERF.md): loss 3.0e-3 against 7.5e-2, parameter mean
# 1.15e-3 against 1.19e-2.
CLIP_CARD_CPU_TOL = {"loss_rel_err": 1e-2, "param_mean_rel_err": 4e-3}


def causal_mask_dropped(M):
    """The control fault a flash kernel that ignores its mask would give:
    the model's attention called with ``causal=False`` (CLIP's text tower
    then attends to later tokens), forward and backward alike."""
    orig = M.FA.flash_attention
    return swapped([(M.FA, "flash_attention",
                     lambda q, k, v, *, causal: orig(q, k, v, causal=False))])


def clip_faults(torch, M):
    """The CLIP path's control faults for ``card_vs_cpu``, by name: the
    positional embedding read one row off (in the parameters, on the card);
    the plain fp8 matmuls reading one k32 slab of A a row off (phase 21's
    ``slab_fault_fp8``: what a wrong fp8 kernel would do) and the text
    tower's causal mask dropped (what a wrong flash kernel would do), both
    patched into the CPU's plain versions."""
    return {
        "pos_embed rolled (card)": control_fault(
            None, params=lambda t: rolled_pos_embed(torch, t),
            back=lambda t: rolled_pos_embed(torch, t, 1)),
        "fp8 matmuls read a k32 slab a row off (CPU)": control_fault(
            "cpu", lambda: swapped(slab_fault_fp8(torch, M))),
        "text causal mask dropped (CPU)": control_fault("cpu", lambda: causal_mask_dropped(M)),
    }


# phase 22, CLIP's fp8 modes card against CPU (``card_vs_cpu``): the final
# parameters' worst per-leaf mean only. The loss is printed, not bounded: a
# third step that spikes turns the attention's last bits into percents, so
# no loss limit separates sound runs from faulty ones (tools/gate_seeds.py
# over 16 seeds on an H100, the tree's kernels and the card's plain
# versions: sound loss readings up to 4.0e-2, the three faults from 5.1e-3;
# over the steps before the third, 8.4e-3 against 2.0e-3). The parameter
# reading separates all three faults at every seed: sound up to 5.09e-3
# (3.29e-3 with every plain version on the card), the faults from 1.16e-2
# (pos_embed rolled), 1.19e-2 (the fp8 slab fault) and 7.85e-3 (the text
# mask dropped). Limit by the rule of phase 10: the geometric mean of
# 5.09e-3 and 7.85e-3, 6.3e-3, one digit (readings in PERF.md).
CLIP_FP8_CARD_CPU_TOL = {"param_mean_rel_err": 6e-3}
CLIP_FP8_FAULTS = ("pos_embed rolled (card)", "fp8 matmuls read a k32 slab a row off (CPU)",
                   "text causal mask dropped (CPU)")


def clip_check_path(torch, M, cfg, modes=("int8_switchback_q", "int8_llm"),
                    tol=CLIP_CARD_CPU_TOL, tag="clip card vs cpu", seed_offset=11,
                    faults=("pos_embed rolled (card)",)):
    """Phases 17 and 22's path: CLIP at 2 + 2 layers in ``modes``, those
    that run a slice's new kernels (the seeds take them in turn),
    SyntheticCLIP batches of CPU_BATCH pairs with each step's kept patches
    drawn beforehand, the control faults ``faults`` of ``clip_faults``."""
    from repro_torch.models.clip import patch_keep_sampler
    small = dataclasses.replace(cfg, vision_layers=2, text_layers=2)
    draw = patch_keep_sampler(small)
    table = clip_faults(torch, M)
    return types.SimpleNamespace(
        tag=tag, small=small, modes=modes, seed_offset=seed_offset, tol=tol, opt=CLIP_OPT,
        batches=lambda n, where, s: clip_batches(torch, small, n, CPU_BATCH, where, s),
        keeps=lambda n, s: [draw(torch.Generator().manual_seed(s + i)) for i in range(n)],
        faults={name: table[name] for name in faults})


def time_clip_kernels(torch, M, cfg, dev, seed):
    """Phase 18: the new kernels at CLIP's shapes, one vision layer's calls
    of the column-wise modes at batch 32 (4,128 rows): the colscale forward
    of the six linears and their transposed colscale dgrad; each with its
    plain version, the library yardstick (``torch._int_mm`` plus the rank-1
    scale) and the bound. Then at each tower's layer (vision 4,128 rows,
    text 2,464, the patch embedding's 8,192 x 588 -> 1,280) the column-wise
    modes' ``row_quantize`` and ``col_quantize`` calls
    (``time_int8_quantizers``), the tensor-wise modes' ``tensor_quantize``
    of the layer's weights (``time_tensor_quantize``) and the fused pair
    with the two-step yardstick (``time_fused``)."""
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    _, R, _, _, _, shapes = clip_shapes(cfg)[0]                         # the vision tower
    lin = [shapes[k][:2] for k in ("w_qkvo",) * 4 + ("w_up", "w_down")]    # (K, M)

    def one_set():
        s = {"fwd": [], "dgrad": []}
        for K, Mw in lin:
            w = weight(torch, gen, K, Mw, dev)
            w_q, s_w = KOPS.col_quantize(w)
            x_q, s_x = KOPS.row_quantize(activations(torch, gen, R, K, dev))
            g_q, s_g = KOPS.row_quantize(activations(torch, gen, R, Mw, dev))
            w_n, s_n = KOPS.row_quantize(w)
            s["fwd"].append((x_q, w_q, REF.div(s_x, 127.0 * 127.0), s_w))
            s["dgrad"].append((g_q, w_n, REF.div(s_g, 127.0 * 127.0), s_n.reshape(1, -1)))
        return s

    per_set = sum(3 * K * Mw + 2 * R * (K + Mw) for K, Mw in lin)
    sets = [one_set() for _ in range(max(2, int(120e6 // per_set) + 1))]
    torch.cuda.synchronize()

    def int_mm(x_q, w_q, row, col):
        return (torch._int_mm(x_q, w_q).float() * (row * col)).to(torch.bfloat16)

    def int_mm_t(g_q, w_n, row, col):
        return (torch._int_mm(g_q, w_n.t()).float() * (row * col)).to(torch.bfloat16)

    a, b = sets[0]["fwd"][4], sets[0]["dgrad"][4]
    check(torch.equal(int_mm(*a), KOPS.int8_matmul_dequant(a[0], a[1], a[2], col_scale=a[3])),
          "torch._int_mm yardstick disagrees with the colscale int8_matmul_dequant")
    check(torch.equal(int_mm_t(*b), KOPS.int8_matmul_dequant_t(b[0], b[1], b[2], col_scale=b[3])),
          "torch._int_mm yardstick disagrees with the colscale int8_matmul_dequant_t")
    work = {
        # name: (calls, call(set, ops module), library call, bytes, int8 ops, f32 ops)
        "int8_matmul_dequant_colscale": (
            len(lin),
            lambda s, op: [op.int8_matmul_dequant(x, w, r, col_scale=c) for x, w, r, c in s["fwd"]],
            lambda s: [int_mm(*t) for t in s["fwd"]],
            sum(R * K + K * Mw + 4 * R + 4 * Mw + 2 * R * Mw for K, Mw in lin),
            sum(2 * R * K * Mw for K, Mw in lin), sum(2 * R * Mw for _, Mw in lin)),
        "int8_matmul_dequant_colscale_t": (
            len(lin), lambda s, op: [op.int8_matmul_dequant_t(g, w, r, col_scale=c)
                           for g, w, r, c in s["dgrad"]],
            lambda s: [int_mm_t(*t) for t in s["dgrad"]],
            sum(R * Mw + K * Mw + 4 * R + 4 * K + 2 * R * K for K, Mw in lin),
            sum(2 * R * K * Mw for K, Mw in lin), sum(2 * R * K for K, _ in lin)),
    }
    out = time_work(torch, KOPS, REF, sets, work,
                    lambda c: f"one vision layer's {c} calls at {R} rows (batch {CLIP_BATCH})")
    del sets
    for tower, rows, _, _, _, lins in clip_shapes(cfg):
        got = time_int8_quantizers(torch, M, gen, dev, int8_quantizer_calls(lins, rows),
                                   f"one {tower} layer at {rows} rows")
        for name, r in got.items():
            out.setdefault(name, {})[tower] = r
        # int8_switchback's and _m's tensor_quantize of the layer's weights
        out.setdefault("tensor_quantize", {})[tower] = time_tensor_quantize(
            torch, KOPS.tensor_quantize, REF.tensor_quantize, gen, dev, tower_weights(lins),
            f"one {tower} layer's weights")
    # the fused pair (int8_switchback) at each tower's layer: the forward of
    # every linear whose K fits FUSED_MAX_CONTRACT, the dgrad of every one
    # whose output width does; the patch embedding's forward alone
    for tower, rows, _, _, _, lins in clip_shapes(cfg):
        fwd, dgrad = fused_calls(clip_layer(lins), KOPS.FUSED_MAX_CONTRACT)
        got = time_fused(torch, M, gen, dev, rows, fwd, dgrad,
                         lambda c, t=tower, r=rows: f"one {t} layer's {c} calls at {r} rows")
        for name, r in got.items():
            out.setdefault(name, {})[tower] = r
        int8_rates(f"fused pair, CLIP {tower}", got)
    out.update(time_clip_flash(torch, M, cfg, dev, seed + 43))
    print("[timing] clip kernels:", json.dumps(out))
    return out


def time_clip_flash(torch, M, cfg, dev, seed, dt=None):
    """The flash kernels at CLIP's two attention shapes of phase 14, one
    layer's call each, in ``dt`` (default bf16, as the int8 and fp8 paths
    run; f16 under the FP16 policy): the vision tower's (32, 129, 16, 80)
    with no mask and the text tower's (32, 77, 16, 64) causal
    (``time_flash_cases``). Returns {kernel: {tower: ...}}."""
    return time_flash_cases(torch, M, clip_flash_cases(cfg), dev, seed, dt)


def time_flash_cases(torch, M, cases, dev, seed, dt=None, backward=True):
    """The flash kernels at ``cases`` (``compare_flash_train``'s form), one
    layer's call each, in ``dt`` (default bf16). ``flash_fwd``: the kernel,
    its plain version, SDPA and the bound (bytes against the live pairs'
    matmul operations at the bf16 peak); with ``backward`` the backward
    pair as ``time_flash_bwd``. Returns {kernel: {tower: ...}}."""
    import torch.nn.functional as F
    dt = dt or torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    plain = plain_flash_fwd(M)
    out = {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for tower, B, S, Sk, _, H, KV, hd, causal, _ in cases:
        def make():
            return tuple(torch.randn(shape, generator=gen, device=dev).to(dt)
                         for shape in ((B, S, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), is_causal=causal,
                                                  enable_gqa=H != KV).transpose(1, 2)

        qkv_bytes = (B * S * H * hd + 2 * B * Sk * KV * hd) * 2
        sets = [make() for _ in range(max(2, int(120e6 // qkv_bytes) + 1))]
        err = rel_err(torch, sdpa(*sets[0]), M.FA.flash_fwd_lse(*sets[0], causal=causal)[0])
        check(err <= 2e-2, f"SDPA yardstick disagrees with flash_fwd at {tower} ({err:g})")
        pairs = B * H * (S * (S + 1) // 2 if causal else S * Sk)
        n = len(sets)
        out["flash_fwd"][tower] = dict(
            ms=graph_ms(torch, lambda i: M.FA.flash_fwd_lse(*sets[i], causal=causal), n),
            plain_ms=graph_ms(torch, lambda i: plain(*sets[i], causal=causal), n),
            library_ms=graph_ms(torch, lambda i: sdpa(*sets[i]), n),
            eager_ms=eager_ms(torch, lambda i: M.FA.flash_fwd_lse(*sets[i], causal=causal), n),
            bound=bound(qkv_bytes + B * S * H * hd * 2 + B * H * S * 4,
                        bf16_ops=4.0 * pairs * hd),
            sdpa_rel_err=err, calls=1,
            work=f"one {tower} layer's call: ({B}, {S}{'' if Sk == S else f' x {Sk}'}, "
                 f"{H}/{KV}, {hd}), {'causal' if causal else 'no mask'}, "
                 f"{str(dt).replace('torch.', '')}")
        del sets
        if backward:
            bwd, asets = time_flash_bwd(torch, M, gen, dev, B, S, H, KV, hd, causal, dt, Sk)
            del asets
            for name, r in bwd.items():
                out[name][tower] = r
    return out


# ---------------------------------------------------------------------------
# phases 19-23: CLIP ViT-H/14 in the four fp8 modes, on the fp8 kernels
# ---------------------------------------------------------------------------

CLIP_FP8_MODES = ("fp8_sim", "fp8", "fp8_mixed", "fp8_switchback")
# the modes whose linears run the fp8 kernels (the other two are plain
# f32 products of fp8 values, the paper's simulation)
FP8_KERNEL_MODES = ("fp8", "fp8_mixed")
# zero-init layer-scale, the paper's recipe: int8_switchback and fp8_sim
ZERO_INIT_MODES = ("int8_switchback", "fp8_sim")
# the fp8 matmul kernels against their plain versions: per output within
# F8REF.matmul_bound (a worst case, from the accumulator probe's widths) and,
# at F8TC.check_rows, bit-equal to F8TC, the model of their tensor-core
# arithmetic; the control faults (one k32 slab of A read one row off; for
# fp8_mixed the fallback bits dropped) at least FAULT_MARGIN output ulps
# off the model
MATMUL_FORMS = ("fp8_matmul_dequant", "fp8_matmul_dequant_t", "fp8_mixed_matmul",
                "fp8_mixed_matmul_t")


def fp8_activations(torch, gen, R, K, dev, dtype, outliers):
    """Random rows over several binades; row 1 holds exact fp8 ties at
    scale 1 (multiples of 1/64 in [-1, 1]: the midpoints of both formats'
    grids in [1/4, 1)), row 2 is all zero, and rows 128-255 of the first
    128 columns an all-zero tile. With ``outliers`` the first 4 columns of
    rows 256-383 are 1,000x (outlier channels: their tile falls back to
    bf16 in fp8_mixed, and fp8 at its scale would flush the tile's other
    values) and the last element is 500."""
    x = torch.randn((R, K), generator=gen, device=dev) * 3
    x = x * torch.exp(torch.empty((R, 1), device=dev).uniform_(-4, 4, generator=gen))
    x[1] = ((torch.arange(K, device=dev) % 129) - 64).float() / 64
    x[2] = 0.0
    if R > 256:
        x[128:256, :128] = 0.0
    if outliers and R > 384:
        x[256:384, :4] *= 1000.0
        x[-1, -1] = 500.0
    return x.to(dtype)


def bound_share(torch, got, want, bnd, where=None):
    """The largest |got - want| as a share of the per-output bound (over
    the outputs ``where`` is true, when given)."""
    r = (got.double() - want.double()).abs() / bnd
    r = r if where is None else r[where]
    return float(r.max()) if r.numel() else 0.0


def model_ulps(torch, F8REF, got, model):
    """The largest |got - model| in ulps of the output type at |model|."""
    return float(((got.double() - model.double()).abs() / F8REF.ulp(model, model.dtype)).max())


def slab_fault(torch, a_q, k0):
    """A with its k32 slab at k0 read one row off (row r takes row r + 1)."""
    f = a_q.view(torch.uint8).clone()
    f[:, k0:k0 + 32] = torch.roll(f[:, k0:k0 + 32], -1, dims=0)
    return f.view(a_q.dtype)


def as_bits(torch, t):
    """An fp8 tensor as its bytes (so that equality is bitwise), else itself."""
    return t.view(torch.uint8) if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2) else t


def compare_fp8_kernels(torch, M, table, dev, seed):
    """Phase 19: every fp8 kernel of the fp8 and fp8_mixed modes against its
    plain version at the shapes the main path (phase 20) gives it:
    ``table`` as ``clip_shapes`` (every weight of both towers at batch 32:
    4,128 vision rows, 8,192 patch rows at K = 588, 2,464 text rows), and
    the ragged 37 x 130 -> 70 of the cuda tests. Per linear:
    ``tensor_quantize(W)`` in E4M3, ``transpose_bytes`` of it (an op entry
    point) and ``tensor_quantize_kt(W)`` (the path's quantizer: q and the
    state the flat kernel's bits, q_k ``transpose_bytes``' bytes); per dtype
    the forward (``row_quantize`` E4M3 + ``fp8_matmul_dequant``;
    ``block_quantize`` + ``fp8_mixed_matmul``) and, where the layer has an
    input gradient, the dgrad (``row_quantize`` E5M2 +
    ``fp8_matmul_dequant_t``; ``block_quantize`` E5M2 +
    ``fp8_mixed_matmul_t``), on two inputs: rows of scales e^-4..e^4 with
    fp8 ties, an all-zero row, an all-zero tile and outlier tiles that fall
    back, and rows of one scale. The quantizers and transpose_bytes must be
    bit-equal; the four matmul forms within ``F8REF.matmul_bound`` of their
    plain versions per output and, at ``F8TC.check_rows``, bit-equal to the
    model ``F8TC``, from which their control faults (one k32 slab of A read
    one row off; for fp8_mixed the fallback bits dropped) lie at least
    FAULT_MARGIN output ulps off; both forwards given the fold's ``w_k``
    bit-equal to the same call through ``transpose_bytes``; on inputs from
    ``F8REF.exact_entries`` (a
    checkerboard of fallback tiles for the mixed forms) all four bit-equal
    to their plain versions; each run twice gives the same bits. Returns per
    kernel the largest |kernel - plain| (the quantizers' decoded values), the
    matmul readings by form (the worst share of the bound; the faults'
    smallest distance from the model in ulps) and the number of
    comparisons; the faults' shares of the bound over the outputs that are
    not 0, on both inputs, are printed."""
    F8, F8REF, F8TC = M.F8, M.F8REF, M.F8TC
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = dict.fromkeys(FP8_KERNELS, 0.0)
    share = dict.fromkeys(MATMUL_FORMS, 0.0)
    fault = dict.fromkeys(MATMUL_FORMS, math.inf)
    mixed = dict(tiles=0, fallback_tiles=0, exact_cases=0, model_outputs=0, w_k_forwards=0)
    n = 0

    def twice(fn, what):
        a, b = fn(), fn()
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            check(torch.equal(as_bits(torch, x), as_bits(torch, y)), f"{what}: two launches differ")
        return a

    def quantized(key, name, args, what):
        nonlocal n
        got = twice(lambda: getattr(F8, name)(*args), f"{key} {what}")
        want = getattr(F8REF, name)(*args)
        for g, w, part in zip(got, want, ("fp8", "state")):
            ok = g.dtype == w.dtype and g.shape == w.shape and torch.equal(
                as_bits(torch, g), as_bits(torch, w))
            worst[key] = max(worst[key], max_abs_diff(torch, g.float(), w.float()))
            check(ok, f"{key} {what} {part}: kernel != plain")
            n += 1
        return got

    def transposed(w_q, what):
        nonlocal n
        got = twice(lambda: F8.transpose_bytes(w_q), f"fp8_transpose_bytes {what}")
        check(got.dtype == torch.uint8 and torch.equal(got, w_q.view(torch.uint8).t().contiguous()),
              f"fp8_transpose_bytes {what}: kernel != w_q.t().contiguous()")
        n += 1

    def folded(w, w_q, s_w, what):
        """The fold, tensor_quantize_kt(W): q and state the flat kernel's
        bits (held to the plain version), q_k its bytes K-major, as both
        transpose_bytes and the plain copy give them; its q_k."""
        nonlocal n
        q, s_, w_k = twice(lambda: F8.tensor_quantize_kt(w, "e4m3"),
                           f"fp8_tensor_quantize (kt) {what}")
        check(torch.equal(as_bits(torch, q), as_bits(torch, w_q)) and torch.equal(s_, s_w),
              f"fp8_tensor_quantize (kt) {what}: q or the state != tensor_quantize's")
        check(w_k.dtype == torch.uint8 and torch.equal(w_k, F8.transpose_bytes(w_q))
              and torch.equal(w_k, w_q.view(torch.uint8).t().contiguous()),
              f"fp8_tensor_quantize (kt) {what}: q_k != q's bytes transposed")
        n += 1
        return w_k

    def through_w_k(got, fn, what):
        """A forward given the fold's w_k: the bits of the same call through
        transpose_bytes."""
        nonlocal n
        check(torch.equal(fn(), got), f"{what}: the forward given the fold's w_k != "
              "through transpose_bytes")
        mixed["w_k_forwards"] += 1
        n += 1

    readings = []

    def bounded(key, got, want, bnd, model, rows, faults, what):
        """got within the bound of want and equal to the model at ``rows``;
        each fault (kind: output) FAULT_MARGIN ulps off the model there:
        recorded here, checked once every reading is printed."""
        nonlocal n
        r = bound_share(torch, got, want, bnd)
        equal = bool(torch.equal(got[rows], model))
        worst[key] = max(worst[key], max_abs_diff(torch, got, want))
        share[key] = max(share[key], r)
        check(got.dtype == want.dtype and got.shape == want.shape, f"{key} {what}: dtype/shape")
        for kind, faulty in faults.items():
            f = model_ulps(torch, F8REF, faulty[rows], model)
            fault[key] = min(fault[key], f)
            readings.append((key, kind, str(got.dtype), what, r, equal, f,
                             bound_share(torch, faulty, want, bnd, want != 0)))
        mixed["model_outputs"] += model.numel()
        n += 1

    def dequant(a_q, w_q, rs, tw, dt, what, w_k=None):
        key = "fp8_matmul_dequant_t" if tw else "fp8_matmul_dequant"
        fn = getattr(F8, key)
        got = twice(lambda: fn(a_q, w_q, rs, out_dtype=dt), f"{key} {what}")
        if w_k is not None:
            through_w_k(got, lambda: fn(a_q, w_q, rs, out_dtype=dt, w_k=w_k), f"{key} {what}")
        plain = lambda a: F8REF.fp8_matmul_dequant(a, w_q, rs, transpose_w=tw, out_dtype=dt)
        want = plain(a_q)
        rows = torch.tensor(F8TC.check_rows(a_q.shape[0]), device=dev)
        model = F8TC.dequant_rows(a_q, w_q, rs, rows, transpose_w=tw, out_dtype=dt)
        k0 = 32 * (a_q.shape[1] // 64)
        bounded(key, got, want, F8REF.matmul_bound(want, a_q, w_q, rs, transpose_w=tw), model,
                rows, {"slab": plain(slab_fault(torch, a_q, k0))}, what)

    def mixed_pair(a, fmt, w_q, s_w, tw, dt, what, w_k=None):
        key = "fp8_mixed_matmul_t" if tw else "fp8_mixed_matmul"
        a_q, s_blk = quantized("fp8_block_quantize", "block_quantize", (a, fmt), what)
        fb = F8.fallback_mask(s_blk, 8.0)
        fn = getattr(F8, key)
        got = twice(lambda: fn(a, a_q, s_blk, fb, w_q, s_w, out_dtype=dt), f"{key} {what}")
        if w_k is not None:
            through_w_k(got, lambda: fn(a, a_q, s_blk, fb, w_q, s_w, out_dtype=dt, w_k=w_k),
                        f"{key} {what}")
        kw = dict(block_rows=128, block_cols=128, transpose_w=tw)
        plain = lambda b_q, f: F8REF.fp8_mixed_matmul(a, b_q, s_blk, f, w_q, s_w,
                                                      out_dtype=dt, **kw)
        want = plain(a_q, fb)
        bnd = F8REF.matmul_bound(want, a_q, w_q, x16=a, s_blk=s_blk, fb_blk=fb, s_w=s_w, **kw)
        rows = torch.tensor(F8TC.check_rows(a.shape[0]), device=dev)
        model = F8TC.mixed_rows(a, a_q, s_blk, fb, w_q, s_w, rows, out_dtype=dt, **kw)
        mixed.update(tiles=mixed["tiles"] + fb.numel(),
                     fallback_tiles=mixed["fallback_tiles"] + int(fb.sum()))
        faults = {"slab": plain(slab_fault(torch, a_q, 32 * (a.shape[1] // 64)), fb)}
        if float(fb.sum()) > 0:                     # the outlier tiles fall back
            check(float(fb.sum()) < fb.numel(), f"{key} {what}: not both branches ran")
            faults["fallback dropped"] = fn(a, a_q, s_blk, torch.zeros_like(fb), w_q, s_w,
                                            out_dtype=dt)
        bounded(key, got, want, bnd, model, rows, faults, what)

    def exact_case(R, K, Mw, dt, dx, what):
        """The four forms on F8REF.exact_entries inputs: bit-equal."""
        nonlocal n
        x, g = (F8REF.exact_entries(shape, gen, dev) for shape in ((R, K), (R, Mw)))
        w_q, s_w = F8.tensor_quantize(F8REF.exact_entries((K, Mw), gen, dev) * 0.125, "e4m3")
        cases = [("fp8_matmul_dequant", x, "e4m3", False)]
        cases += [("fp8_matmul_dequant_t", g, "e5m2", True)] if dx else []
        for key, a, fmt, tw in cases:
            a16 = a.to(dt)
            a_q, s_a = F8.row_quantize(a16, fmt)
            got = getattr(F8, key)(a_q, w_q, s_a * s_w, out_dtype=dt)
            want = F8REF.fp8_matmul_dequant(a_q, w_q, s_a * s_w, transpose_w=tw, out_dtype=dt)
            check(torch.equal(got, want), f"{key} {what} exact entries: kernel != plain "
                  f"(max |diff| {max_abs_diff(torch, got, want):g})")
            mkey = key.replace("matmul_dequant", "mixed_matmul")
            b_q, s_blk = F8.block_quantize(a16, fmt)
            grid = torch.arange(s_blk.shape[0], device=dev)[:, None] + torch.arange(
                s_blk.shape[1], device=dev)[None, :]
            fb = (grid % 2 == 1).float()
            got = getattr(F8, mkey)(a16, b_q, s_blk, fb, w_q, s_w, out_dtype=dt)
            want = F8REF.fp8_mixed_matmul(a16, b_q, s_blk, fb, w_q, s_w, block_rows=128,
                                          block_cols=128, transpose_w=tw, out_dtype=dt)
            check(torch.equal(got, want), f"{mkey} {what} exact entries: kernel != plain "
                  f"(max |diff| {max_abs_diff(torch, got, want):g})")
            n += 2
            mixed["exact_cases"] += 2

    def inputs(R, C, dt):
        """(label, activations): rows of many scales with ties, zeros and
        outliers; rows of one scale."""
        return (("", fp8_activations(torch, gen, R, C, dev, dt, outliers=True)),
                (" one-scale", (torch.randn((R, C), generator=gen, device=dev) * 3).to(dt)))

    ragged = [("ragged", 37, ("bfloat16", "float32"), None, None,
               {"ragged": (130, 70, True)})]
    for tower, R, dts, _, _, linears in table + ragged:
        for lin, (K, Mw, dx) in linears.items():
            what = f"{tower} {lin} {K}x{Mw} R={R}"
            w = weight(torch, gen, K, Mw, dev)
            w_q, s_w = quantized("fp8_tensor_quantize", "tensor_quantize", (w, "e4m3"), what)
            transposed(w_q, what)
            w_k = folded(w, w_q, s_w, what)
            for dt in (getattr(torch, d) for d in dts):
                for label, x in inputs(R, K, dt):
                    at = f"{what} {dt}{label}"
                    x_q, s_x = quantized("fp8_row_quantize", "row_quantize", (x, "e4m3"), at)
                    dequant(x_q, w_q, s_x * s_w, False, dt, at, w_k)
                    mixed_pair(x, "e4m3", w_q, s_w, False, dt, at, w_k)
                if dx:                              # the patch embedding has no Ẋ
                    for label, g in inputs(R, Mw, dt):
                        at = f"{what} {dt}{label} dgrad"
                        g_q, s_g = quantized("fp8_row_quantize", "row_quantize", (g, "e5m2"),
                                             f"{at} Ẏ")
                        dequant(g_q, w_q, s_g * s_w, True, dt, at)
                        mixed_pair(g, "e5m2", w_q, s_w, True, dt, at)
                exact_case(R, K, Mw, dt, dx, f"{what} {dt}")
    torch.cuda.synchronize()
    by = {}
    for key, kind, dt, what, r, equal, f, f_bound in readings:
        one = "one-scale" in what
        b = by.setdefault(f"{key} {kind} {dt}", dict(
            worst_bound_share=0.0, model_equal=True, fault_min_model_ulps=math.inf,
            fault_min_bound_share=math.inf, fault_min_bound_share_one_scale=math.inf))
        b["worst_bound_share"] = max(b["worst_bound_share"], r)
        b["model_equal"] = b["model_equal"] and equal
        b["fault_min_model_ulps"] = min(b["fault_min_model_ulps"], f)
        k = "fault_min_bound_share" + ("_one_scale" if one else "")
        b[k] = min(b[k], f_bound)
    # fault_min_bound_share*: the smallest over cases of the fault's largest
    # share of matmul_bound over the outputs that are not 0 (printed: the
    # bound is a worst case; the model is what holds arithmetic faults out)
    print("[kernels] fp8 matmuls (form, fault, output): " + json.dumps(by))
    for key, kind, dt, what, r, equal, f, _ in readings:
        check(r <= 1.0, f"{key} {what}: kernel outside matmul_bound ({r:g} of it)")
        check(equal, f"{key} {what}: kernel != the tensor-core model at the check rows")
        check(f >= FAULT_MARGIN, f"{key} {what}: the control fault ({kind}) lies "
              f"{f:g} ulps off the model, under {FAULT_MARGIN:g}")
    return worst, dict(bound_share=share, fault_model_ulps=fault, **mixed), n


# phase 19's quantizer edges: every (rows, K) of the fp8 paths (the
# vision and text layers' X and Ẏ widths, the patch embedding's 588), the
# warp-a-row path's last K and the first past it, the cuda tests' ragged
# 37 x 130; the tiles of the main path, the cuda tests and the CLI
FP8_QUANT_EDGES = ((4128, 1280), (4128, 5120), (2464, 1024), (2464, 4096), (8192, 588),
                   (300, 2048), (300, 2049), (37, 130))
FP8_QUANT_TILES = ((128, 128), (64, 32), (64, 64))


def fp8_edge_input(torch, gen, R, C, dev, dtype, offset=0):
    """``fp8_activations`` (scales e^-4..e^4 a row, exact fp8 ties in row 1,
    an all-zero row 2 and 128 x 128 tile) with the other cases the
    quantizers' arithmetic must keep: ±0 beside 1.0 (row 3), bf16
    subnormals alone (row 4: the 1e-12 floor) and beside 1.0 (row 5).
    ``offset``: the elements the contiguous view starts after its buffer's
    start (an odd one: not 16-byte aligned, the masked path)."""
    x = fp8_activations(torch, gen, R, C, dev, torch.float32, outliers=False)
    k = torch.arange(C, device=dev)
    tiny = ((k % 7) - 3).float() * 2.0 ** -133
    for r, v in {3: torch.where(k % 2 == 0, -0.0, 0.0), 4: tiny, 5: tiny}.items():
        if r < R:
            x[r] = v
            if r != 4:
                x[r, 0] = 1.0
    x = x.to(dtype)
    if offset:
        buf = torch.empty(R * C + offset, dtype=dtype, device=dev)
        buf[offset:] = x.reshape(-1)
        x = buf[offset:].view(R, C)
        check(x.is_contiguous() and x.data_ptr() % 16 != 0, "an odd offset's view")
    return x


def compare_fp8_quantizer_edges(torch, M, dev, seed, encode_check=True):
    """Phase 19: ``row_quantize`` and ``block_quantize`` at FP8_QUANT_TILES,
    bit-equal to their plain versions (q's bytes and the state) at
    FP8_QUANT_EDGES, bf16 and f32, E4M3 and E5M2, from an aligned base and
    from an odd offset, on ``fp8_edge_input``'s cases; each run twice gives
    the same bits. Then ``tensor_quantize`` at its edges in both formats
    (``compare_tensor_quantizer_edges``) and ``tensor_quantize_kt`` at its
    own (``compare_kt_edges``), where the module has the entry points for
    them. With ``encode_check``, the quantizers' conversion
    equals grid_round + encode on every f32 bit pattern
    (``ops.encode_check``) and their bf16 division ``__fdiv_rn`` on every
    pair it meets (``ops.divide_check``).
    Returns the largest |kernel - plain| (decoded) by kernel, the number
    of comparisons and the tensor quantizers' control faults caught."""
    F8, F8REF = M.F8, M.F8REF
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {"fp8_row_quantize": 0.0, "fp8_block_quantize": 0.0}
    n = 0
    for R, C in FP8_QUANT_EDGES:
        for dt in (torch.bfloat16, torch.float32):
            for offset in (0, 1):
                x = fp8_edge_input(torch, gen, R, C, dev, dt, offset)
                for fmt in ("e4m3", "e5m2"):
                    cases = [("fp8_row_quantize", "row_quantize", ())]
                    cases += [("fp8_block_quantize", "block_quantize", t) for t in FP8_QUANT_TILES]
                    for key, name, args in cases:
                        what = f"{key} {R}x{C} {dt} offset {offset} {fmt} {args}"
                        got = getattr(F8, name)(x, fmt, *args)
                        again = getattr(F8, name)(x, fmt, *args)
                        want = getattr(F8REF, name)(x, fmt, *args)
                        for g, a, w, part in zip(got, again, want, ("fp8", "state")):
                            check(g.dtype == w.dtype and g.shape == w.shape and torch.equal(
                                as_bits(torch, g), as_bits(torch, w)),
                                f"{what} {part}: kernel != plain")
                            check(torch.equal(as_bits(torch, g), as_bits(torch, a)),
                                  f"{what} {part}: two launches differ")
                            worst[key] = max(worst[key],
                                             max_abs_diff(torch, g.float(), w.float()))
                            n += 1
                del x
    caught = 0
    if getattr(F8, "tensor_quantize_plan", None):
        t_worst, t_n, caught = compare_tensor_quantizer_edges(torch, M, dev, seed + 1,
                                                              ("e4m3", "e5m2"))
        worst["fp8_tensor_quantize"] = max(t_worst.values())
        n += t_n
    if getattr(F8, "tensor_quantize_kt", None):
        k_worst, k_n, k_caught = compare_kt_edges(torch, M, dev, seed + 2)
        worst["fp8_tensor_quantize"] = max(worst.get("fp8_tensor_quantize", 0.0), k_worst)
        n += k_n
        caught += k_caught
    if encode_check:
        for fmt in ("e4m3", "e5m2"):
            bad = F8.encode_check(fmt, dev)
            check(bad == 0, f"the quantizers' {fmt} conversion differs from grid_round + encode "
                  f"on {bad} of the 2 x 2^32 bytes encode_check reads")
        bad = F8.divide_check(dev)
        check(bad == 0, f"the bf16 quantizers' division differs from __fdiv_rn on {bad} "
              "(x, absmax) pairs")
        n += 3
    return worst, n, caught


def quantizer_calls(lins):
    """The fp8 quantizers' calls over one layer of a ``clip_shapes`` entry:
    X (K, E4M3) of each linear, then Ẏ (M, E5M2) of each with an input
    gradient."""
    layer = clip_layer(lins)
    return [(K, "e4m3") for K, _, _ in layer] + [(Mw, "e5m2") for _, Mw, dx in layer if dx]


def time_fp8_quantizers(torch, M, gen, dev, R, calls, what, plain=True):
    """``row_quantize`` and ``block_quantize`` (128 x 128) over one layer's
    ``calls`` [(K, fmt)] at ``R`` rows, bf16 as the path gives them
    (``fp8_activations``: many binades, ties, zeros, outlier tiles): each
    kernel's device ms by graph replay over input sets larger than L2, the
    plain version's (with ``plain``), the eager ms and the bound (each value
    read once in bf16 and written once in 8 bits, and the states)."""
    F8, F8REF = M.F8, M.F8REF
    n_el = sum(R * K for K, _ in calls)
    sets = [[fp8_activations(torch, gen, R, K, dev, torch.bfloat16, outliers=True)
             for K, _ in calls] for _ in range(max(2, int(120e6 // (3 * n_el)) + 1))]
    tiles = sum(-(-R // 128) * -(-K // 128) for K, _ in calls)
    work = {"fp8_row_quantize": ("row_quantize", (), n_el * 3 + 4 * R * len(calls)),
            "fp8_block_quantize": ("block_quantize", (128, 128), n_el * 3 + 4 * tiles)}
    out = {}
    for name, (fn, args, bytes_) in work.items():
        def call(i, op, fn=fn, args=args):
            return [getattr(op, fn)(x, fmt, *args) for x, (_, fmt) in zip(sets[i], calls)]
        out[name] = dict(
            ms=graph_ms(torch, lambda i: call(i, F8), len(sets)),
            plain_ms=graph_ms(torch, lambda i: call(i, F8REF), len(sets)) if plain else None,
            library_ms=None, library=None,
            eager_ms=eager_ms(torch, lambda i: call(i, F8), len(sets)),
            bound=bound(bytes_, f32_ops=2 * n_el), calls=len(calls),
            work=f"{what}: {len(calls)} calls at {R} rows")
    del sets
    return out


def plain_kt(torch, M, w, fmt="e4m3"):
    """The fold's plain version: ``ref.tensor_quantize`` and the plain copy."""
    q, s = M.F8REF.tensor_quantize(w, fmt)
    return q, s, q.view(torch.uint8).t().contiguous()


def plain_fp8(M):
    """The fp8 wrappers' plain versions behind the wrappers' signatures (the
    forwards' ``w_k`` read as the wrappers' CPU path reads it: its bytes as
    w_q's dtype in the ``transpose_w`` form, the same function)."""
    import torch
    R = M.F8REF

    def w_of(w_q, w_k):
        return (w_q, False) if w_k is None else (w_k.view(w_q.dtype), True)

    def dequant(x_q, w_q, rs, *, out_dtype, w_k=None):
        w, tw = w_of(w_q, w_k)
        return R.fp8_matmul_dequant(x_q, w, rs, transpose_w=tw, out_dtype=out_dtype)

    def mixed(x16, x_q, s_blk, fb, w_q, s_w, *, block_rows, block_cols, out_dtype, w_k=None):
        w, tw = w_of(w_q, w_k)
        return R.fp8_mixed_matmul(x16, x_q, s_blk, fb, w, s_w, block_rows=block_rows,
                                  block_cols=block_cols, transpose_w=tw, out_dtype=out_dtype)

    return {
        "row_quantize": R.row_quantize, "tensor_quantize": R.tensor_quantize,
        "tensor_quantize_kt": lambda x, fmt="e4m3": plain_kt(torch, M, x, fmt),
        "block_quantize": R.block_quantize,
        "fp8_matmul_dequant": dequant,
        "fp8_matmul_dequant_t": lambda x_q, w_q, rs, *, out_dtype: R.fp8_matmul_dequant(
            x_q, w_q, rs, transpose_w=True, out_dtype=out_dtype),
        "fp8_mixed_matmul": mixed,
        "fp8_mixed_matmul_t": lambda *a, block_rows, block_cols, out_dtype: R.fp8_mixed_matmul(
            *a, block_rows=block_rows, block_cols=block_cols, transpose_w=True,
            out_dtype=out_dtype),
    }


# the fp8 whole-step checks of phase 21 (kernels vs plain at 2 + 2 layers,
# flash_scan and dense): per leaf of the gradient ||diff|| / ||plain||, the
# worst leaf and the median leaf. The fp8 quantizers turn a last-bit
# difference of a kernel's sum into a step of 2^-4 (E4M3) or 2^-3 (E5M2)
# of a value, which saturates a per-leaf max |diff| / max (sound readings
# up to 0.72, where an all-zero gradient reads 1.0), so the norms. Two
# control faults, both of which every key must see: the positional
# embedding read one row off, and the fp8 matmuls reading one k32 slab of
# A a row off (``slab_fault_fp8``). Limits by the rule of phase 10 over
# three seeds, both modes and both attentions on an H100 (readings in
# PERF.md): worst leaf 0.592 sound against the faults' 0.959 (geometric
# mean 0.753: 8e-1); median leaf 0.219 against 0.831 (0.427: 4e-1). The
# loss is printed, not bounded (as in phase 16).
CLIP_FP8_STEP_TOL = {"grad_norm_rel_err": 8e-1, "grad_median_norm_rel_err": 4e-1}


# the accumulator probe (before phase 19): one window of each form the fp8
# matmuls issue, through the GEMMs' own m64n128 steps chained as a window
# chains them, on constructed operands, against the exact sum
PROBE_FORMS = {"fp8": (("e4m3.e4m3 m64n128k32", 0, "e4m3", "e4m3"),
                       ("e5m2.e4m3 m64n128k32", 1, "e5m2", "e4m3")),
               "bf16": (("bf16.bf16 m64n128k16", 2, "bf16", "bf16"),
                        ("bf16.bf16 m64n128k16 MN-major", 3, "bf16", "bf16"))}
PROBE_DEPTH = 40


def fp8_values(torch):
    """Every finite value of each fp8 format, as a set of floats."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    out = {}
    for fmt, dt in (("e4m3", torch.float8_e4m3fn), ("e5m2", torch.float8_e5m2)):
        v = codes.view(dt).float()
        out[fmt] = {float(x) for x in v[torch.isfinite(v)]}
    return out


def probe_sum(torch, M, dev, form, products, values, pairs=None):
    """(the card's, the exact, the model's) result of one probe window:
    ``products`` in k order (each factored here into a in the A format
    times a power of two b in the B format), or the operand ``pairs`` as
    given, over as many chained steps as they fill (k32 of fp8, k16 of
    bf16; at most 4), the first into a fresh fragment; the model is
    ``F8TC.window_sum`` on the same operands. All 64 rows and 128 columns
    compute the same sum."""
    from repro_torch.kernels import build as KB
    name, mode, fa, fb = form
    kk = 16 if mode >= 2 else 32

    def ok(x, fmt):
        if fmt == "bf16":
            return x == 0 or (2.0 ** -133 <= abs(x) <= 2.0 ** 127
                              and (abs(x) / 2.0 ** math.frexp(abs(x))[1]) in (0.5, 0.75))
        return x in values[fmt]

    a, b = [0.0] * 4 * kk, [1.0] * 4 * kk
    if pairs is None:
        pairs = []
        for p in products:
            e = math.frexp(abs(p))[1] - 1
            for be in sorted(range(-133, 128), key=lambda j: abs(j - e // 2)):
                if p == 0 or (ok(2.0 ** be, fb) and ok(p / 2.0 ** be, fa)):
                    pairs.append((p / 2.0 ** be, 2.0 ** be) if p else (0.0, 1.0))
                    break
            else:
                raise ValueError(f"probe {name}: product {p} cannot be factored")
    for k, (x, y) in enumerate(pairs):
        a[k], b[k] = x, y
    steps = -(-len(pairs) // kk)
    check(1 <= steps <= 4, f"probe {name}: {len(pairs)} products are not 1-4 steps")
    A = torch.tensor([a] * 64, dtype=torch.float64)
    B = torch.tensor([b] * 128, dtype=torch.float64)
    cast = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2, "bf16": torch.bfloat16}
    a8, b8 = A.to(cast[fa]), B.to(cast[fb])
    check(torch.equal(a8.double(), A) and torch.equal(b8.double(), B), f"probe {name}: inexact operands")
    d = torch.empty((64, 128), dtype=torch.float32, device=dev)
    ops = [t.contiguous().view(torch.uint8).to(dev) for t in (a8, b8)]
    KB.launch(M.F8B.load().f8_wgmma_probe, ops[0].data_ptr(), ops[1].data_ptr(), d.data_ptr(),
              mode, steps, KB.stream(d))
    got = d.cpu().double()
    check(bool((got == got[0, 0]).all()), f"probe {name}: rows or columns disagree")
    n = steps * kk
    model = M.F8TC.window_sum(a8[:1, :n], b8[:1, :n], "bf16" if mode >= 2 else "fp8")
    return float(got[0, 0]), math.fsum(x * y for x, y in pairs), float(model[0, 0])


def accumulator_probe(torch, M, dev):
    """How each wgmma form the fp8 matmuls and wgrad_bf16 issue adds (bf16
    read K-major and, as wgrad_bf16 reads it, MN-major), on constructed
    operands: ``t`` is the largest d for which big + big 2^-d is exact for
    every smaller d, as two products of one step and with big the fragment
    a first step left (the width a step's sum keeps); ``t_addend`` the
    largest d for which 31 (or 15) addends of big 2^-d still add something
    (the width each addend keeps). Then, at the width t, 0.75 and -0.5
    units added to big (truncation), 31 (or 15) addends of half and of an
    eighth of a unit (dropped one by one), a fragment of 2 big + 1 unit
    carried through a step of zero products, a product with a carry in its
    significand plus two small ones (the addends align to the exponent
    sums: fp8 240 x 240 + 2 + 2 keeps the 4), and sums of the smallest
    products alone (subnormal operands). Every reading must equal the
    model's (``F8TC``, which phase 19 holds the kernels to) and ``t`` be at
    least ``F8REF.ACC_BITS`` (what matmul_bound assumes). Returns the
    readings by form."""
    values = fp8_values(torch)
    out, off = {}, []
    for kind, forms in PROBE_FORMS.items():
        for form in forms:
            name, mode = form[:2]
            kk = 16 if mode >= 2 else 32
            big = 1.0 if mode >= 2 else 2.0 ** 16

            def run(prods, pairs=None, key=""):
                got, exact, model = probe_sum(torch, M, dev, form, prods, values, pairs)
                if got != model:
                    off.append((name, key, got, model))
                return got, exact

            width = {}
            for key, case, same in (
                    ("products", lambda d: run([big, big * 2.0 ** -d], key=f"products {d}"),
                     lambda got, exact: got == exact),
                    ("accumulator", lambda d: run([big] + [0.0] * (kk - 1) + [big * 2.0 ** -d],
                                                  key=f"accumulator {d}"),
                     lambda got, exact: got == exact),
                    ("addend", lambda d: run([big] + [big * 2.0 ** -d] * (kk - 1),
                                             key=f"addend {d}"),
                     lambda got, exact: got != big)):
                t = 0
                for d in range(1, PROBE_DEPTH):
                    if not same(*case(d)):
                        break
                    t = d
                width[key] = t
            t = min(width["products"], width["accumulator"])
            u = big * 2.0 ** -t
            r = dict(kind=kind, t=t, t_products=width["products"],
                     t_accumulator=width["accumulator"], t_addend=width["addend"], unit=u)
            carry = {0: ([(240.0, 240.0), (2.0, 1.0), (2.0, 1.0)], 57600.0, 4.0),
                     1: ([(224.0, 240.0), (2.0, 1.0), (2.0, 1.0)], 53760.0, 4.0),
                     2: ([(1.9921875, 1.9921875)] + [(2.0 ** -25, 1.0)] * 15,
                         1.9921875 ** 2, 2.0 ** -22)}[min(mode, 2)]
            for key, prods, base, unit, pairs in (
                    ("plus_0.75_unit", [big, 0.75 * u], big, u, None),
                    ("minus_0.5_unit", [big, -0.5 * u], big, u, None),
                    (f"plus_{kk - 1}_half_units", [big] + [0.5 * u] * (kk - 1), big, u, None),
                    (f"plus_{kk - 1}_eighth_units", [big] + [0.125 * u] * (kk - 1), big, u,
                     None),
                    ("fragment_2big_plus_unit_then_zeros",
                     [big, big, u] + [0.0] * (2 * kk - 3), 2 * big, u, None),
                    ("carry_product_plus_small", None, carry[1], carry[2], carry[0])):
                got, want = run(prods, pairs, key)
                r[key] = dict(got_minus_base_in_units=(got - base) / unit,
                              exact_minus_base_in_units=(want - base) / unit)
            tiny = {0: [2.0 ** -18], 1: [2.0 ** -25], 2: [2.0 ** -133]}[min(mode, 2)]
            for key, prods in (("smallest_product", tiny), ("smallest_products_sum", tiny * kk)):
                got, want = run(prods, key=key)
                r[key] = dict(got=got, exact=want)
            out[name] = r
    torch.cuda.synchronize()
    print("[probe] wgmma accumulation: " + json.dumps(out))
    print(f"[probe] readings off the model (F8TC): {len(off)} " + json.dumps(off[:8]))
    mma = mma_sync_probe(torch, M, dev)
    print("[probe] widths (bits below the largest addend), wgmma beside mma.sync: " + json.dumps(
        {name: {k: r[k] for k in ("t", "t_products", "t_accumulator", "t_addend")}
         for name, r in {**out, MMA_PROBE_FORM: mma}.items()}))
    for name, r in out.items():
        check(r["t"] >= M.F8REF.ACC_BITS[r["kind"]],
              f"probe {name}: adds {r['t']} bits below the largest addend, under the "
              f"{M.F8REF.ACC_BITS[r['kind']]} that matmul_bound assumes")
    check(not off, f"probe: {len(off)} readings off the tensor-core model, e.g. {off[:4]}")
    return out


MMA_PROBE_FORM = "bf16.bf16 m16n8k16 (mma.sync)"


def mma_sum(torch, M, dev, pairs):
    """One probe of the attention kernels' mma.sync step (``fa_mma_probe``):
    the operand ``pairs`` (bf16-exact (a, b), in k order, over as many k16
    steps as they fill, chained on one fragment from zero) in every row
    and column. Returns (the card's sum, the exact sum)."""
    from repro_torch.kernels import build as KB
    from repro_torch.kernels.flash_attention import build as FB
    steps = -(-len(pairs) // 16)
    check(1 <= steps <= 4, f"mma.sync probe: {len(pairs)} products are not 1-4 steps")
    a, b = [0.0] * 16 * steps, [0.0] * 16 * steps
    for k, (x, y) in enumerate(pairs):
        a[k], b[k] = x, y
    A = torch.tensor([a] * 16, dtype=torch.float64)
    B = torch.tensor([b] * 8, dtype=torch.float64)
    check(torch.equal(A.bfloat16().double(), A) and torch.equal(B.bfloat16().double(), B),
          "mma.sync probe: inexact operands")
    ops = [t.bfloat16().contiguous().to(dev) for t in (A, B)]
    d = torch.empty((16, 8), dtype=torch.float32, device=dev)
    KB.launch(FB.load().fa_mma_probe, ops[0].data_ptr(), ops[1].data_ptr(), d.data_ptr(), steps,
              KB.stream(d))
    got = d.cpu().double()
    check(bool((got == got[0, 0]).all()), "mma.sync probe: rows or columns disagree")
    return float(got[0, 0]), math.fsum(x * y for x, y in pairs)


def mma_sync_probe(torch, M, dev):
    """The widths of the attention kernels' mma.sync m16n8k16 bf16 step
    (flash_attention.cu, paged_attention.cu), read as ``accumulator_probe``
    reads wgmma's: ``t_products`` the largest d for which 1 + 2^-d in one
    step is exact for every smaller d, ``t_accumulator`` the same with the
    1 a chained first step left in the fragment, ``t_addend`` the largest d
    for which 15 addends of 2^-d still add something; then 0.75 and -0.5
    units added to 1 at the width t (truncation or rounding). Printed
    beside wgmma's; no plain model of it is fitted yet, so nothing is held
    to one."""
    def run(prods):
        return mma_sum(torch, M, dev, [(p, 1.0) for p in prods])

    width = {}
    for key, case, same in (
            ("products", lambda d: run([1.0, 2.0 ** -d]), lambda got, exact: got == exact),
            ("accumulator", lambda d: run([1.0] + [0.0] * 15 + [2.0 ** -d]),
             lambda got, exact: got == exact),
            ("addend", lambda d: run([1.0] + [2.0 ** -d] * 15), lambda got, exact: got != 1.0)):
        t = 0
        for d in range(1, PROBE_DEPTH):
            if not same(*case(d)):
                break
            t = d
        width[key] = t
    t = min(width["products"], width["accumulator"])
    u = 2.0 ** -t
    r = dict(kind="bf16", t=t, t_products=width["products"],
             t_accumulator=width["accumulator"], t_addend=width["addend"], unit=u)
    for key, prods in (("plus_0.75_unit", [1.0, 0.75 * u]), ("minus_0.5_unit", [1.0, -0.5 * u]),
                       ("chained_plus_0.75_unit", [1.0] + [0.0] * 15 + [0.75 * u])):
        got, want = run(prods)
        r[key] = dict(got_minus_base_in_units=(got - 1.0) / u,
                      exact_minus_base_in_units=(want - 1.0) / u)
    torch.cuda.synchronize()
    print("[probe] mma.sync accumulation: " + json.dumps(r))
    return r


# the one PyTorch call phase 23 times beside each fp8 kernel, by kind
LIBRARY_CALL = {"fwd": "torch._scaled_mm, row-wise scales, bf16 out",
                "dgrad": "torch._scaled_mm, row-wise scales, bf16 out",
                "transpose": "w_q.view(torch.uint8).t().contiguous() (also the plain version)"}
# what phase 23 reads beside the fold (tensor_quantize_kt), for the six
# weights of a layer: the flat tensor_quantize alone, the parent's pair
# (tensor_quantize, then transpose_bytes) and the library pair
# (tensor_quantize, then PyTorch's transposed copy of the bytes); no single
# PyTorch call takes a tensor's absmax and casts by it
KT_LIBRARY = ("none (no single call); library_pair_ms: F8.tensor_quantize + "
              "w_q.view(torch.uint8).t().contiguous()")


def time_fp8_kernels(torch, M, cfg, dev, seed):
    """Phase 23: each fp8 kernel at one vision layer's calls at batch 32
    (4,128 rows; the six linears wq, wk, wv, wo, w_up, w_down): the fp8
    modes' tensor_quantize_kt of the six weights (the fold, beside the flat
    tensor_quantize alone, the parent's tensor_quantize + transpose_bytes
    pair and the library pair), transpose_bytes of them (an op entry point),
    row_quantize of X (E4M3) and Ẏ (E5M2), fp8_matmul_dequant given the
    fold's w_k (beside the same call through transpose_bytes) and its
    transposed form;
    fp8_mixed's block_quantize of X and Ẏ and both mixed forms (with the
    fallback tiles of these inputs). Each beside its plain version, the
    bound (bytes over 3.35 TB/s; the matmuls' operations over the fp8 peak
    of 1,979 TFLOP/s, the fallback tiles' over the bf16 peak) and, for the
    matmuls, ``torch._scaled_mm`` with row-wise scales (timed only; the
    port never calls it; the forward's column-major W is made outside its
    timing, as the path's forward is given it), and for the matmuls the
    rate in TFLOP/s and the bound's share of the time."""
    F8, F8REF = M.F8, M.F8REF
    gen = torch.Generator(device=dev).manual_seed(seed + 37)
    _, R, _, _, _, shapes = clip_shapes(cfg)[0]
    lin = [shapes[k][:2] for k in ("w_qkvo",) * 4 + ("w_up", "w_down")]    # (K, M)
    bf = torch.bfloat16

    def one_set():
        s = {"w": [], "x": [], "g": [], "fwd": [], "dgrad": [], "mix": [], "mix_t": [],
             "w_k": []}
        for K, Mw in lin:
            w = weight(torch, gen, K, Mw, dev)
            w_q, s_w, w_k = F8.tensor_quantize_kt(w, "e4m3")
            s["w_k"].append(w_k)
            x = fp8_activations(torch, gen, R, K, dev, bf, outliers=True)
            g = fp8_activations(torch, gen, R, Mw, dev, bf, outliers=True)
            x_q, s_x = F8.row_quantize(x, "e4m3")
            g_q, s_g = F8.row_quantize(g, "e5m2")
            s["w"].append(w)
            s["x"].append(x)
            s["g"].append(g)
            s["fwd"].append((x_q, w_q, s_x * s_w))
            s["dgrad"].append((g_q, w_q, s_g * s_w))
            for key, a, fmt in (("mix", x, "e4m3"), ("mix_t", g, "e5m2")):
                a_q, s_blk = F8.block_quantize(a, fmt)
                s[key].append((a, a_q, s_blk, F8.fallback_mask(s_blk, 8.0), w_q, s_w))
        return s

    per_set = sum(K * Mw * 5 + R * (K + Mw) * 8 for K, Mw in lin)
    sets = [one_set() for _ in range(max(2, int(120e6 // per_set) + 1))]
    torch.cuda.synchronize()
    fb_share = {key: sum(float(t[3].sum()) for t in sets[0][key]) /
                sum(t[3].numel() for t in sets[0][key]) for key in ("mix", "mix_t")}

    def scaled_mm(a_q, w_cm, row_scale, ones):
        """torch._scaled_mm with row-wise scales: a_q (B, K) row-major, W
        as the column-major (K, M) it wants, the row scale (B, 1) and ones
        (1, M) for the columns, bf16 out."""
        return torch._scaled_mm(a_q, w_cm, scale_a=row_scale, scale_b=ones, out_dtype=bf)

    # the forward's (K, M) W as a column-major copy, made outside the
    # timing; the dgrad's (N, M) W read transposed is column-major already
    col_major = {key: [(a, w.t().contiguous().t() if key == "fwd" else w.t(), rs,
                        torch.ones((1, w.shape[1] if key == "fwd" else w.shape[0]), device=dev))
                       for a, w, rs in sets[0][key]] for key in ("fwd", "dgrad")}
    library, lib_err = {}, {}
    plain_t = lambda w_q: w_q.view(torch.uint8).t().contiguous()
    library["transpose"] = lambda i: [plain_t(a[1]) for a in sets[0]["fwd"]]
    for key, kernel in (("fwd", F8.fp8_matmul_dequant), ("dgrad", F8.fp8_matmul_dequant_t)):
        y, want = scaled_mm(*col_major[key][4]), kernel(*sets[0][key][4])
        lib_err[key] = rel_err(torch, y.float(), want.float())
        check(lib_err[key] <= 2.0 ** -6, f"torch._scaled_mm yardstick ({key}) disagrees "
              f"with the kernel: {lib_err[key]:g}")
        library[key] = lambda i, key=key: [scaled_mm(*t) for t in col_major[key]]
    print("[timing] fp8 yardstick torch._scaled_mm vs kernel (relative to max|y|): "
          + json.dumps(lib_err))

    n_w = sum(K * Mw for K, Mw in lin)
    rk = sum(R * K for K, _ in lin)
    rm = sum(R * Mw for _, Mw in lin)
    mac = sum(R * K * Mw for K, Mw in lin)
    # the path's forward reads the fold's w_k (the kernel only: the plain
    # version is the same function without it)
    given = lambda s, op, i: {"w_k": s["w_k"][i]} if op is F8 else {}
    work = {
        # name: (calls, call(set, module, plain), library call, bytes, fp8 ops, bf16 ops, f32 ops)
        "fp8_tensor_quantize": (len(lin), lambda s, op, p: [
            F8.tensor_quantize_kt(w, "e4m3") if op is F8 else plain_kt(torch, M, w)
            for w in s["w"]], None, n_w * 2 + 2 * n_w + 4 * len(lin), 0, 0, 2 * n_w),
        "fp8_matmul_dequant": (len(lin), lambda s, op, p: [p("fp8_matmul_dequant")(
            *a, out_dtype=bf, **given(s, op, i)) for i, a in enumerate(s["fwd"])], "fwd",
            rk + n_w + 4 * R * len(lin) + 2 * rm, 2 * mac, 0, 0),
        "fp8_matmul_dequant_t": (len(lin), lambda s, op, p: [p("fp8_matmul_dequant_t")(
            *a, out_dtype=bf) for a in s["dgrad"]], "dgrad",
            rm + n_w + 4 * R * len(lin) + 2 * rk, 2 * mac, 0, 0),
        "fp8_mixed_matmul": (len(lin), lambda s, op, p: [p("fp8_mixed_matmul")(
            *a, block_rows=128, block_cols=128, out_dtype=bf, **given(s, op, i))
            for i, a in enumerate(s["mix"])], "fwd",
            rk * 3 + n_w + 2 * rm, 2 * mac * (1 - fb_share["mix"]), 2 * mac * fb_share["mix"], 0),
        "fp8_transpose_bytes": (len(lin), lambda s, op, p: [
            (F8.transpose_bytes if op is F8 else plain_t)(a[1]) for a in s["fwd"]], "transpose",
            2 * n_w, 0, 0, 0),
        "fp8_mixed_matmul_t": (len(lin), lambda s, op, p: [p("fp8_mixed_matmul_t")(
            *a, block_rows=128, block_cols=128, out_dtype=bf) for a in s["mix_t"]], "dgrad",
            rm * 3 + n_w + 2 * rk, 2 * mac * (1 - fb_share["mix_t"]),
            2 * mac * fb_share["mix_t"], 0),
    }
    kern = lambda name: getattr(F8, name)
    plain = plain_fp8(M)
    out, n = {}, len(sets)
    for name, (calls, call, lib, bytes_, f8, b16, f32) in work.items():
        lib_fn = library[lib] if lib else None
        out[name] = dict(
            ms=graph_ms(torch, lambda i: call(sets[i], F8, kern), n),
            plain_ms=graph_ms(torch, lambda i: call(sets[i], F8REF, plain.__getitem__), n),
            library_ms=graph_ms(torch, lib_fn, 1) if lib_fn else None,
            library=LIBRARY_CALL.get(lib),
            eager_ms=eager_ms(torch, lambda i: call(sets[i], F8, kern), n),
            bound=bound(bytes_, fp8_ops=f8, bf16_ops=b16, f32_ops=f32), calls=calls,
            work=f"one vision layer's {calls} calls at {R} rows (batch {CLIP_BATCH})")
        if name in MATMUL_FORMS:                    # the tensor-core rate and roofline share
            out[name].update(tflops=(f8 + b16) / (out[name]["ms"] * 1e-3) / 1e12,
                             bound_share=out[name]["bound"][0] / out[name]["ms"])
    out["fallback_share"] = fb_share
    # beside the fold: the flat quantizer alone, the parent's pair and the
    # library pair; beside each forward given w_k: the call through
    # transpose_bytes (the parent's path)
    beside = {
        ("fp8_tensor_quantize", "flat_ms"): lambda s: [F8.tensor_quantize(w, "e4m3")
                                                       for w in s["w"]],
        ("fp8_tensor_quantize", "pair_ms"): lambda s: [
            F8.transpose_bytes(F8.tensor_quantize(w, "e4m3")[0]) for w in s["w"]],
        ("fp8_tensor_quantize", "library_pair_ms"): lambda s: [
            plain_t(F8.tensor_quantize(w, "e4m3")[0]) for w in s["w"]],
        ("fp8_matmul_dequant", "with_transpose_ms"): lambda s: [
            F8.fp8_matmul_dequant(*a, out_dtype=bf) for a in s["fwd"]],
        ("fp8_mixed_matmul", "with_transpose_ms"): lambda s: [
            F8.fp8_mixed_matmul(*a, block_rows=128, block_cols=128, out_dtype=bf)
            for a in s["mix"]],
    }
    for (name, key), fn in beside.items():
        out[name][key] = graph_ms(torch, lambda i, fn=fn: fn(sets[i]), n)
    out["fp8_tensor_quantize"]["library"] = KT_LIBRARY
    del sets
    # the two quantizers at one layer of each tower: vision (the row above),
    # text and the patch embedding beside
    quant = {tower: time_fp8_quantizers(torch, M, gen, dev, rows, quantizer_calls(lins),
                                        f"one {tower} layer")
             for tower, rows, _, _, _, lins in clip_shapes(cfg)}
    for name in ("fp8_row_quantize", "fp8_block_quantize"):
        out[name] = dict(quant["vision"][name], at_shapes={
            t: {k: q[name][k] for k in ("ms", "plain_ms", "eager_ms", "calls", "work")}
            | {"bound_ms": q[name]["bound"][0]} for t, q in quant.items() if t != "vision"})
    # the fp8 modes' quantizer (the fold) of the weights of the other
    # towers' layers, the flat form beside
    out["fp8_tensor_quantize"]["at_shapes"] = {
        tower: {k: r[k] for k in ("ms", "plain_ms", "eager_ms", "calls", "work")}
        | {"bound_ms": r["bound"][0], "flat_ms": flat["ms"]}
        for tower, _, _, _, _, lins in clip_shapes(cfg) if tower != "vision"
        for r, flat in [(time_tensor_quantize(
            torch, lambda w: F8.tensor_quantize_kt(w, "e4m3"), lambda w: plain_kt(torch, M, w),
            gen, dev, tower_weights(lins), f"one {tower} layer's weights (the fold)",
            k_major=True),
            time_tensor_quantize(torch, lambda w: F8.tensor_quantize(w, "e4m3"), None, gen, dev,
                                 tower_weights(lins), f"one {tower} layer's weights"))]}
    print("[timing] fp8 kernels:", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 24-26: paged serving, on the paged-attention kernels
# ---------------------------------------------------------------------------

PAGED_BS, PAGED_NB, PAGED_MAX_LEN = 16, 64, 1024
# the paged serve phases' depth: 16 of smollm's 32 layers, to keep the
# script inside its time (PAGED_MODEL_TOL's control fault reads 4.6x its
# limit at 32 layers)
PAGED_LAYERS = 16
# phase 25's workload: 32 requests, a shared 256-token system prompt and a
# 32-512-token suffix each, 64 new tokens, greedy, 8 slots of 1,024 cells,
# 256 tokens per engine step
PAGED_REQUESTS, PAGED_SYSTEM, PAGED_NEW = 32, 256, 64
PAGED_SUFFIX = (32, 512)
PAGED_CHUNK = 256
# phase 25's whole-model check: prompt lengths (8 slots, one prefill call)
PAGED_CHECK_LENS = (128, 256)
# phase 26: 8 requests of these lengths, so many new tokens each, through a
# roomy pool and a tight one (TIGHT_SHARE of the prompts' blocks); the
# speculative run on 8 repetitive prompts of these lengths
PREEMPT_PROMPTS, PREEMPT_NEW, TIGHT_SHARE = (200, 400), 96, 0.6
SPEC_PROMPTS = (64, 256)
# the served model's logits, paged kernels vs plain (phase 25, three
# seeds): (max, mean) |diff| over max|logit|. The two kernels sum the
# softmax in another order than the plain versions' one softmax, as flash
# does, and the int8 quantizers carry a last-bit difference on. Stated
# before the first card run as phase 5's SERVED_FLASH_TOL (1e-1, 1.5e-2);
# then set by the rule of phase 10 (the geometric mean of the worst sound
# and the smallest control-fault reading over three seeds, one digit) from
# the readings on an H100 (PERF.md): sound up to 4.74e-2 / 6.83e-3, the
# fault (KV heads tiled) from 1.39 / 2.40e-1
PAGED_MODEL_TOL = (3e-1, 4e-2)


def paged_inputs(torch, gen, dev, cfg, B, nb=PAGED_NB, bs=PAGED_BS):
    """bf16 K/V pools of B * nb blocks plus the trash block at the model's
    heads, and tables (B, nb) int32: a random permutation of the blocks."""
    N = B * nb
    k = torch.randn((N + 1, bs, cfg.n_kv_heads, cfg.hd), generator=gen, device=dev)
    v = torch.randn((N + 1, bs, cfg.n_kv_heads, cfg.hd), generator=gen, device=dev)
    perm = torch.randperm(N, generator=gen, device=dev).to(torch.int32).reshape(B, nb)
    return k.to(torch.bfloat16), v.to(torch.bfloat16), perm


def dead_entries(torch, tables, kv_len, bs=PAGED_BS):
    """Table entries past each slot's live blocks -> an id outside the pool
    (the kernels never read them; the plain versions clamp them)."""
    live = torch.div(kv_len + bs - 1, bs, rounding_mode="floor")
    j = torch.arange(tables.shape[1], device=tables.device)[None, :]
    return torch.where(j < live[:, None], tables, 10 ** 6).to(torch.int32).contiguous()


def rotated_tables(torch, tables):
    """The control fault: every table row rotated by one (logical block j
    read from the physical block of j - 1), a one-index slip."""
    return torch.roll(tables, 1, dims=1).contiguous()


def plain_paged(M):
    """The plain versions behind the wrappers' signatures."""
    def dec(q, k, v, tables, kv_len):
        return M.PREF.paged_decode_fwd(q, k, v, tables, kv_len,
                                       scale=M.FA.softmax_scale(q.shape[-1]))

    def pre(q, k, v, tables, q_off, kv_len):
        return M.PREF.paged_prefill_fwd(q, k, v, tables, q_off, kv_len,
                                        scale=M.FA.softmax_scale(q.shape[-1]))
    return {"paged_decode_attention": dec, "paged_prefill_attention": pre}


def compare_paged(torch, M, cfg, dev, seed):
    """Phase 24: both paged kernels against their plain versions at the
    served shapes (8 slots, 64 blocks of 16 per table, ragged lengths 0 to
    1,024, dead entries outside the pool), q in bf16 and f32 over the bf16
    pools: o within FLASH_O_TOL of max|o|, a dry slot exact zeros, two
    launches the same bits, the control fault (rotated tables) at least
    FAULT_MARGIN x outside. Prefill at Sq in {1, 5, 128, 300} with ragged
    offsets off the block edges; then every prefill row bit-equal to the
    decode kernel at kv_len = its position + 1. Returns per kernel the
    readings (with the mean signed error of o over every live output, by
    q's dtype: the tensor cores' sums truncate toward zero where they
    chain; the kernels return no lse), the number of comparisons and of
    bit-equal rows."""
    gen = torch.Generator(device=dev).manual_seed(seed + 24)
    out = {k: dict(max_abs_err=0.0, max_rel_err=0.0, fault_over_tol=math.inf)
           for k in ("paged_decode_fwd", "paged_prefill_fwd")}
    signed = {k: {} for k in out}                 # kernel -> dtype -> [sum, count]
    plain = plain_paged(M)
    n = rows_equal = 0
    B, H, hd = 8, cfg.n_heads, cfg.hd

    def record(name, dt, got, want, fault, live, what):
        nonlocal n
        r = out[name]
        tol = FLASH_O_TOL[str(dt).replace("torch.", "")]
        check(got.dtype == dt and got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} {what}: bad output")
        check(float(got[~live].abs().max()) == 0.0 if bool((~live).any()) else True,
              f"{name} {what}: a dry slot is not exact zeros")
        g, w, f = got[live], want[live], fault[live]
        acc = signed[name].setdefault(str(dt).replace("torch.", ""), [0.0, 0])
        acc[0] += float((g.double() - w.double()).sum())
        acc[1] += g.numel()
        err = rel_err(torch, g, w)
        r["max_rel_err"] = max(r["max_rel_err"], err)
        r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(torch, g, w))
        check(err <= tol, f"{name} {what}: kernel vs plain {err:g} > {tol:g}")
        fo = rel_err(torch, g, f) / tol
        r["fault_over_tol"] = min(r["fault_over_tol"], fo)
        check(fo >= FAULT_MARGIN, f"{name} {what}: the control fault reads only {fo:g} x the "
              "tolerance")
        n += 1

    k, v, tables = paged_inputs(torch, gen, dev, cfg, B)
    for dt in (torch.bfloat16, torch.float32):
        kv_len = torch.tensor([0, 1, 15, 16, 17, 300, 1000, 1024], dtype=torch.int32, device=dev)
        t = dead_entries(torch, tables, kv_len)
        q = torch.randn((B, 1, H, hd), generator=gen, device=dev).to(dt)
        o = M.PA.paged_decode_attention(q, k, v, t, kv_len)
        check(torch.equal(o, M.PA.paged_decode_attention(q, k, v, t, kv_len)),
              f"paged_decode_fwd {dt}: two launches differ")
        record("paged_decode_fwd", dt, o, plain["paged_decode_attention"](q, k, v, t, kv_len),
               plain["paged_decode_attention"](q, k, v, rotated_tables(torch, t), kv_len),
               kv_len > 0, f"lens {kv_len.tolist()} q {dt}")
        for Sq in (1, 5, 128, 300):
            q_off = torch.tensor([0, 3, 16, 100, 257, 500, 700, 0], dtype=torch.int32,
                                 device=dev)
            kv_len = (q_off + Sq).clamp(max=PAGED_MAX_LEN).to(torch.int32)
            kv_len[7] = 0                                  # not admitted: a dry slot
            t = dead_entries(torch, tables, kv_len)
            q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).to(dt)
            o = M.PA.paged_prefill_attention(q, k, v, t, q_off, kv_len)
            what = f"Sq {Sq} q_off {q_off.tolist()} kv_len {kv_len.tolist()} q {dt}"
            check(torch.equal(o, M.PA.paged_prefill_attention(q, k, v, t, q_off, kv_len)),
                  f"paged_prefill_fwd {what}: two launches differ")
            record("paged_prefill_fwd", dt, o,
                   plain["paged_prefill_attention"](q, k, v, t, q_off, kv_len),
                   plain["paged_prefill_attention"](q, k, v, rotated_tables(torch, t), q_off,
                                                    kv_len), kv_len > 0, what)
            for r in range(Sq):
                lens = torch.where(kv_len > 0, (q_off + r + 1).clamp(max=PAGED_MAX_LEN),
                                   0).to(torch.int32)
                rows = (q_off + r < kv_len) & (kv_len > 0)
                d = M.PA.paged_decode_attention(q[:, r:r + 1].contiguous(), k, v, t, lens)
                check(torch.equal(d[rows], o[:, r:r + 1][rows]),
                      f"paged_prefill_fwd {what}: row {r} differs from the decode at its "
                      "position")
                rows_equal += int(rows.sum())
    torch.cuda.synchronize()
    for name, by_dt in signed.items():
        out[name]["mean_signed_err"] = {dt: t / c for dt, (t, c) in by_dt.items()}
    return out, n, rows_equal


def time_paged(torch, M, cfg, dev, seed):
    """Each paged kernel at served shapes, bf16: decode at 8 slots with the
    lengths a mid-run decode step of phase 25 sees (system prompt + suffix
    + half the new tokens), a verify pass (8 x 5 rows at those lengths) and
    prefill chunks (8 slots x 32 rows, the first wave's share of the 256-
    token step, and 8 x 256 after an adopted 256-token prefix). Per case:
    the kernel, its plain version and its eager time; the library yardstick
    SDPA (GQA, boolean mask) over K/V already gathered into dense tensors,
    with the gather's own time beside it; and the bound: the live K/V cells
    (each read once), q, o, the live table entries and the lengths over
    3.35 TB/s against 4 x live (query, key) pairs x H x hd at the bf16 peak."""
    import numpy as np
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(seed + 26)
    rng = np.random.default_rng(seed + 25)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, bf = 8, torch.bfloat16
    suffix = rng.integers(PAGED_SUFFIX[0], PAGED_SUFFIX[1] + 1, size=B)
    served = [int(PAGED_SYSTEM + s + PAGED_NEW // 2) for s in suffix]
    plain = plain_paged(M)

    def sdpa(q, k, v, mask):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask,
                                              enable_gqa=True).transpose(1, 2)

    out = {}
    for name, Sq, q_off in (("decode", 1, [n - 1 for n in served]),
                            ("verify", 5, [n - 1 for n in served]),
                            ("prefill_chunk", 32, [0] * B),
                            ("prefill_long", 256, [PAGED_SYSTEM] * B)):
        q_off_t = torch.tensor(q_off, dtype=torch.int32, device=dev)
        kv_len = (q_off_t + Sq).to(torch.int32)
        n_blk = [-(-int(x) // PAGED_BS) for x in kv_len]
        per_set = (sum(n_blk) * PAGED_BS * KV * hd * 2 * 2 + B * Sq * H * hd * 4)
        sets = []
        for _ in range(max(2, int(120e6 // per_set) + 1)):
            k, v, tables = paged_inputs(torch, gen, dev, cfg, B)
            t = dead_entries(torch, tables, kv_len)
            q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).to(bf)
            sets.append((q, k, v, t))
        decode = Sq == 1
        if decode:
            def kern(s):
                return M.PA.paged_decode_attention(s[0], s[1], s[2], s[3], kv_len)

            def plain_fn(s):
                return plain["paged_decode_attention"](s[0], s[1], s[2], s[3], kv_len)
        else:
            def kern(s):
                return M.PA.paged_prefill_attention(*s, q_off_t, kv_len)

            def plain_fn(s):
                return plain["paged_prefill_attention"](*s, q_off_t, kv_len)
        L = PAGED_NB * PAGED_BS
        qpos = q_off_t[:, None] + torch.arange(Sq, device=dev)[None, :]
        kpos = torch.arange(L, device=dev)[None, None, :]
        mask = ((kpos <= qpos[..., None]) & (kpos < kv_len[:, None, None]))[:, None]
        gathered = [(s[0], M.PREF.gather_blocks(s[1], s[3]), M.PREF.gather_blocks(s[2], s[3]))
                    for s in sets]
        n_sets = len(sets)
        ref_err = rel_err(torch, sdpa(*gathered[0], mask), kern(sets[0]))
        check(ref_err <= 2e-2, f"SDPA yardstick disagrees with the paged {name} ({ref_err:g})")
        live_pairs = int(sum(min(q_off[b] + r + 1, int(kv_len[b]))
                             for b in range(B) for r in range(Sq)))
        bytes_ = (sum(n_blk) * PAGED_BS * KV * hd * 2 * 2       # live K/V blocks
                  + 2 * B * Sq * H * hd * 2                     # q, o
                  + sum(n_blk) * 4 + B * 4 * (1 if decode else 2))
        out[name] = dict(
            ms=graph_ms(torch, lambda i: kern(sets[i]), n_sets),
            plain_ms=graph_ms(torch, lambda i: plain_fn(sets[i]), n_sets),
            library_ms=graph_ms(torch, lambda i: sdpa(*gathered[i], mask), n_sets),
            gather_ms=graph_ms(torch, lambda i: (M.PREF.gather_blocks(sets[i][1], sets[i][3]),
                                                 M.PREF.gather_blocks(sets[i][2], sets[i][3])),
                               n_sets),
            eager_ms=eager_ms(torch, lambda i: kern(sets[i]), n_sets),
            bound=bound(bytes_, bf16_ops=4.0 * live_pairs * H * hd), sdpa_rel_err=ref_err,
            calls=1, work=f"one {name} call per layer: {B} slots x {Sq} rows, q_off {q_off}, "
                          f"kv_len {kv_len.tolist()}, bf16")
        del sets, gathered
    return out


def paged_cfg():
    """Phases 24-26's model: smollm-360m at full width and PAGED_LAYERS layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("smollm-360m"), n_layers=PAGED_LAYERS)


def paged_engine(torch, dev, **kw):
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve import make_serve_engine
    scfg = ServeConfig(max_batch=8, max_len=PAGED_MAX_LEN, quant_mode="int8_switchback",
                       cache_mode="paged", block_size=PAGED_BS, **kw)
    return make_serve_engine(paged_cfg(), scfg, device=dev)


def expected_paged_launches(cfg, stats) -> dict:
    """Each wrapper's launches for a paged generate: the SwitchBack forward
    kernels per layer per model call (prefill, verify or decode), the
    paged decode kernel per layer per plain decode step, the paged prefill
    kernel per layer per prefill or verify call; the flash kernels none."""
    L = cfg.n_layers
    verify = stats["spec_verify_calls"]
    calls = stats["prefill_calls"] + stats["decode_steps"]
    want = {k: per * L * calls for k, per in PER_LAYER.items()}
    want.update(flash_fwd=0, decode_fwd=0,
                paged_decode_fwd=L * (stats["decode_steps"] - verify),
                paged_prefill_fwd=L * (stats["prefill_calls"] + verify),
                **dict.fromkeys(OP_KERNELS, 0))
    return want


def check_launches(counts, want, what):
    for k, n in counts.items():
        check(n == want.get(k, 0), f"{what}: {k}: {n} launches, expected {want.get(k, 0)}")
    for k, n in want.items():
        if n:
            check(counts.get(k, 0) > 0, f"{what}: {k} never launched")


def paged_serve(torch, M, cfg, dev, seed):
    """Phase 25: full-width smollm-360m through the paged engine,
    int8_switchback, chunked prefill: 32 requests sharing a 256-token
    system prompt, 64 new tokens, greedy. Every launch counter exactly its
    worked-out count (zeroed just before, read just after)."""
    import numpy as np
    t = time.perf_counter()
    eng = paged_engine(torch, dev, prefill_chunk_tokens=PAGED_CHUNK)
    check(eng.parallel.attn_impl == "flash_scan",
          f"the engine's default attn_impl is {eng.parallel.attn_impl!r}")
    params = eng.init_params(seed)
    torch.cuda.synchronize()
    print(f"[paged serve] engine ({eng.num_blocks} blocks of {PAGED_BS}, table width "
          f"{eng.blocks_per_slot}) + params in {time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(seed + 25)
    system = rng.integers(0, cfg.vocab_size, size=PAGED_SYSTEM).tolist()
    suffix = rng.integers(PAGED_SUFFIX[0], PAGED_SUFFIX[1] + 1, size=PAGED_REQUESTS)
    prompts = [system + rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in suffix]
    eng.generate(params, prompts[:8], max_new_tokens=2)          # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(M)
    gens, stats = eng.generate(params, prompts, max_new_tokens=PAGED_NEW)
    counts = launch_counts(M)
    check(len(gens) == PAGED_REQUESTS and all(len(g) == PAGED_NEW for g in gens),
          f"not every request got {PAGED_NEW} tokens: {[len(g) for g in gens]}")
    check(all(0 <= x < cfg.vocab_size for g in gens for x in g), "a token outside the vocabulary")
    check_launches(counts, expected_paged_launches(cfg, stats), "paged serve")
    check(stats["prefix_hits"] > 0 and stats["prefill_chunks"] > stats["prefill_calls"],
          f"no prefix reuse or no chunking: {stats['prefix_hits']} hits, "
          f"{stats['prefill_chunks']} chunks over {stats['prefill_calls']} calls")
    print(f"[paged serve] {stats['new_tokens']} new tokens ({stats['prefill_tokens']} prefilled, "
          f"{stats['prefill_tokens_saved']} adopted) in {stats['wall_s']:.3f} s: "
          f"{stats['tokens_per_s']:.1f} tok/s, decode {stats['decode_tokens_per_s']:.1f} tok/s; "
          f"ttft p50 {stats['ttft_p50_s'] * 1e3:.1f} ms p95 {stats['ttft_p95_s'] * 1e3:.1f} ms; "
          f"itl p50 {stats['itl_p50_s'] * 1e3:.2f} ms p95 {stats['itl_p95_s'] * 1e3:.2f} ms; "
          f"prefix hit rate {stats['prefix_hit_rate']:.3f}; {stats['prefill_chunks']} chunks "
          f"over {stats['prefill_calls']} prefill calls, {stats['decode_steps']} decode steps; "
          f"peak cache {stats['peak_cache_bytes'] / 2**20:.1f} MiB vs ring "
          f"{stats['ring_equiv_cache_bytes'] / 2**20:.1f} MiB; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("[paged serve] launches:", json.dumps(counts))
    print("[paged serve] stats:", json.dumps(stats))
    return eng, params, stats, counts


def paged_run_logits(eng, params, toks, lens, fed):
    """A paged prefill over fresh tables (slot b owns blocks b * nb ...)
    plus three decode steps fed ``fed`` (or the run's own greedy tokens):
    the last-position logits of each call, and the tokens fed."""
    import numpy as np
    B, nb = eng.serve_cfg.max_batch, eng.blocks_per_slot
    tables = np.arange(B * nb, dtype=np.int32).reshape(B, nb)
    cache = eng.init_cache()
    lg, cache = eng.prefill_paged(params, cache, tables, toks, np.zeros((B,), np.int32), lens,
                                  np.ones((B,), bool))
    steps, own = [lg[:, 0]], []
    for i in range(3):
        own.append(lg[:, 0].argmax(-1).cpu().numpy()[:, None])
        lg, cache = eng.decode_paged(params, cache, tables, own[i] if fed is None else fed[i])
        steps.append(lg[:, 0])
    return steps, own


def paged_whole_model(torch, M, eng, params, cfg, seed):
    """Phase 25, the served model kernels vs plain: prefill (8 slots,
    PAGED_CHECK_LENS tokens) plus three decode steps with the kernels and with the plain
    versions swapped in (both paged kernels and the SwitchBack kernels, as
    phase 5 swaps them), and the control fault (KV heads tiled) on the plain
    path, from CHECK_SEEDS seeds: (max, mean) |diff| over max|logit| within
    PAGED_MODEL_TOL, the fault outside. Returns the readings per seed."""
    import numpy as np
    res = []
    for s in check_seeds(seed, 250):
        rng = np.random.default_rng(s)
        lens = rng.integers(PAGED_CHECK_LENS[0], PAGED_CHECK_LENS[1] + 1,
                            size=eng.serve_cfg.max_batch).astype(np.int32)
        toks = rng.integers(0, cfg.vocab_size, size=(len(lens), PAGED_CHECK_LENS[1]))
        kern, fed = paged_run_logits(eng, params, toks, lens, None)
        with plain_ops(M, flash=True):
            plain, _ = paged_run_logits(eng, params, toks, lens, fed)
            with tiled_kv_heads(M):
                fault, _ = paged_run_logits(eng, params, toks, lens, fed)
        check(all(bool(torch.isfinite(a).all()) for a in kern), "paged whole model: non-finite")
        sound, bad = rel_errs(kern, plain), rel_errs(fault, plain)
        res.append(dict(seed=s, max_rel_err=sound[0], mean_rel_err=sound[1],
                        fault_max_rel_err=bad[0], fault_mean_rel_err=bad[1],
                        bitwise=all(torch.equal(a, b) for a, b in zip(kern, plain))))
    print("[paged whole model] prefill + 3 decode steps, 8 slots, "
          f"{cfg.n_layers} layers, kernels vs plain, limit {PAGED_MODEL_TOL}: " + json.dumps(res))
    worst = (max(r["max_rel_err"] for r in res), max(r["mean_rel_err"] for r in res))
    fault_min = (min(r["fault_max_rel_err"] for r in res),
                 min(r["fault_mean_rel_err"] for r in res))
    check(worst[0] <= PAGED_MODEL_TOL[0] and worst[1] <= PAGED_MODEL_TOL[1],
          f"paged whole model: kernels vs plain {worst} > {PAGED_MODEL_TOL}")
    check(fault_min[0] > PAGED_MODEL_TOL[0] and fault_min[1] > PAGED_MODEL_TOL[1],
          f"paged whole model: the control fault {fault_min} lies within {PAGED_MODEL_TOL}")
    return res



def paged_features(torch, M, cfg, dev, seed, params):
    """Phase 26 at full width: (a) a tight pool (TIGHT_SHARE of the prompts'
    blocks) with preemption="recompute" against a roomy one on the same
    requests: the tight run preempts, and every request's tokens, the
    preemptees' among them, equal the roomy run's; (b) spec_mode="ngram" on repetitive prompts against spec off:
    drafts accepted, tokens equal, the launch counts exact; (c) what a
    verify row and a decode step compute: the logits of a 5-row verify pass
    against four decode steps' on the same cache, bit for bit or not
    (printed)."""
    import numpy as np
    rng = np.random.default_rng(seed + 26)
    res = {}
    # (a) preemption
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(PREEMPT_PROMPTS[0], PREEMPT_PROMPTS[1] + 1, size=8)]
    blocks = [-(-len(p) // PAGED_BS) for p in prompts]
    worst = max(-(-(len(p) + PREEMPT_NEW - 1) // PAGED_BS) for p in prompts)
    tight = max(worst, int(TIGHT_SHARE * sum(blocks)))
    gens = {}
    for name, nb in (("roomy", 0), ("tight", tight)):
        eng = paged_engine(torch, dev, num_blocks=nb, preemption="recompute",
                           prefill_chunk_tokens=PAGED_CHUNK)
        reset_launch_counts(M)
        gens[name], st = eng.generate(params, prompts, max_new_tokens=PREEMPT_NEW)
        check_launches(launch_counts(M), expected_paged_launches(cfg, st), f"preemption {name}")
        res[name] = {k: st[k] for k in ("sched_preempted", "peak_blocks_in_use", "num_blocks",
                                        "prefill_calls", "decode_steps", "tokens_per_s")}
    check(res["roomy"]["sched_preempted"] == 0 and res["tight"]["sched_preempted"] >= 1,
          f"preemption: {res}")
    differ = [i for i, (a, b) in enumerate(zip(gens["roomy"], gens["tight"])) if a != b]
    res["requests_differing"] = differ
    check(not differ, f"preemption: requests {differ} differ from the roomy run")
    # (b) n-gram speculative decoding on repetitive prompts
    pats = [rng.integers(0, cfg.vocab_size, size=int(p)).tolist() for p in rng.integers(3, 8, 8)]
    prompts = [(p * 100)[:int(n)] for p, n in
               zip(pats, rng.integers(SPEC_PROMPTS[0], SPEC_PROMPTS[1] + 1, size=8))]
    for name, kw in (("spec_off", {}), ("spec_on", dict(spec_mode="ngram", spec_k=4,
                                                        spec_min_ngram=1))):
        eng = paged_engine(torch, dev, **kw)
        reset_launch_counts(M)
        gens[name], st = eng.generate(params, prompts, max_new_tokens=PAGED_NEW)
        check_launches(launch_counts(M), expected_paged_launches(cfg, st), name)
        res[name] = {k: st[k] for k in ("spec_drafted", "spec_accepted", "spec_verify_calls",
                                        "tokens_per_model_pass", "decode_steps", "tokens_per_s")}
    differ = [i for i, (a, b) in enumerate(zip(gens["spec_off"], gens["spec_on"])) if a != b]
    res["spec_requests_differing"] = differ
    check(res["spec_on"]["spec_accepted"] > 0, f"spec: no draft accepted {res['spec_on']}")
    check(not differ, f"spec: requests {differ} differ from spec off")
    # (c) a verify pass's rows against decode steps, logits bit for bit?
    B, nb = eng.serve_cfg.max_batch, eng.blocks_per_slot
    tables = np.arange(B * nb, dtype=np.int32).reshape(B, nb)
    toks, lens = prompt_batch(prompts, B, SPEC_PROMPTS[1])
    ones = np.ones((B,), bool)
    cache = eng.init_cache()
    lg, cache = eng.prefill_paged(params, cache, tables, toks, np.zeros((B,), np.int32), lens,
                                  ones)
    fed = [lg[:, 0].argmax(-1).cpu().numpy()]
    dec = []
    for _ in range(4):
        lg, cache = eng.decode_paged(params, cache, tables, fed[-1][:, None])
        dec.append(lg[:, 0])
        fed.append(lg[:, 0].argmax(-1).cpu().numpy())
    cache = eng.init_cache()
    eng.prefill_paged(params, cache, tables, toks, np.zeros((B,), np.int32), lens, ones)
    with torch.inference_mode():
        ver, _ = eng._paged_prefill(params, cache, tables, np.stack(fed[:5], 1), lens,
                                    lens + 5, ones, last_only=False)
    res["verify_vs_decode"] = dict(
        bitwise=[bool(torch.equal(ver[:, j], dec[j])) for j in range(4)],
        max_abs_diff=[float((ver[:, j].float() - dec[j].float()).abs().max()) for j in range(4)],
        argmax_equal=[bool(torch.equal(ver[:, j].argmax(-1), dec[j].argmax(-1)))
                      for j in range(4)])
    print("[paged features]", json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 27: the op entry points wgrad_bf16 and fp8_cast_tensorwise
# ---------------------------------------------------------------------------

# wgrad_bf16 against cuBLAS: a bf16 product is exact in f32, and any order
# of summing B such products in f32 lies within (B - 1) * 2^-24 *
# (|X|^T |Ẏ|) of the exact sum, so two orders differ by at most
# B * WGRAD_BOUND * (|X|^T |Ẏ|) elementwise. The kernel's tensor-core
# windows truncate inside each window (REF.wgrad_bound counts it: (71 +
# (windows - 1) / 2) 2^-23 against the exact sum at worst), and cuBLAS sums
# on the tensor cores too; the limit stays as the cross-check against an
# independent implementation (the readings, far inside it, in PERF.md). Ẏ's
# rows shifted by one (the control fault) must read outside it.
WGRAD_BOUND = 2.0 ** -23
# the two inputs where the JAX package's Pallas kernel (the reciprocal,
# then the product) and its XLA path (x / absmax) round to different fp8
# values: (fmt, absmax, x, the Pallas kernel's value)
CAST_SPLIT_CASES = (("e4m3", 3.0, 0.0556640587747097, 0.01953125),
                    ("e5m2", 7.0, 0.00037384030292741954, 6.103515625e-05))


def op_wgrad_shapes(cfg, clip_cfg):
    """{set: [(B, K, M, dtype name)]} of phase 27's wgrad_bf16 calls: smollm's
    weights at 2,048 rows (wq 960 -> 960, wk 960 -> 320, w_up 960 -> 2,560,
    w_down 2,560 -> 960) and two of them at the ragged 8 and 1,000 rows (one
    in f32, rounded to bf16 on entry); one CLIP vision layer's four weight
    gradients at 4,128 rows (wq, wk, wv as one 1,280 -> 3,840 product, wo,
    w_up, w_down), the text layer's at 2,464 and the patch embedding at
    8,192 x 588 -> 1,280."""
    from repro_torch.models.clip import n_kept_patches
    D, FF = cfg.d_model, cfg.d_ff
    KV = cfg.n_kv_heads * cfg.hd
    smollm = [(TRAIN_ROWS, D, D), (TRAIN_ROWS, D, KV), (TRAIN_ROWS, D, FF), (TRAIN_ROWS, FF, D)]
    ragged = [(8, D, KV), (8, FF, D), (1000, D, KV), (1000, FF, D)]

    def layer(B, W, F):
        return [(B, W, 3 * W), (B, W, W), (B, W, F), (B, F, W)]

    c = clip_cfg
    return {
        "smollm": [(*s, "bfloat16") for s in smollm],
        "ragged": [(*s, "float32" if i == 3 else "bfloat16") for i, s in enumerate(ragged)],
        "clip_vision": [(*s, "bfloat16") for s in layer(
            CLIP_BATCH * (n_kept_patches(c) + 1), c.vision_width, c.vision_ff)],
        "clip_text": [(*s, "bfloat16") for s in layer(CLIP_BATCH * c.text_ctx, c.text_width,
                                                      c.text_ff)],
        "patch_embed": [(CLIP_BATCH * c.n_patches, 3 * c.patch_size ** 2, c.vision_width,
                         "bfloat16")],
    }


def op_cast_shapes(clip_cfg):
    """(R, C, dtype name) of phase 27's fp8_cast_tensorwise inputs: the JAX
    package's test shapes (130 columns; 1,030 rows ragged against its
    512-row blocks) in f32 and bf16, and CLIP's: the vision tower's
    activations X (4,128 rows x 1,280 and 5,120) in bf16 and its weights W
    (1,280 x 3,840, 1,280 x 5,120) in f32."""
    from repro_torch.models.clip import n_kept_patches
    c = clip_cfg
    R = CLIP_BATCH * (n_kept_patches(c) + 1)
    W, F = c.vision_width, c.vision_ff
    jax_shapes = [(r, 130, dt) for r in (17, 257, 512, 1030) for dt in ("float32", "bfloat16")]
    return jax_shapes + [(R, W, "bfloat16"), (R, F, "bfloat16"), (W, 3 * W, "float32"),
                         (W, F, "float32")]


def cast_input(torch, gen, R, C, fmt, dtype, dev):
    """Random rows over several binades below 64, then: x[0, 0] = 64 (the
    tensor's absmax, so 1/absmax = 2^-6 is exact), row 1 the fp8 ties in
    [-1, 1] times 64 (exact ties after scaling), row 2 fp8-subnormal values
    and ties there, times 64, row 3 zeros of both signs."""
    from repro_torch.core.fp8 import SPECS, fp8_values
    spec = SPECS[fmt]
    v = torch.from_numpy(fp8_values(spec)).to(dev, torch.float64)
    grid = torch.cat([-v.flip(0), v[1:]])
    unit = grid[grid.abs() <= 1.0]
    ties = (unit[:-1] + unit[1:]) / 2
    small = torch.cat([unit, ties])
    sub = small[small.abs() < 2.0 ** (1 - spec.bias)]
    x = torch.randn((R, C), generator=gen, device=dev)
    x = x * torch.exp(torch.empty((R, 1), device=dev).uniform_(-4, 0.5, generator=gen))
    x = x.clamp(-63, 63)
    x[1] = (ties * 64).float().repeat(-(-C // len(ties)))[:C]
    x[2] = (sub * 64).float().repeat(-(-C // len(sub)))[:C]
    x[3] = torch.where(torch.arange(C, device=dev) % 2 == 0, 0.0, -0.0)
    x[0, 0] = 64.0
    return x.to(getattr(torch, dtype))


def op_transpose_shapes(clip_cfg):
    """``transpose_bytes``' cases: every fp8 weight shape (K, M) of CLIP and
    the cuda tests' ragged ones."""
    return sorted({(K, Mw) for K, Mw, _ in clip_linears(clip_cfg)}) + [(130, 70), (37, 5)]


def drive_op_path(torch, M, cfg, clip_cfg, dev, seed):
    """Phase 27, the path: the op entry points called once at every case
    (``op_wgrad_shapes``; ``op_cast_shapes`` x both formats x three
    absmaxes, an all-zero tensor with absmax 0 per format, and
    CAST_SPLIT_CASES; ``transpose_bytes`` of E4M3 codes at
    ``op_transpose_shapes``, since the fp8 paths take W's K-major copy from
    tensor_quantize_kt), every launch counter zeroed just before and read
    just after: each kernel exactly its number of calls, every other 0.
    Returns the cases with their outputs and the counts."""
    gen = torch.Generator(device=dev).manual_seed(seed + 27)
    wcases = []
    for group, shapes in op_wgrad_shapes(cfg, clip_cfg).items():
        for B, K, Mw, dt in shapes:
            x = torch.randn((B, K), generator=gen, device=dev).to(getattr(torch, dt))
            g = torch.randn((B, Mw), generator=gen, device=dev).to(getattr(torch, dt))
            wcases.append(dict(group=group, shape=(B, K, Mw), dtype=dt, x=x, g=g))
    ccases = []
    for R, C, dt in op_cast_shapes(clip_cfg):
        for fmt in ("e4m3", "e5m2"):
            x = cast_input(torch, gen, R, C, fmt, dt, dev)
            am = x.float().abs().amax()
            for kind, absmax in (("tensor", am), ("stale", am * 3.7), ("clips", am * 2.0 ** -17)):
                ccases.append(dict(shape=(R, C), dtype=dt, fmt=fmt, absmax_kind=kind, x=x,
                                   absmax=absmax))
    for fmt in ("e4m3", "e5m2"):
        ccases.append(dict(shape=(33, 130), dtype="float32", fmt=fmt, absmax_kind="zero",
                           x=torch.zeros((33, 130), device=dev),
                           absmax=torch.zeros((), device=dev)))
    for fmt, am, xv, want in CAST_SPLIT_CASES:
        ccases.append(dict(shape=(4, 130), dtype="float32", fmt=fmt, absmax_kind="split",
                           x=torch.full((4, 130), xv, device=dev),
                           absmax=torch.full((), am, device=dev), want=want))
    tcases = [dict(shape=(K, Mw), w_q=M.F8.tensor_quantize(weight(torch, gen, K, Mw, dev),
                                                           "e4m3")[0])
              for K, Mw in op_transpose_shapes(clip_cfg)]
    torch.cuda.synchronize()

    reset_launch_counts(M)
    for c in wcases:
        c["out"] = M.KOPS.wgrad_bf16(c["x"], c["g"])
    for c in ccases:
        c["out"] = M.FC.fp8_cast_tensorwise(c["x"], c["absmax"], c["fmt"])
    for c in tcases:
        c["out"] = M.F8.transpose_bytes(c["w_q"])
    torch.cuda.synchronize()
    counts = launch_counts(M)
    check_launches(counts, {"wgrad_bf16": len(wcases), "fp8_cast_tensorwise": len(ccases),
                            "fp8_transpose_bytes": len(tcases)}, "op entry points")
    return wcases, ccases, tcases, counts


def compare_op_kernels(torch, M, wcases, ccases, tcases, seed):
    """Phase 27, the checks on the path's outputs: each run again for the
    same bits; the outputs finite, of the expected shape. transpose_bytes
    byte for byte the plain copy. fp8_cast_tensorwise
    bit-equal to its plain version; fp8 values only (on the grid of the
    format, within [-fmax, fmax]); the all-zero tensor gives zeros, the
    split inputs the Pallas kernel's value. wgrad_bf16, on bf16 wgmma, whose
    windows sum in another order than the plain in-order loop: within
    ``REF.wgrad_bound`` of it per output, bit-equal to it on exactly
    summable inputs (``F8REF.exact_entries``) at the same shape, and
    bit-equal to ``F8TC.wgrad_rows`` (the tensor cores' steps chained as
    the kernel chains them) at ``F8TC.check_rows``; against cuBLAS within
    WGRAD_BOUND; the control fault (Ẏ's rows shifted by one) outside both
    bounds. Returns the readings."""
    from repro_torch.core import switchback as SB
    from repro_torch.core.fp8 import SPECS, fp8_values
    from repro_torch.kernels.fp8_cast import ref as FCREF
    worst = dict(wgrad_bf16=0.0, fp8_cast_tensorwise=0.0, fp8_transpose_bytes=0.0)
    for c in tcases:
        w_q, out = c["w_q"], c["out"]
        what = f"fp8_transpose_bytes {c['shape']}"
        plain = w_q.view(torch.uint8).t().contiguous()
        check(out.dtype == torch.uint8 and torch.equal(out, plain), f"{what}: kernel != plain")
        check(torch.equal(out, M.F8.transpose_bytes(w_q)), f"{what}: two launches differ")
    lib_ratio, fault_ratio = 0.0, math.inf
    bound_share, fault_share, model_outputs = 0.0, math.inf, 0
    by_group = {}
    gen = torch.Generator(device=wcases[0]["x"].device).manual_seed(seed + 127)
    for c in wcases:
        x, g, out = c["x"], c["g"], c["out"]
        B, K, Mw = c["shape"]
        what = f"wgrad_bf16 {c['group']} {c['shape']} {c['dtype']}"
        check(tuple(out.shape) == (K, Mw) and out.dtype == torch.float32
              and bool(torch.isfinite(out).all()), f"{what}: bad output")
        check(torch.equal(out.view(torch.int32), M.KOPS.wgrad_bf16(x, g).view(torch.int32)),
              f"{what}: two launches differ")
        plain = M.REF.wgrad_bf16(x, g)
        worst["wgrad_bf16"] = max(worst["wgrad_bf16"], max_abs_diff(torch, out, plain))
        wb = M.REF.wgrad_bound(plain, x, g)
        share = float(((out.double() - plain.double()).abs() / wb).max())
        check(share <= 1.0, f"{what}: |kernel - plain| {share:g} x REF.wgrad_bound")
        rows = torch.tensor(M.F8TC.check_rows(K), device=x.device)
        model = M.F8TC.wgrad_rows(x, g, rows)
        off = int((out[rows].view(torch.int32) != model.view(torch.int32)).sum())
        check(off == 0, f"{what}: {off} of {model.numel()} check-row outputs off the "
              "tensor-core model (F8TC.wgrad_rows)")
        model_outputs += model.numel()
        xe = M.F8REF.exact_entries((B, K), gen, x.device)
        ge = M.F8REF.exact_entries((B, Mw), gen, x.device)
        exact = M.KOPS.wgrad_bf16(xe, ge)
        check(torch.equal(exact.view(torch.int32), M.REF.wgrad_bf16(xe, ge).view(torch.int32)),
              f"{what}: kernel != plain on exact entries")
        del xe, ge, exact, model
        xb, gb = x.to(torch.bfloat16).double(), g.to(torch.bfloat16).double()
        bound = B * WGRAD_BOUND * (xb.abs().t() @ gb.abs())
        lib = SB.wgrad_16bit(x, g).double()
        diff = (out.double() - lib).abs()
        check(bool((diff <= bound).all()), f"{what}: |kernel - cuBLAS| outside the bound, "
              f"max ratio {float((diff / bound.clamp_min(1e-300)).max()):g}")
        shifted = M.KOPS.wgrad_bf16(x, g.roll(1, dims=0)).double()
        fault = (shifted - lib).abs()
        check(not bool((fault <= bound).all()), f"{what}: the control fault reads inside the bound")
        fs = float(((shifted - plain.double()).abs() / wb).max())
        check(fs > 1.0, f"{what}: the control fault reads inside REF.wgrad_bound ({fs:g})")
        r = float((diff / bound.clamp_min(1e-300)).max())
        f = float((fault / bound.clamp_min(1e-300)).max())
        lib_ratio, fault_ratio = max(lib_ratio, r), min(fault_ratio, f)
        bound_share, fault_share = max(bound_share, share), min(fault_share, fs)
        grp = by_group.setdefault(c["group"], dict(cases=0, lib_ratio=0.0, fault_ratio=math.inf,
                                                   bound_share=0.0, fault_share=math.inf))
        grp.update(cases=grp["cases"] + 1, lib_ratio=max(grp["lib_ratio"], r),
                   fault_ratio=min(grp["fault_ratio"], f),
                   bound_share=max(grp["bound_share"], share),
                   fault_share=min(grp["fault_share"], fs))
        del bound, lib, diff, fault, shifted, wb, plain
    grids = {fmt: torch.from_numpy(fp8_values(SPECS[fmt])).float().to(wcases[0]["x"].device)
             for fmt in ("e4m3", "e5m2")}
    for c in ccases:
        x, absmax, fmt, out = c["x"], c["absmax"], c["fmt"], c["out"]
        what = f"fp8_cast_tensorwise {c['shape']} {c['dtype']} {fmt} {c['absmax_kind']}"
        check(tuple(out.shape) == tuple(x.shape) and out.dtype == torch.float32
              and bool(torch.isfinite(out).all()), f"{what}: bad output")
        check(bool(torch.isin(out.abs(), grids[fmt]).all()), f"{what}: values off the fp8 grid")
        plain = FCREF.fp8_cast_tensorwise(x, absmax, fmt)
        worst["fp8_cast_tensorwise"] = max(worst["fp8_cast_tensorwise"],
                                           max_abs_diff(torch, out, plain))
        check(torch.equal(out.view(torch.int32), plain.view(torch.int32)),
              f"{what}: kernel != plain, max |diff| {max_abs_diff(torch, out, plain):g}")
        check(torch.equal(out.view(torch.int32),
                          M.FC.fp8_cast_tensorwise(x, absmax, fmt).view(torch.int32)),
              f"{what}: two launches differ")
        if c["absmax_kind"] == "zero":
            check(not bool(out.any()), f"{what}: not all zero")
        if c["absmax_kind"] == "clips":
            check(float(out.abs().max()) == SPECS[fmt].max_value, f"{what}: nothing clipped")
        if "want" in c:
            check(bool((out == c["want"]).all()), f"{what}: not the Pallas kernel's value "
                  f"{c['want']!r}: {float(out[0, 0])!r}")
    res = dict(wgrad_cases=len(wcases), cast_cases=len(ccases), transpose_cases=len(tcases),
               max_abs_err=worst,
               wgrad_bound_share=bound_share, wgrad_fault_bound_share=fault_share,
               wgrad_model_outputs=model_outputs,
               wgrad_vs_cublas_max_ratio=lib_ratio, wgrad_fault_min_ratio=fault_ratio,
               wgrad_by_group=by_group)
    print("[op kernels]", json.dumps(res))
    return res


def time_op_kernels(torch, M, cfg, clip_cfg, dev, seed):
    """Phase 27's times: ``wgrad_bf16`` at one CLIP vision layer's four
    weight gradients (4,128 rows) and at smollm's four at 2,048 rows,
    beside the bound (bytes, or 2 B K M operations at the bf16 tensor-core
    peak), the plain version (the in-order loop; timed over 2 graph
    replays, it runs B launches a product) and cuBLAS (``wgrad_16bit``,
    timed only); ``fp8_cast_tensorwise`` (E4M3) at CLIP's four shapes
    together and each alone, beside its bound (bytes) and plain version.
    No single PyTorch call computes the fp8 cast (scale, clip, the grid
    round and the widening are separate ops; a cast to the fp8 dtype rounds
    otherwise), so its library time is none."""
    from repro_torch.core import switchback as SB
    from repro_torch.kernels.fp8_cast import ref as FCREF
    gen = torch.Generator(device=dev).manual_seed(seed + 57)
    shapes = op_wgrad_shapes(cfg, clip_cfg)
    out = {}
    for group in ("clip_vision", "smollm"):
        pairs = [(torch.randn((B, K), generator=gen, device=dev).bfloat16(),
                  torch.randn((B, Mw), generator=gen, device=dev).bfloat16())
                 for B, K, Mw, _ in shapes[group]]
        torch.cuda.synchronize()
        bytes_ = sum(B * K * 2 + B * Mw * 2 + K * Mw * 4 for B, K, Mw, _ in shapes[group])
        ops = sum(2 * B * K * Mw for B, K, Mw, _ in shapes[group])
        out[group] = dict(
            ms=graph_ms(torch, lambda i: [M.KOPS.wgrad_bf16(x, g) for x, g in pairs], 1),
            plain_ms=graph_ms(torch, lambda i: [M.REF.wgrad_bf16(x, g) for x, g in pairs], 1,
                              reps=2),
            library_ms=graph_ms(torch, lambda i: [SB.wgrad_16bit(x, g) for x, g in pairs], 1),
            eager_ms=eager_ms(torch, lambda i: [M.KOPS.wgrad_bf16(x, g) for x, g in pairs], 1,
                              iters=3),
            bound=bound(bytes_, bf16_ops=ops), calls=len(pairs),
            work=f"{group}: {len(pairs)} calls (B, K, M) "
                 + ", ".join(f"{B}x{K}x{Mw}" for B, K, Mw, _ in shapes[group]))
        out[group]["tflops"] = ops / (out[group]["ms"] * 1e-3) / 1e12
        del pairs
    clip_shapes_ = op_cast_shapes(clip_cfg)[-4:]
    xs = [(cast_input(torch, gen, R, C, "e4m3", dt, dev)) for R, C, dt in clip_shapes_]
    amax = [x.float().abs().amax() for x in xs]
    torch.cuda.synchronize()

    def cast_times(idx):
        n_bytes = sum(xs[i].numel() * (xs[i].element_size() + 4) for i in idx)
        n = sum(xs[i].numel() for i in idx)
        kern = lambda i: [M.FC.fp8_cast_tensorwise(xs[j], amax[j], "e4m3") for j in idx]
        return dict(ms=graph_ms(torch, kern, 1),
                    plain_ms=graph_ms(torch, lambda i: [FCREF.fp8_cast_tensorwise(
                        xs[j], amax[j], "e4m3") for j in idx], 1),
                    library_ms=None, eager_ms=eager_ms(torch, kern, 1),
                    # per element: the product, the clip's two compares and the
                    # subnormal branch's product, in f32
                    bound=bound(n_bytes, f32_ops=4 * n), calls=len(idx), bytes=n_bytes)

    out["cast"] = cast_times(range(len(xs)))
    out["cast"]["work"] = "CLIP's four casts, one call each: " + ", ".join(
        f"{R}x{C} {dt}" for R, C, dt in clip_shapes_)
    out["cast"]["per_shape"] = {f"{R}x{C} {dt}": cast_times([i])
                                for i, (R, C, dt) in enumerate(clip_shapes_)}
    del xs
    print("[timing] op kernels:", json.dumps(out))
    return out


# ---------------------------------------------------------------------------

# -- phase 29: self-healing CLIP training and the flight recorder -----------
# CLIP ViT-H/14 at full width and 2 + 2 layers, int8_switchback with
# zero-init layer-scale, batch CLIP_BATCH, patch dropout 0.5, StableAdamW;
# data index j -> DeterministicBatcher over SyntheticCLIP(seed =
# SELFHEAL_DATA_SEED + j), a pure function of j
SELFHEAL_STEPS, SELFHEAL_EVERY, SELFHEAL_KEEP = 12, 3, 4
SELFHEAL_DATA_SEED = 2900
# (c)'s plan: a NaN gradient at data index 7, checkpoint 6 bit-flipped after
# its write, checkpoint 9's write failing, a gradient explosion at data
# index 13 (reached after the first rewind's skip)
SELFHEAL_PLAN = (dict(step=7, kind="nan_grad"), dict(step=6, kind="corrupt_ckpt", key="step"),
                 dict(step=9, kind="fail_save", key="step"), dict(step=13, kind="explode_grad"))
# detection that only the injected faults can trip: the EMA ratios far past
# any sound step's spread, the spike detector's history past the run
SELFHEAL_SUP = dict(checkpoint_every=SELFHEAL_EVERY, keep_checkpoints=SELFHEAL_KEEP,
                    log_every=0, detect_warmup=2, grad_norm_ratio=1e3, loss_jump_ratio=1e3,
                    spike_min_history=100)
SELFHEAL_PROFILE = (2, 3)
# (c)'s report() and (f)'s event sequence, pinned on the CPU against the
# JAX package's supervisor under the same plan and config
# (tests/test_torch_selfheal.py); rewind_log entries without their detail
# (it prints the step's loss)
SELFHEAL_REPORT = {
    "rewinds": 2, "data_steps_skipped": 8, "incidents": 2, "escalations": 0,
    "save_failures": 1, "save_retries": 1,
    "incident_kinds": {"nonfinite": 1, "grad_explosion": 1}, "data_offset": 8,
    "fault_plan_fired": {"nan_grad": 1, "corrupt_ckpt": 1, "fail_save": 1, "explode_grad": 1},
    "rewind_log": [
        {"fault_step": 7, "kind": "nonfinite", "restored_step": 3, "attempt": 1, "skipped": 5,
         "data_offset": 5},
        {"fault_step": 8, "kind": "grad_explosion", "restored_step": 6, "attempt": 1,
         "skipped": 3, "data_offset": 8}]}
SELFHEAL_EVENTS = [
    ["train_step", "", 0], ["span", "flush", 0], ["flush", "", 0],
    ["train_step", "", 1], ["span", "flush", 1], ["flush", "", 1],
    ["profile", "start", 2], ["train_step", "", 2], ["span", "flush", 2],
    ["flush", "", 2], ["span", "checkpoint_save", 3], ["checkpoint", "", 3],
    ["train_step", "", 3], ["span", "flush", 3], ["flush", "", 3],
    ["profile", "stop", 4], ["train_step", "", 4], ["span", "flush", 4],
    ["flush", "", 4], ["train_step", "", 5], ["span", "flush", 5], ["flush", "", 5],
    ["span", "checkpoint_save", 6], ["checkpoint", "", 6], ["train_step", "", 6],
    ["span", "flush", 6], ["flush", "", 6], ["train_step", "", 7],
    ["anomaly", "nonfinite", 7], ["span", "rewind", 7], ["rewind", "nonfinite", 7],
    ["train_step", "", 3], ["span", "flush", 3], ["flush", "", 3],
    ["train_step", "", 4], ["span", "flush", 4], ["flush", "", 4],
    ["train_step", "", 5], ["span", "flush", 5], ["flush", "", 5],
    ["span", "checkpoint_save", 6], ["checkpoint", "", 6], ["train_step", "", 6],
    ["span", "flush", 6], ["flush", "", 6], ["train_step", "", 7],
    ["span", "flush", 7], ["flush", "", 7], ["train_step", "", 8],
    ["anomaly", "grad_explosion", 8], ["span", "rewind", 8],
    ["rewind", "grad_explosion", 8], ["train_step", "", 6], ["span", "flush", 6],
    ["flush", "", 6], ["train_step", "", 7], ["span", "flush", 7], ["flush", "", 7],
    ["train_step", "", 8], ["span", "flush", 8], ["flush", "", 8],
    ["span", "checkpoint_save", 9], ["checkpoint", "", 9], ["train_step", "", 9],
    ["span", "flush", 9], ["flush", "", 9], ["save_failure", "", 9],
    ["train_step", "", 10], ["span", "flush", 10], ["flush", "", 10],
    ["train_step", "", 11], ["span", "flush", 11], ["flush", "", 11],
    ["span", "checkpoint_save", 12], ["checkpoint", "", 12],
]
# phase 29's serve run: 8 requests through phase 25's paged engine
SELFHEAL_SERVE = dict(n=8, prompt=(64, 256), new=16)
# the profiler's trace must name these kernels of the path
SELFHEAL_TRACE_KERNELS = ("fused_switchback_kernel", "flash_fwd", "flash_bwd_dq",
                          "flash_bwd_dkv")


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def selfheal_config():
    from repro_torch.configs.base import SupervisorConfig
    return SupervisorConfig(**SELFHEAL_SUP)


def selfheal_plan():
    from repro_torch.train import FaultPlan, FaultSpec
    return FaultPlan([FaultSpec(**f) for f in SELFHEAL_PLAN])


def report_key(rep) -> dict:
    """The part of a supervisor's report() that phase 29 holds: counters,
    incident kinds, the rewind log without its detail, the data offset and
    the faults fired."""
    keys = ("rewinds", "data_steps_skipped", "incidents", "escalations", "save_failures",
            "save_retries", "incident_kinds", "data_offset", "fault_plan_fired")
    return {**{k: rep[k] for k in keys},
            "rewind_log": [{k: v for k, v in e.items() if k != "detail"}
                           for e in rep["rewind_log"]]}


def event_sequence(records) -> list:
    """[kind, name, step] of each telemetry record but the meta header (a
    span's name, a profile or request event, an anomaly's kind); times and
    values left out."""
    return [[r["kind"], r.get("name") or r.get("event") or r.get("anomaly") or "",
             r.get("step")] for r in records if r["kind"] != "meta"]


def shifted_indices(rewind_log, n) -> list:
    """The data index of each of ``n`` steps on the trajectory that survives
    the rewinds: a rewind restoring step r with data offset o replays every
    step from r on with index i + o."""
    off = [0] * n
    for ev in rewind_log:
        for i in range(ev["restored_step"], n):
            off[i] = ev["data_offset"]
    return [i + o for i, o in enumerate(off)]


def state_leaves(state, prefix=""):
    """(path, leaf) of a train state in a fixed order (NamedTuple fields,
    sorted dict keys)."""
    if isinstance(state, dict):
        for k in sorted(state):
            yield from state_leaves(state[k], f"{prefix}/{k}")
    elif hasattr(state, "_fields"):
        for k in state._fields:
            yield from state_leaves(getattr(state, k), f"{prefix}/{k}")
    else:
        yield prefix, state


def leaf_bytes(torch, leaf):
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy().tobytes()
    return leaf.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes()


def state_digest(torch, state) -> str:
    """SHA-256 over every leaf of a train state: parameters, optimizer and
    scaler state, step and the generator's state."""
    import hashlib
    h = hashlib.sha256()
    for path, leaf in state_leaves(state):
        h.update(path.encode())
        h.update(leaf_bytes(torch, leaf))
    return h.hexdigest()


def selfheal_parts(torch, cfg, dev, seed, batch=CLIP_BATCH, layers=(2, 2)):
    """Phase 29's training path: the CLIP config at ``layers`` (vision,
    text), zero-init layer-scale, int8_switchback, its step (counted), a
    fresh state from ``seed``, and ``data_fn(j)`` (cached on ``dev``)."""
    from repro_torch.data import DeterministicBatcher, SyntheticCLIP
    from repro_torch.models import params as PRM
    from repro_torch.train import init_train_state
    small = dataclasses.replace(cfg, vision_layers=layers[0], text_layers=layers[1],
                                layer_scale_init=0.0)
    bundle, policy, parallel, tc, step, opt, scaler = train_parts(
        torch, small, dev, mode="int8_switchback", **CLIP_OPT)
    batcher = DeterministicBatcher(
        lambda s: SyntheticCLIP(small.image_size, small.text_ctx, small.text_vocab,
                                n_classes=32, seed=s), seed=SELFHEAL_DATA_SEED)
    cache, calls = {}, [0]

    def data_fn(j):
        if j not in cache:
            b = batcher.batch_at(j, batch_size=batch)
            cache[j] = {"images": torch.from_numpy(b["images"]).to(dev),
                        "texts": torch.from_numpy(b["texts"]).to(device=dev, dtype=torch.long)}
        return cache[j]

    def fresh_state(s=seed):
        return init_train_state(PRM.init_params(bundle.param_specs, s, device=dev), opt,
                                scaler, seed=s)

    def counted(state, b):
        calls[0] += 1
        return step(state, b)

    return types.SimpleNamespace(cfg=small, step=counted, calls=calls, data_fn=data_fn,
                                 fresh_state=fresh_state, dev=dev)


def selfheal_trainer(P, state, ckpt_dir=None, plan=None, telemetry=None):
    """A Trainer over phase 29's step: flush every step, checkpoints every
    SELFHEAL_EVERY steps (kept SELFHEAL_KEEP) when a directory is given, no
    early checkpoint on a slow step (the watchdog reads wall time)."""
    from repro_torch.train import Trainer
    return Trainer(P.step, state, checkpoint_dir=ckpt_dir,
                   checkpoint_every=SELFHEAL_EVERY if ckpt_dir else 0,
                   keep_checkpoints=SELFHEAL_KEEP, log_every=0, fault_plan=plan,
                   early_checkpoint_on_slow=False, telemetry=telemetry)


def selfheal_supervised(P, ckpt_dir, telemetry=None):
    """(c): a TrainSupervisor over SELFHEAL_STEPS steps under
    SELFHEAL_PLAN and SELFHEAL_SUP (no early checkpoint on a slow step)."""
    from repro_torch.train import TrainSupervisor
    sup = TrainSupervisor(P.step, P.fresh_state(), P.data_fn, checkpoint_dir=ckpt_dir,
                          config=selfheal_config(), fault_plan=selfheal_plan(),
                          telemetry=telemetry)
    sup.trainer.early_checkpoint_on_slow = False
    sup.run(SELFHEAL_STEPS)
    return sup


def check_selfheal_launches(M, P, what):
    """Every launch counter (zeroed just before the run) exactly the CLIP
    step's count times the steps the run took (replays included)."""
    counts = launch_counts(M)
    want = {k: per * P.calls[0] for k, per in
            clip_launches_per_step(P.cfg, "int8_switchback", M.KOPS.FUSED_MAX_CONTRACT).items()}
    check_launches(counts, want, f"phase 29 {what}")
    return counts


@contextlib.contextmanager
def generator_kept():
    """Control fault (e): a restore that leaves the train state's
    torch.Generator as it was."""
    from repro_torch.train import Trainer
    orig = Trainer.restore_checkpoint

    def restore(self, step=None):
        rng = self.state.rng
        out = orig(self, step)
        self.state = self.state._replace(rng=rng)
        return out

    Trainer.restore_checkpoint = restore
    try:
        yield
    finally:
        Trainer.restore_checkpoint = orig


@contextlib.contextmanager
def counting_fetches():
    """Count the trainer's device-to-host metric fetches (one per flush)."""
    import repro_torch.train.trainer as TR
    real, n = TR.fetch_metrics, [0]

    def fetch(window):
        n[0] += 1
        return real(window)

    TR.fetch_metrics = fetch
    try:
        yield n
    finally:
        TR.fetch_metrics = real


def span_seconds(records, name) -> list:
    return [r["dur_s"] for r in records if r["kind"] == "span" and r["name"] == name]


def trace_kernel_names(path) -> set:
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def selfheal_training(torch, M, cfg, dev, seed, root, batch=CLIP_BATCH):
    """Phase 29 (a)-(f) under ``root``: the clean run, crash and resume, the
    torn checkpoint, the supervised run, the shifted stream, the control
    faults and the flight recorder. Returns (readings, supervisor)."""
    import shutil
    import warnings

    from repro_torch.telemetry import Telemetry, validate_file
    from repro_torch.telemetry.report import load
    from repro_torch.train import FaultPlan, FaultSpec, SimulatedCrash
    P = selfheal_parts(torch, cfg, dev, seed, batch=batch)
    n = SELFHEAL_STEPS
    out, secs = {}, {}
    t_part = [time.perf_counter()]

    def part(name, *dirs):
        """Close part ``name``: its seconds; its checkpoint directories go."""
        sync(torch, dev)
        now = time.perf_counter()
        secs[name] = now - t_part[0]
        t_part[0] = now
        for d in dirs:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)

    for j in range(n + 8):                 # every index (c) reads, built up front
        P.data_fn(j)
    part("data")
    # (a) clean run with checkpoints
    reset_launch_counts(M)
    P.calls[0] = 0
    t_a = selfheal_trainer(P, P.fresh_state(), os.path.join(root, "a"))
    sync(torch, dev)
    t = time.perf_counter()
    t_a.run(P.data_fn, n)
    sync(torch, dev)
    out["wall_ms_per_step_ckpt"] = (time.perf_counter() - t) / n * 1e3
    check_selfheal_launches(M, P, "clean run")
    losses_a = [h["loss"] for h in t_a.history]
    digest_a = state_digest(torch, t_a.state)
    check(len(losses_a) == n and all(math.isfinite(x) for x in losses_a),
          f"phase 29 (a): losses {losses_a}")
    check(t_a.ckpt.all_steps() == [3, 6, 9, 12], f"phase 29 (a): checkpoints "
          f"{t_a.ckpt.all_steps()}")
    del t_a
    part("a", "a")
    # (b) crash at step 7, then a fresh process: resume from 6
    d_b = os.path.join(root, "b")
    t_b = selfheal_trainer(P, P.fresh_state(), d_b,
                           plan=FaultPlan([FaultSpec(step=7, kind="crash", key="step")]))
    try:
        t_b.run(P.data_fn, n)
        check(False, "phase 29 (b): the planned crash did not fire")
    except SimulatedCrash:
        pass
    t_b.ckpt.wait()
    del t_b
    t_r = selfheal_trainer(P, P.fresh_state(), d_b)
    start = t_r.maybe_resume()
    check(start == 6, f"phase 29 (b): resumed at {start}, expected 6")
    t_r.run(P.data_fn, n - start)
    losses_b = [h["loss"] for h in t_r.history]
    check(losses_b == losses_a[6:], f"phase 29 (b): resumed losses {losses_b} != the clean "
          f"run's {losses_a[6:]}")
    check(state_digest(torch, t_r.state) == digest_a, "phase 29 (b): the resumed run's final "
          "state is not the clean run's")
    del t_r
    # ... then a torn newest checkpoint (a leaf truncated) and a stray .tmp
    newest = os.path.join(d_b, "step_00000012")
    leaf = sorted(f for f in os.listdir(newest) if f.endswith(".npy"))[0]
    with open(os.path.join(newest, leaf), "r+b") as f:
        f.truncate(16)
    os.makedirs(os.path.join(d_b, "step_00000015.tmp"))
    t_t = selfheal_trainer(P, P.fresh_state(), d_b)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        start = t_t.maybe_resume()
    check(start == 9 and any("skipping corrupt" in str(w.message) for w in caught),
          f"phase 29 (b): torn checkpoint: resumed at {start}, warnings "
          f"{[str(w.message) for w in caught]}")
    t_t.run(P.data_fn, n - start)
    check(state_digest(torch, t_t.state) == digest_a, "phase 29 (b): the replay past the torn "
          "checkpoint does not reach the clean run's final state")
    del t_t
    part("b", "b")
    # (c) supervised under the plan
    reset_launch_counts(M)
    P.calls[0] = 0
    sync(torch, dev)
    t = time.perf_counter()
    with counting_fetches() as fetches_off:
        sup = selfheal_supervised(P, os.path.join(root, "c"))
    sync(torch, dev)
    out["supervised_s"] = time.perf_counter() - t
    check_selfheal_launches(M, P, "supervised run")
    out["supervised_steps_taken"] = P.calls[0]
    rep = report_key(sup.report())
    out["report"] = rep
    check(rep == SELFHEAL_REPORT, f"phase 29 (c): report {json.dumps(rep)} != the pinned "
          f"{json.dumps(SELFHEAL_REPORT)}")
    hist_c = sup.trainer.history
    check(len(hist_c) == n and all(math.isfinite(h["loss"]) for h in hist_c),
          f"phase 29 (c): history {[h['loss'] for h in hist_c]}")
    digest_c = state_digest(torch, sup.trainer.state)
    part("c", "c")
    # (d) the shifted stream: a plain Trainer, no checkpoints
    idx = shifted_indices(sup.report()["rewind_log"], n)
    out["shifted_indices"] = idx

    def shifted_digest(indices):
        tr = selfheal_trainer(P, P.fresh_state())
        sync(torch, dev)
        t0 = time.perf_counter()
        tr.run(lambda i: (indices[i], P.data_fn(indices[i])), n)
        sync(torch, dev)
        return state_digest(torch, tr.state), [h["loss"] for h in tr.history], \
            (time.perf_counter() - t0) / n * 1e3

    digest_d, losses_d, out["wall_ms_per_step_plain"] = shifted_digest(idx)
    check(digest_d == digest_c, "phase 29 (d): the shifted stream's final state is not the "
          "supervised run's")
    check(losses_d == [h["loss"] for h in hist_c], "phase 29 (d): the shifted stream's losses "
          "are not the supervised run's")
    part("d")
    # (e) control faults, each must break (d)'s equality
    short = [j - 1 if j != i else j for i, j in enumerate(idx)]
    faults = {"skip one data index short": shifted_digest(short)[0] != digest_c}
    with generator_kept():
        g_sup = selfheal_supervised(P, os.path.join(root, "e"))
    faults["restore leaves the generator as it was"] = \
        state_digest(torch, g_sup.trainer.state) != digest_d
    del g_sup
    out["control_faults_caught"] = faults
    check(all(faults.values()), f"phase 29 (e): a control fault kept (d)'s equality: {faults}")
    part("e", "e")
    # (f) the flight recorder: (c) again with telemetry and a profile window
    path = os.path.join(root, "run.jsonl")
    tele = Telemetry(path, profile_steps=SELFHEAL_PROFILE, profile_dir=os.path.join(root, "prof"),
                     program="train", meta={"phase": 29})
    try:
        with counting_fetches() as fetches_on:
            f_sup = selfheal_supervised(P, os.path.join(root, "f"), telemetry=tele)
    finally:
        tele.close()
    errs = validate_file(path)
    check(errs == [], f"phase 29 (f): telemetry file invalid: {errs[:5]}")
    recs = load(path)
    seq = event_sequence(recs)
    check(seq == SELFHEAL_EVENTS, f"phase 29 (f): event sequence {json.dumps(seq)} != the "
          f"pinned {json.dumps(SELFHEAL_EVENTS)}")
    check([h["loss"] for h in f_sup.trainer.history] == [h["loss"] for h in hist_c]
          and state_digest(torch, f_sup.trainer.state) == digest_c,
          "phase 29 (f): telemetry on changed the losses or the final state")
    check(fetches_on[0] == fetches_off[0], f"phase 29 (f): {fetches_on[0]} metric fetches with "
          f"telemetry on, {fetches_off[0]} off")
    out["metric_fetches"] = fetches_off[0]
    stop = [r for r in recs if r["kind"] == "profile" and r.get("event") == "stop"]
    check(len(stop) == 1, "phase 29 (f): profile events "
          f"{[r for r in recs if r['kind'] == 'profile']}")
    if dev.type == "cuda":
        names = trace_kernel_names(stop[0]["file"])
        missing = [k for k in SELFHEAL_TRACE_KERNELS if not any(k in nm for nm in names)]
        check(not missing, f"phase 29 (f): the profiler's trace names none of {missing}")
        out["trace_kernels"] = len(names)
    out["span_median_s"] = {k: statistics.median(span_seconds(recs, k)) for k in
                            ("checkpoint_save", "rewind", "flush")}
    out["telemetry_records"] = len(recs)
    out["losses"] = losses_a
    out["digest"] = digest_a
    del f_sup
    part("f", "f", "prof")
    out["seconds"] = secs
    return out, sup


def selfheal_serve(torch, M, cfg, eng, params, sup, root, seed):
    """Phase 29 (g): the paged engine (phase 25's) serves SELFHEAL_SERVE's
    requests with telemetry on and the supervisor as stability source:
    the tokens of a telemetry-off run, every request's submitted and
    finished events, spans of each wave kind, launches exact, the stats
    row's supervisor_* equal to the supervisor's report."""
    import numpy as np

    from repro_torch.serve.engine import SUPERVISOR_KEYS
    from repro_torch.telemetry import Telemetry, validate_file
    from repro_torch.telemetry.report import load
    s = SELFHEAL_SERVE
    rng = np.random.default_rng(seed + 29)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(k)).tolist()
               for k in rng.integers(s["prompt"][0], s["prompt"][1] + 1, size=s["n"])]
    off, _ = eng.generate(params, prompts, max_new_tokens=s["new"])
    path = os.path.join(root, "serve.jsonl")
    eng.telemetry = Telemetry(path, program="serve", meta={"phase": 29})
    eng.stability_source = sup
    reset_launch_counts(M)
    try:
        on, stats = eng.generate(params, prompts, max_new_tokens=s["new"])
    finally:
        eng.telemetry.close()
        eng.telemetry = eng.stability_source = None
    check_launches(launch_counts(M), expected_paged_launches(cfg, stats), "phase 29 (g)")
    check(on == off, "phase 29 (g): telemetry on changed the served tokens")
    check(validate_file(path) == [], f"phase 29 (g): {validate_file(path)[:5]}")
    recs = load(path)
    for uid in range(s["n"]):
        evs = {r["event"] for r in recs if r["kind"] == "request" and r["uid"] == uid}
        check({"submitted", "finished"} <= evs, f"phase 29 (g): request {uid}: events {evs}")
    spans = {r["name"] for r in recs if r["kind"] == "span"}
    check({"prefill_wave", "decode_wave"} <= spans, f"phase 29 (g): spans {spans}")
    rep = sup.report()
    got = {k: stats[f"supervisor_{k}"] for k in SUPERVISOR_KEYS}
    check(got == {k: rep[k] for k in SUPERVISOR_KEYS},
          f"phase 29 (g): stats row {got} != the supervisor's report")
    return {"tokens_per_s": stats["tokens_per_s"], "records": len(recs),
            "supervisor": got}


# (h)'s depth, vision + text: a quarter of CLIP ViT-H/14's (full depth, an
# 11.8 GB checkpoint, until the script took phase 34; the round trip is a
# bit equality at any depth)
ROUND_TRIP_LAYERS = (8, 6)


def selfheal_full_depth(torch, cfg, dev, seed, root, batch=CLIP_BATCH):
    """Phase 29 (h): the CLIP state at ``cfg``'s depth, one step, then save_async,
    wait, verify and restore into a fresh state (keep_last=1): every leaf
    and the generator's state bit-equal; bytes, free disk and seconds."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import Trainer
    P = selfheal_parts(torch, cfg, dev, seed, batch=batch, layers=(cfg.vision_layers,
                                                                   cfg.text_layers))
    tr = selfheal_trainer(P, P.fresh_state())
    tr.run(P.data_fn, 1)
    state = tr.state
    del tr
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    need = sum(len(leaf_bytes(torch, x)) if isinstance(x, torch.Generator)
               else x.numel() * x.element_size() for _, x in state_leaves(state))
    d = os.path.join(root, "h")
    os.makedirs(d)
    free = shutil.disk_usage(d).free
    check(free > need * 1.05, f"phase 29 (h): {free} bytes free under {d}, the checkpoint "
          f"needs {need}")
    mgr = CheckpointManager(d, keep_last=1)
    sync(torch, dev)
    t0 = time.perf_counter()
    mgr.save_async(1, state)
    t1 = time.perf_counter()
    mgr.wait()
    t2 = time.perf_counter()
    mgr.verify(1)
    t3 = time.perf_counter()
    fresh = Trainer(P.step, P.fresh_state(seed + 1), checkpoint_dir=d, keep_checkpoints=1)
    sync(torch, dev)
    t4 = time.perf_counter()
    step = fresh.restore_checkpoint(1)
    sync(torch, dev)
    t5 = time.perf_counter()
    check(step == 1, f"phase 29 (h): restored step {step}")
    a, b = dict(state_leaves(state)), dict(state_leaves(fresh.state))
    check(a.keys() == b.keys(), "phase 29 (h): the restored state's leaves differ")
    bad = [p for p in a if (isinstance(a[p], torch.Generator)
                            and not torch.equal(a[p].get_state(), b[p].get_state()))
           or (isinstance(a[p], torch.Tensor)
               and (a[p].dtype != b[p].dtype or a[p].device != b[p].device
                    or not torch.equal(a[p].reshape(-1).view(torch.uint8),
                                       b[p].reshape(-1).view(torch.uint8))))]
    check(not bad, f"phase 29 (h): leaves not bit-equal after the round trip: {bad[:5]}")
    stored = sum(os.path.getsize(os.path.join(d, "step_00000001", f))
                 for f in os.listdir(os.path.join(d, "step_00000001")))
    return {"bytes": need, "bytes_on_disk": stored, "free_bytes_before": free,
            "leaves": len(a), "snapshot_s": t1 - t0, "write_s": t2 - t1, "verify_s": t3 - t2,
            "restore_s": t5 - t4}


def selfheal(torch, M, clip_cfg, cfg, dev, seed, eng, params):
    """Phase 29: self-healing CLIP training and the flight recorder (a)-(h)
    in a fresh temporary directory, removed at the end."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_selfheal_")
    try:
        t = time.perf_counter()
        res, sup = selfheal_training(torch, M, clip_cfg, dev, seed, root)
        res["training_s"] = time.perf_counter() - t
        t = time.perf_counter()
        res["serve"] = selfheal_serve(torch, M, cfg, eng, params, sup, root, seed)
        res["serve_s"] = time.perf_counter() - t
        del sup
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        res["full_depth"] = selfheal_full_depth(
            torch, dataclasses.replace(clip_cfg, vision_layers=ROUND_TRIP_LAYERS[0],
                                       text_layers=ROUND_TRIP_LAYERS[1]), dev, seed, root)
        res["full_depth_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 30: the paper's remaining training options on CLIP at full width:
# fp16 with loss scaling on the f16 forms of the three flash kernels, fp32,
# activation recomputation, AdaFactor and the App. C variance analysis
# ---------------------------------------------------------------------------

# the three flash kernels' f16 forms (the FP16 policy's attention)
F16_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FP16_STEPS = 3
FP16_SCALERS = ("fixed_tensor", "dynamic")
# (b) each leaf's change over the FP16 steps, the kernels against the plain
# attention on the card: mean |diff| over the largest change the plain run
# made in that leaf; the CPU tests' limit against the JAX package
# (tests/test_torch_precision16.py, tests/test_torch_clip.py), fixed before
# the first card run. A leaf the plain run left as it was (skipped on every
# step) must be left as it was. The key bias is left out, as in those
# tests: its exact gradient is 0 (softmax ignores a per-query constant), so
# both runs hold rounding noise there, which Adam turns into +-lr steps.
FP16_DELTA_TOL = 5e-2
FP32_STEPS = 2
# (c) one fp32 step's loss and gradient, kernels against plain versions, by
# compute dtype, and the control fault (the text tower's causal mask
# dropped) outside on at least one key. Limits by phase 10's rule: the
# geometric mean of the worst sound reading and the fault's reading, one
# digit, from one seed a dtype on an H100 (readings in PERF.md, run P3): sound
# loss 0 (bf16) and 1.4e-7 (f32) against the fault's 8.9e-4 and 9.5e-4;
# gradient max 4.2e-3 and 8.6e-6 against 1.49 and 1.47; mean 2.3e-6 and
# 1.8e-6 against 0.31 and 0.31. Under bf16 compute the gradients of the
# leaves that stay bf16 (the embeddings and the first norm of each tower)
# are rounded to bf16, so a last-bit difference in the f32 attention flips
# their rounding now and then: one bf16 ulp of an element, up to 2^-8 of
# the leaf's max
FP32_STEP_TOL = {"bfloat16": dict(loss_rel_err=1e-5, grad_max_rel_err=8e-2,
                                  grad_mean_rel_err=8e-4),
                 "float32": dict(loss_rel_err=1e-5, grad_max_rel_err=4e-3,
                                 grad_mean_rel_err=8e-4)}
STEP_SKIP = ("['bk']", "['logit_scale']")
REMAT_STEPS = 3
REMAT_BIG_BATCH = 128
# (d)'s depth, vision + text: an eighth of CLIP ViT-H/14's, to keep the
# script inside its time (8 + 6 until the script took phase 34; the checks
# are bit equalities at any depth)
REMAT_LAYERS = (4, 3)
ADAFACTOR_STEPS = 3
# (f) App. C: k at the two CLIP widths and the paper's weight-gradient k
# (App. C.3: batch x sequence, about 65,536), b = m = 256; the reference's
# criteria (measured / predicted within [0.3, 3], the variance growing)
APPC_K = (1280, 5120, 65536)
APPC_BM = 256


def f16_clip_cases(cfg):
    """CLIP's vision (32, 129, 16, 80) and text (32, 77, 16, 64) attention,
    each causal and full (control faults: the lanes past 64 dropped, the
    mask dropped), in ``compare_flash_train``'s form."""
    from repro_torch.models.clip import n_kept_patches
    Sv, Hv, Ht = n_kept_patches(cfg) + 1, cfg.vision_heads, cfg.text_heads
    hv, ht = cfg.vision_width // Hv, cfg.text_width // Ht
    St = cfg.text_ctx
    return ([("vision", CLIP_BATCH, Sv, Sv, Sv, Hv, Hv, hv, c, lanes_fault) for c in (False, True)]
            + [("text", CLIP_BATCH, St, St, St, Ht, Ht, ht, c, mask_fault) for c in (True, False)])


def f16_faults(torch, M, cfg, dev, seed):
    """(a)'s two control faults of the f16 forms, each of which must fail the
    kernel-vs-plain check at every CLIP case: o rounded through bf16 in place
    of f16 (the output conversion of the bf16 form), and a one-term split
    (the kernels fed k, v, q and do rounded through bf16: what staging an f16
    value as one bf16 term computes). Returns the smallest reading over the
    tolerance of each."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h16 = torch.float16
    o_tol, b_tol = FLASH_O_TOL["float16"], FLASH_BWD_TOL["float16"]
    worst = {"o through bf16": math.inf, "one-term split": math.inf}
    for tower, B, S, _, kv_valid, H, KV, hd, causal, _ in f16_clip_cases(cfg):
        q, do = (torch.randn((B, S, H, hd), generator=gen, device=dev).to(h16) for _ in range(2))
        k, v = (torch.randn((B, S, KV, hd), generator=gen, device=dev).to(h16) for _ in range(2))
        scale = M.FA.softmax_scale(hd)
        ro, rlse = M.FREF.mha_fwd(q, k, v, causal=causal, kv_valid=S, scale=scale)
        o, lse = M.FA.flash_fwd_lse(q, k, v, causal=causal)
        r = rel_err(torch, o.to(torch.bfloat16).to(h16), ro) / o_tol
        worst["o through bf16"] = min(worst["o through bf16"], r)
        check(r > 1.0, f"f16 {tower}: o rounded through bf16 reads only {r:g} x the tolerance")
        one = [t.to(torch.bfloat16).to(h16) for t in (q, k, v, do)]
        fo, flse = M.FA.flash_fwd_lse(*one[:3], causal=causal)
        di = M.FREF.attention_di(o, do)
        rdq = M.FREF.flash_bwd_dq(q, k, v, do, lse, di, causal=causal, kv_valid=S, scale=scale)
        fdq = M.FA.flash_bwd_dq(*one, lse, di, causal=causal)
        fdk, fdv = M.FA.flash_bwd_dkv(*one, lse, di, causal=causal)
        rdk, rdv = M.FREF.flash_bwd_dkv(q, k, v, do, lse, di, causal=causal, kv_valid=S,
                                        scale=scale)
        r = min(max(rel_err(torch, fo, ro) / o_tol, float((flse - rlse).abs().max())
                    / FLASH_LSE_TOL),
                *(rel_err(torch, a, b) / b_tol for a, b in ((fdq, rdq), (fdk, rdk), (fdv, rdv))))
        worst["one-term split"] = min(worst["one-term split"], r)
        check(r > 1.0, f"f16 {tower}: a one-term split reads only {r:g} x the tolerance in "
              "one of the kernels")
    torch.cuda.synchronize()
    return worst


def clip_steps(torch, M, P, batches, seed, dev, keep_initial=False):
    """Run ``len(batches)`` steps of the parts ``P`` from the seed's fresh
    parameters (each loss call's patches from the state's generator): the
    metrics per step ((loss, grad norm, loss scale, skipped tensors)), the
    final state and, with ``keep_initial``, a copy of the initial
    parameters (else None, so that a peak read over the steps is theirs)."""
    from repro_torch.models import params as PRM
    from repro_torch.train import init_train_state
    bundle, policy, parallel, tc, step, opt, sc = P
    params = PRM.init_params(bundle.param_specs, seed, device=dev)
    p0 = PRM.tree_map(lambda t: t.clone(), params) if keep_initial else None
    state = init_train_state(params, opt, sc, seed=seed)
    del params
    hist = []
    for b in batches:
        state, m = step(state, b)
        hist.append([float(m[k]) for k in ("loss", "grad_norm", "loss_scale",
                                           "n_skipped_tensors")])
    torch.cuda.synchronize()
    return hist, state, p0


def leaf_changes(torch, got, want, p0):
    """Per leaf, mean |(got - p0) - (want - p0)| over max|want - p0|; a leaf
    ``want`` left as it was reads 0 if ``got`` left it too, else inf."""
    from repro_torch.models.params import tree_paths
    out = {}
    for (path, g), w, z in zip(tree_paths(got), (l for _, l in tree_paths(want)),
                               (l for _, l in tree_paths(p0))):
        dg, dw = g.double() - z.double(), w.double() - z.double()
        top = float(dw.abs().max())
        out[path] = (float((dg - dw).abs().mean()) / top if top
                     else (0.0 if float(dg.abs().max()) == 0.0 else math.inf))
    return out


def fp16_runs(torch, M, cfg, dev, seed):
    """(b): the FP16 policy (f16 compute, the f16 flash forms) at full
    width and depth, batch 32, FP16_STEPS steps under each scaler, with the
    kernels (every counter zeroed just before, read just after: the flash
    kernels exactly once a layer a step, no SwitchBack kernel) and again
    with the plain attention on the card; the loss-scale sequence and the
    skipped-tensor counts equal, losses finite wherever nothing was skipped,
    at least one step that updates, each leaf's change within
    FP16_DELTA_TOL. Returns the readings and the kernel run's counts."""
    batches = clip_batches(torch, cfg, FP16_STEPS, CLIP_BATCH, dev, seed + 3000)
    layers = cfg.vision_layers + cfg.text_layers
    out, counts = {}, dict.fromkeys(F16_KERNELS, 0)
    for scaler in FP16_SCALERS:
        P = train_parts(torch, cfg, dev, mode="fp16", compute_dtype=torch.float16,
                        scaler=scaler, **CLIP_OPT)
        reset_launch_counts(M)
        t = time.perf_counter()
        hist, state, p0 = clip_steps(torch, M, P, batches, seed, dev, keep_initial=True)
        wall = time.perf_counter() - t
        c = launch_counts(M)
        for k in F16_KERNELS:
            check(c[k] == layers * FP16_STEPS, f"FP16 {scaler}: {k}: {c[k]} launches in "
                  f"{FP16_STEPS} steps, expected {layers * FP16_STEPS}")
            counts[k] += c[k]
        check(all(c[k] == 0 for k in SB_KERNELS + ("decode_fwd",) + FP8_KERNELS),
              f"FP16 {scaler}: a SwitchBack, fp8 or decode kernel ran: {c}")
        with plain_ops(M, flash=True):
            plain_hist, plain_state, _ = clip_steps(torch, M, P, batches, seed, dev)
        n_leaves = sum(1 for _ in _leaves(p0))
        changes = leaf_changes(torch, state.params, plain_state.params, p0)
        bk = {k: v for k, v in changes.items() if "['bk']" in k}
        changes = {k: v for k, v in changes.items() if k not in bk}
        worst = max(changes, key=changes.get)
        r = dict(losses=[h[0] for h in hist], grad_norms=[h[1] for h in hist],
                 loss_scales=[h[2] for h in hist], skipped=[h[3] for h in hist],
                 plain_losses=[h[0] for h in plain_hist], n_tensors=n_leaves,
                 worst_leaf_change=changes[worst], worst_leaf=worst, bk_changes=bk,
                 step_ms=wall / FP16_STEPS * 1e3)
        out[scaler] = r
        print(f"[fp16] {scaler}: " + json.dumps(r))
        check([h[2:] for h in hist] == [h[2:] for h in plain_hist],
              f"FP16 {scaler}: the loss scales or skips differ from the plain attention's: "
              f"{hist} against {plain_hist}")
        check(all(math.isfinite(h[0]) for h in hist if h[3] == 0),
              f"FP16 {scaler}: a non-finite loss where nothing was skipped: {hist}")
        check(changes[worst] <= FP16_DELTA_TOL,
              f"FP16 {scaler}: leaf {worst}'s change {changes[worst]:g} > {FP16_DELTA_TOL:g}")
        del state, plain_state, p0, P
        gc.collect()
        torch.cuda.empty_cache()
    check(any(h < out["fixed_tensor"]["n_tensors"] for h in out["fixed_tensor"]["skipped"]),
          "FP16 fixed_tensor: no step updated any tensor")
    return out, counts


def fp32_runs(torch, M, cfg, dev, seed):
    """(c): ``fp32`` with the CLI's bf16 compute dtype and with f32 compute,
    full width and depth, batch 32, ``remat="block"`` (f32 activations
    would pass ~65 GiB without it), FP32_STEPS steps each: losses finite,
    nothing skipped; then one step's loss and gradient with the kernels
    against the plain versions within FP32_STEP_TOL, the control fault (the
    text tower's causal mask dropped, on the plain versions) outside. Every
    reading is printed before any is checked."""
    from repro_torch.train import loss_and_grads
    batches = clip_batches(torch, cfg, FP32_STEPS, CLIP_BATCH, dev, seed + 3100)
    res, finite = {}, {}
    for cd in (torch.bfloat16, torch.float32):
        name = str(cd).replace("torch.", "")
        P = train_parts(torch, cfg, dev, mode="fp32", compute_dtype=cd, remat="block",
                        **CLIP_OPT)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        hist, state, _ = clip_steps(torch, M, P, batches, seed, dev)
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all(math.isfinite(h[0]) and h[3] == 0 for h in hist),
              f"fp32 compute {name}: non-finite loss or a skipped tensor: {hist}")
        bundle, policy, parallel = P[:3]
        keep = bundle.patch_keep(torch.Generator(device=dev).manual_seed(seed))
        run = lambda: loss_and_grads(bundle, policy, parallel, state.params, batches[0],
                                     patch_keep=keep)
        kern = run()
        with plain_ops(M, flash=True):
            plain = run()
            with causal_mask_dropped(M):
                fault = run()
        res[name], finite[name] = step_reading(torch, kern, plain, {"text mask dropped": fault},
                                               skip=STEP_SKIP)
        res[name].update(losses=[h[0] for h in hist], step_ms=wall / FP32_STEPS * 1e3,
                         peak_memory_gib=peak, tolerance=FP32_STEP_TOL[name])
        print(f"[fp32] compute {name}: " + json.dumps(res[name]))
        del kern, plain, fault, state, P
        gc.collect()
        torch.cuda.empty_cache()
    check_readings("fp32 whole step", res, finite)
    return res


def remat_run(torch, M, cfg, dev, seed, remat, batch, steps, profile=True):
    """``int8_switchback`` (zero-init layer-scale) at full width and depth
    under ``remat`` through the Trainer: a warm-up step, then ``steps``
    steps (launches per step and peak memory over them); with ``profile``
    one more step's device time from torch.profiler. Returns the losses,
    the final state, and the readings."""
    from repro_torch.models import params as PRM
    from repro_torch.train import Trainer, init_train_state, loss_and_grads
    c = dataclasses.replace(cfg, layer_scale_init=0.0)
    P = train_parts(torch, c, dev, remat=remat, **CLIP_OPT)
    bundle, _, _, _, step, opt, sc = P
    batches = clip_batches(torch, c, 1 + steps, batch, dev, seed + 3200)
    # the trainer holds the only reference to the state, so the peak is the
    # steps' own
    trainer = Trainer(step, init_train_state(PRM.init_params(bundle.param_specs, seed, device=dev),
                                             opt, sc, seed=seed), log_every=1000)
    trainer.run(lambda i: batches[i], 1)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(M)
    t = time.perf_counter()
    trainer.run(lambda i: batches[i], steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / steps * 1e3
    counts = launch_counts(M)
    r = dict(remat=remat, batch=batch, peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
             wall_ms_per_step=wall, pairs_per_s=batch / wall * 1e3,
             launches_per_step=sum(counts.values()) / steps)
    # the activations' share: one forward and backward's peak above the
    # state the trainer holds (the optimizer's copies left out)
    gc.collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = loss_and_grads(bundle, *P[1:3], trainer.state.params, batches[1],
                           patch_keep=bundle.patch_keep(trainer.state.rng))
    torch.cuda.synchronize()
    r["fwd_bwd_peak_gib_above_state"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    del grads
    if profile:
        by_kernel = kernel_times(torch, lambda: trainer.run(lambda i: batches[1 + i % steps], 1),
                                 1)
        r.update(device_ms_per_step=sum(v[0] for v in by_kernel.values()),
                 cuda_launches_per_step=sum(v[1] for v in by_kernel.values()))
    losses = [h["loss"] for h in trainer.history]
    check(all(math.isfinite(x) for x in losses), f"remat {remat} batch {batch}: losses {losses}")
    return losses[:1 + steps], trainer.state, r


def remat_checks(torch, M, cfg, dev, seed):
    """(d): int8_switchback under ``"block"`` against ``"none"`` at batch 32:
    the 1 + REMAT_STEPS steps' losses and every parameter bit-equal; peak
    GiB, device ms, wall ms and launches a step of each; then batch 128
    under ``"block"`` (predicted not to fit without it)."""
    from repro_torch.models import params as PRM
    from repro_torch.models.params import tree_paths
    runs = {}
    for remat in ("none", "block"):
        losses, state, r = remat_run(torch, M, cfg, dev, seed, remat, CLIP_BATCH, REMAT_STEPS)
        # the parameters kept on the host, so the next run's peak is its own
        runs[remat] = (losses, PRM.tree_map(lambda t: t.to("cpu"), state.params), r)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    (l0, p0, r0), (l1, p1, r1) = runs["none"], runs["block"]
    differ = [path for (path, a), (_, b) in zip(tree_paths(p0), tree_paths(p1))
              if not torch.equal(a, b)]
    out = {"none": r0, "block": r1, "losses_equal": l0 == l1, "leaves_differing": differ}
    _, _, big = remat_run(torch, M, cfg, dev, seed, "block", REMAT_BIG_BATCH, 2)
    out["block_batch_128"] = big
    del runs, p0, p1
    print("[remat] " + json.dumps(out))
    check(l0 == l1, f"remat block vs none: losses differ: {l0} against {l1}")
    check(not differ, f"remat block vs none: {len(differ)} parameter leaves differ: {differ[:8]}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def adafactor_run(torch, M, cfg, dev, seed):
    """(e): int8_switchback (zero-init layer-scale) with AdaFactor, full width
    and depth, batch 32, ADAFACTOR_STEPS steps: finite losses; the optimizer
    state's bytes beside StableAdamW's for the same parameters; its state
    saved and restored by ``CheckpointManager`` bit for bit."""
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import stable_adamw
    c = dataclasses.replace(cfg, layer_scale_init=0.0)
    P = train_parts(torch, c, dev, optimizer="adafactor", **CLIP_OPT)
    batches = clip_batches(torch, c, ADAFACTOR_STEPS, CLIP_BATCH, dev, seed + 3300)
    t = time.perf_counter()
    hist, state, _ = clip_steps(torch, M, P, batches, seed, dev)
    wall = (time.perf_counter() - t) / ADAFACTOR_STEPS * 1e3
    check(all(math.isfinite(h[0]) for h in hist), f"AdaFactor: losses {hist}")
    state_bytes = sum(t.numel() * t.element_size() for t in _leaves(state.opt_state.moments))
    adam = stable_adamw().init(state.params)
    adam_bytes = sum(t.numel() * t.element_size() for tree in (adam.exp_avg, adam.exp_avg_sq)
                     for t in _leaves(tree))
    del adam
    with tempfile.TemporaryDirectory(prefix="chip_smoke_adafactor_") as d:
        mgr = CheckpointManager(d)
        mgr.save(ADAFACTOR_STEPS, {"opt_state": state.opt_state})
        back, step, _ = mgr.restore(ADAFACTOR_STEPS, like={"opt_state": state.opt_state},
                                    device=dev)
    same = (type(back["opt_state"]).__name__ == "AdafactorState"
            and torch.equal(back["opt_state"].step, state.opt_state.step)
            and all(torch.equal(a, b) for a, b in zip(_leaves(state.opt_state.moments),
                                                      _leaves(back["opt_state"].moments))))
    r = dict(losses=[h[0] for h in hist], step_ms=wall, state_bytes=state_bytes,
             stable_adamw_state_bytes=adam_bytes, checkpoint_round_trip_bit_equal=same)
    print("[adafactor] " + json.dumps(r))
    check(same, "AdaFactor: the optimizer state did not come back bit for bit")
    del state, back, P
    gc.collect()
    torch.cuda.empty_cache()
    return r


def appendix_c(torch, M, dev, seed):
    """(f): App. C's measured and predicted variance of the Eq. 3 product at
    k = APPC_K, b = m = APPC_BM, on the card (``core/analysis``: the
    row_quantize, tensor_quantize and int8_matmul_dequant_t kernels, counted
    and each launched); each ratio within [0.3, 3], the variance growing with
    k; one draw's kernels bit-equal to the plain functions on the same card
    tensors."""
    from repro_torch.core import analysis as AN
    from repro_torch.core import quantization as Q
    out = {}
    reset_launch_counts(M)
    for k in APPC_K:
        gen = torch.Generator(device=dev).manual_seed(seed + k)
        measured, predicted = AN.empirical_matmul_quant_error(gen, APPC_BM, k, APPC_BM)
        out[k] = dict(measured=measured, predicted=predicted, ratio=measured / predicted)
    counts = launch_counts(M)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((APPC_BM, APPC_K[0]), generator=gen, device=dev)
    w = torch.randn((APPC_BM, APPC_K[0]), generator=gen, device=dev)
    x_q, s_x, w_q, s_w, approx = AN.eq3_product(x, w)
    qx, sx = Q.quantize_rowwise(x)
    qw, sw = Q.quantize_tensorwise(w)
    bits = (torch.equal(x_q, qx) and torch.equal(s_x, sx) and torch.equal(w_q, qw)
            and torch.equal(s_w.reshape(()), sw)
            and torch.equal(approx, Q.int8_matmul_dequant_rowwise_tensorwise(qx, qw, sx, sw)))
    res = dict(by_k=out, launches={k: counts[k] for k in ("row_quantize", "tensor_quantize",
                                                           "int8_matmul_dequant_t")},
               kernels_bit_equal_to_plain=bits)
    print("[appendix C] " + json.dumps(res))
    for k, r in out.items():
        check(0.3 <= r["ratio"] <= 3.0, f"App. C k={k}: measured / predicted {r['ratio']:g}")
    check(all(out[a]["measured"] < out[b]["measured"] for a, b in zip(APPC_K, APPC_K[1:])),
          f"App. C: the variance does not grow with k: {out}")
    check(all(v > 0 for v in res["launches"].values()), f"App. C: a kernel never ran: {res}")
    check(bits, "App. C: the kernels' Eq. 3 product differs from the plain functions")
    return res


def training_options(torch, M, cfg, smollm_cfg, dev, seed):
    """Phase 30, parts (a) to (f); each part prints its seconds."""
    secs, res = {}, {}

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        print(f"[time] 30{name}: {secs[name]:.1f} s", flush=True)
        return out

    def kernels_a():
        # CLIP's shapes, then phase 3's smollm edges (8 sequences of 64, 200
        # and 256 tokens, kv_valid 200, GQA 15/5)
        cases = f16_clip_cases(cfg) + smollm_flash_cases(smollm_cfg)
        worst, n = compare_flash_train(torch, M, cases, dev, seed + 3400,
                                       dtypes=(torch.float16,))
        faults = f16_faults(torch, M, cfg, dev, seed + 3500)
        times = time_clip_flash(torch, M, cfg, dev, seed + 3600, dt=torch.float16)
        print(f"[kernels] {n} f16 flash comparisons within o {FLASH_O_TOL['float16']:g} of "
              f"max|o|, backward {FLASH_BWD_TOL['float16']:g}, lse {FLASH_LSE_TOL:g}, "
              f"bit-identical over two launches; the control faults (smallest reading over "
              "the tolerance): " + json.dumps({"case faults": {
                  k: v["fault_over_tol"] for k, v in worst.items()}, **faults})
              + "; readings " + json.dumps(worst))
        print("[timing] f16 flash: " + json.dumps(times))
        return dict(worst=worst, n=n, faults=faults, times=times)

    res["a"] = part("a f16 kernels", kernels_a)
    res["b"], res["f16_counts"] = part("b fp16", lambda: fp16_runs(torch, M, cfg, dev, seed))
    res["c"] = part("c fp32", lambda: fp32_runs(torch, M, cfg, dev, seed))
    res["d"] = part("d remat", lambda: remat_checks(
        torch, M, dataclasses.replace(cfg, vision_layers=REMAT_LAYERS[0],
                                      text_layers=REMAT_LAYERS[1]), dev, seed))
    res["e"] = part("e adafactor", lambda: adafactor_run(torch, M, cfg, dev, seed))
    res["f"] = part("f appendix C", lambda: appendix_c(torch, M, dev, seed))
    res["seconds"] = secs
    return res


# ---------------------------------------------------------------------------
# phase 31: data-parallel and ZeRO-3 training through the TrainEngine, on a
# world-1 NCCL group: CLIP ViT-H/14 at full width in int8_switchback
# ---------------------------------------------------------------------------

# vision, text layers: the depth cut so the phase's six runs fit ~60 s (4 +
# 4 until the script took phase 34; the checks are bit equalities at any
# depth)
ENGINE_LAYERS = (2, 2)
ENGINE_STEPS = 3
# the world whose per-rank state the phase predicts under fsdp
ENGINE_PREDICT_WORLD = 4


def halves_int8_wire(torch, PRM, w):
    """(c)'s control fault: the int8 wire with an absmax per half of the
    weight's first dim, as two shards would make it without the reduction."""
    return torch.cat([PRM.int8_wire(h) for h in w.chunk(2, dim=0)], dim=0)


@contextlib.contextmanager
def use_weight_through(PRM, wire):
    """The direct step with every weight passed through ``wire`` after
    ``use_weight``'s cast (the plain reference of the int8 wire)."""
    real = PRM.use_weight
    PRM.use_weight = lambda w, logical=(), dtype=None: wire(real(w, logical, dtype))
    try:
        yield
    finally:
        PRM.use_weight = real


def engine_run(torch, M, step_fn, state, batches, context=contextlib.nullcontext,
               profile=True):
    """ENGINE_STEPS steps of ``step_fn`` from ``state`` with every launch
    counter zeroed just before and read just after: the losses, the
    counts, the final state's digest and the peak memory; with ``profile``
    one more step's device time by kernel (torch.profiler), NCCL's own
    kernels counted apart."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(M)
    losses = []
    with context():
        for b in batches[:ENGINE_STEPS]:
            state, m = step_fn(state, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        r = dict(losses=losses, counts=launch_counts(M), digest=state_digest(torch, state),
                 peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        if profile:
            by_kernel = kernel_times(torch, lambda: step_fn(state, batches[ENGINE_STEPS]), 1)
            nccl = {k: v for k, v in by_kernel.items() if "nccl" in k.lower()}
            dev_ms = sum(v[0] for v in by_kernel.values())
            r.update(device_ms_per_step=dev_ms,
                     cuda_launches_per_step=sum(v[1] for v in by_kernel.values()),
                     nccl_ms_per_step=sum(v[0] for v in nccl.values()),
                     nccl_launches_per_step=sum(v[1] for v in nccl.values()),
                     nccl_share=(sum(v[0] for v in nccl.values()) / dev_ms if dev_ms else None))
    check(all(math.isfinite(x) for x in losses), f"engine run: losses {losses}")
    return r


def sharded_engine(torch, M, cfg, dev, seed):
    """Phase 31: CLIP ViT-H/14 at full width and ENGINE_LAYERS depth,
    int8_switchback (zero-init layer-scale), batch 32, through
    ``make_engine`` on a world-1 NCCL group. (a) fsdp off: ENGINE_STEPS
    steps' losses, final state and launch counts equal the direct
    ``make_train_step``'s (phase 15's route) exactly; (b) fsdp with the
    explicit gather and pure_dp (the dry-run's CLIP recipe, bf16 wire):
    (a)'s exactly; (c) the same over the int8 wire: the direct step whose
    weights pass through the plain wire, exactly, and not the control
    fault (an absmax per half of each weight); (d) device ms and launches
    a step of each, the NCCL kernels' share, peak memory, and the
    predicted per-rank state at world ENGINE_PREDICT_WORLD under fsdp."""
    import torch.distributed as dist
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.mesh import init_distributed, make_test_mesh
    from repro_torch.models import build
    from repro_torch.models import params as PRM
    from repro_torch.train import init_train_state, make_engine
    from repro_torch.train.engine import predicted_state_bytes
    # one card, one rank: NCCL's bootstrap stays on the loopback device
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_IB_DISABLE", "1")
    t0 = time.perf_counter()
    started = init_distributed("cuda")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"engine: backend {dist.get_backend()}, world {dist.get_world_size()}")
    try:
        small = dataclasses.replace(cfg, vision_layers=ENGINE_LAYERS[0],
                                    text_layers=ENGINE_LAYERS[1], layer_scale_init=0.0)
        bundle, policy, _, tc, step, opt, sc = train_parts(torch, small, dev,
                                                           mode="int8_switchback", **CLIP_OPT)
        batches = clip_batches(torch, small, ENGINE_STEPS + 1, CLIP_BATCH, dev, seed + 3100)
        mesh = make_test_mesh((1, 1))

        def fresh():
            return init_train_state(PRM.init_params(bundle.param_specs, seed, device=dev), opt,
                                    sc, seed=seed)

        def engine(**kw):
            par = ParallelConfig(mesh_shape=(1, 1), mesh_axes=("data", "model"), remat="none",
                                 attn_impl="flash_scan", **kw)
            eng = make_engine(bundle, tc, par, mesh, batches[0], policy=policy)
            return eng.step, eng.init_state(seed)

        gather = dict(fsdp=True, fsdp_gather_weights=True, pure_dp=True)
        runs = {"direct": engine_run(torch, M, step, fresh(), batches),
                "a": engine_run(torch, M, *engine(), batches),
                "b": engine_run(torch, M, *engine(**gather), batches),
                "c": engine_run(torch, M, *engine(gather_wire="int8", **gather), batches),
                "wire_direct": engine_run(torch, M, step, fresh(), batches,
                                          lambda: use_weight_through(PRM, PRM.int8_wire)),
                "wire_fault": engine_run(torch, M, step, fresh(), batches,
                                         lambda: use_weight_through(
                                             PRM, lambda w: halves_int8_wire(torch, PRM, w)),
                                         profile=False)}
        for k, ref in (("a", "direct"), ("b", "a"), ("c", "wire_direct")):
            got, want = runs[k], runs[ref]
            check(got["losses"] == want["losses"],
                  f"engine ({k}): losses {got['losses']} != {ref}'s {want['losses']}")
            check(got["digest"] == want["digest"],
                  f"engine ({k}): the final state differs from {ref}'s")
            check_launches(got["counts"], want["counts"], f"engine ({k}) against {ref}")
        check_launches(runs["direct"]["counts"],
                       {k: v * ENGINE_STEPS for k, v in clip_launches_per_step(
                           small, "int8_switchback", M.KOPS.FUSED_MAX_CONTRACT).items()},
                       "engine: the direct step")
        check(runs["wire_fault"]["losses"] != runs["wire_direct"]["losses"],
              "engine (c): the control fault (an absmax per half) left the losses as they were")
        full = dataclasses.replace(cfg, layer_scale_init=0.0)
        fbundle = build(full)
        predicted = {f"world{n}": predicted_state_bytes(
            fbundle, tc, ParallelConfig(mesh_shape=(n, 1), fsdp=n > 1), (n, 1))
            for n in (1, ENGINE_PREDICT_WORLD)}
    finally:
        if started:
            dist.destroy_process_group()
    keys = ("losses", "device_ms_per_step", "cuda_launches_per_step", "nccl_ms_per_step",
            "nccl_launches_per_step", "nccl_share", "peak_memory_gib")
    res = dict(card=nvidia_smi_line(), layers=ENGINE_LAYERS, batch=CLIP_BATCH,
               steps=ENGINE_STEPS,
               runs={k: {kk: r[kk] for kk in keys if kk in r} | {
                   "wrapper_launches_per_step": sum(r["counts"].values()) / ENGINE_STEPS}
                   for k, r in runs.items()},
               wire_equals_no_wire=runs["c"]["losses"] == runs["a"]["losses"],
               predicted_state_bytes_full_depth=predicted,
               seconds=time.perf_counter() - t0)
    print("[engine] " + json.dumps(res))
    return res



# ---------------------------------------------------------------------------
# phase 32: the mixture-of-experts family and fp16/fp32 serving
# ---------------------------------------------------------------------------

# the expert-batched SwitchBack forms (kernels/switchback/ops.py), on the
# int8_switchback expert path of a mixture-of-experts layer
BATCHED_KERNELS = ("tensor_quantize_batched", "fused_switchback_fwd_batched",
                   "fused_switchback_dgrad_batched")
MOE_PY = "src/repro/models/moe.py:41"
SOURCE.update(dict.fromkeys(BATCHED_KERNELS, SB_SOURCE))
REPLACES.update({
    "tensor_quantize_batched": REPLACES["tensor_quantize"] + " under jax.vmap (" + MOE_PY + ")",
    "fused_switchback_fwd_batched": REPLACES["fused_switchback_fwd"] + " under jax.vmap ("
    + MOE_PY + ")",
    "fused_switchback_dgrad_batched": REPLACES["fused_switchback_dgrad"] + " under jax.vmap ("
    + MOE_PY + ")"})
# qwen3-moe-30b-a3b's experts: 128 of d_model 2,048 and d_ff 768; C = 4 at
# decode (8 slots x top 8 / 128 experts, the capacity floor) and 160 at
# train (8 x 256 tokens x 8 / 128 x 1.25)
MOE_E, MOE_D, MOE_FF = 128, 2048, 768
MOE_DECODE_C, MOE_TRAIN_C = 4, 160
# serving at 2 layers (4 until the script took phase 34: a depth cut to
# keep it inside its time; widths, prompts and checks kept)
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS, MINITRON_LAYERS = 2, 2, 2
# smollm-360m's fp16/fp32 serving: full width, 8 of its 32 layers (depth cut
# to keep the script inside its time)
SMOLLM_PRECISION_LAYERS = 8
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 8, 256, 3
# launches per layer per model call of an all-MoE attention stack in
# int8_switchback at qwen3's widths: wq (K 2,048), wk, wv fused; wo (K
# 4,096) row_quantize + the int8 matmul; the experts' three linears batched
MOE_PER_LAYER = {"tensor_quantize": 4, "fused_switchback_fwd": 3, "row_quantize": 1,
                 "int8_matmul_dequant": 1, "tensor_quantize_batched": 3,
                 "fused_switchback_fwd_batched": 3}
# and per layer of a train step (remat "none"): the forward's, then the
# dgrads: wk, wv (output 512) and wo (2,048) fused, wq (4,096) row_quantize
# + the transposed matmul, the experts' three batched; the flash kernels
MOE_TRAIN_PER_LAYER = {"tensor_quantize": 4, "fused_switchback_fwd": 3, "row_quantize": 2,
                       "int8_matmul_dequant": 1, "int8_matmul_dequant_t": 1,
                       "fused_switchback_dgrad": 3, "tensor_quantize_batched": 3,
                       "fused_switchback_fwd_batched": 3, "fused_switchback_dgrad_batched": 3,
                       "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
# minitron-8b (d 4,096, d_ff 16,384), serving: every linear's forward
# contracts over 4,096 or 16,384 > 2,048, so all seven take the two-step path
MINITRON_PER_LAYER = {"tensor_quantize": 7, "row_quantize": 7, "int8_matmul_dequant": 7}
# the reduced qwen3-moe on the card (kernels) against the CPU (plain), 3
# steps, phase 11's readings and rule: each limit the geometric mean of the
# worst sound reading and the smallest control-fault reading over three
# seeds on an H100, rounded to one digit: loss 2.1e-3 (a third step that
# moves a near-tie's expert; the first two steps read 3.5e-4 at most)
# against 6.2e-3, the parameters' mean 4.1e-4 against 5.4e-3 (PERF.md)
MOE_CARD_CPU_TOL = {"loss_rel_err": 4e-3, "param_mean_rel_err": 2e-3}


def batched_inputs(torch, gen, E, C, K, M, dev, dtype=None):
    """x (E, C, K) with an all-zero row (an empty slot) and a row of exact
    ties, W (E, K, M) bf16 with a scale per expert, g (E, C, M)."""
    dtype = dtype or torch.bfloat16
    x = torch.randn((E, C, K), generator=gen, device=dev) * 3
    x[0, 0] = 0.0
    if C > 1:
        x[1, 1] = (torch.arange(K, device=dev) % 8) - 3.5
        x[1, 1, 0] = 127.0
    scale = torch.linspace(0.5, 2.0, E, device=dev)[:, None, None]
    w = (torch.randn((E, K, M), generator=gen, device=dev) * scale).to(torch.bfloat16)
    g = torch.randn((E, C, M), generator=gen, device=dev)
    return x.to(dtype), w, g.to(dtype)


def compare_batched(torch, M, dev, seed):
    """Phase 32 (a): the three expert-batched forms at qwen3's expert
    shapes (up/gate 2,048 -> 768, down 768 -> 2,048) at decode's C = 4 and
    train's C = 160, bf16 and f32 activations, bit-equal to their plain
    versions and to the 2-D kernels looped over the experts, twice the same
    bits, one wrapper launch a call, the K-split workspace left zero.
    Returns the largest |kernel - plain| (0) and the comparisons made."""
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed + 3201)
    worst, n = dict.fromkeys(BATCHED_KERNELS, 0.0), 0
    for C in (MOE_DECODE_C, MOE_TRAIN_C):
        for K, N in ((MOE_D, MOE_FF), (MOE_FF, MOE_D)):
            for dt in (torch.bfloat16, torch.float32):
                x, w, g = batched_inputs(torch, gen, MOE_E, C, K, N, dev, dt)
                KOPS.reset_launch_counts()
                w_q, s_w = KOPS.tensor_quantize_batched(w)
                y = KOPS.fused_switchback_fwd_batched(x, w_q, s_w)
                dx = KOPS.fused_switchback_dgrad_batched(g, w_q, s_w)
                c = KOPS.launch_counts()
                check(all(c[k] == 1 for k in BATCHED_KERNELS), f"batched forms: launches {c}")
                rq, rs = REF.tensor_quantize_batched(w)
                plain = {"tensor_quantize_batched": (w_q, rq),
                         "fused_switchback_fwd_batched": (y, REF.fused_switchback_fwd_batched(
                             x, w_q, s_w)),
                         "fused_switchback_dgrad_batched": (dx, REF.fused_switchback_dgrad_batched(
                             g, w_q, s_w))}
                check(torch.equal(s_w, rs), f"tensor_quantize_batched: states differ at C={C}")
                loop = (torch.stack([KOPS.tensor_quantize(w[e])[0] for e in range(MOE_E)]),
                        torch.stack([KOPS.fused_switchback_fwd(x[e], w_q[e], s_w[e])
                                     for e in range(MOE_E)]),
                        torch.stack([KOPS.fused_switchback_dgrad(g[e], w_q[e], s_w[e])
                                     for e in range(MOE_E)]))
                again = (KOPS.tensor_quantize_batched(w)[0],
                         KOPS.fused_switchback_fwd_batched(x, w_q, s_w),
                         KOPS.fused_switchback_dgrad_batched(g, w_q, s_w))
                for (name, (got, want)), lp, ag in zip(plain.items(), loop, again):
                    where = f"{name} at E={MOE_E} C={C} K={K} M={N} {dt}"
                    worst[name] = max(worst[name], max_abs_diff(torch, got, want))
                    check(torch.equal(got, want), f"{where}: kernel != plain")
                    check(torch.equal(got, lp), f"{where}: kernel != the 2-D kernels' loop")
                    check(torch.equal(got, ag), f"{where}: two launches differ")
                    n += 1
                check(not any(bool(b.any()) for b in KOPS._SPLIT.values()),
                      "batched forms: the K-split workspace was left non-zero")
    return worst, n


def int_mm_loop(torch, x_q, w_q):
    """The library hint beside the batched GEMMs: torch._int_mm an expert
    (x_q (E, C, K), w_q (E, K, M); rows padded to 32, _int_mm's least)."""
    rows = x_q.shape[1]
    pad = max(0, 32 - rows)
    xp = torch.nn.functional.pad(x_q, (0, 0, 0, pad)) if pad else x_q
    return [torch._int_mm(xp[e], w_q[e]) for e in range(x_q.shape[0])]


def time_batched(torch, M, dev, seed):
    """Phase 32 (a)'s times: each batched form at qwen3's layer (the three
    expert linears: two 2,048 -> 768, one 768 -> 2,048) at decode C = 4 and
    train C = 160, by CUDA-graph replay over two input sets; its plain
    version; the bound (bytes: x and W's codes read once, y written; the
    quantizer W's bf16 read and its codes written; operations 2 E C K M at
    the int8 peak); no single PyTorch call runs a batched int8 GEMM, so the
    library time is null and a torch._int_mm loop over the experts (the
    GEMM alone, no quantize or scale) stands beside as a hint."""
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed + 3203)
    linears = ((MOE_D, MOE_FF), (MOE_D, MOE_FF), (MOE_FF, MOE_D))
    out = {}
    for C in (MOE_DECODE_C, MOE_TRAIN_C):
        sets = []
        for _ in range(2):
            layer = []
            for K, N in linears:
                x, w, g = batched_inputs(torch, gen, MOE_E, C, K, N, dev)
                w_q, s_w = KOPS.tensor_quantize_batched(w)
                x_q = x.to(torch.int8)
                layer.append((x, w, g, w_q, s_w, x_q))
            sets.append(layer)
        E = MOE_E
        qbytes = sum(E * K * N * 3 + E * 4 for K, N in linears)
        fbytes = sum(E * C * K * 2 + E * K * N + E * C * N * 2 for K, N in linears)
        dbytes = sum(E * C * N * 2 + E * K * N + E * C * K * 2 for K, N in linears)
        ops = sum(2.0 * E * C * K * N for K, N in linears)
        forms = {
            "tensor_quantize_batched": (lambda s, O: [O.tensor_quantize_batched(t[1]) for t in s],
                                        qbytes, 0.0),
            "fused_switchback_fwd_batched": (
                lambda s, O: [O.fused_switchback_fwd_batched(t[0], t[3], t[4]) for t in s],
                fbytes, ops),
            "fused_switchback_dgrad_batched": (
                lambda s, O: [O.fused_switchback_dgrad_batched(t[2], t[3], t[4]) for t in s],
                dbytes, ops)}
        for name, (call, bytes_, i8) in forms.items():
            r = dict(ms=graph_ms(torch, lambda i: call(sets[i], KOPS), len(sets), reps=10),
                     plain_ms=graph_ms(torch, lambda i: call(sets[i], REF), len(sets), reps=2),
                     library_ms=None, bound=bound(bytes_, int8_ops=i8), calls=3,
                     work=f"one qwen3 layer's 3 expert linears, E={E}, C={C}")
            if i8:
                r["tops"] = i8 / (r["ms"] * 1e-3) / 1e12
                r["bound_share"] = r["bound"][0] / r["ms"]
                r["int_mm_loop_ms"] = graph_ms(
                    torch, lambda i: [int_mm_loop(torch, t[5], t[3]) for t in sets[i]],
                    len(sets), reps=5)
            out.setdefault(name, {})[f"C{C}"] = r
    print("[moe timing] " + json.dumps(out))
    return out


def qwen3_cfg(layers):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=layers)


def moe_prompts(rng, n, vocab, lo=32, hi=128):
    return [rng.integers(0, vocab, size=int(k)).tolist() for k in rng.integers(lo, hi + 1, n)]


def expected_lm_launches(cfg, per_layer, stats, paged):
    """Each wrapper's launches for a generate of an LM whose linears launch
    ``per_layer`` per layer per model call, its attention on the ring
    (flash_fwd a prefill call, decode_fwd a decode step) or the paged
    kernels, everything else 0."""
    L = cfg.n_layers
    calls = stats["prefill_calls"] + stats["decode_steps"]
    want = {k: per * L * calls for k, per in per_layer.items()}
    if paged:
        want.update(paged_decode_fwd=L * stats["decode_steps"],
                    paged_prefill_fwd=L * stats["prefill_calls"])
    else:
        want.update(flash_fwd=L * stats["prefill_calls"], decode_fwd=L * stats["decode_steps"])
    return want


def decode_step_reading(torch, eng, params, tokens):
    """One decode step of ``eng`` on a copy of a filled cache: its CUDA
    kernels (the nodes of a CUDA graph that captures it) and its device ms
    (the graph replayed)."""
    from repro_torch.kernels import build as KBUILD
    from repro_torch.models import transformer as TF
    cache = eng.init_cache()
    lens = torch.full((eng.serve_cfg.max_batch,), 64, dtype=torch.int32, device=eng.device)
    for st in cache.values():
        st.length.copy_(lens[None].expand_as(st.length))
    paged = eng.serve_cfg.cache_mode == "paged"
    nb = -(-eng.serve_cfg.max_len // eng.serve_cfg.block_size) if paged else 0
    tables = (torch.arange(eng.serve_cfg.max_batch * nb, device=eng.device, dtype=torch.int32)
              .reshape(eng.serve_cfg.max_batch, nb) % eng.num_blocks) if paged else None
    rc = eng._rope_rows(lens[:, None])

    def step():
        with torch.inference_mode():
            if paged:
                TF.paged_decode_step(params, cache, tables, tokens, eng.cfg, eng.policy,
                                     eng.parallel, rope_cache=rc)
            else:
                TF.decode_step(params, cache, tokens, eng.cfg, eng.policy, eng.parallel,
                               rope_cache=rc)

    kernels = len(KBUILD.graph_kernels(step))
    ms = graph_ms(torch, lambda i: step(), 1, reps=10)
    return dict(cuda_kernels_per_step=kernels, device_ms_per_step=ms)


def moe_serve(torch, M, dev, seed):
    """Phase 32 (b): qwen3-moe-30b-a3b at full width and MOE_SERVE_LAYERS
    layers, int8_switchback, the ring and the paged engine: 8 prompts of
    32-128 tokens, 32 new tokens, greedy, after a warm-up; every wrapper's
    launches exactly the generate's calls times MOE_PER_LAYER (no 2-D
    SwitchBack kernel runs an expert); the tokens equal to the same
    engine's with the SwitchBack plain versions swapped in on the card
    (bit-equal kernels: the same tokens); a decode step's device ms and
    CUDA kernels (graph nodes)."""
    import numpy as np

    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve import make_serve_engine
    cfg = qwen3_cfg(MOE_SERVE_LAYERS)
    rng = np.random.default_rng(seed + 3205)
    prompts = moe_prompts(rng, 8, cfg.vocab_size)
    res, params = {}, None
    for cache in ("ring", "paged"):
        eng = make_serve_engine(cfg, ServeConfig(max_batch=8, max_len=256, cache_mode=cache,
                                                 quant_mode="int8_switchback"), device=dev)
        if params is None:
            params = eng.init_params(seed)
        eng.generate(params, prompts[:2], max_new_tokens=2)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts(M)
        gens, stats = eng.generate(params, prompts, max_new_tokens=32)
        counts = launch_counts(M)
        check(all(len(g) == 32 for g in gens) and all(0 <= t < cfg.vocab_size
                                                      for g in gens for t in g),
              f"qwen3 serve ({cache}): {[len(g) for g in gens]} tokens")
        check_launches(counts, expected_lm_launches(cfg, MOE_PER_LAYER, stats, cache == "paged"),
                       f"qwen3 serve ({cache})")
        peak = torch.cuda.max_memory_allocated() / 2**30
        with swapped([(M.KOPS, k, getattr(M.REF, k)) for k in SB_KERNELS + BATCHED_KERNELS]):
            plain, _ = eng.generate(params, prompts, max_new_tokens=32)
        check(plain == gens, f"qwen3 serve ({cache}): kernel tokens != plain-version tokens")
        toks = torch.zeros((8, 1), dtype=torch.long, device=dev)
        res[cache] = dict(stats={k: stats[k] for k in (
            "tokens_per_s", "decode_tokens_per_s", "ttft_p50_s", "itl_p50_s", "itl_p95_s",
            "decode_steps", "prefill_calls", "new_tokens")}, peak_memory_gib=peak,
            counts={k: v for k, v in counts.items() if v}, tokens_equal_plain=True,
            **decode_step_reading(torch, eng, params, toks))
        del eng
    print("[moe serve] " + json.dumps(res))
    return res, params


def moe_check_path(torch, M):
    """Phase 32 (c)'s card-vs-CPU path: the reduced qwen3-moe (2 layers ...
    as the config has them), int8_switchback, BigramLM batches of 4 x 64
    over its 512 ids; the control fault the router's top k taken from the
    bottom (on the CPU)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data import BigramLM
    from repro_torch.models import moe as MOE
    cfg = get_reduced_config("qwen3-moe-30b-a3b")

    def batches(n, where, s):
        data = BigramLM(cfg.vocab_size, seed=s, temperature=0.3)
        return [{k: torch.from_numpy(v).to(device=where, dtype=torch.long)
                 for k, v in data.batch(4, 64).items()} for _ in range(n)]

    def bottom_k(probs, k):
        v, i = torch.sort(probs, dim=-1, descending=False, stable=True)
        return v[..., :k], i[..., :k]

    return types.SimpleNamespace(
        tag="moe card vs cpu", small=cfg, modes=("int8_switchback",), seed_offset=37,
        tol=MOE_CARD_CPU_TOL, opt={}, batches=batches, keeps=lambda n, s: None,
        faults={"top k from the bottom (CPU)": control_fault(
            "cpu", lambda: swapped([(MOE, "stable_top_k", bottom_k)]))})


def moe_train(torch, M, dev, seed):
    """Phase 32 (c): qwen3-moe-30b-a3b at full width and MOE_TRAIN_LAYERS
    layers, int8_switchback, StableAdamW, MOE_TRAIN_STEPS steps of 8 x 256
    tokens through ``make_engine`` on a world-1 NCCL group: every wrapper's
    launches exactly MOE_TRAIN_PER_LAYER times the layers and steps, the
    losses finite, moe_aux positive and finite, the peak memory; one step's
    device ms (torch.profiler). Then the reduced config card vs CPU."""
    import torch.distributed as dist
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data import BigramLM
    from repro_torch.launch.mesh import init_distributed, make_test_mesh
    from repro_torch.train import make_engine
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_IB_DISABLE", "1")
    started = init_distributed("cuda")
    try:
        cfg = qwen3_cfg(MOE_TRAIN_LAYERS)
        bundle, policy, _, tc, _, _, _ = train_parts(torch, cfg, dev, mode="int8_switchback")
        data = BigramLM(DATA_VOCAB, seed=seed + 3207, temperature=0.2)
        batches = [{k: torch.from_numpy(v).to(device=dev, dtype=torch.long)
                    for k, v in data.batch(MOE_TRAIN_BATCH, MOE_TRAIN_SEQ).items()}
                   for _ in range(MOE_TRAIN_STEPS + 1)]
        par = ParallelConfig(mesh_shape=(1, 1), mesh_axes=("data", "model"), remat="none",
                             attn_impl="flash_scan")
        eng = make_engine(bundle, tc, par, make_test_mesh((1, 1)), batches[0], policy=policy)
        state = eng.init_state(seed)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts(M)
        t = time.perf_counter()
        losses, aux = [], []
        for b in batches[:MOE_TRAIN_STEPS]:
            state, m = eng.step(state, eng.shard_batch(b))
            losses.append(float(m["loss"]))
            aux.append(float(m["moe_aux"]))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / MOE_TRAIN_STEPS
        counts = launch_counts(M)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all(math.isfinite(x) for x in losses + aux) and all(a > 0 for a in aux),
              f"qwen3 train: losses {losses}, moe_aux {aux}")
        check_launches(counts, {k: v * cfg.n_layers * MOE_TRAIN_STEPS
                                for k, v in MOE_TRAIN_PER_LAYER.items()}, "qwen3 train")
        by_kernel = kernel_times(torch, lambda: eng.step(state, eng.shard_batch(
            batches[MOE_TRAIN_STEPS])), 1)
        del eng, state
    finally:
        if started:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(layers=MOE_TRAIN_LAYERS, tokens=MOE_TRAIN_BATCH * MOE_TRAIN_SEQ, losses=losses,
               moe_aux=aux, step_ms=wall * 1e3, tokens_per_s=MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / wall,
               peak_memory_gib=peak,
               device_ms_per_step=sum(v[0] for v in by_kernel.values()),
               cuda_launches_per_step_profiled=sum(v[1] for v in by_kernel.values()),
               counts={k: v for k, v in counts.items() if v})
    print("[moe train] " + json.dumps(res))
    res["card_vs_cpu"] = card_vs_cpu(torch, M, moe_check_path(torch, M), dev, seed)
    return res


def lm_serve(torch, M, dev, seed, arch, layers, mode, per_layer, prompts, cache="ring"):
    """One generate of ``arch`` at full width and ``layers`` layers in
    ``mode`` (8 slots, 32 new tokens) after a warm-up, its launches exact.
    Returns (tokens, stats)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve import make_serve_engine
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    eng = make_serve_engine(cfg, ServeConfig(max_batch=8, max_len=256, cache_mode=cache,
                                             quant_mode=mode), device=dev)
    params = eng.init_params(seed)
    eng.generate(params, prompts[:2], max_new_tokens=2)
    reset_launch_counts(M)
    gens, stats = eng.generate(params, prompts, max_new_tokens=32)
    check_launches(launch_counts(M), expected_lm_launches(cfg, per_layer, stats, cache == "paged"),
                   f"{arch} serve ({mode}, {cache})")
    check(all(len(g) == 32 for g in gens), f"{arch} serve ({mode}): {[len(g) for g in gens]}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return gens, {k: stats[k] for k in ("tokens_per_s", "itl_p50_s", "decode_steps",
                                        "prefill_calls")}


def serve_precisions(torch, M, dev, seed):
    """Phase 32 (d): minitron-8b at full width and MINITRON_LAYERS layers in
    int8_switchback (the two-step paths at d 4,096 and d_ff 16,384); then
    smollm-360m at full width and SMOLLM_PRECISION_LAYERS layers in bf16,
    fp16 and fp32 on the ring and the paged cache: served fp16 gives
    bf16's tokens bit for bit (both bf16 compute, as the JAX engine builds
    the policy), every run's launches exact (the plain modes launch no
    SwitchBack kernel)."""
    import numpy as np
    from repro_torch.configs import get_config
    rng = np.random.default_rng(seed + 3209)
    res = {}
    mini = get_config("minitron-8b")
    _, res["minitron_int8_switchback"] = lm_serve(
        torch, M, dev, seed, "minitron-8b", MINITRON_LAYERS, "int8_switchback",
        MINITRON_PER_LAYER, moe_prompts(rng, 8, mini.vocab_size))
    smol = get_config("smollm-360m")
    prompts = moe_prompts(rng, 8, smol.vocab_size)
    for cache in ("ring", "paged"):
        gens = {}
        for mode in ("bf16", "fp16", "fp32"):
            gens[mode], res[f"smollm_{mode}_{cache}"] = lm_serve(
                torch, M, dev, seed, "smollm-360m", SMOLLM_PRECISION_LAYERS, mode, {}, prompts,
                cache)
        check(gens["fp16"] == gens["bf16"], f"smollm {cache}: fp16 tokens != bf16 tokens")
        res[f"fp32_tokens_equal_bf16_{cache}"] = gens["fp32"] == gens["bf16"]
    print("[serve precisions] " + json.dumps(res))
    return res


def timed_parts(torch, phase, parts):
    """Run each (part, fn) of ``phase`` in turn, the card synchronised and
    its cache emptied after each; print and return each part's seconds.
    Returns ({part: fn()}, {part: seconds})."""
    out, secs = {}, {}
    for part, fn in parts:
        t = time.perf_counter()
        out[part] = fn()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        secs[part] = time.perf_counter() - t
        print(f"[time] {phase}{part}: {secs[part]:.1f} s", flush=True)
    return out, secs


def moe_phase(torch, M, dev, seed):
    """Phase 32: (a) the batched forms, (b) qwen3 serving, (c) qwen3
    training, (d) minitron and fp16/fp32 serving; each part's seconds."""
    out, secs = timed_parts(torch, "32", (
        ("a", lambda: (compare_batched(torch, M, dev, seed), time_batched(torch, M, dev, seed))),
        ("b", lambda: moe_serve(torch, M, dev, seed)[0]),
        ("c", lambda: moe_train(torch, M, dev, seed)),
        ("d", lambda: serve_precisions(torch, M, dev, seed))))
    (worst, n), times = out["a"]
    print(f"[kernels] {n} expert-batched comparisons bit-equal to plain and to the 2-D "
          "kernels' loop, twice the same bits: " + json.dumps(worst))
    out.update(worst=worst, times=times, seconds=secs)
    return out


# ---------------------------------------------------------------------------
# phase 33: the SSM and hybrid families (rwkv6-1.6b, jamba-v0.1-52b)
# ---------------------------------------------------------------------------

# the decode_step loop (launch/serve.decode_step_fallback): 8 rows, a prompt
# of 32 tokens fed one a step, 32 greedy tokens (63 decode steps)
SSM_BATCH, SSM_PROMPT, SSM_NEW = 8, 32, 32
SSM_STEPS = SSM_PROMPT + SSM_NEW - 1
# jamba at full width and one period (8 layers: attention at 4, Mamba at the
# other seven, MoE MLPs at 1, 3, 5, 7): a period is the least depth the
# config takes (``period()`` asserts n_layers % 8)
JAMBA_LAYERS = 8
# rwkv6 served at full width and 12 of its 24 layers (24 until the script
# took phase 34: a depth cut for its time; the checks are per layer)
RWKV_SERVE_LAYERS = 12
# rwkv6 training at full width and depth: 8 x 256 tokens (S % 64 == 0: the
# chunked form), StableAdamW, the TrainEngine at world 1; the depth would be
# cut if a step's peak passed RWKV_TRAIN_PEAK_GIB
RWKV_TRAIN_LAYERS, RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ, RWKV_TRAIN_STEPS = 24, 8, 256, 3
RWKV_TRAIN_PEAK_GIB = 70.0
JAMBA_PEAK_GIB = 80.0
# launches a decode step in int8_switchback. rwkv6 (d 2,048, d_ff 7,168), a
# layer: wr, wk, wv, wg, wo, w_key, w_receptance contract over 2,048
# (fused), w_value over 7,168 (row_quantize + the int8 matmul); every linear
# quantizes its weight
RWKV_DECODE_PER_LAYER = {"tensor_quantize": 8, "fused_switchback_fwd": 7, "row_quantize": 1,
                         "int8_matmul_dequant": 1}
# jamba (d 4,096, d_inner 8,192, d_ff 14,336), a period: every 2-D linear
# contracts over more than 2,048 (two-step): 7 Mamba layers' w_in, w_x_proj,
# w_out (21), the attention's wq, wk, wv, wo (4), 4 dense MLPs' w_up, w_gate,
# w_down (12); 4 MoE layers' three expert linears batched (12); decode_fwd
# once
JAMBA_DECODE_PER_PERIOD = {"tensor_quantize": 37, "row_quantize": 37, "int8_matmul_dequant": 37,
                           "tensor_quantize_batched": 12, "fused_switchback_fwd_batched": 12,
                           "decode_fwd": 1}
# rwkv6, a layer of a train step (remat "none"): the forward's, then the
# dgrads: every output width 2,048 (fused) but w_key's 7,168
# (row_quantize + the transposed int8 matmul)
RWKV_TRAIN_PER_LAYER = {"tensor_quantize": 8, "fused_switchback_fwd": 7, "row_quantize": 2,
                        "int8_matmul_dequant": 1, "fused_switchback_dgrad": 7,
                        "int8_matmul_dequant_t": 1}
# the reduced configs on the card (kernels) against the CPU (plain), 2 steps
# of 4 x 64 tokens (rwkv6: the chunked form) and 4 x 32 (jamba), phase 11's
# rule: each limit the geometric mean of the worst sound reading and the
# smallest control-fault reading over three seeds on an H100, rounded to
# one digit. rwkv6: loss 1.2e-5 against 7.1e-3, the parameters' mean
# 1.9e-5 against 1.8e-3; jamba: loss 4.1e-5 against 7.1e-3, mean 8.7e-5
# against 6.0e-3 (PERF.md)
SSM_CARD_CPU_TOL = {"rwkv6-1.6b": {"loss_rel_err": 3e-4, "param_mean_rel_err": 2e-4},
                    "jamba-v0.1-52b": {"loss_rel_err": 5e-4, "param_mean_rel_err": 7e-4}}
SSM_CHECK_SEQ = {"rwkv6-1.6b": 64, "jamba-v0.1-52b": 32}


def arch_cfg(arch, layers=None):
    """``arch``'s full config, cut to ``layers`` layers when given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def ssm_linear_shapes(rwkv, jamba):
    """Phase 33's table for ``compare_linear_kernels``: the linears of the
    rwkv6 decode step (8 rows, ties) and train step (2,048 rows), of the
    jamba decode step (8 rows, forward only: jamba trains on the CPU and
    in (d) reduced), and of both reduced configs at (d)'s rows (bf16 and
    f32): w_x_proj's 8,192 -> 288 and the reduced 256 -> 24, whose 24
    outputs fall off the TMA path."""
    from repro_torch.configs import get_reduced_config
    D, F = rwkv.d_model, rwkv.d_ff
    r = {"wr/wk/wv/wg/wo/w_receptance": (D, D, True), "w_key": (D, F, True),
         "w_value": (F, D, True)}

    def mamba(c, dx):
        d_in = c.mamba.expand * c.d_model
        xp = (c.mamba.dt_rank or -(-c.d_model // 16)) + 2 * c.mamba.d_state
        return {"w_in": (c.d_model, 2 * d_in, dx), "w_x_proj": (d_in, xp, dx),
                "w_out": (d_in, c.d_model, dx)}

    d, kv = jamba.d_model, jamba.n_kv_heads * jamba.hd
    j = {**mamba(jamba, False), "wq/wo": (d, d, False), "wk/wv": (d, kv, False),
         "w_up/w_gate": (d, jamba.d_ff, False), "w_down": (jamba.d_ff, d, False)}
    rs, js = get_reduced_config("rwkv6-1.6b"), get_reduced_config("jamba-v0.1-52b")
    small_r = {"wr": (rs.d_model, rs.d_model, True), "w_key": (rs.d_model, rs.d_ff, True),
               "w_value": (rs.d_ff, rs.d_model, True)}
    dts = ("bfloat16", "float32")
    return [("rwkv6 decode", SSM_BATCH, ("bfloat16",), True, False, r),
            ("rwkv6 train", RWKV_TRAIN_BATCH * RWKV_TRAIN_SEQ, ("bfloat16",), False, False, r),
            ("jamba decode", SSM_BATCH, ("bfloat16",), True, False, j),
            ("rwkv6 reduced", 4 * SSM_CHECK_SEQ["rwkv6-1.6b"], dts, False, False, small_r),
            ("jamba reduced", 4 * SSM_CHECK_SEQ["jamba-v0.1-52b"], dts, False, False,
             mamba(js, True))]


def compare_jamba_batched(torch, M, jamba, dev, seed):
    """The expert-batched forward at jamba's expert shapes (16 experts,
    4,096 -> 14,336 and 14,336 -> 4,096) at decode's C = 4: bit-equal to
    its plain version, twice the same bits. Returns the largest |kernel -
    plain| per form and the comparisons made."""
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed + 3301)
    E, worst, n = jamba.moe.n_experts, dict.fromkeys(BATCHED_KERNELS[:2], 0.0), 0
    for K, N in ((jamba.d_model, jamba.d_ff), (jamba.d_ff, jamba.d_model)):
        x, w, _ = batched_inputs(torch, gen, E, 4, K, N, dev)
        w_q, s_w = KOPS.tensor_quantize_batched(w)
        rq, rs = REF.tensor_quantize_batched(w)
        y = KOPS.fused_switchback_fwd_batched(x, w_q, s_w)
        for name, got, want, again in (
                ("tensor_quantize_batched", w_q, rq, KOPS.tensor_quantize_batched(w)[0]),
                ("fused_switchback_fwd_batched", y, REF.fused_switchback_fwd_batched(x, w_q, s_w),
                 KOPS.fused_switchback_fwd_batched(x, w_q, s_w))):
            worst[name] = max(worst[name], max_abs_diff(torch, got, want))
            check(torch.equal(got, want), f"{name} at jamba's E={E} K={K} M={N}: kernel != plain")
            check(torch.equal(got, again), f"{name} at jamba's E={E} K={K} M={N}: reruns differ")
            n += 1
        check(torch.equal(s_w, rs), f"tensor_quantize_batched at jamba's K={K}: states differ")
    return worst, n


def ssm_decode_loop(torch, M, cfg, dev, seed, params, mode, per_step, what,
                    refusal="all-attention"):
    """The serve CLI's path for an SSM or hybrid stack (or a frontend
    stack's text): ``make_serve_engine`` refuses it with ``refusal``,
    ``decode_step_fallback`` serves it (SSM_BATCH rows,
    SSM_PROMPT prompt tokens, SSM_NEW new). Every launch counter exactly
    ``per_step`` times the decode steps; then the same loop with the
    SwitchBack plain versions swapped in (the kernels are bit-equal: the
    same tokens; a mode that launches none has nothing to swap).
    ``decode_fwd`` is not bit-equal to its plain version: ``ssm_serve``
    holds it to that within its tolerance at this loop's shapes. Returns
    the loop's result, its counts and wall s."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.launch.serve import decode_step_fallback
    from repro_torch.models import transformer as TF
    from repro_torch.serve import make_serve_engine
    try:
        make_serve_engine(cfg, ServeConfig(max_batch=SSM_BATCH, max_len=256, quant_mode=mode),
                          device=dev)
        reason = None
    except TF.NoEnginePath as e:
        reason = str(e)
    check(reason is not None and refusal in reason,
          f"{what}: make_serve_engine did not refuse {cfg.name} ({reason})")
    args = argparse.Namespace(arch=cfg.name, device=str(dev), quant_mode=mode,
                              max_batch=SSM_BATCH, prompt_len=SSM_PROMPT, new_tokens=SSM_NEW,
                              seed=seed)
    reset_launch_counts(M)
    t = time.perf_counter()
    res = decode_step_fallback(cfg, args, reason=reason, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = launch_counts(M)
    check_launches(counts, {k: v * SSM_STEPS for k, v in per_step.items()}, what)
    toks = res["tokens"]
    check(tuple(toks.shape) == (SSM_BATCH, SSM_NEW) and bool((toks >= 0).all())
          and bool((toks < cfg.vocab_size).all()), f"{what}: tokens {tuple(toks.shape)}")
    if any(counts[k] for k in SB_KERNELS + BATCHED_KERNELS):
        with swapped([(M.KOPS, k, getattr(M.REF, k)) for k in SB_KERNELS + BATCHED_KERNELS]):
            plain = decode_step_fallback(cfg, args, reason=reason, params=params)
        check(torch.equal(plain["tokens"], toks), f"{what}: kernel tokens != plain-version tokens")
    return res, counts, wall


def slots_crossed(k, v):
    """A control fault of ``decode_fwd`` at any query group: each slot
    reads the next slot's cache (a wrong slot stride)."""
    return k.roll(1, 0), v.roll(1, 0)


def compare_ssm_decode(torch, M, cfg, dev, seed, modes, fault=None, B=SSM_BATCH,
                       S=SSM_PROMPT + SSM_NEW, steps=SSM_STEPS,
                       ragged=(1, 2, 15, 16, 17, 33, 62, 63)):
    """``decode_fwd`` against its plain version at a decode loop's shapes
    for ``cfg`` (by default the SSM loop's; jamba: 32 query heads over 8 KV
    heads, hd 128): B rows over a bf16 cache of S cells, every length the
    loop attends over (1 .. steps, all rows equal, as its slots advance
    together) and the ``ragged`` set, q in each mode's compute dtype,
    within FLASH_O_TOL of max|o|; the control fault (by default query head
    h on KV head h % KV; ``fault(k, v)`` gives another cache, e.g. at a
    query group of 1) must read FAULT_MARGIN x outside. Returns the largest
    |kernel - plain|, the largest relative error, the smallest
    fault/tolerance ratio and the comparisons made."""
    from repro_torch.core.precision import QuantPolicy
    gen = torch.Generator(device=dev).manual_seed(seed + 3304)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = M.FA.softmax_scale(hd)
    check(len(ragged) == B and max(ragged) <= S, f"ragged lengths {ragged} for {B} x {S}")
    r = dict(max_abs_err=0.0, max_rel_err=0.0, fault_over_tol=math.inf, comparisons=0)

    def rand(*shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    k, v = rand(B, S, KV, hd, dt=torch.bfloat16), rand(B, S, KV, hd, dt=torch.bfloat16)
    fk, fv = fault(k, v) if fault else (kv_heads_by_modulo(k, H), kv_heads_by_modulo(v, H))
    lens_sets = [[L] * B for L in range(1, steps + 1)] + [list(ragged)]
    for dt in dict.fromkeys(QuantPolicy(m).compute_dtype for m in modes):
        tol = FLASH_O_TOL[str(dt).replace("torch.", "")]
        for lens in lens_sets:
            what = f"decode_fwd at {cfg.name}'s H{H}/KV{KV}/hd{hd} S_max{S} lens {lens} q {dt}"
            lens = torch.tensor(lens, dtype=torch.int32, device=dev)
            q = rand(B, 1, H, hd, dt=dt)
            o = M.FA.decode_attention(q, k, v, lens)
            ro = M.FREF.decode_fwd(q, k, v, lens, scale=scale)
            fo = M.FREF.decode_fwd(q, fk, fv, lens, scale=scale)
            check(o.dtype == ro.dtype and o.shape == ro.shape
                  and bool(torch.isfinite(o).all()), f"{what}: bad output")
            err, f = rel_err(torch, o, ro), rel_err(torch, o, fo) / tol
            check(err <= tol, f"{what}: kernel vs plain {err:g} > {tol:g}")
            check(f >= FAULT_MARGIN, f"{what}: the control fault reads only {f:g} x the "
                  "tolerance, which so could barely see it")
            r.update(max_abs_err=max(r["max_abs_err"], max_abs_diff(torch, o, ro)),
                     max_rel_err=max(r["max_rel_err"], err),
                     fault_over_tol=min(r["fault_over_tol"], f),
                     comparisons=r["comparisons"] + 1)
    return r


def ssm_step_reading(torch, cfg, params, mode, dev):
    """One decode step on a state 32 tokens in: its CUDA kernels (the nodes
    of a CUDA graph that captures it) and device ms (the graph replayed);
    then the same for the plain recurrences alone (the causal conv and the
    selective scan, RWKV's one-token update), replayed on the inputs they
    took in that step: their share of the step's kernels and device time."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.precision import QuantPolicy
    from repro_torch.kernels import build as KBUILD
    from repro_torch.models import transformer as TF
    from repro_torch.models.ssm import mamba as TM
    from repro_torch.models.ssm import rwkv6 as TR
    pol, par = QuantPolicy(mode), ParallelConfig(remat="none")
    state = TF.init_decode_state(cfg, SSM_BATCH, SSM_PROMPT + SSM_NEW, device=dev)
    for st in state.values():
        if hasattr(st, "length"):
            st.length.fill_(SSM_PROMPT)
    tok = torch.zeros((SSM_BATCH, 1), dtype=torch.long, device=dev)

    def step():
        with torch.inference_mode():
            TF.decode_step(params, state, tok, cfg, pol, par)

    calls = []

    def recorded(fn):
        def run(*a, **kw):
            calls.append((fn, tuple(t.clone() if torch.is_tensor(t) else t for t in a), kw))
            return fn(*a, **kw)
        return run

    with swapped([(TM, "_conv1d_causal", recorded(TM._conv1d_causal)),
                  (TM, "selective_scan", recorded(TM.selective_scan)),
                  (TR, "rwkv6_step", recorded(TR.rwkv6_step))]):
        step()

    def recurrences():
        with torch.inference_mode():
            for fn, a, kw in calls:
                fn(*a, **kw)

    out = graph_step_reading(torch, step)
    if calls:
        rec_kernels = len(KBUILD.graph_kernels(recurrences))
        rec_ms = graph_ms(torch, lambda i: recurrences(), 1, reps=10)
        out.update(recurrence_calls_per_step=len(calls), recurrence_cuda_kernels=rec_kernels,
                   recurrence_device_ms=rec_ms,
                   recurrence_kernel_share=rec_kernels / out["cuda_kernels_per_step"],
                   recurrence_time_share=rec_ms / out["device_ms_per_step"])
    return out


def graph_step_reading(torch, step):
    """A decode step's CUDA kernels (the nodes of a CUDA graph that captures
    ``step()``) and device ms (the graph replayed)."""
    from repro_torch.kernels import build as KBUILD
    return dict(cuda_kernels_per_step=len(KBUILD.graph_kernels(step)),
                device_ms_per_step=graph_ms(torch, lambda i: step(), 1, reps=10))


def ssm_serve(torch, M, dev, seed, arch, layers, per_step, peak_limit=None,
              refusal="all-attention"):
    """Phase 33 (a) and (b), and phase 34 (b): ``arch`` at full width and
    ``layers`` layers, random weights from the seed, refused by the engine
    with ``refusal``, through the decode_step loop under
    ``int8_switchback`` (launches exact, tokens equal to the plain
    versions') and ``bf16`` (no SwitchBack launch; the attention's
    ``decode_fwd`` as in int8); where the stack attends, ``decode_fwd``
    against its plain version at the loop's shapes in both modes
    (``compare_ssm_decode``); a decode step's device ms and the
    recurrences' share in both modes; the peak memory."""
    from repro_torch.models import build
    from repro_torch.models import params as PRM
    cfg = arch_cfg(arch, layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = PRM.init_params(build(cfg).param_specs, seed, device=dev)
    n_params = sum(t.numel() for t in PRM.tree_leaves(params))
    res = dict(layers=cfg.n_layers, params=n_params)
    for mode, want in (("int8_switchback", per_step),
                       ("bf16", {k: v for k, v in per_step.items() if k == "decode_fwd"})):
        out, counts, wall = ssm_decode_loop(torch, M, cfg, dev, seed, params, mode, want,
                                            f"{arch} decode ({mode})", refusal)
        res[mode] = dict(tokens_per_s=out["tokens_per_s"], decode_s=out["decode_s"],
                         loop_wall_s=wall, steps=SSM_STEPS,
                         plain_versions_swapped_in=any(counts[k] for k in SB_KERNELS
                                                       + BATCHED_KERNELS),
                         counts={k: v for k, v in counts.items() if v},
                         **ssm_step_reading(torch, cfg, params, mode, dev))
    if "decode_fwd" in per_step:
        res["decode_fwd_check"] = compare_ssm_decode(torch, M, cfg, dev, seed,
                                                     ("int8_switchback", "bf16"))
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if peak_limit:
        check(res["peak_memory_gib"] < peak_limit,
              f"{arch}: peak {res['peak_memory_gib']:.2f} GiB at {layers} layers, full width")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[ssm serve] {arch} " + json.dumps(res))
    return res


def rwkv_train(torch, M, dev, seed):
    """Phase 33 (c): rwkv6-1.6b at full width and RWKV_TRAIN_LAYERS layers,
    int8_switchback, StableAdamW, RWKV_TRAIN_STEPS steps of 8 x 256 tokens
    through ``make_engine`` on a world-1 NCCL group (``engine_train``)."""
    cfg = arch_cfg("rwkv6-1.6b", RWKV_TRAIN_LAYERS)
    batches = bigram_batches(torch, RWKV_TRAIN_STEPS + 1, RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ,
                             dev, seed + 3303)
    want = {k: v * cfg.n_layers for k, v in RWKV_TRAIN_PER_LAYER.items()}
    return engine_train(torch, M, dev, seed, cfg, batches, want, RWKV_TRAIN_PEAK_GIB,
                        "ssm train", RWKV_TRAIN_BATCH * RWKV_TRAIN_SEQ)


def engine_train(torch, M, dev, seed, cfg, batches, want, peak_limit, tag, tokens,
                 optimizer="stable_adamw"):
    """``cfg`` in int8_switchback with ``optimizer``, remat "none", through
    ``make_engine`` on a world-1 NCCL group: ``len(batches) - 1`` steps with
    the launch counters zeroed just before, each wrapper's launches exactly
    ``want`` a step, the losses finite, the peak under ``peak_limit`` GiB;
    then one step profiled (torch.profiler, the last batch): its device ms
    and CUDA launches. ``tokens`` a step give tokens/s."""
    import torch.distributed as dist
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.mesh import init_distributed, make_test_mesh
    from repro_torch.train import make_engine
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_IB_DISABLE", "1")
    steps = len(batches) - 1
    started = init_distributed("cuda")
    try:
        bundle, policy, _, tc, _, _, _ = train_parts(torch, cfg, dev, mode="int8_switchback",
                                                     optimizer=optimizer)
        par = ParallelConfig(mesh_shape=(1, 1), mesh_axes=("data", "model"), remat="none")
        eng = make_engine(bundle, tc, par, make_test_mesh((1, 1)), batches[0], policy=policy)
        state = eng.init_state(seed)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts(M)
        t = time.perf_counter()
        losses = []
        for b in batches[:steps]:
            state, m = eng.step(state, eng.shard_batch(b))
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / steps
        counts = launch_counts(M)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all(math.isfinite(x) for x in losses), f"{cfg.name} train: losses {losses}")
        check(peak < peak_limit, f"{cfg.name} train: peak {peak:.2f} GiB at {cfg.n_layers} "
              "layers")
        check_launches(counts, {k: v * steps for k, v in want.items()}, f"{cfg.name} train")
        by_kernel = kernel_times(torch, lambda: eng.step(state, eng.shard_batch(batches[-1])), 1)
        del eng, state
    finally:
        if started:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(layers=cfg.n_layers, optimizer=optimizer, tokens=tokens, losses=losses,
               step_ms=wall * 1e3,
               tokens_per_s=tokens / wall, peak_memory_gib=peak,
               device_ms_per_step=sum(v[0] for v in by_kernel.values()),
               cuda_launches_per_step_profiled=sum(v[1] for v in by_kernel.values()),
               counts={k: v for k, v in counts.items() if v})
    print(f"[{tag}] {cfg.name} " + json.dumps(res))
    return res


def no_token_shift(x, x_prev):
    """rwkv6's control fault: the token shift dropped (each mix reads the
    token itself), a plausible slip of the DDLerp."""
    return x


def ssm_check_path(torch, arch):
    """Phase 33 (d)'s card-vs-CPU path: ``arch``'s reduced config as it
    stands, int8_switchback, BigramLM batches of 4 x SSM_CHECK_SEQ over its
    512 ids; the control fault on the CPU: rwkv6's token shift dropped,
    jamba's causal conv taps reversed."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data import BigramLM
    from repro_torch.models.ssm import mamba as TM
    from repro_torch.models.ssm import rwkv6 as TR
    cfg = get_reduced_config(arch)
    seq = SSM_CHECK_SEQ[arch]

    def batches(n, where, s):
        data = BigramLM(cfg.vocab_size, seed=s, temperature=0.3)
        return [{k: torch.from_numpy(v).to(device=where, dtype=torch.long)
                 for k, v in data.batch(4, seq).items()} for _ in range(n)]

    conv = TM._conv1d_causal
    if arch == "rwkv6-1.6b":
        fault = {"token shift dropped (CPU)": control_fault(
            "cpu", lambda: swapped([(TR, "_token_shift", no_token_shift)]))}
    else:
        fault = {"conv taps reversed (CPU)": control_fault(
            "cpu", lambda: swapped([(TM, "_conv1d_causal",
                                     lambda x, k, b, p=None: conv(x, k.flip(0), b, p))]))}
    return types.SimpleNamespace(
        tag=f"{arch} card vs cpu", small=cfg, modes=("int8_switchback",),
        seed_offset=41 if arch == "rwkv6-1.6b" else 43, tol=SSM_CARD_CPU_TOL[arch], opt={},
        batches=batches, keeps=lambda n, s: None, faults=fault)


def add_ssm_launches(kernel_entries, ssm):
    """Each kernel entry with its launches a phase 33 step beside its own
    path's: an rwkv6 and a jamba decode step (``int8_switchback``), an
    rwkv6 train step."""
    runs = {"rwkv6_decode_step": (ssm["a"]["int8_switchback"]["counts"], SSM_STEPS),
            "jamba_decode_step": (ssm["b"]["int8_switchback"]["counts"], SSM_STEPS),
            "rwkv6_train_step": (ssm["c"]["counts"], RWKV_TRAIN_STEPS)}
    for e in kernel_entries:
        e["launches_ssm"] = {run: c.get(e["name"], 0) / n for run, (c, n) in runs.items()}
    return kernel_entries


def ssm_report(ssm) -> dict:
    """Phase 33's readings without the raw launch counts (those go to the
    kernel entries)."""
    def serve(r):
        return {k: ({kk: vv for kk, vv in v.items() if kk != "counts"} if isinstance(v, dict)
                    else v) for k, v in r.items()}
    return {"seconds": ssm["seconds"], "a": serve(ssm["a"]), "b": serve(ssm["b"]),
            "c": {k: v for k, v in ssm["c"].items() if k != "counts"}}


def ssm_phase(torch, M, dev, seed):
    """Phase 33: (a) rwkv6-1.6b served at full width and 12 layers, (b)
    jamba-v0.1-52b served at full width and one period, (c) rwkv6 trained
    at full width, (d) both reduced configs card vs CPU; the kernels at the
    new shapes against their plain versions first. Each part's seconds."""
    rwkv = arch_cfg("rwkv6-1.6b", RWKV_SERVE_LAYERS)
    jamba = arch_cfg("jamba-v0.1-52b", JAMBA_LAYERS)
    out, secs = timed_parts(torch, "33", (
            ("kernels", lambda: (compare_linear_kernels(torch, M, ssm_linear_shapes(rwkv, jamba),
                                                        dev, seed + 3300),
                                 compare_jamba_batched(torch, M, jamba, dev, seed))),
            ("a", lambda: ssm_serve(torch, M, dev, seed, "rwkv6-1.6b", rwkv.n_layers,
                                    {k: v * rwkv.n_layers
                                     for k, v in RWKV_DECODE_PER_LAYER.items()})),
            ("b", lambda: ssm_serve(torch, M, dev, seed, "jamba-v0.1-52b", JAMBA_LAYERS,
                                    JAMBA_DECODE_PER_PERIOD, JAMBA_PEAK_GIB)),
            ("c", lambda: rwkv_train(torch, M, dev, seed)),
            ("d", lambda: {a: card_vs_cpu(torch, M, ssm_check_path(torch, a), dev, seed,
                                          steps=2)
                           for a in ("rwkv6-1.6b", "jamba-v0.1-52b")})))
    (worst, n), (bworst, bn) = out["kernels"]
    print(f"[kernels] {n} SwitchBack and {bn} expert-batched comparisons at the SSM paths' "
          "shapes bit-equal to plain, twice the same bits: "
          + json.dumps({k: v for k, v in {**worst, **bworst}.items()}))
    dec = out["b"]["decode_fwd_check"]
    print(f"[kernels] {dec['comparisons']} decode_fwd comparisons at jamba's decode loop "
          f"shapes within o {FLASH_O_TOL['bfloat16']:g} of max|o|; control fault >= "
          f"{FAULT_MARGIN:g}x the tolerance: " + json.dumps(dec))
    out.update(worst={**{k: max(worst.get(k, 0.0), bworst.get(k, 0.0))
                         for k in set(worst) | set(bworst)},
                      "decode_fwd": dec["max_abs_err"]}, seconds=secs)
    return out


# ---------------------------------------------------------------------------
# phase 34: the multimodal and enc-dec group (internvl2-76b, seamless-m4t-large-v2)
# ---------------------------------------------------------------------------

VLM, ENCDEC = "internvl2-76b", "seamless-m4t-large-v2"
# internvl2-76b at full width (d 8,192, 64 heads over 8 KV heads of 128,
# d_ff 28,672, vocab 128,256): a layer holds 855.6 M parameters, embedding
# and head 2,101.3 M, frontend_proj 67.1 M. Served through the serve CLI's
# decode_step loop (phase 33's 8 rows, prompt 32, 32 new tokens) at 8 of
# its 80 layers (9.01 B f32 parameters, 33.6 GiB); trained at 1 layer
# (StableAdamW's 16 bytes a parameter: 45.1 GiB; 2 layers 57.8 GiB before
# activations and the out-of-place update)
VLM_SERVE_LAYERS, VLM_TRAIN_LAYERS = 8, 1
# seamless-m4t-large-v2 at full width and depth (24 encoder + 24 decoder
# layers, d 1,024, 16 heads of 64, d_ff 8,192, vocab 256,206, 1.633 B
# parameters): 8 rows of 4,096 frames encoded once, a start token, 32
# greedy tokens from init_decode_state / decode_step
ENCDEC_BATCH, ENCDEC_NEW = 8, 32
# training through make_engine (world 1, remat "none"), 2 steps and a
# profiled third: seamless 2 x (4,096 frames, 64 target tokens) with
# StableAdamW: 24.3 GiB of state and ~0.8 GB of saved activations an
# encoder layer a row (the tanh-GELU's f32 input the largest), so 2 rows
# stay under the limit where 4 would not; internvl2 8 x (256 frontend + 64
# text tokens) with AdaFactor: StableAdamW's out-of-place update holds the
# parameters, gradients, old and new moments and new parameters at once,
# 7 x 12.1 GB for one layer's 3.02 B parameters, past the card's 80 GB
# (ROADMAP.md H2); AdaFactor's factored state is 0.2% of the parameters'
ENCDEC_TRAIN_BATCH, VLM_TRAIN_BATCH, MM_TRAIN_SEQ, MM_TRAIN_STEPS = 2, 8, 64, 2
MM_TRAIN_OPTIMIZER = {ENCDEC: "stable_adamw", VLM: "adafactor"}
MM_PEAK_GIB = 70.0
# the reduced configs on the card (kernels) against the CPU (plain), 2
# steps, phase 11's rule: each limit the geometric mean of the worst sound
# reading and the smallest control-fault reading over three seeds on an
# H100, rounded to one digit. internvl2: loss 2.6e-4 against 2.6e-2, the
# parameters' mean 2.4e-5 against 1.3e-3 (the frontend's int8 rounding
# flips lead); seamless: loss 6.2e-6 against 1.7e-2, mean 4.4e-6 against
# 1.3e-3 (PERF.md)
MM_CARD_CPU_TOL = {VLM: {"loss_rel_err": 3e-3, "param_mean_rel_err": 2e-4},
                   ENCDEC: {"loss_rel_err": 3e-4, "param_mean_rel_err": 8e-5}}
MM_CHECK_BATCH, MM_CHECK_SEQ = 4, 16


def mm_linears(cfg):
    """(K, M) of one layer's linears in call order: an LM layer's seven
    (``path_shapes``); an enc-dec decoder layer's attention four (wq, wk,
    wv, wo), the cross attention's four (wq and wo on the decoder's rows,
    wk and wv on the encoder's) and the MLP's two (GELU)."""
    D, FF = cfg.d_model, cfg.d_ff
    if cfg.family != "encdec":
        return path_shapes(cfg)
    return {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wo": (D, D),
            "x_wq": (D, D), "x_wk": (D, D), "x_wv": (D, D), "x_wo": (D, D),
            "w_up": (D, FF), "w_down": (FF, D)}


def linear_launches(shapes, fused_max, backward=False, no_dx=()):
    """Each SwitchBack wrapper's launches for the linears ``shapes`` (K, M)
    in int8_switchback: ``tensor_quantize`` each; the forward fused where K
    fits ``fused_max``, else ``row_quantize`` + ``int8_matmul_dequant``;
    with ``backward`` the dgrad (but of the linears in ``no_dx``, whose
    input is data) fused where M fits, else ``row_quantize`` +
    ``int8_matmul_dequant_t`` (core/switchback)."""
    n = dict.fromkeys(("tensor_quantize", "fused_switchback_fwd", "row_quantize",
                       "int8_matmul_dequant", "fused_switchback_dgrad",
                       "int8_matmul_dequant_t"), 0)
    for name, (K, Mw) in shapes.items():
        n["tensor_quantize"] += 1
        if K <= fused_max:
            n["fused_switchback_fwd"] += 1
        else:
            n["row_quantize"] += 1
            n["int8_matmul_dequant"] += 1
        if backward and name not in no_dx:
            if Mw <= fused_max:
                n["fused_switchback_dgrad"] += 1
            else:
                n["row_quantize"] += 1
                n["int8_matmul_dequant_t"] += 1
    return n


def add_counts(*parts):
    out = {}
    for times, part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0) + times * v
    return out


def mm_launches(cfg, run, fused_max, mode="int8_switchback"):
    """Each wrapper's launches of one ``run`` of ``cfg``: "decode_step" (an
    LM's text decode step, or an enc-dec decoder step), "encode" (the
    enc-dec encoder over the frames, once in init_decode_state), "train"
    (a train step, remat "none"; ``frontend_proj`` where the config has a
    frontend); bf16 launches the attention kernels only."""
    L = cfg.n_layers
    lin = mm_linears(cfg)
    sb = mode == "int8_switchback"

    def linears(shapes, **kw):
        return linear_launches(shapes, fused_max, **kw) if sb else {}
    if run == "decode_step":
        if cfg.family == "encdec":      # self attention on the cache, cross by flash_fwd
            return add_counts((L, linears(lin)), (L, {"decode_fwd": 1, "flash_fwd": 1}))
        return add_counts((L, linears(lin)), (L, {"decode_fwd": 1}))
    D = cfg.d_model
    front = linears({"frontend_proj": (D, D)}) if cfg.frontend else {}
    if run == "encode":
        enc = {k: v for k, v in lin.items() if not k.startswith("x_")}
        return add_counts((1, front), (cfg.encdec.n_encoder_layers, linears(enc)),
                          (cfg.encdec.n_encoder_layers, {"flash_fwd": 1}))
    flash = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    if cfg.family == "encdec":
        enc = {k: v for k, v in lin.items() if not k.startswith("x_")}
        n_enc = cfg.encdec.n_encoder_layers
        return add_counts((1, front), (n_enc, linears(enc, backward=True)), (n_enc, flash),
                          (L, linears(lin, backward=True)), (2 * L, flash))
    return add_counts((1, front), (L, linears(lin, backward=True)), (L, flash))


def mm_linear_shapes(vlm, s2s):
    """Phase 34's table for ``compare_linear_kernels``: internvl2's linears
    at its decode rows (8; every K past FUSED_MAX_CONTRACT, so the two-step
    forms), frontend_proj at 8 x 256 frontend rows and the seven at the
    train step's 8 x 320 rows (forward and dgrad); seamless's at its
    decode rows (8), at the encoder's 8 x 4,096 rows (the cross K/V and
    frontend_proj, forward) and at its train rows (2 x 4,096 encoder, 2 x
    64 decoder, forward and dgrad); both reduced configs at (e)'s rows,
    bf16 and f32."""
    from repro_torch.configs import get_reduced_config
    bf, both = ("bfloat16",), ("bfloat16", "float32")

    def table(cfg, dx):
        return {f"{K}x{Mw}": (K, Mw, dx) for K, Mw in mm_linears(cfg).values()}
    D, Ds = vlm.d_model, s2s.d_model
    rv, rs = get_reduced_config(VLM), get_reduced_config(ENCDEC)
    rows = MM_CHECK_BATCH * MM_CHECK_SEQ
    return [("internvl2 decode", SSM_BATCH, bf, True, False, table(vlm, False)),
            ("internvl2 frontend_proj", VLM_TRAIN_BATCH * vlm.frontend_tokens, bf, False, False,
             {"frontend_proj": (D, D, False)}),
            ("internvl2 train", VLM_TRAIN_BATCH * (vlm.frontend_tokens + MM_TRAIN_SEQ), bf,
             False, False, table(vlm, True)),
            ("seamless decode", ENCDEC_BATCH, bf, True, False, table(s2s, False)),
            ("seamless encoder rows", ENCDEC_BATCH * s2s.frontend_tokens, bf, False, False,
             {"frontend_proj/x_wk/x_wv": (Ds, Ds, False)}),
            ("seamless train encoder", ENCDEC_TRAIN_BATCH * s2s.frontend_tokens, bf, False,
             False, table(s2s, True)),
            ("seamless train decoder", ENCDEC_TRAIN_BATCH * MM_TRAIN_SEQ, bf, False, False,
             table(s2s, True)),
            ("internvl2 reduced", MM_CHECK_BATCH * (rv.frontend_tokens + MM_CHECK_SEQ), both,
             False, False, table(rv, True)),
            ("seamless reduced decoder", rows, both, False, False, table(rs, True)),
            ("seamless reduced encoder", MM_CHECK_BATCH * rs.frontend_tokens, both, False, False,
             table(rs, True))]


def mm_flash_cases(vlm, s2s):
    """Phase 34's flash table (``compare_flash_train``'s form): seamless's
    encoder (one row's 4,096 x 4,096, no mask), its cross attention at
    train (2 x 64 queries over 4,096 frames) and at decode (8 x 1 over
    4,096), their control fault the causal mask added (cross attention
    called as self-attention is); internvl2's causal 8 x (256 + 64) over
    64 heads and 8 KV heads of 128, its fault the KV heads tiled; both
    reduced configs' shapes (seamless's 16 queries over 32 frames)."""
    from repro_torch.configs import get_reduced_config
    S, H, hd = s2s.frontend_tokens, s2s.n_heads, s2s.hd
    Sv, Hv, KVv = vlm.frontend_tokens + MM_TRAIN_SEQ, vlm.n_heads, vlm.n_kv_heads
    rv, rs = get_reduced_config(VLM), get_reduced_config(ENCDEC)
    Sr = rv.frontend_tokens + MM_CHECK_SEQ
    return [("seamless encoder", 1, S, S, S, H, H, hd, False, mask_fault),
            ("seamless cross train", ENCDEC_TRAIN_BATCH, MM_TRAIN_SEQ, S, S, H, H, hd, False,
             mask_fault),
            ("seamless cross decode", ENCDEC_BATCH, 1, S, S, H, H, hd, False, mask_fault),
            ("internvl2", VLM_TRAIN_BATCH, Sv, Sv, Sv, Hv, KVv, vlm.hd, True,
             gqa_fault(Hv, KVv)),
            ("seamless reduced cross", MM_CHECK_BATCH, MM_CHECK_SEQ, rs.frontend_tokens,
             rs.frontend_tokens, rs.n_heads, rs.n_kv_heads, rs.hd, False, mask_fault),
            ("internvl2 reduced", MM_CHECK_BATCH, Sr, Sr, Sr, rv.n_heads, rv.n_kv_heads, rv.hd,
             True, gqa_fault(rv.n_heads, rv.n_kv_heads))]


def compare_f32_weight(torch, M, s2s, dev, seed):
    """seamless's frontend_proj reaches the quantizer as its f32 master (the
    JAX layer hands it over uncast): ``tensor_quantize`` of an f32 (1,024,
    1,024) weight, not bf16-valued, bit-equal to its plain version twice,
    and the fused forward on its codes at the encoder's 8 x 4,096 rows.
    Returns the largest |kernel - plain| per kernel and the comparisons."""
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed)
    D = s2s.d_model
    w = torch.randn((D, D), generator=gen, device=dev) / D ** 0.5
    check(not torch.equal(w, w.to(torch.bfloat16).float()), "the f32 weight is bf16-valued")
    w_q, s_w = KOPS.tensor_quantize(w)
    r_q, r_s = REF.tensor_quantize(w)
    again = KOPS.tensor_quantize(w)
    check(torch.equal(w_q, r_q) and torch.equal(s_w, r_s) and torch.equal(again[0], w_q),
          "tensor_quantize of seamless's f32 frontend_proj: kernel != plain")
    x = activations(torch, gen, ENCDEC_BATCH * s2s.frontend_tokens, D, dev)
    y, ry = KOPS.fused_switchback_fwd(x, w_q, s_w), REF.fused_switchback_fwd(x, w_q, s_w)
    check(torch.equal(y, ry), "fused_switchback_fwd on the f32 frontend_proj's codes: "
          "kernel != plain")
    return {"tensor_quantize": max_abs_diff(torch, w_q, r_q),
            "fused_switchback_fwd": max_abs_diff(torch, y, ry)}, 2


def mm_kernels(torch, M, dev, seed):
    """Phase 34 (a): every SwitchBack kernel at both models' linear shapes
    bit-equal to its plain version (``mm_linear_shapes``; seamless's f32
    frontend_proj apart), the flash kernels at the new attention shapes,
    Sq != Sk included (``mm_flash_cases``, bf16 and f32), ``decode_fwd`` at
    internvl2's query group 8 (hd 128) and seamless's group 1 (hd 64, its
    control fault the slots crossed), each at its own decode loop's cache
    (internvl2's 64 cells, seamless's 1 + ENCDEC_NEW = 33, not a multiple
    of the kernel's 16-key parts). Returns the readings."""
    vlm, s2s = arch_cfg(VLM), arch_cfg(ENCDEC)
    sb, n_sb = compare_linear_kernels(torch, M, mm_linear_shapes(vlm, s2s), dev, seed + 3400)
    f32w, n_f32 = compare_f32_weight(torch, M, s2s, dev, seed + 3401)
    flash, n_flash = compare_flash_train(torch, M, mm_flash_cases(vlm, s2s), dev, seed + 3402)
    dec = {VLM: compare_ssm_decode(torch, M, vlm, dev, seed + 3403, ("int8_switchback", "bf16")),
           ENCDEC: compare_ssm_decode(torch, M, s2s, dev, seed + 3404,
                                      ("int8_switchback", "bf16"), fault=slots_crossed,
                                      B=ENCDEC_BATCH, S=1 + ENCDEC_NEW, steps=ENCDEC_NEW,
                                      ragged=(1, 2, 15, 16, 17, 31, 32, 33))}
    worst = {k: max(sb.get(k, 0.0), f32w.get(k, 0.0)) for k in set(sb) | set(f32w)}
    worst.update({k: v["max_abs_err"] for k, v in flash.items()})
    worst["decode_fwd"] = max(d["max_abs_err"] for d in dec.values())
    print(f"[kernels] {n_sb + n_f32} SwitchBack comparisons at internvl2's and seamless's "
          "shapes (f32 frontend_proj too) bit-equal, twice the same bits; "
          f"{n_flash} flash comparisons (Sq != Sk included) within o {json.dumps(FLASH_O_TOL)}, "
          f"backward {json.dumps(FLASH_BWD_TOL)}, control fault >= {FAULT_MARGIN:g}x: "
          + json.dumps(flash) + "; decode_fwd at groups 8 and 1: " + json.dumps(dec))
    return dict(worst=worst, flash=flash, decode=dec, comparisons=n_sb + n_f32 + n_flash
                + sum(d["comparisons"] for d in dec.values()))


def time_mm_kernels(torch, M, dev, seed):
    """Phase 34 (a)'s times, each beside its plain version, a library call
    where one exists and the bound: the flash kernels at seamless's encoder
    (one row), its cross attention (train and decode; the decode call the
    forward only) and internvl2's attention (``time_flash_cases``);
    ``decode_fwd`` at both decode loops' step 16 (``time_decode``);
    ``tensor_quantize`` of internvl2's largest weight (8,192 x 28,672 bf16)
    and seamless's f32 frontend_proj; the fused pair at seamless's train
    encoder rows (2 x 4,096, 1,024 -> 1,024: frontend_proj, the cross K/V,
    the attention); ``row_quantize`` + ``int8_matmul_dequant`` at
    internvl2's w_down in a decode step (8 rows, 28,672 -> 8,192)."""
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed + 3410)
    vlm, s2s = arch_cfg(VLM), arch_cfg(ENCDEC)
    cases = mm_flash_cases(vlm, s2s)
    out = time_flash_cases(torch, M, [c for c in cases[:4] if c[2] > 1], dev, seed + 3411)
    fwd1 = time_flash_cases(torch, M, [cases[2]], dev, seed + 3412, backward=False)
    out["flash_fwd"].update(fwd1["flash_fwd"])
    lens = [16] * SSM_BATCH
    out["decode_fwd"] = {
        VLM: time_decode(torch, M, gen, dev, SSM_PROMPT + SSM_NEW, vlm.n_heads, vlm.n_kv_heads,
                         vlm.hd, lens),
        ENCDEC: time_decode(torch, M, gen, dev, 1 + ENCDEC_NEW, s2s.n_heads, s2s.n_kv_heads,
                            s2s.hd, [16] * ENCDEC_BATCH)}
    # tensor_quantize: (shape, dtype) -> readings
    tq = {}
    for K, N, dt in ((vlm.d_model, vlm.d_ff, torch.bfloat16),
                     (s2s.d_model, s2s.d_model, torch.float32)):
        n = K * N
        sets = [(torch.randn((K, N), generator=gen, device=dev) / K ** 0.5).to(dt)
                for _ in range(max(2, int(120e6 // (n * 2)) + 1))]
        size = torch.empty((), dtype=dt).element_size()
        tq[f"{K}x{N} {str(dt).replace('torch.', '')}"] = time_work(
            torch, KOPS, REF, sets, {"tensor_quantize": (
                1, lambda s, op: op.tensor_quantize(s), None, n * size + n + 4, 0, 4 * n)},
            lambda c: f"one weight {K} x {N}")["tensor_quantize"]
        del sets
    out["tensor_quantize"] = tq
    D = s2s.d_model
    for k, v in time_fused(torch, M, gen, dev, ENCDEC_TRAIN_BATCH * s2s.frontend_tokens,
                           [(D, D)], [(D, D)], lambda c: f"one 1,024 x 1,024 call at "
                           f"{ENCDEC_TRAIN_BATCH} x {s2s.frontend_tokens} rows").items():
        out[k] = {"seamless train encoder rows": v}
    K, N, R = vlm.d_ff, vlm.d_model, SSM_BATCH
    sets = []
    for _ in range(2):
        w_q, s_w = KOPS.tensor_quantize(weight(torch, gen, K, N, dev))
        x = activations(torch, gen, R, K, dev)
        x_q, s_x = KOPS.row_quantize(x)
        sets.append(dict(x=x, w_q=w_q, x_q=x_q, scale=s_x * REF.div(s_w, 127.0 * 127.0)))

    def int_mm(s):                        # torch._int_mm wants more than 16 rows
        xq = torch.cat([s["x_q"], s["x_q"].new_zeros((32 - R, K))])
        return (torch._int_mm(xq, s["w_q"])[:R].float() * s["scale"]).to(torch.bfloat16)
    check(torch.equal(int_mm(sets[0]), KOPS.int8_matmul_dequant(sets[0]["x_q"], sets[0]["w_q"],
                                                                 sets[0]["scale"])),
          "torch._int_mm yardstick disagrees with int8_matmul_dequant")
    work = {"row_quantize": (1, lambda s, op: op.row_quantize(s["x"]), None,
                             R * K * 2 + R * K + R * 4, 0, 4 * R * K),
            "int8_matmul_dequant": (
                1, lambda s, op: op.int8_matmul_dequant(s["x_q"], s["w_q"], s["scale"]), int_mm,
                R * K + K * N + R * 4 + R * N * 2, 2 * R * K * N, 0)}
    for k, v in time_work(torch, KOPS, REF, sets, work,
                          lambda c: f"internvl2's w_down at {R} rows ({K} -> {N})").items():
        out[k] = {"internvl2 w_down decode": v}
    return out


def mm_step_reading(torch, step):
    """``graph_step_reading`` under inference mode."""
    def run():
        with torch.inference_mode():
            step()
    return graph_step_reading(torch, run)


def encdec_serve(torch, M, dev, seed):
    """Phase 34 (c): seamless at full width and depth, random weights from
    the seed, refused by the engine (JAX's reason); ENCDEC_BATCH rows of
    SyntheticSeq2Seq frames (4,096 each) encoded once by
    ``init_decode_state``, a start token, ENCDEC_NEW greedy tokens by
    ``decode_step``, in int8_switchback (every launch counter exactly the
    encoder's and then the ENCDEC_NEW decoder steps', each zeroed just
    before and read just after its part; tokens equal to the loop's
    with the SwitchBack plain versions swapped in) and bf16 (the attention
    kernels only); a decoder step's device ms and CUDA kernels (a CUDA
    graph of it), the peak."""
    import numpy as np
    from repro_torch.configs.base import ParallelConfig, ServeConfig
    from repro_torch.core.precision import QuantPolicy
    from repro_torch.data import SyntheticSeq2Seq
    from repro_torch.models import build
    from repro_torch.models import encdec as ED
    from repro_torch.models import params as PRM
    from repro_torch.models import transformer as TF
    from repro_torch.serve import make_serve_engine
    cfg = arch_cfg(ENCDEC)
    try:
        make_serve_engine(cfg, ServeConfig(max_batch=ENCDEC_BATCH), device=dev)
        reason = None
    except TF.NoEnginePath as e:
        reason = str(e)
    check(reason is not None and "enc-dec decodes via models/encdec.py" in reason,
          f"seamless: make_serve_engine did not refuse enc-dec ({reason})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = PRM.init_params(build(cfg).param_specs, seed, device=dev)
    data = SyntheticSeq2Seq(cfg.d_model, cfg.vocab_size, seed=seed + 3420)
    frames = torch.from_numpy(data.batch(ENCDEC_BATCH, cfg.frontend_tokens, 1)["frames"]).to(dev)
    start = torch.from_numpy(np.random.default_rng(seed + 3421).integers(
        0, cfg.vocab_size, (ENCDEC_BATCH, 1))).to(dev)
    par = ParallelConfig(remat="none")

    def loop(mode):
        """The tokens, the state, the policy and the launch counts of the
        encode and of the ENCDEC_NEW decoder steps, each read apart."""
        pol, counts = QuantPolicy(mode), {}
        with torch.inference_mode():
            reset_launch_counts(M)
            st = ED.init_decode_state(params, frames, cfg, pol, par, ENCDEC_BATCH,
                                      1 + ENCDEC_NEW)
            counts["encode"] = launch_counts(M)
            reset_launch_counts(M)
            tok, toks = start, []
            for _ in range(ENCDEC_NEW):
                lg, _ = ED.decode_step(params, st, tok, cfg, pol, par)
                tok = torch.argmax(lg[:, -1], -1)[:, None]
                toks.append(tok)
            counts["decode_steps"] = launch_counts(M)
        return torch.cat(toks, 1), st, pol, counts

    res = dict(layers=(cfg.encdec.n_encoder_layers, cfg.n_layers),
               params=sum(t.numel() for t in PRM.tree_leaves(params)))
    for mode in ("int8_switchback", "bf16"):
        t = time.perf_counter()
        toks, st, pol, counts = loop(mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        fused_max = M.KOPS.FUSED_MAX_CONTRACT
        check_launches(counts["encode"], mm_launches(cfg, "encode", fused_max, mode),
                       f"seamless encode ({mode})")
        check_launches(counts["decode_steps"], add_counts(
            (ENCDEC_NEW, mm_launches(cfg, "decode_step", fused_max, mode))),
            f"seamless decode steps ({mode})")
        check(tuple(toks.shape) == (ENCDEC_BATCH, ENCDEC_NEW) and bool((toks >= 0).all())
              and bool((toks < cfg.vocab_size).all()), f"seamless ({mode}): tokens")
        if mode == "int8_switchback":
            with swapped([(M.KOPS, k, getattr(M.REF, k)) for k in SB_KERNELS]):
                plain = loop(mode)[0]
            check(torch.equal(plain, toks), "seamless decode: kernel tokens != plain-version "
                  "tokens")
        tok = toks[:, -1:]
        res[mode] = dict(loop_wall_s=wall, new_tokens=ENCDEC_BATCH * ENCDEC_NEW,
                         tokens_per_s_with_encode=ENCDEC_BATCH * ENCDEC_NEW / wall,
                         counts={run: {k: v for k, v in c.items() if v}
                                 for run, c in counts.items()},
                         **mm_step_reading(torch, lambda: ED.decode_step(
                             params, st, tok, cfg, pol, par)))
        del st
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print("[mm serve] seamless-m4t-large-v2 " + json.dumps(res))
    return res


def mm_train(torch, M, dev, seed, arch):
    """Phase 34 (d): ``arch`` at full width in int8_switchback through
    ``engine_train`` (world 1) with MM_TRAIN_OPTIMIZER's optimizer:
    seamless at full depth on ENCDEC_TRAIN_BATCH x (4,096 frames,
    MM_TRAIN_SEQ targets) of SyntheticSeq2Seq, internvl2 at
    VLM_TRAIN_LAYERS on VLM_TRAIN_BATCH x MM_TRAIN_SEQ BigramLM tokens with
    256 bf16 frontend features a row; launches exactly ``mm_launches``'
    train step's, the peak under MM_PEAK_GIB."""
    import numpy as np
    from repro_torch.data import SyntheticSeq2Seq
    from repro_torch.models.frontends import synthetic_frontend_batch
    n = MM_TRAIN_STEPS + 1
    if arch == ENCDEC:
        cfg = arch_cfg(ENCDEC)
        data = SyntheticSeq2Seq(cfg.d_model, cfg.vocab_size, seed=seed + 3430)
        batches = [{k: torch.from_numpy(v).to(device=dev, dtype=torch.long if v.dtype.kind in
                                             "iu" else None) for k, v in data.batch(
            ENCDEC_TRAIN_BATCH, cfg.frontend_tokens, MM_TRAIN_SEQ).items()} for _ in range(n)]
        tokens = ENCDEC_TRAIN_BATCH * (cfg.frontend_tokens + MM_TRAIN_SEQ)
    else:
        cfg = arch_cfg(VLM, VLM_TRAIN_LAYERS)
        rng = np.random.default_rng(seed + 3431)
        batches = bigram_batches(torch, n, VLM_TRAIN_BATCH, MM_TRAIN_SEQ, dev, seed + 3432)
        for b in batches:
            b["extra_embeds"] = synthetic_frontend_batch(rng, cfg, VLM_TRAIN_BATCH, device=dev)
        tokens = VLM_TRAIN_BATCH * (cfg.frontend_tokens + MM_TRAIN_SEQ)
    want = mm_launches(cfg, "train", M.KOPS.FUSED_MAX_CONTRACT)
    return engine_train(torch, M, dev, seed, cfg, batches, want, MM_PEAK_GIB, "mm train",
                        tokens, MM_TRAIN_OPTIMIZER[arch])


def mm_check_path(torch, arch):
    """Phase 34 (e)'s card-vs-CPU path: ``arch``'s reduced config as it
    stands, int8_switchback, MM_CHECK_BATCH rows of MM_CHECK_SEQ targets
    (seamless: SyntheticSeq2Seq frames; internvl2: BigramLM tokens over its
    512 ids with seeded frontend features); the control fault on the CPU:
    seamless's cross attention fed the decoder's own states, internvl2's
    frontend tokens appended instead of prepended."""
    import numpy as np
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.precision import quant_linear
    from repro_torch.data import BigramLM, SyntheticSeq2Seq
    from repro_torch.models import attention as ATT
    from repro_torch.models import params as PRM
    from repro_torch.models import transformer as TF
    from repro_torch.models.frontends import synthetic_frontend_batch
    cfg = get_reduced_config(arch)

    def batches(n, where, s):
        if arch == ENCDEC:
            data = SyntheticSeq2Seq(cfg.d_model, cfg.vocab_size, seed=s)
            return [{k: torch.from_numpy(v).to(device=where, dtype=torch.long if v.dtype.kind in
                                               "iu" else None) for k, v in data.batch(
                MM_CHECK_BATCH, cfg.frontend_tokens, MM_CHECK_SEQ).items()} for _ in range(n)]
        data, rng = BigramLM(cfg.vocab_size, seed=s, temperature=0.3), np.random.default_rng(s)
        out = []
        for _ in range(n):
            b = {k: torch.from_numpy(v).to(device=where, dtype=torch.long)
                 for k, v in data.batch(MM_CHECK_BATCH, MM_CHECK_SEQ).items()}
            b["extra_embeds"] = synthetic_frontend_batch(rng, cfg, MM_CHECK_BATCH, device=where)
            out.append(b)
        return out

    if arch == ENCDEC:
        cross, encode = ATT.cross_attention, ATT.encode_cross_kv
        fault = {"cross attention fed the decoder (CPU)": control_fault("cpu", lambda: swapped(
            [(ATT, "cross_attention", lambda x, kv, p, c, pol, impl="flash_scan": cross(
                x, encode(x, p, c, pol), p, c, pol, impl=impl))]))}
    else:
        embed = TF.embed_input

        def appended(params, tokens, c, policy, extra_embeds=None):
            x = embed(params, tokens, c, policy)
            if extra_embeds is None:
                return x
            cd = policy.compute_dtype
            fe = quant_linear(extra_embeds.to(cd), PRM.use_weight(
                params["frontend_proj"], ("embed", "embed"), cd), policy=policy)
            return torch.cat([x, fe], dim=1)
        fault = {"frontend appended (CPU)": control_fault(
            "cpu", lambda: swapped([(TF, "embed_input", appended)]))}
    return types.SimpleNamespace(
        tag=f"{arch} card vs cpu", small=cfg, modes=("int8_switchback",),
        seed_offset=47 if arch == VLM else 53, tol=MM_CARD_CPU_TOL[arch], opt={},
        batches=batches, keeps=lambda n, s: None, faults=fault)


def add_mm_launches(kernel_entries, mm, times):
    """Each kernel entry with its launches a phase 34 run's step beside its
    own path's (internvl2's and seamless's decode steps, seamless's encode,
    both train steps, int8_switchback; each counted in its own run), and
    its times at the new shapes."""
    dec_v, dec_s = mm["b"]["int8_switchback"]["counts"], mm["c"]["int8_switchback"]["counts"]
    runs = {"internvl2_decode_step": (dec_v, SSM_STEPS),
            "seamless_decode_step": (dec_s["decode_steps"], ENCDEC_NEW),
            "seamless_encode": (dec_s["encode"], 1),
            "seamless_train_step": (mm["d"][ENCDEC]["counts"], MM_TRAIN_STEPS),
            "internvl2_train_step": (mm["d"][VLM]["counts"], MM_TRAIN_STEPS)}
    for e in kernel_entries:
        e["launches_mm"] = {run: c.get(e["name"], 0) / n for run, (c, n) in runs.items()}
        if e["name"] in times:
            e["at_mm_shapes"] = {k: {x: r[x] for x in ("ms", "plain_ms", "library_ms", "eager_ms",
                                                        "work", "tops", "bound_share",
                                                        "two_step_ms") if x in r}
                                 | {"bound_ms": r["bound"][0]}
                                 for k, r in times[e["name"]].items()}
    return kernel_entries


def mm_phase(torch, M, dev, seed):
    """Phase 34: (a) the kernels at the new shapes against their plain
    versions, and their times; (b) internvl2 served at full width and 8
    layers through the decode_step loop; (c) seamless served at full width
    and depth; (d) both trained at world 1; (e) both reduced configs card
    vs CPU. Each part's seconds."""
    out, secs = timed_parts(torch, "34", (
            ("a", lambda: (mm_kernels(torch, M, dev, seed), time_mm_kernels(torch, M, dev, seed))),
            ("b", lambda: ssm_serve(torch, M, dev, seed, VLM, VLM_SERVE_LAYERS,
                                    mm_launches(arch_cfg(VLM, VLM_SERVE_LAYERS), "decode_step",
                                                M.KOPS.FUSED_MAX_CONTRACT),
                                    80.0, refusal="multimodal frontends are a training-path")),
            ("c", lambda: encdec_serve(torch, M, dev, seed)),
            ("d", lambda: {a: mm_train(torch, M, dev, seed, a) for a in (ENCDEC, VLM)}),
            ("e", lambda: {a: card_vs_cpu(torch, M, mm_check_path(torch, a), dev, seed, steps=2)
                           for a in (VLM, ENCDEC)})))
    out["a"], out["times"] = out["a"]
    print("[timing] multimodal and enc-dec shapes: " + json.dumps(out["times"]))
    out.update(worst=out["a"]["worst"], seconds=secs)
    return out


def mm_report(mm) -> dict:
    """Phase 34's readings without the raw launch counts and times (those go
    to the kernel entries)."""
    def strip(r):
        return {k: (strip(v) if isinstance(v, dict) else v) for k, v in r.items()
                if k != "counts"}
    return {"seconds": mm["seconds"], "b": strip(mm["b"]), "c": strip(mm["c"]),
            "d": strip(mm["d"])}


# ---------------------------------------------------------------------------
# phase 35: the code models granite-20b and starcoder2-3b, on the wide-group
# forms of decode_fwd and the paged template
# ---------------------------------------------------------------------------

GRANITE, STARCODER = "granite-20b", "starcoder2-3b"
CODE_ARCHS = (GRANITE, STARCODER)
# serving through the ServeEngine (ring, and paged in blocks of PAGED_BS):
# granite-20b at full width (d 6,144, 48 query heads over one KV head of
# 128, d_ff 24,576, vocab 49,152) and 8 of its 52 layers (3.64 B
# parameters, 14.5 GB of f32 masters; 52 layers would hold 20.3 B, 81 GB),
# starcoder2-3b at full width and depth (30 x 3,072, 24 heads over 2, d_ff
# 12,288; 3.18 B, 12.7 GB); 8 prompts of CODE_PROMPT tokens, CODE_NEW new,
# greedy, a cache of CODE_MAX_LEN cells a slot
CODE_SERVE_LAYERS = {GRANITE: 8, STARCODER: 30}
CODE_PROMPT, CODE_NEW, CODE_MAX_LEN = 32, 32, 256
# training through the TrainEngine at world 1, int8_switchback, StableAdamW,
# 8 x 256 tokens: StableAdamW's out-of-place update caps one card near 2.5 B
# parameters (PERF.md), so granite at 2 layers (1.36 B) and starcoder2 at
# 12 (1.45 B)
CODE_TRAIN_LAYERS = {GRANITE: 2, STARCODER: 12}
CODE_TRAIN_STEPS = 2
CODE_PEAK_GIB = 70.0
# decode_fwd's checks at the served ring cache: every length 1 .. S_max
# (all slots alike, as they advance together) and this ragged set
CODE_RAGGED = (0, 1, 15, 16, 17, 100, 255, 256)
# the reduced configs on the card (kernels) against the CPU (plain), 2 steps
# of BigramLM 4 x 64 over their 512 ids, phase 11's rule: each limit the
# geometric mean of the worst sound reading and the smallest control-fault
# reading over three seeds on an H100, rounded to one digit. granite: loss
# 6.2e-5 against 2.1e-3, the parameters' mean 1.9e-5 against 4.0e-4 (the
# LayerNorm uncentred); starcoder2: loss 6.4e-5 against 2.3e-2, mean 1.6e-5
# against 1.5e-3 (the KV heads tiled) (PERF.md)
CODE_CHECK_BATCH, CODE_CHECK_SEQ = 4, 64
CODE_CARD_CPU_TOL = {GRANITE: {"loss_rel_err": 4e-4, "param_mean_rel_err": 9e-5},
                     STARCODER: {"loss_rel_err": 1e-3, "param_mean_rel_err": 2e-4}}
# narrow launches: decode_fwd took groups of at most 8 before its wide form,
# the paged decode at most 16
NARROW = {"ring": 8, "paged": 16}


def heads_one_off(o):
    """The wide forms' control fault on an output (B, S, H, hd): the heads
    from 16 on (the row tiles past the first) written one head off."""
    f = o.clone()
    f[:, :, 16:] = o[:, :, 15:-1]
    return f


def narrow_launches(torch, fn, q, k, v, *rest, width):
    """``fn`` (a decode or prefill wrapper taking q (B, S, H, hd) and K/V
    with the KV heads on dim 2) as launches of at most ``width`` query
    heads of one KV head each, stitched back into (B, S, H, hd)."""
    H, KV = q.shape[2], k.shape[2]
    group, parts = H // KV, []
    for h in range(KV):
        kh, vh = k[:, :, h:h + 1].contiguous(), v[:, :, h:h + 1].contiguous()
        for g0 in range(0, group, width):
            heads = slice(h * group + g0, h * group + min(group, g0 + width))
            parts.append(fn(q[:, :, heads].contiguous(), kh, vh, *rest))
    return torch.cat(parts, dim=2)


def compare_wide_decode(torch, M, cfg, dev, seed):
    """``decode_fwd`` at ``cfg``'s query group (hd 128) over a bf16 ring
    cache of CODE_MAX_LEN cells, 8 slots at every length 1 .. S_max and at
    CODE_RAGGED (one slot at kv_len 0), q bf16 and f32: within FLASH_O_TOL
    of max|o| of its plain version; bit for bit the same heads run as
    launches of at most NARROW["ring"] heads; two launches the same bits;
    the control fault (``heads_one_off``) FAULT_MARGIN x outside wherever
    it changes the output (with every slot at length 1 all heads of a KV
    head read the same one value: there the slots crossed stand in).
    Returns the readings."""
    gen = torch.Generator(device=dev).manual_seed(seed + 3501)
    H, KV, hd, S, B = cfg.n_heads, cfg.n_kv_heads, cfg.hd, CODE_MAX_LEN, len(CODE_RAGGED)
    plain = plain_decode(M)
    r = dict(max_abs_err=0.0, max_rel_err=0.0, fault_over_tol=math.inf, comparisons=0)
    k = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(torch.bfloat16)
    for dt in (torch.bfloat16, torch.float32):
        tol = FLASH_O_TOL[str(dt).replace("torch.", "")]
        for lens in [[n] * B for n in range(1, S + 1)] + [list(CODE_RAGGED)]:
            what = f"decode_fwd at {cfg.name}'s H{H}/KV{KV}/hd{hd} S_max{S} lens {lens} q {dt}"
            lens = torch.tensor(lens, dtype=torch.int32, device=dev)
            q = torch.randn((B, 1, H, hd), generator=gen, device=dev).to(dt)
            o = M.FA.decode_attention(q, k, v, lens)
            ro = plain(q, k, v, lens)
            check(o.dtype == ro.dtype and o.shape == ro.shape and bool(torch.isfinite(o).all()),
                  f"{what}: bad output")
            check(torch.equal(o, M.FA.decode_attention(q, k, v, lens)),
                  f"{what}: two launches differ")
            narrow = narrow_launches(torch, M.FA.decode_attention, q, k, v, lens,
                                     width=NARROW["ring"])
            check(torch.equal(narrow, o), f"{what}: the wide launch differs from launches of "
                  f"{NARROW['ring']} heads")
            err = rel_err(torch, o, ro)
            check(err <= tol, f"{what}: kernel vs plain {err:g} > {tol:g}")
            one_value = int(lens.max()) == 1
            fo = plain(q, *slots_crossed(k, v), lens) if one_value else heads_one_off(ro)
            f = rel_err(torch, o, fo) / tol
            check(f >= FAULT_MARGIN, f"{what}: the control fault reads only {f:g} x the "
                  "tolerance")
            r.update(max_abs_err=max(r["max_abs_err"], max_abs_diff(torch, o, ro)),
                     max_rel_err=max(r["max_rel_err"], err),
                     fault_over_tol=min(r["fault_over_tol"], f),
                     comparisons=r["comparisons"] + 1)
    torch.cuda.synchronize()
    return r


def compare_wide_paged(torch, M, cfg, dev, seed):
    """Both paged kernels at ``cfg``'s query group: phase 24's comparisons
    (``compare_paged``: within FLASH_O_TOL, dry slots zero, the rotated
    tables' fault, every prefill row bit-equal to the decode at its
    position); then the decode and a 5-row prefill at served lengths, q bf16
    and f32, bit for bit the same heads run as launches of at most
    NARROW["paged"] heads, and the wide control fault (``heads_one_off``)
    FAULT_MARGIN x outside. Returns the readings."""
    readings, n, rows = compare_paged(torch, M, cfg, dev, seed + 3502)
    gen = torch.Generator(device=dev).manual_seed(seed + 3503)
    k, v, tables = paged_inputs(torch, gen, dev, cfg, 8)
    plain = plain_paged(M)
    kv_len = torch.tensor([0, 1, 15, 16, 17, 300, 1000, 1024], dtype=torch.int32, device=dev)
    t = dead_entries(torch, tables, kv_len)
    q_off = (kv_len - 5).clamp(min=0).to(torch.int32)
    n_narrow = 0
    for dt in (torch.bfloat16, torch.float32):
        tol = FLASH_O_TOL[str(dt).replace("torch.", "")]
        for name, Sq in (("paged_decode_fwd", 1), ("paged_prefill_fwd", 5)):
            q = torch.randn((8, Sq, cfg.n_heads, cfg.hd), generator=gen, device=dev).to(dt)
            if Sq == 1:
                fn, rest = M.PA.paged_decode_attention, (t, kv_len)
                ro = plain["paged_decode_attention"](q, k, v, t, kv_len)
            else:
                fn, rest = M.PA.paged_prefill_attention, (t, q_off, kv_len)
                ro = plain["paged_prefill_attention"](q, k, v, t, q_off, kv_len)
            o = fn(q, k, v, *rest)
            what = f"{name} at {cfg.name}'s group, Sq {Sq}, q {dt}"
            check(torch.equal(narrow_launches(torch, fn, q, k, v, *rest,
                                              width=NARROW["paged"]), o),
                  f"{what}: the wide launch differs from launches of {NARROW['paged']} heads")
            err = rel_err(torch, o, ro)
            check(err <= tol, f"{what}: kernel vs plain {err:g} > {tol:g}")
            f = rel_err(torch, o, heads_one_off(ro)) / tol
            check(f >= FAULT_MARGIN, f"{what}: the wide control fault reads only {f:g} x the "
                  "tolerance")
            readings[name]["wide_fault_over_tol"] = min(
                readings[name].get("wide_fault_over_tol", math.inf), f)
            n_narrow += 1
    torch.cuda.synchronize()
    return dict(readings=readings, comparisons=n + n_narrow, rows_bit_equal=rows,
                narrow_bit_equal=n_narrow)


def narrow_digests(torch, M, dev, seed):
    """SHA-256 of the decode kernels' outputs at the groups they took before
    their wide forms (``decode_fwd`` 1-8, the paged decode 1-16, the paged
    prefill's rows at those groups), hd 64 and 128, q bf16 and f32 over a
    bf16 cache, from fixed seeds: two checkouts whose kernels give these
    groups the same bits print the same digests (``tools/ab_attention.py``
    reads them for an older commit)."""
    import hashlib
    out = {}
    for name in ("decode_fwd", "paged_decode_fwd", "paged_prefill_fwd"):
        h = hashlib.sha256()
        gen = torch.Generator(device=dev).manual_seed(seed + 3504)
        groups = range(1, 9) if name == "decode_fwd" else range(1, 17)
        for group in groups:
            for KV, hd in ((1, 128), (2, 64)):
                for dt in (torch.bfloat16, torch.float32):
                    cfg = types.SimpleNamespace(n_heads=group * KV, n_kv_heads=KV, hd=hd)
                    if name == "decode_fwd":
                        lens = torch.tensor([1, 16, 17, 100, 200, 0], dtype=torch.int32,
                                            device=dev)
                        q = torch.randn((6, 1, group * KV, hd), generator=gen, device=dev)
                        k, v = (torch.randn((6, 200, KV, hd), generator=gen, device=dev)
                                .to(torch.bfloat16) for _ in range(2))
                        o = M.FA.decode_attention(q.to(dt), k, v, lens)
                    else:
                        k, v, tables = paged_inputs(torch, gen, dev, cfg, 4, nb=16)
                        kv_len = torch.tensor([0, 1, 17, 250], dtype=torch.int32, device=dev)
                        t = dead_entries(torch, tables, kv_len)
                        Sq = 1 if name == "paged_decode_fwd" else 3
                        q = torch.randn((4, Sq, group * KV, hd), generator=gen,
                                        device=dev).to(dt)
                        o = (M.PA.paged_decode_attention(q, k, v, t, kv_len) if Sq == 1 else
                             M.PA.paged_prefill_attention(q, k, v, t, (kv_len - 3).clamp(min=0)
                                                          .to(torch.int32), kv_len))
                    h.update(o.float().cpu().numpy().tobytes())
        out[name] = h.hexdigest()
    return out


def code_linear_shapes(granite, star):
    """Phase 35's table for ``compare_linear_kernels``: each model's six
    linears (wq, wk, wv, wo and the GELU MLP's w_up, w_down; every K past
    FUSED_MAX_CONTRACT, so the two-step forms; granite's wk/wv 6,144 -> 128
    one N tile, its w_down K = 24,576; starcoder2's wk/wv 3,072 -> 256) at
    decode's 8 rows (ties), the ring prefill's 8 x 32 rows and the train
    step's 8 x 256 (forward and dgrad); both reduced configs at (e)'s rows,
    bf16 and f32."""
    from repro_torch.configs import get_reduced_config
    bf, both = ("bfloat16",), ("bfloat16", "float32")

    def table(cfg, dx):
        return {f"{K}x{Mw}": (K, Mw, dx) for K, Mw in path_shapes(cfg).values()}
    out = []
    for cfg in (granite, star):
        name = cfg.name.split("-")[0]
        out += [(f"{name} decode", 8, bf, True, False, table(cfg, False)),
                (f"{name} prefill", 8 * CODE_PROMPT, bf, False, False, table(cfg, False)),
                (f"{name} train", TRAIN_ROWS, bf, False, False, table(cfg, True))]
    for arch in CODE_ARCHS:
        out.append((f"{arch} reduced", CODE_CHECK_BATCH * CODE_CHECK_SEQ, both, False, False,
                    table(get_reduced_config(arch), True)))
    return out


def code_flash_cases(granite, star):
    """Phase 35's flash table (``compare_flash_train``'s form): each model's
    causal 8 x 256 training attention (granite 48 query heads over one KV
    head of 128: its fault the causal mask dropped, since a KV-head mix-up
    cannot show with one KV head; starcoder2 24 over 2: the KV heads tiled)
    and both reduced configs' 4 x 64."""
    from repro_torch.configs import get_reduced_config
    rg, rs = get_reduced_config(GRANITE), get_reduced_config(STARCODER)
    S, Sr = TRAIN_SEQ, CODE_CHECK_SEQ
    return [("granite", TRAIN_BATCH, S, S, S, granite.n_heads, 1, granite.hd, True, mask_fault),
            ("starcoder2", TRAIN_BATCH, S, S, S, star.n_heads, star.n_kv_heads, star.hd, True,
             gqa_fault(star.n_heads, star.n_kv_heads)),
            ("granite reduced", CODE_CHECK_BATCH, Sr, Sr, Sr, rg.n_heads, rg.n_kv_heads, rg.hd,
             True, mask_fault),
            ("starcoder2 reduced", CODE_CHECK_BATCH, Sr, Sr, Sr, rs.n_heads, rs.n_kv_heads,
             rs.hd, True, gqa_fault(rs.n_heads, rs.n_kv_heads))]


def code_kernels(torch, M, dev, seed):
    """Phase 35 (a): the SwitchBack kernels at both models' linears
    bit-equal (``code_linear_shapes``), the flash kernels at their training
    shapes (``code_flash_cases``), ``decode_fwd`` (``compare_wide_decode``)
    and the paged kernels (``compare_wide_paged``) at groups 48 and 12, and
    the narrow groups' digests. Returns the readings."""
    granite, star = arch_cfg(GRANITE), arch_cfg(STARCODER)
    sb, n_sb = compare_linear_kernels(torch, M, code_linear_shapes(granite, star), dev,
                                      seed + 3505)
    flash, n_flash = compare_flash_train(torch, M, code_flash_cases(granite, star), dev,
                                         seed + 3506)
    dec = {a: compare_wide_decode(torch, M, c, dev, seed) for a, c in
           ((GRANITE, granite), (STARCODER, star))}
    paged = {a: compare_wide_paged(torch, M, c, dev, seed) for a, c in
             ((GRANITE, granite), (STARCODER, star))}
    digests = narrow_digests(torch, M, dev, seed)
    worst = dict(sb)
    worst.update({k: v["max_abs_err"] for k, v in flash.items()})
    worst["decode_fwd"] = max(d["max_abs_err"] for d in dec.values())
    for k in ("paged_decode_fwd", "paged_prefill_fwd"):
        worst[k] = max(p["readings"][k]["max_abs_err"] for p in paged.values())
    n = (n_sb + n_flash + sum(d["comparisons"] for d in dec.values())
         + sum(p["comparisons"] for p in paged.values()))
    print(f"[kernels] {n_sb} SwitchBack comparisons at granite's and starcoder2's shapes "
          f"bit-equal, twice the same bits; {n_flash} flash comparisons within o "
          f"{json.dumps(FLASH_O_TOL)}, backward {json.dumps(FLASH_BWD_TOL)}, control fault >= "
          f"{FAULT_MARGIN:g}x: " + json.dumps(flash) + "; decode_fwd at groups 48 and 12 "
          f"(bit-equal to launches of {NARROW['ring']} heads): " + json.dumps(dec)
          + f"; the paged kernels at groups 48 and 12 (bit-equal to launches of "
          f"{NARROW['paged']} heads): " + json.dumps(paged) + "; the narrow groups' digests: "
          + json.dumps(digests))
    return dict(worst=worst, flash=flash, decode=dec, paged=paged, digests=digests,
                comparisons=n)


def time_code_kernels(torch, M, dev, seed):
    """Phase 35 (a)'s times, each beside its plain version, SDPA and the
    bound: ``decode_fwd`` at both models' decode step 16 (8 slots of the
    256-cell ring at 48 cells, ``time_decode``); the paged kernels at phase
    24's served shapes with each model's heads (``time_paged``); the flash
    kernels at both training shapes (``time_flash_cases``); ``row_quantize``
    + ``int8_matmul_dequant`` at granite's w_down in a decode step (8 rows,
    24,576 -> 6,144)."""
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed + 3510)
    granite, star = arch_cfg(GRANITE), arch_cfg(STARCODER)
    out = time_flash_cases(torch, M, code_flash_cases(granite, star)[:2], dev, seed + 3511)
    lens = [CODE_PROMPT + CODE_NEW // 2] * 8
    out["decode_fwd"] = {a: time_decode(torch, M, gen, dev, CODE_MAX_LEN, c.n_heads,
                                        c.n_kv_heads, c.hd, lens)
                         for a, c in ((GRANITE, granite), (STARCODER, star))}
    for a, c in ((GRANITE, granite), (STARCODER, star)):
        for case, r in time_paged(torch, M, c, dev, seed + 3512).items():
            name = "paged_decode_fwd" if case == "decode" else "paged_prefill_fwd"
            out.setdefault(name, {})[f"{a} {case}"] = r
    K, N, R = granite.d_ff, granite.d_model, 8
    sets = []
    for _ in range(2):
        w_q, s_w = KOPS.tensor_quantize(weight(torch, gen, K, N, dev))
        x = activations(torch, gen, R, K, dev)
        x_q, s_x = KOPS.row_quantize(x)
        sets.append(dict(x=x, w_q=w_q, x_q=x_q, scale=s_x * REF.div(s_w, 127.0 * 127.0)))

    def int_mm(s):                        # torch._int_mm wants more than 16 rows
        xq = torch.cat([s["x_q"], s["x_q"].new_zeros((32 - R, K))])
        return (torch._int_mm(xq, s["w_q"])[:R].float() * s["scale"]).to(torch.bfloat16)
    check(torch.equal(int_mm(sets[0]), KOPS.int8_matmul_dequant(sets[0]["x_q"], sets[0]["w_q"],
                                                                 sets[0]["scale"])),
          "torch._int_mm yardstick disagrees with int8_matmul_dequant")
    work = {"row_quantize": (1, lambda s, op: op.row_quantize(s["x"]), None,
                             R * K * 2 + R * K + R * 4, 0, 4 * R * K),
            "int8_matmul_dequant": (
                1, lambda s, op: op.int8_matmul_dequant(s["x_q"], s["w_q"], s["scale"]), int_mm,
                R * K + K * N + R * 4 + R * N * 2, 2 * R * K * N, 0)}
    for k, v in time_work(torch, KOPS, REF, sets, work,
                          lambda c: f"granite's w_down at {R} rows ({K} -> {N})").items():
        out[k] = {"granite w_down decode": v}
    return out


def code_generate_launches(cfg, stats, cache, mode, fused_max):
    """Each wrapper's launches of a generate of an LM (``mm_launches``'
    linears at every model call, prefill or decode step: the forward only;
    bf16 none) on the ring (flash_fwd a prefill call, decode_fwd a decode
    step) or the paged cache (the paged kernels), every layer."""
    per_layer = (linear_launches(path_shapes(cfg), fused_max) if mode == "int8_switchback"
                 else {})
    return expected_lm_launches(cfg, per_layer, stats, cache == "paged")


def code_serve(torch, M, dev, seed, arch):
    """Phase 35 (b) and (c): ``arch`` at full width and CODE_SERVE_LAYERS
    layers, random weights from the seed, through the ring and the paged
    ``ServeEngine`` in int8_switchback and bf16: 8 prompts of CODE_PROMPT
    tokens, CODE_NEW greedy new tokens, after a warm-up; every launch
    counter exactly ``code_generate_launches``' (zeroed just before the
    generate, read just after); in int8_switchback the tokens equal to the
    same engine's with the SwitchBack plain versions swapped in (bf16
    launches only the attention kernels, which are not bit-equal to theirs:
    ``code_kernels`` holds them within tolerance); tokens/s, TTFT and ITL,
    a decode step's device ms and CUDA kernels (graph nodes); the peak."""
    import numpy as np
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models import params as PRM
    from repro_torch.serve import make_serve_engine
    cfg = arch_cfg(arch, CODE_SERVE_LAYERS[arch])
    prompts = [np.random.default_rng(seed + 3520 + i).integers(0, cfg.vocab_size,
                                                              CODE_PROMPT).tolist()
               for i in range(8)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, params, fused_max = dict(layers=cfg.n_layers), None, M.KOPS.FUSED_MAX_CONTRACT
    for cache in ("ring", "paged"):
        for mode in ("int8_switchback", "bf16"):
            eng = make_serve_engine(cfg, ServeConfig(
                max_batch=8, max_len=CODE_MAX_LEN, cache_mode=cache, quant_mode=mode,
                block_size=PAGED_BS), device=dev)
            if params is None:
                params = eng.init_params(seed)
                res["params"] = sum(t.numel() for t in PRM.tree_leaves(params))
            eng.generate(params, prompts[:2], max_new_tokens=2)              # warm-up
            torch.cuda.synchronize()
            reset_launch_counts(M)
            gens, stats = eng.generate(params, prompts, max_new_tokens=CODE_NEW)
            counts = launch_counts(M)
            what = f"{arch} serve ({cache}, {mode})"
            check(all(len(g) == CODE_NEW for g in gens) and all(
                0 <= t < cfg.vocab_size for g in gens for t in g), f"{what}: tokens "
                f"{[len(g) for g in gens]}")
            check_launches(counts, code_generate_launches(cfg, stats, cache, mode, fused_max),
                           what)
            if mode == "int8_switchback":
                with swapped([(M.KOPS, k, getattr(M.REF, k)) for k in SB_KERNELS]):
                    plain, _ = eng.generate(params, prompts, max_new_tokens=CODE_NEW)
                check(plain == gens, f"{what}: kernel tokens != plain-version tokens")
            toks = torch.zeros((8, 1), dtype=torch.long, device=dev)
            res[f"{cache} {mode}"] = dict(
                stats={k: stats[k] for k in ("tokens_per_s", "decode_tokens_per_s",
                                             "ttft_p50_s", "ttft_p95_s", "itl_p50_s",
                                             "itl_p95_s", "decode_steps", "prefill_calls",
                                             "new_tokens")},
                counts={k: v for k, v in counts.items() if v},
                plain_versions_swapped_in=mode == "int8_switchback",
                **decode_step_reading(torch, eng, params, toks))
            del eng
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    check(res["peak_memory_gib"] < CODE_PEAK_GIB, f"{arch} serve: peak "
          f"{res['peak_memory_gib']:.2f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[code serve] {arch} " + json.dumps(res))
    return res


def code_train(torch, M, dev, seed, arch):
    """Phase 35 (d): ``arch`` at full width and CODE_TRAIN_LAYERS layers in
    int8_switchback with StableAdamW through ``engine_train`` (world 1) on
    TRAIN_BATCH x TRAIN_SEQ BigramLM tokens, CODE_TRAIN_STEPS steps and a
    profiled one: launches exactly ``mm_launches``' train step's, the
    losses finite, the peak under CODE_PEAK_GIB."""
    cfg = arch_cfg(arch, CODE_TRAIN_LAYERS[arch])
    batches = bigram_batches(torch, CODE_TRAIN_STEPS + 1, TRAIN_BATCH, TRAIN_SEQ, dev,
                             seed + 3530)
    want = mm_launches(cfg, "train", M.KOPS.FUSED_MAX_CONTRACT)
    return engine_train(torch, M, dev, seed, cfg, batches, want, CODE_PEAK_GIB, "code train",
                        TRAIN_BATCH * TRAIN_SEQ)


def layer_norm_uncentred(x, gain, bias=None, eps=1e-5):
    """granite's control fault on the CPU: the LayerNorm's mean left out
    (an RMS norm with a bias), a plausible slip in the one norm these
    models add."""
    import torch
    xf = x.float()
    out = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * gain.float()
    return (out if bias is None else out + bias.float()).to(x.dtype)


def code_check_path(torch, M, arch):
    """Phase 35 (e)'s card-vs-CPU path: ``arch``'s reduced config as it
    stands, int8_switchback, BigramLM batches of CODE_CHECK_BATCH x
    CODE_CHECK_SEQ over its 512 ids; the control fault on the CPU:
    starcoder2's KV heads tiled (``tiled_kv_heads``), granite's LayerNorm
    uncentred (with one KV head the tiling cannot show)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data import BigramLM
    from repro_torch.models import common as COMMON
    cfg = get_reduced_config(arch)

    def batches(n, where, s):
        data = BigramLM(cfg.vocab_size, seed=s, temperature=0.3)
        return [{k: torch.from_numpy(v).to(device=where, dtype=torch.long)
                 for k, v in data.batch(CODE_CHECK_BATCH, CODE_CHECK_SEQ).items()}
                for _ in range(n)]
    if arch == GRANITE:
        fault = {"LayerNorm uncentred (CPU)": control_fault("cpu", lambda: swapped(
            [(COMMON, "layer_norm", layer_norm_uncentred)]))}
    else:
        fault = {"KV heads tiled (CPU)": control_fault("cpu", lambda: tiled_kv_heads(M))}
    return types.SimpleNamespace(
        tag=f"{arch} card vs cpu", small=cfg, modes=("int8_switchback",),
        seed_offset=59 if arch == GRANITE else 61, tol=CODE_CARD_CPU_TOL[arch], opt={},
        batches=batches, keeps=lambda n, s: None, faults=fault)


def add_code_launches(kernel_entries, code, times):
    """Each kernel entry with its launches per model call of phase 35's
    int8_switchback runs (each model's ring and paged generate: per prefill
    call and decode step, as counted; its train step), and its times at the
    new shapes."""
    runs = {}
    for arch in CODE_ARCHS:
        name = arch.split("-")[0]
        for cache in ("ring", "paged"):
            r = code["serve"][arch][f"{cache} int8_switchback"]
            calls = r["stats"]["decode_steps"] + r["stats"]["prefill_calls"]
            runs[f"{name}_{cache}_generate_per_model_call"] = (r["counts"], calls)
        runs[f"{name}_train_step"] = (code["d"][arch]["counts"], CODE_TRAIN_STEPS)
    for e in kernel_entries:
        e["launches_code"] = {run: c.get(e["name"], 0) / n for run, (c, n) in runs.items()}
        if e["name"] in times:
            e["at_code_shapes"] = {k: {x: r[x] for x in ("ms", "plain_ms", "library_ms",
                                                          "gather_ms", "eager_ms", "work",
                                                          "tops", "bound_share", "two_step_ms")
                                       if x in r} | {"bound_ms": r["bound"][0]}
                                   for k, r in times[e["name"]].items()}
    return kernel_entries


def code_phase(torch, M, dev, seed):
    """Phase 35: (a) the kernels at the new shapes against their plain
    versions, and their times; (b) granite-20b served at full width and
    CODE_SERVE_LAYERS layers; (c) starcoder2-3b at full width and depth;
    (d) both trained at world 1; (e) both reduced configs card vs CPU. Each
    part's seconds."""
    out, secs = timed_parts(torch, "35", (
            ("a", lambda: (code_kernels(torch, M, dev, seed),
                           time_code_kernels(torch, M, dev, seed))),
            ("b", lambda: code_serve(torch, M, dev, seed, GRANITE)),
            ("c", lambda: code_serve(torch, M, dev, seed, STARCODER)),
            ("d", lambda: {a: code_train(torch, M, dev, seed, a) for a in CODE_ARCHS}),
            ("e", lambda: {a: card_vs_cpu(torch, M, code_check_path(torch, M, a), dev, seed,
                                          steps=2) for a in CODE_ARCHS})))
    out["a"], out["times"] = out["a"]
    print("[timing] code models' shapes: " + json.dumps(out["times"]))
    out.update(worst=out["a"]["worst"], seconds=secs,
               serve={GRANITE: out["b"], STARCODER: out["c"]})
    return out


def code_report(code) -> dict:
    """Phase 35's readings without the raw launch counts and times (those go
    to the kernel entries)."""
    def strip(r):
        return {k: (strip(v) if isinstance(v, dict) else v) for k, v in r.items()
                if k != "counts"}
    return {"seconds": code["seconds"], "b": strip(code["b"]), "c": strip(code["c"]),
            "d": strip(code["d"]), "digests": code["a"]["digests"]}


def demangled(names) -> list:
    """C++ kernel names as the profiler prints them (``c++filt``)."""
    out = subprocess.run(["c++filt"], input="\n".join(n or "" for n in names),
                         capture_output=True, text=True, check=True).stdout
    return out.splitlines()


def kernel_group(name: str):
    """The TRAIN_KERNEL_GROUPS group a kernel name lands in (the profile's
    rule: the first whose pattern and flag it holds), or None."""
    return next((g for pat, flag, g in TRAIN_KERNEL_GROUPS if pat in name and flag in name),
                None)


def group_probes(torch, M, dev):
    """One call of the wrapper behind each group of PROFILE_GROUPS, at a
    CLIP vision layer's shapes (4,128 x 1,280 -> 1,280)."""
    gen = torch.Generator(device=dev).manual_seed(3211)
    x = torch.randn((4128, 1280), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((1280, 1280), generator=gen, device=dev).to(torch.bfloat16)
    x_q, s_x = M.F8.row_quantize(x, "e4m3")
    w_q, s_w, w_k = M.F8.tensor_quantize_kt(w, "e4m3")
    return {
        "tensor_quantize": lambda: M.KOPS.tensor_quantize(w),
        "row_quantize": lambda: M.KOPS.row_quantize(x),
        "col_quantize": lambda: M.KOPS.col_quantize(w),
        "fp8_tensor_quantize": lambda: M.F8.tensor_quantize_kt(w, "e4m3"),
        "fp8_row_quantize": lambda: M.F8.row_quantize(x, "e4m3"),
        "fp8_block_quantize": lambda: M.F8.block_quantize(x, "e4m3"),
        "fp8_matmul_dequant and _t (one wgmma kernel)": lambda: M.F8.fp8_matmul_dequant(
            x_q, w_q, s_x * s_w, w_k=w_k),
        "fp8_mixed_matmul and _t (one wgmma kernel)": lambda: M.F8.mixed(x, w_q, s_w,
                                                                         w_k=w_k)}


def check_profile_groups(torch, M, dev, mode, probes):
    """Each group a mode's profile reads (PROFILE_GROUPS) holds the kernels
    its wrapper launches: their names, read exactly from the nodes of a
    CUDA graph of one call (``graph_kernels``; torch.profiler's records can
    go missing), land in that group by the profile's own rule. Returns
    {group: the kernel names}."""
    from repro_torch.kernels import build as KBUILD
    out = {}
    for g in PROFILE_GROUPS.get(mode, ()):
        names = demangled(KBUILD.graph_kernels(probes[g]))
        check(names and any(kernel_group(n) == g for n in names),
              f"CLIP {mode}: the profile's group {g!r} matches none of its wrapper's kernels "
              f"{names}")
        out[g] = sorted({n.split("<")[0].split("::")[-1] for n in names
                         if kernel_group(n) == g})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.precision import full_precision_products, product_flags
    from repro_torch.kernels.flash_attention import build as FB
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FREF
    from repro_torch.kernels.fp8_cast import build as FCB
    from repro_torch.kernels.fp8_cast import ops as FC
    from repro_torch.kernels.fp8_matmul import build as F8B
    from repro_torch.kernels.fp8_matmul import ops as F8
    from repro_torch.kernels.fp8_matmul import ref as F8REF
    from repro_torch.kernels.fp8_matmul import wgmma_model as F8TC
    from repro_torch.kernels.paged_attention import build as PAB
    from repro_torch.kernels.paged_attention import ops as PA
    from repro_torch.kernels.paged_attention import ref as PREF
    from repro_torch.kernels.switchback import build as KB
    from repro_torch.kernels.switchback import ops as KOPS
    from repro_torch.kernels.switchback import ref as REF
    from repro_torch.serve import make_serve_engine
    M = types.SimpleNamespace(KOPS=KOPS, REF=REF, FA=FA, FREF=FREF, F8=F8, F8REF=F8REF, F8B=F8B,
                              F8TC=F8TC, PA=PA, PREF=PREF, FC=FC)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # 1. environment
    smi = nvidia_smi_line()
    print(smi)
    # full-precision products, as the JAX package computes them and as the
    # launchers set them: no TF32, and bf16 and f16 GEMMs reduce in f32
    full_precision_products()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}; " + json.dumps(product_flags()))
    check(not any(product_flags().values()), f"product flags left on: {product_flags()}")

    # 2. build: one nvcc per source, started together
    secs = {}

    @contextlib.contextmanager
    def timed(name):
        """Seconds of the phase ``name`` into ``secs``, printed as it ends."""
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        print(f"[time] {name}: {secs[name]:.1f} s", flush=True)

    # phase 22's CPU half needs no kernel: it runs on the cores the
    # compilers leave, while they build
    clip_cfg = get_config("clip-vit-huge")
    fp8_check = clip_check_path(torch, M, clip_cfg, FP8_KERNEL_MODES, tol=CLIP_FP8_CARD_CPU_TOL,
                                tag="clip fp8 card vs cpu", seed_offset=13,
                                faults=CLIP_FP8_FAULTS)
    build_secs = {}

    def timed_build(lib, mod):
        t0 = time.perf_counter()
        out = mod.build()
        build_secs[lib] = time.perf_counter() - t0
        return out

    with timed("2 build, and phase 22's CPU half beside it"):
        libs = (("switchback", KB), ("flash_attention", FB), ("fp8_matmul", F8B),
                ("paged_attention", PAB), ("fp8_cast", FCB))
        with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
            builds = {lib: pool.submit(timed_build, lib, mod) for lib, mod in libs}
            t0 = time.perf_counter()
            fp8_cpu = cpu_half(torch, fp8_check, args.seed)
            secs["22 CPU half"] = time.perf_counter() - t0
            built = {lib: f.result() for lib, f in builds.items()}
        for _, mod in libs:
            mod.load()
    print(f"[time] 22 CPU half: {secs['22 CPU half']:.1f} s; each build (s): "
          + json.dumps({k: round(v, 1) for k, v in build_secs.items()}), flush=True)
    for lib, (lib_path, log) in built.items():
        print(f"[build] {os.path.relpath(lib_path, ROOT)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib}:", line.strip())

    cfg = get_config("smollm-360m")
    # 3. kernels vs plain
    with timed("3 kernels vs plain"):
        worst, n_cmp = compare_kernels(torch, KOPS, REF, cfg, dev, args.seed)
        print(f"[kernels] {n_cmp} SwitchBack comparisons bit-equal; max |kernel - plain| "
              + json.dumps(worst))
        flash_worst, n_flash = compare_flash(torch, M, cfg, dev, args.seed)
        print(f"[kernels] {n_flash} flash comparisons within o {json.dumps(FLASH_O_TOL)} of "
              f"max|o|, lse {FLASH_LSE_TOL:g}; control fault >= {FAULT_MARGIN:g}x the "
              "tolerance: " + json.dumps(flash_worst))
        train_worst, n_train = compare_linear_kernels(torch, M, smollm_train_shapes(cfg), dev,
                                                      args.seed + 13)
        print(f"[kernels] {n_train} train-path SwitchBack comparisons bit-equal and "
              "bit-identical over two launches; max |kernel - plain| " + json.dumps(train_worst))
        bwd_worst, n_bwd = compare_flash_train(torch, M, smollm_flash_cases(cfg), dev,
                                               args.seed + 17)
        print(f"[kernels] {n_bwd} train-path flash comparisons within o "
              f"{json.dumps(FLASH_O_TOL)}, backward {json.dumps(FLASH_BWD_TOL)} of max|grad|, "
              f"bit-identical over two launches; control fault >= {FAULT_MARGIN:g}x the "
              "tolerance: " + json.dumps(bwd_worst))

    # 4. serve (the main path)
    with timed("4-6 serve, whole model, reference"):
        eng, params, prompts, stats, counts = serve(torch, M, cfg, dev, args.seed)
        engines = {"flash_scan": eng, "dense": make_serve_engine(
            "smollm-360m", eng.serve_cfg,
            parallel=ParallelConfig(remat="none", attn_impl="dense"), device=dev)}
        # 5. whole model, kernels vs plain
        whole_model(torch, M, engines, params, prompts)
        # 6. reference
        reference(torch, M, cfg, dev, args.seed)
    # 7. decode profile, the two attention paths in turns on the same card
    with timed("7 decode profile"):
        profs = {"flash_scan": [], "dense": []}
        for impl in ("flash_scan", "dense", "dense", "flash_scan"):
            p, lengths = decode_profile(torch, M, cfg, engines[impl], params, prompts)
            profs[impl].append(p)
            if impl == "flash_scan":
                served_lens = lengths
        prof = profs["flash_scan"][0]
    del eng, engines, params
    torch.cuda.empty_cache()

    # 24. the paged kernels vs plain, and their times
    with timed("24 paged kernels vs plain"):
        paged_worst, n_paged, n_rows = compare_paged(torch, M, cfg, dev, args.seed)
        print(f"[kernels] {n_paged} paged comparisons within o {json.dumps(FLASH_O_TOL)} of "
              f"max|o|, dry slots exact zeros, each bit-identical over two launches; control "
              f"fault (tables rotated) >= {FAULT_MARGIN:g}x the tolerance; {n_rows} prefill "
              "rows bit-equal to the decode kernel at their positions; the mean signed error "
              "of o by q's dtype: " + json.dumps(paged_worst))
        paged_t = time_paged(torch, M, cfg, dev, args.seed)
        print("[timing] paged:", json.dumps(paged_t))
    # 25. paged serve (the paged main path) and its served model kernels vs plain
    with timed("25 paged serve"):
        p_eng, p_params, p_stats, p_counts = paged_serve(torch, M, paged_cfg(), dev,
                                                         args.seed)
        paged_whole_model(torch, M, p_eng, p_params, paged_cfg(), args.seed)
    # 26. the paged features at full width: preemption, n-gram drafts
    with timed("26 paged features"):
        paged_features(torch, M, paged_cfg(), dev, args.seed, p_params)
    # 29. self-healing CLIP training and the flight recorder (serving
    # through phase 25's engine)
    with timed("29 self-healing and the flight recorder"):
        heal = selfheal(torch, M, get_config("clip-vit-huge"), paged_cfg(), dev, args.seed,
                        p_eng, p_params)
    print(smi)
    print("[selfheal] " + json.dumps(heal))
    del p_eng, p_params
    gc.collect()
    torch.cuda.empty_cache()

    # 9. train (the training path): full width through Trainer
    with timed("9 train"):
        trainer, batches, train_counts, train_res = train(torch, M, cfg, dev, args.seed)
    # 10. one train step, kernels vs plain
    with timed("10 whole step"):
        whole_step(torch, M, cfg, dev, args.seed, trainer.state.params, batches[0])
    # 11. card vs CPU, 3 steps at full width and 2 layers
    with timed("11 card vs cpu"):
        card_vs_cpu(torch, M, smollm_check_path(torch, M, cfg), dev, args.seed)
    # 12. train-step profile
    with timed("12 train profile"):
        train_prof = train_profile(torch, M, trainer, batches)
        check_one_kernel_a_call(train_prof, train_res["launches_per_step"], "train profile")
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()

    # 13-17. CLIP ViT-H/14 (the paper's own model) in the four int8 modes
    clip_train_cfg = dataclasses.replace(clip_cfg, vision_layers=CLIP_TRAIN_LAYERS[0],
                                         text_layers=CLIP_TRAIN_LAYERS[1])
    with timed("13-14 CLIP kernels vs plain"):
        clip_worst, n_clip = compare_linear_kernels(torch, M, clip_shapes(clip_cfg), dev,
                                                    args.seed + 23)
        print(f"[kernels] {n_clip} SwitchBack comparisons at CLIP's shapes (every kernel of the "
              "four modes) bit-equal and bit-identical over two launches; max |kernel - plain| "
              + json.dumps(clip_worst))
        edge_worst, n_edge = compare_int8_edges(torch, M, dev, args.seed + 37)
        print(f"[kernels] {n_edge} int8 GEMM comparisons at the wgmma paths' edges "
              f"(int8_matmul_dequant: rows {INT8_EDGE_ROWS} x (K, M) {INT8_EDGE_KM}, all ±127 "
              f"at {INT8_WIDE}; the fused pair: rows {FUSED_EDGE_ROWS} x (K, M) {FUSED_EDGE_KM}, "
              "random and all-zero rows), the four forms and the fused pair bit-equal and "
              "bit-identical over two launches; max |kernel - plain| " + json.dumps(edge_worst))
        quant_worst, n_quant, n_fault = compare_int8_quantizer_edges(torch, M, dev,
                                                                     args.seed + 47)
        print(f"[kernels] {n_quant} int8 quantizer comparisons at the edges (row_quantize: rows "
              f"{INT8_ROW_EDGE_ROWS} x K {INT8_ROW_EDGE_K}; col_quantize: R {INT8_COL_EDGE_R} x C "
              f"{INT8_COL_EDGE_C}; bf16 and f32, offsets {INT8_EDGE_OFFSETS}; ties, all-zero "
              "rows and columns, a lone outlier in the last row; tensor_quantize at every path "
              f"weight {TQ_PATH_SHAPES}, {TQ_SMALL_SHAPES} and the one-launch limit's edges, "
              f"offsets {TQ_OFFSETS}, the absmax first, last, in the last block's span and at "
              "a span's edge, ties, all zero) bit-equal and bit-identical over two launches; "
              f"the control faults (a band's last slab left out; the absmax's block's partial "
              f"left out) caught in {n_fault} of {n_fault} cases; max |kernel - plain| "
              + json.dumps(quant_worst))
        clip_flash, n_clip_flash = compare_flash_train(torch, M, clip_flash_cases(clip_cfg), dev,
                                                       args.seed + 29)
        print(f"[kernels] {n_clip_flash} flash comparisons at CLIP's shapes within o "
              f"{json.dumps(FLASH_O_TOL)}, backward {json.dumps(FLASH_BWD_TOL)}; control fault "
              f">= {FAULT_MARGIN:g}x the tolerance: " + json.dumps(clip_flash))
    with timed("15 CLIP train"):
        clip_res, clip_counts = clip_train(torch, M, clip_train_cfg, dev, args.seed)
    with timed("16 CLIP whole step"):
        clip_whole_step(torch, M, clip_cfg, dev, args.seed)
    with timed("17 CLIP card vs cpu"):
        card_vs_cpu(torch, M, clip_check_path(torch, M, clip_cfg), dev, args.seed)
    torch.cuda.empty_cache()

    # 19-20. CLIP ViT-H/14 in the four fp8 modes, on the fp8 kernels; first
    # the accumulator probe (28), whose widths matmul_bound assumes
    with timed("28 accumulator probe"):
        probe = accumulator_probe(torch, M, dev)
    with timed("19 fp8 kernels vs plain"):
        fp8_worst, fp8_mm, n_fp8 = compare_fp8_kernels(torch, M, clip_shapes(clip_cfg), dev,
                                                       args.seed + 41)
        print(f"[kernels] {n_fp8} fp8 comparisons at CLIP's shapes and 37 x 130 -> 70: "
              "quantizers, tensor_quantize_kt (both copies) and transpose_bytes bit-equal, "
              f"{fp8_mm['w_k_forwards']} forwards given the fold's w_k bit-equal to those "
              "through transpose_bytes, the four matmul forms within "
              "F8REF.matmul_bound (worst share of it by form) and bit-equal to the F8TC model "
              f"at the check rows (control faults >= {FAULT_MARGIN:g} ulps off it, smallest "
              "by form), bit-equal on exact entries, each bit-identical over two launches: "
              + json.dumps(fp8_mm) + "; max |kernel - plain| " + json.dumps(fp8_worst))
        edge_worst8, n_edge8, n_fault8 = compare_fp8_quantizer_edges(torch, M, dev,
                                                                     args.seed + 43)
        for k, v in edge_worst8.items():
            fp8_worst[k] = max(fp8_worst[k], v)
        print(f"[kernels] {n_edge8} fp8 quantizer comparisons at the edges (rows x K "
              f"{FP8_QUANT_EDGES}, tiles {FP8_QUANT_TILES}, bf16 and f32, both formats, aligned "
              "and at an odd offset; ties, ±0, subnormals, all-zero rows and tiles; "
              "tensor_quantize as in phase 13, tensor_quantize_kt there and at "
              f"{KT_EDGE_SHAPES}) bit-equal and bit-identical over two launches, "
              "the conversion equal to grid_round + encode on every f32 (encode_check), the "
              "bf16 division to __fdiv_rn on every pair (divide_check); the tensor quantizers' "
              f"control faults caught in {n_fault8} of {n_fault8} cases; max |kernel - plain| "
              + json.dumps(edge_worst8))
    with timed("20 CLIP fp8 train"):
        fp8_res, fp8_counts = clip_train(torch, M, clip_train_cfg, dev, args.seed,
                                         CLIP_FP8_MODES,
                                         tag="clip fp8 train")
    torch.cuda.empty_cache()

    # 8. timing
    with timed("8 timing"):
        rows = {}
        for R in (PREFILL_ROWS, DECODE_ROWS):
            rows[R] = time_kernels(torch, KOPS, REF, cfg, dev, args.seed, R)
            int8_rates(f"{R} rows", rows[R])
        flash_t = time_flash(torch, M, cfg, dev, args.seed, served_lens)
        print("[timing] flash:", json.dumps(flash_t))
        train_t = time_train_kernels(torch, M, cfg, dev, args.seed)
        int8_rates(f"train, {TRAIN_ROWS} rows", train_t)
    with timed("18 CLIP timing"):
        clip_t = time_clip_kernels(torch, M, clip_cfg, dev, args.seed)
        int8_rates("one CLIP vision layer", clip_t)
    with timed("23 fp8 timing"):
        fp8_t = time_fp8_kernels(torch, M, clip_cfg, dev, args.seed)
    torch.cuda.empty_cache()
    # 27. the op entry points wgrad_bf16 and fp8_cast_tensorwise: the path
    # (counted), its checks, its times
    with timed("27 op entry points"):
        wcases, ccases, tcases, op_counts = drive_op_path(torch, M, cfg, clip_cfg, dev,
                                                          args.seed)
        op_res = compare_op_kernels(torch, M, wcases, ccases, tcases, args.seed)
        del wcases, ccases, tcases
        op_t = time_op_kernels(torch, M, cfg, clip_cfg, dev, args.seed)
    torch.cuda.empty_cache()
    # 21-22. the fp8 whole step, kernels vs plain, and card vs CPU
    with timed("21 CLIP fp8 whole step"):
        clip_whole_step(torch, M, clip_cfg, dev, args.seed, FP8_KERNEL_MODES, CLIP_FP8_STEP_TOL,
                        tag="clip fp8 whole step")
    with timed("22 CLIP fp8 card vs cpu (the card's half)"):
        card_vs_cpu(torch, M, fp8_check, dev, args.seed, cpu_runs=fp8_cpu)
    del fp8_cpu
    torch.cuda.empty_cache()
    # 30. the paper's remaining training options on CLIP at full width: the
    # f16 flash forms, fp16 with loss scaling, fp32, recomputation,
    # AdaFactor and App. C
    with timed("30 training options"):
        opts = training_options(torch, M, clip_cfg, cfg, dev, args.seed)
    torch.cuda.empty_cache()
    # 31. data-parallel and ZeRO-3 training through the TrainEngine on a
    # world-1 NCCL group (CLIP at full width, ENGINE_LAYERS deep)
    with timed("31 sharded engine"):
        sharded_engine(torch, M, clip_cfg, dev, args.seed)
    torch.cuda.empty_cache()
    # 32. the mixture-of-experts family (qwen3-moe-30b-a3b at full width),
    # minitron-8b, fp16/fp32 serving
    with timed("32 moe and serve precisions"):
        moe = moe_phase(torch, M, dev, args.seed)
    torch.cuda.empty_cache()
    # 33. the SSM and hybrid families: rwkv6-1.6b and jamba-v0.1-52b served
    # through the decode_step loop, rwkv6 trained, both reduced card vs CPU
    with timed("33 ssm and hybrid"):
        ssm = ssm_phase(torch, M, dev, args.seed)
    torch.cuda.empty_cache()
    # 34. the multimodal and enc-dec group: internvl2-76b and
    # seamless-m4t-large-v2 served and trained, the kernels at their shapes
    with timed("34 multimodal and enc-dec"):
        mm = mm_phase(torch, M, dev, args.seed)
    torch.cuda.empty_cache()
    # 35. the code models: granite-20b and starcoder2-3b served and trained,
    # the wide-group forms of decode_fwd and the paged template
    with timed("35 code models, wide groups"):
        code = code_phase(torch, M, dev, args.seed)
    calls = stats["decode_steps"] + stats["prefill_calls"]
    per_train_step = train_res["launches_per_step"]
    # each kernel's largest |kernel - plain| over every phase that held it
    readings = (worst, train_worst, clip_worst, edge_worst, quant_worst,
                *({k: v["max_abs_err"] for k, v in d.items()}
                  for d in (flash_worst, bwd_worst, clip_flash, paged_worst)))
    max_err = {k: max(d.get(k, 0.0) for d in readings) for k in SOURCE}
    for k, v in (*ssm["worst"].items(), *mm["worst"].items(), *code["worst"].items()):
        max_err[k] = max(max_err[k], v)

    def entry(name, r, err):
        """A serve-path kernel: ``launches`` from the serve run; its train
        launches beside them."""
        b_ms, b_by = r["bound"]
        return dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
                    launches=counts[name],
                    launches_per_decode_step=prof["launches_per_step"][name],
                    launches_train=train_counts[name],
                    launches_per_train_step=per_train_step[name],
                    max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms,
                    bound_by=b_by, library_ms=r["library_ms"], eager_ms=r["eager_ms"],
                    calls_timed=r["calls"], work=r.get("work"),
                    **{k: r[k] for k in ("tops", "bound_share", "two_step_ms") if k in r})

    def train_entry(name, err):
        """A kernel of the training path only: ``launches`` from the train run."""
        r = train_t[name]
        b_ms, b_by = r["bound"]
        return dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
                    launches=train_counts[name], launches_per_train_step=per_train_step[name],
                    max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms,
                    bound_by=b_by, library_ms=r["library_ms"], eager_ms=r["eager_ms"],
                    calls_timed=r["calls"], work=r["work"],
                    **{k: r[k] for k in ("library", "library_eager_ms", "tops", "bound_share",
                                         "two_step_ms") if k in r})

    def entries(R):
        out = []
        for name, r in rows[R].items():
            e = entry(name, r, max_err[name])
            e.update(rows=R, work=f"one layer's {r['calls']} call(s) at {R} rows")
            if "library_rows" in r:
                e["library_rows"] = r["library_rows"]
            if name == "int8_matmul_dequant":
                e["at_train_shape"] = at_train(name)
            if name in ("fused_switchback_fwd", "row_quantize", "tensor_quantize") and \
                    R == DECODE_ROWS:
                e["at_clip_shapes"] = at_clip(name)
            if name == "tensor_quantize":
                e["library"] = TQ_LIBRARY
            out.append(e)
        return out

    def at_train(name):
        """A forward kernel's reading at the training path's shape (phase 8)."""
        r = train_t[name]
        return {k: r[k] for k in ("ms", "plain_ms", "library_ms", "eager_ms", "work", "tops",
                                  "bound_share") if k in r} | {"bound_ms": r["bound"][0]}

    def at_clip(name):
        """A flash kernel's readings at CLIP's two attention shapes, or the
        fused pair's at each tower's layer (phase 18)."""
        return {t: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "library_eager_ms",
                                      "eager_ms", "two_step_ms", "tops", "bound_share", "work")
                    if k in r}
                | {"bound_ms": r["bound"][0]} for t, r in clip_t[name].items()}

    full = flash_t["decode_fwd_full"]
    flash_entries = [
        dict(entry("flash_fwd", flash_t["flash_fwd"], max_err["flash_fwd"]),
             library="scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
             at_train_shape=at_train("flash_fwd"), at_clip_shapes=at_clip("flash_fwd")),
        dict(entry("decode_fwd", flash_t["decode_fwd_served"], max_err["decode_fwd"]),
             library="scaled_dot_product_attention(attn_mask=key mask, enable_gqa=True)",
             full_window=dict(ms=full["ms"], plain_ms=full["plain_ms"],
                              bound_ms=full["bound"][0], library_ms=full["library_ms"],
                              eager_ms=full["eager_ms"])),
    ]
    print(json.dumps({"kernels_prefill": entries(PREFILL_ROWS)}))
    print("[profile] decode step, flash_scan vs dense (two runs each, in turns): "
          + json.dumps({impl: {key: [p[key] for p in ps] for key in (
              "step_ms", "device_ms_per_step", "device_idle_share", "cuda_launches_per_step")}
              for impl, ps in profs.items()}))
    train_entries = [dict(train_entry("fused_switchback_dgrad", max_err["fused_switchback_dgrad"]),
                          at_clip_shapes=at_clip("fused_switchback_dgrad")),
                     train_entry("int8_matmul_dequant_t", max_err["int8_matmul_dequant_t"])]
    train_entries += [dict(train_entry(k, max_err[k]), at_clip_shapes=at_clip(k))
                      for k in ("flash_bwd_dq", "flash_bwd_dkv")]
    def clip_entry(name):
        """A kernel of the CLIP path only: ``launches`` summed over the four
        modes' timed runs (CLIP_STEPS steps each), per step by mode beside;
        times at the vision layer, with the other towers' beside where they
        were read."""
        towers = "vision" in clip_t[name]
        r = clip_t[name]["vision"] if towers else clip_t[name]
        b_ms, b_by = r["bound"]
        return dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
                    launches=sum(c[name] for c in clip_counts.values()),
                    launches_per_clip_step={m: c[name] / CLIP_STEPS
                                            for m, c in clip_counts.items()},
                    max_abs_err=max_err[name], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=b_ms, bound_by=b_by, library_ms=r["library_ms"],
                    eager_ms=r["eager_ms"], calls_timed=r["calls"], work=r["work"],
                    **({"library": "torch._int_mm + rank-1 scale"} if r["library_ms"] else {}),
                    **({"at_clip_shapes": at_clip(name)} if towers else {}),
                    **{k: r[k] for k in ("tops", "bound_share") if k in r})

    clip_entries = [clip_entry(k) for k in ("col_quantize", "int8_matmul_dequant_colscale",
                                            "int8_matmul_dequant_colscale_t")]

    def fp8_entry(name):
        """An fp8 kernel: ``launches`` summed over the four fp8 modes' timed
        runs (CLIP_STEPS steps each), per step by mode beside; for
        transpose_bytes, an op entry point since the fold, phase 27's run
        (its count on every serve and train run beside, 0). The fp8
        ``tensor_quantize`` entry reads the path's form, the fold
        (tensor_quantize_kt), with the flat form and the pairs beside."""
        r = fp8_t[name]
        b_ms, b_by = r["bound"]
        on_path = sum(c[name] for c in fp8_counts.values())
        op = name == "fp8_transpose_bytes"
        elsewhere = (counts[name] + train_counts[name] + p_counts[name] + on_path
                     + sum(c[name] for c in clip_counts.values())) if op else None
        return dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
                    launches=op_counts[name] if op else on_path,
                    launches_per_clip_step={m: c[name] / CLIP_STEPS
                                            for m, c in fp8_counts.items()},
                    max_abs_err=max(fp8_worst[name], op_res["max_abs_err"].get(name, 0.0)),
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=b_ms, bound_by=b_by, library_ms=r["library_ms"],
                    eager_ms=r["eager_ms"], calls_timed=r["calls"], work=r["work"],
                    **({"library": r["library"]} if r["library"] else {}),
                    **({"launches_serve_train": elsewhere,
                        "part_of": "op entry point on no path: the fp8 forward's K-major W "
                                   "comes from tensor_quantize_kt"} if op else {}),
                    **{k: r[k] for k in ("flat_ms", "pair_ms", "library_pair_ms",
                                         "with_transpose_ms") if k in r},
                    **({"at_shapes": r["at_shapes"]} if "at_shapes" in r else {}),
                    **({"tflops": r["tflops"], "bound_share": r["bound_share"],
                        "matmul_bound_share": fp8_mm["bound_share"][name],
                        "fault_model_ulps": fp8_mm["fault_model_ulps"][name],
                        "acc_bits": {k: v["t"] for k, v in probe.items()}}
                       if name in MATMUL_FORMS else {}))

    fp8_entries = [fp8_entry(k) for k in FP8_KERNELS]
    p_decode = p_stats["decode_steps"] - p_stats["spec_verify_calls"]
    p_calls = p_stats["prefill_calls"] + p_stats["spec_verify_calls"]

    def paged_entry(name, case, per_call):
        """A paged kernel: ``launches`` from the paged serve run (phase 25),
        per decode step or per prefill/verify call beside; times at the
        served shape ``case`` of phase 24, the other cases beside."""
        r = paged_t[case]
        b_ms, b_by = r["bound"]
        others = {c: {k: v[k] for k in ("ms", "plain_ms", "library_ms", "gather_ms")}
                  | {"bound_ms": v["bound"][0]} for c, v in paged_t.items() if c != case
                  and (c == "decode") == (case == "decode")}
        return dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
                    launches=p_counts[name], **per_call,
                    max_abs_err=max_err[name], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                    library_ms=r["library_ms"], gather_ms=r["gather_ms"],
                    library="scaled_dot_product_attention(attn_mask, enable_gqa) over the "
                            "gathered cache; gather_ms the gather", eager_ms=r["eager_ms"],
                    calls_timed=r["calls"], work=r["work"], other_shapes=others)

    def op_entry(name, r, others):
        """An op-entry-point kernel: ``launches`` from phase 27's run of the
        op path; ``launches_serve_train`` over every serve and train run
        (0, checked exactly in each)."""
        b_ms, b_by = r["bound"]
        elsewhere = (counts[name] + train_counts[name] + p_counts[name]
                     + sum(c[name] for c in (*clip_counts.values(), *fp8_counts.values())))
        return dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
                    launches=op_counts[name], launches_serve_train=elsewhere,
                    max_abs_err=op_res["max_abs_err"][name], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=b_ms, bound_by=b_by, library_ms=r["library_ms"],
                    eager_ms=r["eager_ms"], calls_timed=r["calls"], work=r["work"], **others)

    op_entries = [
        op_entry("wgrad_bf16", op_t["clip_vision"], dict(
            library="torch.mm(x.t(), g, out_dtype=torch.float32) (core/switchback.wgrad_16bit)",
            tflops=op_t["clip_vision"]["tflops"],
            wgrad_bound_share=op_res["wgrad_bound_share"],
            fault_wgrad_bound_share=op_res["wgrad_fault_bound_share"],
            other_shapes={"smollm": {k: op_t["smollm"][k] for k in (
                "ms", "plain_ms", "library_ms", "eager_ms", "tflops", "work")}
                | {"bound_ms": op_t["smollm"]["bound"][0]}})),
        op_entry("fp8_cast_tensorwise", op_t["cast"], dict(
            library="none: no single PyTorch call computes it (scale, clip, grid round and "
                    "widening are separate ops; a cast to the fp8 dtype rounds otherwise)",
            other_shapes={k: {kk: v[kk] for kk in ("ms", "plain_ms", "eager_ms")}
                          | {"bound_ms": v["bound"][0]}
                          for k, v in op_t["cast"]["per_shape"].items()}))]
    paged_entries = [
        paged_entry("paged_decode_fwd", "decode",
                    {"launches_per_decode_step": p_counts["paged_decode_fwd"] / max(p_decode, 1)}),
        paged_entry("paged_prefill_fwd", "prefill_chunk",
                    {"launches_per_prefill_or_verify_call":
                     p_counts["paged_prefill_fwd"] / max(p_calls, 1)})]
    print("[clip train] step: " + json.dumps({
        m: {**{k: r[k] for k in ("step_ms", "pairs_per_s", "peak_memory_gib")},
            **{k: r["profile"][k] for k in ("device_ms_per_step", "device_idle_share",
                                            "cuda_launches_per_step")}}
        for m, r in {**clip_res, **fp8_res}.items()}))
    print("[train] step: " + json.dumps({
        "step_ms_trainer": train_res["step_ms"], "tokens_per_s_trainer": train_res["tokens_per_s"],
        **{k: train_prof[k] for k in ("step_ms", "tokens_per_s", "device_ms_per_step",
                                      "device_idle_share", "cuda_launches_per_step")}}))
    print("[time] phases (s): " + json.dumps(secs))
    print("[paged serve] row: " + json.dumps({k: p_stats[k] for k in (
        "tokens_per_s", "decode_tokens_per_s", "ttft_p50_s", "ttft_p95_s", "itl_p50_s",
        "itl_p95_s", "prefix_hit_rate", "prefill_chunks", "prefill_calls", "decode_steps",
        "peak_cache_bytes", "ring_equiv_cache_bytes")}))
    print(f"[done] {calls} model calls on the serve path, "
          f"{len(train_res['losses'])} train steps, {len(CLIP_MODES) + len(CLIP_FP8_MODES)} x "
          f"{1 + CLIP_STEPS} CLIP train steps; total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    def f16_entry(name):
        """A flash kernel's f16 form: ``launches`` from phase 30's FP16 runs
        (both scalers), its error over phase 30 (a), its times at the CLIP
        vision layer with the text layer's beside."""
        times = opts["a"]["times"][name]
        r = times["vision"]
        b_ms, b_by = r["bound"]
        return dict(name=name + "_f16", route="cuda", source=SOURCE[name],
                    replaces=REPLACES[name], launches=opts["f16_counts"][name],
                    launches_per_clip_step=opts["f16_counts"][name]
                    / (FP16_STEPS * len(FP16_SCALERS)),
                    max_abs_err=opts["a"]["worst"][name]["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                    library_ms=r["library_ms"], eager_ms=r["eager_ms"],
                    library=r.get("library", "scaled_dot_product_attention, f16"),
                    calls_timed=r["calls"], work=r["work"],
                    at_clip_shapes={t: {k: v[k] for k in ("ms", "plain_ms", "library_ms", "work")}
                                    | {"bound_ms": v["bound"][0]} for t, v in times.items()})

    f16_entries = [f16_entry(k) for k in F16_KERNELS]

    def batched_entry(name):
        """An expert-batched form: ``launches`` from phase 32's qwen3 runs
        (the ring serve run; the dgrad from the train run), the paged serve
        and train runs beside; its times at decode's C (the dgrad at
        train's), the other C beside."""
        t = moe["times"][name]
        at = "C160" if name == "fused_switchback_dgrad_batched" else "C4"
        r = t[at]
        b_ms, b_by = r["bound"]
        serve_counts = {c: moe["b"][c]["counts"].get(name, 0) for c in ("ring", "paged")}
        train_n = moe["c"]["counts"].get(name, 0)
        return dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
                    launches=train_n if at == "C160" else serve_counts["ring"],
                    launches_serve=serve_counts, launches_train=train_n,
                    launches_per_train_step=train_n / MOE_TRAIN_STEPS,
                    max_abs_err=moe["worst"][name], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    library="none: no single PyTorch call runs a batched int8 GEMM; "
                            "int_mm_loop_ms is a torch._int_mm loop over the experts",
                    calls_timed=r["calls"], work=r["work"],
                    **{k: r[k] for k in ("tops", "bound_share", "int_mm_loop_ms") if k in r},
                    other_shapes={c: {k: v[k] for k in ("ms", "plain_ms", "tops", "bound_share",
                                                         "int_mm_loop_ms") if k in v}
                                  | {"bound_ms": v["bound"][0]} for c, v in t.items() if c != at})

    batched_entries = [batched_entry(k) for k in BATCHED_KERNELS]
    kernel_entries = add_code_launches(add_mm_launches(add_ssm_launches(
        entries(DECODE_ROWS) + flash_entries + train_entries + clip_entries + fp8_entries
        + paged_entries + op_entries + f16_entries + batched_entries, ssm), mm, mm["times"]),
        code, code["times"])
    print("[moe] " + json.dumps({k: moe[k] for k in ("b", "d", "seconds")}))
    print("[ssm] " + json.dumps(ssm_report(ssm)))
    print("[mm] " + json.dumps(mm_report(mm)))
    print("[code] " + json.dumps(code_report(code)))
    print("[training options] " + json.dumps({k: opts[k] for k in ("b", "c", "d", "e", "f",
                                                                    "seconds")}))
    print(json.dumps({"kernels": kernel_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
