"""PagedServe host bookkeeping: block pool, block tables, prefix cache.

Copies of the JAX package's ``repro/serve/paged/`` (numpy and typing
only; the port imports nothing of ``repro``). The device side (pool
tensors, paged prefill/decode, the block-table CUDA kernels) lives in
``models/transformer.py`` + ``kernels/paged_attention``; this package is
the pure-Python control plane the engine loop drives (DESIGN.md §10).
"""
from repro_torch.serve.paged.block_pool import (  # noqa: F401
    BlockPool, NoFreeBlocks, PagedCacheManager)
from repro_torch.serve.paged.prefix_cache import RadixPrefixCache  # noqa: F401
