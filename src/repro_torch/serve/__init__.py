"""Continuously-batched inference on one card: ServeEngine + SlotScheduler,
the PagedServe block-pool subsystem (``cache_mode="paged"``) and the
n-gram draft proposer for speculative decoding (``spec_mode="ngram"``).
The PyTorch counterpart of ``repro.serve``."""
from repro_torch.serve.engine import (ServeEngine, make_serve_engine,  # noqa: F401
                                      prefill_bucket)
from repro_torch.serve.paged import (BlockPool, NoFreeBlocks,  # noqa: F401
                                     PagedCacheManager, RadixPrefixCache)
from repro_torch.serve.scheduler import (Request, SlotScheduler,  # noqa: F401
                                         normalize_stop)
from repro_torch.serve.spec import NgramProposer  # noqa: F401
