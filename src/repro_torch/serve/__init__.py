"""Continuously-batched inference on one card: ServeEngine + SlotScheduler
(ring cache). The PyTorch counterpart of ``repro.serve``."""
from repro_torch.serve.engine import (ServeEngine, make_serve_engine,  # noqa: F401
                                      prefill_bucket)
from repro_torch.serve.scheduler import (Request, SlotScheduler,  # noqa: F401
                                         normalize_stop)
