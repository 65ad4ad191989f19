from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointCorruption, CheckpointManager, CheckpointWriteError)
