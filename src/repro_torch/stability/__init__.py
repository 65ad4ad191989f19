"""Training stability monitors (copies of ``repro/stability``)."""
from repro_torch.stability.feature_stats import (  # noqa: F401
    block_feature_magnitude, gradient_stats)
from repro_torch.stability.rms_monitor import RMS_SPIKE_THRESHOLD, RMSMonitor  # noqa: F401
from repro_torch.stability.spike_detector import LossSpikeDetector  # noqa: F401
