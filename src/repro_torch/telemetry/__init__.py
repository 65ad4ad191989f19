from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,  # noqa: F401
                                            MetricsRegistry)
