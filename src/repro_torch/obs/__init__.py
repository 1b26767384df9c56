"""Stage hooks and mergeable metrics (stdlib only), as in ``repro.obs``."""
from repro_torch.obs.metrics import (GROWTH, Counter, Gauge, LogHistogram,
                                     MetricsRegistry)

__all__ = ["GROWTH", "Counter", "Gauge", "LogHistogram", "MetricsRegistry"]
