"""Observability for the serving stack, as in ``repro.obs``: deterministic
virtual-clock traces (``trace``), mergeable metrics (``metrics``), stage
hooks (``hooks``) and schema'd benchmark records (``bench``). Stdlib only.
"""
from repro_torch.obs.bench import (SCHEMA_VERSION, bench_record, compare,
                                   format_report, load_bench, metric,
                                   write_bench)
from repro_torch.obs.metrics import (GROWTH, Counter, Gauge, LogHistogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import (Span, Tracer, reconcile_trace,
                                   validate_chrome_trace)

__all__ = [
    "SCHEMA_VERSION", "bench_record", "compare", "format_report",
    "load_bench", "metric", "write_bench",
    "GROWTH", "Counter", "Gauge", "LogHistogram", "MetricsRegistry",
    "Span", "Tracer", "reconcile_trace", "validate_chrome_trace",
]
