"""Observability plane of the port: the metrics registry (windowed
percentiles, snapshot merge and rendering), the stdlib ``/metrics``
exporter and timeline emitter, and the step timer."""
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, HistogramWindow, MetricsRegistry,
    get_registry, merge_snapshots, percentile_from_buckets,
    snapshot_to_prometheus,
)
from .exporter import (  # noqa: F401
    PROMETHEUS_CONTENT_TYPE, Exporter, TimelineEmitter, make_metrics_server,
    start_exporter, timeline_summary,
)
from .report import build_report, metrics_report, step_timer  # noqa: F401
