"""Observability plane of the port: the metrics registry and the step
timer."""
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, get_registry,
)
from .report import step_timer  # noqa: F401
