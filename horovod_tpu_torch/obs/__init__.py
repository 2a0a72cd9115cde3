"""Observability plane of the port: the metrics registry."""
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, get_registry,
)
