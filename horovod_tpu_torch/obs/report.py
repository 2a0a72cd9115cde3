"""Step timing of the port: the copy of ``horovod_tpu/obs/report.py``'s
``step_timer``, which feeds the step-time histogram that per-rank skew
reports rank by."""
from __future__ import annotations

import contextlib
import time
from typing import Optional

from .metrics import MetricsRegistry, get_registry


@contextlib.contextmanager
def step_timer(name: str = "hvd_step_time_ms",
               registry: Optional[MetricsRegistry] = None):
    """Observe the wrapped block's wall time (ms) into the step-time
    histogram. Host-timed: on a GPU, end the block with a synchronize
    (or a readback) to time the device's work rather than its launch."""
    h = (registry or get_registry()).histogram(
        name, "per-step wall time (ms), worker-loop timed")
    t0 = time.perf_counter()
    try:
        yield h
    finally:
        h.observe((time.perf_counter() - t0) * 1000.0)
