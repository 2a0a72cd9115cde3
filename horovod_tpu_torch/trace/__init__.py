"""horovod_tpu_torch.trace: per-request spans.

The port's copy of the replica half of ``horovod_tpu/trace``:

    context.py   the (trace_id, span_id, parent_id) triple minted at
                 admission and carried as one ``"trace"`` JSON field
    spans.py     the span registry (``SPAN_LEGS``) and the bounded
                 per-process ``SpanRecorder`` the batcher records its
                 queue_wait / prefill / decode spans into

``clock.py``, ``collect.py`` and ``writer.py`` serve the fleet's router
and wait for the fleet slice. Stdlib only.
"""
from .context import TraceContext                       # noqa: F401
from .spans import (                                    # noqa: F401
    LEGS, SPAN_LEGS, SPAN_NAMES, Span, SpanRecorder,
    configure_recorder, get_recorder,
)
