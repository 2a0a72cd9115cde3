"""horovod_tpu_torch.trace: per-request spans and their assembly.

The port's copy of ``horovod_tpu/trace``:

    context.py   the (trace_id, span_id, parent_id) triple minted at
                 admission and carried as one ``"trace"`` JSON field
    spans.py     the span registry (``SPAN_LEGS``) and the bounded
                 per-process ``SpanRecorder`` the batcher records its
                 queue_wait / prefill / decode spans into
    clock.py     per-worker clock offsets from heartbeat round trips
                 (minimum-delay filter)
    collect.py   the router-side TraceAssembler: leg attribution into
                 hvd_trace_leg_ms{leg,pool}, tail sampling, the
                 flight-recorder incident dump; armed by the process
                 fleet's router from the HOROVOD_TRACE* knobs
    writer.py    the merged clock-aligned Chrome-trace writer (one named
                 pid row per pool / replica / generation)

Stdlib only.
"""
from .context import TraceContext                       # noqa: F401
from .spans import (                                    # noqa: F401
    LEGS, SPAN_LEGS, SPAN_NAMES, Span, SpanRecorder,
    configure_recorder, get_recorder,
)
from .clock import ClockOffsets                         # noqa: F401
from .collect import (                                  # noqa: F401
    TraceAssembler, assembler_from_env, clock_key, leg_decompose,
)
from .writer import ChromeTraceWriter                   # noqa: F401
