"""horovod_tpu_torch.redist: N->M redistribution of parameter trees.

    plan.py       pure overlap math: Spec (row / full layouts),
                  plan_redistribute, split_op, schedule_rounds; the
                  layer ckpt/reshard.py consumes
    transport.py  interchangeable data planes: p2p ring alltoall,
                  coordinator allgather, disk-backed ckpt (fallback);
                  chaos fault site ``redist.transport``
    stream.py     training -> serving hot weight streaming
                  (``hvdws-v1``): versioned publisher / subscriber over
                  the native KV, monotone adoption, the serve fleets'
                  hot swap between decode iterations

``redistribute`` (the reference's ``core.py``) and its elastic consumer
wait for ``ROADMAP.md`` item 8.
"""
from .plan import (                                            # noqa: F401
    RedistError, Spec, leaf_nbytes, op_nbytes, plan_redistribute,
    row_bounds, row_nbytes, schedule_rounds, split_op, storage_dtype,
)
from .transport import (                                       # noqa: F401
    BaseTransport, CkptTransport, CoordTransport, RingTransport,
    chaos_gate,
)
from .stream import (                                          # noqa: F401
    WeightPublisher, WeightSubscriber, version_key,
)
