"""horovod_tpu_torch.redist: N->M redistribution of parameter trees.

    plan.py   pure overlap math: Spec (row / full layouts),
              plan_redistribute, split_op, schedule_rounds; the layer
              ckpt/reshard.py consumes

The data planes (``transport.py``, ``core.py``), the elastic consumer
and the training -> serving weight stream (``stream.py``) wait for
``ROADMAP.md`` item 5c.
"""
from .plan import (                                            # noqa: F401
    RedistError, Spec, leaf_nbytes, op_nbytes, plan_redistribute,
    row_bounds, row_nbytes, schedule_rounds, split_op, storage_dtype,
)
