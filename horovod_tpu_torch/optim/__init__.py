"""Gradient path of the port: DistributedOptimizer, compression and the
broadcast helpers."""
from .compression import (  # noqa: F401
    Compression, Compressor, FP16Compressor, NoneCompressor,
)
from .functions import (  # noqa: F401
    broadcast_object, broadcast_optimizer_state, broadcast_parameters,
)
from .optimizer import DistributedOptimizer, allreduce_gradients  # noqa: F401
