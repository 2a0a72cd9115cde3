"""Gradient path of the port: DistributedOptimizer, compression,
SyncBatchNorm and the broadcast / gather helpers."""
from .compression import (  # noqa: F401
    BlockQuantCompressor, Compression, Compressor, FP16Compressor,
    Float16Compressor, NoneCompressor, SparCompressor, WIRE_FORMATS,
    block_dequantize, block_quantize, wire_bytes, wire_format_of,
)
from .functions import (  # noqa: F401
    allgather_object, broadcast_object, broadcast_optimizer_state,
    broadcast_parameters, broadcast_variables,
)
from .optimizer import DistributedOptimizer, allreduce_gradients  # noqa: F401
from .sync_batch_norm import SyncBatchNorm  # noqa: F401
