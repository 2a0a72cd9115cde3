"""horovod_tpu_torch.serve: continuous-batching paged greedy serving.

    queue.py     admission control: bounded queue, deadlines, load shed
    kv_cache.py  paged KV: plain attention functions, BlockPool,
                 PagedKVCache
    prefix.py    radix prefix cache: refcounted shared block runs, CoW
                 at divergence, LRU eviction
    executor.py  the fixed-shape step; paged attention through the CUDA
                 kernel (ops/paged.py) on a card
    batcher.py   iteration-level scheduler over fixed bucket shapes
    http.py      stdlib front end (/generate, /healthz, /metrics)
"""
from .batcher import ContinuousBatcher                         # noqa: F401
from .executor import ShardedExecutor                          # noqa: F401
from .http import make_server, retry_after_seconds, serve_http  # noqa: F401
from .kv_cache import (                                        # noqa: F401
    BlockPool, PagedKVCache, masked_attention, paged_attention,
    paged_model_kwargs, pool_blocks_for, write_kv_paged,
)
from .prefix import RadixPrefixCache                           # noqa: F401
from .queue import (                                           # noqa: F401
    AdmissionQueue, AdmitDropped, Rejected, ServeHandle, ServeRequest,
)
