"""horovod_tpu_torch.serve: continuous-batching serving, greedy, sampled
and speculative.

    queue.py     admission control: bounded queue, deadlines, load shed,
                 per-request temperature / top_p / seed
    kv_cache.py  KV storage: plain attention functions, slotted rows
                 (write_kv, cached_attention, SlotKVCache) and paged
                 blocks (BlockPool, PagedKVCache)
    prefix.py    radix prefix cache: refcounted shared block runs, CoW
                 at divergence, LRU eviction
    executor.py  the fixed-shape step (prefill / decode / verify) with
                 on-device sampling; paged attention through the CUDA
                 kernel (ops/paged.py) on a card; role="draft" drafters
    batcher.py   iteration-level scheduler over fixed bucket shapes,
                 speculative decoding with a draft executor
    http.py      stdlib front end (/generate, /healthz, /metrics)
"""
from .batcher import ContinuousBatcher                         # noqa: F401
from .executor import ShardedExecutor                          # noqa: F401
from .http import make_server, retry_after_seconds, serve_http  # noqa: F401
from .kv_cache import (                                        # noqa: F401
    BlockPool, PagedKVCache, SlotKVCache, cached_attention,
    masked_attention, paged_attention, paged_model_kwargs, pool_blocks_for,
    write_kv, write_kv_paged,
)
from .prefix import RadixPrefixCache                           # noqa: F401
from .queue import (                                           # noqa: F401
    AdmissionQueue, AdmitDropped, Rejected, ServeHandle, ServeRequest,
)
