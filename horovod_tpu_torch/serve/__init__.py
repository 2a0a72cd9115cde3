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
                 speculative decoding with a draft executor; the crc
                 ledger, the chaos serve sites and trace spans
    kvtier/      the KV tier: the HBM -> host -> disk eviction ladder
                 with crc-gated, version-fenced promotion, the
                 cross-replica pull, and the router's fleet radix index
    kv_migrate.py  KV blocks packed / crc-verified / installed across
                 replicas (parked rows, pulled runs)
    wire.py      the fleet's framed wire protocol (JSON and binary)
    fleet.py     the in-process fleet: Replica, FleetRouter (accrual
                 failover, at-most-once, drain, weight-gated re-admission,
                 cross-replica KV pull), aggregate_healthz
    http.py      stdlib front ends (/generate, /healthz, /metrics), per
                 replica and for the fleet (/metrics?fleet=1 merges the
                 process fleet's workers)
    worker.py    the replica worker process: ReplicaEndpoint (fid replay
                 dedupe), ReplicaWorker (KV-store heartbeats, serve.proc
                 SIGKILL, SIGTERM drain), tiny_gpt_builder, llama_builder
    proc_fleet.py  the process fleet: ProcessReplica, ProcessFleetRouter
                 (laddered dispatch, accrual ejection over heartbeat
                 keys, exactly-once re-queue, respawn, scale up / down)
"""
from .batcher import ContinuousBatcher, ReplicaDead            # noqa: F401
from .executor import ShardedExecutor                          # noqa: F401
from .fleet import (                                           # noqa: F401
    FleetHandle, FleetRouter, Replica, aggregate_healthz,
)
from .http import (                                            # noqa: F401
    make_fleet_server, make_server, retry_after_seconds, serve_http,
)
from .kv_cache import (                                        # noqa: F401
    BlockPool, PagedKVCache, SlotKVCache, cached_attention,
    masked_attention, paged_attention, paged_model_kwargs, pool_blocks_for,
    write_kv, write_kv_paged,
)
from .kvtier import (                                          # noqa: F401
    DiskTier, FleetRadixIndex, HostRing, ReplicaKVTier, TierEntry,
    prefer_holders, read_spill_file,
)
from .prefix import RadixPrefixCache                           # noqa: F401
from .proc_fleet import ProcessFleetRouter, ProcessReplica     # noqa: F401
from .queue import (                                           # noqa: F401
    AdmissionQueue, AdmitDropped, Rejected, ServeHandle, ServeRequest,
)
