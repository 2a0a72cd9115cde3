"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

A second package beside the JAX one (which stays the reference), ported
slice by slice:

* paged greedy serving: the serve knobs, the metrics registry, the
  admission queue, the paged KV cache and radix prefix cache, the Llama
  and GPT decode paths, the executor, the continuous batcher, the HTTP
  front end and the paged-attention kernel, written in CUDA C++ for
  Hopper (``ops/csrc/paged_attention.cu``);
* data-parallel training: the hvd surface (``init``, ``size``, ``rank``
  ...), collectives over ``torch.distributed`` (NCCL on the card, gloo
  on the CPU), ``DistributedOptimizer``, the broadcast helpers, the
  ResNet family and ``make_train_step``, whose default loss is the fused
  cross entropy written in CUDA C++ (``ops/csrc/cross_entropy.cu``);
* LM training: the Llama and GPT training paths through the same
  ``make_train_step`` with AdamW, attention through the flash-attention
  kernels written in CUDA C++ (``ops/csrc/flash_attention.cu``:
  forward, dQ and dK/dV);
* the replica's KV integrity and tier planes: the per-block crc ledger,
  the chaos serve sites (``chaos/``), trace spans (``trace/``) and the
  HBM -> host -> disk KV tier (``serve/kvtier/``);
* the in-process serving fleet: ``FleetRouter`` over ``Replica``s with
  accrual failover, at-most-once answers, drain, weight-gated
  re-admission and the cross-replica KV pull (``serve/fleet.py``,
  ``serve/kv_migrate.py``, ``serve/wire.py``), the fleet front door
  ``make_fleet_server``, and the retry ladder (``native/resilience.py``);
* the process fleet: the native KV store built from the repository's
  ``csrc/`` (``native/store.py``), replica worker processes
  (``serve/worker.py``, spawned through ``runner/exec.py``) behind
  ``ProcessFleetRouter`` (``serve/proc_fleet.py``), and the router's
  trace assembly (``trace/collect.py``, ``clock.py``, ``writer.py``);
* the collective surface and the gradient path: process sets (a
  ``torch.distributed`` group each), ``alltoall`` with splits,
  ``reducescatter``, the int8 ``quantized_*`` collectives, Adasum
  (``ops/adasum.py``), the float16 / spar / int8 compressors,
  ``DistributedOptimizer(local_vars=...)`` and ``SyncBatchNorm``;
* the async engine (``ops/engine.py``): fusion, negotiation at world > 1,
  join, the async and grouped surface (``allreduce_async`` ... ``poll``,
  ``synchronize``, ``wait``), ``sparse_allreduce``, ``allreduce(algo=)``
  over ``ops/algo.py`` and ``ops/cross.py``, the heartbeat failure
  detector (``chaos/detector.py``), the straggler report
  (``obs/report.py``) and ``DistributedOptimizer``'s gradient hooks,
  which reduce each gradient bucket while backward runs;
* hybrid parallelism: meshes of ranks (``core/mesh.py``,
  ``parallel/mesh_utils.py``), the in-model collectives
  (``ops/inside.py``), tensor parallelism and partition rules
  (``parallel/tp.py``), FSDP (``parallel/fsdp.py``), ring / zigzag /
  Ulysses sequence parallelism (``parallel/sp.py``, through the flash
  kernels on the card) and ``make_gspmd_train_step``.

Entry points take ``device=None``, which means ``"cuda"`` and raises
when CUDA is absent; ``device="cpu"`` runs the plain PyTorch versions.
The package imports torch, numpy and the stdlib only.
"""
from .core.basics import (                                     # noqa: F401
    add_process_set, ccl_built, cross_rank, cross_size, cuda_built,
    ddl_built, get_config, get_coordinator, get_device, get_engine,
    get_failure_detector, get_hier_mesh, get_mesh, get_process_set,
    get_process_set_ids_and_ranks, gloo_built, gloo_enabled, init,
    is_homogeneous, is_initialized, local_rank, local_size,
    mpi_built, mpi_enabled, mpi_threads_supported, nccl_built,
    process_set_included, rank, remove_process_set, rocm_built, shutdown,
    size, tpu_built, tpu_enabled,
)
from .core.config import Config                                # noqa: F401
from .core.process_sets import ProcessSet, global_process_set  # noqa: F401
from .core.types import (                                      # noqa: F401
    Adasum, Average, DuplicateNameError, HorovodInternalError,
    HostsUpdatedInterrupt, Max, Min, Product, ReduceOp, Request,
    RequestType, Response, Status, StatusType, Sum, TensorShape,
)
from .models import (                                          # noqa: F401
    GPT, GPTConfig, Llama, Llama_1B, LlamaConfig, ResNet, ResNet18,
    ResNet34, ResNet50, ResNet101, ResNet152, gpt_from_flax,
    init_gpt_params, init_llama_params, init_resnet_params,
    llama_from_flax, resnet_from_flax,
)
from .ops.ce import fused_cross_entropy, fused_softmax_cross_entropy  # noqa: F401,E501
from .ops.collective_ops import (                              # noqa: F401
    allgather, allreduce, alltoall, barrier, broadcast, broadcast_, join,
    quantized_allgather, quantized_allreduce, quantized_alltoall,
    quantized_reducescatter, reducescatter,
)
from .ops.engine import (                                      # noqa: F401
    Handle, allgather_async, allreduce_async, alltoall_async,
    broadcast_async, grouped_allgather, grouped_allgather_async,
    grouped_allreduce, grouped_allreduce_async, grouped_reducescatter,
    grouped_reducescatter_async, poll, reducescatter_async, synchronize,
    wait,
)
from .ops.sparse import sparse_allreduce, sparse_allreduce_async  # noqa: F401,E501
from .obs import metrics_report                                # noqa: F401
from .ops.paged import (                                       # noqa: F401
    filtered_probs, paged_attention_fused, resolve_kernel, sample_greedy,
    sample_with_probs, speculative_accept,
)
from .optim import (                                           # noqa: F401
    Compression, DistributedOptimizer, SyncBatchNorm, allgather_object,
    allreduce_gradients, broadcast_object, broadcast_optimizer_state,
    broadcast_parameters, broadcast_variables,
)
from .serve import (                                           # noqa: F401
    AdmissionQueue, AdmitDropped, BlockPool, ContinuousBatcher, DiskTier,
    FleetHandle, FleetRadixIndex, FleetRouter, HostRing, PagedKVCache,
    RadixPrefixCache, Rejected, Replica, ReplicaDead, ReplicaKVTier,
    ServeHandle, ServeRequest, ShardedExecutor, SlotKVCache, TierEntry,
    aggregate_healthz, cached_attention, make_fleet_server, make_server,
    masked_attention, paged_attention, paged_model_kwargs,
    pool_blocks_for, prefer_holders, read_spill_file, serve_http,
    write_kv, write_kv_paged, ProcessFleetRouter, ProcessReplica,
)
from .training import (                                        # noqa: F401
    cross_entropy_loss, fused_cross_entropy_loss, init_replicated,
    make_gspmd_train_step, make_train_step, shard_batch,
)

__version__ = "0.2.0"
