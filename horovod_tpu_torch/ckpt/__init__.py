"""horovod_tpu_torch.ckpt: the sharded checkpoint plane.

The port of ``horovod_tpu/ckpt/``, reading and writing the same
``hvdckpt-v1`` layout. Every rank writes only its own row-blocks, saves
are async behind one device sync, shards can carry buddy replicas, and a
checkpoint saved on N ranks restores onto M ranks through a
reshard-overlap plan.

    snapshot.py   device -> host snapshot (one pinned buffer, one sync),
                  the tree's flattening and structure record, and the
                  double-buffered async writer
    store.py      per-rank shard files + rank-0 manifest (structure,
                  shapes, shard -> rank chunk map, per-chunk crc32),
                  committed by atomic rename; crc-verified fail-fast load
    reshard.py    the N -> M shard-overlap plan (redist/plan.py) and the
                  one-allgather restore over the native coordinator
    replicate.py  buddy-rank shard mirroring over the p2p ring
                  (HOROVOD_CKPT_REPLICATE)

Entry point: :class:`ShardedCheckpointer`. Knobs:
``HOROVOD_CKPT_SNAPSHOT_DEPTH``, ``HOROVOD_CKPT_REPLICATE``,
``HOROVOD_CKPT_MAX_TO_KEEP``, ``HOROVOD_CKPT_AUTO_RESTORE`` (strict
parsing, ``core/config.py``). Metrics: ``hvd_ckpt_save_ms`` /
``hvd_ckpt_blocking_ms`` / ``hvd_ckpt_restore_ms`` histograms and
``hvd_ckpt_bytes_total{kind}``. The reference's ``checkpoint.py`` (an
orbax manager and ``FileBackedState``) waits for the elastic slice.
"""
from .store import (                                           # noqa: F401
    CkptError, RawLeaf, ShardedCheckpointer, list_steps, load_manifest,
    replica_name, shard_name, step_dir, verify_step,
)
from ..redist.plan import row_bounds                           # noqa: F401
from .snapshot import (                                        # noqa: F401
    AsyncSnapshotWriter, flatten_with_paths, host_snapshot,
)
from .reshard import (                                         # noqa: F401
    plan_reshard, read_block, restore_resharded,
)
from .replicate import exchange_shard                          # noqa: F401
