"""The KV tier's replica half: the HBM -> host-RAM -> disk eviction
ladder (:mod:`.tier`). A refcount-zero prefix run demotes to a bounded
host-RAM ring, overflows to hvdkv-v1 disk spill files, and promotes back
through the crc-gated, version-fenced ``install_kv_blocks`` path. The
router's fleet index (the reference's ``kvtier/index.py``) waits for the
fleet slice.
"""
from .tier import (DiskTier, HostRing, ReplicaKVTier, TierEntry,
                   read_spill_file, spill_file_name, write_spill_file)

__all__ = [
    "DiskTier",
    "HostRing",
    "ReplicaKVTier",
    "TierEntry",
    "read_spill_file",
    "spill_file_name",
    "write_spill_file",
]
