"""The KV tier, both halves:

* :mod:`.index` — the router's fleet radix index mapping block-granular
  prefix runs to their holders, fed by the replicas' tier events on the
  health sweep; ``prefer_holders`` orders the router's candidates;
* :mod:`.tier` — the replica's HBM -> host-RAM -> disk eviction ladder:
  a refcount-zero prefix run demotes to a bounded host-RAM ring,
  overflows to hvdkv-v1 disk spill files, and promotes back (or is
  pulled by another replica) through the crc-gated, version-fenced
  ``install_kv_blocks`` path.
"""
from .index import FleetRadixIndex, TIERS, prefer_holders
from .tier import (DiskTier, HostRing, ReplicaKVTier, TierEntry,
                   read_spill_file, spill_file_name, write_spill_file)

__all__ = [
    "FleetRadixIndex",
    "TIERS",
    "prefer_holders",
    "DiskTier",
    "HostRing",
    "ReplicaKVTier",
    "TierEntry",
    "read_spill_file",
    "spill_file_name",
    "write_spill_file",
]
