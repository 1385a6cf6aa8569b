"""Partitioned metadata plane: the port's own copies of ``tpu3fs/metashard/``,
M stateless meta servers over the shared transactional KV.

- ``partition``: the routing math every party shares — directory-hash
  over the parent path for by-path ops, partition-tagged inode ids for
  by-inode ops.
- ``store``: ``ShardedMetaStore`` — ownership-fenced MetaStore facade
  with per-partition inode allocation and the cross-partition two-phase
  rename/hardlink coordinator.
- ``twophase``: intent records, the prepare/commit protocol and the
  idempotent crash resolver.
"""

from tpu3fs_torch.metashard.partition import (
    DEFAULT_PARTITIONS,
    partition_of_inode,
    partition_of_path,
    partition_tag,
)
from tpu3fs_torch.metashard.store import ShardedMetaStore
from tpu3fs_torch.metashard.twophase import (
    IntentRecord,
    TwoPhaseCoordinator,
    resolve_intents,
)

__all__ = [
    "DEFAULT_PARTITIONS",
    "partition_of_inode",
    "partition_of_path",
    "partition_tag",
    "ShardedMetaStore",
    "IntentRecord",
    "TwoPhaseCoordinator",
    "resolve_intents",
]
