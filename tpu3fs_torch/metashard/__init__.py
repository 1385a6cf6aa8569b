"""Partitioned metadata plane: the port's own copies of
``tpu3fs/metashard/partition.py`` (the routing math every party shares),
``twophase.py`` (intent records, the prepare/commit protocol and the
idempotent crash resolver) and ``metrics.py``. ``store.py``
(``ShardedMetaStore``) is not ported yet (ROADMAP M6a-2b), so a meta
server of the port serves one unpartitioned store."""

from tpu3fs_torch.metashard.partition import (  # noqa: F401
    DEFAULT_PARTITIONS,
    partition_of_inode,
    partition_of_path,
    partition_tag,
)
from tpu3fs_torch.metashard.twophase import (  # noqa: F401
    IntentRecord,
    TwoPhaseCoordinator,
    resolve_intents,
)
