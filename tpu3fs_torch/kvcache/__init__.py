"""tpu3fs_torch/kvcache — the inference KV-cache serving tier.

The third headline workload of the reference (README.md:17,45-51 — KV
tensors of previous tokens cached in files, ~40 GiB/s cached-KV reads,
GC remove-op IOPS), grown into a serving subsystem:

- ``cache``  — the durable fs tier: sharded entry namespace, striped
  batched gets, BATCHED touch-on-get LRU refresh, and a GC with TTL
  scans + capacity-target LRU eviction (lease-respecting)
- ``tier``   — bounded host-RAM hot tier (LRU) + write-back dirty buffer
  with a background flusher; host hits never touch the wire
- ``blocks`` — content-addressed prefix-block store: KV pages keyed by a
  rolling prefix-hash chain, so shared prompt prefixes dedupe to shared
  fs entries; ``match_prefix`` longest-prefix lookup, device-ready
  ``get_blocks``
- ``leases`` — pin/unpin xattr leases: active decodes are never GC'd
  out from under themselves
- ``layout`` — the shared on-disk formats (shard paths, array codec,
  lease encoding), and pages read under a declared element type
- ``landing`` — the hand-off of pages into a caller's layer-first paged
  pool through reused page-locked staging

All IO rides the ``kvcache`` QoS class (foreground-weighted,
share-bounded). docs/kvcache.md has the contracts; the port writes the
JAX package's entries byte for byte, and ``get_blocks(device="cuda")``
copies blocks to the card (``dtype=torch.bfloat16`` for bfloat16 pages,
``out=`` and ``slots=`` into a pool). The admin CLI's kvcache commands
(``cli.py``) and the GC daemon (``bin/kvcache_gc_main.py``) drive
``KVCacheGC``; the benchmark's cell ``kv-mla-prefix-read`` lands
DeepSeek-V3's MLA pages into a pool on the card (``portbench/``).
"""

from tpu3fs_torch.kvcache.blocks import (  # noqa: F401
    PrefixBlockStore,
    PrefixMatch,
    chain_keys,
)
from tpu3fs_torch.kvcache.cache import KVCacheClient, KVCacheGC  # noqa: F401
from tpu3fs_torch.kvcache.layout import (  # noqa: F401
    decode_array,
    encode_array,
    shard_path,
)
from tpu3fs_torch.kvcache.leases import Lease, LeaseManager  # noqa: F401
from tpu3fs_torch.kvcache.tier import HostTier, TieredKVCache  # noqa: F401

__all__ = [
    "HostTier",
    "KVCacheClient",
    "KVCacheGC",
    "Lease",
    "LeaseManager",
    "PrefixBlockStore",
    "PrefixMatch",
    "TieredKVCache",
    "chain_keys",
    "decode_array",
    "encode_array",
    "shard_path",
]
