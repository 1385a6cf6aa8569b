"""The cluster a configuration describes, built from the program, and the
reads of its stored state that the comparison needs."""

from __future__ import annotations

import numpy as np


def build(config: dict, device):
    """``tpu3fs_torch``'s in-process cluster at the configuration's shape.
    Raises unless every chain puts each of its k+m shards on its own node."""
    from tpu3fs_torch.fabric.fabric import Fabric, SystemSetupConfig

    fab = Fabric(SystemSetupConfig(
        num_storage_nodes=config["num_storage_nodes"],
        num_chains=config["num_chains"],
        chunk_size=config["chunk_size"],
        ec_k=config["ec_k"], ec_m=config["ec_m"],
        engine=config["engine"]), device=device)
    routing = fab.routing()
    width = config["ec_k"] + config["ec_m"]
    for chain_id in fab.chain_ids:
        chain = routing.chains[chain_id]
        nodes = {routing.node_of_target(chain.target_of_shard(j).target_id)
                 .node_id for j in range(width)}
        if len(nodes) != width:
            raise RuntimeError(f"chain {chain_id} has its {width} shards on "
                               f"{len(nodes)} nodes")
    return fab


def node_of_shard(fab, chain_id: int, j: int) -> int:
    routing = fab.routing()
    t = routing.chains[chain_id].target_of_shard(j)
    return routing.node_of_target(t.target_id).node_id


def stored_shards(fab, chain_id: int, file_id: int, index: int,
                  width: int) -> list:
    """[(committed_ver, pending_ver, length, crc, bytes) or None] of each
    shard of one stripe, read from the engine of the target that holds it."""
    from tpu3fs_torch.storage.types import ChunkId

    routing = fab.routing()
    chain = routing.chains[chain_id]
    cid = ChunkId(file_id, index)
    out = []
    for j in range(width):
        t = chain.target_of_shard(j)
        node = routing.node_of_target(t.target_id)
        target = fab.nodes[node.node_id].service.target(t.target_id)
        meta = target.engine.get_meta(cid) if target is not None else None
        if meta is None:
            out.append(None)
            continue
        data = bytes(target.engine.read(cid))
        out.append((meta.committed_ver, meta.pending_ver, meta.length,
                    meta.checksum.value, data))
    return out


def kernel_launches() -> int:
    from tpu3fs_torch import kernels

    return sum(kernels.counts().values())


def as_rows(bufs, length: int) -> np.ndarray:
    """Byte buffers as rows of ``length`` bytes, zero-padded."""
    out = np.zeros((len(bufs), length), dtype=np.uint8)
    for i, b in enumerate(bufs):
        a = np.frombuffer(b, dtype=np.uint8)[:length]
        out[i, :a.size] = a
    return out
