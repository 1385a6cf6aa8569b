"""The KV engine a service binary's ``--kv`` flag names.

The port's own copy of ``engine_from_flag`` from ``tpu3fs/kv/remote.py``.
An empty flag gives the in-memory engine, as in the JAX package. The
network engines (``RemoteKVEngine`` over the kvd service,
``ReplicatedRemoteKVEngine`` over a kvd group), ``kv/service.py``,
``kv/replica.py`` and ``bin/kv_main.py`` are not ported yet (ROADMAP
M6a-2b), so a non-empty flag raises ``NotImplementedError``.
"""

from __future__ import annotations


def engine_from_flag(kv_flag: str):
    """'' -> local MemKVEngine (dev); 'host:port' or a kvd group -> the
    network engines, not ported yet."""
    if not kv_flag:
        from tpu3fs_torch.kv.mem import MemKVEngine

        return MemKVEngine()
    raise NotImplementedError(
        f"--kv {kv_flag!r}: the network KV engines (kv/remote.py, "
        "kv/service.py, kv/replica.py, bin/kv_main.py) are not ported "
        "(ROADMAP M6a-2b); leave --kv empty for the in-memory engine")
