"""Client stub factory — one place that builds service stubs from a
transport choice (the reference's stub/DI layer, src/stubs/: each service
exposes a Stub interface plus factories producing real-RPC or mock
implementations, and consumers take the factory, never a concrete stub).

The port's own copy of ``tpu3fs/client/stubs.py``, with the "tcp" and
"inmem" transports: "native" (the C++ transport, ROADMAP M6a-3) raises
``NotImplementedError``.
Storage and file clients take the keywords of ``StorageClient``, among
them ``device`` (default ``cuda``), where their stripe codec runs.

    stubs = StubFactory(transport="tcp", mgmtd_addr=("host", port))
    meta = stubs.meta_client()
    storage = stubs.storage_client("client-1")
    admin = stubs.mgmtd_admin()

Transports:
  "tcp"    — Python socket transport (rpc.net.RpcClient)
  "inmem"  — no cluster at all: StorageClientInMem + MemKV-backed MetaStore
             (unit-test doubles, ref StorageClientInMem.h / mgmtd mocks)

Every stub built by one factory shares one pooled RPC client, mirroring
the reference sharing one net::Client across stubs.
"""

from __future__ import annotations

from typing import Optional, Tuple

from tpu3fs_torch.utils.result import Code, FsError, Status


class StubFactory:
    def __init__(
        self,
        transport: str = "tcp",
        *,
        mgmtd_addr: Optional[Tuple[str, int]] = None,
        meta_addr: Optional[Tuple[str, int]] = None,
        connect_timeout: float = 5.0,
        call_timeout: float = 30.0,
    ):
        if transport == "native":
            raise NotImplementedError(
                "transport='native' (rpc/native_net.py) is not ported "
                "(ROADMAP M6a-3); use transport='tcp'")
        if transport not in ("tcp", "inmem"):
            raise FsError(Status(Code.INVALID_ARG,
                                 f"unknown transport {transport!r}"))
        self.transport = transport
        self.mgmtd_addr = mgmtd_addr
        self.meta_addr = meta_addr
        self._rpc = None
        self._mgmtd_cli = None
        self._timeouts = (connect_timeout, call_timeout)
        self._inmem_kv = None

    # -- shared plumbing -----------------------------------------------------
    def rpc_client(self):
        """The one pooled connection client every stub shares."""
        if self.transport == "inmem":
            raise FsError(Status(Code.INVALID_ARG,
                                 "inmem stubs have no RPC client"))
        if self._rpc is None:
            from tpu3fs_torch.rpc.net import RpcClient

            self._rpc = RpcClient(*self._timeouts)
        return self._rpc

    def _mgmtd(self):
        if self._mgmtd_cli is None:
            if self.mgmtd_addr is None:
                raise FsError(Status(Code.INVALID_ARG, "mgmtd_addr required"))
            from tpu3fs_torch.rpc.services import MgmtdRpcClient

            self._mgmtd_cli = MgmtdRpcClient(self.mgmtd_addr,
                                             self.rpc_client())
        return self._mgmtd_cli

    # -- stubs ---------------------------------------------------------------
    def mgmtd_client(self):
        """Routing/heartbeat/registration stub."""
        if self.transport == "inmem":
            raise FsError(Status(Code.INVALID_ARG,
                                 "inmem mode has no mgmtd; use the fabric"))
        return self._mgmtd()

    def mgmtd_admin(self):
        from tpu3fs_torch.rpc.services import MgmtdAdminRpcClient

        if self.mgmtd_addr is None:
            raise FsError(Status(Code.INVALID_ARG, "mgmtd_addr required"))
        return MgmtdAdminRpcClient(self.mgmtd_addr, self.rpc_client())

    def storage_client(self, client_id: str = "stub-client", **kw):
        if self.transport == "inmem":
            from tpu3fs_torch.client.inmem import StorageClientInMem

            return StorageClientInMem(client_id)
        from tpu3fs_torch.client.storage_client import StorageClient
        from tpu3fs_torch.rpc.services import RpcMessenger

        mcli = self._mgmtd()
        messenger = RpcMessenger(mcli.refresh_routing, self.rpc_client())
        return StorageClient(client_id, mcli.refresh_routing, messenger,
                             **kw)

    def file_client(self, client_id: str = "stub-client", **kw):
        from tpu3fs_torch.client.file_io import FileIoClient

        return FileIoClient(self.storage_client(client_id, **kw))

    def meta_client(self, token: str = ""):
        if self.transport == "inmem":
            from tpu3fs_torch.kv.mem import MemKVEngine
            from tpu3fs_torch.meta.store import ChainAllocator, MetaStore

            if self._inmem_kv is None:
                self._inmem_kv = MemKVEngine()
            return MetaStore(self._inmem_kv, ChainAllocator(1, [1]))
        from tpu3fs_torch.rpc.services import MetaRpcClient

        if self.meta_addr is None:
            raise FsError(Status(Code.INVALID_ARG, "meta_addr required"))
        return MetaRpcClient([self.meta_addr], self.rpc_client(),
                             token=token)

    def serving_peer_client(self, **kw):
        """Serving peerRead/fillClaim stub (serving/service.py) — shares the
        factory's pooled RPC client like every other stub; pass
        ``usrbio=False`` to force sockets for non-co-located use."""
        if self.transport == "inmem":
            raise FsError(Status(Code.INVALID_ARG,
                                 "inmem mode has no serving peers"))
        from tpu3fs_torch.serving.service import ServingPeerClient

        return ServingPeerClient(self.rpc_client(), **kw)

    def close(self) -> None:
        if self._rpc is not None:
            self._rpc.close()
            self._rpc = None
