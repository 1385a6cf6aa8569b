"""FUSE daemon binary (ref src/fuse/hf3fs_fuse.cpp + FuseClients.h:179-239).

Two-phase boot as a FUSE node: builds the mgmtd/meta/storage client stack
(the reference's FuseClients singleton), a USRBIO agent for 3fs-virt ring
registration, then mounts FuseOps at --mountpoint through libfuse.

The port's own copy of ``tpu3fs/bin/fuse_main.py``. ``FuseApp`` takes a
keyword ``device`` (else ``--device``, default ``cuda``, raising without a
card) and hands it to its ``StorageClient``: the stripe encode (K1 at
k = 12), the parity delta of a partial write (K1 at k = 1), the shard CRCs
(K2) and the degraded decodes (K1, K3) of every file written or read
through the mount run there, in this process. The process's kernel
launches ride its monitor samples to the collector (``kernel.launches``,
tagged by kernel) and are logged at stop. What differs from the JAX
package: a stop also closes the file client's pool and readahead, the
storage client and the shm rings its messenger opened.

    python -m tpu3fs_torch.bin.fuse_main --node-id N --mgmtd HOST:PORT \
        --device cuda --mountpoint /mnt/tpu3fs [--config.collector=H:P]
"""

from __future__ import annotations

import sys
from typing import List, Optional

from tpu3fs_torch import kernels
from tpu3fs_torch.app.application import TwoPhaseApplication
from tpu3fs_torch.client.file_io import FileIoClient
from tpu3fs_torch.client.storage_client import StorageClient
from tpu3fs_torch.fuse.mount import FuseMount
from tpu3fs_torch.fuse.ops import FuseOps
from tpu3fs_torch.mgmtd.types import NodeType
from tpu3fs_torch.rpc.net import RpcServer
from tpu3fs_torch.rpc.services import MetaRpcClient, RpcMessenger
from tpu3fs_torch.usrbio.agent import UsrbioAgent
from tpu3fs_torch.analytics.spans import TraceConfig
from tpu3fs_torch.monitor.flight import FlightConfig
from tpu3fs_torch.utils.config import Config, ConfigItem
from tpu3fs_torch.utils.logging import shutdown_logging, xlog


class FuseAppConfig(Config):
    # observability: distributed tracing + monitor sample push
    # (tpu3fs_torch/analytics/spans.py; both hot-configured)
    trace = TraceConfig
    # flight recorder (monitor/flight.py): bounded in-process black box
    # dumped on SLO breach / fatal signal / admin_cli flight-dump
    flight = FlightConfig
    collector = ConfigItem("", hot=True)   # host:port; "" = off
    monitor_push_period_s = ConfigItem(5.0, hot=True)
    mountpoint = ConfigItem("")
    fsname = ConfigItem("tpu3fs")
    # shared mounts want allow_other, but non-root mounts need
    # user_allow_other in /etc/fuse.conf — so it must be switchable
    allow_other = ConfigItem(False)


class FuseApp(TwoPhaseApplication):
    node_type = NodeType.FUSE

    def __init__(self, argv: Optional[List[str]] = None, *, device=None):
        super().__init__(argv, device=device)
        self.fuse: Optional[FuseMount] = None
        self.ops: Optional[FuseOps] = None
        self._fio: Optional[FileIoClient] = None
        self._messenger: Optional[RpcMessenger] = None
        self._launches = kernels.launch_recorder(
            {"node": str(self.info.node_id)})

    def default_config(self) -> Config:
        return FuseAppConfig()

    def build_services(self, server: RpcServer) -> None:
        routing = self.mgmtd_client.refresh_routing()
        meta_addrs = [
            (n.host, n.port) for n in routing.nodes.values()
            if n.type == NodeType.META and n.port
        ]
        if not meta_addrs:
            raise SystemExit("no meta servers in routing info")
        meta = MetaRpcClient(meta_addrs,
                             client_id=f"fuse-{self.info.node_id}")
        # prefetch on: the mount is this client's single mutation path
        # (its own writes/truncates invalidate), and FUSE readers are the
        # sequential-scan workload readahead exists for
        self._messenger = RpcMessenger(lambda: self.mgmtd_client.routing())
        fio = self._fio = FileIoClient(StorageClient(
            f"fuse-{self.info.node_id}",
            lambda: self.mgmtd_client.routing(),
            self._messenger, device=self.device,
        ), prefetch=True)
        agent = UsrbioAgent(meta, fio, client_id=f"fuse-{self.info.node_id}")
        self.ops = FuseOps(meta, fio, agent)

    def before_start(self) -> None:
        mountpoint = self.flag("mountpoint") or self.config.get("mountpoint")
        if not mountpoint:
            raise SystemExit("--mountpoint is required")
        self.fuse = FuseMount(self.ops, mountpoint,
                              fsname=self.config.get("fsname"),
                              allow_other=self.config.get("allow_other"))
        self.fuse.mount()
        if not self.fuse.wait_mounted():
            raise SystemExit(f"mount at {mountpoint} failed "
                             f"(exit {self.fuse.exit_code})")
        xlog("INFO", "fuse mounted at %s", mountpoint)

    def after_stop(self) -> None:
        if self.fuse is not None:
            self.fuse.unmount()
        if self._fio is not None:
            self._fio.close()
            self._fio.storage.close()
        if self._messenger is not None:
            self._messenger.close_rings()
        xlog("INFO", "fuse kernel launches %s",
             {n: c for n, c in kernels.counts().items() if c})


def main(argv: Optional[List[str]] = None) -> int:
    try:
        FuseApp(argv if argv is not None else sys.argv[1:]).run()
    finally:
        # the log writer is a daemon thread: drain it, or the lines of the
        # stop (the kernel launches) can be lost at exit
        shutdown_logging()
    return 0


if __name__ == "__main__":
    sys.exit(main())
