"""migration worker binary (ref src/migration/main.cpp — the job-service
process).

Two-phase boot like every service: registers with mgmtd (CLIENT node
type — the worker serves no data, it IS a client of the data plane),
then loops claiming migration jobs from the mgmtd KV and executing them
(tpu3fs_torch/migration/service.py MigrationWorker). Stateless by design: all
durable job state lives in mgmtd, so N workers share the queue and a
SIGKILLed worker's jobs are re-claimed after its lease lapses — by its
own restart or by any surviving peer.

The port's own copy of ``tpu3fs/bin/migration_main.py``. ``MigrationApp``
takes a keyword ``device`` (else ``--device``, default ``cuda``) like every
app of the port and hands it to the worker's ``StorageClient``. Run it as
``python -m tpu3fs_torch.bin.migration_main --node-id N --mgmtd HOST:PORT
--device cuda``.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from tpu3fs_torch.analytics.spans import TraceConfig
from tpu3fs_torch.app.application import TwoPhaseApplication
from tpu3fs_torch.mgmtd.types import NodeType
from tpu3fs_torch.monitor.flight import FlightConfig
from tpu3fs_torch.qos.core import QosConfig
from tpu3fs_torch.rpc.net import RpcServer
from tpu3fs_torch.tenant.quota import TenantConfig
from tpu3fs_torch.utils.config import Config, ConfigItem
from tpu3fs_torch.utils.fault_injection import FaultPlaneConfig
from tpu3fs_torch.utils.logging import xlog


class MigrationAppConfig(Config):
    poll_interval_s = ConfigItem(0.5, hot=True)
    batch_chunks = ConfigItem(64, hot=True)
    claim_lease_s = ConfigItem(15.0, hot=True)
    max_jobs = ConfigItem(4, hot=True)
    # auto re-plan: when every job settled but draining/dead nodes still
    # host chains (multi-failure chains take one wave per member), the
    # worker submits the next wave itself — drains converge unattended
    auto_replan = ConfigItem(True, hot=True)
    qos = QosConfig
    faults = FaultPlaneConfig
    tenants = TenantConfig
    trace = TraceConfig
    flight = FlightConfig
    collector = ConfigItem("", hot=True)
    monitor_push_period_s = ConfigItem(5.0, hot=True)


class MigrationApp(TwoPhaseApplication):
    node_type = NodeType.CLIENT

    def __init__(self, argv: Optional[List[str]] = None, *, device=None):
        super().__init__(argv, device=device)
        self.worker = None
        self._messenger = None

    def default_config(self) -> Config:
        return MigrationAppConfig()

    def build_services(self, server: RpcServer) -> None:
        pass  # core service only: the worker exposes no data plane

    def before_start(self) -> None:
        from tpu3fs_torch.client.storage_client import StorageClient
        from tpu3fs_torch.migration.service import MigrationWorker
        from tpu3fs_torch.rpc.services import RpcMessenger

        # refresh_routing (not routing): chain mutations the worker itself
        # issues must be visible on its next poll — the bound method gives
        # StorageClient the TTL-invalidation hook and every _routing()
        # call re-polls mgmtd once the worker invalidates
        messenger = self._messenger = RpcMessenger(
            self.mgmtd_client.refresh_routing)
        client = StorageClient(
            f"migration-worker-{self.info.node_id}",
            self.mgmtd_client.refresh_routing, messenger, device=self.device)
        self.worker = MigrationWorker(
            self.mgmtd_client, client,
            worker_id=f"mig-{self.info.node_id}",
            batch_chunks=self.config.get("batch_chunks"),
            lease_s=self.config.get("claim_lease_s"),
            max_jobs=self.config.get("max_jobs"),
            auto_replan=self.config.get("auto_replan"))
        self.spawn(self._work_loop, "migration-work")

    def after_stop(self) -> None:
        if self._messenger is not None:
            self._messenger.close_rings()

    def _work_loop(self) -> None:
        while not self._stop.wait(self.config.get("poll_interval_s")):
            try:
                self.worker._lease_s = self.config.get("claim_lease_s")
                self.worker._batch = self.config.get("batch_chunks")
                self.worker._max_jobs = self.config.get("max_jobs")
                self.worker._auto_replan = self.config.get("auto_replan")
                advanced = self.worker.run_once()
                if advanced:
                    xlog("INFO", "migration worker advanced %d job(s)",
                         advanced)
            except Exception as e:  # a bad round must not kill the loop
                xlog("ERR", "migration round failed: %r", e)


def main(argv: Optional[List[str]] = None) -> int:
    MigrationApp(argv if argv is not None else sys.argv[1:]).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
