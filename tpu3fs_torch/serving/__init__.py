"""Fleet KVCache serving: peer-fill tier over mgmtd-registered endpoints.

A host-tier miss is filled from a PEER's host tier before falling to
storage (docs/serving.md). The package splits along the protocol:

- ``directory``  — gossip-light peer directory over RoutingInfo.serving
  (rendezvous-hashed owner ranking, health-gated selection);
- ``singleflight`` — in-process request coalescing + the cluster
  fill-intent claim table;
- ``service``   — the Serving RPC service (peerRead/fillClaim/
  fillRelease/servingStats/servingLoad), its per-process host, and the
  socket peer client (its shm rings are ROADMAP M6a-3 and raise);
- ``fleet``     — ``FleetKVCache``: the TieredKVCache subclass whose
  miss path runs single-flight -> hedged peer fill -> claimed storage
  fill, with shared-block refcounts and tenant-aware peer admission.
"""

from tpu3fs_torch.serving.directory import PeerDirectory
from tpu3fs_torch.serving.fleet import FleetKVCache
from tpu3fs_torch.serving.service import (
    SERVING_SERVICE_ID,
    ServingHost,
    ServingPeerClient,
    bind_serving_service,
)
from tpu3fs_torch.serving.singleflight import FillClaims, SingleFlight

__all__ = [
    "SERVING_SERVICE_ID",
    "FillClaims",
    "FleetKVCache",
    "PeerDirectory",
    "ServingHost",
    "ServingPeerClient",
    "SingleFlight",
    "bind_serving_service",
]
