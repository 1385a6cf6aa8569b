"""The cluster manager (``types``, ``chain_sm``, ``service``): the port's
own copies of those modules of ``tpu3fs/mgmtd/``: routing, heartbeats,
chain and target states."""

from tpu3fs_torch.mgmtd.types import (  # noqa: F401
    ChainInfo,
    ChainTable,
    ChainTarget,
    LeaseInfo,
    LocalTargetState,
    NodeInfo,
    NodeStatus,
    NodeType,
    PublicTargetState,
    RoutingInfo,
    TargetInfo,
)
from tpu3fs_torch.mgmtd.chain_sm import generate_new_chain  # noqa: F401
from tpu3fs_torch.mgmtd.service import Mgmtd, MgmtdConfig  # noqa: F401
