"""QoS: the traffic classes, admission, weighted-fair scheduling and the
per-service bundle of them (``core``, ``scheduler``, ``manager``): the
port's own copies of ``tpu3fs/qos/``."""

from tpu3fs_torch.qos.core import (
    BACKGROUND_CLASSES,
    SHARE_BOUNDED_CLASSES,
    AdmissionController,
    ConcurrencyGate,
    QosConfig,
    TokenBucket,
    TrafficClass,
    class_from_flags,
    class_to_flags,
    current_class,
    default_class_for,
    format_retry_after,
    infer_write_class,
    retry_after_ms_of,
    tagged,
)
from tpu3fs_torch.qos.manager import QosManager
from tpu3fs_torch.qos.scheduler import WeightedFairQueue, WfqPolicy

__all__ = [
    "AdmissionController",
    "BACKGROUND_CLASSES",
    "ConcurrencyGate",
    "QosConfig",
    "QosManager",
    "SHARE_BOUNDED_CLASSES",
    "TokenBucket",
    "TrafficClass",
    "WeightedFairQueue",
    "WfqPolicy",
    "class_from_flags",
    "class_to_flags",
    "current_class",
    "default_class_for",
    "format_retry_after",
    "infer_write_class",
    "retry_after_ms_of",
    "tagged",
]
