"""The storage node's hook into the migration service's recorders.

The port's own copy of ``record_retired_target`` and its recorder from
``tpu3fs/migration/service.py``. The chain-to-chain copy service itself
(jobs, workers, the auto re-plan loop) is not ported yet.
"""

from __future__ import annotations

from tpu3fs_torch.monitor.recorder import CounterRecorder

_rec_retired_targets = CounterRecorder("migration.retired_targets")


def record_retired_target(n: int = 1) -> None:
    """Storage-node hook: a target whose routing assignment vanished was
    closed + trash-routed (bin/storage_main.py scan_targets)."""
    _rec_retired_targets.add(n)
