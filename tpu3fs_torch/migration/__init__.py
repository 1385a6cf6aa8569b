"""Migration: the job schema (``types``), the chain-to-chain copy service
and the mgmtd-coordinated worker (``service``). The port's own copy of
``tpu3fs/migration``, with the same exports."""

from tpu3fs_torch.migration.service import (
    Job,
    JobState,
    MigrationService,
    MigrationWorker,
)
from tpu3fs_torch.migration.types import JobPhase, MigrationJob, MoveSpec

__all__ = ["Job", "JobState", "MigrationService", "MigrationWorker",
           "JobPhase", "MigrationJob", "MoveSpec"]
