"""Chaos subsystem: seeded replayable fault schedules, cross-cutting
invariant checkers, and the violation-hunting search loop (docs/chaos.md).

The port's own copy of ``tpu3fs/chaos/``: the search runs the port's
``Fabric`` on a device (the card unless the caller names another), and
its oracle checksums through ``crc32c_many`` there (kernel K2).

Submodules:

- ``schedule``   — event grammar + the seeded generator (recorded,
  exactly-replayable timelines);
- ``invariants`` — the named checker registry asserting the contracts
  the per-subsystem PRs promised piecemeal;
- ``search``     — runs schedules against an in-process fabric, shrinks
  violating schedules to a minimal prefix, reads/writes the
  ``tests/chaos_seeds/`` regression corpus;
- ``bugs``       — the TEST-ONLY planted-bug registry (re-introduce a
  known-fixed bug behind a flag to prove the search still catches it).

The package ``__init__`` stays lazy: ``bugs`` is imported from hot paths
(storage/craq.py) and must not drag the fabric in.
"""

from __future__ import annotations

_LAZY = {
    "ChaosEvent": "tpu3fs_torch.chaos.schedule",
    "Schedule": "tpu3fs_torch.chaos.schedule",
    "ScheduleSpec": "tpu3fs_torch.chaos.schedule",
    "generate_schedule": "tpu3fs_torch.chaos.schedule",
    "Violation": "tpu3fs_torch.chaos.invariants",
    "ChaosContext": "tpu3fs_torch.chaos.invariants",
    "run_checkers": "tpu3fs_torch.chaos.invariants",
    "checker_names": "tpu3fs_torch.chaos.invariants",
    "FabricRunner": "tpu3fs_torch.chaos.search",
    "RunReport": "tpu3fs_torch.chaos.search",
    "search_violations": "tpu3fs_torch.chaos.search",
    "shrink_schedule": "tpu3fs_torch.chaos.search",
    "save_seed": "tpu3fs_torch.chaos.search",
    "replay_seed": "tpu3fs_torch.chaos.search",
    "load_corpus": "tpu3fs_torch.chaos.search",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(mod), name)


__all__ = sorted(_LAZY)
