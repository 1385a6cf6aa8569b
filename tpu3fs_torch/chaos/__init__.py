"""Planted-bug switches (``bugs``): the port's own copy of
``tpu3fs/chaos/bugs.py``, which the storage tier's hook sites read. The
chaos search, schedules and invariants are not ported."""
