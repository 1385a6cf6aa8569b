"""Service binaries: the port's own copies of ``tpu3fs/bin/mgmtd_main.py``,
``storage_main.py``, ``meta_main.py``, ``kv_main.py``, ``monitor_main.py``
and ``serving_main.py`` (ref src/mgmtd/mgmtd.cpp, src/storage/storage.cpp,
src/meta/meta.cpp, src/monitor_collector/monitor_collector.cpp). Each
module exposes ``main(argv)`` and a ``*App`` class usable in process, and
runs as ``python -m tpu3fs_torch.bin.<name>_main --device cuda ...``. The
other binaries of the JAX package (cli, fuse, migration, the GC and pack
tools) are ROADMAP M6a-3."""
