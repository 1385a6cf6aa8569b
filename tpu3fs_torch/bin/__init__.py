"""Service binaries: the port's own copies of ``tpu3fs/bin/mgmtd_main.py``,
``storage_main.py``, ``meta_main.py``, ``kv_main.py``, ``monitor_main.py``,
``serving_main.py``, ``fuse_main.py`` and ``migration_main.py`` (ref
src/mgmtd/mgmtd.cpp, src/storage/storage.cpp, src/meta/meta.cpp,
src/monitor_collector/monitor_collector.cpp, src/fuse/hf3fs_fuse.cpp,
src/migration/main.cpp), and of the operator's tools ``ckpt_gc_main.py``,
``dataload_pack_main.py`` and ``kvcache_gc_main.py``. Each service module
exposes ``main(argv)`` and a ``*App`` class usable in process, and runs as
``python -m tpu3fs_torch.bin.<name>_main --device cuda ...``; each tool
runs as ``python -m tpu3fs_torch.bin.<name>_main --connect HOST:PORT
--device cuda ...``. The admin CLI is ``python -m tpu3fs_torch.cli``."""
