"""Service binaries: the port's own copies of ``tpu3fs/bin/mgmtd_main.py``,
``storage_main.py`` and ``meta_main.py`` (ref src/mgmtd/mgmtd.cpp,
src/storage/storage.cpp, src/meta/meta.cpp). Each module exposes
``main(argv)`` and a ``*App`` class usable in process, and runs as
``python -m tpu3fs_torch.bin.<name>_main --device cuda ...``. The other
binaries of the JAX package are not ported yet (ROADMAP M6a-2b)."""
