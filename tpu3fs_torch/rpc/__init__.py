"""Request deadlines (``deadline``): the port's own copy of
``tpu3fs/rpc/deadline.py``. The RPC transport and ``serde`` are not
ported."""
