"""Request deadlines, peer health and the record codec (``deadline``,
``health``, ``serde``): the port's own copies of those modules of
``tpu3fs/rpc/``. The RPC transport (``net``, ``services``) is not ported
(ROADMAP M6a)."""
