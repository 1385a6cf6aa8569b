"""The RPC layer: the port's own copies of ``tpu3fs/rpc/``'s ``deadline``,
``health``, ``serde``, ``idempotency``, ``net`` (the TCP transport) and
``services`` (the storage, mgmtd, meta and core bindings and their client
stubs) and ``native_net`` (the C++ transport); the messenger's USRBIO
rings live in ``tpu3fs_torch.usrbio``."""
