"""The migration job schema (``types``) and the storage node's
retired-target recorder (``service.record_retired_target``): the port's
own copies from ``tpu3fs/migration/``. The migration service is not
ported yet."""
