"""Tenant identity, quotas and per-method enforcement: the port's own
copies of ``tpu3fs/tenant/identity.py``, ``quota.py`` and
``enforcement.py``."""

from tpu3fs_torch.tenant.identity import (  # noqa: F401
    DEFAULT_TENANT,
    current_tenant,
    decode_tenant,
    resolved_tenant,
    tenant_scope,
    valid_tenant,
)
from tpu3fs_torch.tenant.quota import (  # noqa: F401
    TenantConfig,
    TenantQuota,
    TenantRegistry,
    apply_tenant_config,
    registry,
)
