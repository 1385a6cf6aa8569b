"""Tenant identity: who owns a request, end to end.

The port's own copy of ``tpu3fs/tenant/identity.py``,
unchanged but for its imports.

The north star is "heavy traffic from millions of users"; QoS (tpu3fs/qos)
made traffic fair across CLASSES, but one greedy client inside ``fg``
could still starve its peers. This module gives every operation an OWNER
— a compact tenant id — the way the reference attributes work per user
(token-authenticated UserStore identities, per-user metric tags via
``monitor::instanceTagSet``), carried on the same two channels the QoS
class, the trace context and the deadline already ride:

1. IN-PROCESS: a ``contextvars.ContextVar`` (``tenant_scope`` /
   ``current_tenant``). The same machinery that carries the traffic
   class means the tenant follows fanned-out IO for free: WorkerPool
   tasks run inside ``contextvars.copy_context()`` snapshots,
   ``_OverlapForward`` helper threads snapshot their spawning context,
   the prefetcher deliberately DETACHES, and the update worker captures
   the submitter's tenant per job (storage/update_worker.py).
2. ON THE WIRE: a ``u1.<tenant>`` token appended to the request
   envelope's ``message`` field, composing with the trace (``t1.*``) and
   deadline (``d1.*``) tokens — the field every decoder, old or new,
   python or native, already parses and ignores on requests, so the
   encoding is version-tolerant in BOTH directions exactly like
   TraceContext: an old server keeps its trace + deadline and ignores
   the tenant; a new server parses all three.

Wire forms (dot-separated tokens; append order trace, deadline, tenant)::

    u1.<tenant>                              bare tenant
    d1.<micros-hex>.u1.<tenant>              deadline + tenant
    t1.<tid>.<sid>.<flags>.u1.<tenant>       trace + tenant
    t1.<tid>.<sid>.<flags>.d1.<hex>.u1.<tenant>   all three

Tenant names are restricted to ``[a-z0-9_-]`` (1..64 chars): no dots, so
a name can never be confused with a token boundary. An absent/invalid
tenant resolves to ``DEFAULT_TENANT`` ("default") — every dispatch path
resolves SOME tenant (tools/check_rpc_registry.py check 6), so quota
enforcement and per-tenant recorders never see an unowned op.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Optional

#: wire token introducing the tenant field (the tenant name follows)
WIRE_TOKEN = "u1"

#: the owner of untenanted traffic (legacy clients, internal daemons)
DEFAULT_TENANT = "default"

_NAME_RE = re.compile(r"^[a-z0-9_-]{1,64}$")

_tenant_var: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("tpu3fs_tenant", default=None)


def valid_tenant(name: str) -> bool:
    """True iff `name` is a legal tenant id (wire-safe: no dots)."""
    return bool(name) and _NAME_RE.match(name) is not None


# -- context propagation ------------------------------------------------------

def current_tenant() -> Optional[str]:
    """The ambient tenant id, or None when untenanted."""
    return _tenant_var.get()


def resolved_tenant() -> str:
    """The ambient tenant, defaulted: every caller gets an owner."""
    t = _tenant_var.get()
    return t if t else DEFAULT_TENANT


@contextlib.contextmanager
def tenant_scope(tenant: Optional[str]):
    """Arm a tenant id for the block (None/"" = no-op passthrough).
    Unlike deadlines there is no tightening rule: the INNERMOST explicit
    scope wins — a service re-issuing IO on behalf of a client keeps the
    client's tenant simply by not re-scoping. Invalid names raise."""
    if not tenant:
        yield None
        return
    if not valid_tenant(tenant):
        raise ValueError(f"invalid tenant id: {tenant!r}")
    token = _tenant_var.set(tenant)
    try:
        yield tenant
    finally:
        _tenant_var.reset(token)


# -- envelope carriage --------------------------------------------------------

def append_wire(message: str, tenant: Optional[str]) -> str:
    """Append the tenant token to an (optionally empty) envelope message
    already carrying trace and/or deadline tokens. Invalid names are
    dropped rather than corrupting the envelope (belt and braces — the
    scope constructor already refuses them)."""
    if not tenant or not valid_tenant(tenant):
        return message or ""
    tok = f"{WIRE_TOKEN}.{tenant}"
    return f"{message}.{tok}" if message else tok


def decode_tenant(message: str) -> Optional[str]:
    """Parse the tenant off a request envelope message; None for absent,
    malformed or future encodings. Tokens are positional — the scan
    starts after the 4 trace fields when the message is traced, then
    steps over 2-field tokens (``d1``, unknown future tokens) until it
    finds ``u1`` — so a trace/span id that happens to spell 'u1' can
    never be misread as a tenant introducer."""
    if not message or WIRE_TOKEN not in message:
        return None
    parts = message.split(".")
    idx = 4 if parts[0] == "t1" else 0
    while idx + 1 < len(parts):
        if parts[idx] == WIRE_TOKEN:
            name = parts[idx + 1]
            return name if valid_tenant(name) else None
        # any other token (d1 deadline, future extensions) is 2 fields
        idx += 2
    return None
