"""The chain membership state machine.

The port's own copy of ``tpu3fs/mgmtd/chain_sm.py``,
unchanged but for its imports.

Re-expresses the public-state transition semantics of
docs/design_notes.md "Failure detection" (table at lines ~211-230) and
src/mgmtd/service/updateChain.cc:25-140 — the same rules, written as a
pass over state groups:

- SERVING targets stay serving while alive; when ALL serving targets die,
  only the first becomes LASTSRV (the chain must wait for the head's data);
  later dead serving targets go OFFLINE.
- A LASTSRV target that comes back (and no serving exists) resumes SERVING —
  it is the single source of truth. If a serving target exists, LASTSRV
  demotes to OFFLINE.
- SYNCING finishes to SERVING when the service reports up-to-date; falls to
  WAITING if there is no serving source; OFFLINE if dead.
- WAITING/OFFLINE targets reporting ONLINE get promoted to SYNCING only when
  a serving source exists and no other target is already syncing (one
  recovery at a time per chain); otherwise alive targets wait. A target in
  WAITING reporting UPTODATE stays WAITING (same as the reference: a target
  may only claim up-to-date after sync-done, so services must report ONLINE
  when returning).
- New chain order groups SERVING, LASTSRV, SYNCING, WAITING, OFFLINE —
  i.e. dead targets rotate to the chain tail.
- The chain version bumps iff membership order or any public state changed.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Tuple

from tpu3fs_torch.mgmtd.types import ChainInfo, ChainTarget, LocalTargetState as LS, PublicTargetState as PS


def _alive(t: ChainTarget) -> bool:
    return t.local_state in (LS.UPTODATE, LS.ONLINE)


def generate_new_chain(targets: List[ChainTarget]) -> List[ChainTarget]:
    """One step of the state machine over a chain's targets (old order in,
    new order out)."""
    by_state = {s: [t for t in targets if t.public_state == s] for s in PS}
    out = {s: [] for s in PS}

    def put(t: ChainTarget, ps: PS):
        out[ps].append(replace(t, public_state=ps))

    for t in by_state[PS.SERVING]:
        if _alive(t):
            put(t, PS.SERVING)
        elif not out[PS.LASTSRV]:
            # all serving died: only the FIRST becomes lastsrv; the chain
            # must wait for it even if later replicas are complete
            put(t, PS.LASTSRV)
        else:
            put(t, PS.OFFLINE)

    for t in by_state[PS.LASTSRV]:
        if out[PS.SERVING]:
            put(t, PS.OFFLINE)
        elif _alive(t):
            put(t, PS.SERVING)
        else:
            put(t, PS.LASTSRV)

    for t in by_state[PS.SYNCING]:
        if t.local_state == LS.UPTODATE:
            put(t, PS.SERVING)
        elif t.local_state == LS.ONLINE:
            put(t, PS.SYNCING if out[PS.SERVING] else PS.WAITING)
        else:
            put(t, PS.OFFLINE)

    for group in (PS.WAITING, PS.OFFLINE):
        for t in by_state[group]:
            if out[PS.SERVING] and not out[PS.SYNCING] and t.local_state == LS.ONLINE:
                put(t, PS.SYNCING)  # start one recovery at a time
            elif _alive(t):
                put(t, PS.WAITING)
            else:
                put(t, PS.OFFLINE)

    # a lastsrv produced this round is void if any serving target remains
    if out[PS.SERVING] and out[PS.LASTSRV]:
        for t in out[PS.LASTSRV]:
            put(t, PS.OFFLINE)
        out[PS.LASTSRV] = []

    new_targets: List[ChainTarget] = []
    for s in (PS.SERVING, PS.LASTSRV, PS.SYNCING, PS.WAITING, PS.OFFLINE):
        new_targets.extend(out[s])
    assert len(new_targets) == len(targets)
    return new_targets


def step_chain(chain: ChainInfo) -> Tuple[ChainInfo, bool]:
    """Apply one state-machine step; bump chain_version iff anything changed."""
    new_targets = generate_new_chain(chain.targets)
    changed = [(t.target_id, t.public_state) for t in chain.targets] != [
        (t.target_id, t.public_state) for t in new_targets
    ]
    if not changed:
        # keep refreshed local states without a version bump
        chain = replace(chain, targets=new_targets)
        return chain, False
    return (
        replace(chain, targets=new_targets, chain_version=chain.chain_version + 1),
        True,
    )
