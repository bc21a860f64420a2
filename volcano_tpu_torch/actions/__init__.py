"""The action pass pipeline (reference: pkg/scheduler/actions/factory.go:31-39;
the port of ``volcano_tpu/actions``).

Each action is a thin host-side wrapper around a pass; the Session holds
the state they mutate. The conf's ``actions`` list gives the order, as in
the reference scheduler loop (pkg/scheduler/scheduler.go:105)::

    for name in conf.actions:
        get_action(name).execute(ssn)

Asking for a reference action that is not ported yet raises ``KeyError``
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from .allocate import AllocateAction
from .backfill import BackfillAction
from .base import Action
from .enqueue import EnqueueAction

#: reference actions still to port -> the ROADMAP item that ports them
_NOT_PORTED = {name: "queue 1 item 5b (preempt, reclaim and the remaining "
                     "plugins)"
               for name in ("preempt", "reclaim", "elect", "reserve")}


def get_action(name: str) -> Action:
    actions = {cls.name: cls
               for cls in (EnqueueAction, AllocateAction, BackfillAction)}
    if name in actions:
        return actions[name]()
    if name in _NOT_PORTED:
        raise KeyError(f"action {name!r} is not ported to volcano_tpu_torch "
                       f"yet: ROADMAP {_NOT_PORTED[name]}")
    raise KeyError(f"unknown action {name!r}; ported: {sorted(actions)}")


__all__ = ["Action", "get_action"]
