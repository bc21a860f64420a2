"""Allocate action (reference: pkg/scheduler/actions/allocate/allocate.go:43-281).

The whole pass (ordering, predicates, scoring, placement, gang commit or
discard) is the allocate cycle of ``ops/allocate_scan.py``; this action
runs it and applies its decisions.
"""

from __future__ import annotations

from .base import Action


class AllocateAction(Action):
    name = "allocate"

    def execute(self, ssn) -> None:
        ssn.run_allocate()
