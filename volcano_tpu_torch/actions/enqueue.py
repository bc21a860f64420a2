"""Enqueue action (reference: pkg/scheduler/actions/enqueue/enqueue.go:43-102)."""

from __future__ import annotations

from .base import Action


class EnqueueAction(Action):
    name = "enqueue"

    def execute(self, ssn) -> None:
        ssn.stats["enqueued"] = ssn.run_enqueue()
