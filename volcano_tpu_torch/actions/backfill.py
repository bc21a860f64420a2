"""Backfill action (reference: pkg/scheduler/actions/backfill/backfill.go:40-93)."""

from __future__ import annotations

from .base import Action


class BackfillAction(Action):
    name = "backfill"

    def execute(self, ssn) -> None:
        ssn.stats["backfilled"] = ssn.run_backfill()
