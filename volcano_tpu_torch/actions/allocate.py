"""Allocate action (reference: pkg/scheduler/actions/allocate/allocate.go:43-281).

The whole pass (ordering, predicates, scoring, placement, gang commit or
discard) is the allocate cycle of ``ops/allocate_scan.py``; this action
runs it, applies its decisions and records the reference's readouts
(``allocated_binds``, ``jobs_ready``, ``jobs_pipelined`` in ``stats``).
"""

from __future__ import annotations

import numpy as np

from .base import Action


class AllocateAction(Action):
    name = "allocate"

    def execute(self, ssn) -> None:
        result = ssn.run_allocate()
        ssn.stats["allocated_binds"] = len(ssn.binds)
        ssn.stats["jobs_ready"] = int(np.asarray(result.job_ready).sum())
        ssn.stats["jobs_pipelined"] = int(
            np.asarray(result.job_pipelined).sum())
