"""Proportion plugin: weighted queue fair share.

Reference: pkg/scheduler/plugins/proportion/proportion.go:33-325. The
water-filling deserved computation is ``ops/fairshare.proportion_deserved``;
the Overused gate and the queue-share order consume its output inside the
allocate cycle. The port of ``volcano_tpu/plugins/proportion.py``.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .base import Plugin


class ProportionPlugin(Plugin):
    name = "proportion"

    def queue_deserved(self, ssn) -> np.ndarray:
        """f32[Q, R] on the host, computed on CPU tensors."""
        from ..ops.fairshare import proportion_deserved
        q = ssn.snap.queues
        queues = types.SimpleNamespace(**{
            f: torch.from_numpy(np.asarray(getattr(q, f)))
            for f in ("weight", "capability", "allocated", "request",
                      "valid")})
        total = torch.from_numpy(np.asarray(ssn.snap.cluster_capacity))
        return proportion_deserved(queues, total).numpy()

    def enqueue_gates(self, ssn):
        return {"enable_proportion_gate": True}
