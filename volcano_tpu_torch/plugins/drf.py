"""DRF plugin: dominant-resource fairness (job order, namespace fairness,
hierarchical queues).

Reference: pkg/scheduler/plugins/drf/drf.go:35-797: per-job dominant share
(drfAttr, drf.go:104-131), weighted namespace fairness (drf.go:474-507) and
the fork's hierarchical DRF over queue hierarchy annotations
(drf.go:42-87, 230-360). A copy of ``volcano_tpu/plugins/drf.py``. The
allocate cycle recomputes the shares from the live allocations after every
commit (``ops/fairshare.py``, ``ops/dyn_placer.py``); these are the
snapshot's starting keys.
"""

from __future__ import annotations

import numpy as np

from .base import Plugin


class DRFPlugin(Plugin):
    name = "drf"

    def job_order_share(self, ssn) -> np.ndarray:
        jobs = ssn.snap.jobs
        total = np.maximum(np.asarray(ssn.snap.cluster_capacity), 1e-9)
        alloc = np.asarray(jobs.allocated)
        frac = np.where(total > 0, alloc / total, 0.0)
        share = frac.max(axis=-1)
        return np.where(np.asarray(jobs.valid), share, np.inf).astype(np.float32)

    def namespace_share(self, ssn) -> np.ndarray:
        if not self.option.enabled_namespace_order:
            return None
        jobs = ssn.snap.jobs
        S = np.asarray(ssn.snap.namespace_weight).shape[0]
        total = np.maximum(np.asarray(ssn.snap.cluster_capacity), 1e-9)
        ns_alloc = np.zeros((S, total.shape[0]), np.float32)
        alloc = np.asarray(jobs.allocated)
        ns_idx = np.asarray(jobs.namespace)
        valid = np.asarray(jobs.valid)
        np.add.at(ns_alloc, ns_idx[valid], alloc[valid])
        share = (ns_alloc / total).max(axis=-1)
        return (share / np.maximum(np.asarray(ssn.snap.namespace_weight), 1.0)
                ).astype(np.float32)

    # hdrf: the hierarchical queue order comes from AllocateExtras.hierarchy
    # (arrays/hierarchy.py) when the option's enabled_hierarchy sets
    # AllocateConfig.enable_hdrf; see ops/fairshare.hdrf_level_keys.
