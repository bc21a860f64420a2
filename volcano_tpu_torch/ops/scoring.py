"""Additive node-score kernels (PyTorch port of ``volcano_tpu/ops/scoring.py``).

Array form of the reference's scoring plugins: binpack
(pkg/scheduler/plugins/binpack/binpack.go:196-260), nodeorder's wrapped k8s
least/most-allocated and balanced-allocation scorers
(pkg/scheduler/plugins/nodeorder/nodeorder.go:219-271) and the
tainttoleration PreferNoSchedule score. Each returns f32[N].

Bit-exactness with the reference: every sum over the resource axis folds in
index order from zero (:func:`fold_sum`), never through ``torch.sum``'s
vectorised order, and every constant is rounded to float32 once, as JAX
rounds a Python scalar, so float32 and float64 evaluation of each single
operation round to the same float32 result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..arrays.labels import EFFECT_PREFER_NO_SCHEDULE
from ..arrays.schema import NodeArrays

_EPS = float(np.float32(1e-9))
_OVER = float(np.float32(1.0 + 1e-6))


def fold_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` as ``((0 + x0) + x1) + ...`` in index order."""
    x = x.to(torch.float32) if x.dtype == torch.bool else x
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def binpack_score(used, allocatable, resreq, resource_weights):
    """Best-fit score, higher = fuller node after placement (BinPackingScore,
    binpack.go:196-260). used/allocatable f32[N,R], resreq and
    resource_weights f32[R]."""
    applicable = ((resreq > 0)[None, :] & (allocatable > 0)
                  & (resource_weights > 0)[None, :])
    frac = torch.where(applicable,
                       (used + resreq[None, :]) / allocatable.clamp_min(_EPS),
                       torch.zeros_like(used))
    over = frac > _OVER
    w = resource_weights[None, :] * applicable
    raw = fold_sum(frac * w) / fold_sum(w).clamp_min(_EPS)
    raw = torch.where(over.any(-1), torch.zeros_like(raw), raw)
    return raw * 100.0


def least_allocated_score(used, allocatable, resreq):
    """Spread score, higher = emptier node after placement (k8s
    NodeResourcesLeastAllocated, nodeorder.go:219-240)."""
    cap = allocatable.clamp_min(_EPS)
    free_frac = (allocatable - used - resreq[None, :]) / cap
    counted = allocatable > 0
    n = fold_sum(counted.to(torch.int32)).clamp_min(1)
    return fold_sum(free_frac.clamp(0.0, 1.0) * counted) / n * 100.0


def most_allocated_score(used, allocatable, resreq):
    """Packing score (k8s NodeResourcesMostAllocated)."""
    cap = allocatable.clamp_min(_EPS)
    used_frac = (used + resreq[None, :]) / cap
    counted = allocatable > 0
    n = fold_sum(counted.to(torch.int32)).clamp_min(1)
    return fold_sum(used_frac.clamp(0.0, 1.0) * counted) / n * 100.0


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as IEEE ``sqrtf`` (the
    kernels' and XLA's): taken in float64 and rounded once, which is exact
    for float32 inputs. PyTorch's vectorised float32 ``sqrt`` on the CPU
    is off by an ulp on some inputs (about 0.6 % of uniform ones)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def balanced_allocation_score(used, allocatable, resreq):
    """100 - 100*std(resource fractions): k8s
    NodeResourcesBalancedAllocation (nodeorder.go:241-260)."""
    cap = allocatable.clamp_min(_EPS)
    frac = ((used + resreq[None, :]) / cap).clamp(0.0, 1.0)
    counted = (allocatable > 0).to(frac.dtype)
    n = fold_sum(counted).clamp_min(1.0)
    mean = fold_sum(frac * counted) / n
    dev = frac - mean[:, None]
    var = fold_sum((dev * dev) * counted) / n
    return (1.0 - sqrt32(var)) * 100.0


def taint_prefer_score(tol_hash, tol_effect, tol_mode,
                       nodes: NodeArrays) -> torch.Tensor:
    """Fewer intolerable PreferNoSchedule taints = higher score (k8s
    TaintToleration scorer, nodeorder.go:219-271)."""
    from .predicates import toleration_covers
    covered = toleration_covers(tol_hash, tol_effect, tol_mode, nodes)
    prefer = nodes.taint_effect == EFFECT_PREFER_NO_SCHEDULE
    intolerable = (prefer & ~covered).sum(-1, dtype=torch.int32)
    max_count = intolerable.max().clamp_min(1)
    return (1.0 - intolerable / max_count) * 100.0


def node_preference_score(preferred_node, n_nodes: int) -> torch.Tensor:
    """One-hot bonus for a specific node (task-topology's bucket preference,
    topology.go:344)."""
    idx = torch.arange(n_nodes, dtype=torch.int32,
                       device=preferred_node.device)
    hit = (preferred_node >= 0) & (idx == preferred_node)
    return torch.where(hit, 100.0, 0.0).to(torch.float32)
