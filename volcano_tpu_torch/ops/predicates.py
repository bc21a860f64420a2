"""Feasibility masks: one task signature against all nodes, vectorized
(PyTorch port of ``volcano_tpu/ops/predicates.py:28-166``).

Array form of the reference's predicate plugins (predicates.go:181-288
wrapping the k8s NodeUnschedulable, NodeAffinity and TaintToleration
filters). Inside the allocate cycle the capacity-dependent half (resource
fit, pod slots, GPU card fit) lives in the placers, which re-evaluate it
after every commit; :func:`capacity_feasible` is that half, without GPU
cards, for the backfill pass.
"""

from __future__ import annotations

import torch

from ..arrays.labels import (EFFECT_NO_EXECUTE, EFFECT_NO_SCHEDULE, TOL_EQUAL,
                             TOL_EXISTS_ALL, TOL_EXISTS_KEY)
from ..arrays.schema import NodeArrays

_EPS = 1e-5


def resource_fit(resreq: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """bool[N]: does ``resreq`` f32[R] fit into ``avail`` f32[N, R]
    (Resource.LessEqual, resource_info.go:376-414)?"""
    return (resreq[None, :] <= avail + _EPS).all(-1)


def pod_count_fit(nodes: NodeArrays, extra=None) -> torch.Tensor:
    """bool[N]: the node has pod slots left (predicates.go:213-230);
    ``extra`` i32[N] adds in-cycle placements."""
    count = nodes.pod_count if extra is None else nodes.pod_count + extra
    return count < nodes.max_pods


def capacity_feasible(nodes: NodeArrays, resreq: torch.Tensor,
                      avail: torch.Tensor, extra_pods=None) -> torch.Tensor:
    """bool[N]: resource fit and pod slots; AND it with a
    ``template_masks`` row for the full predicate conjunction. (The
    reference's optional single-card GPU fit has no caller outside the
    placers, which carry their own.)"""
    return pod_count_fit(nodes, extra_pods) & resource_fit(resreq, avail)


def selector_match(selector: torch.Tensor,
                   node_labels: torch.Tensor) -> torch.Tensor:
    """bool[N]: every nonzero required hash of ``selector`` i32[K] is in the
    node's label set ``node_labels`` i32[N, L]."""
    present = (node_labels[:, None, :] == selector[None, :, None]).any(-1)
    return ((selector == 0)[None, :] | present).all(-1)


def toleration_covers(tol_hash: torch.Tensor, tol_effect: torch.Tensor,
                      tol_mode: torch.Tensor,
                      nodes: NodeArrays) -> torch.Tensor:
    """bool[N, E]: does any of the task's tolerations cover taint e of
    node n? Shared by the hard-taint filter and the PreferNoSchedule
    scorer, so the two can never disagree."""
    kv, key, eff = nodes.taint_kv, nodes.taint_key, nodes.taint_effect
    m_all = (tol_mode == TOL_EXISTS_ALL)[None, None, :]
    m_key = ((tol_mode == TOL_EXISTS_KEY)[None, None, :]
             & (key[:, :, None] == tol_hash[None, None, :]))
    m_eq = ((tol_mode == TOL_EQUAL)[None, None, :]
            & (kv[:, :, None] == tol_hash[None, None, :]))
    eff_ok = ((tol_effect == 0)[None, None, :]
              | (tol_effect[None, None, :] == eff[:, :, None]))
    return ((m_all | m_key | m_eq) & eff_ok).any(-1)


def taints_tolerated(tol_hash: torch.Tensor, tol_effect: torch.Tensor,
                     tol_mode: torch.Tensor,
                     nodes: NodeArrays) -> torch.Tensor:
    """bool[N]: no NoSchedule/NoExecute taint left untolerated
    (PreferNoSchedule only scores, see scoring.taint_prefer_score)."""
    eff = nodes.taint_effect
    covered = toleration_covers(tol_hash, tol_effect, tol_mode, nodes)
    hard = (eff == EFFECT_NO_SCHEDULE) | (eff == EFFECT_NO_EXECUTE)
    return (~hard | covered).all(-1)


def static_feasible(nodes: NodeArrays, selector: torch.Tensor,
                    tol_hash: torch.Tensor, tol_effect: torch.Tensor,
                    tol_mode: torch.Tensor) -> torch.Tensor:
    """bool[N]: the capacity-independent predicate conjunction for one
    selector/toleration signature."""
    return (nodes.valid
            & nodes.schedulable
            & selector_match(selector, nodes.labels)
            & taints_tolerated(tol_hash, tol_effect, tol_mode, nodes))


def template_masks(nodes: NodeArrays, tasks,
                   template_rep: torch.Tensor) -> torch.Tensor:
    """bool[P, N]: static feasibility per predicate template, computed once
    per cycle from the template's representative task — the analog of the
    reference's predicate cache (plugins/predicates/cache.go:42-90)."""
    rows = [static_feasible(nodes, tasks.selector[ti], tasks.tol_hash[ti],
                            tasks.tol_effect[ti], tasks.tol_mode[ti])
            for ti in template_rep.clamp_min(0).tolist()]
    return torch.stack(rows)
