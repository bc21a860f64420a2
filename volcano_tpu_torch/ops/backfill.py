"""Backfill pass: place zero-request (BestEffort) pending tasks (PyTorch
port of ``volcano_tpu/ops/backfill.py``, without its telemetry).

The backfill action (pkg/scheduler/actions/backfill/backfill.go:40-93):
every pending task with an empty resource request goes to a node that
passes the predicates (the reference does not score here), at once, with
no gang transaction. The reference iterates a Go map; like the JAX
package, the port takes the lowest feasible node.

The JAX pass scans every task in index order; a step whose task is no
candidate changes nothing, so this pass reads the candidates back once
and walks only them, in ascending index, with no readback inside the
loop. ``pods_extra`` counts the pods it placed on each node, so a node
fills up to its pod limit. Like the reference, it has no kernel of its
own.
"""

from __future__ import annotations

import torch

from ..api.types import TaskStatus
from . import predicates as P


def make_backfill_pass():
    """Returns backfill(snap, task_or_group=None, or_feasible=None) ->
    (task_node i32[T], placed bool[T]) on the snapshot's device. The
    optional pair is the OR-of-terms node-affinity group mask (required
    affinity binds best-effort tasks too: backfill.go runs the same
    PredicateFn)."""

    def backfill(snap, task_or_group=None, or_feasible=None):
        nodes, tasks, jobs = snap.nodes, snap.tasks, snap.jobs
        dev = tasks.valid.device
        T = tasks.resreq.shape[0]
        N = nodes.idle.shape[0]
        candidate = (tasks.valid & tasks.best_effort
                     & (tasks.status == int(TaskStatus.PENDING))
                     & jobs.schedulable[tasks.job.clamp_min(0).long()]
                     & (tasks.job >= 0))
        if task_or_group is None:
            task_or_group = torch.full((T,), -1, dtype=torch.int32,
                                       device=dev)
        # per-template static predicate rows (predicate-cache analog)
        tmpl_static = P.template_masks(nodes, tasks, snap.template_rep)
        # the one readback before the walk: each candidate's template and
        # OR group
        cand = candidate.nonzero()[:, 0]
        host = torch.stack([cand.to(torch.int32), tasks.template[cand],
                            task_or_group[cand]]).cpu().tolist()

        pods_extra = torch.zeros(N, dtype=torch.int32, device=dev)
        t_node = torch.full((T,), -1, dtype=torch.int32, device=dev)
        placed = torch.zeros(T, dtype=torch.bool, device=dev)
        for t, tmpl, grp in zip(*host):
            feas = tmpl_static[tmpl] & P.capacity_feasible(
                nodes, tasks.resreq[t], nodes.idle, pods_extra)
            if grp >= 0:
                feas = feas & or_feasible[grp]
            # the lowest feasible index (0 when none is); indexed as a
            # one-element tensor, which never waits for the device
            node = torch.argmax(feas.to(torch.uint8)).reshape(1)
            ok = feas.any()
            pods_extra.index_add_(0, node, ok.to(torch.int32).reshape(1))
            t_node[t] = torch.where(ok, node[0].to(torch.int32), -1)
            placed[t] = ok
        return t_node, placed

    return backfill
