"""Enqueue pass: gate Pending PodGroups into the Inqueue phase (PyTorch
port of ``volcano_tpu/ops/enqueue.py``).

The enqueue action (pkg/scheduler/actions/enqueue/enqueue.go:43-102) with
its JobEnqueueable voters: proportion's queue-quota test, permit iff
``minResources + allocated + inqueue <= capability`` (an unset capability
is +inf, proportion.go:254-280); overcommit's cluster-factor test
(pkg/scheduler/plugins/overcommit/overcommit.go:28-124); and sla's
waiting-deadline override (pkg/scheduler/plugins/sla/sla.go:146-148).

Admission is sequential: each admitted job's MinResources counts at once
against its queue and the cluster for the next candidate. The reference
scans every job in (queue, -priority, creation rank) order with the
non-candidates last; a non-candidate step changes nothing, so this pass
reads the order and the candidate mask back once, walks the candidates
alone in that order with a handful of small device operations a step and
no readback inside the loop, and returns the device mask. Like the
reference, it has no kernel of its own.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .seg_fold import seg_fold
from .select import sort_order

_EPS = 1e-5


@dataclass(frozen=True)
class EnqueueConfig:
    enable_proportion_gate: bool = True
    enable_overcommit_gate: bool = False
    overcommit_factor: float = 1.2   # overcommit.go default
    # sla override: jobs whose waiting time exceeded the SLA are always
    # admitted (sla.go:146-148); wait flags are computed host-side.


def _row_sum(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """f32[R]: the rows of ``x`` [A, R] where ``keep``, added in row order
    (a segmented sum of one segment)."""
    vals = torch.where(keep[:, None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    seg = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    return seg_fold(vals.contiguous(), seg, 1)[0]


def make_enqueue_pass(cfg: EnqueueConfig):
    """Returns enqueue(snap, sla_waiting) -> bool[J] newly admitted
    (Pending -> Inqueue) jobs, on the snapshot's device. ``sla_waiting``
    bool[J] marks jobs past their SLA waiting deadline."""

    def enqueue(snap, sla_waiting: torch.Tensor) -> torch.Tensor:
        jobs, queues, nodes = snap.jobs, snap.queues, snap.nodes
        dev = jobs.valid.device
        J = jobs.valid.shape[0]
        jq = jobs.queue.long()
        candidate = (jobs.valid & jobs.pending_phase
                     & queues.open[jq] & queues.valid[jq])
        order = sort_order([jobs.queue.to(torch.float32),
                            -jobs.priority.to(torch.float32),
                            jobs.creation_rank.to(torch.float32)], candidate)
        # the one readback before the walk: order, candidates, queues
        host = torch.stack([order, candidate.to(torch.int32)[order],
                            jobs.queue[order]]).cpu()
        n_cand = int(host[1].sum())
        steps = list(zip(host[0, :n_cand].tolist(),
                         host[2, :n_cand].tolist()))

        eps = torch.full((), _EPS, dtype=torch.float32, device=dev)
        q_inqueue = queues.inqueue_minres.clone()
        cluster_inqueue = _row_sum(
            queues.inqueue_minres,
            torch.ones(queues.valid.shape[0], dtype=torch.bool, device=dev))
        # loop-invariant halves of the gates, the reference's operations
        cap_eps = queues.capability + eps
        if cfg.enable_overcommit_gate:
            total_idle = _row_sum(nodes.idle, nodes.valid)
            total_alloc = _row_sum(nodes.allocatable, nodes.valid)
            base = (total_alloc * cfg.overcommit_factor
                    - (total_alloc - total_idle))
        admitted = torch.zeros(J, dtype=torch.bool, device=dev)
        sla = sla_waiting.to(device=dev, dtype=torch.bool)
        always = torch.ones((), dtype=torch.bool, device=dev)
        for ji, qi in steps:
            minres = jobs.min_resources[ji]
            permit = always
            if cfg.enable_proportion_gate:
                used = minres + queues.allocated[qi] + q_inqueue[qi]
                permit = permit & (used <= cap_eps[qi]).all()
            if cfg.enable_overcommit_gate:
                head = base - cluster_inqueue
                permit = permit & (minres <= head + eps).all()
            permit = permit | sla[ji]
            upd = permit.to(torch.float32) * minres
            q_inqueue[qi] += upd
            cluster_inqueue = cluster_inqueue + upd
            admitted[ji] = permit
        return admitted

    return enqueue
