"""Fair-share solvers: proportion water-filling, DRF, hierarchical DRF
(PyTorch port of ``volcano_tpu/ops/fairshare.py``).

- proportion's iterative deserved-share water-filling
  (pkg/scheduler/plugins/proportion/proportion.go:140-197) runs as a Python
  loop over [Q, R] tensors, with the reference's bound and stop tests;
- drf's dominant-resource shares (drf.go:104-131, calcShare) are one masked
  max-reduce per job or namespace;
- the hierarchical DRF (drf.go:42-87, 230-360) propagates subtree
  allocations up the packed tree (``arrays/hierarchy.py``) level by level.

Every sum over queues, jobs or resource dims folds in index order from 0,
so the results do not depend on the device; the sums over jobs and tree
nodes run on the device of their inputs through the segmented sum of
``ops/seg_fold.py`` (a CUDA kernel on the card). Where the reference's own
order is not defined (XLA's reductions and ``segment_sum``), the two agree
whenever the sums are exact, which requests in multiples of 500 millicpu
and of 2^30 bytes keep them below 2^26 millicpu.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api.resource import MIN_RESOURCE
from .seg_fold import seg_fold

_EPS = float(np.float32(1e-9))
_MIN_RES = float(np.float32(MIN_RESOURCE))
_INF = float("inf")


def fold_rows(x: torch.Tensor) -> torch.Tensor:
    """[A, ...] -> [...]: ((0 + x[0]) + x[1]) + ... in float32, in index
    order, on the device of ``x``."""
    acc = torch.zeros_like(x[0])
    for a in range(x.shape[0]):
        acc = acc + x[a]
    return acc


def fold_last(x: torch.Tensor) -> torch.Tensor:
    """[..., J] -> [...]: ((x0 + x1) + x2) + ... over the last axis, in
    float32 and in index order, with numpy's sequential ``add.accumulate``
    on the host (J is thousands, too long for a Python loop of tensor ops).
    For the plain versions only: a CUDA input is copied to the host and the
    result back."""
    v = x.detach().cpu().numpy()
    if v.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    out = np.add.accumulate(v, axis=-1, dtype=np.float32)[..., -1]
    return torch.from_numpy(np.ascontiguousarray(out)).to(x.device)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add rounds it.

    XLA's CPU backend contracts the water-filling step ``deserved +
    remaining * frac`` into one FMA; this reproduces it on any device. The
    float32 product is exact in float64; ``hi + err`` is the exact sum
    (Knuth's two-sum); rounding ``hi`` to float32 is exact unless ``hi``
    lies halfway between two float32 values, where ``err`` decides."""
    p = a.double() * b.double()
    c64 = c.double()
    hi = p + c64
    bb = hi - p
    err = (p - (hi - bb)) + (c64 - bb)
    r = hi.float()
    other = torch.nextafter(r, torch.where(hi > r.double(), torch.full_like(
        r, float("inf")), torch.full_like(r, float("-inf"))))
    mid = (hi - r.double()) == (other.double() - r.double()) / 2
    toward_other = (err > 0) == (other > r)
    return torch.where(mid & (err != 0) & toward_other, other, r)


def proportion_deserved(queues, total: torch.Tensor,
                        max_iters: int = 16) -> torch.Tensor:
    """f32[Q, R]: each queue's deserved share by weighted water-filling.

    Repeatedly hand each unmet queue ``remaining * w_q / sum(unmet
    weights)``, clamp by capability and request (``min(deserved',
    capability, request)``), mark queues that meet their request or exceed
    their capability, and recycle the clamped-off amount into
    ``remaining`` (proportion.go:140-197).

    ``proposed`` is one fused multiply-add (:func:`fma32`), as XLA's CPU
    backend compiles the reference. The loop starts with
    ``prev_remaining = total + 1.0`` and tests
    "remaining changed" before the first pass, as the reference does
    (fairshare.py:47 and :64-65 there). Once every dimension of ``total``
    is 2^24 or more, ``total + 1.0 == total`` in float32, no pass runs and
    every queue's deserved is 0: the reference's behaviour, reproduced
    bit for bit (ROADMAP, reference fault (d)).
    """
    Q, R = queues.allocated.shape
    dev = queues.allocated.device
    weight = torch.where(queues.valid, queues.weight.to(torch.float32),
                         torch.zeros((), device=dev))
    request = queues.request
    capability = queues.capability
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    deserved = torch.zeros((Q, R), dtype=torch.float32, device=dev)
    remaining = total.to(torch.float32)
    meet = ~queues.valid
    prev = remaining + 1.0
    for _ in range(max_iters):
        unmet_w = torch.where(meet, zero, weight)
        total_w = fold_rows(unmet_w)
        changed = ((remaining - prev).abs() > _EPS).any()
        nonempty = (remaining >= _MIN_RES).any()
        if not bool(total_w > 0) or not bool(nonempty) or not bool(changed):
            break
        frac = unmet_w / total_w.clamp_min(_EPS)
        proposed = fma32(remaining[None, :], frac[:, None], deserved)
        cap_exceeded = ~(proposed <= capability + _EPS).all(-1)
        new = torch.minimum(torch.minimum(proposed, capability), request)
        new = torch.where(meet[:, None], deserved, new)
        new_meet = meet | cap_exceeded | (request <= proposed + _EPS).all(-1)
        delta = fold_rows(new - deserved)
        deserved, prev, remaining, meet = new, remaining, remaining - delta, \
            new_meet
    return deserved


def dominant_share(allocated: torch.Tensor, total: torch.Tensor):
    """f32[...]: max over resource dims of allocated / total, dims with no
    cluster capacity ignored (drf.go calcShare)."""
    frac = torch.where(total > 0, allocated / total.clamp_min(_EPS),
                       torch.zeros((), device=allocated.device))
    return frac.max(dim=-1).values


def drf_job_shares(job_allocated: torch.Tensor, total: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """f32[J]: per-job dominant share, the drf JobOrderFn key
    (drf.go:454-472); +inf for invalid jobs."""
    return torch.where(valid, dominant_share(job_allocated, total),
                       torch.full((), _INF, device=job_allocated.device))


def namespace_shares(job_allocated: torch.Tensor, job_namespace: torch.Tensor,
                     job_valid: torch.Tensor, ns_weight: torch.Tensor,
                     total: torch.Tensor) -> torch.Tensor:
    """f32[S]: weighted namespace dominant share (drf namespaceOrderFn,
    drf.go:474-507): dominantShare(sum of member jobs) / weight. The member
    sum folds over the jobs in index order, on the inputs' device."""
    S = ns_weight.shape[0]
    seg = torch.where(job_valid, job_namespace.to(torch.int32),
                      torch.full((), -1, dtype=torch.int32,
                                 device=job_namespace.device))
    ns_alloc = seg_fold(job_allocated.to(torch.float32), seg, S)  # [S, R]
    return dominant_share(ns_alloc, total) / ns_weight.clamp_min(1.0)


def _seg_sum(vals, idx, mask, num):
    """Masked segment sum [A, ...] -> [num, ...], rows added in index
    order (:func:`seg_fold`)."""
    seg = torch.where(mask, idx.to(torch.int32),
                      torch.full((), -1, dtype=torch.int32, device=idx.device))
    flat = vals.to(torch.float32).reshape(vals.shape[0], -1)
    return seg_fold(flat, seg, num).reshape((num,) + tuple(vals.shape[1:]))


def _seg_min(vals, idx, mask, num):
    """Masked segment min (exact in any order)."""
    sel = torch.where(mask, vals, torch.full((), _INF, device=vals.device))
    out = torch.full((num + 1,), _INF, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, torch.where(mask, idx, num).long(), sel,
                               "amin")[:num]


def hdrf_tree_state(hier, job_alloc, job_request, job_valid, total):
    """Bottom-up hdrf tree update (drf.go:693-767), on ``job_alloc``'s
    device.

    For each depth from the deepest up, every internal node rescales its
    unsaturated children's allocations to the minimum dominant share among
    them (``mdr / child.share``, drf.go:704-745), sums them and recomputes
    its own dominant share; a node is saturated when all its children are.
    A job leaf saturates when its allocation meets its request in some
    dimension, or when it requests a dimension the cluster has fully
    allocated (drf.go:90-103). The subtree sums add in index order
    (:func:`_seg_sum`).
    Returns (share f32[H], saturated bool[H], allocated f32[H, R]).
    """
    dev = job_alloc.device
    tree = _tree(hier, dev)
    H = tree["parent"].shape[0]
    D = tree["queue_path"].shape[1]
    R = total.shape[0]
    jmask = job_valid & (tree["job_leaf"] >= 0)
    leaf = tree["job_leaf"].clamp_min(0).long()
    job_share = dominant_share(job_alloc, total)
    total_alloc = _seg_sum(job_alloc, torch.zeros_like(leaf), jmask, 1)[0]
    demanding = total_alloc < total
    job_sat = (((job_alloc > _EPS) & (job_request > _EPS)
                & (job_alloc >= job_request - _EPS))
               | (~demanding[None, :] & (job_request > _EPS))).any(-1)
    job_depth = tree["depth"][leaf]

    share = torch.zeros(H, dtype=torch.float32, device=dev)
    sat = torch.ones(H, dtype=torch.bool, device=dev)
    alloc = torch.zeros((H, R), dtype=torch.float32, device=dev)
    parent = tree["parent"].clamp_min(0).long()
    valid, depth = tree["valid"], tree["depth"]
    one = torch.ones((), device=dev)
    zero = torch.zeros((), device=dev)
    for d in reversed(range(D)):
        child = valid & (depth == d + 1)
        jat = jmask & (job_depth == d)
        mdr = torch.minimum(
            _seg_min(share, parent, child & (share > _EPS) & ~sat, H),
            _seg_min(job_share, leaf, jat & (job_share > _EPS) & ~job_sat,
                     H))
        mdr = torch.minimum(mdr, one)
        c_scale = torch.where(share > _EPS, torch.where(
            sat, one, mdr[parent] / share.clamp_min(_EPS)), zero)
        j_scale = torch.where(job_share > _EPS, torch.where(
            job_sat, one, mdr[leaf] / job_share.clamp_min(_EPS)), zero)
        new_alloc = (_seg_sum(alloc * c_scale[:, None], parent, child, H)
                     + _seg_sum(job_alloc * j_scale[:, None], leaf, jat, H))
        unsat = (_seg_sum((~sat).to(torch.float32), parent, child, H)
                 + _seg_sum((~job_sat).to(torch.float32), leaf, jat, H))
        at_d = valid & (depth == d)
        share = torch.where(at_d, dominant_share(new_alloc, total), share)
        sat = torch.where(at_d, unsat == 0, sat)
        alloc = torch.where(at_d[:, None], new_alloc, alloc)
    return share, sat, alloc


def _tree(hier, device):
    """The HierarchyArrays fields as tensors on ``device``, by name (no
    copy when they are there already, as in the allocate cycle)."""
    return {k: torch.as_tensor(getattr(hier, k), device=device)
            for k in ("parent", "depth", "weight", "valid", "queue_path",
                      "job_leaf")}


def hdrf_level_keys(hier, job_alloc, job_request, job_valid, total):
    """f32[Q, 2D]: per-queue lexicographic hdrf ordering columns.

    ``compareQueues`` (drf.go:182-218) walks both queues' paths from the
    root: an unsaturated node beats a saturated one, then the lower
    ``share / weight`` wins, ties descend. Emitted as interleaved
    (saturated, share / weight) columns per level; levels past a queue's
    path end are -1. Computed on ``job_alloc``'s device."""
    share, sat, _ = hdrf_tree_state(hier, job_alloc, job_request,
                                    job_valid, total)
    h = _tree(hier, job_alloc.device)
    path = h["queue_path"]
    on_path = path >= 0
    node = path.clamp_min(0).long()
    neg1 = torch.full((), -1.0, device=job_alloc.device)
    sat_col = torch.where(on_path, sat[node].to(torch.float32), neg1)
    share_col = torch.where(on_path, share[node]
                            / h["weight"][node].clamp_min(1.0), neg1)
    cols = torch.stack([sat_col, share_col], dim=-1)
    return cols.reshape(path.shape[0], 2 * path.shape[1])
