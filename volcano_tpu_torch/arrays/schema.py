"""Dense array schema of a cluster snapshot — the device-side world state.

PyTorch counterpart of ``volcano_tpu/arrays/schema.py``: the same
struct-of-array snapshot (reference: cache.Snapshot,
pkg/scheduler/cache/cache.go:712-811) with the same field names, shapes and
dtypes, held in plain dataclasses. The packer fills them with numpy arrays
on the host; :func:`to_device` moves a whole tree onto a torch device in
one pass.

Axis legend: N nodes, T tasks, J jobs, Q queues, S namespaces, R resource dims,
L label slots, K selector slots, E taint slots, O toleration slots, M max
pending tasks per job, G GPU cards per node (shared-GPU predicate).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from .affinity import AffinityArrays
from .hierarchy import HierarchyArrays

#: numpy dtype -> torch dtype of every array the snapshot carries
_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


@dataclass
class NodeArrays:
    """Per-node accounting tensors (reference: api.NodeInfo, node_info.go:28-437)."""

    idle: Any          # f32[N, R]
    used: Any          # f32[N, R]
    releasing: Any     # f32[N, R]
    pipelined: Any     # f32[N, R]
    allocatable: Any   # f32[N, R]
    capability: Any    # f32[N, R]
    labels: Any        # i32[N, L]  label key=value hashes, 0 pad
    taint_kv: Any      # i32[N, E]  taint key=value hashes, 0 pad
    taint_key: Any     # i32[N, E]  taint key hashes
    taint_effect: Any  # i32[N, E]  effect codes (labels.EFFECT_*)
    pod_count: Any     # i32[N]
    max_pods: Any      # i32[N]
    gpu_memory: Any    # f32[N, G]  per-card memory, 0 = no card
    gpu_used: Any      # f32[N, G]  per-card used memory
    schedulable: Any   # bool[N]  ready && !unschedulable
    valid: Any         # bool[N]


@dataclass
class TaskArrays:
    """Per-task tensors (reference: api.TaskInfo, job_info.go:70-171)."""

    resreq: Any        # f32[T, R]
    job: Any           # i32[T] job index
    status: Any        # i32[T] TaskStatus codes
    priority: Any      # i32[T]
    node: Any          # i32[T] current node index, -1 unassigned
    selector: Any      # i32[T, K] required label hashes, 0 pad
    tol_hash: Any      # i32[T, O] toleration match hashes
    tol_effect: Any    # i32[T, O] effect codes (0 = all effects)
    tol_mode: Any      # i32[T, O] labels.TOL_* modes
    best_effort: Any   # bool[T] empty resreq (backfill targets)
    gpu_request: Any   # f32[T] single-card GPU memory request
    template: Any      # i32[T] predicate-template id (predicates/cache.go:42-67)
    preemptable: Any   # bool[T]
    valid: Any         # bool[T]


@dataclass
class JobArrays:
    """Per-gang-job tensors (reference: api.JobInfo, job_info.go:181-613)."""

    min_available: Any  # i32[J]
    queue: Any          # i32[J] queue index
    namespace: Any      # i32[J]
    priority: Any       # i32[J]
    creation_rank: Any  # i32[J] older = smaller (FIFO tie-break)
    ready_num: Any      # i32[J] tasks already in ready statuses
    allocated: Any      # f32[J, R] resources of allocated-status tasks
    total_request: Any  # f32[J, R]
    min_resources: Any  # f32[J, R] PodGroup MinResources (enqueue gate)
    task_table: Any     # i32[J, M] pending task indices in task order, -1 pad
    n_pending: Any      # i32[J]
    schedulable: Any    # bool[J] gang-valid && queue open && inqueue
    inqueue: Any        # bool[J] PodGroup phase is Inqueue/Running
    pending_phase: Any  # bool[J] PodGroup phase is Pending (enqueue input)
    preemptable: Any    # bool[J]
    valid: Any          # bool[J]


@dataclass
class QueueArrays:
    """Per-queue tensors (reference: api.QueueInfo + proportion queueAttr,
    pkg/scheduler/plugins/proportion/proportion.go:59-90)."""

    weight: Any          # f32[Q]
    capability: Any      # f32[Q, R] +inf where unset
    reclaimable: Any     # bool[Q]
    open: Any            # bool[Q]
    allocated: Any       # f32[Q, R] sum of member jobs' allocated
    request: Any         # f32[Q, R] sum of member jobs' total_request
    inqueue_minres: Any  # f32[Q, R] sum of MinResources of inqueue jobs
    parent: Any          # i32[Q] parent queue index (-1 for roots)
    depth: Any           # i32[Q]
    hier_weight: Any     # f32[Q] hdrf leaf weight, 1 when unset
    valid: Any           # bool[Q]


@dataclass
class SnapshotArrays:
    """The full device-side snapshot consumed by the allocate cycle."""

    nodes: NodeArrays
    tasks: TaskArrays
    jobs: JobArrays
    queues: QueueArrays
    namespace_weight: Any   # f32[S]
    cluster_capacity: Any   # f32[R] sum of node allocatable
    template_rep: Any       # i32[P] representative task per predicate
    #                         template, -1 pad (cache.go analog)


@dataclass
class IndexMaps:
    """Host-side decode tables (never moved to the device)."""

    node_names: List[str] = field(default_factory=list)
    task_uids: List[str] = field(default_factory=list)
    job_uids: List[str] = field(default_factory=list)
    queue_names: List[str] = field(default_factory=list)
    namespace_names: List[str] = field(default_factory=list)
    resource_names: List[str] = field(default_factory=list)
    node_index: Dict[str, int] = field(default_factory=dict)
    task_index: Dict[str, int] = field(default_factory=dict)
    job_index: Dict[str, int] = field(default_factory=dict)
    queue_index: Dict[str, int] = field(default_factory=dict)


def bucket(n: int, minimum: int = 8) -> int:
    """Round up to the static-shape bucket grid: powers of two up to 1024,
    then 8 buckets per octave (multiples of next_pow2(n)/8), so 10k nodes
    pad to 10240. The decision fingerprints cover the padded arrays, so
    this grid must stay identical to the reference packer's."""
    b = minimum
    while b < n and b < 1024:
        b *= 2
    if n <= b:
        return b
    p = 1 << (int(n) - 1).bit_length()   # next power of two >= n
    g = max(1024, p // 8)
    return ((int(n) + g - 1) // g) * g


def pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad axis 0 of ``a`` to length n."""
    if a.shape[0] == n:
        return a
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def _tensor(value, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    dtype = _DTYPES.get(arr.dtype)
    if dtype is None:
        raise TypeError(f"snapshot arrays are f32/i32/bool, got {arr.dtype}")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                          dtype=dtype)


def to_device(tree, device):
    """Copy a snapshot dataclass tree (SnapshotArrays, AllocateExtras and
    their nested arrays) onto ``device``: f32 -> float32, i32 -> int32,
    bool -> bool. Returns a new tree; the input is left as it was."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    return _tensor(tree, device)


def _from_dict(cls, data: Dict[str, Any], device):
    kwargs = {}
    for f in dataclasses.fields(cls):
        sub = _NESTED.get((cls.__name__, f.name))
        kwargs[f.name] = (_from_dict(sub, data[f.name], device) if sub
                          else _tensor(data[f.name], device))
    return cls(**kwargs)


_NESTED = {
    ("SnapshotArrays", "nodes"): NodeArrays,
    ("SnapshotArrays", "tasks"): TaskArrays,
    ("SnapshotArrays", "jobs"): JobArrays,
    ("SnapshotArrays", "queues"): QueueArrays,
    ("AllocateExtras", "affinity"): AffinityArrays,
    ("AllocateExtras", "hierarchy"): HierarchyArrays,
}


def snapshot_from_numpy(snap_np: Dict[str, Any], extras_np: Dict[str, Any],
                        device):
    """(SnapshotArrays, AllocateExtras) on ``device`` from nested dicts of
    numpy arrays keyed by the field names — the form in which another
    producer of the same snapshot (for instance the JAX reference
    package, through ``dataclasses.asdict``) hands over its bytes. Every
    field of the extras comes across, the nested ``AffinityArrays`` and
    ``HierarchyArrays`` too, plugin-filled or neutral: proportion's
    ``queue_deserved``, drf's ``job_share`` and ``ns_share``, the
    deadlines and the node-affinity, port and volume fields."""
    from ..ops.allocate_scan import AllocateExtras
    return (_from_dict(SnapshotArrays, snap_np, device),
            _from_dict(AllocateExtras, extras_np, device))
