"""Packed hdrf hierarchy tree, as the allocate cycle reads it.

PyTorch counterpart of ``volcano_tpu/arrays/hierarchy.py``: the fork's
hierarchical DRF builds an explicit tree from each queue's
``volcano.sh/hierarchy`` annotation (pkg/scheduler/plugins/drf/drf.go:641-690
buildHierarchy): the root, one node per path component and one leaf per job
under its queue's last path node. The tree is built on the host as numpy
arrays that ride ``AllocateExtras`` (it changes only when queues change):

- one tree node per unique path prefix across all queues (root included),
- ``queue_path[q, d]`` = the tree node at depth ``d`` along queue ``q``'s
  path (-1 past its end): the walk ``compareQueues`` performs
  (drf.go:182-218),
- ``job_leaf[j]`` = the node under which job ``j``'s drf attribute hangs.

Node weights come from ``volcano.sh/hierarchy-weights``: parsed per level,
floored at 1, the first declaring queue wins (drf.go:648-674); the root
keeps weight 1 (drf.go:141-147). A queue without a hierarchy annotation
attaches its jobs directly under the root.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np


@dataclass
class HierarchyArrays:
    """Static hdrf tree topology (H tree nodes, D depth levels)."""

    parent: Any      # i32[H] parent node, -1 for root
    depth: Any       # i32[H] root = 0
    weight: Any      # f32[H] hierarchy weight, >= 1
    valid: Any       # bool[H]
    queue_path: Any  # i32[Q, D] node at each depth along the queue's path
    job_leaf: Any    # i32[J] attach node per job, -1 = not in tree

    @classmethod
    def neutral(cls, Q: int, J: int) -> "HierarchyArrays":
        """Root-only tree: every queue sits at root, no job leaves."""
        path = np.full((Q, 2), -1, np.int32)
        path[:, 0] = 0
        return cls(
            parent=np.array([-1] + [-1] * 3, np.int32),
            depth=np.zeros(4, np.int32),
            weight=np.ones(4, np.float32),
            valid=np.array([True, False, False, False]),
            queue_path=path,
            job_leaf=np.full(J, -1, np.int32),
        )


def build_from_specs(specs: List[Tuple[str, str]], Q: int,
                     job_queue: np.ndarray,
                     job_in_tree: np.ndarray) -> HierarchyArrays:
    """(hierarchy, weights) annotation strings per queue -> HierarchyArrays.

    ``specs`` is ordered like the packed queue axis; ``job_queue`` is the
    packed i32[J] queue index per job and ``job_in_tree`` masks jobs whose
    queue is real (others get leaf -1).
    """
    from .schema import bucket
    paths: List[List[str]] = []
    weights: List[List[float]] = []
    for hierarchy, wstr in specs:
        p = [c for c in hierarchy.split("/") if c]
        paths.append(p[1:] if p else [])          # components after root
        try:
            w = [float(x) for x in wstr.split("/") if x]
        except ValueError:
            w = []
        weights.append(w[1:] if len(w) > 1 else [])

    # materialize nodes: root + every unique prefix, in queue order so the
    # first declaring queue's weight wins (buildHierarchy first-create,
    # drf.go:648-674)
    node_of: Dict[Tuple[str, ...], int] = {(): 0}
    node_parent = [-1]
    node_depth = [0]
    node_weight = [1.0]                            # root weight (drf.go:146)
    for comps, wvals in zip(paths, weights):
        for i in range(len(comps)):
            key = tuple(comps[: i + 1])
            if key in node_of:
                continue
            w = wvals[i] if i < len(wvals) else 1.0
            node_of[key] = len(node_parent)
            node_parent.append(node_of[tuple(comps[:i])])
            node_depth.append(i + 1)
            node_weight.append(max(w, 1.0))

    nH = len(node_parent)
    H = bucket(nH, 4)
    parent = np.full(H, -1, np.int32)
    depth = np.zeros(H, np.int32)
    weight = np.ones(H, np.float32)
    valid = np.zeros(H, bool)
    parent[:nH] = node_parent
    depth[:nH] = node_depth
    weight[:nH] = node_weight
    valid[:nH] = True

    D = max((len(p) for p in paths), default=0) + 1
    D = max(D, 2)
    queue_path = np.full((Q, D), -1, np.int32)
    leaf_of_queue = np.full(Q, 0, np.int32)
    for qi, comps in enumerate(paths):
        queue_path[qi, 0] = 0
        for i in range(len(comps)):
            queue_path[qi, i + 1] = node_of[tuple(comps[: i + 1])]
        leaf_of_queue[qi] = queue_path[qi, len(comps)]

    J = job_queue.shape[0]
    job_leaf = np.full(J, -1, np.int32)
    sel = np.asarray(job_in_tree, bool)
    job_leaf[sel] = leaf_of_queue[np.clip(job_queue[sel], 0, Q - 1)]

    return HierarchyArrays(parent=parent, depth=depth, weight=weight,
                           valid=valid, queue_path=queue_path,
                           job_leaf=job_leaf)


def build_hierarchy(ci, maps, Q: int, J: int) -> HierarchyArrays:
    """ClusterInfo -> HierarchyArrays on the packed queue/job index maps.

    ``Q``/``J`` are the bucketed dims of the snapshot.
    """
    specs = [(ci.queues[n].hierarchy, ci.queues[n].hierarchy_weights)
             for n in maps.queue_names]
    specs += [("", "")] * (Q - len(specs))
    job_queue = np.zeros(J, np.int32)
    job_in_tree = np.zeros(J, bool)
    for uid, ji in maps.job_index.items():
        qi = maps.queue_index.get(ci.jobs[uid].queue, -1)
        if qi >= 0:
            job_queue[ji] = qi
            job_in_tree[ji] = True
    return build_from_specs(specs, Q, job_queue, job_in_tree)
