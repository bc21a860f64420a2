"""Host-computed session extras (a numpy copy of
``volcano_tpu/framework/host_extras.py``).

These allocate inputs come from walking the object model rather than the
packed arrays: node-affinity OR-group and preferred-score masks (full
matchExpressions semantics through ``api.NodeSelectorTerm``) and the
NodePorts / volume-binding seams. ``Session._node_affinity_extras`` and
``_port_volume_extras`` consume them.

Everything here is sized to the real entity counts (nt tasks, nn nodes);
padding to the snapshot's buckets happens in the ``apply_*`` functions.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..api import as_node_term


def node_affinity_sections(cluster, node_names: List[str],
                           task_index: Dict[str, int],
                           na_weight: float,
                           do_required: bool) -> Dict[str, np.ndarray]:
    """Node-affinity host sections.

    Returns dict with:
      task_or_group i32[nt]  (-1 = unconstrained) and or_masks bool[G, nn]
        — required OR-of-terms / expression-term feasibility, grouped by
        distinct term-set signature (predicates.go:186-190 semantics);
      task_na_group i32[nt] (-1 = no preferred terms) and na_rows
        f32[G2, nn] — preferred-term score rows, already scaled by
        ``na_weight`` (nodeorder.go:255-266), grouped by signature.
        Accumulation order follows the first-seen task's term list so every
        consumer reproduces the same f32 association.
    """
    nt = len(task_index)
    nn = len(node_names)
    node_labels = [cluster.nodes[n].labels for n in node_names]

    def term_mask(term) -> np.ndarray:
        t = as_node_term(term)
        return np.fromiter((t.matches(labels) for labels in node_labels),
                           bool, count=nn)

    task_or_group = np.full(nt, -1, np.int32)
    or_masks: List[np.ndarray] = []
    or_group_of: Dict[tuple, int] = {}
    task_na_group = np.full(nt, -1, np.int32)
    na_rows: List[np.ndarray] = []
    na_group_of: Dict[tuple, int] = {}
    do_score = bool(na_weight)

    for job in cluster.jobs.values():
        for uid, task in job.tasks.items():
            ti = task_index.get(uid)
            if ti is None or ti >= nt:
                continue
            if do_required and task.affinity_required:
                terms = [as_node_term(m) for m in task.affinity_required]
                if not (len(terms) == 1 and terms[0].is_pure_labels()):
                    # a lone pure-labels term folds into the packed hash
                    # row (arrays/pack.py); everything else rides the mask
                    key = tuple(sorted(t.signature() for t in terms))
                    g = or_group_of.get(key)
                    if g is None:
                        g = len(or_masks)
                        or_group_of[key] = g
                        ok = np.zeros(nn, bool)
                        for t in terms:
                            ok |= term_mask(t)
                        or_masks.append(ok)
                    task_or_group[ti] = g
            if do_score and task.affinity_preferred:
                key = tuple(sorted(
                    (as_node_term(m).signature(), w)
                    for m, w in task.affinity_preferred))
                g = na_group_of.get(key)
                if g is None:
                    g = len(na_rows)
                    na_group_of[key] = g
                    row = np.zeros(nn, np.float32)
                    for match, weight in task.affinity_preferred:
                        row += (np.float32(na_weight * weight)
                                * term_mask(match))
                    na_rows.append(row.astype(np.float32))
                task_na_group[ti] = g
    return dict(
        task_or_group=task_or_group,
        or_masks=(np.stack(or_masks) if or_masks
                  else np.zeros((0, nn), bool)),
        task_na_group=task_na_group,
        na_rows=(np.stack(na_rows) if na_rows
                 else np.zeros((0, nn), np.float32)),
    )


def port_volume_sections(cluster, node_index: Dict[str, int],
                         task_index: Dict[str, int]) -> Dict[str, object]:
    """NodePorts + volume-binding host sections (predicates.go:191 and the
    defaultVolumeBinder seam, cache.go:240-272).

    Returns dict with:
      task_ports: {ti: sorted list} pending tasks' host ports;
      node_ports: {ni: sorted list} ports already used on nodes;
      n_pending_ports: total pending port count (sizes the in-cycle
        placement buffer);
      vol_ok bool[nt], vol_node i32[nt].
    """
    nt = len(task_index)
    task_ports: Dict[int, list] = {}
    node_ports: Dict[int, set] = {}
    vol_ok = np.ones(nt, bool)
    vol_node = np.full(nt, -1, np.int32)
    n_pending_ports = 0
    for job in cluster.jobs.values():
        for uid, task in job.tasks.items():
            ti = task_index.get(uid)
            if ti is None or ti >= nt:
                continue
            if task.host_ports:
                if task.node_name in node_index:
                    node_ports.setdefault(
                        node_index[task.node_name],
                        set()).update(task.host_ports)
                else:
                    task_ports[ti] = list(task.host_ports)
                    n_pending_ports += len(task.host_ports)
            for claim in task.pvcs:
                pvc = cluster.pvcs.get(claim)
                if pvc is None or not pvc.bindable:
                    vol_ok[ti] = False
                elif pvc.node_name:
                    ni = node_index.get(pvc.node_name, -1)
                    if ni < 0:
                        vol_ok[ti] = False
                    elif vol_node[ti] >= 0 and vol_node[ti] != ni:
                        vol_ok[ti] = False   # claims pin to two nodes
                    else:
                        vol_node[ti] = ni
    return dict(task_ports={ti: sorted(p) for ti, p in task_ports.items()},
                node_ports={ni: sorted(p) for ni, p in node_ports.items()},
                n_pending_ports=n_pending_ports,
                vol_ok=vol_ok, vol_node=vol_node)


def apply_port_volume_sections(extras, sec: Dict[str, object], snap) -> None:
    """Pad the port/volume sections to the snapshot's device buckets and
    install them on an AllocateExtras."""
    from ..arrays.schema import bucket
    N = np.asarray(snap.nodes.pod_count).shape[0]
    T = np.asarray(snap.tasks.status).shape[0]
    task_ports: Dict[int, list] = sec["task_ports"]
    node_ports: Dict[int, list] = sec["node_ports"]
    HP = bucket(max((len(p) for p in task_ports.values()), default=1), 1)
    PS = bucket(max((len(p) for p in node_ports.values()), default=1), 1)
    tp = np.zeros((T, HP), np.int32)
    for ti, ports in task_ports.items():
        tp[ti, :len(ports)] = ports[:HP]
    npo = np.zeros((N, PS), np.int32)
    for ni, ports in node_ports.items():
        npo[ni, :len(ports)] = ports[:PS]
    PE = bucket(max(int(sec["n_pending_ports"]), 1), 8)
    vol_ok = np.ones(T, bool)
    vol_ok[:len(sec["vol_ok"])] = sec["vol_ok"]
    vol_node = np.full(T, -1, np.int32)
    vol_node[:len(sec["vol_node"])] = sec["vol_node"]
    extras.task_ports = tp
    extras.node_ports = npo
    extras.pe_node0 = np.full(PE, -1, np.int32)
    extras.pe_port0 = np.zeros(PE, np.int32)
    extras.task_volume_ok = vol_ok
    extras.task_volume_node = vol_node


def apply_affinity_sections(extras, sec: Dict[str, np.ndarray], snap,
                            n_nodes: int) -> None:
    """Pad the node-affinity sections to device buckets and install them:
    per-task OR-group masks plus per-template preferred score rows (the
    template gather the kernel performs; templates split by preferred-term
    signature, so a template's representative decides its row exactly)."""
    from ..arrays.schema import bucket
    T = np.asarray(snap.tasks.status).shape[0]
    task_or = sec["task_or_group"]
    or_masks = sec["or_masks"]
    if or_masks.shape[0]:
        Nfull = np.asarray(extras.or_feasible).shape[1]
        GR = bucket(or_masks.shape[0], 1)
        feas = np.ones((GR, Nfull), bool)
        feas[:or_masks.shape[0], :n_nodes] = or_masks
        feas[:or_masks.shape[0], n_nodes:] = False  # padded nodes never match
        tg = np.full(T, -1, np.int32)
        tg[:len(task_or)] = task_or
        extras.task_or_group = tg
        extras.or_feasible = feas
    na_rows = sec["na_rows"]
    if na_rows.shape[0]:
        task_na = sec["task_na_group"]
        rep = np.asarray(snap.template_rep)
        score = np.asarray(extras.template_na_score).copy()
        for p, ti in enumerate(rep.tolist()):
            if ti < 0 or ti >= len(task_na):
                continue
            g = int(task_na[ti])
            if g >= 0:
                score[p, :n_nodes] += na_rows[g]
        extras.template_na_score = score.astype(np.float32)


def conf_na_weight(conf) -> Tuple[float, bool]:
    """(nodeaffinity.weight if the nodeorder plugin is enabled else 0,
    predicates enabled?) from a SchedulerConfiguration: the two knobs the
    affinity sections depend on."""
    no = conf.plugin_option("nodeorder") if conf is not None else None
    pred = (conf.plugin_option("predicates") is not None
            if conf is not None else False)
    w = 0.0
    if no is not None:
        v = no.get_argument("nodeaffinity.weight")
        try:
            w = float(v) if v is not None else 1.0
        except (TypeError, ValueError):
            w = 1.0
    return w, pred
