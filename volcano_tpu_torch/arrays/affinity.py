"""Inter-pod affinity encoding (node-space form), as the allocate cycle
reads it.

PyTorch counterpart of ``volcano_tpu/arrays/affinity.py`` (numpy, its own
copy): the array program of the k8s InterPodAffinity plugin the reference
wraps (pkg/scheduler/plugins/predicates/predicates.go:196-200 filter
dispatch, 261-273; pkg/scheduler/plugins/nodeorder/nodeorder.go:273-306
batch scorer). Terms select existing pods by label selector and constrain
placement relative to the topology DOMAIN (nodes sharing a label value)
those pods occupy.

All live state is denormalised to the node axis: counts live as
``cnt[SK, N]``, "matching pods within node n's domain", so an attempt reads
rows and a placement adds a domain-membership row
(``sk_domain == sk_domain[:, node]``). SK indexes the distinct (selector,
topology-key) pairs the terms use; column N of ``cnt0`` carries the
cluster-wide matching count on keyed nodes (the k8s first-pod escape).
Symmetric preferred contributions of already-placed pods are folded into
the static ``static_pref[SEL, N]`` map. The allocate cycle carries the
live counts through its round placers (``ops/round_placer.py``,
``ops/dyn_placer.py``) when :attr:`AffinityArrays.has_terms` holds and the
predicates plugin is on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np

from ..api import ClusterInfo, PodAffinityTerm


@dataclass
class AffinityArrays:
    """Axis legend: SK distinct (selector, topology-key) pairs, SEL
    selectors, ETA required anti-affinity terms, A/B/PP per-task term
    slots, N nodes."""

    sk_sel: Any          # i32[SK] selector of each pair, -1 pad
    sk_domain: Any       # i32[SK, N] node's domain id under the pair's key
    cnt0: Any            # f32[SK, N+1] matching-pod counts in node n's
    #                      domain; column N = cluster total (first-pod escape)
    task_match: Any      # bool[SEL, T] selector matches task's labels
    task_aff_sk: Any     # i32[T, A] required affinity pair, -1 pad
    task_anti_term: Any  # i32[T, B] own required anti term (eta), -1
    eta_sel: Any         # i32[ETA] anti term selector, -1 pad
    eta_sk: Any          # i32[ETA] anti term (sel,key) pair id
    eta_domain: Any      # i32[ETA, N] node's domain under the term's key
    anti_cnt0: Any       # f32[ETA, N] pods carrying the term in n's domain
    task_pref_sk: Any    # i32[T, PP] preferred term pair, -1 pad
    task_pref_w: Any     # f32[T, PP] term weight (negative = anti)
    static_pref: Any     # f32[SEL, N] symmetric preferred score map

    @property
    def has_terms(self) -> bool:
        """Whether any task carries any term (host-side)."""
        return bool(
            np.any(np.asarray(self.task_aff_sk) >= 0)
            or np.any(np.asarray(self.task_anti_term) >= 0)
            or np.any(np.asarray(self.eta_sel) >= 0)
            or np.any(np.asarray(self.task_pref_sk) >= 0))

    @classmethod
    def neutral(cls, n_nodes: int, n_tasks: int) -> "AffinityArrays":
        i32, f32 = np.int32, np.float32
        return cls(
            sk_sel=np.full(1, -1, i32),
            sk_domain=np.full((1, n_nodes), -1, i32),
            cnt0=np.zeros((1, n_nodes + 1), f32),
            task_match=np.zeros((1, n_tasks), bool),
            task_aff_sk=np.full((n_tasks, 1), -1, i32),
            task_anti_term=np.full((n_tasks, 1), -1, i32),
            eta_sel=np.full(1, -1, i32),
            eta_sk=np.full(1, -1, i32),
            eta_domain=np.full((1, n_nodes), -1, i32),
            anti_cnt0=np.zeros((1, n_nodes), f32),
            task_pref_sk=np.full((n_tasks, 1), -1, i32),
            task_pref_w=np.zeros((n_tasks, 1), f32),
            static_pref=np.zeros((1, n_nodes), f32),
        )


def _canon_term(term: PodAffinityTerm, own_ns: str) -> Tuple:
    """Canonical selector identity: labels + expressions + resolved
    namespace set (terms with no namespaces match the task's own)."""
    ns = tuple(sorted(term.namespaces)) if term.namespaces else (own_ns,)
    return (
        tuple(sorted(term.match_labels.items())),
        tuple((k, op, tuple(sorted(v)) if isinstance(v, (list, tuple)) else (v,))
              for k, op, v in term.match_expressions),
        ns,
    )


def build_affinity(ci: ClusterInfo, maps,
                   n_nodes: int, n_tasks: int) -> AffinityArrays:
    """Encode every task's inter-pod (anti-)affinity terms for the cycle.

    ``n_nodes``/``n_tasks`` are the bucketed axis sizes of the packed
    snapshot (arrays/pack.py) so the tensors align with it.
    """
    from .schema import bucket
    # cheap term scan first: the overwhelmingly common no-terms snapshot
    # must not pay the indexed task-list build (it showed up in the 1 s
    # cycle budget at 100k tasks)
    import operator
    terms_of = operator.attrgetter(
        "pod_affinity", "pod_anti_affinity", "pod_affinity_preferred",
        "pod_anti_affinity_preferred")
    has_any = False
    for job in ci.jobs.values():
        for t in job.tasks.values():
            a, b, c, d = terms_of(t)
            if a or b or c or d:
                has_any = True
                break
        if has_any:
            break
    if not has_any:
        return AffinityArrays.neutral(n_nodes, n_tasks)
    tasks = []          # (task index, TaskInfo) in packed order
    for job in ci.jobs.values():
        for uid, t in job.tasks.items():
            ti = maps.task_index.get(uid)
            if ti is not None:
                tasks.append((ti, t))

    # ---- term tables -----------------------------------------------------
    sel_index: Dict[Tuple, int] = {}
    sel_terms: List[Tuple[PodAffinityTerm, str]] = []  # (term, own_ns)

    def sel_id(term: PodAffinityTerm, own_ns: str) -> int:
        c = _canon_term(term, own_ns)
        if c not in sel_index:
            sel_index[c] = len(sel_terms)
            sel_terms.append((term, own_ns))
        return sel_index[c]

    sk_index: Dict[Tuple[int, str], int] = {}    # (sel, key) -> sk

    def sk_id(s: int, key: str) -> int:
        if (s, key) not in sk_index:
            sk_index[(s, key)] = len(sk_index)
        return sk_index[(s, key)]

    eta_index: Dict[Tuple[int, str], int] = {}   # (sel, key) -> eta

    def eta_id(s: int, key: str) -> int:
        if (s, key) not in eta_index:
            eta_index[(s, key)] = len(eta_index)
        return eta_index[(s, key)]

    per_task_aff: Dict[int, List[int]] = {}
    per_task_anti: Dict[int, List[int]] = {}
    per_task_pref: Dict[int, List[Tuple[int, float]]] = {}
    for ti, t in tasks:
        for term in t.pod_affinity:
            per_task_aff.setdefault(ti, []).append(
                sk_id(sel_id(term, t.namespace), term.topology_key))
        for term in t.pod_anti_affinity:
            s = sel_id(term, t.namespace)
            sk_id(s, term.topology_key)      # own-anti reads live counts too
            per_task_anti.setdefault(ti, []).append(
                eta_id(s, term.topology_key))
        for term in t.pod_affinity_preferred:
            per_task_pref.setdefault(ti, []).append(
                (sk_id(sel_id(term, t.namespace), term.topology_key),
                 float(term.weight or 1)))
        for term in t.pod_anti_affinity_preferred:
            per_task_pref.setdefault(ti, []).append(
                (sk_id(sel_id(term, t.namespace), term.topology_key),
                 -float(term.weight or 1)))

    # ---- per-key node domains (host-side only) ---------------------------
    keys = sorted({k for (_s, k) in sk_index} | {k for (_s, k) in eta_index}
                  | {t.topology_key
                     for _ti, task in tasks
                     for t in (task.pod_affinity_preferred
                               + task.pod_anti_affinity_preferred
                               + task.pod_affinity + task.pod_anti_affinity)})
    dom_of_key: Dict[str, np.ndarray] = {}
    for k in keys:
        vals: Dict[str, int] = {}
        row = np.full(n_nodes, -1, np.int32)
        for name, ni in maps.node_index.items():
            v = ci.nodes[name].labels.get(k)
            if v is not None:
                row[ni] = vals.setdefault(v, len(vals))
        dom_of_key[k] = row

    # ---- match matrix ----------------------------------------------------
    SEL = bucket(max(len(sel_terms), 1), 1)
    task_match = np.zeros((SEL, n_tasks), bool)
    for s, (term, own_ns) in enumerate(sel_terms):
        for ti, t in tasks:
            task_match[s, ti] = term.matches(t.labels, t.namespace, own_ns)

    # ---- node-space snapshot counts --------------------------------------
    SK = bucket(max(len(sk_index), 1), 1)
    sk_sel = np.full(SK, -1, np.int32)
    sk_domain = np.full((SK, n_nodes), -1, np.int32)
    cnt0 = np.zeros((SK, n_nodes + 1), np.float32)
    # per-selector placed-pod node lists (existing pods on nodes)
    placed_nodes: Dict[int, List[int]] = {}
    for ti, t in tasks:
        ni = maps.node_index.get(t.node_name, -1)
        if ni < 0:
            continue
        for s in range(len(sel_terms)):
            if task_match[s, ti]:
                placed_nodes.setdefault(s, []).append(ni)
    for (s, key), p in sk_index.items():
        sk_sel[p] = s
        dom = dom_of_key[key]
        sk_domain[p] = dom
        for ni in placed_nodes.get(s, ()):
            d = dom[ni]
            if d >= 0:
                cnt0[p, :n_nodes][dom == d] += 1.0
                cnt0[p, n_nodes] += 1.0

    ETA = bucket(max(len(eta_index), 1), 1)
    eta_sel = np.full(ETA, -1, np.int32)
    eta_sk = np.full(ETA, -1, np.int32)
    eta_domain = np.full((ETA, n_nodes), -1, np.int32)
    anti_cnt0 = np.zeros((ETA, n_nodes), np.float32)
    for (s, key), e in eta_index.items():
        eta_sel[e] = s
        eta_sk[e] = sk_index[(s, key)]
        eta_domain[e] = dom_of_key[key]

    static_pref = np.zeros((SEL, n_nodes), np.float32)
    sk_rev = {p: (s, key) for (s, key), p in sk_index.items()}
    for ti, t in tasks:
        ni = maps.node_index.get(t.node_name, -1)
        if ni < 0:
            continue
        # a placed pod's own required anti-affinity terms constrain
        # incoming pods matching them (symmetric anti-affinity)
        for e in per_task_anti.get(ti, ()):
            dom = eta_domain[e]
            d = dom[ni]
            if d >= 0:
                anti_cnt0[e][dom == d] += 1.0
        # a placed pod's preferred terms score incoming pods matching them
        # (symmetric preferred, static over the cycle)
        for p, w in per_task_pref.get(ti, ()):
            s, key = sk_rev[p]
            dom = dom_of_key[key]
            d = dom[ni]
            if d >= 0:
                static_pref[s][dom == d] += w

    # ---- per-task slot tables --------------------------------------------
    A = bucket(max(max((len(v) for v in per_task_aff.values()), default=0), 1), 1)
    B = bucket(max(max((len(v) for v in per_task_anti.values()), default=0), 1), 1)
    PP = bucket(max(max((len(v) for v in per_task_pref.values()), default=0), 1), 1)
    task_aff_sk = np.full((n_tasks, A), -1, np.int32)
    task_anti_term = np.full((n_tasks, B), -1, np.int32)
    task_pref_sk = np.full((n_tasks, PP), -1, np.int32)
    task_pref_w = np.zeros((n_tasks, PP), np.float32)
    for ti, rows in per_task_aff.items():
        for a, p in enumerate(rows):
            task_aff_sk[ti, a] = p
    for ti, rows in per_task_anti.items():
        for b, e in enumerate(rows):
            task_anti_term[ti, b] = e
    for ti, rows in per_task_pref.items():
        for i, (p, w) in enumerate(rows):
            task_pref_sk[ti, i] = p
            task_pref_w[ti, i] = w

    return AffinityArrays(
        sk_sel=sk_sel, sk_domain=sk_domain, cnt0=cnt0,
        task_match=task_match, task_aff_sk=task_aff_sk,
        task_anti_term=task_anti_term, eta_sel=eta_sel, eta_sk=eta_sk,
        eta_domain=eta_domain, anti_cnt0=anti_cnt0,
        task_pref_sk=task_pref_sk, task_pref_w=task_pref_w,
        static_pref=static_pref)
