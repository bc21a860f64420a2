"""Sequential CPU reference of the allocate pass.

An independent numpy re-implementation of the reference Go scheduler's
allocate loop (pkg/scheduler/actions/allocate/allocate.go:43-281 +
statement.go commit/discard), kept deliberately loop-structured the way the Go
code is: the port's copy of ``volcano_tpu/runtime/cpu_reference.py``
(``allocate_cpu`` and its helpers), on the port's snapshot (tensors, read
on the host as numpy arrays). Its roles:

1. Decision-equivalence oracle for the port's card path: both must produce
   identical bind decisions on the same packed snapshot.
2. The host entry point ``framework.session.Session.run_allocate_oracle``,
   which runs only when a caller asks for it.

Like the reference, the drf and hdrf ordering keys delegate to the
fair-share functions of the port (``ops/fairshare.py``, run on the host)
so the oracle's keys are the cycle's bit for bit; everything else is
numpy. The predicate families, unplaced reasons and wave histogram width
of the telemetry mirror are copies of the reference's
``telemetry/cycle.py`` constants.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..arrays.labels import (EFFECT_NO_EXECUTE, EFFECT_NO_SCHEDULE,
                             EFFECT_PREFER_NO_SCHEDULE, TOL_EXISTS_ALL,
                             TOL_EXISTS_KEY)
from ..arrays.schema import SnapshotArrays, to_device
from ..ops.allocate_scan import (MODE_ALLOCATED, MODE_NONE, MODE_PIPELINED,
                                 AllocateConfig, AllocateExtras,
                                 normalize_wave, wave_candidate_depth)

_EPS = 1e-5

#: predicate families of the per-task node filter, in the order the
#: rejection counters index them (the reference's telemetry/cycle.py)
PRED_FAMILIES = (
    "template", "tdm", "node_affinity", "volume", "locked", "ports",
    "pod_count", "gpu", "fit_now", "fit_future", "pod_affinity",
)
#: end-of-cycle classification of pending non-best-effort tasks that got
#: no placement (the reference's telemetry/cycle.py)
UNPLACED_REASONS = ("job_not_popped", "job_failed", "job_kept_leftover")
#: committed-per-wave histogram width, the last bucket saturating
WAVE_BINS = 17


def _np(x):
    return np.asarray(x)


def _fairshare(fn, *args):
    """A port fair-share function on host arrays: each numpy argument as a
    CPU tensor (the others as they are), the result as numpy."""
    import torch
    return fn(*(torch.from_numpy(np.ascontiguousarray(a))
                if isinstance(a, np.ndarray) else a for a in args)).numpy()


def _as_np(nodes):
    """One-time numpy view of the node tensors (hoisted out of the hot
    loop so the CPU baseline is not penalized by per-call conversions)."""
    from types import SimpleNamespace
    return SimpleNamespace(
        valid=np.asarray(nodes.valid), schedulable=np.asarray(nodes.schedulable),
        pod_count=np.asarray(nodes.pod_count), max_pods=np.asarray(nodes.max_pods),
        labels=np.asarray(nodes.labels), taint_kv=np.asarray(nodes.taint_kv),
        taint_key=np.asarray(nodes.taint_key),
        taint_effect=np.asarray(nodes.taint_effect),
        allocatable=np.asarray(nodes.allocatable),
        gpu_memory=np.asarray(nodes.gpu_memory),
        gpu_used=np.asarray(nodes.gpu_used))


def _feasible_one(nodes, resreq, sel, th, te, tm, avail, pods_extra,
                  gpu_req=0.0, gpu_extra=None):
    N = avail.shape[0]
    ok = nodes.valid & nodes.schedulable
    ok &= (nodes.pod_count + pods_extra) < nodes.max_pods
    ok &= np.all(resreq[None, :] <= avail + _EPS, axis=-1)
    if gpu_req > 0:
        gidle = nodes.gpu_memory - nodes.gpu_used
        if gpu_extra is not None:
            gidle = gidle - gpu_extra
        ok &= np.any(gidle >= gpu_req - _EPS, axis=-1)
    labels = nodes.labels
    for s in sel:
        if s != 0:
            ok &= np.any(labels == s, axis=-1)
    kv, key, eff = nodes.taint_kv, nodes.taint_key, nodes.taint_effect
    has_hard = np.isin(eff, (EFFECT_NO_SCHEDULE, EFFECT_NO_EXECUTE)).any(axis=-1)
    for n in range(N):
        if not ok[n] or not has_hard[n]:
            continue
        for e in range(kv.shape[1]):
            if eff[n, e] not in (EFFECT_NO_SCHEDULE, EFFECT_NO_EXECUTE):
                continue
            tolerated = False
            for o in range(len(th)):
                if tm[o] == TOL_EXISTS_ALL and th[o] != 0:
                    match = True
                elif tm[o] == TOL_EXISTS_KEY:
                    match = key[n, e] == th[o]
                else:
                    match = kv[n, e] == th[o] and th[o] != 0
                if match and (te[o] == 0 or te[o] == eff[n, e]):
                    tolerated = True
                    break
            if not tolerated:
                ok[n] = False
                break
    return ok


def _score_one(cfg: AllocateConfig, nodes, resreq, idle, th, te, tm):
    allocatable = nodes.allocatable
    used = allocatable - idle
    N = idle.shape[0]
    score = np.zeros(N)
    if cfg.binpack_weight:
        applicable = (resreq > 0)[None, :] & (allocatable > 0)
        frac = np.divide(used + resreq[None, :], allocatable,
                         out=np.zeros_like(used), where=allocatable > 0)
        w = np.ones_like(resreq)[None, :] * applicable
        wsum = np.maximum(w.sum(-1), 1e-9)
        raw = (np.where(applicable, frac, 0) * w).sum(-1) / wsum
        raw = np.where((np.where(applicable, frac, 0) > 1 + 1e-6).any(-1), 0, raw)
        score += cfg.binpack_weight * raw * 100
    if cfg.least_allocated_weight:
        cap = np.maximum(allocatable, 1e-9)
        free = np.clip((allocatable - used - resreq[None, :]) / cap, 0, 1)
        counted = allocatable > 0
        n = np.maximum(counted.sum(-1), 1)
        score += cfg.least_allocated_weight * (free * counted).sum(-1) / n * 100
    if cfg.most_allocated_weight:
        cap = np.maximum(allocatable, 1e-9)
        uf = np.clip((used + resreq[None, :]) / cap, 0, 1)
        counted = allocatable > 0
        n = np.maximum(counted.sum(-1), 1)
        score += cfg.most_allocated_weight * (uf * counted).sum(-1) / n * 100
    if cfg.balanced_weight:
        cap = np.maximum(allocatable, 1e-9)
        frac = np.clip((used + resreq[None, :]) / cap, 0, 1)
        counted = (allocatable > 0).astype(float)
        n = np.maximum(counted.sum(-1), 1.0)
        mean = (frac * counted).sum(-1) / n
        var = (((frac - mean[:, None]) ** 2) * counted).sum(-1) / n
        score += cfg.balanced_weight * (1.0 - np.sqrt(var)) * 100
    if cfg.taint_prefer_weight:
        kv, key, eff = nodes.taint_kv, nodes.taint_key, nodes.taint_effect
        intol = np.zeros(N)
        has_prefer = (eff == EFFECT_PREFER_NO_SCHEDULE).any(axis=-1)
        for n in range(N):
            if not has_prefer[n]:
                continue
            for e in range(kv.shape[1]):
                if eff[n, e] != EFFECT_PREFER_NO_SCHEDULE:
                    continue
                tolerated = False
                for o in range(len(th)):
                    if tm[o] == TOL_EXISTS_ALL and th[o] != 0:
                        match = True
                    elif tm[o] == TOL_EXISTS_KEY:
                        match = key[n, e] == th[o]
                    else:
                        match = kv[n, e] == th[o] and th[o] != 0
                    if match and (te[o] == 0 or te[o] == eff[n, e]):
                        tolerated = True
                        break
                if not tolerated:
                    intol[n] += 1
        mx = max(intol.max(), 1)
        score += cfg.taint_prefer_weight * (1.0 - intol / mx) * 100
    return score


def _affinity_state(extras):
    """Mutable affinity-count state mirroring the kernel's scan carry
    (node-space encoding, arrays/affinity.py)."""
    aff = extras.affinity
    return {
        "sk_sel": np.asarray(aff.sk_sel),
        "sk_domain": np.asarray(aff.sk_domain),
        "task_match": np.asarray(aff.task_match),
        "aff_cnt": np.asarray(aff.cnt0, np.float64).copy(),
        "anti_cnt": np.asarray(aff.anti_cnt0, np.float64).copy(),
        "t_aff_sk": np.asarray(aff.task_aff_sk),
        "t_anti": np.asarray(aff.task_anti_term),
        "eta_sel": np.asarray(aff.eta_sel),
        "eta_sk": np.asarray(aff.eta_sk),
        "eta_domain": np.asarray(aff.eta_domain),
        "t_pref_sk": np.asarray(aff.task_pref_sk),
        "t_pref_w": np.asarray(aff.task_pref_w),
        "static_pref": np.asarray(aff.static_pref),
    }


def _affinity_one(st, t, valid_nodes):
    """Sequential mirror of ops.allocate_scan._affinity_terms: per-node
    feasibility + 0..100 normalized preferred score for task ``t``."""
    N = st["sk_domain"].shape[1]
    feas = np.ones(N, bool)
    # required affinity (with the k8s first-pod escape)
    for a in range(st["t_aff_sk"].shape[1]):
        p = st["t_aff_sk"][t, a]
        if p < 0:
            continue
        dom = st["sk_domain"][p]
        have = st["aff_cnt"][p, :N]
        ok = (have > 0) & (dom >= 0)
        if st["aff_cnt"][p, N] == 0 and st["task_match"][st["sk_sel"][p], t]:
            ok = ok | (dom >= 0)
        feas &= ok
    # own required anti-affinity
    for b in range(st["t_anti"].shape[1]):
        e = st["t_anti"][t, b]
        if e < 0:
            continue
        dom = st["eta_domain"][e]
        have = st["aff_cnt"][st["eta_sk"][e], :N]
        feas &= ~((have > 0) & (dom >= 0))
    # placed pods' anti terms vs this task (symmetric)
    for e in range(len(st["eta_sel"])):
        s = st["eta_sel"][e]
        if s < 0 or not st["task_match"][s, t]:
            continue
        dom = st["eta_domain"][e]
        feas &= ~((st["anti_cnt"][e] > 0) & (dom >= 0))
    # preferred terms
    raw = np.zeros(N)
    for i in range(st["t_pref_sk"].shape[1]):
        p = st["t_pref_sk"][t, i]
        if p < 0:
            continue
        dom = st["sk_domain"][p]
        raw += st["t_pref_w"][t, i] * np.where(
            dom >= 0, st["aff_cnt"][p, :N], 0)
    for s in range(st["task_match"].shape[0]):
        if st["task_match"][s, t]:
            raw += st["static_pref"][s]
    mx = np.max(np.where(valid_nodes, raw, -np.inf))
    mn = np.min(np.where(valid_nodes, raw, np.inf))
    span = mx - mn
    norm = ((raw - mn) * (100.0 / max(span, 1e-9))
            if np.isfinite(span) and span > 0 else np.zeros(N))
    return feas, norm


def _affinity_place(st, t, node):
    """Mirror of _affinity_place_update: account a placement by adding
    domain-membership mask rows."""
    N = st["sk_domain"].shape[1]
    for p in range(len(st["sk_sel"])):
        s = st["sk_sel"][p]
        if s < 0 or not st["task_match"][s, t]:
            continue
        d = st["sk_domain"][p, node]
        if d < 0:
            continue
        st["aff_cnt"][p, :N][st["sk_domain"][p] == d] += 1.0
        st["aff_cnt"][p, N] += 1.0
    for b in range(st["t_anti"].shape[1]):
        e = st["t_anti"][t, b]
        if e < 0:
            continue
        dom = st["eta_domain"][e]
        d = dom[node]
        if d >= 0:
            st["anti_cnt"][e][dom == d] += 1.0


def _hdrf_keys(hier, job_alloc, job_req, job_valid, total):
    """Per-queue hdrf level keys for the current live job allocations.

    Delegates to ops.fairshare.hdrf_level_keys (run on host arrays) so the
    oracle's ordering keys are BIT-identical to the kernel's — the key
    VALUES are independently validated against a recursive transliteration
    of drf.go in tests/test_hdrf.py; what this oracle checks is the pop
    loop's mechanics around them."""
    from ..ops.fairshare import hdrf_level_keys
    return _fairshare(hdrf_level_keys, hier,
                      np.asarray(job_alloc, np.float32), job_req, job_valid,
                      total)


def _tmpl_ok(nodes, sel, th, te, tm) -> np.ndarray:
    """bool[N]: the selector+taints static template row alone (the
    'template' telemetry family) — predicates.static_feasible minus the
    valid/schedulable gate, loop-structured like the rest of the oracle."""
    N = nodes.labels.shape[0]
    ok = np.ones(N, bool)
    for s in sel:
        if s != 0:
            ok &= np.any(nodes.labels == s, axis=-1)
    kv, key, eff = nodes.taint_kv, nodes.taint_key, nodes.taint_effect
    has_hard = np.isin(eff, (EFFECT_NO_SCHEDULE,
                             EFFECT_NO_EXECUTE)).any(axis=-1)
    for n in range(N):
        if not has_hard[n]:
            continue
        for e in range(kv.shape[1]):
            if eff[n, e] not in (EFFECT_NO_SCHEDULE, EFFECT_NO_EXECUTE):
                continue
            tolerated = False
            for o in range(len(th)):
                if tm[o] == TOL_EXISTS_ALL and th[o] != 0:
                    match = True
                elif tm[o] == TOL_EXISTS_KEY:
                    match = key[n, e] == th[o]
                else:
                    match = kv[n, e] == th[o] and th[o] != 0
                if match and (te[o] == 0 or te[o] == eff[n, e]):
                    tolerated = True
                    break
            if not tolerated:
                ok[n] = False
                break
    return ok


def _tie_count(score, feas) -> int:
    """Sequential mirror of ops.select.tie_count on the chosen view."""
    if not feas.any():
        return 0
    msk = np.where(feas, score, -np.inf)
    return int(((msk == msk.max()) & feas).sum()) - 1


def allocate_cpu(snap: SnapshotArrays, extras: AllocateExtras = None,
                 cfg: AllocateConfig = AllocateConfig(),
                 collect_telemetry: bool = False) -> Dict[str, np.ndarray]:
    """Run the allocate pass sequentially on the host. Returns the same
    decision arrays as ops.allocate_scan (task_node, task_mode, job_ready,
    job_pipelined).

    ``collect_telemetry`` additionally mirrors the kernel's in-graph
    CycleTelemetry block (telemetry/cycle.py) — per-family rejection
    counts, attempts, placements, discards, ties, rounds/pops, committed
    f32 sums, unplaced-reason histogram — under "telemetry" in the result.
    The mirror also replays the kernel's capacity-give-up short-circuit
    (hopeless jobs batch-finish after a stalled round WITHOUT being
    evaluated), which is decision-neutral but counter-relevant; with the
    flag off the oracle's historical behavior is byte-identical."""
    if extras is None:
        extras = AllocateExtras.neutral(snap)
    # the port's snapshot and extras are tensors, possibly on a card: the
    # oracle reads host copies
    snap, extras = to_device(snap, "cpu"), to_device(extras, "cpu")
    # wavefront width (ISSUE 16): normalize_wave is the single authority
    # for legal widths (pod-affinity / host-ports force W back to 1, like
    # the kernel); W > 1 swaps the section walk for the wave mirror below
    cfg = normalize_wave(cfg)
    wave_w = int(cfg.wave_width)
    wave_c = wave_candidate_depth(wave_w)
    job_share = np.asarray(extras.job_share)
    queue_deserved = np.asarray(extras.queue_deserved)
    ns_share = np.asarray(extras.ns_share)
    queue_share_extra = np.asarray(extras.queue_share_extra)
    block_nonrevocable = np.asarray(extras.block_nonrevocable)
    block_all = np.asarray(extras.block_all)
    task_revocable = np.asarray(extras.task_revocable)
    tdm_bonus = np.asarray(extras.tdm_bonus)
    template_na = np.asarray(extras.template_na_score)
    task_or_group = np.asarray(extras.task_or_group)
    or_feasible = np.asarray(extras.or_feasible)
    task_ports_a = np.asarray(extras.task_ports)
    node_ports_a = np.asarray(extras.node_ports)
    vol_ok = np.asarray(extras.task_volume_ok)
    vol_node = np.asarray(extras.task_volume_node)
    ports_placed: List[Tuple[int, int]] = []    # (node, port) this cycle
    task_pref_node = np.asarray(extras.task_pref_node)
    node_locked = np.asarray(extras.node_locked)
    target_job = int(extras.target_job)
    nodes, tasks, jobs, queues = snap.nodes, snap.tasks, snap.jobs, snap.queues
    N, R = np.array(nodes.idle).shape
    T = np.array(tasks.resreq).shape[0]
    J, M = np.array(jobs.task_table).shape

    idle = np.array(nodes.idle, dtype=np.float64).copy()
    pipe_extra = np.zeros((N, R))
    pods_extra = np.zeros(N, np.int64)
    G = np.array(nodes.gpu_memory).shape[1]
    gpu_extra = np.zeros((N, G))
    queue_allocated = np.array(queues.allocated, dtype=np.float64).copy()
    task_node = np.full(T, -1, np.int64)
    task_mode = np.zeros(T, np.int64)
    task_gpu = np.full(T, -1, np.int64)
    job_done = np.zeros(J, bool)
    job_ready = np.zeros(J, bool)
    job_pipelined = np.zeros(J, bool)
    job_popped = np.zeros(J, bool)

    jns = np.array(jobs.namespace)
    jvalid_all = np.array(jobs.valid)
    jvalid = jvalid_all & np.array(jobs.schedulable)
    n_pending = np.array(jobs.n_pending)
    jqueue = np.array(jobs.queue)
    jprio = np.array(jobs.priority)
    jrank = np.array(jobs.creation_rank)
    jready0 = np.array(jobs.ready_num)
    jmin = np.array(jobs.min_available)
    table = np.array(jobs.task_table)
    jreq32 = np.array(jobs.total_request, np.float32)
    total_cap = np.array(snap.cluster_capacity, np.float32)
    resreq32 = np.array(tasks.resreq, np.float32)
    ns_weight = np.array(snap.namespace_weight, np.float32)
    # live drf state (event-handler analog): committed allocations +
    # ReadyTaskNum, float32 accumulated in kernel order for bit-equality
    job_cursor = np.zeros(J, np.int64)
    job_alloc_count = np.zeros(J, np.int64)
    job_alloc_dyn = np.array(jobs.allocated, np.float32).copy()
    releasing = np.array(nodes.releasing)
    pipelined0 = np.array(nodes.pipelined)
    resreq = np.array(tasks.resreq, dtype=np.float64)
    best_effort = np.array(tasks.best_effort)
    tjob = np.array(tasks.job)
    t_selector = np.array(tasks.selector)
    t_tol_hash = np.array(tasks.tol_hash)
    t_tol_effect = np.array(tasks.tol_effect)
    t_tol_mode = np.array(tasks.tol_mode)
    t_template = np.array(tasks.template)
    t_preemptable = np.array(tasks.preemptable)
    t_gpu_req = np.array(tasks.gpu_request, dtype=np.float64)
    nodes_np = _as_np(nodes)
    aff_st = _affinity_state(extras) if cfg.enable_pod_affinity else None
    valid_sched = nodes_np.valid & nodes_np.schedulable

    def _pick_gpu(node, req):
        """Lowest fitting card on the node (predicateGPU, gpu.go:41-56)."""
        if req <= 0:
            return -1
        gidle = (nodes_np.gpu_memory[node] - nodes_np.gpu_used[node]
                 - gpu_extra[node])
        for g in range(G):
            if gidle[g] >= req - _EPS:
                return g
        return -1

    def _wave_eval(ji, t, idle_v, pipe_v, pods_v, gpux_v):
        """Both feasibility views + score of task t against an arbitrary
        capacity state (the wave mirror evaluates every slot twice: the
        window-start snapshot for the candidate lists / TEL rows, the
        live state for the actual commit decision)."""
        sel, th = t_selector[t], t_tol_hash[t]
        te, tm = t_tol_effect[t], t_tol_mode[t]
        req, greq = resreq[t], t_gpu_req[t]
        node_ok = (~(block_nonrevocable & ~task_revocable[t])
                   & ~block_all
                   & (or_feasible[task_or_group[t]][:N]
                      if task_or_group[t] >= 0 else True)
                   & vol_ok[t]
                   & ((vol_node[t] < 0) | (np.arange(N) == vol_node[t]))
                   & (~node_locked | np.bool_(ji == target_job)))
        f_now = node_ok & _feasible_one(nodes_np, req, sel, th, te, tm,
                                        idle_v, pods_v, greq, gpux_v)
        fut_v = np.maximum(idle_v + releasing - pipelined0 - pipe_v, 0.0)
        f_fut = node_ok & _feasible_one(nodes_np, req, sel, th, te, tm,
                                        fut_v, pods_v, greq, gpux_v)
        score = _score_one(cfg, nodes_np, req, idle_v, th, te, tm)
        score = score + (template_na[t_template[t]]
                         + (tdm_bonus if task_revocable[t]
                            else np.float32(0.0)))
        if task_pref_node[t] >= 0:
            score = score + 100.0 * (np.arange(N) == task_pref_node[t])
        return f_now, f_fut, score

    def _wave_tel_row(ji, t, idle_v, pipe_v, pods_v, gpux_v):
        """The sequential loop's per-family rejection block, against the
        wave's window-start snapshot (kernel _wave_rej1: a replayed slot
        is counted in the wave that finally processes it, vs THAT wave's
        start state). Ports/affinity slots are structurally 0: both
        features force wave_width back to 1 (normalize_wave)."""
        sel, th = t_selector[t], t_tol_hash[t]
        te, tm = t_tol_effect[t], t_tol_mode[t]
        req, greq = resreq[t], t_gpu_req[t]
        live = valid_sched
        tmpl = _tmpl_ok(nodes_np, sel, th, te, tm)
        blk = (block_nonrevocable & ~task_revocable[t]) | block_all
        orr = (or_feasible[task_or_group[t]][:N]
               if task_or_group[t] >= 0 else np.ones(N, bool))
        volr = vol_ok[t] & ((vol_node[t] < 0)
                            | (np.arange(N) == vol_node[t]))
        lockr = node_locked & ~np.bool_(ji == target_job)
        pcf = (nodes_np.pod_count + pods_v) < nodes_np.max_pods
        gidle2 = nodes_np.gpu_memory - nodes_np.gpu_used - gpux_v
        gfit = (greq <= 0) | (gidle2 >= greq - _EPS).any(axis=-1)
        fit_n = np.all(req[None, :] <= idle_v + _EPS, axis=-1)
        fut_v = np.maximum(idle_v + releasing - pipelined0 - pipe_v, 0.0)
        fit_f = np.all(req[None, :] <= fut_v + _EPS, axis=-1)
        tel["pred_reject"] += np.asarray([
            int((live & ~tmpl).sum()), int((live & blk).sum()),
            int((live & ~orr).sum()), int((live & ~volr).sum()),
            int((live & lockr).sum()), 0,
            int((live & ~pcf).sum()), int((live & ~gfit).sum()),
            int((live & ~fit_n).sum()), int((live & ~fit_f).sum()), 0])
        tel["attempts"] += 1

    def _wave_section(ji, slot0, ready0_dyn, can_batch, placed):
        """Wavefront transliteration of one popped job's section walk
        (ISSUE 16). Decision-wise this IS the sequential walk: the wave
        commit rule is order-preserving by construction (capacity is
        monotone non-increasing inside a section, so untouched rows keep
        their window-start feasibility/score exactly; touched nodes are
        rescored at the live state; a slot whose pre-wave top-C list is
        exhausted by same-wave commits truncates the wave and replays),
        which lets the mirror commit via the plain live-state argmax.
        What the wave structure adds is the COUNTERS: waves / commits /
        truncations / replays / the per-wave histogram exist only here,
        and TEL rows are counted in the wave that finally processes a
        slot, against that wave's window-start snapshot — exactly like
        the kernel's _wave_body. Returns the new absolute cursor plus
        the section tallies the gang finalize consumes."""
        placed_sum32 = np.zeros(len(total_cap), np.float32)
        n_alloc = n_pipe = 0
        stopped = broke = False
        wpos = slot0
        n_adv = 0
        while wpos < M and not stopped and not broke:
            idle0 = idle.copy()
            pipe0 = pipe_extra.copy()
            pods0 = pods_extra.copy()
            gpux0 = gpu_extra.copy()
            touched: List[int] = []
            trunc = False
            trunc_pos = wave_w
            commits = 0
            for w in range(wave_w):
                s_abs = wpos + w
                if s_abs >= M or stopped or broke:
                    continue
                t = int(table[ji, s_abs])
                if t < 0:
                    continue
                if best_effort[t]:
                    if not trunc:
                        n_adv += 1     # consumed, never queued
                    continue
                if trunc:
                    # deferred: replays at the next wave's window head
                    if collect_telemetry:
                        tel["wave_replays"] += 1
                    continue
                # pre-wave candidate lists vs the window-start snapshot:
                # feasible nodes by (score desc, index asc), top-C kept
                f_n0, f_f0, sc0 = _wave_eval(ji, t, idle0, pipe0,
                                             pods0, gpux0)
                order = np.lexsort((np.arange(N), -sc0))
                lst_n = [int(i) for i in order if f_n0[i]]
                tset = set(touched)
                dec_n = (any(e not in tset for e in lst_n[:wave_c])
                         or len(lst_n) <= wave_c)
                if cfg.enable_pipelining:
                    lst_f = [int(i) for i in order if f_f0[i]]
                    dec_f = (any(e not in tset for e in lst_f[:wave_c])
                             or len(lst_f) <= wave_c)
                # live-state views (== the kernel's list resolve: first
                # untouched entry vs every touched node rescored)
                f_nc, f_fc, scc = _wave_eval(ji, t, idle, pipe_extra,
                                             pods_extra, gpu_extra)
                fnd_n = bool(f_nc.any())
                if cfg.enable_pipelining:
                    conflict = (not dec_n) or (not fnd_n and not dec_f)
                else:
                    conflict = not dec_n
                if conflict:
                    trunc = True
                    trunc_pos = w
                    if collect_telemetry:
                        tel["wave_replays"] += 1
                    continue
                do_alloc = fnd_n
                do_pipe = (not fnd_n and cfg.enable_pipelining
                           and bool(f_fc.any()))
                if collect_telemetry:
                    _wave_tel_row(ji, t, idle0, pipe0, pods0, gpux0)
                n_adv += 1
                if not (do_alloc or do_pipe):
                    broke = True        # allocate.go:210-214
                    continue
                req, greq = resreq[t], t_gpu_req[t]
                feas_c = f_nc if do_alloc else f_fc
                node = int(np.argmax(np.where(feas_c, scc, -np.inf)))
                if do_alloc:
                    idle[node] -= req
                    task_mode[t] = MODE_ALLOCATED
                    n_alloc += 1
                else:
                    pipe_extra[node] += req
                    task_mode[t] = MODE_PIPELINED
                    n_pipe += 1
                pods_extra[node] += 1
                card = _pick_gpu(node, greq)
                if card >= 0:
                    gpu_extra[node, card] += greq
                    task_gpu[t] = card
                task_node[t] = node
                placed.append(t)
                placed_sum32 = placed_sum32 + resreq32[t]
                touched.append(node)
                commits += 1
                if collect_telemetry:
                    # ties of the fired view, pre-wave raw count (the
                    # kernel reports the sweep's count; exact at the
                    # window head, a cheap upper bound after commits)
                    if do_alloc:
                        tel["placed_now"] += 1
                        tel["argmax_ties"] += _tie_count(sc0, f_n0)
                    else:
                        tel["placed_future"] += 1
                        tel["argmax_ties"] += _tie_count(sc0, f_f0)
                ready_aft = (not cfg.enable_gang
                             or (ready0_dyn + n_alloc) >= jmin[ji])
                remaining = any(table[ji, s] >= 0
                                and not best_effort[table[ji, s]]
                                for s in range(s_abs + 1, M))
                if ready_aft and remaining and not can_batch:
                    stopped = True      # yield (allocate.go:262-265)
            if collect_telemetry:
                tel["wave_hist"][min(commits,
                                     len(tel["wave_hist"]) - 1)] += 1
                tel["wave_commits"] += commits
                if trunc:
                    tel["wave_truncations"] += 1
                tel["waves"] += 1
            wpos += trunc_pos if trunc else wave_w
        return slot0 + n_adv, stopped, placed_sum32, n_alloc, n_pipe

    # telemetry mirror state (telemetry/cycle.CycleTelemetry, kernel order)
    tel = None
    progressed = True
    if collect_telemetry:
        tel = dict(pred_reject=np.zeros(len(PRED_FAMILIES), np.int64),
                   attempts=0, placed_now=0, placed_future=0,
                   gang_discarded=0, argmax_ties=0, rounds=0, pops=0,
                   committed=np.zeros(len(total_cap), np.float32),
                   wave_hist=np.zeros(WAVE_BINS, np.int64),
                   wave_commits=0, wave_truncations=0, wave_replays=0,
                   waves=0)
        # cheapest pending request per job per dim (the kernel's
        # jobs_min_req): min over ALL real table slots, f32
        jobs_min_req = np.where(
            (table >= 0)[:, :, None], resreq32[np.maximum(table, 0)],
            np.inf).min(axis=1)

    while True:
        overused = np.any(queue_allocated > queue_deserved + 1e-6, axis=-1)
        elig = jvalid & ~job_done & (job_cursor < n_pending) & ~overused[jqueue]
        if not elig.any():
            break
        # capacity-give-up mirror (kernel hopeless_jobs): after a stalled
        # round, eligible jobs whose cheapest pending request exceeds every
        # node's idle AND future idle batch-finish without being evaluated
        # — decision-identical, but their pops/attempts never happen, so
        # the telemetry mirror must replay it
        hopeless = np.zeros(J, bool)
        if collect_telemetry and not progressed:
            fut_all = np.maximum(idle + releasing - pipelined0 - pipe_extra,
                                 0.0)
            bound = np.max(np.where(valid_sched[:, None],
                                    np.maximum(idle, fut_all), -np.inf),
                           axis=0)
            hopeless = elig & (jobs_min_req > bound + 1e-5).any(axis=-1)
        qshare = np.max(
            np.where(np.isfinite(queue_deserved) & (queue_deserved > 0),
                     queue_allocated / np.maximum(queue_deserved, 1e-9), 0.0),
            axis=-1) + queue_share_extra
        # drf keys from live allocations (event-handler analog,
        # drf.go:511-536) — delegated to ops.fairshare on host arrays so
        # the oracle's keys stay BIT-identical to the kernel's (same
        # delegation rationale as _hdrf_keys above)
        if cfg.drf_ns_order:
            from ..ops.fairshare import namespace_shares
            ns_share_k = _fairshare(namespace_shares, job_alloc_dyn, jns,
                                    jvalid_all, ns_weight, total_cap)
        else:
            ns_share_k = np.asarray(ns_share, float)
        if cfg.drf_job_order:
            from ..ops.fairshare import drf_job_shares
            job_share_k = _fairshare(drf_job_shares, job_alloc_dyn,
                                     total_cap, jvalid_all)
        else:
            job_share_k = np.asarray(job_share, float)
        ready_dyn = jready0 + job_alloc_count
        ready_now = (ready_dyn >= jmin) & (jmin > 0)
        key_rows = [ns_share_k[jns], jns.astype(float), qshare[jqueue]]
        if cfg.enable_hdrf:
            hcols = _hdrf_keys(extras.hierarchy, job_alloc_dyn, jreq32,
                               jvalid_all, total_cap)
            key_rows += [hcols[jqueue, c] for c in range(hcols.shape[1])]
        key_rows += [jqueue.astype(float), -jprio.astype(float)]
        if cfg.tdm_job_order:
            key_rows.append(np.array(jobs.preemptable).astype(float))
        if cfg.sla_job_order:
            key_rows.append(np.asarray(extras.job_deadline, float))
        key_rows += [ready_now.astype(float), job_share_k,
                     jrank.astype(float)]
        keys = np.stack(key_rows)
        best_ji, best_key = -1, None
        for ji in range(J):
            if not elig[ji]:
                continue
            k = tuple(keys[:, ji])
            if best_key is None or k < best_key:
                best_key, best_ji = k, ji
        ji = best_ji
        # hopeless jobs (minus the popped one, whose fate the evaluation
        # below decides) finish without evaluation, like the kernel's
        # give_up OR into job_done/job_popped before the .at[ji].set
        job_done |= hopeless
        job_popped |= hopeless

        saved = (idle.copy(), pipe_extra.copy(), pods_extra.copy(),
                 gpu_extra.copy())
        saved_ports = list(ports_placed)
        # exact re-pop fusion (see ops/allocate_scan.py body): with fully
        # static ordering keys the same ready job wins every following pop,
        # so the single-task yields batch into one pass
        keys_static = not (cfg.drf_job_order or cfg.drf_ns_order
                           or cfg.enable_hdrf)
        # ANY finite deserved (a 0 counts: zero-quota queues flip overused
        # on the first commit) breaks the static-keys argument
        des_row = queue_deserved[jqueue[ji]]
        can_batch = keys_static and not bool(
            np.any(np.isfinite(des_row)))
        if aff_st is not None:
            saved_aff = (aff_st["aff_cnt"].copy(), aff_st["anti_cnt"].copy())
        placed: List[int] = []
        placed_sum32 = np.zeros(len(total_cap), np.float32)
        n_alloc = n_pipe = 0
        ready0_dyn = int(jready0[ji] + job_alloc_count[ji])
        stopped = False
        slot = int(job_cursor[ji])
        if wave_w > 1:
            (slot, stopped, placed_sum32,
             n_alloc, n_pipe) = _wave_section(ji, slot, ready0_dyn,
                                              can_batch, placed)
        while wave_w == 1 and slot < M:
            t = table[ji, slot]
            if t < 0:
                break               # past the row's real entries
            slot += 1               # the task is popped (consumed)
            if best_effort[t]:
                continue            # never queued (allocate.go:186-195)
            sel = t_selector[t]
            th = t_tol_hash[t]
            te = t_tol_effect[t]
            tm = t_tol_mode[t]
            req = resreq[t]
            greq = t_gpu_req[t]
            node_ok = (~(block_nonrevocable & ~task_revocable[t])
                       & ~block_all
                       & (or_feasible[task_or_group[t]][:len(block_all)]
                          if task_or_group[t] >= 0 else True)
                       & vol_ok[t]
                       & ((vol_node[t] < 0)
                          | (np.arange(N) == vol_node[t]))
                       & (~node_locked | np.bool_(ji == target_job)))
            if cfg.enable_host_ports:
                tports = [p for p in task_ports_a[t] if p > 0]
                if tports:
                    conf_mask = np.zeros(N, bool)
                    for p in tports:
                        conf_mask |= (node_ports_a == p).any(axis=-1)
                    for pn, pp in ports_placed:
                        if pp in tports:
                            conf_mask[pn] = True
                    node_ok &= ~conf_mask
            feas_now = node_ok & _feasible_one(nodes_np, req, sel, th, te, tm,
                                               idle, pods_extra,
                                               greq, gpu_extra)
            score = _score_one(cfg, nodes_np, req, idle, th, te, tm)
            score = score + (template_na[t_template[t]]
                             + (tdm_bonus if task_revocable[t]
                                else np.float32(0.0)))
            if task_pref_node[t] >= 0:
                score = score + 100.0 * (np.arange(len(score)) == task_pref_node[t])
            if aff_st is not None:
                aff_feas, aff_score = _affinity_one(aff_st, t, valid_sched)
                feas_now &= aff_feas
                score = score + cfg.pod_affinity_weight * aff_score
            if collect_telemetry:
                # per-family rejection counts over live nodes, families
                # independent, pre-placement capacity view — the kernel's
                # task_step TEL block, loop-structured
                live = valid_sched
                tmpl = _tmpl_ok(nodes_np, sel, th, te, tm)
                blk = (block_nonrevocable & ~task_revocable[t]) | block_all
                orr = (or_feasible[task_or_group[t]][:N]
                       if task_or_group[t] >= 0 else np.ones(N, bool))
                volr = vol_ok[t] & ((vol_node[t] < 0)
                                    | (np.arange(N) == vol_node[t]))
                lockr = node_locked & ~np.bool_(ji == target_job)
                ports_rej = 0
                if cfg.enable_host_ports:
                    tp2 = [p for p in task_ports_a[t] if p > 0]
                    conf2 = np.zeros(N, bool)
                    for p in tp2:
                        conf2 |= (node_ports_a == p).any(axis=-1)
                    for pn, pp in ports_placed:
                        if pp in tp2:
                            conf2[pn] = True
                    ports_rej = int((live & conf2).sum())
                pcf = (nodes_np.pod_count + pods_extra) < nodes_np.max_pods
                gidle2 = (nodes_np.gpu_memory - nodes_np.gpu_used
                          - gpu_extra)
                gfit = (greq <= 0) | (gidle2 >= greq - _EPS).any(axis=-1)
                fit_n = np.all(req[None, :] <= idle + _EPS, axis=-1)
                fut_v = np.maximum(
                    idle + releasing - pipelined0 - pipe_extra, 0.0)
                fit_f = np.all(req[None, :] <= fut_v + _EPS, axis=-1)
                aff_rej = (int((live & ~aff_feas).sum())
                           if aff_st is not None else 0)
                tel["pred_reject"] += np.asarray([
                    int((live & ~tmpl).sum()), int((live & blk).sum()),
                    int((live & ~orr).sum()), int((live & ~volr).sum()),
                    int((live & lockr).sum()), ports_rej,
                    int((live & ~pcf).sum()), int((live & ~gfit).sum()),
                    int((live & ~fit_n).sum()), int((live & ~fit_f).sum()),
                    aff_rej])
                tel["attempts"] += 1
            did_place = False
            if feas_now.any():
                node = int(np.argmax(np.where(feas_now, score, -np.inf)))
                idle[node] -= req
                pods_extra[node] += 1
                card = _pick_gpu(node, greq)
                if card >= 0:
                    gpu_extra[node, card] += greq
                    task_gpu[t] = card
                task_node[t] = node
                task_mode[t] = MODE_ALLOCATED
                placed.append(t)
                placed_sum32 = placed_sum32 + resreq32[t]
                n_alloc += 1
                did_place = True
                if collect_telemetry:
                    tel["placed_now"] += 1
                    tel["argmax_ties"] += _tie_count(score, feas_now)
                if aff_st is not None:
                    _affinity_place(aff_st, t, node)
                if cfg.enable_host_ports:
                    ports_placed.extend(
                        (node, p) for p in task_ports_a[t] if p > 0)
            elif cfg.enable_pipelining:
                future = np.maximum(idle + releasing - pipelined0 - pipe_extra, 0)
                feas_fut = node_ok & _feasible_one(nodes_np, req, sel, th, te, tm, future,
                                         pods_extra, greq, gpu_extra)
                if aff_st is not None:
                    feas_fut &= aff_feas
                if feas_fut.any():
                    node = int(np.argmax(np.where(feas_fut, score, -np.inf)))
                    pipe_extra[node] += req
                    pods_extra[node] += 1
                    card = _pick_gpu(node, greq)
                    if card >= 0:
                        gpu_extra[node, card] += greq
                        task_gpu[t] = card
                    task_node[t] = node
                    task_mode[t] = MODE_PIPELINED
                    placed.append(t)
                    placed_sum32 = placed_sum32 + resreq32[t]
                    n_pipe += 1
                    did_place = True
                    if collect_telemetry:
                        tel["placed_future"] += 1
                        tel["argmax_ties"] += _tie_count(score, feas_fut)
                    if aff_st is not None:
                        _affinity_place(aff_st, t, node)
                    if cfg.enable_host_ports:
                        ports_placed.extend(
                            (node, p) for p in task_ports_a[t] if p > 0)
            if not did_place:
                # no node can take the task at all -> the job breaks
                # (allocate.go:210-214 PredicateNodes empty)
                break
            # yield: a ready job with tasks still queued re-enters the
            # job queue (allocate.go:262-265)
            ready_aft = (not cfg.enable_gang
                         or (ready0_dyn + n_alloc) >= jmin[ji])
            remaining = any(table[ji, s] >= 0 and not best_effort[table[ji, s]]
                            for s in range(slot, M))
            if ready_aft and remaining and not can_batch:
                stopped = True
                break
        job_cursor[ji] = slot

        ready = (ready0_dyn + n_alloc) >= jmin[ji]
        pipelined = (ready0_dyn + n_alloc + n_pipe) >= jmin[ji]
        if not cfg.enable_gang:
            ready = True
        if ready or pipelined:
            queue_allocated[jqueue[ji]] += resreq[placed].sum(axis=0) if placed else 0
            job_alloc_dyn[ji] = job_alloc_dyn[ji] + placed_sum32
            job_alloc_count[ji] += n_alloc
            job_ready[ji] = bool(ready)
            job_pipelined[ji] = bool(pipelined and not ready)
            if not ready:
                # kept-but-unready gang: capacity held, no binds
                for t in placed:
                    task_mode[t] = MODE_PIPELINED
            if collect_telemetry:
                tel["committed"] = tel["committed"] + placed_sum32
        else:
            idle, pipe_extra, pods_extra, gpu_extra = saved
            if aff_st is not None:
                aff_st["aff_cnt"], aff_st["anti_cnt"] = saved_aff
            ports_placed = saved_ports
            for t in placed:
                task_node[t] = -1
                task_mode[t] = MODE_NONE
                task_gpu[t] = -1
            if collect_telemetry:
                tel["gang_discarded"] += len(placed)
        job_done[ji] = not stopped
        job_popped[ji] = True
        progressed = (n_alloc > 0) or bool(pipelined) or bool(ready)
        if collect_telemetry:
            tel["rounds"] += 1
            tel["pops"] += 1

    out = dict(task_node=task_node, task_mode=task_mode, task_gpu=task_gpu,
               job_ready=job_ready,
               job_pipelined=job_pipelined, job_attempted=job_popped,
               idle=idle,
               queue_allocated=queue_allocated)
    if collect_telemetry:
        from ..api.types import TaskStatus
        t_status = np.array(tasks.status)
        t_valid = np.array(tasks.valid)
        pend = (t_valid & ~best_effort & (tjob >= 0)
                & (t_status == int(TaskStatus.PENDING)))
        unplaced = pend & (task_mode == MODE_NONE)
        popped_t = job_popped[np.maximum(tjob, 0)]
        kept_t = (job_ready | job_pipelined)[np.maximum(tjob, 0)]
        reason = np.where(~popped_t, 0, np.where(kept_t, 2, 1))
        hist = np.zeros(len(UNPLACED_REASONS), np.int64)
        for r in reason[unplaced]:
            hist[r] += 1
        out["telemetry"] = {
            "pred_reject": {f: int(v) for f, v in
                            zip(PRED_FAMILIES, tel["pred_reject"])},
            "unplaced": {r: int(v) for r, v in
                         zip(UNPLACED_REASONS, hist)},
            "committed": [float(v) for v in tel["committed"]],
            "attempts": tel["attempts"],
            "placed_now": tel["placed_now"],
            "placed_future": tel["placed_future"],
            "gang_discarded": tel["gang_discarded"],
            "argmax_ties": tel["argmax_ties"],
            "rounds": tel["rounds"], "pops": tel["pops"],
            "dyn_launches": 0, "dyn_pops": 0, "dyn_early_stops": 0,
            "wave_commits": int(tel["wave_commits"]),
            "wave_truncations": int(tel["wave_truncations"]),
            "wave_replays": int(tel["wave_replays"]),
            "waves": int(tel["waves"]),
            "wave_hist": [int(v) for v in tel["wave_hist"]],
        }
    return out
