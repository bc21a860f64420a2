"""Session: one scheduling cycle's world state and pass composer (PyTorch
port of ``volcano_tpu/framework/session.py``: the enqueue, allocate and
backfill passes).

Reference: pkg/scheduler/framework/session.go:38-468 (per-cycle snapshot +
plugin instances + Allocate/Pipeline ops) and framework.go:29-63
(OpenSession/CloseSession). The session
- packs the ClusterInfo snapshot into arrays (the Python packer),
- asks each plugin for its contributions (score weights, fairness arrays,
  gates) and bakes them into AllocateConfig/AllocateExtras,
- uploads the whole snapshot to its device, runs a pass (enqueue,
  allocate or backfill) and reads its result back in one copy,
- and turns the result into PodGroup phase updates (enqueue) or bind and
  pipeline intents (the Statement commit boundary, statement.go:377-395:
  the cycle already committed or discarded each gang, so apply is a
  readout).

The conf's action list runs through ``volcano_tpu_torch.actions``:
``for name in conf.actions: get_action(name).execute(ssn)``.

With conf ``sharding: true`` the allocate cycle splits the node axis over
a mesh of the session's device (``parallel/sharding.py``): one pop and one
attempt at a time through the shard-local candidate kernel, or, with
``wave_width`` W > 1, waves of W attempts through the wide one.

The steady cycle: ``reopen`` starts the next cycle on the same session and
patches the packed snapshot from the jobs and nodes the last cycle (and
``mark_dirty``) touched (``refresh_snapshot``), instead of a full repack.
With conf ``delta_uploads`` (default true) and no mesh, the snapshot lives
on the device across cycles (``ops/fused_io.DeltaKernel``): a cycle ships
only the elements that changed, and an integrity digest checks the
resident buffers against their host mirror.

``run_allocate_oracle`` runs the allocate pass on the host's numpy oracle
(``runtime/cpu_reference.py``) when a caller asks for it; nothing on the
card path falls back to it.

Not carried yet (ROADMAP): pipelined dispatch (depth k, speculation, an
asynchronous pack), the CPU-oracle rung, warm-restart mirrors, chaos
seams, metrics and trace spans (items 2b, 8 and 10); the mesh path's
residency and a mesh over several cards (item 6c); telemetry; and the
preempt and reclaim passes.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api import (ClusterInfo, PodGroupPhase, QueueState, TaskStatus,
                   gpu_request_of, is_allocated_status)
from ..api.resource import Resource
from ..arrays import pack, to_device
from ..arrays.affinity import build_affinity
from ..arrays.hierarchy import build_hierarchy
from ..arrays.pack import queue_capability_row, queue_parent_depth
from ..ops.allocate_scan import (MODE_ALLOCATED, AllocateConfig,
                                 AllocateExtras, cycle_path,
                                 derive_batching, make_allocate_cycle,
                                 unpack_decisions)
from ..ops.backfill import make_backfill_pass
from ..ops.fused_io import ResidentState, delta_cycle_cached, tree_leaves
from ..ops.enqueue import EnqueueConfig, make_enqueue_pass
from .conf import SchedulerConfiguration, parse_conf


@dataclasses.dataclass
class BindIntent:
    """A decided placement to flush to the cluster (cache.Bind seam,
    pkg/scheduler/cache/cache.go:549)."""

    task_uid: str
    job_uid: str
    node_name: str
    gpu_index: int = -1  # shared-GPU card (AddGPUIndexPatch, pod_info.go:154)


#: (cfg, shape signature, device) -> DeltaKernel: the device-resident
#: delta path (conf delta_uploads, default on). Kernels hold no residency
#: and are shared; each Session keeps its own ResidentState.
_DELTA_CACHE: Dict[tuple, object] = {}


@dataclasses.dataclass
class PendingAllocate:
    """A dispatched allocate cycle: the device tensor of its packed
    decisions, read back by :meth:`Session.complete_allocate`, and what
    the drain needs to check and apply them."""

    packed: object              # device tensor (readback deferred)
    cfg: AllocateConfig
    T: int
    J: int
    #: host ms of deriving the cycle's inputs, and of the upload and the
    #: cycle's host loop
    extras_ms: float = 0.0
    dispatch_ms: float = 0.0
    #: the delta path's kernel and residency, and the argument tree the
    #: cycle ran on (a recovery uploads it in full); None on the full path
    kernel: object = None
    state: object = None
    tree: object = None
    #: the changed-rows tail on the device (None: drain in full)
    tail: object = None
    #: ResidentState.dec_epoch at dispatch: another epoch at the drain
    #: means a recovery cut the decisions chain, so the drain reads in full
    dec_epoch: int = 0


class Session:
    def __init__(self, cluster: ClusterInfo,
                 conf: Optional[SchedulerConfiguration] = None,
                 now: Optional[float] = None, device="cuda"):
        """``now``: the cycle's clock (the sla plugin's waiting times), the
        wall clock by default. ``device``: where the passes run — the card
        by default, ``"cpu"`` for the plain PyTorch versions of the
        kernels."""
        self.cluster = cluster
        self.conf = conf or parse_conf()
        self.now = now if now is not None else time.time()
        self.device = device
        self._build_plugins()
        # device residency of the delta path, id(DeltaKernel) ->
        # ResidentState: survives reopen, so the buffers stay on the
        # device across cycles; a fresh Session pays one full upload
        self._resident: Dict[int, object] = {}
        self._reset_cycle_state()
        self.repack()
        self._open_plugins()

    def _build_plugins(self) -> None:
        from ..plugins.factory import build_plugin
        self.plugins = [build_plugin(opt) for tier in self.conf.tiers
                        for opt in tier.plugins]

    def _open_plugins(self) -> None:
        for p in self.plugins:
            p.on_session_open(self)

    def _reset_cycle_state(self) -> None:
        self.binds: List[BindIntent] = []
        self.bind_errors: List[tuple] = []      # (task uid, node, error)
        self.pipelined: Dict[str, str] = {}     # task uid -> node name
        self.conditions: Dict[str, str] = {}    # job uid -> condition type
        self.phase_updates: Dict[str, object] = {}  # job uid -> new PG phase
        self.last_enqueue = None        # bool[J] admitted by the last enqueue
        self.last_allocate = None
        self.last_backfill = None       # (task_node, placed) of the last one
        self.stats: Dict[str, float] = {}
        # the jobs and nodes refresh_snapshot patches: apply records its
        # touches, other mutators call mark_dirty. Kept across this reset,
        # so a reopened session refreshes what the last cycle touched.
        if not hasattr(self, "_dirty_jobs"):
            self._dirty_jobs: set = set()
            self._dirty_nodes: set = set()

    def reopen(self, now: Optional[float] = None,
               conf: Optional[SchedulerConfiguration] = None) -> bool:
        """Start the next scheduling cycle on this session: drop the last
        cycle's intents, patch the packed snapshot from the dirty jobs and
        nodes (:meth:`refresh_snapshot`), and re-open the plugins. The
        reference's cache is patched by informer handlers between cycles,
        never rebuilt (event_handlers.go:43-740). Returns True when the
        patch sufficed, False when refresh_snapshot repacked in full.
        ``stats`` gains ``refresh`` and ``refresh_ms`` (the patch, or the
        repack with its ``pack_ms``)."""
        if conf is not None:
            self.conf = conf
        self.now = now if now is not None else time.time()
        self._reset_cycle_state()
        t0 = time.perf_counter()
        refreshed = self.refresh_snapshot()
        self.stats["refresh_ms"] = (time.perf_counter() - t0) * 1000
        self.stats["refresh"] = refreshed
        self._build_plugins()
        self._open_plugins()
        return refreshed

    # ------------------------------------------------------------- packing
    def repack(self) -> None:
        """Re-flatten the cluster into arrays (cache.Snapshot seam), with
        the pure-Python packer."""
        t0 = time.perf_counter()
        self.snap, self.maps = pack(self.cluster)
        self.stats["pack_ms"] = (time.perf_counter() - t0) * 1000
        N = self.snap.nodes.pod_count.shape[0]
        T = self.snap.tasks.status.shape[0]
        Q = self.snap.queues.weight.shape[0]
        J = self.snap.jobs.valid.shape[0]
        # inter-pod affinity encoding rides the snapshot (the predicates
        # plugin's InterPodAffinity state, predicates.go:116-160)
        t0 = time.perf_counter()
        self.affinity = build_affinity(self.cluster, self.maps, N, T)
        self.stats["affinity_ms"] = (time.perf_counter() - t0) * 1000
        # hdrf tree topology (the drf plugin's hierarchicalRoot,
        # drf.go:128-147), static per snapshot
        self.hierarchy = build_hierarchy(self.cluster, self.maps, Q, J)
        # uid -> (job, task) readout index, built lazily on first use
        self._task_lookup_cache = None
        # packed-order (job, task) object pairs for _bulk_bind, built and
        # alignment-verified once per pack, then kept valid by
        # refresh_snapshot (a task-set change repacks)
        self._packed_objs_cache = None
        # the jobs whose queue is known, for refresh_snapshot's queue sums
        # (pack keeps the others out of them)
        qk = np.zeros(J, bool)
        for ji, uid in enumerate(self.maps.job_uids):
            job = self.cluster.jobs.get(uid)
            qk[ji] = job is not None and job.queue in self.maps.queue_index
        self._queue_known = qk
        self._dirty_jobs = set()
        self._dirty_nodes = set()
        self._scale_allocatables()

    def _scale_allocatables(self) -> None:
        """Apply the conf's ScaleAllocatable factors to the packed node
        allocatable/idle (OpenSession -> ScaleAllocatables,
        framework.go:33 + session.go:448-468). Session-scoped: operates on
        the snapshot arrays only, never the ClusterInfo.

        Per node: allocatable scales in place (ScaleResource keys
        millicpu/memory/maxtasknum, resource_info.go:55-75); the removed
        amount comes out of idle when idle covers it, otherwise idle's
        cpu+memory zero out (session.go:455-464)."""
        for c in self.conf.configurations:
            if c.name.lower() != "scaleallocatable":
                continue
            dims = self.maps.resource_names
            alloc = np.asarray(self.snap.nodes.allocatable).copy()
            idle = np.asarray(self.snap.nodes.idle).copy()
            max_pods = np.asarray(self.snap.nodes.max_pods).copy()
            old_alloc = alloc.copy()
            key_to_dim = {"millicpu": "cpu", "memory": "memory"}
            for key, factor in c.arguments.items():
                try:
                    f = float(factor)
                except (TypeError, ValueError):
                    continue
                if key.lower() == "maxtasknum":
                    max_pods = (max_pods * f).astype(max_pods.dtype)
                    continue
                dim = key_to_dim.get(key.lower())
                if dim in dims:
                    alloc[:, dims.index(dim)] *= f
            unavailable = old_alloc - alloc
            covered = np.all(unavailable <= idle + 1e-9, axis=-1)
            new_idle = np.where(covered[:, None], idle - unavailable, idle)
            if "cpu" in dims:
                new_idle[:, dims.index("cpu")] *= covered
            if "memory" in dims:
                new_idle[:, dims.index("memory")] *= covered
            valid = np.asarray(self.snap.nodes.valid)
            self.snap = dataclasses.replace(
                self.snap, nodes=dataclasses.replace(
                    self.snap.nodes,
                    allocatable=alloc.astype(np.float32),
                    idle=new_idle.astype(np.float32),
                    max_pods=max_pods),
                # plugins sum allocatable AFTER scaling (framework.go:33
                # runs before OnSessionOpen)
                cluster_capacity=np.where(valid[:, None], alloc, 0.0)
                .sum(axis=0).astype(np.float32))

    def plugin(self, name: str):
        for p in self.plugins:
            if p.name == name:
                return p
        return None

    # -------------------------------------------------- incremental refresh
    def mark_dirty(self, job_uid: Optional[str] = None,
                   node_name: Optional[str] = None) -> None:
        """Record an out-of-session mutation for refresh_snapshot."""
        if job_uid is not None:
            self._dirty_jobs.add(job_uid)
        if node_name is not None:
            self._dirty_nodes.add(node_name)

    def refresh_snapshot(self) -> bool:
        """Patch the packed snapshot in place for the recorded dirty
        entities instead of re-packing the whole cluster — the steady-state
        cycle path (the reference maintains its cache incrementally through
        informer event handlers, event_handlers.go:43-740, and only
        deep-copies at Snapshot; here the patch IS the snapshot update).

        Exact only for status/placement/accounting churn on an unchanged
        entity set: same nodes, same jobs, same per-job task uids, and no
        task spec changes (selector/toleration/affinity rows are immutable
        per the job-update webhook, webhooks/jobs.py). Anything else —
        including any inter-pod affinity terms, whose live counts depend on
        placements — falls back to a full repack. Returns True when the
        incremental patch was applied.
        """
        dirty_jobs = self._dirty_jobs
        dirty_nodes = self._dirty_nodes
        self._dirty_jobs = set()
        self._dirty_nodes = set()
        maps = self.maps
        scaled = any(c.name.lower() == "scaleallocatable"
                     for c in self.conf.configurations)
        if (self.affinity.has_terms
                or scaled                       # node rows carry scaled
                #                                 allocatable (session.go:448)
                or len(self.cluster.jobs) != len(maps.job_uids)
                or len(self.cluster.nodes) != len(maps.node_names)
                or len(self.cluster.queues) != len(maps.queue_names)
                or any(q not in maps.queue_index
                       for q in self.cluster.queues)
                or sorted(self.cluster.namespaces or {"default": None})
                != maps.namespace_names
                or any(u not in maps.job_index for u in dirty_jobs)
                or any(n not in maps.node_index for n in dirty_nodes)):
            self.repack()
            return False
        snap = self.snap
        dims = maps.resource_names
        tjob = np.asarray(snap.tasks.job)
        tasks_a = snap.tasks
        jobs_a = snap.jobs
        nodes_arr = snap.nodes
        M = jobs_a.task_table.shape[1]

        def vec(res):
            q = res.quantities
            return [q.get(d, 0.0) for d in dims]

        # ---- queue + namespace static rows (Q/S are small: re-encode) ----
        # covers queue open/closed flips, weight edits, hierarchy
        # annotation changes, and namespace weight changes without
        # per-entity dirty tracking
        queues_a = snap.queues
        q_changed = False
        open_flipped = []
        parents, depths = queue_parent_depth(self.cluster, maps.queue_names)
        for qi, name in enumerate(maps.queue_names):
            q = self.cluster.queues[name]
            hw = q.hierarchy_weight_values()
            row = (np.float32(max(q.weight, 0)),
                   queue_capability_row(q, dims),
                   bool(q.reclaimable),
                   q.state == QueueState.OPEN,
                   np.int32(parents[qi]), np.int32(depths[qi]),
                   np.float32(hw[-1] if hw else 1.0))
            old = (queues_a.weight[qi], queues_a.capability[qi],
                   bool(queues_a.reclaimable[qi]), bool(queues_a.open[qi]),
                   queues_a.parent[qi], queues_a.depth[qi],
                   queues_a.hier_weight[qi])
            if (old[0] != row[0] or not np.array_equal(old[1], row[1])
                    or old[2] != row[2] or old[3] != row[3]
                    or old[4] != row[4] or old[5] != row[5]
                    or old[6] != row[6]):
                q_changed = True
                if old[3] != row[3]:
                    open_flipped.append(qi)
                queues_a.weight[qi] = row[0]
                queues_a.capability[qi] = row[1]
                queues_a.reclaimable[qi] = row[2]
                queues_a.open[qi] = row[3]
                queues_a.parent[qi] = row[4]
                queues_a.depth[qi] = row[5]
                queues_a.hier_weight[qi] = row[6]
        for si, name in enumerate(maps.namespace_names):
            ns = self.cluster.namespaces.get(name)
            snap.namespace_weight[si] = max(ns.weight if ns else 1, 1)
        if q_changed:
            # the hdrf tree rides the queue annotations
            Q = np.asarray(queues_a.weight).shape[0]
            J = np.asarray(jobs_a.valid).shape[0]
            self.hierarchy = build_hierarchy(self.cluster, maps, Q, J)
        ns_index = {n: i for i, n in enumerate(maps.namespace_names)}
        if open_flipped:
            # member jobs' schedulable depends on queue_open (pack j_sched):
            # re-encode them like dirty jobs
            jq = np.asarray(jobs_a.queue)
            jvalid = np.asarray(jobs_a.valid)
            for qi in open_flipped:
                for ji in np.flatnonzero((jq == qi) & jvalid):
                    dirty_jobs.add(maps.job_uids[int(ji)])

        # ---- dirty task/job rows -----------------------------------------
        for uid in dirty_jobs:
            ji = maps.job_index[uid]
            job = self.cluster.jobs.get(uid)
            if job is None:
                self.repack()
                return False
            tis = np.flatnonzero(tjob == ji)
            if ([maps.task_uids[ti] for ti in tis]
                    != list(job.tasks.keys())):
                self.repack()       # task set changed: full rebuild
                return False
            # a watch-driven store may have replaced the TaskInfo objects
            # behind unchanged uids: re-point the positional/uid caches so
            # later binds mutate the live objects, not stale ones
            if self._packed_objs_cache is not None:
                for ti, task in zip(tis.tolist(), job.tasks.values()):
                    self._packed_objs_cache[ti] = (job, task)
            if self._task_lookup_cache is not None:
                for task in job.tasks.values():
                    self._task_lookup_cache[task.uid] = (job, task)
            pending: list = []
            req_sum = np.zeros(len(dims), np.float32)
            for ti, task in zip(tis.tolist(), job.tasks.values()):
                tasks_a.resreq[ti] = vec(task.resreq)
                tasks_a.status[ti] = int(task.status)
                tasks_a.priority[ti] = task.priority
                tasks_a.node[ti] = maps.node_index.get(task.node_name, -1)
                tasks_a.best_effort[ti] = task.best_effort
                tasks_a.gpu_request[ti] = gpu_request_of(task.resreq)
                tasks_a.preemptable[ti] = task.preemptable
                if task.status == TaskStatus.PENDING:
                    pending.append(ti)
                if (task.status == TaskStatus.PENDING
                        or is_allocated_status(TaskStatus(task.status))):
                    req_sum += np.asarray(tasks_a.resreq[ti])
            pending.sort(key=lambda ti: (-int(tasks_a.priority[ti]), ti))
            if len(pending) > M:
                self.repack()       # pending row outgrew the M bucket
                return False
            ready_num = job.ready_task_num()
            jobs_a.min_available[ji] = job.min_available
            jobs_a.queue[ji] = maps.queue_index.get(job.queue, 0)
            self._queue_known[ji] = job.queue in maps.queue_index
            jobs_a.namespace[ji] = ns_index.get(job.namespace, 0)
            jobs_a.priority[ji] = job.priority
            jobs_a.ready_num[ji] = ready_num
            jobs_a.allocated[ji] = vec(job.allocated)
            jobs_a.total_request[ji] = req_sum
            jobs_a.min_resources[ji] = vec(job.min_resources)
            jobs_a.task_table[ji] = -1
            jobs_a.task_table[ji, :len(pending)] = pending
            jobs_a.n_pending[ji] = len(pending)
            gang_valid, _ = job.is_valid()
            qi = maps.queue_index.get(job.queue)
            queue_open = qi is not None and bool(snap.queues.open[qi])
            pending_phase = job.pod_group_phase == PodGroupPhase.PENDING
            jobs_a.pending_phase[ji] = pending_phase
            jobs_a.inqueue[ji] = not pending_phase
            jobs_a.schedulable[ji] = (gang_valid and queue_open
                                      and not pending_phase)
            jobs_a.preemptable[ji] = job.preemptable

        # ---- dirty node rows ---------------------------------------------
        for name in dirty_nodes:
            ni = maps.node_index[name]
            node = self.cluster.nodes.get(name)
            if node is None:
                self.repack()
                return False
            nodes_arr.idle[ni] = vec(node.idle)
            nodes_arr.used[ni] = vec(node.used)
            nodes_arr.releasing[ni] = vec(node.releasing)
            nodes_arr.pipelined[ni] = vec(node.pipelined)
            nodes_arr.allocatable[ni] = vec(node.allocatable)
            nodes_arr.capability[ni] = vec(node.capability)
            nodes_arr.pod_count[ni] = node.pod_count()
            nodes_arr.max_pods[ni] = node.max_pods
            nodes_arr.schedulable[ni] = (node.ready
                                         and not node.unschedulable)
            # always zero first (a node whose device set emptied must not
            # keep stale rows — pack zeros them); a device set that outgrew
            # the packed G bucket or a dev.id past it needs the wider bucket
            # only a repack can size
            nodes_arr.gpu_memory[ni] = 0.0
            nodes_arr.gpu_used[ni] = 0.0
            G = nodes_arr.gpu_memory.shape[1]
            if node.gpu_devices:
                if (len(node.gpu_devices) > G
                        or any(dev.id >= G for dev in node.gpu_devices)):
                    self.repack()
                    return False
                for dev in node.gpu_devices:
                    nodes_arr.gpu_memory[ni, dev.id] = dev.memory
                    nodes_arr.gpu_used[ni, dev.id] = dev.used_memory()

        # ---- cluster capacity (pack.py cluster_capacity formula) ---------
        if dirty_nodes:
            nn = len(maps.node_names)
            snap.cluster_capacity[:] = (
                nodes_arr.allocatable[:nn].sum(axis=0) if nn
                else np.zeros(len(dims), np.float32))

        # ---- queue aggregates (proportion.OnSessionOpen sums) ------------
        if dirty_jobs or q_changed:
            jq = np.asarray(jobs_a.queue)
            # pack excludes valid jobs whose queue is unknown from the
            # aggregates (their j_queue defaults to 0); mirror via the
            # queue-known mask recorded at repack
            member = np.asarray(jobs_a.valid) & self._queue_known
            alloc = np.where(member[:, None], jobs_a.allocated, 0.0)
            req = np.where(member[:, None], jobs_a.total_request, 0.0)
            inq = np.where((member & np.asarray(jobs_a.inqueue))[:, None],
                           jobs_a.min_resources, 0.0)
            for arr, src in ((snap.queues.allocated, alloc),
                             (snap.queues.request, req),
                             (snap.queues.inqueue_minres, inq)):
                arr[:] = 0.0
                np.add.at(arr, jq, src)
        return True

    # ------------------------------------------------- pass composition
    def allocate_config(self) -> AllocateConfig:
        weights: Dict[str, float] = dict(
            binpack_weight=0.0, least_allocated_weight=0.0,
            most_allocated_weight=0.0, balanced_weight=0.0,
            taint_prefer_weight=0.0, pod_affinity_weight=0.0)
        provided = set()
        any_scorer = False
        for p in self.plugins:
            w = p.score_weights(self)
            if w:
                any_scorer = True
                for k, v in w.items():
                    weights[k] = weights.get(k, 0.0) + v
                    provided.add(k)
        if not any_scorer:
            # no scoring plugin: fall back to spread defaults like the
            # reference's nodeorder defaults
            weights.update(least_allocated_weight=1.0, balanced_weight=1.0)
        # InterPodAffinity is part of the predicates plugin's filter set
        # (predicates.go:196-200), compiled in only when terms exist
        enable_aff = (self.affinity.has_terms
                      and self.plugin("predicates") is not None)
        # NodePorts likewise (predicates.go:191): only when a pending task
        # declares hostPorts
        enable_ports = (self.plugin("predicates") is not None
                        and any(t.host_ports
                                for job in self.cluster.jobs.values()
                                for t in job.tasks.values()))
        if enable_aff and "pod_affinity_weight" not in provided:
            weights["pod_affinity_weight"] = 1.0
        drf, tdm, sla = (self.plugin(n) for n in ("drf", "tdm", "sla"))
        return AllocateConfig(telemetry=bool(self.conf.telemetry),
                              wave_width=int(self.conf.wave_width),
                              enable_gang=self.plugin("gang") is not None,
                              enable_pod_affinity=enable_aff,
                              enable_host_ports=enable_ports,
                              enable_hdrf=(drf is not None
                                           and drf.option.enabled_hierarchy),
                              drf_job_order=(drf is not None
                                             and drf.option.enabled_job_order),
                              drf_ns_order=(drf is not None and drf.option
                                            .enabled_namespace_order),
                              tdm_job_order=(tdm is not None
                                             and tdm.option.enabled_job_order),
                              sla_job_order=(sla is not None
                                             and sla.option.enabled_job_order),
                              **weights)

    def _port_volume_extras(self, extras: AllocateExtras) -> None:
        """Host-side NodePorts + volume-binding inputs (the predicates
        plugin's nodePortFilter, predicates.go:191, and the
        defaultVolumeBinder seam, cache.go:240-272)."""
        from .host_extras import (apply_port_volume_sections,
                                  port_volume_sections)
        sec = port_volume_sections(self.cluster, self.maps.node_index,
                                   self.maps.task_index)
        apply_port_volume_sections(extras, sec, self.snap)

    def _node_affinity_extras(self, extras: AllocateExtras) -> None:
        """Node-affinity OR groups (predicates) and the f32[P, N] preferred
        score per predicate template: matched term weights x
        nodeaffinity.weight (nodeorder.go:255-266)."""
        from .host_extras import (apply_affinity_sections,
                                  node_affinity_sections)
        no = self.plugin("nodeorder")
        w = no.arg_float("nodeaffinity.weight", 1.0) if no is not None else 0.0
        do_required = self.plugin("predicates") is not None
        if not (bool(w) or do_required):
            return
        sec = node_affinity_sections(self.cluster, self.maps.node_names,
                                     self.maps.task_index, w, do_required)
        apply_affinity_sections(extras, sec, self.snap,
                                len(self.maps.node_names))

    def allocate_extras(self) -> AllocateExtras:
        extras = AllocateExtras.neutral(self.snap)
        extras.affinity = self.affinity
        extras.hierarchy = self.hierarchy
        if self.plugin("predicates") is not None:
            self._port_volume_extras(extras)
        if (self.plugin("nodeorder") is not None
                or self.plugin("predicates") is not None):
            self._node_affinity_extras(extras)
        for p in self.plugins:
            deserved = p.queue_deserved(self)
            if deserved is not None:
                extras.queue_deserved = np.asarray(deserved, np.float32)
            share = p.job_order_share(self)
            if share is not None and p.option.enabled_job_order:
                extras.job_share = np.asarray(share, np.float32)
            ns = p.namespace_share(self)
            if ns is not None:
                extras.ns_share = np.asarray(ns, np.float32)
            if hasattr(p, "job_deadline"):
                extras.job_deadline = np.asarray(p.job_deadline(self),
                                                 np.float32)
        return extras

    def enqueue_config(self) -> EnqueueConfig:
        gates: Dict[str, object] = {}
        for p in self.plugins:
            gates.update(p.enqueue_gates(self))
        return EnqueueConfig(
            enable_proportion_gate=bool(gates.get("enable_proportion_gate",
                                                  False)),
            enable_overcommit_gate=bool(gates.get("enable_overcommit_gate",
                                                  False)),
            overcommit_factor=float(gates.get("overcommit_factor", 1.2)))

    def sla_waiting_flags(self) -> np.ndarray:
        J = np.asarray(self.snap.jobs.valid).shape[0]
        flags = np.zeros(J, bool)
        for p in self.plugins:
            f = p.sla_waiting(self)
            if f is not None:
                flags |= np.asarray(f, bool)
        return flags

    def _derived_allocate_inputs(self):
        """(cfg, extras) exactly as the cycle consumes them:
        ops.allocate_scan.derive_batching picks the batching, and GPU-free
        snapshots skip the per-card state (decision-neutral: zero requests
        never charge a card)."""
        cfg = self.allocate_config()
        extras = self.allocate_extras()
        cfg = derive_batching(cfg, extras.queue_deserved)
        if not np.any(np.asarray(self.snap.tasks.gpu_request) > 0):
            cfg = dataclasses.replace(cfg, enable_gpu=False)
        return cfg, extras

    def _sharding_mesh(self):
        """The node mesh the allocate cycle runs on, or None when the conf
        leaves sharding off (or turns delta uploads off: the reference
        shards only its delta path). Sized per the snapshot's node bucket
        (``parallel/sharding.mesh_for_nodes``) over the visible cards, or
        over the CPU for a CPU session."""
        if not bool(getattr(self.conf, "sharding", False)):
            return None
        if not bool(getattr(self.conf, "delta_uploads", True)):
            return None
        from ..parallel.sharding import mesh_for_nodes
        dev = torch.device(self.device)
        n_nodes = int(np.asarray(self.snap.nodes.valid).shape[0])
        return mesh_for_nodes(n_nodes,
                              getattr(self.conf, "sharding_devices", None),
                              devices=None if dev.type == "cuda" else [dev])

    # -------------------------------------------------------- pass runners
    def run_enqueue(self) -> int:
        """Run the enqueue pass; promote admitted jobs Pending -> Inqueue
        and repack when any was. Returns the number admitted."""
        t0 = time.perf_counter()
        snap_d = to_device(self.snap, self.device)
        flags = torch.from_numpy(self.sla_waiting_flags()).to(self.device)
        admitted = make_enqueue_pass(self.enqueue_config())(snap_d, flags)
        admitted = admitted.cpu().numpy()
        self.stats["enqueue_ms"] = (time.perf_counter() - t0) * 1000
        self.last_enqueue = admitted
        count = 0
        for uid, ji in self.maps.job_index.items():
            if admitted[ji]:
                self.cluster.jobs[uid].pod_group_phase = PodGroupPhase.INQUEUE
                self.phase_updates[uid] = PodGroupPhase.INQUEUE
                count += 1
        if count:
            self.repack()
        return count

    def run_backfill(self) -> int:
        """Run the backfill pass on the session's snapshot and bind what
        it placed. Returns the number bound. Like the reference, the
        snapshot is the one packed before allocate: allocate's binds
        change the cluster, not the packed arrays."""
        t0 = time.perf_counter()
        extras = self.allocate_extras()
        snap_d = to_device(self.snap, self.device)
        t_node, placed = make_backfill_pass()(
            snap_d, torch.from_numpy(extras.task_or_group).to(self.device),
            torch.from_numpy(extras.or_feasible).to(self.device))
        t_node, placed = t_node.cpu().numpy(), placed.cpu().numpy()
        self.stats["backfill_ms"] = (time.perf_counter() - t0) * 1000
        self.last_backfill = (t_node, placed)
        count = 0
        uids = self.maps.task_uids
        for ti in np.nonzero(placed)[0]:
            self._bind_task(uids[ti], self.maps.node_names[int(t_node[ti])])
            count += 1
        return count

    def run_allocate(self):
        """Upload the snapshot (in full, or the delta against the resident
        buffers), run the allocate cycle, read the packed decisions back
        and apply them: ``complete_allocate(dispatch_allocate())``."""
        return self.complete_allocate(self.dispatch_allocate())

    def run_allocate_oracle(self):
        """The whole allocate pass on the host's numpy oracle
        (``runtime/cpu_reference.allocate_cpu``), with the cycle's derived
        config and extras, applied to the session as a card cycle's result
        is (``last_allocate``, :meth:`apply_allocate`, ``apply_ms``); sets
        ``stats["cpu_oracle"]``. An explicit entry point: it runs only when
        called, and nothing on the card path falls back to it.
        ``collect_telemetry=True`` turns on the oracle's mirror of the
        cycle's capacity give-up, which job_ready and the PodGroup updates
        need to match the cycle's."""
        from ..runtime.cpu_reference import allocate_cpu
        cfg, extras = self._derived_allocate_inputs()
        out = allocate_cpu(self.snap, extras, cfg, collect_telemetry=True)
        result = types.SimpleNamespace(
            task_node=np.asarray(out["task_node"], np.int32),
            task_mode=np.asarray(out["task_mode"], np.int32),
            task_gpu=np.asarray(out["task_gpu"], np.int32),
            job_ready=np.asarray(out["job_ready"], bool),
            job_pipelined=np.asarray(out["job_pipelined"], bool),
            job_attempted=np.asarray(out["job_attempted"], bool))
        self.last_allocate = result
        self.stats["cpu_oracle"] = 1.0
        t0 = time.perf_counter()
        self.apply_allocate(result)
        self.stats["apply_ms"] = (time.perf_counter() - t0) * 1000
        return result

    def dispatch_allocate(self) -> PendingAllocate:
        """Upload and run the allocate cycle, without reading its packed
        decisions back; :meth:`complete_allocate` drains the returned
        pending. The cycle is a host loop with one small readback a round
        (rounds, pops, attempts or waves), so dispatch runs that loop on
        the device and stops before the final packed readback.

        With conf ``delta_uploads`` (default true) and no mesh, the
        snapshot's three group buffers stay on the device between cycles
        and only the changed elements go up (``ops/fused_io``); with
        ``sharding: true`` the mesh path uploads the whole snapshot, as
        before (ROADMAP item 6c). ``stats``: ``path``
        (``allocate_scan.cycle_path``), ``upload_bytes`` and
        ``full_upload_bytes``, ``last_kind`` ("full", "delta"),
        ``extras_ms`` and ``dispatch_ms``."""
        t0 = time.perf_counter()
        cfg, extras = self._derived_allocate_inputs()
        extras_ms = (time.perf_counter() - t0) * 1000
        t0 = time.perf_counter()
        snap = self.snap
        T = int(snap.tasks.status.shape[0])
        J = int(snap.jobs.valid.shape[0])
        mesh = self._sharding_mesh()
        tree = (snap, extras)
        pending = PendingAllocate(packed=None, cfg=cfg, T=T, J=J,
                                  extras_ms=extras_ms, tree=tree)
        if mesh is None and bool(getattr(self.conf, "delta_uploads", True)):
            kernel = delta_cycle_cached(
                make_allocate_cycle(cfg), tree, _DELTA_CACHE, self.device,
                dec_len=3 * T + 3 * J, key_extra=cfg)
            state = self._resident.setdefault(id(kernel), ResidentState())
            pending.packed = kernel.run(state, tree)
            pending.kernel, pending.state = kernel, state
            pending.tail, pending.dec_epoch = state.last_tail, state.dec_epoch
            upload, full, kind = (state.last_upload_bytes,
                                  state.full_upload_bytes, state.last_kind)
        else:
            pending.packed = make_allocate_cycle(cfg, mesh=mesh)(
                to_device(snap, self.device),
                to_device(extras, self.device)).packed_decisions()
            full = sum(np.asarray(x).nbytes for x in tree_leaves(tree))
            upload, kind = full, "full"
        pending.dispatch_ms = (time.perf_counter() - t0) * 1000
        self.stats.update(path=cycle_path(cfg, snap, extras, mesh),
                          upload_bytes=float(upload),
                          full_upload_bytes=float(full), last_kind=kind,
                          extras_ms=extras_ms,
                          dispatch_ms=pending.dispatch_ms)
        return pending

    def complete_allocate(self, pending: PendingAllocate):
        """Drain a dispatched cycle: read its packed decisions back (the
        changed-rows tail where it can), check the resident buffers'
        digest, recover on a mismatch or a failed readback
        (:meth:`_readback_packed`), and apply the decisions. ``stats``:
        ``cycle_ms`` (inputs, upload, the cycle and the readback),
        ``drain_readback_bytes`` and ``drain_readback_rows``."""
        t0 = time.perf_counter()
        packed = self._readback_packed(pending)
        self.stats["cycle_ms"] = (pending.extras_ms + pending.dispatch_ms
                                  + (time.perf_counter() - t0) * 1000)
        return self.apply_packed(packed, pending.T, pending.J)

    def _readback_packed(self, pending: PendingAllocate) -> np.ndarray:
        """The dispatched cycle's packed decisions on the host. On the
        delta path the digest the cycle computed on the device must equal
        the mirror's; the changed-rows tail, when the decisions chain
        holds, patches the host mirror of the last drained decisions in
        place of a full readback. A digest mismatch or a failed readback
        recovers on the device (a full upload from the cycle's own tree
        and a re-run, counted in ``stats["recoveries"]``); a recovery
        that fails raises."""
        kernel, state = pending.kernel, pending.state
        if kernel is None:
            packed = pending.packed.cpu().numpy()
            self.stats["drain_readback_bytes"] = float(packed.nbytes)
            self.stats["drain_readback_rows"] = float(packed.shape[0])
            return packed
        reason = packed = None
        checked = False
        mirror = state.dec_mirror
        same_chain = pending.dec_epoch == state.dec_epoch
        if (kernel.rb_cap and pending.tail is not None and same_chain
                and mirror is not None and mirror.shape[0] == kernel.dec_len):
            try:
                tail = pending.tail.cpu().numpy()
                dig, cnt, idx, vals = kernel.split_tail(tail)
                if not np.array_equal(dig, kernel.mirror_digest(state)):
                    reason = "digest"
                else:
                    checked = True
                    if cnt <= kernel.rb_cap:
                        packed = mirror.copy()
                        packed[idx] = vals
                        self.stats["drain_readback_bytes"] = float(
                            tail.nbytes)
                        self.stats["drain_readback_rows"] = float(cnt)
            except RuntimeError as e:
                reason = f"readback:{type(e).__name__}"
        if packed is None and reason is None:
            try:
                full = pending.packed.cpu().numpy()
            except RuntimeError as e:
                reason = f"readback:{type(e).__name__}"
            else:
                packed, dig = kernel.split_digest(full)
                if not checked and not np.array_equal(
                        dig, kernel.mirror_digest(state)):
                    reason, packed = "digest", None
                else:
                    self.stats["drain_readback_bytes"] = float(full.nbytes)
                    self.stats["drain_readback_rows"] = float(full.shape[0])
        if reason is None:
            if kernel.rb_cap and same_chain:
                # the next drain's base: a copy, not a view of the readback
                state.dec_mirror = np.array(packed, np.int32)
            return packed
        t0 = time.perf_counter()
        full = kernel.recover(state, pending.tree).cpu().numpy()
        packed, dig = kernel.split_digest(full)
        if not np.array_equal(dig, kernel.mirror_digest(state)):
            raise RuntimeError("the resident buffers' digest differs from "
                               "the mirror's after a full upload and re-run")
        self.stats["recoveries"] = self.stats.get("recoveries", 0) + 1
        self.stats["recovery_reason"] = reason
        self.stats["recovery_ms"] = (time.perf_counter() - t0) * 1000
        self.stats["drain_readback_bytes"] = float(full.nbytes)
        self.stats["drain_readback_rows"] = float(full.shape[0])
        return packed

    def apply_packed(self, packed: np.ndarray, T: int, J: int):
        """Decode a packed decision vector and apply it to this session."""
        (task_node, task_mode, task_gpu, job_ready, job_pipelined,
         job_attempted) = unpack_decisions(packed, T, J)
        result = types.SimpleNamespace(
            task_node=task_node, task_mode=task_mode, task_gpu=task_gpu,
            job_ready=job_ready, job_pipelined=job_pipelined,
            job_attempted=job_attempted)
        self.last_allocate = result
        t0 = time.perf_counter()
        self.apply_allocate(result)
        self.stats["apply_ms"] = (time.perf_counter() - t0) * 1000
        return result

    # -------------------------------------------------------- apply/readout
    @property
    def _task_lookup(self):
        if self._task_lookup_cache is None:
            self._task_lookup_cache = {
                uid: (job, task)
                for job in self.cluster.jobs.values()
                for uid, task in job.tasks.items()}
        return self._task_lookup_cache

    def _find_task(self, uid: str):
        return self._task_lookup.get(uid, (None, None))

    def _bind_task(self, task_uid: str, node_name: str,
                   gpu_index: int = -1) -> None:
        """Session dispatch: mark Binding, account on the node, queue the
        bind intent (session.go:264-355 Allocate -> dispatch -> cache.Bind)."""
        job, task = self._find_task(task_uid)
        if task is None:
            return
        job.update_task_status(task, TaskStatus.BINDING)
        task.gpu_index = gpu_index
        node = self.cluster.nodes.get(node_name)
        if node is not None and task.uid not in node.tasks:
            try:
                node.add_task(task)
            except ValueError as e:
                # The device cycle admits with float32 1e-5 slack while the
                # host Resource algebra checks float64 1e-9, so a boundary
                # exact-fit can pass on the device and fail here. The
                # reference returns the AddTask error from dispatch and
                # continues (session.go:330-355).
                job.update_task_status(task, TaskStatus.PENDING)
                task.gpu_index = -1
                self.bind_errors.append((task_uid, node_name, str(e)))
                self._dirty_jobs.add(job.uid)
                return
            self._dirty_nodes.add(node_name)
        self._dirty_jobs.add(job.uid)
        self.binds.append(BindIntent(task_uid, job.uid, node_name, gpu_index))

    def _bulk_bind(self, bind_idx, task_node, task_gpu) -> None:
        """Vectorized dispatch of many binds in one pass: per-task work
        shrinks to dict/status bookkeeping, and the per-node and per-job
        Resource arithmetic batches into one numpy segment-sum per axis."""
        resreq = np.asarray(self.snap.tasks.resreq, np.float64)
        dims = self.maps.resource_names
        uids = self.maps.task_uids
        node_names = self.maps.node_names
        N = len(node_names)
        J = len(self.maps.job_uids)
        tjob = np.asarray(self.snap.tasks.job)
        node_sum = np.zeros((N, resreq.shape[1]))
        job_sum = np.zeros((J, resreq.shape[1]))
        np.add.at(node_sum, task_node[bind_idx], resreq[bind_idx])
        np.add.at(job_sum, tjob[bind_idx], resreq[bind_idx])
        touched_nodes = np.unique(task_node[bind_idx])
        touched_jobs = np.unique(tjob[bind_idx])
        idx_l = bind_idx.tolist()
        node_l = task_node[bind_idx].tolist()
        gpu_l = task_gpu[bind_idx].tolist()
        # packed-order (job, task) object list, uid-alignment-verified once
        # per pack
        packed_objs = self._packed_objs_cache
        if packed_objs is None:
            packed_objs = []
            extend = packed_objs.extend
            for juid in self.maps.job_uids:
                jb = self.cluster.jobs.get(juid)
                if jb is not None:
                    extend((jb, t) for t in jb.tasks.values())
            if (len(packed_objs) != len(uids)
                    or not all(p[1].uid == u
                               for p, u in zip(packed_objs, uids))):
                # packing order no longer matches the live cluster: fall
                # back to the uid index
                packed_objs = None
            else:
                self._packed_objs_cache = packed_objs
        elif len(packed_objs) != len(uids):
            packed_objs = self._packed_objs_cache = None
        if packed_objs is None:
            lookup_get = self._task_lookup.get
        node_objs = self.cluster.nodes
        binds_append = self.binds.append
        binding = TaskStatus.BINDING
        # status-index moves batched per job: bind indices are packed in
        # job order, so the from/to buckets of job.task_status_index are
        # fetched once per job; empty source buckets are dropped at the job
        # boundary, matching _unindex
        prev_job = None
        tsi = None
        buckets: Dict = {}

        def _flush_empties():
            if prev_job is not None:
                for s, b in buckets.items():
                    if b is not None and not b and s in tsi:
                        del tsi[s]

        for k, ti in enumerate(idx_l):
            if packed_objs is not None:
                job, task = packed_objs[ti]
            else:
                job, task = lookup_get(uids[ti], (None, None))
            if task is None:
                continue
            if job is not prev_job:
                _flush_empties()
                prev_job = job
                tsi = job.task_status_index
                buckets = {}
            s = task.status
            if s not in buckets:
                buckets[s] = tsi.get(s)
            src = buckets[s]
            if src is not None:
                src.pop(task.uid, None)
            if buckets.get(binding) is None:
                buckets[binding] = tsi.setdefault(binding, {})
            task.status = binding
            buckets[binding][task.uid] = task
            gi = gpu_l[k]
            task.gpu_index = gi
            nname = node_names[node_l[k]]
            node = node_objs.get(nname)
            if node is not None and task.uid not in node.tasks:
                node.tasks[task.uid] = task
                task.node_name = nname
                if gi >= 0 and gpu_request_of(task.resreq) > 0:
                    node.add_gpu_resource(task)
            binds_append(BindIntent(task.uid, job.uid, nname, gi))
        _flush_empties()
        for ni in touched_nodes:
            node = self.cluster.nodes.get(node_names[int(ni)])
            if node is None:
                continue
            delta = Resource({d: float(node_sum[ni, k])
                              for k, d in enumerate(dims)
                              if node_sum[ni, k] > 0})
            node.used.add(delta)
            node.idle.sub_floored(delta)
            self._dirty_nodes.add(node.name)
        job_uids = self.maps.job_uids
        for ji in touched_jobs:
            job = self.cluster.jobs.get(job_uids[int(ji)])
            if job is None:
                continue
            job.allocated.add(Resource({d: float(job_sum[ji, k])
                                        for k, d in enumerate(dims)
                                        if job_sum[ji, k] > 0}))
            self._dirty_jobs.add(job.uid)

    def apply_allocate(self, result) -> None:
        task_node = np.asarray(result.task_node)
        task_mode = np.asarray(result.task_mode)
        task_gpu = np.asarray(result.task_gpu)
        job_ready = np.asarray(result.job_ready)
        maps, task_job = self.maps, np.asarray(self.snap.tasks.job)
        uids = maps.task_uids
        bind_mask = (task_mode == MODE_ALLOCATED) & job_ready[task_job]
        bind_idx = np.nonzero(bind_mask)[0]
        if len(bind_idx) >= 512:
            self._bulk_bind(bind_idx, task_node, task_gpu)
        else:
            for ti in bind_idx:
                self._bind_task(uids[ti],
                                maps.node_names[int(task_node[ti])],
                                int(task_gpu[ti]))
        for ti in np.nonzero((task_mode != 0) & ~bind_mask)[0]:
            # held in-session only (pipelined or allocated-but-unready):
            # no cache flush, like an uncommitted Statement
            self.pipelined[uids[ti]] = maps.node_names[int(task_node[ti])]
        # ready gangs' PodGroups move to Running (session.go:173
        # jobStatus) — after the bind loop, so a job whose bind degraded to
        # a recorded error is not marked Running with too few bound tasks
        failed_jobs = set()
        for task_uid, _node, _err in self.bind_errors:
            _job, _task = self._find_task(task_uid)
            if _job is not None:
                failed_jobs.add(_job.uid)
        for uid, ji in maps.job_index.items():
            if bool(job_ready[ji]) and uid not in failed_jobs:
                self.phase_updates[uid] = PodGroupPhase.RUNNING

    # --------------------------------------------------------------- close
    def close(self) -> None:
        for p in self.plugins:
            p.on_session_close(self)
