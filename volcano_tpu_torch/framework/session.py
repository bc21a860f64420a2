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

Not carried yet (ROADMAP): incremental refresh, device-resident delta
uploads, pipelined dispatch, a mesh over several cards, the CPU-oracle
rung, metrics and trace spans, telemetry, and the preempt and reclaim
passes.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api import ClusterInfo, PodGroupPhase, TaskStatus, gpu_request_of
from ..api.resource import Resource
from ..arrays import pack, to_device
from ..arrays.affinity import build_affinity
from ..arrays.hierarchy import build_hierarchy
from ..ops.allocate_scan import (MODE_ALLOCATED, AllocateConfig,
                                 AllocateExtras, derive_batching,
                                 make_allocate_cycle, unpack_decisions)
from ..ops.backfill import make_backfill_pass
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


class Session:
    def __init__(self, cluster: ClusterInfo,
                 conf: Optional[SchedulerConfiguration] = None,
                 now: Optional[float] = None, device="cuda"):
        """``now``: the cycle's clock (the sla plugin's waiting times), the
        wall clock by default. ``device``: where the passes run — the card
        by default, ``"cpu"`` for the plain PyTorch versions of the
        kernels."""
        from ..plugins.factory import build_plugin
        self.cluster = cluster
        self.conf = conf or parse_conf()
        self.now = now if now is not None else time.time()
        self.device = device
        self.plugins = [build_plugin(opt) for tier in self.conf.tiers
                        for opt in tier.plugins]
        self._reset_cycle_state()
        self.repack()
        self._open_plugins()

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
        # alignment-verified once per pack
        self._packed_objs_cache = None
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
        """Upload the snapshot to the session's device, run the allocate
        cycle, read the packed decisions back in one copy and apply them."""
        t0 = time.perf_counter()
        cfg, extras = self._derived_allocate_inputs()
        snap_d = to_device(self.snap, self.device)
        extras_d = to_device(extras, self.device)
        result = make_allocate_cycle(cfg, mesh=self._sharding_mesh())(
            snap_d, extras_d)
        packed = result.packed_decisions().cpu().numpy()
        self.stats["cycle_ms"] = (time.perf_counter() - t0) * 1000
        T = self.snap.tasks.status.shape[0]
        J = self.snap.jobs.valid.shape[0]
        return self.apply_packed(packed, T, J)

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
                return
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
        job_uids = self.maps.job_uids
        for ji in touched_jobs:
            job = self.cluster.jobs.get(job_uids[int(ji)])
            if job is None:
                continue
            job.allocated.add(Resource({d: float(job_sum[ji, k])
                                        for k, d in enumerate(dims)
                                        if job_sum[ji, k] > 0}))

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
