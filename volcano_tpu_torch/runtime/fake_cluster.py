"""In-memory cluster: the test/bench stand-in for the Kubernetes API server
(the port's copy of ``volcano_tpu/runtime/fake_cluster.py``, on the port's
``api`` and intents).

Reference seam: the Cache interface with FakeBinder/FakeEvictor/
FakeStatusUpdater (pkg/scheduler/cache/interface.go:29-86,
pkg/scheduler/util/test_utils.go:95-176). The FakeCluster owns the
authoritative ClusterInfo, serves deep-copy snapshots to sessions, and
applies bind/evict intents the way the real binder/evictor REST calls would,
recording them for assertions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api import (ClusterInfo, JobInfo, NodeInfo, QueueInfo, TaskInfo,
                   TaskStatus)
from ..framework.session import BindIntent, EvictIntent


def seam(name: str, **ctx):
    """The chaos fault-injection seam of the reference
    (``chaos/inject.seam``): no fault is ever armed here, so every seam
    returns None. The chaos seams are ROADMAP queue 1 item 10."""
    return None


class FakeCluster:
    def __init__(self, ci: Optional[ClusterInfo] = None):
        self.ci = ci or ClusterInfo()
        self.binds: List[Tuple[str, str]] = []      # (task uid, node)
        self.evictions: List[str] = []              # task uid
        # HA fencing: the highest lease generation any writer
        # has presented. A bind/evict stamped with an OLDER token comes
        # from a deposed leader — reject it structurally (the split-brain
        # window can never double-bind). None-fenced writes (tests, the
        # single-replica loop) bypass the check entirely.
        self.fence_generation: int = 0
        #: rejected stale writes, for assertions: (kind, task_uid,
        #: presented_generation, fence_generation)
        self.fenced_rejections: List[Tuple[str, str, int, int]] = []
        self.bind_failures: Dict[str, str] = {}     # task uid -> error to inject
        self.volume_bind_failures: set = set()      # claim names failing
        #                                             BindVolumes at dispatch
        # dirty marks for the scheduler's persistent session (the informer
        # event-handler analog, event_handlers.go:43-740): every mutator
        # records what it touched; direct ClusterInfo edits must call
        # mark_dirty (entity ADD/REMOVE is caught structurally by
        # refresh_snapshot's count checks either way)
        self.dirty_jobs: set = set()
        self.dirty_nodes: set = set()
        self.structural: bool = False
        #: total structural marks ever raised (see SchedulerCache) — the
        #: expected full-re-fuse count of a delta-upload steady loop
        self.structural_epochs: int = 0

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> ClusterInfo:
        """Deep copy, like SchedulerCache.Snapshot (cache.go:712-811)."""
        return self.ci.clone()

    def live_view(self) -> ClusterInfo:
        """The authoritative ClusterInfo itself, for a persistent session
        maintained across cycles by dirty marks + refresh_snapshot (the
        reference's cache is likewise one live structure patched by event
        handlers; Snapshot's deep copy exists only for cycle isolation the
        synchronous loop doesn't need)."""
        return self.ci

    def mark_dirty(self, job_uid: Optional[str] = None,
                   node_name: Optional[str] = None,
                   structural: bool = False) -> None:
        if job_uid is not None:
            self.dirty_jobs.add(job_uid)
        if node_name is not None:
            self.dirty_nodes.add(node_name)
        if structural:
            if not self.structural:
                self.structural_epochs += 1
            self.structural = True

    def drain_dirty(self) -> Tuple[set, set, bool]:
        dj, dn, st = self.dirty_jobs, self.dirty_nodes, self.structural
        self.dirty_jobs, self.dirty_nodes = set(), set()
        self.structural = False
        return dj, dn, st

    # -------------------------------------------------------------- fencing
    def advance_fence(self, generation: Optional[int]) -> None:
        """Explicit fence announcement — the promoted leader's FIRST act
        (runtime/replication.WarmStandby.promote). Ratchets the fence
        without a data write, closing the window where a deposed leader's
        late write could land before the new leader's first bind."""
        if generation is not None:
            self.fence_generation = max(self.fence_generation,
                                        int(generation))

    def fence_admits(self, generation: Optional[int]) -> bool:
        """Read-only fence probe: would a write stamped ``generation`` be
        admitted right now? (None = unfenced caller, always admitted.)"""
        return generation is None or generation >= self.fence_generation

    def _check_fence(self, kind: str, task_uid: str,
                     generation: Optional[int]) -> bool:
        """Admit-or-reject a fenced write. Admission ratchets the fence
        forward (the new leader's first write deposes every older token);
        rejection is counted and logged — it is a permanent verdict for
        that token, not a retryable flake."""
        if generation is None:
            return True
        if generation < self.fence_generation:
            from ..metrics import METRICS
            METRICS.inc("fenced_writes_rejected_total",
                        labels={"kind": kind})
            self.fenced_rejections.append(
                (kind, task_uid, int(generation),
                 int(self.fence_generation)))
            return False
        self.fence_generation = int(generation)
        return True

    # ----------------------------------------------------------- bind/evict
    def bind(self, intent: BindIntent,
             fence: Optional[int] = None) -> bool:
        """Apply a bind: task becomes Bound on the node (defaultBinder.Bind,
        cache.go:123-143). Injectable failures exercise the resync path: a
        string value fails every attempt, an int value fails that many
        attempts then succeeds."""
        # fault-injection seam: a chaos bind_fail fault is a one-shot API
        # rejection, landing the intent in the scheduler's resync path
        if seam("cluster.bind", intent=intent) == "fail":
            return False
        if not self._check_fence("bind", intent.task_uid, fence):
            return False
        fail = self.bind_failures.get(intent.task_uid)
        if fail is not None:
            if isinstance(fail, int):
                if fail > 0:
                    self.bind_failures[intent.task_uid] = fail - 1
                    return False
                del self.bind_failures[intent.task_uid]
            else:
                return False
        job = self.ci.jobs.get(intent.job_uid)
        node = self.ci.nodes.get(intent.node_name)
        if job is None or node is None:
            return False
        task = job.tasks.get(intent.task_uid)
        if task is None:
            return False
        # BindVolumes precedes the pod bind (ssn.dispatch, session.go:330-338
        # -> defaultVolumeBinder.BindVolumes, cache.go:265-272): an
        # unbindable claim fails the whole bind into the resync path
        for claim in task.pvcs:
            pvc = self.ci.pvcs.get(claim)
            if (pvc is None or not pvc.bindable
                    or claim in self.volume_bind_failures):
                return False
        for claim in task.pvcs:
            self.ci.pvcs[claim].bound = True
        old_status, old_gpu = task.status, task.gpu_index
        removed_from = None
        if task.uid in self.ci.nodes.get(task.node_name, node).tasks:
            removed_from = self.ci.nodes[task.node_name]
            removed_from.remove_task(task)
        job.update_task_status(task, TaskStatus.BOUND)
        # apply the shared-GPU card chosen by the cycle before accounting,
        # like the GPU-index pod patch ahead of AddPod (predicates.go:140-151)
        task.gpu_index = intent.gpu_index
        try:
            node.add_task(task)
        except ValueError:
            # boundary exact-fit rejected by the host float64 check (the
            # device admits with float32 slack): a failed bind, like
            # defaultBinder.Bind returning an error (cache.go:123-143) —
            # the caller's resync path retries it. Restore the prior
            # placement exactly: same status, same node accounting.
            job.update_task_status(task, old_status)
            task.gpu_index = old_gpu
            if removed_from is not None:
                removed_from.add_task(task, force=True)
            else:
                task.node_name = ""
            return False
        self.binds.append((intent.task_uid, intent.node_name))
        self.dirty_jobs.add(job.uid)
        self.dirty_nodes.add(node.name)
        if removed_from is not None and removed_from is not node:
            self.dirty_nodes.add(removed_from.name)
        return True

    def evict(self, intent: EvictIntent,
              fence: Optional[int] = None) -> bool:
        """Apply an eviction: task goes back to Pending off-node
        (defaultEvictor.Evict, cache.go:145-175)."""
        if seam("cluster.evict", intent=intent) == "fail":
            return False
        if not self._check_fence("evict", intent.task_uid, fence):
            return False
        job = self.ci.jobs.get(intent.job_uid)
        if job is None:
            return False
        task = job.tasks.get(intent.task_uid)
        if task is None:
            return False
        node = self.ci.nodes.get(task.node_name)
        if node is not None and task.uid in node.tasks:
            node.remove_task(task)
        task.node_name = ""
        job.update_task_status(task, TaskStatus.PENDING)
        self.evictions.append(intent.task_uid)
        self.dirty_jobs.add(job.uid)
        if node is not None:
            self.dirty_nodes.add(node.name)
        return True

    def hold_binding(self, intent: BindIntent) -> None:
        """After a failed bind dispatch the cache keeps the task in Binding
        holding its decided node (the session's UpdateTaskStatus persists
        until syncTask resets it, cache.go:549-560 + 687-709), so later
        cycles do not re-decide it while the retry queue works."""
        job = self.ci.jobs.get(intent.job_uid)
        node = self.ci.nodes.get(intent.node_name)
        if job is None or node is None:
            return
        task = job.tasks.get(intent.task_uid)
        if task is None or task.status != TaskStatus.PENDING:
            return
        job.update_task_status(task, TaskStatus.BINDING)
        task.gpu_index = intent.gpu_index
        try:
            node.add_task(task)
            self.dirty_nodes.add(node.name)
        except ValueError:
            job.update_task_status(task, TaskStatus.PENDING)
            task.gpu_index = -1
        self.dirty_jobs.add(job.uid)

    def resync_task(self, task_uid: str) -> None:
        """Give-up resync: reset a Binding task to Pending off-node — the
        syncTask refetch discovering the pod never scheduled
        (cache.go:690-709)."""
        for job in self.ci.jobs.values():
            task = job.tasks.get(task_uid)
            if task is None:
                continue
            if task.status == TaskStatus.BINDING:
                node = self.ci.nodes.get(task.node_name)
                if node is not None and task.uid in node.tasks:
                    node.remove_task(task)
                    self.dirty_nodes.add(node.name)
                task.node_name = ""
                task.gpu_index = -1
                job.update_task_status(task, TaskStatus.PENDING)
                self.dirty_jobs.add(job.uid)
            return

    def update_podgroup_phases(self, phase_updates) -> None:
        for uid, phase in phase_updates.items():
            job = self.ci.jobs.get(uid)
            if job is not None and job.pod_group_phase != phase:
                job.pod_group_phase = phase
                self.dirty_jobs.add(uid)

    # --------------------------------------------------- lifecycle helpers
    def add_node(self, node) -> None:
        """Autoscaler-style node arrival: register + structural mark."""
        self.ci.add_node(node)
        self.mark_dirty(node_name=node.name, structural=True)

    def remove_node(self, name: str) -> bool:
        """Autoscaler-style node departure. Refuses a node still carrying
        tasks (a real autoscaler drains first); returns whether removed."""
        node = self.ci.nodes.get(name)
        if node is None or node.tasks:
            return False
        del self.ci.nodes[name]
        self.mark_dirty(structural=True)
        return True

    def remove_job(self, job_uid: str) -> bool:
        """Retire a job: free its tasks' node accounting, drop the job,
        raise the structural mark. Returns whether the job existed."""
        job = self.ci.jobs.get(job_uid)
        if job is None:
            return False
        for task in job.tasks.values():
            node = self.ci.nodes.get(task.node_name)
            if node is not None and task.uid in node.tasks:
                node.remove_task(task)
                self.mark_dirty(node_name=node.name)
        del self.ci.jobs[job_uid]
        self.mark_dirty(job_uid=job_uid, structural=True)
        return True

    def run_task(self, task_uid: str) -> None:
        """Kubelet-style transition Bound -> Running."""
        for job in self.ci.jobs.values():
            task = job.tasks.get(task_uid)
            if task is not None:
                node = self.ci.nodes.get(task.node_name)
                if node is not None and task.uid in node.tasks:
                    node.remove_task(task)
                    job.update_task_status(task, TaskStatus.RUNNING)
                    node.add_task(task)
                    self.dirty_nodes.add(node.name)
                else:
                    job.update_task_status(task, TaskStatus.RUNNING)
                self.dirty_jobs.add(job.uid)
                return
