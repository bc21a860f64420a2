"""Small policy plugins: priority, predicates, binpack, nodeorder,
conformance, overcommit, sla.

Each contributes static weights, gates or vetoes that the Session folds
into the device passes (the same classes as
``volcano_tpu/plugins/simple_plugins.py``):

- priority (pkg/scheduler/plugins/priority/priority.go:30-117): job/task
  priority ordering — the priority keys are always packed into the arrays;
  this plugin's presence is what turns them on in the reference conf.
- predicates (pkg/scheduler/plugins/predicates/predicates.go:42-288): turns
  on the node-affinity OR groups, volume binding and host ports
  (``framework/host_extras.py``); the feasibility conjunction itself is
  always compiled in.
- binpack (pkg/scheduler/plugins/binpack/binpack.go:157-260): best-fit score
  weight from the ``binpack.weight`` argument.
- nodeorder (pkg/scheduler/plugins/nodeorder/nodeorder.go:39-414): the k8s
  scorer weights (leastrequested, mostrequested, balancedresource,
  tainttoleration, podaffinity) and the node-affinity preferred score.
- conformance (pkg/scheduler/plugins/conformance/conformance.go:30-68):
  vetoes eviction of kube-system / critical pods.
- overcommit (pkg/scheduler/plugins/overcommit/overcommit.go:28-124): the
  enqueue pass's cluster-factor gate.
- sla (pkg/scheduler/plugins/sla/sla.go:33-148): the enqueue override for
  jobs past their waiting time, and the deadline job-order key.
"""

from __future__ import annotations

import re

import numpy as np

from .base import Plugin


class PriorityPlugin(Plugin):
    name = "priority"


class PredicatesPlugin(Plugin):
    name = "predicates"


class BinpackPlugin(Plugin):
    name = "binpack"

    def score_weights(self, ssn):
        return {"binpack_weight": self.arg_float("binpack.weight", 1.0)}


class NodeOrderPlugin(Plugin):
    name = "nodeorder"

    def score_weights(self, ssn):
        return {
            "least_allocated_weight":
                self.arg_float("leastrequested.weight", 1.0),
            "most_allocated_weight":
                self.arg_float("mostrequested.weight", 0.0),
            "balanced_weight":
                self.arg_float("balancedresource.weight", 1.0),
            "taint_prefer_weight":
                self.arg_float("tainttoleration.weight", 1.0),
            # InterPodAffinity batch scorer weight (nodeorder.go:104-140)
            "pod_affinity_weight":
                self.arg_float("podaffinity.weight", 1.0),
        }


#: k8s system priority classes (scheduling.SystemClusterCritical /
#: SystemNodeCritical, conformance.go:49-51)
SYSTEM_PRIORITY_CLASSES = ("system-cluster-critical", "system-node-critical")


class ConformancePlugin(Plugin):
    name = "conformance"

    def victim_veto(self, ssn) -> np.ndarray:
        """bool[T]: never evict kube-system tasks or pods in a system
        priority class (conformance.go:45-63 evictableFn skip rules)."""
        T = np.asarray(ssn.snap.tasks.status).shape[0]
        veto = np.zeros(T, bool)
        for job in ssn.cluster.jobs.values():
            for uid, task in job.tasks.items():
                ti = ssn.maps.task_index.get(uid)
                if ti is None:
                    continue
                if (task.namespace == "kube-system"
                        or task.priority_class in SYSTEM_PRIORITY_CLASSES):
                    veto[ti] = True
        return veto


class OvercommitPlugin(Plugin):
    name = "overcommit"

    def enqueue_gates(self, ssn):
        return {"enable_overcommit_gate": True,
                "overcommit_factor": self.arg_float("overcommit-factor", 1.2)}


_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)([hms])")


def parse_duration(s: str) -> float:
    """'1h30m' / '300s' -> seconds (Go time.ParseDuration subset)."""
    total, pos = 0.0, 0
    for m in _DURATION_RE.finditer(s):
        total += float(m.group(1)) * {"h": 3600, "m": 60, "s": 1}[m.group(2)]
        pos = m.end()
    if pos == 0:
        raise ValueError(f"unparseable duration: {s!r}")
    return total


class SLAPlugin(Plugin):
    name = "sla"

    def _job_waiting_time(self, job):
        """Per-job sla-waiting-time annotation overrides the plugin's
        global argument (readJobWaitingTime, sla.go:57-66); None = no SLA
        for the job at all."""
        if job.sla_waiting_time:
            try:
                return parse_duration(str(job.sla_waiting_time))
            except ValueError:
                pass
        arg = self.arg("sla-waiting-time")
        if arg is None:
            return None
        try:
            return parse_duration(str(arg))
        except ValueError:
            return None

    def sla_waiting(self, ssn) -> np.ndarray:
        """bool[J]: jobs waiting past their SLA (the JobEnqueueableFn
        Permit, sla.go:133-145)."""
        J = np.asarray(ssn.snap.jobs.valid).shape[0]
        waiting = np.zeros(J, bool)
        now = ssn.now
        for uid, ji in ssn.maps.job_index.items():
            job = ssn.cluster.jobs.get(uid)
            if job is None:
                continue
            jwt = self._job_waiting_time(job)
            if jwt is not None and now - job.creation_timestamp >= jwt:
                waiting[ji] = True
        return waiting

    def job_deadline(self, ssn) -> np.ndarray:
        """f32[J] jobOrderFn key (sla.go:104-131): jobs WITH a waiting time
        sort first, earliest creation+jwt deadline wins. Encoded relative
        to now (f32 seconds); no-SLA jobs get +inf."""
        J = np.asarray(ssn.snap.jobs.valid).shape[0]
        deadline = np.full(J, np.inf, np.float32)
        for uid, ji in ssn.maps.job_index.items():
            job = ssn.cluster.jobs.get(uid)
            if job is None:
                continue
            jwt = self._job_waiting_time(job)
            if jwt is not None:
                deadline[ji] = np.float32(
                    job.creation_timestamp + jwt - ssn.now)
        return deadline
