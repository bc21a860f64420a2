"""Small policy plugins: priority, predicates, binpack, nodeorder,
conformance.

Each contributes static weights or vetoes that the Session folds into the
device passes (the same classes as ``volcano_tpu/plugins/simple_plugins.py``;
overcommit and sla come with the slice that ports what they feed):

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
"""

from __future__ import annotations

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
