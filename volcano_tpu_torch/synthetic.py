"""Synthetic clusters at any scale, for the chip check and the tests.

A copy of ``_synthetic_cluster`` from the repository's ``__graft_entry__.py``
with the same ``numpy.random.RandomState`` call sequence, so both packages
build the same cluster from the same seed: uniform 16-cpu / 64Gi / 110-pod
nodes, two queues, and gangs of ``tasks_per_job`` tasks with minAvailable
half the gang, random priorities and random 0.5-1.5 cpu requests.

:func:`affinity_scenario` is a copy of ``scripts/affinity_record.scenario``
(the repository's BASELINE configuration 5) on the same seeds.
"""

from __future__ import annotations

import numpy as np

from .api import (ClusterInfo, JobInfo, NodeInfo, PodAffinityTerm,
                  PodGroupPhase, QueueInfo, Resource, TaskInfo)


def _synthetic_cluster(n_nodes: int, n_jobs: int, tasks_per_job: int,
                       seed: int = 0) -> ClusterInfo:
    rng = np.random.RandomState(seed)
    ci = ClusterInfo()
    for i in range(n_nodes):
        ci.add_node(NodeInfo(
            f"n{i:05d}",
            allocatable=Resource.from_resource_list(
                {"cpu": "16", "memory": "64Gi", "pods": "110"})))
    ci.add_queue(QueueInfo("default", weight=1))
    ci.add_queue(QueueInfo("batch", weight=2))
    for j in range(n_jobs):
        queue = "default" if j % 2 == 0 else "batch"
        job = JobInfo(f"default/job-{j:05d}", queue=queue,
                      min_available=max(1, tasks_per_job // 2),
                      priority=int(rng.randint(3)),
                      creation_timestamp=float(j),
                      # already past the enqueue gate (Inqueue), like live
                      # PodGroups mid-flight when a cycle starts
                      pod_group_phase=PodGroupPhase.INQUEUE)
        for t in range(tasks_per_job):
            job.add_task(TaskInfo(
                uid=f"default/job-{j:05d}-{t}", name=f"job-{j:05d}-{t}",
                resreq=Resource.from_resource_list(
                    {"cpu": f"{rng.randint(1, 4) * 500}m", "memory": "1Gi"})))
        ci.add_job(job)
    return ci


def affinity_scenario(n_nodes: int = 10000, n_jobs: int = 2500,
                      seed: int = 0) -> ClusterInfo:
    """BASELINE configuration 5, topology-aware binpack: gangs of 8 on
    nodes labelled with 16 zones and ``n_nodes // 20`` racks; each task
    carries its job's app label (8 apps), and a tenth of the tasks carry
    required rack anti-affinity to their own app, another tenth preferred
    zone affinity of weight 10 to it."""
    rng = np.random.RandomState(seed)
    ci = _synthetic_cluster(n_nodes=n_nodes, n_jobs=n_jobs, tasks_per_job=8)
    apps = [f"app{i}" for i in range(8)]
    for i, node in enumerate(ci.nodes.values()):
        node.labels["zone"] = f"z{i % 16}"
        node.labels["rack"] = f"r{i % max(1, n_nodes // 20)}"
    for j, job in enumerate(ci.jobs.values()):
        app = apps[j % len(apps)]
        for t in job.tasks.values():
            t.labels["app"] = app
            r = rng.rand()
            if r < 0.10:
                t.pod_anti_affinity = [PodAffinityTerm(
                    topology_key="rack", match_labels={"app": app})]
            elif r < 0.20:
                t.pod_affinity_preferred = [PodAffinityTerm(
                    topology_key="zone", match_labels={"app": app},
                    weight=10)]
    return ci
