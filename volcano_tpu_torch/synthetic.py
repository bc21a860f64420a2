"""Synthetic clusters at any scale, for the chip check and the tests.

A copy of ``_synthetic_cluster`` from the repository's ``__graft_entry__.py``
with the same ``numpy.random.RandomState`` call sequence, so both packages
build the same cluster from the same seed: uniform 16-cpu / 64Gi / 110-pod
nodes, two queues, and gangs of ``tasks_per_job`` tasks with minAvailable
half the gang, random priorities and random 0.5-1.5 cpu requests.

:func:`affinity_scenario` is a copy of ``scripts/affinity_record.scenario``
(the repository's BASELINE configuration 5) on the same seeds.
:func:`admission_scenario` is a burst of freshly submitted PodGroups on the
bench's fair-share configuration, for the enqueue and backfill actions.

These functions take the module of ``api`` classes to build with (by default
the port's), so a test can build the same cluster for another package.
"""

from __future__ import annotations

import numpy as np

from . import api as port_api
from .api import ClusterInfo, PodAffinityTerm


def _synthetic_cluster(n_nodes: int, n_jobs: int, tasks_per_job: int,
                       seed: int = 0, api=None) -> ClusterInfo:
    api = api or port_api
    rng = np.random.RandomState(seed)
    ci = api.ClusterInfo()
    for i in range(n_nodes):
        ci.add_node(api.NodeInfo(
            f"n{i:05d}",
            allocatable=api.Resource.from_resource_list(
                {"cpu": "16", "memory": "64Gi", "pods": "110"})))
    ci.add_queue(api.QueueInfo("default", weight=1))
    ci.add_queue(api.QueueInfo("batch", weight=2))
    for j in range(n_jobs):
        queue = "default" if j % 2 == 0 else "batch"
        job = api.JobInfo(f"default/job-{j:05d}", queue=queue,
                          min_available=max(1, tasks_per_job // 2),
                          priority=int(rng.randint(3)),
                          creation_timestamp=float(j),
                          # already past the enqueue gate (Inqueue), like
                          # live PodGroups mid-flight when a cycle starts
                          pod_group_phase=api.PodGroupPhase.INQUEUE)
        for t in range(tasks_per_job):
            job.add_task(api.TaskInfo(
                uid=f"default/job-{j:05d}-{t}", name=f"job-{j:05d}-{t}",
                resreq=api.Resource.from_resource_list(
                    {"cpu": f"{rng.randint(1, 4) * 500}m", "memory": "1Gi"})))
        ci.add_job(job)
    return ci


def fair_share_cluster(n_nodes: int = 1024, n_jobs: int = 3125,
                       tasks_per_job: int = 16, api=None) -> ClusterInfo:
    """The bench's configuration 3 (bench.py:680-716): 8 queues q0..q7 of
    weight 1 + q % 4 over ``_synthetic_cluster``, job j in q{j % 8}."""
    api = api or port_api
    ci = _synthetic_cluster(n_nodes, n_jobs, tasks_per_job, api=api)
    for q in range(8):
        ci.add_queue(api.QueueInfo(f"q{q}", weight=1 + q % 4))
    for j, job in enumerate(ci.jobs.values()):
        job.queue = f"q{j % 8}"
    return ci


def admission_scenario(n_nodes: int = 1024, n_jobs: int = 3125,
                       tasks_per_job: int = 16, n_best_effort: int = 1024,
                       api=None) -> ClusterInfo:
    """The fair-share cluster as a burst of freshly submitted jobs, for the
    shipped conf's enqueue, allocate and backfill actions:

    - every PodGroup is Pending, with ``min_resources`` the sum of its
      first minAvailable tasks' requests (the job controller's
      calcPGMinResources, controllers/job_controller.py:224-240);
    - each queue q has a cpu capability of the cluster's cores x its
      weight / 20 (the weights sum to 20) and no memory capability, so the
      proportion gate refuses part of every queue;
    - every 10th gang carries ``sla_waiting_time: 300s``; gang j is created
      at j seconds (gang 0 too: ``JobInfo`` turns a creation time of 0
      into the wall clock, so it is set after construction);
    - ``n_best_effort`` jobs of one zero-request task each (minAvailable
      1, queue q{k % 8}, created at ``n_jobs + k``), for backfill."""
    api = api or port_api
    ci = fair_share_cluster(n_nodes, n_jobs, tasks_per_job, api=api)
    for q in range(8):
        millicores = 16 * n_nodes * 1000 * (1 + q % 4) // 20
        ci.queues[f"q{q}"].capability = api.Resource({"cpu": millicores})
    for j, job in enumerate(ci.jobs.values()):
        job.pod_group_phase = api.PodGroupPhase.PENDING
        job.creation_timestamp = float(j)
        minres = api.Resource()
        for task in list(job.tasks.values())[:job.min_available]:
            minres.add(task.resreq)
        job.min_resources = minres
        if j % 10 == 0:
            job.sla_waiting_time = "300s"
    for k in range(n_best_effort):
        job = api.JobInfo(f"default/be-{k:05d}", queue=f"q{k % 8}",
                          min_available=1,
                          creation_timestamp=float(n_jobs + k),
                          pod_group_phase=api.PodGroupPhase.PENDING)
        job.add_task(api.TaskInfo(uid=f"default/be-{k:05d}-0",
                                  name=f"be-{k:05d}-0",
                                  resreq=api.Resource()))
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
