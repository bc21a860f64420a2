"""Synthetic clusters at any scale, for the chip check and the tests.

A copy of ``_synthetic_cluster`` from the repository's ``__graft_entry__.py``
with the same ``numpy.random.RandomState`` call sequence, so both packages
build the same cluster from the same seed: uniform 16-cpu / 64Gi / 110-pod
nodes, two queues, and gangs of ``tasks_per_job`` tasks with minAvailable
half the gang, random priorities and random 0.5-1.5 cpu requests.

:func:`affinity_scenario` is a copy of ``scripts/affinity_record.scenario``
(the repository's BASELINE configuration 5) on the same seeds.
``_synthetic_cluster(..., extended=10)`` is a MIG-partitioned GPU cluster
(:data:`MIG_RESOURCES`), and :func:`scalar_cluster` a small cluster of any
number of resource dims.
:func:`admission_scenario` is a burst of freshly submitted PodGroups on the
bench's fair-share configuration, for the enqueue and backfill actions.

These functions take the module of ``api`` classes to build with (by default
the port's), so a test can build the same cluster for another package.
"""

from __future__ import annotations

import numpy as np

from . import api as port_api
from .api import ClusterInfo, PodAffinityTerm


#: the extended resources a MIG-partitioned GPU cluster advertises, in the
#: order ``_synthetic_cluster(..., extended=k)`` adds the first k of them
MIG_RESOURCES = (
    "nvidia.com/gpu", "nvidia.com/mig-1g.10gb", "nvidia.com/mig-2g.20gb",
    "nvidia.com/mig-3g.40gb", "nvidia.com/mig-7g.80gb", "hugepages-2Mi",
    "hugepages-1Gi", "rdma/hca", "ephemeral-storage",
    "nvidia.com/mig-4g.40gb")


def _extended_amounts(rng, n_nodes: int, n_jobs: int, names):
    """Per node and per job, the amounts of the extended resources
    ``names`` (a subset of :data:`MIG_RESOURCES`) as quantity strings,
    from ``rng`` alone. Nodes: three of four are GPU nodes (8 GPUs, some
    of them cut into MIG slices, RDMA devices, 1Gi hugepages), the rest
    CPU nodes (2Mi hugepages and local storage only); every node has
    ephemeral storage. Jobs (every task of a job asks the same, as a
    training job's pods do): half want a whole GPU, a fifth a MIG slice,
    most an RDMA device, some hugepages and scratch storage. RDMA devices
    and MIG slices are scarcer than the requests for them, so these dims
    decide where gangs go and which ones fit."""
    nodes, jobs = [], []
    for i in range(n_nodes):
        gpu = i % 4 != 3
        full = {
            "nvidia.com/gpu": str(8 if gpu else 0),
            "nvidia.com/mig-1g.10gb": str(rng.randint(0, 8) if gpu else 0),
            "nvidia.com/mig-2g.20gb": str(rng.randint(0, 4) if gpu else 0),
            "nvidia.com/mig-3g.40gb": str(rng.randint(0, 3) if gpu else 0),
            "nvidia.com/mig-7g.80gb": str(rng.randint(0, 2) if gpu else 0),
            "hugepages-2Mi": f"{rng.randint(1, 9) * 256}Mi",
            "hugepages-1Gi": f"{rng.randint(0, 5) if gpu else 0}Gi",
            "rdma/hca": str(rng.randint(1, 5) if gpu else 0),
            "ephemeral-storage": f"{rng.randint(2, 9) * 100}Gi",
            "nvidia.com/mig-4g.40gb": str(rng.randint(0, 2) if gpu else 0),
        }
        nodes.append({k: v for k, v in full.items() if k in names})
    for j in range(n_jobs):
        mig = rng.randint(5)
        want = {
            "nvidia.com/gpu": "1" if rng.rand() < 0.5 else None,
            "nvidia.com/mig-1g.10gb": "1" if mig == 1 else None,
            "nvidia.com/mig-2g.20gb": "1" if mig == 2 else None,
            "nvidia.com/mig-3g.40gb": "1" if mig == 3 else None,
            "nvidia.com/mig-7g.80gb": "1" if mig == 4 and rng.rand() < 0.3
            else None,
            "hugepages-2Mi": f"{rng.randint(1, 5) * 64}Mi"
            if rng.rand() < 0.4 else None,
            "hugepages-1Gi": "1Gi" if rng.rand() < 0.1 else None,
            "rdma/hca": "1" if rng.rand() < 0.6 else None,
            "ephemeral-storage": f"{rng.randint(1, 6) * 10}Gi",
            "nvidia.com/mig-4g.40gb": "1" if mig == 4 and rng.rand() < 0.2
            else None,
        }
        jobs.append({k: v for k, v in want.items()
                     if k in names and v is not None})
    return nodes, jobs


def _synthetic_cluster(n_nodes: int, n_jobs: int, tasks_per_job: int,
                       seed: int = 0, api=None,
                       namespaces: int = 0, extended: int = 0) -> ClusterInfo:
    """``namespaces`` > 0 puts job j and its tasks in namespace
    ``ns-{j % namespaces}`` (the same random draws), in place of
    ``default``. ``extended`` > 0 adds the first ``extended`` of
    :data:`MIG_RESOURCES` to every node and task (amounts drawn from a
    second generator, so the other draws stay the same): 2 + ``extended``
    resource dims."""
    api = api or port_api
    rng = np.random.RandomState(seed)
    ext_nodes, ext_jobs = _extended_amounts(
        np.random.RandomState(seed + 7919), n_nodes, n_jobs,
        MIG_RESOURCES[:extended]) if extended else (None, None)
    ci = api.ClusterInfo()
    for i in range(n_nodes):
        ci.add_node(api.NodeInfo(
            f"n{i:05d}",
            allocatable=api.Resource.from_resource_list(
                {"cpu": "16", "memory": "64Gi", "pods": "110",
                 **(ext_nodes[i] if extended else {})})))
    ci.add_queue(api.QueueInfo("default", weight=1))
    ci.add_queue(api.QueueInfo("batch", weight=2))
    for j in range(n_jobs):
        queue = "default" if j % 2 == 0 else "batch"
        ns = f"ns-{j % namespaces}" if namespaces else "default"
        job = api.JobInfo(f"{ns}/job-{j:05d}", queue=queue, namespace=ns,
                          min_available=max(1, tasks_per_job // 2),
                          priority=int(rng.randint(3)),
                          creation_timestamp=float(j),
                          # already past the enqueue gate (Inqueue), like
                          # live PodGroups mid-flight when a cycle starts
                          pod_group_phase=api.PodGroupPhase.INQUEUE)
        for t in range(tasks_per_job):
            job.add_task(api.TaskInfo(
                uid=f"{ns}/job-{j:05d}-{t}", name=f"job-{j:05d}-{t}",
                namespace=ns,
                resreq=api.Resource.from_resource_list(
                    {"cpu": f"{rng.randint(1, 4) * 500}m", "memory": "1Gi",
                     **(ext_jobs[j] if extended else {})})))
        ci.add_job(job)
    return ci


def scalar_cluster(n_dims: int, n_nodes: int = 8,
                   n_jobs: int = 4) -> ClusterInfo:
    """A small cluster whose resources have ``n_dims`` dims: cpu, memory
    and n_dims - 2 extended resources on every node and task, gangs of
    two, and one Pending gang (the last) for enqueue."""
    api = port_api
    extra = {f"example.com/r{k:02d}": "4" for k in range(n_dims - 2)}
    ci = api.ClusterInfo()
    ci.add_queue(api.QueueInfo("default", weight=1))
    for i in range(n_nodes):
        ci.add_node(api.NodeInfo(f"n{i}", allocatable=api.Resource
                                 .from_resource_list({"cpu": "16",
                                                      "memory": "64Gi",
                                                      "pods": "110",
                                                      **extra})))
    for j in range(n_jobs):
        job = api.JobInfo(f"default/j{j}", queue="default", min_available=2,
                          pod_group_phase=(api.PodGroupPhase.PENDING
                                           if j == n_jobs - 1
                                           else api.PodGroupPhase.INQUEUE))
        for t in range(2):
            job.add_task(api.TaskInfo(
                uid=f"default/j{j}-{t}", name=f"j{j}-{t}",
                resreq=api.Resource.from_resource_list(
                    {"cpu": "1", "memory": "1Gi",
                     **{k: "1" for k in extra}})))
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


def steady_churn(cluster: ClusterInfo, rng, frac: float = 0.05, api=None,
                 bound=None):
    """One cycle's churn of a steady training cluster, in place: of the
    gangs whose tasks are all bound (Binding), ``frac`` complete (their
    tasks Succeeded and off their nodes) and another ``frac`` go back to
    Pending (a gang resubmitted), as ``tests/test_refresh.py`` resets one.
    ``rng``: a ``numpy.random.RandomState``. ``bound``: the status of a
    bound task, Binding by default (a Session's binds); the scheduler loop
    flushes its binds to the cluster, which marks them Bound. Returns the
    touched job uids and node names, for ``Session.mark_dirty`` or the
    cluster's ``mark_dirty``."""
    api = api or port_api
    bound = api.TaskStatus.BINDING if bound is None else bound
    placed = sorted(uid for uid, job in cluster.jobs.items()
                    if job.tasks and all(t.status == bound
                                         for t in job.tasks.values()))
    n = int(round(frac * len(placed)))
    pick = [placed[i] for i in rng.permutation(len(placed))[:2 * n]]
    nodes = set()
    for k, uid in enumerate(pick):
        status = (api.TaskStatus.SUCCEEDED if k < n
                  else api.TaskStatus.PENDING)
        job = cluster.jobs[uid]
        for task in list(job.tasks.values()):
            node = cluster.nodes.get(task.node_name)
            if node is not None and task.uid in node.tasks:
                node.remove_task(task)
                nodes.add(node.name)
            job.update_task_status(task, status)
            task.node_name = ""
        job.allocated = type(job.allocated)({})
    return pick, sorted(nodes)
