"""Shared helpers of the tests that hold volcano_tpu_torch against volcano_tpu.

Clusters are built with either package's own ``api`` from one numpy seed;
snapshots packed by the JAX package reach the port as the same bytes through
``arrays.schema.snapshot_from_numpy``; round placer inputs come from
:func:`make_inputs`, dynamic-key placer inputs from the port's
``ops/dyn_cases.py``. Imports nothing of JAX at module level, so the card-only
tests can use it on a machine without JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

# the placer cases shared with chip_smoke.py
from volcano_tpu_torch.ops.dyn_cases import (  # noqa: F401
    DYN_CASES, DYN_FLAGS, PLACER_WEIGHTS, make_dyn_inputs)


def tree_to_numpy(tree):
    """A dataclass tree of arrays (JAX or numpy) as nested dicts of numpy."""
    if dataclasses.is_dataclass(tree):
        return {f.name: tree_to_numpy(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def port_inputs(snap, extras, device="cpu"):
    """The port's (SnapshotArrays, AllocateExtras) from the JAX package's."""
    from volcano_tpu_torch.arrays import snapshot_from_numpy
    return snapshot_from_numpy(tree_to_numpy(snap), tree_to_numpy(extras),
                               device)


def port_cfg(cfg, **overrides):
    """The port's AllocateConfig with the fields of a JAX one."""
    from volcano_tpu_torch.ops.allocate_scan import AllocateConfig
    fields = {f.name for f in dataclasses.fields(AllocateConfig)}
    kw = {k: v for k, v in dataclasses.asdict(cfg).items() if k in fields}
    kw.update(overrides)
    return AllocateConfig(**kw)


def fingerprint(task_node, task_mode) -> str:
    """The bench's decision fingerprint (bench.py:318-320)."""
    return hashlib.sha256(np.asarray(task_node).tobytes()
                          + np.asarray(task_mode).tobytes()).hexdigest()[:16]


def oracle_packed(out) -> np.ndarray:
    """allocate_cpu's result dict in the packed_decisions layout."""
    return np.concatenate([
        np.asarray(out[k]).astype(np.int32) for k in (
            "task_node", "task_mode", "task_gpu", "job_ready",
            "job_pipelined", "job_attempted")])


def random_cluster(api, seed, n_nodes=6, n_jobs=5, gpus=False, taints=False):
    """tests/test_pallas_place.random_cluster, built with ``api`` (the JAX
    package's or the port's) so both packages get the same cluster."""
    rng = np.random.RandomState(seed)

    def res(cpu, memory, scalars):
        rl = {"cpu": cpu, "memory": memory}
        rl.update(scalars)
        return api.Resource.from_resource_list(rl)

    ci = api.ClusterInfo()
    ci.add_queue(api.QueueInfo("default", weight=1))
    for i in range(n_nodes):
        scalars = {}
        if gpus and i % 2 == 0:
            scalars = {api.GPU_MEMORY_RESOURCE: 16,
                       api.GPU_NUMBER_RESOURCE: 2}
        node = api.NodeInfo(f"n{i}", allocatable=res(
            str(2 + int(rng.randint(4))), "8Gi", scalars), labels={},
            max_pods=110)
        if taints and i % 3 == 0:
            node.taints.append(api.Taint("dedicated", "batch",
                                         "PreferNoSchedule"))
        ci.add_node(node)
    ci.add_queue(api.QueueInfo("batch", weight=2))
    for j in range(n_jobs):
        queue = "default" if j % 2 == 0 else "batch"
        n_tasks = 1 + int(rng.randint(3))
        job = api.JobInfo(uid=f"default/j{j}", name=f"j{j}",
                          namespace="default", queue=queue,
                          priority=int(rng.randint(3)),
                          min_available=max(1, n_tasks - 1),
                          pod_group_phase=api.PodGroupPhase.INQUEUE)
        for t in range(n_tasks):
            scalars = {}
            if gpus and rng.rand() < 0.5:
                scalars = {api.GPU_MEMORY_RESOURCE: int(rng.randint(1, 10))}
            task = api.TaskInfo(
                uid=f"default/j{j}-t{t}", name=f"j{j}-t{t}",
                namespace="default",
                resreq=res(f"{int(rng.randint(1, 4)) * 500}m", "1Gi",
                           scalars),
                status=api.TaskStatus.PENDING,
                priority=int(rng.randint(2)), task_role="")
            if taints and rng.rand() < 0.3:
                task.tolerations.append(api.Toleration(
                    key="dedicated", operator="Equal", value="batch",
                    effect=""))
            job.add_task(task)
        ci.add_job(job)
    return ci


F32, I32 = np.float32, np.int32


def make_inputs(seed, K=8, M=4, N=40, R=2, G=2, GR=2, P=3, gpu=True,
                tight=False, releasing=False, big_gangs=False):
    """Flat placer arguments (numpy) in the kernel's order. Values sit on
    a 0.25 grid, so scores tie and capacity hits exact fits."""
    rng = np.random.RandomState(seed)
    KM = K * M

    def grid(*shape, lo=0.0, hi=8.0):
        return (rng.randint(int(lo * 4), int(hi * 4) + 1, size=shape)
                / 4.0).astype(F32)

    def flags(p, *shape):
        return (rng.rand(*shape) < p).astype(I32)

    resreq = grid(R, KM, lo=0.0, hi=3.0)
    gpu_req = np.where(rng.rand(1, KM) < 0.5,
                       rng.randint(1, 8, (1, KM)), 0).astype(F32)
    pref = np.where(rng.rand(1, KM) < 0.2, rng.randint(0, N, (1, KM)),
                    -1).astype(I32)
    suffix = rng.randint(0, 3, (1, KM)).astype(I32)
    tmpl = rng.randint(0, P, (1, KM)).astype(I32)
    grp = np.where(rng.rand(1, KM) < 0.3, rng.randint(0, GR, (1, KM)),
                   -1).astype(I32)
    voln = np.where(rng.rand(1, KM) < 0.1, rng.randint(0, N, (1, KM)),
                    -1).astype(I32)
    volok = flags(0.95, 1, KM)
    rev = flags(0.3, 1, KM)
    active = flags(0.9, 1, KM)
    ready0 = rng.randint(0, 2, (1, K)).astype(I32)
    hi_min = 2 * M if big_gangs else M
    minav = rng.randint(1, hi_min + 1, (1, K)).astype(I32)
    canb = flags(0.5, 1, K)
    secact = flags(0.9, 1, K)
    istgt = flags(0.2, 1, K)
    tstat = (rng.rand(P, N) < 0.85).astype(F32)
    tscore = (rng.randint(0, 5, (P, N)) * 25).astype(F32)
    nascore = (rng.randint(0, 3, (P, N)) * 10).astype(F32)
    blocknr = flags(0.1, 1, N).astype(F32)
    blockall = flags(0.05, 1, N).astype(F32)
    bonus = (flags(0.3, 1, N) * 100).astype(F32)
    locked = flags(0.1, 1, N).astype(F32)
    orfeas = (rng.rand(GR, N) < 0.7).astype(F32)
    alloc = grid(R, N, lo=2.0, hi=8.0)
    alloc[rng.rand(R, N) < 0.05] = 0.0
    idle = np.minimum(alloc, grid(R, N, hi=2.0 if tight else 8.0))
    relmp = grid(R, N, lo=-1.0, hi=6.0 if releasing else 1.0)
    if releasing:
        idle = np.minimum(idle, grid(R, N, hi=0.5))
    cnt = rng.randint(0, 5, (1, N)).astype(F32)
    maxp = rng.randint(3, 9, (1, N)).astype(F32)
    gidle0 = rng.randint(0, 16, (G, N)).astype(F32)
    pipe = grid(R, N, hi=0.5)
    pods = rng.randint(0, 2, (1, N)).astype(F32)
    gpux = rng.randint(0, 3, (G, N)).astype(F32)
    args = [resreq] + ([gpu_req] if gpu else []) + [
        pref, suffix, tmpl, grp, voln, volok, rev, active,
        ready0, minav, canb, secact, istgt,
        tstat, tscore, nascore, blocknr, blockall, bonus, locked, orfeas,
        relmp, alloc, cnt, maxp] + ([gidle0] if gpu else []) + [
        idle, pipe, pods] + ([gpux] if gpu else [])
    return args


CASES = {
    "gpu_on": dict(gpu=True),
    "gpu_off": dict(gpu=False),
    "gang_discard": dict(gpu=True, tight=True, big_gangs=True),
    "pipelining_on_releasing": dict(gpu=False, releasing=True),
    "three_resources": dict(gpu=True, R=3),
    "one_section": dict(gpu=True, K=1, M=8),
    "n_not_multiple_of_128": dict(gpu=True, N=200, M=6),
}


def affinity_cluster(api, seed, n_nodes=8, n_jobs=6):
    """random_cluster with node labels, required node-affinity OR terms,
    preferred terms and volume claims (one pinned to a node, one that
    cannot bind): what the predicates and nodeorder plugins feed the cycle
    through framework/host_extras.py."""
    rng = np.random.RandomState(seed)
    ci = random_cluster(api, seed, n_nodes=n_nodes, n_jobs=n_jobs)
    for i, node in enumerate(ci.nodes.values()):
        node.labels.update({"zone": "ab"[i % 2], "tier": str(i % 3)})
    ci.pvcs["local"] = api.cluster_info.PersistentVolumeClaim("local", node_name="n1")
    ci.pvcs["lost"] = api.cluster_info.PersistentVolumeClaim("lost", bindable=False)
    zone_a = api.NodeSelectorTerm(match_labels={"zone": "a"})
    tier_hi = api.NodeSelectorTerm(match_expressions=[("tier", "Gt", ("0",))])
    for job in ci.jobs.values():
        for task in job.tasks.values():
            u = rng.rand()
            if u < 0.3:
                task.affinity_required = [zone_a, tier_hi]
            elif u < 0.45:
                task.affinity_required = [{"zone": "b"}]
            if rng.rand() < 0.4:
                task.affinity_preferred = [(tier_hi, 3), ({"zone": "b"}, 5)]
    first = [next(iter(job.tasks.values())) for job in ci.jobs.values()]
    first[0].pvcs = ["local"]
    first[1].pvcs = ["lost"]
    return ci


def hdrf_cluster(api, node_cpu, node_mem, queue_specs, pg_specs):
    """tests/test_hdrf._hdrf_cluster, built with ``api``: one node, queues
    (name, hierarchy, weights), and PodGroups (pg, queue, n_tasks, cpu,
    memory bytes) without MinMember."""
    ci = api.ClusterInfo()
    ci.add_node(api.NodeInfo("n", allocatable=api.Resource.from_resource_list(
        {"cpu": node_cpu, "memory": node_mem}), labels={}, max_pods=110))
    for name, hierarchy, weights in queue_specs:
        ci.add_queue(api.QueueInfo(name, weight=1, hierarchy=hierarchy,
                                   hierarchy_weights=weights))
    for pg, queue, n_tasks, cpu, mem in pg_specs:
        job = api.JobInfo(uid=f"default/{pg}", name=pg, namespace="default",
                          queue=queue, priority=0, min_available=0,
                          pod_group_phase=api.PodGroupPhase.INQUEUE)
        for i in range(n_tasks):
            job.add_task(api.TaskInfo(
                uid=f"default/{pg}-p{i}", name=f"{pg}-p{i}",
                namespace="default",
                resreq=api.Resource.from_resource_list(
                    {"cpu": cpu, "memory": str(mem)}),
                status=api.TaskStatus.PENDING, priority=0, task_role=""))
        ci.add_job(job)
    return ci


#: the hdrf_test.go rescaling scenario (tests/test_pallas_place.py
#: TestDynamicKeyRounds.test_hdrf_frozen_columns_guard)
HDRF_SCENARIO = (
    "10", str(10 * 2 ** 30),
    [("root-sci", "root/sci", "100/50"),
     ("root-eng-dev", "root/eng/dev", "100/50/50"),
     ("root-eng-prod", "root/eng/prod", "100/50/50")],
    [("pg1", "root-sci", 10, "1", 2 ** 30),
     ("pg21", "root-eng-dev", 10, "1", 0),
     ("pg22", "root-eng-prod", 10, "0", 2 ** 30)])
