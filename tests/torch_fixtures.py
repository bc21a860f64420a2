"""Shared helpers of the tests that hold volcano_tpu_torch against volcano_tpu.

Clusters are built with either package's own ``api`` from one numpy seed;
snapshots packed by the JAX package reach the port as the same bytes through
``arrays.schema.snapshot_from_numpy``; placer inputs come from the port's
``ops/dyn_cases.py``. Imports nothing of JAX at module level, so the card-only
tests can use it on a machine without JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np

# the placer cases shared with chip_smoke.py
from volcano_tpu_torch.ops.dyn_cases import (  # noqa: F401
    AFF_CASES, CASES, DYN_CASES, DYN_FLAGS, PLACER_WEIGHTS, aff_placer_knobs,
    make_dyn_inputs, make_inputs)


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


def source_order_score(jcfg, a):
    """The reference shard kernels' score row [N] in its source order, for
    the task of ``a`` (``shard_placer.ShardArgs`` of torch tensors: its
    ``req`` [1, R (+1)] and ``task`` [1, 6] rows): the reference's own
    ``_dyn_score`` run eagerly, one operation at a time, then the kernels'
    float32 adds (pallas_place.py:1202-1207) in numpy. XLA's CPU backend,
    which runs the interpret kernels, rewrites this arithmetic (ROADMAP
    section 3 (f)); the port keeps the source order."""
    import jax.numpy as jnp
    from volcano_tpu.ops.pallas_place import _dyn_score as jax_dyn_score
    R, N = a.idle.shape
    pref, tmpl, _, _, _, rev = a.task[0].tolist()
    f32 = np.float32
    score = np.asarray(jax_dyn_score(jcfg, jnp.asarray(a.idle.numpy()),
                                     jnp.asarray(a.alloc.numpy()),
                                     jnp.asarray(a.req[0, :R, None].numpy())))
    score = score + a.tscore[tmpl:tmpl + 1].numpy()
    score = score + (a.nascore[tmpl:tmpl + 1].numpy()
                     + (a.bonus.numpy() if rev else f32(0)))
    score = score + np.where((pref >= 0) & (np.arange(N) == pref), f32(100),
                             f32(0))
    return score[0]


def oracle_packed(out) -> np.ndarray:
    """allocate_cpu's result dict in the packed_decisions layout."""
    return np.concatenate([
        np.asarray(out[k]).astype(np.int32) for k in (
            "task_node", "task_mode", "task_gpu", "job_ready",
            "job_pipelined", "job_attempted")])


def session_pair(build, conf_text):
    """Run ``run_allocate`` in the JAX Session and in the port's (on the
    CPU) on the cluster ``build(api)`` makes with each package's ``api``,
    under the conf ``conf_text`` (None: the built-in default). Returns
    (JAX outcome, port outcome, port Session); an outcome is the binds
    (task uid -> node, GPU card), the held placements, the PodGroup phase
    updates and the conditions."""
    import volcano_tpu.api as japi
    from volcano_tpu.framework import Session as JaxSession
    from volcano_tpu.framework import parse_conf as jax_parse_conf

    import volcano_tpu_torch.api as tapi
    from volcano_tpu_torch.framework import Session, parse_conf

    def outcome(ssn):
        ssn.close()
        return ({b.task_uid: (b.node_name, b.gpu_index) for b in ssn.binds},
                dict(ssn.pipelined), dict(ssn.phase_updates),
                dict(ssn.conditions))

    jax_ssn = JaxSession(build(japi), jax_parse_conf(conf_text))
    jax_ssn.run_allocate()
    port_ssn = Session(build(tapi), parse_conf(conf_text), device="cpu")
    port_ssn.run_allocate()
    return outcome(jax_ssn), outcome(port_ssn), port_ssn


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


def pod_affinity_cluster(api, seed, n_nodes, n_jobs, zones=8, racks=32,
                         tasks_lo=1, tasks_hi=4, running_pods=12, cpu="4",
                         namespaces=False, expressions=False):
    """tests/test_affinity._random_affinity_cluster, built with ``api``:
    a zone/rack topology, a mixed required / preferred inter-pod workload
    over 5 apps, and running pods that seed the static counts. With
    ``namespaces`` some jobs live in a second namespace and some terms name
    namespaces; with ``expressions`` some terms select by
    ``match_expressions``, and preferred anti-affinity appears."""
    rng = np.random.default_rng(seed)
    res = api.Resource.from_resource_list({"cpu": cpu, "memory": "16Gi"})
    ci = api.ClusterInfo()
    ci.add_queue(api.QueueInfo("default", weight=1))
    for i in range(n_nodes):
        n = api.NodeInfo(f"n{i}", res.clone(), res.clone())
        n.labels["zone"] = f"z{i % zones}"
        n.labels["kubernetes.io/hostname"] = f"n{i}"
        n.labels["rack"] = f"r{i % racks}"
        ci.add_node(n)

    def task(name, labels, ns="default", status=None):
        t = api.TaskInfo(name, name, namespace=ns, labels=labels,
                         resreq=api.Resource.from_resource_list(
                             {"cpu": "1", "memory": "1Gi"}))
        if status is not None:
            t.status = status
        return t

    def term(key, app, weight=0):
        kw = dict(topology_key=key, weight=weight)
        u = rng.random() if (namespaces or expressions) else 1.0
        if expressions and u < 0.3:
            kw["match_expressions"] = [("app", "In", [app, "app4"])]
        elif expressions and u < 0.4:
            kw["match_expressions"] = [("app", "Exists", [])]
        else:
            kw["match_labels"] = {"app": app}
        if namespaces and rng.random() < 0.3:
            kw["namespaces"] = ["default", "other"]
        return api.PodAffinityTerm(**kw)

    apps = [f"app{i}" for i in range(5)]
    for j in range(n_jobs):
        ns = "other" if namespaces and j % 3 == 2 else "default"
        job = api.JobInfo(f"{ns}/j{j}", namespace=ns, min_available=1,
                          queue="default",
                          pod_group_phase=api.PodGroupPhase.INQUEUE,
                          creation_timestamp=float(j))
        for i in range(int(rng.integers(tasks_lo, tasks_hi))):
            app = apps[int(rng.integers(len(apps)))]
            t = task(f"j{j}-t{i}", {"app": app}, ns)
            r = rng.random()
            if r < 0.25:
                t.pod_anti_affinity = [term("rack", app)]
            elif r < 0.5:
                t.pod_affinity = [term("zone", app)]
            elif r < 0.75:
                t.pod_affinity_preferred = [term(
                    "zone", apps[0], int(rng.integers(1, 20)))]
            elif expressions and r < 0.85:
                t.pod_anti_affinity_preferred = [term(
                    "rack", app, int(rng.integers(1, 20)))]
            job.add_task(t)
        ci.add_job(job)
    nodes = list(ci.nodes)
    seedjob = api.JobInfo("default/seed", min_available=1, queue="default",
                          pod_group_phase=api.PodGroupPhase.INQUEUE)
    for i in range(running_pods):
        t = task(f"s-{i}", {"app": apps[int(rng.integers(3))]},
                 status=api.TaskStatus.RUNNING)
        seedjob.add_task(t)
        ci.nodes[nodes[int(rng.integers(len(nodes)))]].add_task(t)
    ci.add_job(seedjob)
    return ci


# --------------------------------------------------------------------------
# the sharded cycle's scenarios (tests/test_torch_sharded*.py)
# --------------------------------------------------------------------------

#: shard_map's deprecation (ROADMAP section 3 (b)), ignored by the tests
#: that run the JAX sharded cycle, and only by them
SHARD_MAP_WARNING = ("ignore:jax.experimental.shard_map is deprecated"
                     ":DeprecationWarning")

GANG_BINPACK = ("actions: allocate\ntiers:\n- plugins:\n  - name: gang\n"
                "  - name: binpack\n")
HDRF = ("actions: allocate\ntiers:\n- plugins:\n  - name: gang\n"
        "  - name: drf\n    enableHierarchy: true\n  - name: predicates\n"
        "  - name: nodeorder\n  - name: binpack\n")


def shipped_conf_text() -> str:
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "conf", "volcano-scheduler.conf")) as f:
        return f.read()


def synthetic_256(api):
    """The reference's ``_synthetic_cluster(256, 32, 8)`` with ``api``."""
    import volcano_tpu.api as japi
    if api is japi:
        from __graft_entry__ import _synthetic_cluster
    else:
        from volcano_tpu_torch.synthetic import _synthetic_cluster
    return _synthetic_cluster(256, 32, 8)


#: (function making the cluster, conf text: None for the raw cycle,
#: "default" for the built-in conf); the raw cycle is
#: ``dryrun_multichip``'s configuration, binpack 1 with neutral extras
SHARDED_SCENARIOS = {
    "gang_binpack_raw": (synthetic_256, None),
    "builtin_default": (synthetic_256, "default"),
    "shipped": (synthetic_256, "shipped"),
    "hdrf": (lambda api: hdrf_cluster(api, *HDRF_SCENARIO), HDRF),
}


@functools.lru_cache(maxsize=None)
def sharded_inputs(name):
    """(JAX cfg, snapshot, extras) of a sharded scenario, as the JAX
    Session derives them (the raw cycle: pack and neutral extras)."""
    import volcano_tpu.api as japi
    from volcano_tpu.arrays import pack
    from volcano_tpu.framework import Session as JaxSession
    from volcano_tpu.framework import parse_conf as jax_parse_conf
    from volcano_tpu.ops.allocate_scan import AllocateConfig, AllocateExtras
    build, conf = SHARDED_SCENARIOS[name]
    if conf is None:
        snap, _ = pack(build(japi))
        return (AllocateConfig(binpack_weight=1.0), snap,
                AllocateExtras.neutral(snap))
    text = {"default": None, "shipped": shipped_conf_text()}.get(conf, conf)
    ssn = JaxSession(build(japi), jax_parse_conf(text))
    cfg, extras = ssn._derived_allocate_inputs()
    return cfg, ssn.snap, extras


@functools.lru_cache(maxsize=None)
def jax_sharded_packed(name, D):
    """The JAX sharded cycle's packed decisions: the shard-local candidate
    kernel in interpret mode under shard_map on D virtual devices."""
    from volcano_tpu.parallel.sharding import make_sharded_allocate
    from volcano_tpu.parallel.sharding import scheduler_mesh
    cfg, snap, extras = sharded_inputs(name)
    fn = make_sharded_allocate(dataclasses.replace(cfg, use_pallas="interpret"),
                               scheduler_mesh(D), snap)
    return np.asarray(fn(snap, extras).packed_decisions())


@functools.lru_cache(maxsize=None)
def jax_scan_packed(name):
    """The JAX scan path's packed decisions (no kernel, one pop a round)."""
    import jax
    from volcano_tpu.ops.allocate_scan import make_allocate_cycle
    cfg, snap, extras = sharded_inputs(name)
    return np.asarray(jax.jit(make_allocate_cycle(dataclasses.replace(
        cfg, use_pallas=False)))(snap, extras).packed_decisions())


def port_sharded_packed(name, D):
    """The port's ``make_sharded_allocate`` on D virtual shards of the CPU."""
    import torch

    from volcano_tpu_torch.parallel import NodeMesh, make_sharded_allocate
    cfg, snap, extras = sharded_inputs(name)
    s, e = port_inputs(snap, extras)
    fn = make_sharded_allocate(port_cfg(cfg),
                               NodeMesh((torch.device("cpu"),) * D), s)
    return fn(s, e).packed_decisions().numpy()


def need_jax_devices(n):
    import jax
    import pytest
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual JAX devices")
