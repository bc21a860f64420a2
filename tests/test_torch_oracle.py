"""The port's numpy oracle (``runtime/cpu_reference.allocate_cpu``) and its
Session entry point against the JAX package's.

Snapshots, configs and extras are derived by the JAX Session (or packed
with neutral extras for a raw cycle) and reach the port as the same bytes
(``snapshot_from_numpy``). Both oracles then run on them, with the
telemetry mirror off and on, and every output field must agree bit for
bit, the telemetry dict too. The JAX oracle's telemetry mode inverts a
Python bool with ``~`` (ROADMAP section 3, fault (a)), which
``tests/conftest.py`` turns into an error, so it runs under a filter for
that one DeprecationWarning; the port's copy computes it on ``np.bool_``
and runs with none.
"""

import functools
import warnings

import numpy as np
import pytest

import volcano_tpu.api as japi
from volcano_tpu.arrays import pack
from volcano_tpu.framework import Session as JaxSession
from volcano_tpu.framework import parse_conf as jax_parse_conf
from volcano_tpu.ops.allocate_scan import AllocateConfig, AllocateExtras
from volcano_tpu.runtime.cpu_reference import allocate_cpu as jax_oracle

from torch_fixtures import (GANG_BINPACK, HDRF, HDRF_SCENARIO,
                            fingerprint, hdrf_cluster, pod_affinity_cluster,
                            port_cfg, port_inputs, random_cluster,
                            shipped_conf_text)
from volcano_tpu_torch.runtime.cpu_reference import allocate_cpu

FIELDS = ("task_node", "task_mode", "task_gpu", "job_ready",
          "job_pipelined", "job_attempted", "idle", "queue_allocated")
AFFINITY = ("actions: allocate\ntiers:\n- plugins:\n  - name: gang\n"
            "  - name: predicates\n  - name: binpack\n")
PORTS = ("actions: allocate\ntiers:\n- plugins:\n  - name: gang\n"
         "  - name: predicates\n  - name: nodeorder\n")
SLA = ("actions: allocate\ntiers:\n- plugins:\n  - name: priority\n"
       "  - name: gang\n  - name: sla\n- plugins:\n  - name: drf\n"
       "  - name: proportion\n  - name: binpack\n")


def small_synthetic(api, extended=0):
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    return _synthetic_cluster(24, 10, 4, api=api, extended=extended)


def ports_cluster(api):
    """Three nodes, gangs whose tasks share a few host ports, and a
    running pod holding port 8080 on one node."""
    rng = np.random.RandomState(3)
    ci = api.ClusterInfo()
    ci.add_queue(api.QueueInfo("default", weight=1))
    for i in range(3):
        ci.add_node(api.NodeInfo(f"n{i}", allocatable=api.Resource
                                 .from_resource_list({"cpu": "8",
                                                      "memory": "16Gi",
                                                      "pods": "110"})))
    holder = api.JobInfo("default/holder", queue="default", min_available=1,
                         pod_group_phase=api.PodGroupPhase.RUNNING)
    t = api.TaskInfo(uid="default/h-0", name="h-0",
                     resreq=api.Resource.from_resource_list(
                         {"cpu": "1", "memory": "1Gi"}),
                     status=api.TaskStatus.RUNNING, node_name="n0")
    t.host_ports = [8080]
    holder.add_task(t)
    ci.nodes["n0"].add_task(t)
    ci.add_job(holder)
    for jid in range(5):
        j = api.JobInfo(f"default/j{jid}", queue="default", min_available=1,
                        pod_group_phase=api.PodGroupPhase.INQUEUE,
                        creation_timestamp=float(jid))
        for i in range(2):
            t = api.TaskInfo(uid=f"default/j{jid}-{i}", name=f"j{jid}-{i}",
                             resreq=api.Resource.from_resource_list(
                                 {"cpu": "500m", "memory": "1Gi"}))
            if rng.rand() < 0.7:
                t.host_ports = [int(rng.choice([80, 443, 8080]))]
            j.add_task(t)
        ci.add_job(j)
    return ci


def sla_cluster(api):
    """Gangs created at times 0..11, every third one under a 30 s SLA
    (all past it at ``now`` = 100), in two queues."""
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    ci = _synthetic_cluster(16, 12, 4, api=api)
    for j, job in enumerate(ci.jobs.values()):
        if j % 3 == 0:
            job.sla_waiting_time = "30s"
    return ci


#: name -> (cluster builder over an ``api``, conf text, or a raw cycle's
#: AllocateConfig with neutral extras, Session keywords)
CASES = {
    "gang_binpack": (small_synthetic, GANG_BINPACK, {}),
    "shipped": (small_synthetic, "shipped", {}),
    "pod_affinity": (lambda api: pod_affinity_cluster(
        api, 1, n_nodes=16, n_jobs=6, zones=4, racks=5, running_pods=6),
        AFFINITY, {}),
    "gpu_sharing": (lambda api: random_cluster(api, 3, gpus=True),
                    AllocateConfig(binpack_weight=0.7,
                                   taint_prefer_weight=1.0), {}),
    "hdrf": (lambda api: hdrf_cluster(api, *HDRF_SCENARIO), HDRF, {}),
    "sla": (sla_cluster, SLA, dict(now=100.0)),
    "host_ports": (ports_cluster, PORTS, {}),
    "wave_4": (small_synthetic, AllocateConfig(binpack_weight=1.0,
                                               wave_width=4), {}),
    "wave_16": (small_synthetic, AllocateConfig(
        least_allocated_weight=1.0, balanced_weight=1.0,
        wave_width=16), {}),
    "r12": (lambda api: small_synthetic(api, extended=10), "shipped", {}),
}


@functools.lru_cache(maxsize=None)
def case_inputs(name):
    """(JAX cfg, snapshot, extras) as the JAX Session derives them, or a
    raw cycle's config over the packed snapshot with neutral extras."""
    build, conf, kw = CASES[name]
    if isinstance(conf, AllocateConfig):
        snap, _ = pack(build(japi))
        return conf, snap, AllocateExtras.neutral(snap)
    text = shipped_conf_text() if conf == "shipped" else conf
    ssn = JaxSession(build(japi), jax_parse_conf(text), **kw)
    cfg, extras = ssn._derived_allocate_inputs()
    return cfg, ssn.snap, extras


def ignore_fault_a():
    """The JAX oracle's fault (a), ignored inside a catch_warnings block."""
    warnings.filterwarnings(
        "ignore", "Bitwise inversion '~' on bool is deprecated",
        DeprecationWarning)


def run_jax_oracle(snap, extras, cfg, telemetry):
    with warnings.catch_warnings():
        if telemetry:
            ignore_fault_a()
        return jax_oracle(snap, extras, cfg, collect_telemetry=telemetry)


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_port_oracle_matches_the_jax_oracle(name, telemetry):
    cfg, snap, extras = case_inputs(name)
    want = run_jax_oracle(snap, extras, cfg, telemetry)
    s, e = port_inputs(snap, extras)
    got = allocate_cpu(s, e, port_cfg(cfg), collect_telemetry=telemetry)
    assert set(got) == set(want)
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    if telemetry:
        assert got["telemetry"] == want["telemetry"]
    assert (got["task_mode"] > 0).any()


def test_cases_reach_their_features():
    """Each case turns on what it is named for."""
    cfgs = {n: case_inputs(n)[0] for n in CASES}
    assert cfgs["pod_affinity"].enable_pod_affinity
    assert cfgs["hdrf"].enable_hdrf
    assert cfgs["sla"].sla_job_order
    assert cfgs["host_ports"].enable_host_ports
    assert cfgs["shipped"].drf_ns_order and cfgs["shipped"].drf_job_order
    assert cfgs["wave_4"].wave_width == 4
    assert np.asarray(case_inputs("gpu_sharing")[1].tasks.gpu_request).max() > 0
    assert np.asarray(case_inputs("r12")[1].nodes.idle).shape[1] == 12


def outcome(ssn):
    ssn.close()
    return ({b.task_uid: (b.node_name, b.gpu_index) for b in ssn.binds},
            dict(ssn.pipelined), dict(ssn.phase_updates))


@pytest.mark.parametrize("name", ["gang_binpack", "shipped", "pod_affinity",
                                  "r12"])
def test_session_oracle_matches_the_jax_session_oracle(name):
    """``run_allocate_oracle`` on the port's Session: the JAX Session's
    binds, held placements and PodGroup updates, its ``stats`` flag and
    ``last_allocate``; and, where the JAX paths agree, the port's own
    ``run_allocate``."""
    import volcano_tpu_torch.api as tapi
    from volcano_tpu_torch.framework import Session, parse_conf
    build, conf, kw = CASES[name]
    text = shipped_conf_text() if conf == "shipped" else conf
    jssn = JaxSession(build(japi), jax_parse_conf(text), **kw)
    with warnings.catch_warnings():
        ignore_fault_a()
        jres = jssn.run_allocate_oracle()
    want = outcome(jssn)
    ssn = Session(build(tapi), parse_conf(text), device="cpu", **kw)
    res = ssn.run_allocate_oracle()
    assert ssn.stats["cpu_oracle"] == 1.0 and ssn.last_allocate is res
    for f in ("task_node", "task_mode", "task_gpu", "job_ready",
              "job_pipelined", "job_attempted"):
        np.testing.assert_array_equal(getattr(res, f),
                                      np.asarray(getattr(jres, f)), f)
    assert outcome(ssn) == want
    card = Session(build(tapi), parse_conf(text), device="cpu", **kw)
    card.run_allocate()
    assert "cpu_oracle" not in card.stats
    assert fingerprint(card.last_allocate.task_node,
                       card.last_allocate.task_mode) == fingerprint(
        res.task_node, res.task_mode)
    assert outcome(card) == want


def test_a_failed_recovery_raises_and_never_runs_the_oracle(monkeypatch):
    """complete_allocate on the delta path with a digest mismatch whose
    recovery fails too: it raises, and the oracle is not called."""
    import volcano_tpu_torch.api as tapi
    from volcano_tpu_torch.framework import Session, parse_conf
    from volcano_tpu_torch.runtime import cpu_reference
    calls = []
    monkeypatch.setattr(cpu_reference, "allocate_cpu",
                        lambda *a, **k: calls.append(a))
    ssn = Session(small_synthetic(tapi), parse_conf(GANG_BINPACK),
                  device="cpu")
    pending = ssn.dispatch_allocate()
    assert pending.kernel is not None
    monkeypatch.setattr(type(pending.kernel), "mirror_digest",
                        lambda self, state: np.full(4, -1, np.int64))
    with pytest.raises(RuntimeError, match="digest differs"):
        ssn.complete_allocate(pending)
    assert calls == [] and "cpu_oracle" not in ssn.stats


def test_extended_dims_decide_placements():
    """The R = 12 cluster of check N: dropping the tasks' extended
    requests (the nodes keep theirs) changes the decisions."""
    import volcano_tpu_torch.api as tapi
    from volcano_tpu_torch.framework import Session, parse_conf
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    from volcano_tpu_torch.synthetic import MIG_RESOURCES
    fps = []
    for req in (True, False):
        ci = _synthetic_cluster(64, 40, 16, api=tapi, extended=10)
        for job in ci.jobs.values():
            for task in job.tasks.values():
                for name in MIG_RESOURCES if not req else ():
                    task.resreq.quantities.pop(name, None)
        ssn = Session(ci, parse_conf(GANG_BINPACK), device="cpu")
        assert ssn.snap.nodes.idle.shape[1] == 12
        ssn.run_allocate()
        fps.append(fingerprint(ssn.last_allocate.task_node,
                               ssn.last_allocate.task_mode))
    assert fps[0] != fps[1]


def test_extended_keyword_leaves_other_draws_alone():
    """extended=0 is the old cluster; extended=10 adds the ten dims and
    keeps every cpu request and priority."""
    import volcano_tpu_torch.api as tapi
    from volcano_tpu_torch.synthetic import MIG_RESOURCES, _synthetic_cluster
    a = _synthetic_cluster(8, 6, 4, api=tapi)
    b = _synthetic_cluster(8, 6, 4, api=tapi, extended=10)
    assert len(MIG_RESOURCES) == 10
    for ja, jb in zip(a.jobs.values(), b.jobs.values()):
        assert ja.priority == jb.priority
        for ta, tb in zip(ja.tasks.values(), jb.tasks.values()):
            assert ta.resreq.get("cpu") == tb.resreq.get("cpu")
            assert set(tb.resreq.quantities) - set(ta.resreq.quantities) \
                <= set(MIG_RESOURCES)
    assert all(set(MIG_RESOURCES) <= set(n.allocatable.quantities)
               for n in b.nodes.values())


def mig_cluster(api):
    """Check N's MIG GPU cluster (R = 12) at a quarter of its nodes."""
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    return _synthetic_cluster(64, 40, 16, api=api, extended=10)


@pytest.mark.parametrize("conf", ["static", "shipped", "mesh_w8"])
def test_session_at_12_resource_dims_matches_the_jax_session(conf):
    """The port's Session at R = 12 on the CPU (the placers' plain
    versions) against the JAX Session: gang + binpack (static keys), the
    shipped conf (dynamic keys, enqueue's and drf's folds over 12 dims),
    and gang + binpack with ``sharding: true`` at ``wave_width: 8`` on a
    one-shard mesh, which must give the unsharded JAX Session's
    decisions."""
    import volcano_tpu_torch.api as tapi
    from volcano_tpu_torch.framework import Session, parse_conf
    text = {"static": GANG_BINPACK, "shipped": shipped_conf_text(),
            "mesh_w8": GANG_BINPACK}[conf]
    jssn = JaxSession(mig_cluster(japi), jax_parse_conf(text))
    jssn.run_allocate()
    want = outcome(jssn)
    port = parse_conf(text)
    if conf == "mesh_w8":
        port.sharding, port.wave_width = True, 8
    ssn = Session(mig_cluster(tapi), port, device="cpu")
    assert ssn.snap.nodes.idle.shape[1] == 12
    ssn.run_allocate()
    assert ssn.stats["path"] == {"static": "round", "shipped": "dyn",
                                 "mesh_w8": "mesh"}[conf]
    r, j = ssn.last_allocate, jssn.last_allocate
    assert fingerprint(r.task_node, r.task_mode) == fingerprint(
        np.asarray(j.task_node, np.int32), np.asarray(j.task_mode, np.int32))
    assert outcome(ssn) == want
    assert (np.asarray(r.task_mode) > 0).sum() > 100
