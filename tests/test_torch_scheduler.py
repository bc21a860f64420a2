"""The port's synchronous scheduler loop against the JAX package's.

``volcano_tpu_torch.runtime.Scheduler`` (on the CPU) and
``volcano_tpu.runtime.scheduler.Scheduler`` each drive a ``FakeCluster`` of
their own package, built from the same description, through the same churn
applied through the cluster API: kubelet starts, a gang completing and
re-arriving, a new job, a node added and then removed (a structural
cycle). Every cycle's binds, evictions, held placements and PodGroup phase
updates must be equal, and so must the final cluster state, the loops'
pack counters, the resync queue's behaviour under refused binds, the
``METRICS`` registries and the flight records (timings aside).
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest

import volcano_tpu.api as japi
import volcano_tpu_torch.api as tapi
from volcano_tpu.framework import parse_conf as jax_parse_conf
from volcano_tpu.metrics import METRICS as JAX_METRICS
from volcano_tpu.runtime.fake_cluster import FakeCluster as JaxFakeCluster
from volcano_tpu.runtime.scheduler import Scheduler as JaxScheduler
from volcano_tpu.telemetry import spans as jax_spans

from volcano_tpu_torch.framework import parse_conf
from volcano_tpu_torch.metrics import METRICS
from volcano_tpu_torch.runtime import FakeCluster, ResyncQueue, Scheduler
from volcano_tpu_torch.telemetry import spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "conf", "volcano-scheduler.conf")) as _f:
    SHIPPED = _f.read()
GANG_BINPACK = """
actions: "allocate"
tiers:
- plugins:
  - name: gang
  - name: binpack
"""
CONFS = {"shipped": SHIPPED, "gang_binpack": GANG_BINPACK}

#: the gauges of the JAX registry with no counterpart in the port: the
#: jit trace-vs-call counters (``telemetry/tracecount``); and the series
#: whose values are durations: the span quantiles and every histogram's
#: sum and buckets (their keys and observation counts are compared)
NO_COUNTERPART = ("jit_traces", "jit_calls", "jit_cache_hits")
DURATIONS = ("span_phase_ms",)
#: flight-record fields that are timings
TIMED = ("cycle_ms", "wall_ts")


@pytest.fixture(autouse=True)
def clean_registries():
    """Both packages' METRICS and span buffers empty before and after each
    test, so no later test in the same worker sees what these left."""
    for m in (METRICS, JAX_METRICS):
        m.reset()
    for s in (spans, jax_spans):
        s.reset()
    yield
    for m in (METRICS, JAX_METRICS):
        m.reset()
    for s in (spans, jax_spans):
        s.reset()


def build_cluster(api, n_nodes=8, n_jobs=10, tasks_per_job=4):
    """``n_nodes`` nodes of 8 cpu and two queues; ``n_jobs`` gangs of
    ``tasks_per_job`` tasks of 2 cpu (min_available 2), every third still
    Pending for the enqueue action, the rest Inqueue."""
    def res(cpu, mem):
        return api.Resource.from_resource_list({"cpu": cpu, "memory": mem})

    ci = api.ClusterInfo()
    for i in range(n_nodes):
        ci.add_node(api.NodeInfo(f"n{i}", allocatable=res("8", "16Gi"),
                                 labels={}, max_pods=110))
    ci.add_queue(api.QueueInfo("default", weight=1))
    ci.add_queue(api.QueueInfo("batch", weight=2))
    for j in range(n_jobs):
        phase = (api.PodGroupPhase.PENDING if j % 3 == 2
                 else api.PodGroupPhase.INQUEUE)
        job = api.JobInfo(uid=f"default/j{j}", name=f"j{j}",
                          namespace="default",
                          queue="default" if j % 2 == 0 else "batch",
                          priority=j % 3, min_available=2,
                          pod_group_phase=phase,
                          creation_timestamp=float(j + 1))
        for t in range(tasks_per_job):
            job.add_task(api.TaskInfo(
                uid=f"default/j{j}-t{t}", name=f"j{j}-t{t}",
                namespace="default", resreq=res("2", "2Gi"),
                status=api.TaskStatus.PENDING, priority=t % 2,
                task_role=""))
        ci.add_job(job)
    return ci


def churn(api, cluster, cycle):
    """Between-cycle churn through the cluster's API (direct edits mark
    dirty): every Bound task starts Running; then by cycle, a fully
    Running gang completes and re-arrives as Pending (1, 4), a new job
    arrives (2), a node no task fits on joins (3) and leaves (4). Returns
    what the structural steps returned."""
    ci = cluster.ci
    for uid in sorted(t.uid for job in ci.jobs.values()
                      for t in job.tasks.values()
                      if t.status == api.TaskStatus.BOUND):
        cluster.run_task(uid)
    out = None
    if cycle in (1, 4):
        for uid in sorted(ci.jobs):
            job = ci.jobs[uid]
            tasks = list(job.tasks.values())
            if tasks and all(t.status == api.TaskStatus.RUNNING
                             for t in tasks):
                for t in tasks:
                    node = ci.nodes.get(t.node_name)
                    if node is not None and t.uid in node.tasks:
                        node.remove_task(t)
                        cluster.mark_dirty(node_name=node.name)
                    job.update_task_status(t, api.TaskStatus.PENDING)
                    t.node_name = ""
                job.allocated = type(job.allocated)({})
                cluster.mark_dirty(job_uid=uid)
                out = uid
                break
    if cycle == 2:
        job = api.JobInfo(uid="default/new", name="new", namespace="default",
                          queue="batch", priority=1, min_available=1,
                          pod_group_phase=api.PodGroupPhase.INQUEUE,
                          creation_timestamp=100.0)
        job.add_task(api.TaskInfo(
            uid="default/new-t0", name="new-t0", namespace="default",
            resreq=api.Resource.from_resource_list({"cpu": "1",
                                                    "memory": "1Gi"}),
            status=api.TaskStatus.PENDING, priority=0, task_role=""))
        ci.add_job(job)
        cluster.mark_dirty(job_uid=job.uid)
    if cycle == 3:
        cluster.add_node(api.NodeInfo(
            "tiny", allocatable=api.Resource.from_resource_list(
                {"cpu": "100m", "memory": "1Gi"}), labels={}, max_pods=110))
    if cycle == 4:
        assert cluster.remove_node("tiny")
    return out


def cycle_digest(ssn):
    return (sorted((b.task_uid, b.node_name, b.gpu_index) for b in ssn.binds),
            sorted(e.task_uid for e in ssn.evictions),
            sorted(ssn.pipelined.items()),
            sorted((u, str(getattr(p, "value", p)))
                   for u, p in ssn.phase_updates.items()))


def cluster_state(cluster):
    """Every job's phase and tasks (status, node, card), every node's tasks
    and accounting, and the cluster's bind and evict logs."""
    ci = cluster.ci
    jobs = [(uid, str(job.pod_group_phase.value),
             [(t.uid, int(t.status), t.node_name, t.gpu_index)
              for t in job.tasks.values()],
             sorted(job.allocated.quantities.items()))
            for uid, job in sorted(ci.jobs.items())]
    nodes = [(name, sorted(node.tasks), sorted(node.idle.quantities.items()),
              sorted(node.used.quantities.items()))
             for name, node in sorted(ci.nodes.items())]
    return jobs, nodes, list(cluster.binds), list(cluster.evictions)


def make_pair(conf_text, incremental=True, jax_cluster=JaxFakeCluster,
              port_cluster=FakeCluster, **kw):
    js = JaxScheduler(jax_cluster(build_cluster(japi, **kw)),
                      conf=jax_parse_conf(conf_text),
                      incremental=incremental)
    ps = Scheduler(port_cluster(build_cluster(tapi, **kw)),
                   conf=parse_conf(conf_text), incremental=incremental,
                   device="cpu")
    return js, ps


def run_churn(js, ps, cycles=6):
    for c in range(cycles):
        a = js.run_once(now=1000.0 + c)
        b = ps.run_once(now=1000.0 + c)
        assert cycle_digest(a) == cycle_digest(b), f"cycle {c}"
        assert [(x.task_uid, x.node_name) for x in b.binds] \
            == [(x.task_uid, x.node_name) for x in a.binds], f"cycle {c}"
        assert churn(japi, js.cluster, c) == churn(tapi, ps.cluster, c)


@pytest.mark.parametrize("incremental", [True, False],
                         ids=["incremental", "fresh"])
@pytest.mark.parametrize("conf_name", sorted(CONFS))
def test_loop_matches_jax_scheduler_over_churn(conf_name, incremental):
    js, ps = make_pair(CONFS[conf_name], incremental)
    assert ps.incremental == incremental
    run_churn(js, ps)
    assert cluster_state(ps.cluster) == cluster_state(js.cluster)
    assert ps.cycles == js.cycles == 6
    assert (ps.full_packs, ps.incremental_cycles) \
        == (js.full_packs, js.incremental_cycles)
    assert ps.cluster.binds, "the loop flushed no bind"
    if incremental:
        # the first cycle, the node's arrival and its departure pack in
        # full; the other cycles refresh in place or repack inside
        assert ps.full_packs >= 3 and ps.incremental_cycles >= 1


def refusing(base):
    """``base`` (either package's FakeCluster) refusing the binds of the
    tasks in ``refuse``: a count refuses that many attempts, None every
    attempt."""
    class Refusing(base):
        def __init__(self, ci):
            super().__init__(ci)
            self.refuse = {}
            self.refused = []

        def bind(self, intent, fence=None):
            left = self.refuse.get(intent.task_uid, 0)
            if left is None or left > 0:
                if left is not None:
                    self.refuse[intent.task_uid] = left - 1
                self.refused.append(intent.task_uid)
                return False
            return super().bind(intent, fence)

    return Refusing


def resync_view(sched):
    """The resync queue (intent, kind, attempts, next retry), its dead
    letters, and the status and node of every task it holds."""
    def row(e):
        i = e["intent"]
        return (i.task_uid, i.node_name, e["kind"], e["attempts"],
                e["next_try"], e.get("gave_up_at"))

    held = sorted({e["intent"].task_uid
                   for e in sched.resync.entries + sched.resync.dead})
    tasks = {t.uid: t for job in sched.cluster.ci.jobs.values()
             for t in job.tasks.values()}
    return ([row(e) for e in sched.resync.entries],
            [row(e) for e in sched.resync.dead],
            [(u, int(tasks[u].status), tasks[u].node_name) for u in held])


def test_resync_matches_jax_scheduler():
    """Refused binds hold their tasks in Binding and retry from the
    rate-limited queue; one refused 2 times binds on its third attempt,
    one refused every time dead-letters at ``max_attempts`` and resyncs
    its task to Pending, where the same cycle decides it again."""
    js, ps = make_pair(GANG_BINPACK, jax_cluster=refusing(JaxFakeCluster),
                       port_cluster=refusing(FakeCluster))
    for s in (js, ps):
        s.resync.max_attempts = 3
        s.cluster.refuse.update({"default/j0-t0": 2, "default/j1-t1": None})
    views = []
    for c in range(6):
        a = js.run_once(now=100.0 + c)
        b = ps.run_once(now=100.0 + c)
        assert cycle_digest(a) == cycle_digest(b), f"cycle {c}"
        views.append(resync_view(ps))
        assert views[-1] == resync_view(js), f"cycle {c}"
        assert ps.cluster.refused == js.cluster.refused
    # what the run went through: both tasks held in Binding, one retried
    # into a bind, one given up on and resynced
    held = {u for v in views for u, status, _ in v[2]
            if status == int(tapi.TaskStatus.BINDING)}
    assert {"default/j0-t0", "default/j1-t1"} <= held
    assert ("default/j0-t0", views[0][0][0][1]) in ps.cluster.binds
    assert [d[0] for d in views[-1][1]] == ["default/j1-t1"]
    assert cluster_state(ps.cluster) == cluster_state(js.cluster)
    for name in ("resync_tasks", "resync_retried", "resync_succeeded",
                 "resync_dropped", "resync_dead_letter_total"):
        assert METRICS.counter_value(name) \
            == JAX_METRICS.counter_value(name), name
    assert METRICS.counter_value("resync_dead_letter_total") == 1
    assert ps.resync.dead_letter() == ps.resync.dead
    assert ps.flight.snapshots()[-1]["resync_dead_letter"] == 1


def test_resync_queue_backs_off_as_the_reference():
    """The queue alone: the same due times, retries and give-up as the
    reference's on a cluster that never binds."""
    from volcano_tpu.runtime.scheduler import ResyncQueue as JaxQueue

    from volcano_tpu_torch.framework import BindIntent

    class Never:
        def __init__(self):
            self.calls, self.resynced = 0, []

        def bind(self, intent):
            self.calls += 1
            return False

        def resync_task(self, uid):
            self.resynced.append(uid)

    out = []
    for q in (ResyncQueue(base_delay=1.0, max_delay=8.0, max_attempts=4),
              JaxQueue(base_delay=1.0, max_delay=8.0, max_attempts=4)):
        c = Never()
        q.add(BindIntent("t", "j", "n"), "bind", now=0.0)
        steps = [q.process(c, now=t) for t in (0.5, 1.0, 2.0, 3.5, 7.5,
                                               20.0, 40.0)]
        out.append((steps, c.calls, c.resynced,
                    [(e["attempts"], e["gave_up_at"]) for e in q.dead],
                    q.redrive(50.0), [e["next_try"] for e in q.entries]))
    assert out[0] == out[1]
    assert out[0][2] == ["t"]


def series(registry):
    """A registry's counters and gauges, less the JAX-only and duration
    series, and its histograms' keys with their observation counts."""
    keep = lambda k: k[0] not in NO_COUNTERPART + DURATIONS  # noqa: E731
    return ({k: v for k, v in registry.counters.items() if keep(k)},
            {k: v for k, v in registry.gauges.items() if keep(k)},
            {k: h.n for k, h in registry.histograms.items()})


@pytest.mark.parametrize("conf_name", sorted(CONFS))
def test_metrics_and_flight_record_match_jax(conf_name):
    """After the same churn run, the registries hold the same counters
    and gauges (the queue and namespace families, upload bytes, schedule
    attempts by result) and the same histograms with the same counts, and
    the flight records agree field by field apart from timings; the span
    summaries name the same phases."""
    js, ps = make_pair(CONFS[conf_name])
    run_churn(js, ps)
    assert {k[0] for k in JAX_METRICS.gauges} - {
        k[0] for k in METRICS.gauges} <= set(NO_COUNTERPART)
    got, want = series(METRICS), series(JAX_METRICS)
    assert got == want
    assert METRICS.counter_value("schedule_attempts") == 6
    assert any(k[0] == "queue_share" for k in got[1])
    assert any(k[0] == "cycle_upload_bytes" for k in got[0])
    assert ps.flight.recorded_total == js.flight.recorded_total == 6
    # the reference's stats under the port's names (the readback's bytes
    # differ: the port counts the digest words it reads with a full
    # readback, the reference counts the decisions only)
    renamed = {"full_upload_bytes": "upload_bytes_full"}
    for fa, fb in zip(js.flight.snapshots(), ps.flight.snapshots()):
        for k in set(fa) | set(fb):
            if k in TIMED or k in ("stats", "spans"):
                continue
            assert fb.get(k) == fa.get(k), (k, fb.get(k), fa.get(k))
        assert set(fb["spans"]) == set(fa["spans"])
        sa, sb = fa["stats"], fb["stats"]
        for k in ("enqueued", "backfilled", "upload_bytes",
                  "full_upload_bytes", "allocated_binds", "jobs_ready",
                  "jobs_pipelined"):
            assert (k in sb) == (renamed.get(k, k) in sa), k
            if k in sb:
                assert sb[k] == sa[renamed.get(k, k)], k


def test_conf_hot_reload(tmp_path):
    """A conf file changed between cycles takes effect at the next cycle's
    start, in both loops alike."""
    path = str(tmp_path / "scheduler.conf")
    with open(path, "w") as f:
        f.write(GANG_BINPACK)
    js = JaxScheduler(JaxFakeCluster(build_cluster(japi)), conf_path=path)
    ps = Scheduler(FakeCluster(build_cluster(tapi)), conf_path=path,
                   device="cpu")
    assert ps.conf.actions == ["allocate"]
    for c in range(3):
        if c == 1:
            with open(path, "w") as f:
                f.write(SHIPPED)
            st = os.stat(path)
            os.utime(path, (st.st_atime, st.st_mtime + 10))
        a = js.run_once(now=1000.0 + c)
        b = ps.run_once(now=1000.0 + c)
        assert cycle_digest(a) == cycle_digest(b), f"cycle {c}"
        churn(japi, js.cluster, 0)
        churn(tapi, ps.cluster, 0)
    assert ps.conf.actions == ["enqueue", "allocate", "backfill"]
    assert [p.name for t in ps.conf.tiers for p in t.plugins] \
        == [p.name for t in js.conf.tiers for p in t.plugins]
    assert cluster_state(ps.cluster) == cluster_state(js.cluster)


REFUSALS = {
    "pipeline_conf": (lambda c: Scheduler(c, conf=parse_conf(
        SHIPPED + "\npipeline: true\n"), device="cpu"), "item 2b"),
    "pipeline_arg": (lambda c: Scheduler(c, pipeline=True, device="cpu"),
                     "item 2b"),
    "elector": (lambda c: Scheduler(c, elector=object(), device="cpu"),
                "item 8"),
    "warmup": (lambda c: Scheduler(c, device="cpu").warmup(), "item 2b"),
    "checkpoint": (lambda c: Scheduler(c, device="cpu").checkpoint("x"),
                   "item 8"),
    "checkpoint_state": (lambda c: Scheduler(
        c, device="cpu").checkpoint_state(), "item 8"),
    "restore": (lambda c: Scheduler(c, device="cpu").restore("x"),
                "item 8"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_name_their_items(name):
    make, item = REFUSALS[name]
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        make(FakeCluster(build_cluster(tapi)))


def test_pipeline_false_overrides_the_conf():
    """As in the reference, the constructor's ``pipeline`` overrides the
    conf's: ``pipeline=False`` runs the synchronous loop."""
    conf = SHIPPED + "\npipeline: true\n"
    ps = Scheduler(FakeCluster(build_cluster(tapi)), conf=parse_conf(conf),
                   pipeline=False, device="cpu")
    js = JaxScheduler(JaxFakeCluster(build_cluster(japi)),
                      conf=jax_parse_conf(conf), pipeline=False)
    assert cycle_digest(ps.run_once(now=1.0)) \
        == cycle_digest(js.run_once(now=1.0))
    assert ps.drain() is None and ps.cycles == 1


def test_an_action_exception_propagates_with_nothing_flushed():
    """A pending task with a host port under the predicates plugin is
    item 4b's refusal: the NotImplementedError leaves run_once, no bind
    reaches the cluster, no phase is written back and ``cycles`` stays."""
    ci = build_cluster(tapi)
    next(iter(ci.jobs["default/j3"].tasks.values())).host_ports = [8080]
    ps = Scheduler(FakeCluster(ci), conf=parse_conf(SHIPPED), device="cpu")
    phases = {u: j.pod_group_phase for u, j in ci.jobs.items()}
    with pytest.raises(NotImplementedError, match="item 4b"):
        ps.run_once(now=1.0)
    assert ps.cycles == 0 and ps.cluster.binds == []
    assert len(ps.flight) == 0 and not METRICS.counter_value(
        "schedule_attempts")
    assert all(t.status != tapi.TaskStatus.BOUND
               for j in ci.jobs.values() for t in j.tasks.values())
    assert {u for u, j in ci.jobs.items() if j.pod_group_phase
            == tapi.PodGroupPhase.RUNNING} == {
        u for u, p in phases.items() if p == tapi.PodGroupPhase.RUNNING}


def test_sharding_runs_the_one_card_mesh_path():
    """``sharding: true`` runs the Session's mesh path (one shard of the
    loop's device) and decides as the loop without it."""
    conf = GANG_BINPACK + "\nsharding: true\n"
    meshed = Scheduler(FakeCluster(build_cluster(tapi)),
                       conf=parse_conf(conf), device="cpu")
    fused = Scheduler(FakeCluster(build_cluster(tapi)),
                      conf=parse_conf(GANG_BINPACK), device="cpu")
    for c in range(2):
        a, b = meshed.run_once(now=1.0 + c), fused.run_once(now=1.0 + c)
        assert cycle_digest(a) == cycle_digest(b)
        assert a.stats["mesh_devices"] == 1.0
    assert METRICS.gauges[("mesh_width", "")] == 1
    assert meshed.flight.snapshots()[-1]["mesh_devices"] == 1


def test_default_device_is_the_card():
    import inspect
    assert inspect.signature(Scheduler).parameters["device"].default \
        == "cuda"
    ps = Scheduler(FakeCluster(build_cluster(tapi)), device="cpu")
    ssn = ps.run_once(now=1.0)
    assert ssn.device == "cpu" and ps._session is ssn
    assert np.all([b.node_name for b in ssn.binds])


def test_check_o_churn_matches_jax_scheduler():
    """Check O's loop run (``chip_smoke.loop_churn``: cycle 0, then
    ``steady_churn`` of the Bound gangs marked through the cluster) under
    the shipped conf at a small size: each cycle's bind count and bind
    fingerprint, as ``scripts/check_o_targets.py`` takes them from the
    JAX loop."""
    import chip_smoke
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    js = JaxScheduler(JaxFakeCluster(_synthetic_cluster(16, 12, 4,
                                                        api=japi)),
                      conf=jax_parse_conf(SHIPPED))
    ps = Scheduler(FakeCluster(_synthetic_cluster(16, 12, 4)),
                   chip_smoke.shipped_conf(), device="cpu")
    got = chip_smoke.loop_churn(ps, tapi, frac=0.25)
    assert got == chip_smoke.loop_churn(js, japi, frac=0.25)
    assert all(n for n, _ in got)
    assert (ps.full_packs, ps.incremental_cycles) == (1, 3)
