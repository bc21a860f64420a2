"""The port's enqueue and backfill passes, and the Session's
``enqueue, allocate, backfill``, against the JAX package's.

Inputs come from numpy seeds; the JAX passes run under ``jax.jit`` on the
CPU and the port's on CPU tensors. Tolerance 0: every admitted flag, node
and bind is equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import volcano_tpu.api as japi
import volcano_tpu_torch.api as tapi
from volcano_tpu.arrays import pack as jax_pack
from volcano_tpu.ops.allocate_scan import AllocateExtras as JaxExtras
from volcano_tpu.ops.backfill import make_backfill_pass as jax_backfill_pass
from volcano_tpu.ops.enqueue import EnqueueConfig as JaxEnqueueConfig
from volcano_tpu.ops.enqueue import make_enqueue_pass as jax_enqueue_pass
from volcano_tpu.ops.select import sort_order as jax_sort_order

from torch_fixtures import port_inputs, random_cluster, shipped_conf_text
from volcano_tpu_torch.actions import get_action
from volcano_tpu_torch.framework import Session, parse_conf
from volcano_tpu_torch.ops.backfill import make_backfill_pass
from volcano_tpu_torch.ops.enqueue import EnqueueConfig, make_enqueue_pass
from volcano_tpu_torch.ops.select import sort_order
from volcano_tpu_torch.synthetic import admission_scenario


def port_snap(snap):
    return port_inputs(snap, JaxExtras.neutral(snap))[0]


# --------------------------------------------------------------------------
# sort_order
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_sort_order_matches_jax_with_ties(seed):
    """Few distinct values per key, so most entries tie on the first keys
    and some on all three; a fifth are masked out."""
    rng = np.random.RandomState(seed)
    n = 37
    keys = [rng.randint(0, 3, n).astype(np.float32),
            -rng.randint(0, 2, n).astype(np.float32),
            rng.randint(0, 4, n).astype(np.int32)]
    mask = rng.rand(n) < 0.8
    want = np.asarray(jax_sort_order([jax.numpy.asarray(k) for k in keys],
                                     jax.numpy.asarray(mask)))
    got = sort_order([torch.from_numpy(k) for k in keys],
                     torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# the enqueue pass
# --------------------------------------------------------------------------

def enqueue_snapshot(seed, unset_capability=False):
    """A packed JAX snapshot whose enqueue inputs are drawn from ``seed``:
    queue and priority with many ties, 85 % of the jobs Pending, integer
    millicore and 2^28-byte requests and capabilities that the gates must
    refuse part of, running usage on the nodes, and queues already
    holding allocated and Inqueue resources. With ``unset_capability``
    the first queue declares no capability and every queue no memory
    capability (+inf)."""
    rng = np.random.RandomState(seed)
    snap, _ = jax_pack(random_cluster(japi, seed, n_nodes=8, n_jobs=14))
    J = snap.jobs.valid.shape[0]
    Q, R = snap.queues.allocated.shape
    N = snap.nodes.idle.shape[0]
    unit = np.array([1000.0, 2.0 ** 28], np.float32)[:R]
    nq = int(np.asarray(snap.queues.valid).sum())
    valid = np.asarray(snap.jobs.valid)
    jobs = dataclasses.replace(
        snap.jobs,
        queue=rng.randint(0, nq, J).astype(np.int32),
        priority=rng.randint(0, 2, J).astype(np.int32),
        pending_phase=valid & (rng.rand(J) < 0.85),
        min_resources=(rng.randint(1, 9, (J, R)) * unit).astype(np.float32))
    cap = (rng.randint(4, 14, (Q, R)) * unit * 2).astype(np.float32)
    if unset_capability:
        cap[0] = np.inf
        cap[:, 1:] = np.inf
    queues = dataclasses.replace(
        snap.queues, capability=cap,
        allocated=(rng.randint(0, 4, (Q, R)) * unit).astype(np.float32),
        inqueue_minres=(rng.randint(0, 4, (Q, R)) * unit).astype(np.float32))
    alloc = np.asarray(snap.nodes.allocatable)
    used = np.minimum(rng.randint(0, 3, (N, R)) * unit, alloc)
    nodes = dataclasses.replace(snap.nodes,
                                idle=(alloc - used).astype(np.float32))
    return dataclasses.replace(snap, jobs=jobs, queues=queues, nodes=nodes)


GATES = {"proportion": (True, False), "overcommit": (False, True),
         "both": (True, True), "none": (False, False)}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("factor", [1.0, 1.2])
@pytest.mark.parametrize("gates", sorted(GATES))
def test_enqueue_matches_jax(gates, factor, seed):
    prop, over = GATES[gates]
    snap = enqueue_snapshot(seed, unset_capability=seed == 2)
    J = snap.jobs.valid.shape[0]
    sla = np.random.RandomState(100 + seed).rand(J) < 0.15
    kw = dict(enable_proportion_gate=prop, enable_overcommit_gate=over,
              overcommit_factor=factor)
    want = np.asarray(jax.jit(jax_enqueue_pass(JaxEnqueueConfig(**kw)))(
        snap, sla))
    got = make_enqueue_pass(EnqueueConfig(**kw))(port_snap(snap),
                                                 torch.from_numpy(sla))
    np.testing.assert_array_equal(got.numpy(), want)
    candidates = np.asarray(snap.jobs.pending_phase)
    if prop or over:
        # the gates refused some candidates and admitted others
        assert 0 < want.sum() < candidates.sum()
    else:
        np.testing.assert_array_equal(want, candidates)


def test_sla_flags_override_both_gates():
    snap = enqueue_snapshot(0)
    J = snap.jobs.valid.shape[0]
    sla = np.ones(J, bool)
    cfg = EnqueueConfig(enable_overcommit_gate=True)
    got = make_enqueue_pass(cfg)(port_snap(snap), torch.from_numpy(sla))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(snap.jobs.pending_phase))


# --------------------------------------------------------------------------
# the backfill pass
# --------------------------------------------------------------------------

def backfill_cluster(api, seed):
    """Nodes in two zones, the first with room for 2 more pods; jobs mixing
    zero-request and requesting tasks; zone selectors on some best-effort
    tasks; one Pending job (not schedulable) and one running best-effort
    task, neither of which backfill may touch."""
    rng = np.random.RandomState(seed)
    ci = api.ClusterInfo()
    ci.add_queue(api.QueueInfo("default", weight=1))
    res = api.Resource.from_resource_list
    for i in range(6):
        ci.add_node(api.NodeInfo(f"n{i}", allocatable=res(
            {"cpu": "4", "memory": "8Gi"}), labels={"zone": "ab"[i % 2]},
            max_pods=3 if i == 0 else 6))
    running = api.JobInfo("default/run", queue="default", min_available=1,
                          creation_timestamp=1.0,
                          pod_group_phase=api.PodGroupPhase.RUNNING)
    t = api.TaskInfo("default/run-0", "run-0", resreq=api.Resource(),
                     status=api.TaskStatus.RUNNING)
    running.add_task(t)
    ci.nodes["n0"].add_task(t)
    ci.add_job(running)
    for j in range(5):
        phase = (api.PodGroupPhase.PENDING if j == 3
                 else api.PodGroupPhase.INQUEUE)
        job = api.JobInfo(f"default/j{j}", queue="default", min_available=1,
                          creation_timestamp=float(2 + j),
                          pod_group_phase=phase)
        for k in range(2 + int(rng.randint(4))):
            be = rng.rand() < 0.7
            task = api.TaskInfo(
                f"default/j{j}-{k}", f"j{j}-{k}",
                resreq=api.Resource() if be else res(
                    {"cpu": "1", "memory": "1Gi"}))
            if be and rng.rand() < 0.3:
                task.node_selector = {"zone": "b"}
            job.add_task(task)
        ci.add_job(job)
    return ci


@pytest.mark.parametrize("or_groups", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_backfill_matches_jax(seed, or_groups):
    snap, _ = jax_pack(backfill_cluster(japi, seed))
    T = snap.tasks.valid.shape[0]
    N = snap.nodes.idle.shape[0]
    args = ()
    if or_groups:
        rng = np.random.RandomState(seed)
        args = (rng.randint(-1, 3, T).astype(np.int32),
                rng.rand(3, N) < 0.6)
    want_node, want_placed = (np.asarray(a) for a in jax.jit(
        jax_backfill_pass())(snap, *args))
    got_node, got_placed = make_backfill_pass()(
        port_snap(snap), *(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got_node.numpy(), want_node)
    np.testing.assert_array_equal(got_placed.numpy(), want_placed)
    assert want_placed.any()
    # non-candidates stay unplaced: requesting tasks, the running task and
    # the Pending job's tasks
    be = np.asarray(snap.tasks.best_effort)
    assert not want_placed[~be].any()
    # the first node takes 2 more pods, then it is full
    assert (want_node == 0).sum() <= 2


# --------------------------------------------------------------------------
# the Session's enqueue, allocate, backfill
# --------------------------------------------------------------------------

def check_k_conf_text():
    """conf/volcano-scheduler-ci.conf's tiers with the actions enqueue,
    allocate, backfill (its reclaim and preempt are not ported yet)."""
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "conf", "volcano-scheduler-ci.conf")) as f:
        text = f.read()
    return text.replace('"enqueue, reclaim, allocate, backfill, preempt"',
                        '"enqueue, allocate, backfill"')


#: a tenth of check K's cluster: nodes, gangs of 16, best-effort jobs
TENTH = (102, 312, 16, 102)


def actions_outcome(ssn):
    """Run the conf's actions; the enqueued count, phase updates, packed
    decisions, allocate binds and backfill binds."""
    if isinstance(ssn, Session):
        run = [lambda s=ssn, n=name: get_action(n).execute(s)
               for name in ssn.conf.actions]
    else:
        from volcano_tpu.actions import get_action as jax_get_action
        run = [lambda s=ssn, n=name: jax_get_action(n).execute(s)
               for name in ssn.conf.actions]
    assert ssn.conf.actions == ["enqueue", "allocate", "backfill"]
    run[0]()
    run[1]()
    allocate_binds = [(b.task_uid, b.node_name) for b in ssn.binds]
    r = ssn.last_allocate
    packed = np.concatenate([np.asarray(getattr(r, k)).astype(np.int32)
                             for k in ("task_node", "task_mode", "task_gpu",
                                       "job_ready", "job_pipelined",
                                       "job_attempted")])
    run[2]()
    backfill_binds = [(b.task_uid, b.node_name)
                      for b in ssn.binds[len(allocate_binds):]]
    return (ssn.stats["enqueued"], dict(ssn.phase_updates), packed,
            allocate_binds, backfill_binds, ssn.stats["backfilled"])


@pytest.mark.parametrize("conf", ["shipped", "check_k"])
def test_session_actions_match_jax_session(conf):
    from volcano_tpu.framework import Session as JaxSession
    from volcano_tpu.framework import parse_conf as jax_parse_conf
    text = shipped_conf_text() if conf == "shipped" else check_k_conf_text()
    want = actions_outcome(JaxSession(admission_scenario(*TENTH, api=japi),
                                      jax_parse_conf(text), now=4149.0))
    got = actions_outcome(Session(admission_scenario(*TENTH, api=tapi),
                                  parse_conf(text), now=4149.0,
                                  device="cpu"))
    assert got[0] == want[0]
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3:] == want[3:]
    enqueued, _, _, allocate_binds, backfill_binds, _ = got
    J = TENTH[1] + TENTH[3]
    assert 0 < enqueued < J, "the gates admitted every job, or none"
    assert allocate_binds and backfill_binds


def test_admission_scenario_matches_its_description():
    ci = admission_scenario(*TENTH)
    gangs = [j for j in ci.jobs.values() if "job-" in j.uid]
    assert len(gangs) == TENTH[1]
    assert all(j.pod_group_phase == tapi.PodGroupPhase.PENDING
               for j in ci.jobs.values())
    assert sum(bool(j.sla_waiting_time) for j in gangs) == 32
    assert gangs[0].creation_timestamp == 0.0
    for job in gangs[:5]:
        first = list(job.tasks.values())[:8]
        assert job.min_resources.get("cpu") == sum(
            t.resreq.get("cpu") for t in first)
    be = [j for j in ci.jobs.values() if "be-" in j.uid]
    assert len(be) == TENTH[3]
    assert all(t.best_effort for j in be for t in j.tasks.values())
    caps = [ci.queues[f"q{q}"].capability.get("cpu") for q in range(8)]
    assert sum(caps) == 16 * TENTH[0] * 1000


def test_sla_flags_and_deadlines_use_now():
    conf = parse_conf(check_k_conf_text())
    ssn = Session(admission_scenario(32, 40, 16, 8), conf, now=4149.0,
                  device="cpu")
    assert ssn.sla_waiting_flags().sum() == 4
    early = Session(admission_scenario(32, 40, 16, 8), conf, now=100.0,
                    device="cpu")
    assert not early.sla_waiting_flags().any()
    cfg = ssn.enqueue_config()
    assert cfg.enable_proportion_gate and cfg.enable_overcommit_gate
    _, extras = ssn._derived_allocate_inputs()
    assert np.isfinite(extras.job_deadline).sum() == 4


@pytest.mark.parametrize("name", ["preempt", "reclaim", "elect", "reserve"])
def test_unported_action_names_its_roadmap_item(name):
    with pytest.raises(KeyError, match="ROADMAP queue 1 item 5b"):
        get_action(name)


def test_chip_smoke_check_k_conf_is_the_ci_conf():
    """chip_smoke.py builds check K's conf from dataclasses (the card's
    machine has no PyYAML): conf/volcano-scheduler-ci.conf's tiers with the
    actions enqueue, allocate, backfill."""
    import chip_smoke
    assert chip_smoke.check_k_conf() == parse_conf(check_k_conf_text())


def test_check_k_target_script_conf_is_the_tests():
    import importlib.util
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "check_k_targets", os.path.join(repo, "scripts",
                                        "check_k_targets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.conf_text() == check_k_conf_text()
