"""The port's Session.refresh_snapshot against a full pack and against the
JAX Session's refresh.

The reference's ``tests/test_refresh.py`` cases, as one parametrised test:
after binds and status churn on an unchanged entity set, the patched
arrays must equal a from-scratch ``pack`` of the mutated cluster field by
field, and the JAX Session's patched arrays on the same cluster, built
with each package's ``api`` from one seed. The reference's eviction case
waits for the port's ``evict_task`` (ROADMAP queue 1 item 5b).
"""

import numpy as np
import pytest

import volcano_tpu.api as japi
import volcano_tpu_torch.api as tapi
from torch_fixtures import tree_to_numpy
from volcano_tpu.framework import Session as JaxSession
from volcano_tpu.framework import parse_conf as jax_parse_conf
from volcano_tpu_torch.arrays import pack
from volcano_tpu_torch.framework import Session, parse_conf
from volcano_tpu_torch.synthetic import _synthetic_cluster

CONF = ("actions: allocate\ntiers:\n- plugins:\n  - name: gang\n"
        "  - name: binpack\n")


def clear_from_nodes(ci, ssn, job, status):
    """Take ``job``'s tasks off their nodes and give them ``status``."""
    for task in list(job.tasks.values()):
        node = ci.nodes.get(task.node_name)
        if node is not None and task.uid in node.tasks:
            node.remove_task(task)
            ssn.mark_dirty(node_name=node.name)
        job.update_task_status(task, status)
        task.node_name = ""
    ssn.mark_dirty(job_uid=job.uid)


def apply_churn(api, ci, ssn):
    pass


def status_churn(api, ci, ssn):
    """Bound tasks of one gang go Running; another gang completes."""
    uids = sorted(ci.jobs)
    run_job = ci.jobs[uids[0]]
    for task in run_job.tasks.values():
        if task.status == api.TaskStatus.BINDING:
            run_job.update_task_status(task, api.TaskStatus.RUNNING)
    ssn.mark_dirty(job_uid=run_job.uid)
    clear_from_nodes(ci, ssn, ci.jobs[uids[1]], api.TaskStatus.SUCCEEDED)


def reset_to_pending(api, ci, ssn):
    """A bound gang goes back to Pending (completed and resubmitted)."""
    job = ci.jobs[sorted(ci.jobs)[3]]
    clear_from_nodes(ci, ssn, job, api.TaskStatus.PENDING)
    job.allocated = type(job.allocated)({})


def queue_close_and_capacity(api, ci, ssn):
    """A queue closes (its jobs' schedulable flips) and a node's
    allocatable grows (cluster capacity moves)."""
    assert ssn.refresh_snapshot()       # take in the bind churn first
    ci.queues["default"].state = api.QueueState.CLOSED
    node = ci.nodes[sorted(ci.nodes)[0]]
    big = {"cpu": "32", "memory": "128Gi", "pods": "110"}
    node.allocatable = api.Resource.from_resource_list(big)
    node.capability = api.Resource.from_resource_list(big)
    ssn.mark_dirty(node_name=node.name)


def namespace_weight(api, ci, ssn):
    assert ssn.refresh_snapshot()
    ci.namespaces["default"].weight = 7


def entity_set_change(api, ci, ssn):
    """A job that arrived after the pack: the refresh repacks in full."""
    job = api.JobInfo("default/late", queue="default", min_available=1,
                      pod_group_phase=api.PodGroupPhase.INQUEUE)
    job.add_task(api.TaskInfo(
        uid="default/late-0", name="late-0",
        resreq=api.Resource.from_resource_list({"cpu": "1",
                                                "memory": "1Gi"})))
    ci.add_job(job)
    ssn.mark_dirty(job_uid="default/late")


CASES = {f.__name__: f for f in (apply_churn, status_churn, reset_to_pending,
                                  queue_close_and_capacity, namespace_weight,
                                  entity_set_change)}


def assert_fields_equal(got, want, path="snap"):
    """Field by field, naming the first field that differs."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_fields_equal(got[k], want[k], f"{path}.{k}")
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_refresh_matches_full_pack_and_jax(case):
    sessions = []
    for api, session, conf in ((tapi, Session, parse_conf),
                               (japi, JaxSession, jax_parse_conf)):
        ci = _synthetic_cluster(6, 8, 4, seed=2, api=api)
        kw = dict(device="cpu") if api is tapi else {}
        ssn = session(ci, conf(CONF), **kw)
        ssn.run_allocate()
        assert ssn.binds
        CASES[case](api, ci, ssn)
        sessions.append((ci, ssn, ssn.refresh_snapshot()))
    (ci, ssn, ok), (_, jssn, jok) = sessions
    assert ok == jok == (case != "entity_set_change")
    got = tree_to_numpy(ssn.snap)
    assert_fields_equal(got, tree_to_numpy(pack(ci)[0]))
    assert_fields_equal(got, tree_to_numpy(jssn.snap))
    if case == "queue_close_and_capacity":
        jq = ssn.snap.jobs.queue[:len(ci.jobs)]
        closed = jq == ssn.maps.queue_index["default"]
        assert closed.any()
        assert not np.asarray(ssn.snap.jobs.schedulable)[:len(ci.jobs)][
            closed].any()
    if case == "entity_set_change":
        assert "default/late" in ssn.maps.job_index
    if case == "reset_to_pending":
        # the next cycle places the reset gang again, as the JAX one does
        uid = sorted(ci.jobs)[3]
        for s in (ssn, jssn):
            before = len(s.binds)
            s.run_allocate()
            again = [b for b in s.binds[before:] if b.job_uid == uid]
            assert len(again) == len(ci.jobs[uid].tasks)
        assert ({b.task_uid: b.node_name for b in ssn.binds}
                == {b.task_uid: b.node_name for b in jssn.binds})
