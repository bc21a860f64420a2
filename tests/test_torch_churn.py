"""The port's steady cycle over churn: reopen, refresh, delta upload.

At (64 nodes, 40 gangs of 4), under gang + binpack and under the shipped
conf/volcano-scheduler.conf: cycle 0 in full, then 3 churn cycles, each
completing a tenth of the placed gangs and resetting another tenth to
Pending (``synthetic.steady_churn``). Every cycle's decisions must equal a
fresh full port Session's on a copy of the cluster taken before the cycle,
and the JAX Session's, itself reopened with delta uploads on the same
churn; each churn cycle refreshes in place and ships a delta smaller than
a full upload.
"""

import numpy as np
import pytest

import volcano_tpu.api as japi
from torch_fixtures import shipped_conf_text
from volcano_tpu.framework import Session as JaxSession
from volcano_tpu.framework import parse_conf as jax_parse_conf
from volcano_tpu_torch.framework import Session, parse_conf
from volcano_tpu_torch.synthetic import _synthetic_cluster, steady_churn

CONFS = {
    "gang_binpack": "actions: allocate\ntiers:\n- plugins:\n"
                    "  - name: gang\n  - name: binpack\n",
    "shipped": None,
}
SHAPE = (64, 40, 4)
NOW = 1000.0


def decisions(res):
    return [np.asarray(getattr(res, f)).astype(np.int32)
            for f in ("task_node", "task_mode", "task_gpu", "job_ready",
                      "job_pipelined", "job_attempted")]


def mark(ssn, jobs, nodes):
    for uid in jobs:
        ssn.mark_dirty(job_uid=uid)
    for name in nodes:
        ssn.mark_dirty(node_name=name)


@pytest.mark.parametrize("conf_name", sorted(CONFS))
def test_churn_cycles_match_fresh_and_jax_sessions(conf_name):
    text = CONFS[conf_name] or shipped_conf_text()
    ci = _synthetic_cluster(*SHAPE)
    jci = _synthetic_cluster(*SHAPE, api=japi)
    ssn = Session(ci, parse_conf(text), now=NOW, device="cpu")
    jssn = JaxSession(jci, jax_parse_conf(text), now=NOW)
    rng, jrng = np.random.RandomState(5), np.random.RandomState(5)
    kinds = []
    for cycle in range(4):
        if cycle:
            touched = steady_churn(ci, rng, 0.1)
            assert touched == steady_churn(jci, jrng, 0.1, api=japi)
            assert touched[0]
            mark(ssn, *touched)
            mark(jssn, *touched)
            assert ssn.reopen(now=NOW) and jssn.reopen(now=NOW)
            assert ssn.stats["refresh"] and "pack_ms" not in ssn.stats
        fresh = Session(ci.clone(), parse_conf(text), now=NOW, device="cpu")
        fresh.run_allocate()
        ssn.run_allocate()
        jssn.run_allocate()
        got = decisions(ssn.last_allocate)
        for want in (decisions(fresh.last_allocate),
                     decisions(jssn.last_allocate)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        assert got[1].any(), "the cycle placed nothing"
        kinds.append(ssn.stats["last_kind"])
        assert jssn.stats["delta_cycle"] == float(cycle > 0)
        assert ssn.stats["full_upload_bytes"] == fresh.stats[
            "full_upload_bytes"]
        if cycle:
            assert 0 < ssn.stats["upload_bytes"] < ssn.stats[
                "full_upload_bytes"]
        assert "recoveries" not in ssn.stats
        assert {b.task_uid: b.node_name for b in ssn.binds} == {
            b.task_uid: b.node_name for b in jssn.binds}
    assert kinds == ["full", "delta", "delta", "delta"]
    state = next(iter(ssn._resident.values()))
    assert (state.full_cycles, state.delta_cycles) == (1, 3)
