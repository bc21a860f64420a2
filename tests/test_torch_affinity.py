"""Inter-pod affinity in the port against the JAX package, bit for bit.

- the port's encoder (``arrays/affinity.build_affinity``) against the JAX
  one, field by field;
- the affinity step of both placers' plain versions against the Pallas
  kernels in interpret mode (``make_round_placer`` and
  ``make_dyn_round_placer`` with ``aff_dims``), on the built cases of
  ``ops/dyn_cases.py``;
- the port's static and dynamic-key cycles against the JAX interpret
  cycle, the scan path and the numpy oracle ``allocate_cpu``
  (``tests/test_affinity.py`` ``TestPallasAffinityParity`` and
  ``TestEquivalenceAt1kNodes``);
- gang discard, which must take the live counts back;
- the port's Session against the JAX Session.

Decisions and counts are integers: the tolerance is 0 everywhere.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import volcano_tpu.api as japi
import volcano_tpu_torch.api as tapi
from volcano_tpu.arrays import pack
from volcano_tpu.arrays.affinity import build_affinity as jax_build
from volcano_tpu.ops.allocate_scan import AllocateConfig as JaxConfig
from volcano_tpu.ops.allocate_scan import AllocateExtras
from volcano_tpu.ops.allocate_scan import make_allocate_cycle as jax_cycle
from volcano_tpu.ops.pallas_place import (make_dyn_round_placer,
                                          make_round_placer)
from volcano_tpu.runtime.cpu_reference import allocate_cpu

from torch_fixtures import (AFF_CASES, PLACER_WEIGHTS, aff_placer_knobs,
                            make_dyn_inputs, make_inputs, oracle_packed,
                            pod_affinity_cluster, port_cfg, port_inputs,
                            session_pair)
from volcano_tpu_torch.arrays import pack as port_pack
from volcano_tpu_torch.arrays.affinity import AffinityArrays, build_affinity
from volcano_tpu_torch.ops import allocate_scan as tas
from volcano_tpu_torch.ops import dyn_placer as dp
from volcano_tpu_torch.ops import round_placer as rp
from volcano_tpu_torch.ops.allocate_scan import AllocateConfig

#: tests/test_affinity.py CFG: binpack with pod affinity
CFG = JaxConfig(binpack_weight=1.0, least_allocated_weight=0.0,
                balanced_weight=0.0, taint_prefer_weight=0.0,
                enable_pod_affinity=True)
SMALL = dict(n_nodes=16, n_jobs=6, zones=4, racks=5, running_pods=6)


def assert_bitwise(ref, got):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape,
                                                           b.shape)
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), (
            f"output {i} differs:\n{a}\n{b}")


def jax_extras(ci):
    """(snapshot, extras with the JAX encoding) of a JAX-api cluster."""
    snap, maps = pack(ci)
    N, T = snap.nodes.idle.shape[0], snap.tasks.resreq.shape[0]
    return snap, dataclasses.replace(AllocateExtras.neutral(snap),
                                     affinity=jax_build(ci, maps, N, T))


# --------------------------------------------------------------------------
# (a) the encoder
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(namespaces=True, expressions=True)],
                         ids=["labels", "namespaces_expressions"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_affinity_matches_jax(seed, kw):
    """Every field, dtype and shape of the encoding, on clusters with
    running pods (static counts, symmetric terms), terms that name
    namespaces and terms that select by match_expressions."""
    ci = pod_affinity_cluster(japi, seed, **SMALL, **kw)
    snap, maps = pack(ci)
    N, T = snap.nodes.idle.shape[0], snap.tasks.resreq.shape[0]
    want = jax_build(ci, maps, N, T)
    port_ci = pod_affinity_cluster(tapi, seed, **SMALL, **kw)
    got = build_affinity(port_ci, port_pack(port_ci)[1], N, T)
    assert got.has_terms
    for f in dataclasses.fields(want):
        a, b = np.asarray(getattr(want, f.name)), getattr(got, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, f.name)


def test_build_affinity_without_terms_is_neutral():
    ci = pod_affinity_cluster(tapi, 0, **SMALL)
    for job in ci.jobs.values():
        for t in job.tasks.values():
            t.pod_affinity = t.pod_anti_affinity = []
            t.pod_affinity_preferred = t.pod_anti_affinity_preferred = []
    snap, maps = port_pack(ci)
    N, T = snap.nodes.idle.shape[0], snap.tasks.resreq.shape[0]
    got = build_affinity(ci, maps, N, T)
    want = AffinityArrays.neutral(N, T)
    assert not got.has_terms
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), f.name)


# --------------------------------------------------------------------------
# (b) the placers' affinity step against the Pallas kernels
# --------------------------------------------------------------------------

def round_case(case, seed, gpu):
    cfg = AllocateConfig(enable_gpu=gpu, enable_pod_affinity=True,
                         pod_affinity_weight=1.5, **PLACER_WEIGHTS)
    args = make_inputs(seed, gpu=gpu, aff=AFF_CASES[case],
                       **aff_placer_knobs(case))
    return cfg, args


@pytest.mark.parametrize("gpu", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(AFF_CASES))
def test_round_plain_matches_pallas_interpret(case, seed, gpu):
    cfg, args = round_case(case, seed, gpu)
    a = rp.unpack_args(cfg, [torch.from_numpy(x) for x in args])
    R, N = a.idle.shape
    place = make_round_placer(
        JaxConfig(**dataclasses.asdict(cfg)), 8, 4, N, R, 2,
        a.orfeas.shape[0], aff_dims=(a.skdom.shape[0], a.eta_dom.shape[0]),
        interpret=True)
    ref = [np.asarray(o) for o in place(*[jnp.asarray(x) for x in args])]
    got = rp.round_place_plain(cfg, 8, 4, [torch.from_numpy(x)
                                           for x in args])
    assert len(got) == 6 + gpu + 3
    assert_bitwise(ref, [o.numpy() for o in got])


def dyn_case(case, seed):
    flags, args = make_dyn_inputs(seed, drf_job_order=True,
                                  aff=AFF_CASES[case],
                                  **aff_placer_knobs(case))
    return AllocateConfig(**PLACER_WEIGHTS, **flags), args


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(AFF_CASES))
def test_dyn_plain_matches_pallas_interpret(case, seed):
    """The dynamic-key placer with pod affinity and drf: the affinity state
    and the in-kernel key recompute together."""
    cfg, args = dyn_case(case, seed)
    a = dp.unpack_args(cfg, [torch.from_numpy(x) for x in args])
    R, N, CM, _, J, Q, S, NH, G = dp._shapes(a)
    place = make_dyn_round_placer(
        JaxConfig(**dataclasses.asdict(cfg)), 4, 12, 4, N, R, max(G, 1),
        a.orfeas.shape[0], J, Q, max(S, 1), NH,
        aff_dims=(a.skdom.shape[0], a.eta_dom.shape[0]), interpret=True)
    ref = [np.asarray(o) for o in place(*[jnp.asarray(x) for x in args])]
    got = dp.dyn_place_plain(cfg, 4, 12, 4, [torch.from_numpy(x)
                                             for x in args])
    assert_bitwise(ref, [o.numpy() for o in got])


def test_affinity_cases_cover_what_they_name(monkeypatch):
    """Across seeds 0-2 the built cases reach what they are named for: a
    placement through the first-pod escape, a node that only an own or
    symmetric anti-affinity term vetoes, a placed task with negative
    preferred weights, no live node, and gang discards after commits to
    the counts."""
    commits = []
    commit = rp.aff_commit
    monkeypatch.setattr(rp, "aff_commit",
                        lambda *a, **k: commits.append(1) or commit(*a, **k))
    seen = dict(escape=False, anti=False, neg=False, no_live=False,
                discard=False)
    for seed in (0, 1, 2):
        for case in AFF_CASES:
            cfg, args = round_case(case, seed, False)
            t = [torch.from_numpy(x) for x in args]
            a = rp.unpack_args(cfg, t)
            commits.clear()
            out = rp.round_place_plain(cfg, 8, 4, t)
            placed = (out[1] > 0).numpy()
            if case == "first_pod_escape":
                req, tot0 = a.aff_sk.numpy(), a.aff_tot[:, 0].numpy()
                escape = (req >= 0) & (tot0[np.maximum(req, 0)] == 0)
                seen["escape"] |= bool((placed & escape.any(0)).any())
            if case == "anti_own_and_symmetric":
                al = rp.AffLists.of(a)
                state = [a.aff_cnt, a.aff_tot, a.anti_cnt]
                for s in range(32):
                    anti = (any(row[s] >= 0 for row in al.anti)
                            or any(m[s] > 0 for m in al.etm))
                    if anti and all(row[s] < 0 for row in al.aff_sk):
                        ok, _ = rp.aff_eval(a, al, s, state)
                        seen["anti"] |= not bool(ok.all())
            if case == "negative_preferred":
                seen["neg"] |= bool((placed & (a.prefw.numpy() < 0)
                                     .any(0)).any())
            if case == "no_live_node":
                seen["no_live"] |= not bool(a.live.any())
            if case == "gang_discard":
                seen["discard"] |= len(commits) > int(placed.sum())
    assert all(seen.values()), seen


def test_wrapper_refuses_wrong_affinity_layout():
    """The wrappers check the affinity arguments as they check the others,
    on the CPU as on the card."""
    cfg, args = round_case("mixed", 0, False)
    t = [torch.from_numpy(x) for x in args]
    a = rp.unpack_args(cfg, t)
    bad = a._replace(skm=a.skm[:-1])
    with pytest.raises(ValueError, match="skm"):
        rp.round_place(cfg, 8, 4, [x for x in bad if x is not None])
    bad = a._replace(aff_tot=a.aff_tot.T.contiguous())
    with pytest.raises(ValueError, match="aff_tot"):
        rp.round_place(cfg, 8, 4, [x for x in bad if x is not None])
    dcfg, dargs = dyn_case("mixed", 0)
    d = dp.unpack_args(dcfg, [torch.from_numpy(x) for x in dargs])
    bad = d._replace(eta_dom=d.eta_dom.to(torch.float32))
    with pytest.raises(ValueError, match="eta_dom"):
        dp.dyn_place(dcfg, 4, 12, 4, [x for x in bad if x is not None])
    with pytest.raises(ValueError, match="too many"):
        rp.unpack_args(dataclasses.replace(cfg, enable_pod_affinity=False),
                       t)


# --------------------------------------------------------------------------
# (b) whole cycles (TestPallasAffinityParity)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,kw,dyn", [
    (0, {}, False), (2, {}, False),
    (1, dict(namespaces=True, expressions=True), False),
    (1, {}, True), (3, dict(namespaces=True, expressions=True), True)])
def test_cycle_matches_interpret_scan_and_oracle(seed, kw, dyn):
    ci = pod_affinity_cluster(japi, seed, **SMALL, **kw)
    snap, extras = jax_extras(ci)
    cfg = dataclasses.replace(CFG, drf_job_order=dyn)
    batch = dict(batch_jobs=4, batch_rounds=12 if dyn else 0)
    s, e = port_inputs(snap, extras)
    got = tas.make_allocate_cycle(port_cfg(cfg, **batch))(s, e) \
        .packed_decisions().numpy()
    interp = jax.jit(jax_cycle(dataclasses.replace(
        cfg, use_pallas="interpret", **batch)))(snap, extras)
    scan = jax.jit(jax_cycle(dataclasses.replace(
        cfg, use_pallas=False)))(snap, extras)
    np.testing.assert_array_equal(got, np.asarray(interp.packed_decisions()))
    np.testing.assert_array_equal(got, np.asarray(scan.packed_decisions()))
    np.testing.assert_array_equal(got, oracle_packed(
        allocate_cpu(snap, extras, cfg)))
    T = snap.tasks.status.shape[0]
    assert (got[T:2 * T] > 0).sum() > 5


@pytest.mark.parametrize("batch", [dict(batch_jobs=1), dict(batch_jobs=8),
                                   dict(batch_jobs=3, batch_rounds=5)])
def test_batching_does_not_change_affinity_decisions(batch):
    """One job per launch, eight, and the dynamic-key placer's pops give
    the scan path's decisions (with static keys the dynamic-key placer is
    exact too)."""
    ci = pod_affinity_cluster(japi, 4, **SMALL)
    snap, extras = jax_extras(ci)
    s, e = port_inputs(snap, extras)
    got = tas.make_allocate_cycle(port_cfg(CFG, **batch))(s, e) \
        .packed_decisions().numpy()
    scan = jax.jit(jax_cycle(dataclasses.replace(
        CFG, use_pallas=False)))(snap, extras)
    np.testing.assert_array_equal(got, np.asarray(scan.packed_decisions()))


def test_equivalence_at_1k_nodes():
    """TestEquivalenceAt1kNodes: 1,024 nodes in 16 zones and 128 racks,
    96 jobs, 48 running pods; the port's cycle equals the oracle."""
    ci = pod_affinity_cluster(japi, 17, n_nodes=1024, n_jobs=96, zones=16,
                              racks=128, tasks_hi=3, running_pods=48)
    snap, extras = jax_extras(ci)
    s, e = port_inputs(snap, extras)
    res = tas.make_allocate_cycle(port_cfg(CFG, batch_jobs=8))(s, e)
    cpu = allocate_cpu(snap, extras, CFG)
    np.testing.assert_array_equal(res.task_node.numpy(), cpu["task_node"])
    np.testing.assert_array_equal(res.task_mode.numpy(), cpu["task_mode"])
    assert int((res.task_mode > 0).sum()) > 40


# --------------------------------------------------------------------------
# (c) gang discard takes the counts back
# --------------------------------------------------------------------------

@pytest.mark.parametrize("gpu", [False, True])
def test_round_discard_takes_the_counts_back(gpu):
    """A section that cannot reach minAvailable leaves the affinity counts
    exactly as it found them, though its placements added to them."""
    cfg, args = round_case("mixed", 5, gpu)
    t = [torch.from_numpy(x) for x in args]
    a = rp.unpack_args(cfg, t)
    a.ready0[:] = 0
    a.minav[:] = 99      # minAvailable out of reach
    a.canb[:] = 1        # no yield
    a.secact[:] = 1
    a.active[:] = 1
    a.volok[:] = 1
    stats = {}
    out = rp.round_place_plain(cfg, 8, 4, t, stats)
    assert (out[0] == -1).all() and (out[1] == 0).all()
    assert stats["aff_commit_rows"] > 0
    for got, want in zip(out[-3:], (a.aff_cnt, a.aff_tot, a.anti_cnt)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_dyn_discard_takes_the_counts_back():
    cfg, args = dyn_case("mixed", 5)
    t = [torch.from_numpy(x) for x in args]
    a = dp.unpack_args(cfg, t)
    a.minav[:] = 99
    a.tidok[:] = 1
    a.nbe[:] = 1
    a.volok[:] = 1
    stats = {}
    out = dp.dyn_place_plain(cfg, 4, 12, 4, t, stats)
    assert (out[1] == 0).all() and stats["aff_commit_rows"] > 0
    for got, want in zip(out[6:9], (a.aff_cnt, a.aff_tot, a.anti_cnt)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def ghost_cluster(api):
    """tests/test_affinity.py test_gang_discard_rolls_back_affinity_counts:
    a gang of 5 that cannot fit on 2 nodes of 2 cpu (discarded after 4
    placements), and a task that requires a pod of that gang's app in its
    zone."""
    ci = api.ClusterInfo()
    ci.add_queue(api.QueueInfo("default", weight=1))
    res = api.Resource.from_resource_list({"cpu": "2", "memory": "4Gi"})
    for i in range(2):
        n = api.NodeInfo(f"n{i}", res.clone(), res.clone())
        n.labels.update({"zone": "a", "kubernetes.io/hostname": f"n{i}"})
        ci.add_node(n)

    def task(name, app):
        return api.TaskInfo(name, name, labels={"app": app},
                            resreq=api.Resource.from_resource_list(
                                {"cpu": "1", "memory": "1Gi"}))

    ghost = api.JobInfo("default/ghost", min_available=5, queue="default",
                        pod_group_phase=api.PodGroupPhase.INQUEUE,
                        priority=10)
    for i in range(5):
        ghost.add_task(task(f"g{i}", "ghost"))
    ci.add_job(ghost)
    seeker = api.JobInfo("default/seeker", min_available=1, queue="default",
                         pod_group_phase=api.PodGroupPhase.INQUEUE)
    s = task("s0", "seeker")
    s.pod_affinity = [api.PodAffinityTerm(topology_key="zone",
                                          match_labels={"app": "ghost"})]
    seeker.add_task(s)
    ci.add_job(seeker)
    return ci


@pytest.mark.parametrize("batch", [dict(batch_jobs=8),
                                   dict(batch_jobs=8, batch_rounds=32)])
def test_discarded_gang_does_not_satisfy_affinity(batch):
    """The gang and the seeker in one launch: the seeker's required
    affinity must not see the discarded gang's placements."""
    snap, extras = jax_extras(ghost_cluster(japi))
    s, e = port_inputs(snap, extras)
    got = tas.make_allocate_cycle(port_cfg(CFG, **batch))(s, e)
    want = jax.jit(jax_cycle(dataclasses.replace(
        CFG, use_pallas=False)))(snap, extras)
    np.testing.assert_array_equal(got.packed_decisions().numpy(),
                                  np.asarray(want.packed_decisions()))
    assert (got.task_mode == 0).all()


# --------------------------------------------------------------------------
# (d) the Session
# --------------------------------------------------------------------------

AFFINITY_CONF = ("actions: allocate\ntiers:\n- plugins:\n  - name: gang\n"
                 "  - name: predicates\n  - name: binpack\n")


def conf_text(name):
    """The gang + predicates + binpack conf, or the shipped conf file."""
    if name == "affinity":
        return AFFINITY_CONF
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "conf",
            "volcano-scheduler.conf")) as f:
        return f.read()


@pytest.mark.parametrize("conf", ["affinity", "shipped"])
@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(namespaces=True, expressions=True))])
def test_session_matches_jax_session(seed, kw, conf):
    want, got, ssn = session_pair(
        lambda api: pod_affinity_cluster(api, seed, **SMALL, **kw),
        conf_text(conf))
    assert got == want
    assert got[0], "nothing was bound"
    cfg, _ = ssn._derived_allocate_inputs()
    assert cfg.enable_pod_affinity and cfg.pod_affinity_weight == 1.0
    assert (cfg.batch_rounds > 0) == (conf == "shipped")


@pytest.mark.parametrize("conf", ["affinity", "shipped"])
def test_affinity_scenario_session_matches_jax(conf):
    """BASELINE configuration 5 (``synthetic.affinity_scenario``, a copy of
    ``scripts/affinity_record.scenario``) at 96 nodes and 24 gangs: the
    same cluster in both packages and the same decisions."""
    from scripts.affinity_record import scenario

    from volcano_tpu_torch.synthetic import affinity_scenario

    def build(api):
        return (scenario if api is japi else affinity_scenario)(
            96, 24, seed=3)

    want, got, ssn = session_pair(build, conf_text(conf))
    assert got == want
    assert len(got[0]) > 20
    assert ssn.affinity.has_terms
