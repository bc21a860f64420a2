"""The port's allocate cycle against the JAX package's three references,
on its static-key and its dynamic-key path.

Snapshots are packed by the JAX package and handed to the port as the same
bytes (``snapshot_from_numpy``). The port's cycle runs on the CPU, where its
round placer takes the plain version, and its ``packed_decisions`` must
equal, element for element:

- the JAX cycle through the Pallas kernel in interpret mode (batch_jobs=8);
- the JAX scan path (no kernel, one pop per round);
- the numpy oracle ``runtime/cpu_reference.allocate_cpu``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import volcano_tpu.api as japi
from volcano_tpu.arrays import pack
from volcano_tpu.ops.allocate_scan import AllocateConfig, AllocateExtras
from volcano_tpu.ops.allocate_scan import make_allocate_cycle as jax_cycle
from volcano_tpu.runtime.cpu_reference import allocate_cpu

from torch_fixtures import (HDRF_SCENARIO, fingerprint, hdrf_cluster,
                            oracle_packed, port_cfg, port_inputs,
                            random_cluster)
from volcano_tpu_torch.ops import allocate_scan as tas
from volcano_tpu_torch.ops import dyn_placer as dp
from volcano_tpu_torch.ops import round_placer as rp

BINPACK_TAINT = AllocateConfig(binpack_weight=0.7, taint_prefer_weight=1.0)


def port_packed(snap, extras, cfg, **overrides):
    s, e = port_inputs(snap, extras)
    res = tas.make_allocate_cycle(port_cfg(cfg, **overrides))(s, e)
    return res.packed_decisions().numpy()


@pytest.mark.parametrize("seed,kw,cfg", [
    (0, {}, AllocateConfig()),
    (3, dict(gpus=True), BINPACK_TAINT),
    (5, dict(n_nodes=7, n_jobs=9, gpus=True, taints=True), BINPACK_TAINT),
    (7, dict(taints=True), AllocateConfig(
        binpack_weight=1.0, least_allocated_weight=1.0,
        most_allocated_weight=0.5, balanced_weight=1.0,
        taint_prefer_weight=1.0)),
])
def test_cycle_matches_interpret_scan_and_oracle(seed, kw, cfg):
    ci = random_cluster(japi, seed, **kw)
    snap, _ = pack(ci)
    extras = AllocateExtras.neutral(snap)
    got = port_packed(snap, extras, cfg, batch_jobs=8)
    interp = jax.jit(jax_cycle(dataclasses.replace(
        cfg, use_pallas="interpret", batch_jobs=8)))(snap, extras)
    scan = jax.jit(jax_cycle(dataclasses.replace(
        cfg, use_pallas=False)))(snap, extras)
    np.testing.assert_array_equal(got, np.asarray(interp.packed_decisions()))
    np.testing.assert_array_equal(got, np.asarray(scan.packed_decisions()))
    np.testing.assert_array_equal(got, oracle_packed(
        allocate_cpu(snap, extras, cfg)))
    assert (got[:snap.tasks.status.shape[0]] >= 0).any()


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_batch_width_does_not_change_decisions(batch):
    """K-job batching is exact under static keys: every K gives the
    oracle's decisions."""
    ci = random_cluster(japi, 6, n_nodes=7, n_jobs=9, taints=True)
    snap, _ = pack(ci)
    extras = AllocateExtras.neutral(snap)
    got = port_packed(snap, extras, BINPACK_TAINT, batch_jobs=batch)
    np.testing.assert_array_equal(got, oracle_packed(
        allocate_cpu(snap, extras, BINPACK_TAINT)))


def test_gpu_elision_is_neutral():
    ci = random_cluster(japi, 8, taints=True)
    snap, _ = pack(ci)
    extras = AllocateExtras.neutral(snap)
    on = port_packed(snap, extras, BINPACK_TAINT, batch_jobs=4)
    off = port_packed(snap, extras, BINPACK_TAINT, batch_jobs=4,
                      enable_gpu=False)
    np.testing.assert_array_equal(on, off)


def test_subscale_matches_scan_and_fingerprint():
    """(1024 nodes, 640 jobs x 16 tasks), the bench's cluster at a tenth
    of its size: the gang + binpack decisions of the JAX scan path, and
    the fingerprint the JAX Session and the oracle give for it."""
    from __graft_entry__ import _synthetic_cluster
    snap, _ = pack(_synthetic_cluster(1024, 640, 16))
    extras = AllocateExtras.neutral(snap)
    cfg = AllocateConfig(binpack_weight=1.0, least_allocated_weight=0.0,
                         balanced_weight=0.0, taint_prefer_weight=0.0,
                         enable_gpu=False)
    s, e = port_inputs(snap, extras)
    res = tas.make_allocate_cycle(port_cfg(cfg, batch_jobs=8))(s, e)
    assert fingerprint(res.task_node.numpy(),
                       res.task_mode.numpy()) == "60a8509ec33e772c"
    assert int((res.task_mode == tas.MODE_ALLOCATED).sum()) == 10240
    scan = jax.jit(jax_cycle(dataclasses.replace(
        cfg, use_pallas=False)))(snap, extras)
    np.testing.assert_array_equal(res.packed_decisions().numpy(),
                                  np.asarray(scan.packed_decisions()))


def test_cycle_goes_through_the_given_placer():
    """The placer seam: every round calls it with the kernel's signature
    (the chip check uses it to capture launches and to run the plain
    version on the card)."""
    ci = random_cluster(japi, 1)
    snap, _ = pack(ci)
    extras = AllocateExtras.neutral(snap)
    calls = []

    def watch(cfg, K, M, args):
        calls.append((K, M, len(args)))
        return rp.round_place_plain(cfg, K, M, args)

    s, e = port_inputs(snap, extras)
    cfg = port_cfg(BINPACK_TAINT, batch_jobs=8, enable_gpu=False)
    res = tas.make_allocate_cycle(cfg, placer=watch)(s, e)
    assert calls and all(c == (8, snap.jobs.task_table.shape[1], 29)
                         for c in calls)
    np.testing.assert_array_equal(res.packed_decisions().numpy(),
                                  oracle_packed(allocate_cpu(snap, extras,
                                                             BINPACK_TAINT)))


@pytest.mark.parametrize("overrides", [
    dict(enable_host_ports=True), dict(telemetry=True),
    dict(enable_host_ports=True, drf_job_order=True, batch_rounds=32),
    dict(telemetry=True, drf_ns_order=True, batch_jobs=8, batch_rounds=32)])
def test_unported_configs_name_their_roadmap_item(overrides):
    cfg = tas.AllocateConfig(**overrides)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tas.make_allocate_cycle(cfg)
    if cfg.enable_host_ports:
        with pytest.raises(NotImplementedError, match="item 4b"):
            tas.make_allocate_cycle(cfg)


@pytest.mark.parametrize("overrides", [
    dict(batch_jobs=8), dict(drf_job_order=True, batch_jobs=8,
                             batch_rounds=32)])
def test_wave_width_on_the_fused_placers_is_sequential(overrides):
    """Without a mesh the fused placers take whole job sections and ignore
    ``wave_width``, as the reference's do (its allocate_scan.py:623-627,
    ``test_pallas_fused_clamps_to_sequential``): W = 4 gives the W = 1
    decisions and the JAX interpret cycle's at W = 4, and raises
    nothing."""
    ci = random_cluster(japi, 3, gpus=True)
    snap, _ = pack(ci)
    extras = AllocateExtras.neutral(snap)
    got = port_packed(snap, extras, BINPACK_TAINT, wave_width=4, **overrides)
    np.testing.assert_array_equal(
        got, port_packed(snap, extras, BINPACK_TAINT, **overrides))
    if not overrides.get("batch_rounds"):
        want = jax.jit(jax_cycle(dataclasses.replace(
            BINPACK_TAINT, use_pallas="interpret", wave_width=4,
            **overrides)))(snap, extras)
        np.testing.assert_array_equal(got,
                                      np.asarray(want.packed_decisions()))


@pytest.mark.parametrize("overrides", [
    dict(enable_pod_affinity=True, batch_rounds=32, batch_jobs=8),
    dict(enable_pod_affinity=True)])
def test_pod_affinity_configs_match_jax_cycle(overrides):
    """The two pod-affinity configurations that raised before the port
    carried kernel 2: the dynamic-key placer (drf job order) and one job
    per round, against the JAX scan path on the same snapshot."""
    from volcano_tpu.arrays.affinity import build_affinity

    from torch_fixtures import pod_affinity_cluster
    ci = pod_affinity_cluster(japi, 6, n_nodes=16, n_jobs=6, zones=4,
                              racks=5, running_pods=6)
    snap, maps = pack(ci)
    N, T = snap.nodes.idle.shape[0], snap.tasks.resreq.shape[0]
    extras = dataclasses.replace(AllocateExtras.neutral(snap),
                                 affinity=build_affinity(ci, maps, N, T))
    cfg = AllocateConfig(binpack_weight=1.0, least_allocated_weight=0.0,
                         balanced_weight=0.0, taint_prefer_weight=0.0,
                         drf_job_order="batch_rounds" in overrides,
                         enable_gpu=False, enable_pod_affinity=True)
    got = port_packed(snap, extras, cfg, **overrides)
    scan = jax.jit(jax_cycle(dataclasses.replace(
        cfg, use_pallas=False)))(snap, extras)
    np.testing.assert_array_equal(got, np.asarray(scan.packed_decisions()))
    assert (got[T:2 * T] > 0).any()


def test_static_batching_refuses_dynamic_keys():
    """The one-place assert behind derive_batching (allocate_scan.py:556
    there): K > 1 on the static-key path cannot carry drf/hdrf keys."""
    for flags in (dict(drf_job_order=True), dict(drf_ns_order=True),
                  dict(enable_hdrf=True)):
        with pytest.raises(ValueError, match="static ordering keys"):
            tas.make_allocate_cycle(tas.AllocateConfig(batch_jobs=8,
                                                       **flags))


def test_derive_batching_matches_reference():
    from volcano_tpu.ops.allocate_scan import derive_batching as jax_derive
    for kw, deserved in [({}, np.full((2, 2), np.inf, np.float32)),
                         ({}, np.zeros((2, 2), np.float32)),
                         (dict(drf_job_order=True), None),
                         (dict(batch_jobs=4), None)]:
        d = deserved if deserved is not None else np.full((2, 2), np.inf)
        want = jax_derive(AllocateConfig(**kw), d)
        got = tas.derive_batching(tas.AllocateConfig(**kw), d)
        assert (got.batch_jobs, got.batch_rounds) == (want.batch_jobs,
                                                      want.batch_rounds)


def test_to_device_keeps_dtypes():
    from volcano_tpu_torch.arrays import to_device
    ci = random_cluster(japi, 2, gpus=True)
    snap, _ = pack(ci)
    s, e = port_inputs(snap, AllocateExtras.neutral(snap))
    assert s.nodes.idle.dtype == torch.float32
    assert s.tasks.template.dtype == torch.int32
    assert s.jobs.valid.dtype == torch.bool
    assert e.affinity.cnt0.dtype == torch.float32
    again = to_device(s, "cpu")
    assert torch.equal(again.nodes.idle, s.nodes.idle)
    with pytest.raises(TypeError):
        to_device(np.zeros(3, np.float64), "cpu")


# --------------------------------------------------------------------------
# the dynamic-key path (tests/test_pallas_place.py TestDynamicKeyRounds)
# --------------------------------------------------------------------------

def _finite_deserved(snap, maps, extras):
    d = np.asarray(extras.queue_deserved).copy()
    d[maps.queue_index["default"]] = 2.5
    d[maps.queue_index["batch"]] = 4.0
    extras.queue_deserved = d
    return extras


def _zero_deserved(snap, maps, extras):
    d = np.asarray(extras.queue_deserved).copy()
    d[maps.queue_index["default"]] = 0.0
    extras.queue_deserved = d
    return extras


DRF = AllocateConfig(binpack_weight=1.0, drf_job_order=True,
                     enable_gpu=False)
DYN_SCENARIOS = {
    "drf_seed0": (0, {}, DRF, None),
    "drf_seed3": (3, {}, DRF, None),
    "drf_ns": (2, dict(ns=True), dataclasses.replace(DRF, drf_ns_order=True),
               None),
    "finite_deserved": (1, {}, AllocateConfig(binpack_weight=1.0,
                                              enable_gpu=False),
                        _finite_deserved),
    "zero_deserved_flip": (7, {}, AllocateConfig(binpack_weight=1.0,
                                                 enable_gpu=False),
                           _zero_deserved),
    "gpu_drf": (0, dict(gpus=True), dataclasses.replace(DRF,
                                                        enable_gpu=True),
                None),
}


@pytest.mark.parametrize("name", sorted(DYN_SCENARIOS))
def test_dynamic_keys_match_interpret_scan_and_oracle(name):
    """The port's dynamic-key cycle (its placer's plain version on the CPU)
    against the JAX dyn cycle through the Pallas kernel in interpret mode,
    the scan path and the numpy oracle: equal packed decisions."""
    from test_pallas_place import dyn_cluster
    seed, kw, cfg, extras_fn = DYN_SCENARIOS[name]
    ci = dyn_cluster(seed, **kw)
    snap, maps = pack(ci)
    extras = AllocateExtras.neutral(snap)
    if extras_fn:
        extras = extras_fn(snap, maps, extras)
    got = port_packed(snap, extras, cfg, batch_jobs=8, batch_rounds=32)
    small = port_packed(snap, extras, cfg, batch_jobs=3, batch_rounds=5)
    # one job per round on the static-key placer, keys recomputed per pop
    single = port_packed(snap, extras, cfg, batch_jobs=1, batch_rounds=0)
    interp = jax.jit(jax_cycle(dataclasses.replace(
        cfg, use_pallas="interpret", batch_jobs=8,
        batch_rounds=32)))(snap, extras)
    scan = jax.jit(jax_cycle(dataclasses.replace(
        cfg, use_pallas=False)))(snap, extras)
    np.testing.assert_array_equal(got, np.asarray(interp.packed_decisions()))
    np.testing.assert_array_equal(got, np.asarray(scan.packed_decisions()))
    np.testing.assert_array_equal(got, small)
    np.testing.assert_array_equal(got, single)
    np.testing.assert_array_equal(got, oracle_packed(
        allocate_cpu(snap, extras, cfg)))
    assert (got[:snap.tasks.status.shape[0]] > 0).any()


def test_hdrf_frozen_columns_guard():
    """hdrf: the level keys are frozen per launch, and a pop after a commit
    proceeds only while the eligible jobs share one queue. The
    hdrf_test.go scenario against the oracle (which the JAX suite holds
    equal to the scan path and the dyn kernel here,
    test_pallas_place.py::TestDynamicKeyRounds)."""
    from volcano_tpu.arrays.hierarchy import build_hierarchy
    ci = hdrf_cluster(japi, *HDRF_SCENARIO)
    snap, maps = pack(ci)
    Q, J = snap.queues.weight.shape[0], snap.jobs.valid.shape[0]
    extras = AllocateExtras.neutral(snap)
    extras.hierarchy = build_hierarchy(ci, maps, Q, J)
    cfg = AllocateConfig(enable_gang=False, enable_hdrf=True,
                         drf_job_order=True)
    calls = []

    def watch(pcfg, C, KP, M, args):
        out = dp.dyn_place_plain(pcfg, C, KP, M, args)
        calls.append(int(out[-2][0, 0]))
        return out

    s, e = port_inputs(snap, extras)
    res = tas.make_allocate_cycle(port_cfg(cfg, batch_jobs=4,
                                           batch_rounds=12),
                                  dyn_placer=watch)(s, e)
    got = res.packed_decisions().numpy()
    np.testing.assert_array_equal(got, oracle_packed(
        allocate_cpu(snap, extras, cfg)))
    # the guard cut launches short: fewer pops than the budget while work
    # was left
    assert max(calls) < 12 and len(calls) > 1


def test_dynamic_cycle_goes_through_the_given_placer():
    """The dyn placer seam: every round calls it with the kernel's
    signature; the cycle counts the pops and early stops it reads back."""
    from test_pallas_place import dyn_cluster
    snap, _ = pack(dyn_cluster(0))
    extras = AllocateExtras.neutral(snap)
    seen = []

    def watch(cfg, C, KP, M, args):
        seen.append((C, KP, M, len(args)))
        return dp.dyn_place_plain(cfg, C, KP, M, args)

    dp.pops = dp.early_stops = 0
    s, e = port_inputs(snap, extras)
    cfg = port_cfg(DRF, batch_jobs=8, batch_rounds=32)
    res = tas.make_allocate_cycle(cfg, dyn_placer=watch)(s, e)
    M = snap.jobs.task_table.shape[1]
    assert seen and all(c == (8, 32, M, 49) for c in seen)
    assert dp.pops >= len(seen) and dp.early_stops == len(seen)
    np.testing.assert_array_equal(res.packed_decisions().numpy(),
                                  oracle_packed(allocate_cpu(snap, extras,
                                                             DRF)))
