"""The port's sharded allocate cycle under the confs whose ordering keys
move with every commit: the built-in default conf, the shipped
``conf/volcano-scheduler.conf`` (drf + proportion) and hierarchical drf;
the same confs on the wavefront walk (``wave_width`` > 1); and the
reference's planted contention fixture, where a wave must truncate.

The port's ``make_sharded_allocate`` on D virtual shards of the CPU must
give the ``packed_decisions`` of the JAX package's sharded cycle (the
shard-local candidate kernel in interpret mode under shard_map on 4
virtual CPU devices) and of the JAX scan path, element for element. Like
``tests/test_torch_sharded.py``, these tests ignore shard_map's
DeprecationWarning (ROADMAP section 3 (b)) and no other warning.
"""

import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

import jax
from volcano_tpu.arrays import pack
from volcano_tpu.ops.allocate_scan import AllocateConfig, AllocateExtras
from volcano_tpu.ops.allocate_scan import make_allocate_cycle as jax_cycle
from volcano_tpu.telemetry.cycle import unpack_cycle_telemetry

from fixtures import build_job, build_task, simple_cluster
from torch_fixtures import (SHARD_MAP_WARNING, jax_scan_packed,
                            jax_sharded_packed, need_jax_devices, port_cfg,
                            port_inputs, port_sharded_packed, sharded_inputs)
from volcano_tpu_torch.ops import allocate_scan as tas
from volcano_tpu_torch.ops import shard_wave as sw
from volcano_tpu_torch.parallel import NodeMesh, make_sharded_allocate


@pytest.mark.filterwarnings(SHARD_MAP_WARNING)
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("name", ["builtin_default", "shipped", "hdrf"])
def test_conf_matches_jax_sharded_and_scan(name, D):
    """The built-in conf, the shipped conf (drf + proportion) and hdrf,
    whose ordering keys move with every commit: the port at D shards
    equals the JAX sharded cycle on 4 virtual devices and the JAX scan
    path."""
    need_jax_devices(4)
    got = port_sharded_packed(name, D)
    np.testing.assert_array_equal(got, jax_sharded_packed(name, 4))
    np.testing.assert_array_equal(got, jax_scan_packed(name))
    T = sharded_inputs(name)[1].tasks.status.shape[0]
    assert (got[T:2 * T] > 0).any()


@pytest.mark.parametrize("D,W", [(1, 16), (4, 4)])
@pytest.mark.parametrize("name", ["builtin_default", "shipped", "hdrf"])
def test_conf_on_the_wave_walk_matches_scan(name, D, W):
    """The same confs with ``wave_width`` W: yields and breaks inside waves
    under moving keys give the JAX scan path's decisions (its W = 1, equal
    at every width) and the port's W = 1 sharded cycle's."""
    cfg, snap, extras = sharded_inputs(name)
    s, _ = port_inputs(snap, extras)
    sw.waves = 0
    fn = make_sharded_allocate(port_cfg(cfg, wave_width=W),
                               NodeMesh((torch.device("cpu"),) * D), s)
    got = fn(*port_inputs(snap, extras)).packed_decisions().numpy()
    assert sw.waves > 0
    np.testing.assert_array_equal(got, jax_scan_packed(name))
    np.testing.assert_array_equal(got, port_sharded_packed(name, D))


@functools.lru_cache(maxsize=None)
def contended():
    """tests/test_wavefront.py's planted contention: 16 identical nodes and
    one 16-task gang of identical tasks under spread scoring, so every
    slot of a wave sees the same node order, and at W = 16 (depth 8) the
    tail slots exhaust their lists."""
    ci = simple_cluster(n_nodes=16, node_cpu="8", node_mem="16Gi")
    job = build_job("default/big", min_available=16)
    for i in range(16):
        job.add_task(build_task(f"p{i}", cpu="2", memory="2Gi"))
    ci.add_job(job)
    snap, _ = pack(ci)
    return snap, AllocateExtras.neutral(snap)


@functools.lru_cache(maxsize=None)
def jax_contended(W):
    """The JAX scan path's decisions and ``wave_truncations`` at width W."""
    snap, extras = contended()
    T = snap.tasks.resreq.shape[0]
    J = snap.jobs.task_table.shape[0]
    R = snap.nodes.idle.shape[1]
    cfg = AllocateConfig(least_allocated_weight=1.0, wave_width=W,
                         telemetry=True)
    packed = np.asarray(jax.jit(jax_cycle(cfg))(snap, extras)
                        .packed_decisions())
    tel = unpack_cycle_telemetry(packed[3 * T + 3 * J:], R)
    return packed[:3 * T + 3 * J], tel["wave_truncations"]


@pytest.mark.parametrize("D", [1, 2])
def test_planted_contention_truncates_as_the_reference(D):
    """W = 16 truncates, as often as the JAX scan path's ``wave_truncations``
    counter says; W = 8 does not; the decisions are W = 1's."""
    snap, extras = contended()
    base = AllocateConfig(least_allocated_weight=1.0)
    T = snap.tasks.resreq.shape[0]
    s, e = port_inputs(snap, extras)
    mesh = NodeMesh((torch.device("cpu"),) * D)
    seq = tas.make_allocate_cycle(port_cfg(base), mesh=mesh)(
        s, e).packed_decisions().numpy()
    assert (seq[T:2 * T] > 0).sum() == 16
    for W, truncates in ((8, False), (16, True)):
        want, truncations = jax_contended(W)
        sw.waves = sw.truncations = 0
        got = tas.make_allocate_cycle(
            port_cfg(dataclasses.replace(base, wave_width=W)), mesh=mesh)(
                s, e).packed_decisions().numpy()
        np.testing.assert_array_equal(got, seq)
        np.testing.assert_array_equal(got, want)
        assert sw.truncations == truncations, W
        assert (sw.truncations > 0) == truncates, W


@pytest.mark.parametrize("limit", ["jobs", "keys"])
@pytest.mark.parametrize("name", ["shipped", "hdrf"])
def test_a_snapshot_kernel_3_refuses_takes_the_one_shard_mesh(
        name, limit, monkeypatch):
    """A dynamic-key snapshot that the dynamic-key kernel's launch plan
    refuses (J past its job limit, or more ordering keys than it keys
    on; here the limits are lowered, as a card with less shared memory or
    a longer key plan would meet them) takes the one-shard mesh path,
    chosen from shapes before the cycle: no dynamic-key launch, pops
    through the shard-local candidate search, and the fused path's
    decisions, which are the JAX scan path's."""
    from volcano_tpu_torch.ops import dyn_placer as dp
    from volcano_tpu_torch.ops import shard_placer as sp
    cfg, snap, extras = sharded_inputs(name)
    pcfg = port_cfg(cfg)
    assert pcfg.batch_rounds > 0
    s, e = port_inputs(snap, extras)
    assert tas.cycle_path(pcfg, s, e) == "dyn"
    dp.pops = 0
    fused = tas.make_allocate_cycle(pcfg)(s, e).packed_decisions().numpy()
    assert dp.pops > 0
    if limit == "jobs":
        monkeypatch.setattr(dp, "MAX_SHARED", 0)
        match = "J <= 0"
    else:
        monkeypatch.setattr(dp, "MAX_KEYS", 3)
        match = "ordering keys, over 3"
    assert tas.cycle_path(pcfg, s, e) == "dyn_mesh"
    assert re.search(match, tas.dyn_refusal(pcfg, s, e))
    dp.pops = sp.pops = 0
    got = tas.make_allocate_cycle(pcfg)(s, e).packed_decisions().numpy()
    assert dp.pops == 0 and sp.pops > 0
    np.testing.assert_array_equal(got, fused)
    np.testing.assert_array_equal(got, jax_scan_packed(name))
    # a dynamic-key placer given by the caller is never routed
    dp.pops = 0
    plain = tas.make_allocate_cycle(pcfg, dyn_placer=dp.dyn_place_plain)(
        s, e).packed_decisions().numpy()
    assert dp.pops > 0
    np.testing.assert_array_equal(plain, fused)


def test_a_snapshot_kernel_1_refuses_takes_the_one_shard_mesh(monkeypatch):
    """A static-key snapshot whose node slice the round placer's kernel
    does not hold (here its shared memory is lowered, as more resource
    dims or nodes would meet it) takes the one-shard mesh path, chosen
    from shapes before the cycle: no round-placer launch, pops through
    the shard-local candidate search, and the fused path's decisions,
    which are the JAX scan path's. A placer given by the caller is never
    routed; with pod affinity on, the route raises as the mesh path
    does."""
    from volcano_tpu_torch.ops import round_placer as rp
    from volcano_tpu_torch.ops import shard_placer as sp
    cfg, snap, extras = sharded_inputs("gang_binpack_raw")
    pcfg = port_cfg(cfg)
    assert pcfg.batch_rounds == 0
    s, e = port_inputs(snap, extras)
    assert tas.cycle_path(pcfg, s, e) == "round"
    fused = tas.make_allocate_cycle(pcfg)(s, e).packed_decisions().numpy()
    monkeypatch.setattr(rp, "MAX_SHARED", 0)
    assert tas.cycle_path(pcfg, s, e) == "round_mesh"
    assert re.search("over the 0 a block", tas.round_refusal(pcfg, s, e))
    calls = []
    monkeypatch.setattr(rp, "round_place", lambda *a: calls.append(a))
    sp.pops = 0
    got = tas.make_allocate_cycle(pcfg)(s, e).packed_decisions().numpy()
    assert calls == [] and sp.pops > 0
    np.testing.assert_array_equal(got, fused)
    np.testing.assert_array_equal(got, jax_scan_packed("gang_binpack_raw"))
    plain = tas.make_allocate_cycle(pcfg, placer=rp.round_place_plain)(
        s, e).packed_decisions().numpy()
    np.testing.assert_array_equal(plain, fused)
    aff = dataclasses.replace(pcfg, enable_pod_affinity=True)
    with pytest.raises(NotImplementedError, match="6d"):
        tas.make_allocate_cycle(aff)(s, e)
