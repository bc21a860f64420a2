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
