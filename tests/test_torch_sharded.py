"""The port's sharded allocate cycle (``parallel/sharding.py`` and the mesh
path of ``ops/allocate_scan.make_allocate_cycle``) against the JAX
package.

The port's ``make_sharded_allocate`` runs on a mesh of D virtual shards of
the CPU (``NodeMesh((cpu,) * D)``); its ``packed_decisions`` must equal
the JAX package's sharded cycle (``make_sharded_allocate`` with the
shard-local candidate kernel in interpret mode under shard_map, on D
virtual CPU devices) and the JAX scan path, element for element. The
port's Session with ``sharding: true`` must give the JAX Session's
outcome.

``jax.experimental.shard_map`` warns that it is deprecated, and the
repository's ``tests/conftest.py`` makes every DeprecationWarning an error
(ROADMAP section 3 (b)): the tests that run the JAX sharded cycle ignore
that one warning, by its message, and no other. The built-in, shipped and
hdrf confs are in ``tests/test_torch_sharded_confs.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import volcano_tpu.api as japi
from volcano_tpu.arrays import pack
from volcano_tpu.ops.allocate_scan import AllocateConfig, AllocateExtras
from volcano_tpu.ops.allocate_scan import make_allocate_cycle as jax_cycle

from torch_fixtures import (GANG_BINPACK, SHARD_MAP_WARNING,
                            jax_scan_packed, jax_sharded_packed,
                            need_jax_devices, port_cfg, port_inputs,
                            port_sharded_packed, random_cluster,
                            session_pair, sharded_inputs, shipped_conf_text)
from volcano_tpu_torch.ops import allocate_scan as tas
from volcano_tpu_torch.ops import dyn_placer as dp
from volcano_tpu_torch.ops import round_placer as rp
from volcano_tpu_torch.ops import shard_placer as sp
from volcano_tpu_torch.ops import shard_wave as sw
from volcano_tpu_torch.parallel import (NodeMesh, make_sharded_allocate,
                                        mesh_for_nodes, scheduler_mesh)

CPU = torch.device("cpu")


@pytest.mark.filterwarnings(SHARD_MAP_WARNING)
@pytest.mark.parametrize("D", [1, 2, 4])
def test_gang_binpack_matches_jax_sharded_at_every_width(D):
    """The raw gang + binpack cycle: the port at D shards equals the JAX
    sharded cycle at D virtual devices, and the JAX scan path."""
    need_jax_devices(D)
    got = port_sharded_packed("gang_binpack_raw", D)
    np.testing.assert_array_equal(got, jax_sharded_packed("gang_binpack_raw", D))
    np.testing.assert_array_equal(got, jax_scan_packed("gang_binpack_raw"))
    T = sharded_inputs("gang_binpack_raw")[1].tasks.status.shape[0]
    assert (got[T:2 * T] > 0).sum() == 256


@pytest.mark.parametrize("seed,kw,cfg", [
    (3, dict(gpus=True), AllocateConfig(binpack_weight=0.7)),
    (5, dict(n_nodes=7, n_jobs=9, gpus=True, taints=True),
     AllocateConfig(binpack_weight=0.7, taint_prefer_weight=1.0)),
    (7, dict(taints=True), AllocateConfig(
        binpack_weight=1.0, least_allocated_weight=1.0,
        most_allocated_weight=0.5, balanced_weight=1.0,
        enable_pipelining=False)),
    (2, {}, AllocateConfig(enable_gang=False)),
])
@pytest.mark.parametrize("D", [1, 2])
def test_random_clusters_match_scan(seed, kw, cfg, D):
    """GPU cards, taints, every score family, no pipelining and no gang:
    the port's sharded cycle equals the JAX scan path."""
    ci = random_cluster(japi, seed, **kw)
    snap, _ = pack(ci)
    extras = AllocateExtras.neutral(snap)
    s, e = port_inputs(snap, extras)
    got = tas.make_allocate_cycle(port_cfg(cfg), mesh=NodeMesh((CPU,) * D))(
        s, e).packed_decisions().numpy()
    want = jax.jit(jax_cycle(dataclasses.replace(cfg, use_pallas=False)))(
        snap, extras)
    np.testing.assert_array_equal(got, np.asarray(want.packed_decisions()))


def test_gang_discard_copies_the_state_back():
    """A gang that cannot reach minAvailable is discarded: its capacity
    comes back (the job after it still binds), and its tasks are not
    placed; the remaining idle equals the scan path's."""
    def build(api):
        ci = api.ClusterInfo()
        ci.add_queue(api.QueueInfo("default", weight=1))
        ci.add_node(api.NodeInfo("n0", allocatable=api.Resource
                                 .from_resource_list({"cpu": "2",
                                                      "memory": "8Gi"})))
        for uid, minav, n, cpu in (("default/big", 3, 3, "1"),
                                   ("default/small", 1, 1, "2")):
            job = api.JobInfo(uid, queue="default", min_available=minav,
                              pod_group_phase=api.PodGroupPhase.INQUEUE)
            for t in range(n):
                job.add_task(api.TaskInfo(
                    uid=f"{uid}-{t}", name=f"{uid[8:]}-{t}",
                    resreq=api.Resource.from_resource_list(
                        {"cpu": cpu, "memory": "1Gi"})))
            ci.add_job(job)
        return ci
    snap, maps = pack(build(japi))
    extras = AllocateExtras.neutral(snap)
    cfg = AllocateConfig(binpack_weight=1.0)
    s, e = port_inputs(snap, extras)
    res = tas.make_allocate_cycle(port_cfg(cfg), mesh=NodeMesh((CPU,) * 2))(
        s, e)
    want = jax.jit(jax_cycle(dataclasses.replace(cfg, use_pallas=False)))(
        snap, extras)
    np.testing.assert_array_equal(res.packed_decisions().numpy(),
                                  np.asarray(want.packed_decisions()))
    np.testing.assert_array_equal(res.idle.numpy(), np.asarray(want.idle))
    big, small = maps.job_index["default/big"], maps.job_index["default/small"]
    assert res.job_attempted[big] and not res.job_ready[big]
    assert res.job_ready[small]


@pytest.mark.filterwarnings(SHARD_MAP_WARNING)
@pytest.mark.parametrize("conf", ["gang_binpack", "shipped"])
@pytest.mark.parametrize("seed,kw", [
    (0, {}), (3, dict(gpus=True)),
    (5, dict(n_nodes=7, n_jobs=9, gpus=True, taints=True))])
def test_session_sharding_matches_jax_session(seed, kw, conf):
    """``sharding: true`` in the conf: the port's Session (a one-shard mesh
    of the CPU) gives the JAX Session's outcome (its sharded delta path on
    the virtual CPU devices)."""
    need_jax_devices(2)
    text = "sharding: true\n" + {"gang_binpack": GANG_BINPACK,
                                 "shipped": shipped_conf_text()}[conf]
    want, got, ssn = session_pair(
        lambda api: random_cluster(api, seed, **kw), text)
    assert got == want and got[0]
    mesh = ssn._sharding_mesh()
    assert mesh is not None and mesh.devices == (CPU,)


def test_session_without_sharding_takes_no_mesh():
    from volcano_tpu_torch.framework import Session, parse_conf
    import volcano_tpu_torch.api as tapi
    ssn = Session(random_cluster(tapi, 0), parse_conf(GANG_BINPACK),
                  device="cpu")
    assert ssn._sharding_mesh() is None
    off = parse_conf("sharding: true\ndelta_uploads: false\n" + GANG_BINPACK)
    assert Session(random_cluster(tapi, 0), off,
                   device="cpu")._sharding_mesh() is None


def test_mesh_choice_follows_the_reference():
    """The largest power of two, at most the requested count, that divides
    the node axis; one device gives one shard."""
    pool = [CPU] * 8
    assert mesh_for_nodes(1024, devices=pool).size == 8
    assert mesh_for_nodes(24, devices=pool).size == 8
    assert mesh_for_nodes(12, devices=pool).size == 4
    assert mesh_for_nodes(1024, 3, devices=pool).size == 2
    assert mesh_for_nodes(1024, devices=[CPU]).size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scheduler_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_for_nodes(1024)


def test_cycle_launches_one_candidate_search_an_attempt():
    """The shard placer seam: one call per attempt (every open slot of
    every pop: each job here pops once, with 8 tasks), with the mesh's
    shard count, and pops counted."""
    cfg, snap, extras = sharded_inputs("gang_binpack_raw")
    s, e = port_inputs(snap, extras)
    calls = []

    def watch(cfg, D, args):
        calls.append(D)
        return sp.shard_candidates(cfg, D, args)
    sp.pops = 0
    res = tas.make_allocate_cycle(port_cfg(cfg), mesh=NodeMesh((CPU,) * 4),
                                  shard_placer=watch)(s, e)
    J, M = snap.jobs.task_table.shape
    assert set(calls) == {4}
    assert sp.pops == int(res.job_attempted.sum()) == 32
    assert len(calls) == sp.pops * M


# ---- the wavefront section walk (wave_width > 1 under a mesh) ------------

#: random_cluster cases of the wave tests: GPU cards, taints, every score
#: family with pipelining off, and no gang (test_random_clusters_match_scan's)
WAVE_CASES = {
    "gpus": (3, dict(gpus=True), AllocateConfig(binpack_weight=0.7)),
    "gpus_taints": (5, dict(n_nodes=8, n_jobs=9, gpus=True, taints=True),
                    AllocateConfig(binpack_weight=0.7,
                                   taint_prefer_weight=1.0)),
    "families_no_pipelining": (7, dict(taints=True), AllocateConfig(
        binpack_weight=1.0, least_allocated_weight=1.0,
        most_allocated_weight=0.5, balanced_weight=1.0,
        enable_pipelining=False)),
    "no_gang": (2, {}, AllocateConfig(enable_gang=False)),
}


@functools.lru_cache(maxsize=None)
def wave_case(name):
    seed, kw, cfg = WAVE_CASES[name]
    snap, _ = pack(random_cluster(japi, seed, **kw))
    return cfg, snap, AllocateExtras.neutral(snap)


@functools.lru_cache(maxsize=None)
def jax_wave_scan(name, W):
    """The JAX scan path at wave width W (no mesh, no kernel)."""
    cfg, snap, extras = wave_case(name)
    return np.asarray(jax.jit(jax_cycle(dataclasses.replace(
        cfg, use_pallas=False, wave_width=W)))(snap, extras)
        .packed_decisions())


def port_wave(name, D, W):
    cfg, snap, extras = wave_case(name)
    s, e = port_inputs(snap, extras)
    sw.waves = sw.fast_waves = sw.truncations = 0
    return tas.make_allocate_cycle(port_cfg(cfg, wave_width=W),
                                   mesh=NodeMesh((CPU,) * D))(
        s, e).packed_decisions().numpy()


@pytest.mark.filterwarnings(SHARD_MAP_WARNING)
def test_wave_cycle_matches_jax_sharded_wave_cycle():
    """D = 2, W = 4: the port's wave cycle equals the JAX sharded wave cycle
    (kernel 5 in interpret mode under shard_map on 2 virtual devices), the
    JAX scan path at W = 4, and the port's W = 1 cycle."""
    need_jax_devices(2)
    from volcano_tpu.parallel.sharding import make_sharded_allocate as jsa
    from volcano_tpu.parallel.sharding import scheduler_mesh as jmesh
    cfg, snap, extras = wave_case("gpus_taints")
    got = port_wave("gpus_taints", 2, 4)
    assert sw.waves > 0
    fn = jsa(dataclasses.replace(cfg, use_pallas="interpret", wave_width=4),
             jmesh(2), snap)
    np.testing.assert_array_equal(
        got, np.asarray(fn(snap, extras).packed_decisions()))
    np.testing.assert_array_equal(got, jax_wave_scan("gpus_taints", 4))
    np.testing.assert_array_equal(got, port_wave("gpus_taints", 2, 1))


@pytest.mark.parametrize("W", [4, 8, 16])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("name", sorted(WAVE_CASES))
def test_wave_random_clusters_match_scan(name, D, W):
    """GPU cards, taints, every score family, no pipelining and no gang: the
    port's wave cycle at D shards and width W equals the JAX scan path at
    W = 4 (whose decisions are its W = 1 decisions at every width) and the
    port's W = 1 cycle."""
    got = port_wave(name, D, W)
    assert sw.waves > 0
    np.testing.assert_array_equal(got, jax_wave_scan(name, 4))
    np.testing.assert_array_equal(got, port_wave(name, D, 1))


def test_cycle_launches_one_wave_search_a_wave():
    """The wave placer seam: one call a wave, with the mesh's shard count
    and the depth C = min(W, 8), and the one-attempt search never."""
    cfg, snap, extras = sharded_inputs("gang_binpack_raw")
    s, e = port_inputs(snap, extras)
    calls, attempts = [], []

    def watch(cfg, D, C, args):
        calls.append((D, C, args[0].shape[1]))
        return sw.shard_wave(cfg, D, C, args)

    def attempt(cfg, D, args):
        attempts.append(D)
        return sp.shard_candidates(cfg, D, args)
    sw.waves = sw.fast_waves = 0
    sp.pops = 0
    res = tas.make_allocate_cycle(
        port_cfg(cfg, wave_width=16), mesh=NodeMesh((CPU,) * 4),
        shard_placer=attempt, wave_placer=watch)(s, e)
    assert set(calls) == {(4, 8, 16)} and attempts == []
    assert len(calls) == sw.waves >= sp.pops == 32
    np.testing.assert_array_equal(res.packed_decisions().numpy(),
                                  jax_scan_packed("gang_binpack_raw"))


@pytest.mark.filterwarnings(SHARD_MAP_WARNING)
@pytest.mark.parametrize("conf,seed,kw", [
    ("gang_binpack", 3, dict(gpus=True)),
    ("shipped", 5, dict(n_nodes=8, n_jobs=9, gpus=True, taints=True))])
def test_session_wave_matches_jax_session(conf, seed, kw):
    """``sharding: true`` and ``wave_width: 8`` in the conf: the port's
    Session runs the wave walk and gives the JAX Session's outcome."""
    need_jax_devices(2)
    text = ("sharding: true\nwave_width: 8\n"
            + {"gang_binpack": GANG_BINPACK,
               "shipped": shipped_conf_text()}[conf])
    sw.waves = 0
    want, got, ssn = session_pair(
        lambda api: random_cluster(api, seed, **kw), text)
    assert got == want and got[0]
    assert ssn._derived_allocate_inputs()[0].wave_width == 8
    assert sw.waves > 0


@pytest.mark.parametrize("what,item", [
    ("two_devices", "item 6c"),
    ("pod_affinity", "item 6d"),
    ("host_ports", "item 4b"),
    ("telemetry", "item 7"),
])
def test_unported_mesh_configs_name_their_roadmap_item(what, item):
    cfg, snap, extras = sharded_inputs("gang_binpack_raw")
    s, _ = port_inputs(snap, extras)
    pcfg = port_cfg(cfg)
    mesh = NodeMesh((CPU,) * 2)
    if what == "two_devices":
        mesh = NodeMesh((CPU, torch.device("meta")))
    else:
        pcfg = dataclasses.replace(pcfg, **{
            "pod_affinity": dict(enable_pod_affinity=True),
            "host_ports": dict(enable_host_ports=True),
            "telemetry": dict(telemetry=True)}[what])
    with pytest.raises(NotImplementedError, match=item):
        make_sharded_allocate(pcfg, mesh, s)


def test_node_axis_must_split():
    cfg, snap, extras = sharded_inputs("gang_binpack_raw")
    s, _ = port_inputs(snap, extras)
    N = s.nodes.idle.shape[0]
    with pytest.raises(ValueError, match="nodes % mesh devices"):
        make_sharded_allocate(port_cfg(cfg), NodeMesh((CPU,) * (N + 1)), s)


class HostCopies(torch.overrides.TorchFunctionMode):
    """Counts, after the first placer call and outside the placers, the
    calls that copy from the host to the card when the tensors live there:
    an index write by tensor indices of a Python scalar (PyTorch makes the
    scalar a host tensor and copies it over with a blocking copy), and a
    tensor made from host data (``torch.tensor``, ``torch.as_tensor``)."""

    def __init__(self):
        super().__init__()
        self.started = False
        self.copies = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if self.started:
            name = getattr(func, "__name__", "")
            if name == "__setitem__":
                idx = args[1] if isinstance(args[1], tuple) else (args[1],)
                if (any(isinstance(i, torch.Tensor) for i in idx)
                        and not isinstance(args[2], torch.Tensor)):
                    self.copies.append("index write of a Python scalar")
            elif func in (torch.tensor, torch.as_tensor):
                self.copies.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("path", ["static_keys", "dynamic_keys", "sharded",
                                  "sharded_wave"])
def test_rounds_copy_nothing_from_the_host(path):
    """A round of the static-key and the dynamic-key cycle, and a pop of the
    sharded cycle (one attempt a slot, or waves of 4), make no host-to-device
    copy (each would make the host wait for the card; the static-key round
    made one, ``job_popped[jdrop] = True``, before it wrote a tensor)."""
    name = "shipped" if path == "dynamic_keys" else "gang_binpack_raw"
    cfg, snap, extras = sharded_inputs(name)
    s, e = port_inputs(snap, extras)
    mode = HostCopies()
    seen = []

    def first(place):
        # counts start at the first placer call and skip the placers
        # themselves (their plain versions run here on the CPU)
        def wrapped(*a):
            mode.started = False
            out = place(*a)
            mode.started = True
            seen.append(1)
            return out
        return wrapped
    pcfg = port_cfg(cfg)
    if path == "static_keys":
        pcfg = dataclasses.replace(pcfg, batch_jobs=8)
    if path == "sharded_wave":
        pcfg = dataclasses.replace(pcfg, wave_width=4)
    seams = dict(placer=first(rp.round_place),
                 dyn_placer=first(dp.dyn_place),
                 shard_placer=first(sp.shard_candidates),
                 wave_placer=first(sw.shard_wave))
    mesh = NodeMesh((CPU,) * 2) if path.startswith("sharded") else None
    with mode:
        tas.make_allocate_cycle(pcfg, mesh=mesh, **seams)(s, e)
    assert len(seen) > 1
    assert mode.copies == []
