"""The port's fused transfer and device residency (``ops/fused_io``) against
the JAX package's.

On one small snapshot, shared by the module's tests: the fuse / unfuse
round trip; a delta scatter into the resident buffers equals a full fuse
of the new tree, and its cycle the JAX DeltaKernel's decisions; the
device digest equals the port's and the JAX package's host digest and the
JAX in-graph digest bit for bit, NaNs, negative zeros and bools included;
the changed-rows tail decodes to the full readback; the cycle leaves its
inputs as it found them; and a planted corruption of a resident buffer
trips the digest, after which recovery gives the fresh Session's
decisions.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import volcano_tpu.api as japi
from torch_fixtures import port_cfg, port_inputs, shipped_conf_text
from volcano_tpu.framework import Session as JaxSession
from volcano_tpu.framework import parse_conf as jax_parse_conf
from volcano_tpu.ops import fused_io as jfio
from volcano_tpu.ops.allocate_scan import make_allocate_cycle as jax_cycle
from volcano_tpu_torch.framework import Session, parse_conf
from volcano_tpu_torch.ops import allocate_scan as tas
from volcano_tpu_torch.ops import fused_io as fio
from volcano_tpu_torch.parallel import NodeMesh
from volcano_tpu_torch.synthetic import _synthetic_cluster, steady_churn

GANG_BINPACK = ("actions: allocate\ntiers:\n- plugins:\n  - name: gang\n"
                "  - name: binpack\n")
SHAPE = (16, 12, 4)


@functools.lru_cache(maxsize=None)
def jax_inputs(conf=GANG_BINPACK):
    """(JAX cfg, snapshot, extras) of the module's cluster, as the JAX
    Session derives them."""
    ssn = JaxSession(_synthetic_cluster(*SHAPE, api=japi),
                     jax_parse_conf(conf))
    cfg, extras = ssn._derived_allocate_inputs()
    return cfg, ssn.snap, extras


def tree(conf=GANG_BINPACK):
    cfg, snap, extras = jax_inputs(conf)
    s, e = port_inputs(snap, extras)
    return port_cfg(cfg), (to_numpy(s), to_numpy(e))


def to_numpy(t):
    if dataclasses.is_dataclass(t):
        return dataclasses.replace(t, **{
            f.name: to_numpy(getattr(t, f.name))
            for f in dataclasses.fields(t)})
    return t.numpy().copy()


def test_fuse_unfuse_round_trip():
    """Every leaf comes back with its shape, dtype and bits, through
    torch buffers (views) and through numpy; the JAX round trip of the
    same snapshot gives the same arrays."""
    _, t = tree()
    treedef, spec = fio.fuse_spec(t)
    bufs = fio.fuse_into(t, spec, fio.group_sizes(spec))
    dev = [torch.from_numpy(b) for b in bufs]
    back = fio.make_unfuse(treedef, spec)(*dev)
    for a, b in zip(fio.tree_leaves(t), fio.tree_leaves(back)):
        assert b.shape == a.shape and b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)
        if a.size:
            # a view into its group buffer, not a copy
            assert any(b.untyped_storage().data_ptr()
                       == d.untyped_storage().data_ptr() for d in dev)
    host = fio.make_unfuse(treedef, spec)(*bufs)
    for a, b in zip(fio.tree_leaves(t), fio.tree_leaves(host)):
        np.testing.assert_array_equal(a, b)
    _, jsnap, jextras = jax_inputs()
    jt = (jsnap, jextras)
    jdef, jspec = jfio.fuse_spec(jt)
    jback = jfio.make_unfuse(jdef, jspec)(*map(jnp.asarray, jfio.fuse(jt)))
    assert sum(fio.group_sizes(spec)) == sum(jfio.group_sizes(jspec))
    for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def churned(t, seed):
    """``t`` with some node, task and job rows changed, as a cycle's
    refresh changes them."""
    snap, extras = t
    rng = np.random.RandomState(seed)
    nodes = dataclasses.replace(snap.nodes, idle=snap.nodes.idle.copy())
    nodes.idle[rng.randint(nodes.idle.shape[0], size=3)] *= 0.5
    jobs = dataclasses.replace(snap.jobs, valid=snap.jobs.valid.copy())
    jobs.valid[rng.randint(jobs.valid.shape[0])] = False
    return (dataclasses.replace(snap, nodes=nodes, jobs=jobs), extras)


@functools.lru_cache(maxsize=None)
def jax_delta_decisions():
    """The JAX DeltaKernel's packed decisions over the module's tree and
    its churned successor (the scan path, full then delta)."""
    cfg, jsnap, jextras = jax_inputs()
    cycle = jax_cycle(dataclasses.replace(cfg, use_pallas=False))
    jt = (jsnap, jextras)
    kern = jfio.DeltaKernel(cycle, jt)
    state = jfio.ResidentState()
    out = []
    for tr in (jt, churned(jt, 0)):
        packed = np.asarray(kern.run(state, tr))
        out.append((state.last_kind, kern.split_digest(packed)[0]))
    return out


def test_delta_scatter_equals_a_full_fuse():
    """Full, then a delta: the resident buffers equal a fresh fuse of the
    new tree bit for bit, only the changed elements ship, and both
    cycles give the JAX DeltaKernel's decisions."""
    cfg, t = tree()
    kern = fio.DeltaKernel(tas.make_allocate_cycle(cfg), t, "cpu")
    state = fio.ResidentState()
    want = jax_delta_decisions()
    for k, tr in enumerate((t, churned(t, 0))):
        packed = kern.run(state, tr).numpy()
        dec, dig = kern.split_digest(packed)
        kind, jdec = want[k]
        assert state.last_kind == kind == ("full", "delta")[k]
        np.testing.assert_array_equal(dec, jdec)
        _, spec = fio.fuse_spec(tr)
        fresh = fio.fuse_into(tr, spec, fio.group_sizes(spec))
        for d, f in zip(state.device, fresh):
            np.testing.assert_array_equal(d.numpy().view(np.uint8),
                                          f.view(np.uint8))
        np.testing.assert_array_equal(dig, fio.host_digest(fresh))
    assert 0 < state.last_upload_bytes < state.full_upload_bytes


def digest_cases():
    rng = np.random.RandomState(7)
    f = rng.randn(1000).astype(np.float32) * 1e30
    f[[3, 50, 999]] = [np.nan, -0.0, 0.0]
    f[100] = np.float32(-np.nan)
    i = rng.randint(-2 ** 31, 2 ** 31 - 1, 777).astype(np.int32)
    b = rng.rand(333) < 0.5
    yield "mixed", (f, i, b)
    yield "empty", (np.zeros(0, np.float32), i[:1], np.zeros(0, bool))
    yield "signed_zero", (np.array([-0.0, 0.0, -0.0], np.float32),
                          np.array([-1, 0, 2 ** 31 - 1], np.int32),
                          np.array([True, False, True]))


@pytest.mark.parametrize("name,bufs", list(digest_cases()),
                         ids=[n for n, _ in digest_cases()])
def test_device_digest_equals_host_and_jax_digests(name, bufs):
    host = fio.host_digest(bufs)
    dev = fio.device_digest([torch.from_numpy(b) for b in bufs])
    assert dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), host)
    np.testing.assert_array_equal(host, jfio.host_digest(bufs))
    jd = np.asarray(jfio._device_digest(*map(jnp.asarray, bufs)))
    np.testing.assert_array_equal(dev.numpy(), jd)
    # a word whose bits differ, here the sign of a zero at an odd weight,
    # digests apart
    if name == "signed_zero":
        flipped = bufs[0].copy()
        flipped[0] = -flipped[0]
        other = fio.host_digest((flipped,) + bufs[1:])
        assert other[0] != host[0]
        np.testing.assert_array_equal(
            fio.device_digest([torch.from_numpy(b) for b in
                               (flipped,) + bufs[1:]]).numpy().view(
                np.uint32), other)


CYCLE_PATHS = {
    "round": (GANG_BINPACK, None),
    "dyn": (None, None),
    "dyn_mesh": (None, "route"),
    "mesh": (GANG_BINPACK, "mesh"),
}


@pytest.mark.parametrize("path", sorted(CYCLE_PATHS))
def test_the_cycle_leaves_its_inputs_as_it_found_them(path, monkeypatch):
    """The resident buffers' digest before and after a cycle run on their
    views is the same, on every path the cycle takes (the mesh path adds
    into its copy of the idle rows in place)."""
    conf, how = CYCLE_PATHS[path]
    cfg, t = tree(conf or shipped_conf_text())
    mesh = None
    if how == "route":
        from volcano_tpu_torch.ops import dyn_placer as dp
        monkeypatch.setattr(dp, "MAX_SHARED", 0)
    elif how == "mesh":
        mesh = NodeMesh((torch.device("cpu"),))
    assert tas.cycle_path(cfg, *t, mesh) == path
    treedef, spec = fio.fuse_spec(t)
    bufs = [torch.from_numpy(b.copy()) for b in
            fio.fuse_into(t, spec, fio.group_sizes(spec))]
    before = fio.device_digest(bufs)
    res = tas.make_allocate_cycle(cfg, mesh=mesh)(
        *fio.make_unfuse(treedef, spec)(*bufs))
    assert (res.task_mode > 0).any()
    assert torch.equal(fio.device_digest(bufs), before)


def churn_session(conf=GANG_BINPACK, cycles=3):
    """A port Session on the module's cluster and its churn cycles."""
    ci = _synthetic_cluster(*SHAPE)
    ssn = Session(ci, parse_conf(conf), device="cpu")
    ssn.run_allocate()
    rng = np.random.RandomState(1)
    for _ in range(cycles):
        jobs, nodes = steady_churn(ci, rng, 0.25)
        for uid in jobs:
            ssn.mark_dirty(job_uid=uid)
        for name in nodes:
            ssn.mark_dirty(node_name=name)
        assert ssn.reopen(now=ssn.now)
        yield ci, ssn


def test_changed_rows_tail_decodes_to_the_full_readback():
    """The tail [digest | count | rows | values] patched into the last
    drained decisions gives the full packed readback, cycle after cycle."""
    tails = 0
    for _ci, ssn in churn_session():
        pending = ssn.dispatch_allocate()
        kern, state = pending.kernel, pending.state
        assert kern.rb_cap and pending.tail is not None
        full, dig = kern.split_digest(pending.packed.numpy())
        tdig, cnt, idx, vals = kern.split_tail(pending.tail.numpy())
        np.testing.assert_array_equal(tdig, dig)
        assert cnt == int((full != state.dec_mirror).sum())
        if cnt <= kern.rb_cap:
            patched = state.dec_mirror.copy()
            patched[idx] = vals
            np.testing.assert_array_equal(patched, full)
            tails += 1
        res = ssn.complete_allocate(pending)
        np.testing.assert_array_equal(res.task_node, full[:pending.T])
    assert tails >= 2


def test_planted_corruption_trips_the_digest_and_recovers():
    """A resident element the next delta does not touch is corrupted
    between cycles: the digest trips at the drain, the cycle re-runs from
    a full upload, and its decisions are a fresh Session's."""
    for ci, ssn in churn_session(cycles=1):
        state = next(iter(ssn._resident.values()))
        fresh = Session(ci.clone(), parse_conf(GANG_BINPACK), device="cpu")
        fresh.run_allocate()
        # node 0's allocatable cpu, which no delta touches
        t = (ssn.snap, ssn._derived_allocate_inputs()[1])
        _, spec = fio.fuse_spec(t)
        k = [i for i, x in enumerate(fio.tree_leaves(t))
             if x is ssn.snap.nodes.allocatable][0]
        group, off = spec[k][:2]
        assert group == "f"
        state.device[0][off + ssn.maps.resource_names.index("cpu")] += 1e3
        ssn.run_allocate()
        assert ssn.stats["recoveries"] == 1
        assert ssn.stats["recovery_reason"] == "digest"
        assert state.last_kind == "recovery"
        np.testing.assert_array_equal(ssn.last_allocate.task_node,
                                      fresh.last_allocate.task_node)
        np.testing.assert_array_equal(ssn.last_allocate.task_mode,
                                      fresh.last_allocate.task_mode)
