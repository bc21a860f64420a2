"""The port's shard-local launch check and kernel 6 against the JAX
package's sharding family.

The reference's planted fixture (``planted_gather_pallas``) runs under
shard_map on the virtual CPU devices ``tests/conftest.py`` forces, with
shard_map's DeprecationWarning ignored (ROADMAP section 3 (b)). Its
``_pallas_findings`` imports its jaxpr walker from ``jaxpr_audit``, which
does not import under JAX 0.9 (section 3 (c)); the test hands it a walker
of its own for the length of one test, so the reference's own code decides
which keys fire. Tolerance 0.
"""

import sys
import types

import jax
import numpy as np
import pytest
import torch

from torch_fixtures import SHARD_MAP_WARNING, need_jax_devices
from volcano_tpu_torch.analysis import sharding as port_sharding
from volcano_tpu_torch.ops import launch_record

pytestmark = pytest.mark.filterwarnings(SHARD_MAP_WARNING)

SHAPES = [(2, 32, 4), (4, 64, 4), (8, 64, 2)]


def iter_eqns(jaxpr):
    """Every equation of ``jaxpr`` and of the jaxprs in its parameters."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from iter_eqns(inner)


@pytest.fixture
def reference_findings(monkeypatch):
    """The reference's ``_pallas_findings`` with ``iter_eqns`` above in
    place of ``volcano_tpu.analysis.jaxpr_audit``'s."""
    audit = types.ModuleType("volcano_tpu.analysis.jaxpr_audit")
    audit.iter_eqns = iter_eqns
    monkeypatch.setitem(sys.modules, "volcano_tpu.analysis.jaxpr_audit",
                        audit)
    from volcano_tpu.analysis.sharding import _pallas_findings
    return _pallas_findings


def planted(D, n_nodes, cols, seed=0):
    return port_sharding.planted_gather(
        D, n_nodes, cols, device="cpu",
        generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("D,n_nodes,cols", SHAPES)
def test_plain_kernel_6_matches_the_reference_fixture(D, n_nodes, cols):
    """The reference fixture's jaxpr, evaluated on the port's input, gives
    the port's output bit for bit (both ``x * 2``)."""
    need_jax_devices(D)
    from volcano_tpu.analysis.sharding import planted_gather_pallas
    closed, rows_per = planted_gather_pallas(D, n_nodes, cols)
    x, out, records, port_rows = planted(D, n_nodes, cols)
    assert port_rows == rows_per
    want = np.asarray(jax.core.eval_jaxpr(closed.jaxpr, closed.consts,
                                          x.numpy())[0])
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(out.numpy(), x.numpy() * 2)


@pytest.mark.parametrize("D,n_nodes,cols", SHAPES)
def test_planted_launch_fires_with_the_reference_key(D, n_nodes, cols,
                                                     reference_findings):
    need_jax_devices(D)
    from volcano_tpu.analysis.sharding import planted_gather_pallas
    closed, rows_per = planted_gather_pallas(D, n_nodes, cols)
    want = reference_findings(closed, n_nodes, rows_per, "planted")
    _, _, records, _ = planted(D, n_nodes, cols)
    got = port_sharding.pallas_block_findings(records, n_nodes, rows_per,
                                              "planted")
    assert [f.key for f in got] == [f.key for f in want]
    assert [f.key for f in got] == [
        f"sharding:pallas-block:planted:{(n_nodes, cols)}"]
    assert all(f.family == "sharding" and f.where == "planted" for f in got)
    # one launch a shard, each reading the whole axis
    assert len(records) == D
    assert {(r.kernel, r.nl) for r in records} == {("planted_gather",
                                                    rows_per)}
    assert all(b.rows == (0, n_nodes) for r in records for b in r.blocks)


def test_one_shard_has_nothing_to_leak(reference_findings):
    """rows_per >= n_nodes: no finding, in the reference and the port."""
    from volcano_tpu.analysis.sharding import planted_gather_pallas
    closed, ref_rows = planted_gather_pallas(1, 32, 4)
    assert reference_findings(closed, 32, ref_rows, "planted") == []
    _, _, records, rows_per = planted(1, 32, 4)
    assert rows_per == 32 and len(records) == 1
    assert port_sharding.pallas_block_findings(records, 32, rows_per,
                                               "planted") == []


def test_plain_kernel_6_is_x_times_2_and_counts_no_launch():
    x = torch.randn(40, 3, generator=torch.Generator().manual_seed(1))
    before = port_sharding.launches
    assert torch.equal(port_sharding.planted_double(x, 10), x * 2)
    assert port_sharding.launches == before
    with pytest.raises(ValueError):
        port_sharding.planted_double(x.double(), 10)


def test_nothing_is_recorded_outside_a_recording():
    x = torch.zeros(8, 2)
    with launch_record.recording() as outer:
        port_sharding.planted_double(x, 4)
        with launch_record.recording() as inner:
            port_sharding.planted_double(x, 2)
    port_sharding.planted_double(x, 4)
    assert [r.nl for r in outer] == [4, 2]
    assert [r.nl for r in inner] == [2]
    assert not launch_record.active()


#: check H's configuration (binpack 1, neutral extras), at small size
SMALL = (64, 16, 8)


@pytest.fixture(scope="module")
def small_audit():
    """``check_sharding`` on ``NodeMesh(("cpu",) * 4)`` at SMALL: check H's
    configuration (W = 1, kernel 4) and check J's binpack one (W = 4,
    kernel 5)."""
    return port_sharding.check_sharding("cpu", SMALL)


def test_real_sharded_cycles_stay_shard_local(small_audit):
    """Every block reads its own shard's NL rows, so the audit finds
    nothing, over records that are not empty."""
    findings, records = small_audit
    assert findings == []
    n_nodes = 64
    NL = n_nodes // 4
    kernels = {}
    for where, launches in records.items():
        assert launches, where
        for launch in launches:
            kernels[where] = launch.kernel
            assert launch.nl == NL
            shards = sorted({b.rows for b in launch.blocks})
            assert shards == [(d * NL, (d + 1) * NL) for d in range(4)]
            assert all(shape[-1] == NL for b in launch.blocks
                       for shape in b.shapes)
    assert sorted(kernels.values()) == ["shard_candidates", "shard_wave"]
    # the wide search launches a block for each of its 4 columns a shard
    wave = next(v for k, v in records.items() if "W=4" in k)
    assert {len(launch.blocks) for launch in wave} == {16}


def test_a_full_axis_block_in_a_real_record_is_flagged(small_audit):
    """The audit reads the records: the W = 1 cycle's launches with their
    shard blocks widened to the full axis are flagged, once a shape."""
    _, records = small_audit
    where, launches = next((k, v) for k, v in records.items() if "W=1" in k)
    widened = [launch_record.Launch(
        launch.kernel, launch.nl,
        tuple(launch_record.Block(tuple((s[0], 64) for s in b.shapes),
                                  (0, 64)) for b in launch.blocks))
        for launch in launches]
    found = port_sharding.pallas_block_findings(widened, 64, 16, where)
    shapes = sorted({s for b in widened[0].blocks for s in b.shapes})
    assert [f.key for f in found] == [
        f"sharding:pallas-block:{where}:{s}" for s in shapes]


def test_a_shard_handed_the_full_axis_shows_in_the_record():
    """The plain route records the slices each shard's call is given, not
    the shard's NL: shards handed their own rows are silent, shards each
    handed every row (one shard's slices of a one-shard split) fire."""
    from volcano_tpu_torch.ops import shard_placer as sp
    from volcano_tpu_torch.ops.allocate_scan import AllocateConfig
    from volcano_tpu_torch.ops.dyn_cases import make_shard_inputs
    D = 4
    cfg = AllocateConfig(binpack_weight=1.0, enable_gpu=False)
    a = sp.unpack_args(cfg, [torch.from_numpy(x)
                             for x in make_shard_inputs(0, D=D, NL=16)])
    N = a.idle.shape[1]
    own = [sp.shard_args_of(cfg, D, a, d) for d in range(D)]
    full = [sp.shard_args_of(cfg, 1, a, 0)] * D
    with launch_record.recording() as records:
        sp.note_plain_launch("shard_candidates", a, D, own)
        sp.note_plain_launch("shard_candidates", a, D, full)
    assert [b.rows for b in records[0].blocks] == [
        (d * 16, (d + 1) * 16) for d in range(D)]
    assert {b.rows for b in records[1].blocks} == {(0, N)}
    assert port_sharding.pallas_block_findings(records[:1], N, 16, "w") == []
    found = port_sharding.pallas_block_findings(records[1:], N, 16, "w")
    assert [f.key for f in found] == [
        f"sharding:pallas-block:w:{s}" for s in records[1].blocks[0].shapes]
    assert all(s[-1] == N for s in records[1].blocks[0].shapes)
