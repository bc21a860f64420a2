"""The CUDA kernels against their plain PyTorch versions, on the card: the
round placer (with and without its pod-affinity step), the pod-affinity
step in the dynamic-key placer, the segmented sum, the shard-local
candidate search and its wide (wavefront) form, and kernel 6 (graphcheck's
planted shard gather); the sharded cycle's waits on the card, with and
without waves; and sort_order, enqueue and backfill on the card against
the CPU.

Imports nothing of JAX, so it runs on a machine with a card and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Where there is no card every test skips (decided inside the test).
"""

import dataclasses

import pytest
import torch

from torch_fixtures import (AFF_CASES, CASES, PLACER_WEIGHTS,
                            aff_placer_knobs, make_dyn_inputs, make_inputs)
from volcano_tpu_torch.ops import dyn_placer as dp
from volcano_tpu_torch.ops import round_placer as rp
from volcano_tpu_torch.ops import shard_placer as sp
from volcano_tpu_torch.ops import shard_wave as sw
from volcano_tpu_torch.ops.dyn_cases import (SHARD_CASES, WAVE_CASES,
                                             make_shard_inputs,
                                             make_wave_inputs)
from volcano_tpu_torch.ops.allocate_scan import (AllocateConfig,
                                                 wave_candidate_depth)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_bitwise(case, seed):
    need_card()
    kw = dict(CASES[case])
    K, M = kw.get("K", 8), kw.get("M", 4)
    cfg = AllocateConfig(enable_gpu=kw["gpu"], **PLACER_WEIGHTS)
    t = [torch.from_numpy(a).cuda() for a in make_inputs(seed, **kw)]
    want = rp.round_place_plain(cfg, K, M, t)
    before = rp.launches
    got = rp.round_place(cfg, K, M, t)
    torch.cuda.synchronize()
    assert rp.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_kernel_rejects_wrong_layout():
    need_card()
    cfg = AllocateConfig(enable_gpu=False, **PLACER_WEIGHTS)
    t = [torch.from_numpy(a).cuda() for a in make_inputs(2, gpu=False)]
    t[-3] = t[-3].T.contiguous().T          # idle, transposed layout
    with pytest.raises(ValueError, match="contiguous"):
        rp.round_place_cuda(cfg, 8, 4, t)


# ---- the pod-affinity step in both placers (kernel 2) -----------------------

def assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("gpu", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(AFF_CASES))
def test_round_affinity_kernel_matches_plain_bitwise(case, seed, gpu):
    need_card()
    cfg = AllocateConfig(enable_gpu=gpu, enable_pod_affinity=True,
                         pod_affinity_weight=1.5, **PLACER_WEIGHTS)
    t = [torch.from_numpy(a).cuda() for a in make_inputs(
        seed, gpu=gpu, aff=AFF_CASES[case], **aff_placer_knobs(case))]
    want = rp.round_place_plain(cfg, 8, 4, t)
    before = (rp.launches, rp.aff_launches)
    got = rp.round_place(cfg, 8, 4, t)
    torch.cuda.synchronize()
    assert (rp.launches, rp.aff_launches) == (before[0] + 1, before[1] + 1)
    assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(AFF_CASES))
def test_dyn_affinity_kernel_matches_plain_bitwise(case, seed):
    need_card()
    flags, args = make_dyn_inputs(seed, drf_job_order=True,
                                  aff=AFF_CASES[case],
                                  **aff_placer_knobs(case))
    cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
    t = [torch.from_numpy(a).cuda() for a in args]
    want = dp.dyn_place_plain(cfg, 4, 12, 4, t)
    before = dp.aff_launches
    got = dp.dyn_place(cfg, 4, 12, 4, t)
    torch.cuda.synchronize()
    assert dp.aff_launches == before + 1
    assert_same(got, want)


@pytest.mark.cuda
def test_kernels_reject_wrong_affinity_layout():
    """The launchers refuse affinity arguments of the wrong layout, shape
    or type before anything is launched."""
    need_card()
    cfg = AllocateConfig(enable_gpu=False, enable_pod_affinity=True,
                         **PLACER_WEIGHTS)
    t = [torch.from_numpy(a).cuda() for a in make_inputs(
        2, gpu=False, aff=AFF_CASES["mixed"])]
    a = rp.unpack_args(cfg, t)
    before = rp.launches
    for bad, match in ((a._replace(aff_cnt=a.aff_cnt.T.contiguous().T),
                        "contiguous"),
                       (a._replace(skdom=a.skdom.to(torch.float32)),
                        "skdom"),
                       (a._replace(prefw=a.prefw[:, :-1].contiguous()),
                        "prefw")):
        with pytest.raises(ValueError, match=match):
            rp.round_place_cuda(cfg, 8, 4, [x for x in bad if x is not None])
    flags, args = make_dyn_inputs(2, drf_job_order=True,
                                  aff=AFF_CASES["mixed"])
    dcfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
    d = dp.unpack_args(dcfg, [torch.from_numpy(x).cuda() for x in args])
    bad = d._replace(anti_cnt=d.anti_cnt.T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        dp.dyn_place_cuda(dcfg, 4, 12, 4, [x for x in bad if x is not None])
    assert rp.launches == before


# ---- the segmented sum in row order (ops/seg_fold.py) ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("A,D,num", [(4096, 2, 4), (5000, 2, 5000),
                                     (100, 1, 1), (0, 2, 3), (7, 3, 0)])
def test_seg_fold_kernel_matches_plain_bitwise(A, D, num):
    need_card()
    from volcano_tpu_torch.ops import seg_fold as sf
    g = torch.Generator().manual_seed(A + num)
    vals = (torch.randn((A, D), generator=g)
            * 10.0 ** torch.randint(-3, 8, (A, D), generator=g)).float()
    seg = torch.randint(-1, num + 1, (A,), generator=g, dtype=torch.int32)
    vals, seg = vals.cuda(), seg.cuda()
    want = sf.seg_fold_plain(vals, seg, num)
    before = sf.launches
    got = sf.seg_fold(vals, seg, num)
    torch.cuda.synchronize()
    assert sf.launches == before + 1
    assert got.shape == want.shape == (num, D)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_fair_shares_on_the_card_match_the_cpu():
    """namespace_shares and the hdrf level keys run on the card (no copy to
    the host) and give the CPU's bits."""
    need_card()
    import numpy as np

    from volcano_tpu_torch.arrays import to_device
    from volcano_tpu_torch.arrays.hierarchy import build_from_specs
    from volcano_tpu_torch.ops import fairshare as tfs
    from volcano_tpu_torch.ops import seg_fold as sf
    rng = np.random.RandomState(0)
    J, S, Q = 4096, 3, 4
    alloc = (rng.rand(J, 2) * 10.0 ** rng.randint(0, 9, (J, 2))).astype(
        np.float32)
    ns = rng.randint(0, S, J).astype(np.int32)
    valid = rng.rand(J) < 0.9
    weight = np.array([1.0, 2.0, 3.0], np.float32)
    total = np.array([1e9, 1e12], np.float32)
    cpu = [torch.from_numpy(x) for x in (alloc, ns, valid, weight, total)]
    card = [x.cuda() for x in cpu]
    before = sf.launches
    got = tfs.namespace_shares(*card)
    assert sf.launches == before + 1
    assert torch.equal(got.cpu(), tfs.namespace_shares(*cpu))

    specs = [("root/sci", "100/50"), ("root/eng/dev", "100/50/50"),
             ("root/eng/prod", "100/50/50"), ("", "")]
    job_queue = rng.randint(0, 3, J).astype(np.int32)
    hier = build_from_specs(specs, Q, job_queue, rng.rand(J) < 0.9)
    request = alloc + (rng.rand(J, 2) * 1e6).astype(np.float32)
    args = [torch.from_numpy(request), cpu[2], cpu[4]]
    want = tfs.hdrf_level_keys(hier, cpu[0], *args)
    got = tfs.hdrf_level_keys(to_device(hier, "cuda"), card[0],
                              *[x.cuda() for x in args])
    assert got.is_cuda
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


# ---- the shard-local candidate search (kernel 4) -----------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("gpu", [False, True])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_shard_kernel_matches_plain_bitwise(case, D, gpu):
    need_card()
    cfg = AllocateConfig(enable_gpu=gpu, **PLACER_WEIGHTS)
    for seed in (0, 1):
        t = [torch.from_numpy(a).cuda() for a in
             make_shard_inputs(seed, D=D, gpu=gpu, **SHARD_CASES[case])]
        want = sp.shard_candidates_plain_all(cfg, D, t)
        before = sp.launches
        got = sp.shard_candidates(cfg, D, t)
        torch.cuda.synchronize()
        assert sp.launches == before + 1
        assert_same(got, want)


@pytest.mark.cuda
def test_shard_kernel_at_full_width():
    """One shard of 10,240 rows and four of 2,560 (the north star's
    shapes): more rows than threads in a block."""
    need_card()
    cfg = AllocateConfig(enable_gpu=False, binpack_weight=1.0)
    for D, NL in ((1, 10240), (4, 2560)):
        t = [torch.from_numpy(a).cuda() for a in
             make_shard_inputs(3, D=D, NL=NL, ties=True)]
        assert_same(sp.shard_candidates(cfg, D, t),
                    sp.shard_candidates_plain_all(cfg, D, t))


@pytest.mark.cuda
def test_shard_kernel_rejects_wrong_layout():
    need_card()
    cfg = AllocateConfig(enable_gpu=False, **PLACER_WEIGHTS)
    t = [torch.from_numpy(a).cuda() for a in make_shard_inputs(0, D=2)]
    t[-3] = t[-3].T.contiguous().T          # idle, transposed layout
    with pytest.raises(ValueError, match="contiguous"):
        sp.shard_candidates_cuda(cfg, 2, t)
    t = [torch.from_numpy(a).cuda() for a in make_shard_inputs(0, D=2)]
    with pytest.raises(ValueError, match="do not split"):
        sp.shard_candidates_cuda(cfg, 5, t)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_path", [False, True])
def test_cycle_copies_nothing_to_the_card_and_waits_once_a_round(mesh_path):
    """On the card, the static-key cycle's rounds and the sharded cycle's
    pops make no host-to-device copy, and the host waits for the card
    once a round or pop (the readback), beside a few waits of the
    cycle's set-up."""
    need_card()
    from torch.profiler import ProfilerActivity, profile

    from volcano_tpu_torch.arrays import pack, to_device
    from volcano_tpu_torch.ops.allocate_scan import (AllocateExtras,
                                                     derive_batching,
                                                     make_allocate_cycle)
    from volcano_tpu_torch.parallel import NodeMesh
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    snap, _ = pack(_synthetic_cluster(512, 48, 8))
    s = to_device(snap, "cuda")
    e = to_device(AllocateExtras.neutral(snap), "cuda")
    cfg = AllocateConfig(binpack_weight=1.0, enable_gpu=False)
    if mesh_path:
        cycle = make_allocate_cycle(cfg, mesh=NodeMesh(("cuda",) * 2))
    else:
        cycle = make_allocate_cycle(derive_batching(cfg,
                                                    has_proportion=False))
    cycle(s, e).packed_decisions().cpu()
    rp.launches = sp.pops = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cycle(s, e).packed_decisions().cpu()
    rounds = sp.pops if mesh_path else rp.launches
    htod = [ev for ev in prof.events() if "HtoD" in ev.name]
    syncs = [ev for ev in prof.events()
             if ev.name == "cudaStreamSynchronize"]
    assert rounds > 4
    assert htod == []
    assert rounds <= len(syncs) <= rounds + 8


# ---- the wide shard-local candidate search (kernel 5) -----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("gpu", [False, True])
@pytest.mark.parametrize("W", [1, 4, 8, 16])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(WAVE_CASES))
def test_wave_kernel_matches_plain_bitwise(case, D, W, gpu):
    need_card()
    cfg = AllocateConfig(enable_gpu=gpu, **PLACER_WEIGHTS)
    C = wave_candidate_depth(W)
    t = [torch.from_numpy(a).cuda() for a in
         make_wave_inputs(0, D=D, W=W, gpu=gpu, **WAVE_CASES[case])]
    want = sw.shard_wave_plain_all(cfg, D, C, t)
    before = sw.launches
    got = sw.shard_wave(cfg, D, C, t)
    torch.cuda.synchronize()
    assert sw.launches == before + 1
    assert_same(got, want)


@pytest.mark.cuda
def test_wave_kernel_at_full_width():
    """One shard of 10,240 rows and four of 2,560 (the north star's
    shapes), 8 columns: more rows than threads in a block."""
    need_card()
    cfg = AllocateConfig(enable_gpu=False, least_allocated_weight=1.0,
                         balanced_weight=1.0)
    for D, NL in ((1, 10240), (4, 2560)):
        t = [torch.from_numpy(a).cuda() for a in
             make_wave_inputs(3, D=D, W=8, NL=NL, ties=True)]
        assert_same(sw.shard_wave(cfg, D, 8, t),
                    sw.shard_wave_plain_all(cfg, D, 8, t))


@pytest.mark.cuda
def test_wave_kernel_rejects_wrong_layout():
    need_card()
    cfg = AllocateConfig(enable_gpu=False, **PLACER_WEIGHTS)
    t = [torch.from_numpy(a).cuda() for a in make_wave_inputs(0, D=2, W=4)]
    t[-3] = t[-3].T.contiguous().T          # idle, transposed layout
    with pytest.raises(ValueError, match="contiguous"):
        sw.shard_wave_cuda(cfg, 2, 4, t)
    t = [torch.from_numpy(a).cuda() for a in make_wave_inputs(0, D=2, W=4)]
    with pytest.raises(ValueError, match="depth"):
        sw.shard_wave_cuda(cfg, 2, 9, t)


@pytest.mark.cuda
def test_wave_cycle_on_the_card():
    """The wave cycle on 4 virtual shards of the card: the kernel cycle and
    the plain cycle give the W = 1 cycle's decisions, with one kernel-5
    launch a wave and no kernel-4 launch; no host-to-device copy, and the
    host waits for the card once a pop, once a batched wave and once a
    slot of the in-order walk, at most W a wave."""
    need_card()
    from torch.profiler import ProfilerActivity, profile

    from volcano_tpu_torch.arrays import pack, to_device
    from volcano_tpu_torch.ops.allocate_scan import (AllocateExtras,
                                                     make_allocate_cycle)
    from volcano_tpu_torch.parallel import NodeMesh
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    snap, _ = pack(_synthetic_cluster(512, 48, 8))
    s = to_device(snap, "cuda")
    e = to_device(AllocateExtras.neutral(snap), "cuda")
    cfg = AllocateConfig(binpack_weight=0.0, enable_gpu=False)
    mesh = NodeMesh(("cuda",) * 4)
    seq = make_allocate_cycle(cfg, mesh=mesh)(s, e).packed_decisions().cpu()
    wide = dataclasses.replace(cfg, wave_width=8)
    cycle = make_allocate_cycle(wide, mesh=mesh)
    sw.launches = sw.waves = sw.fast_waves = sp.launches = sp.pops = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = cycle(s, e).packed_decisions().cpu()
    assert torch.equal(got, seq)
    assert sw.launches == sw.waves > 0 and sp.launches == 0
    htod = [ev for ev in prof.events() if "HtoD" in ev.name]
    syncs = [ev for ev in prof.events()
             if ev.name == "cudaStreamSynchronize"]
    low = sp.pops + sw.waves
    assert htod == []
    assert low <= len(syncs) <= low + (sw.waves - sw.fast_waves) * 7 + 8
    plain = make_allocate_cycle(wide, mesh=mesh,
                                wave_placer=sw.shard_wave_plain_all)
    assert torch.equal(plain(s, e).packed_decisions().cpu(), seq)


@pytest.mark.cuda
def test_mesh_over_the_cards():
    """scheduler_mesh and mesh_for_nodes take the visible cards; one card
    gives one shard."""
    need_card()
    from volcano_tpu_torch.parallel import mesh_for_nodes, scheduler_mesh
    n = torch.cuda.device_count()
    assert scheduler_mesh().size == n
    assert mesh_for_nodes(10240, 1).devices == (torch.device("cuda", 0),)


# --------------------------------------------------------------------------
# kernel 6 (graphcheck's planted shard gather), sort_order, and the
# enqueue and backfill passes on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 4), (10240, 4), (1000, 3), (1, 1)])
def test_planted_kernel_matches_plain_bitwise(shape):
    need_card()
    from volcano_tpu_torch.analysis import sharding as gs
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    x[0, 0] = float("inf")
    x = x.cuda()
    before = gs.launches
    got = gs.planted_double(x, shape[0])
    torch.cuda.synchronize()
    assert gs.launches == before + 1
    want = gs.planted_double_plain(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError):
        gs.planted_double_cuda(x.double())
    with pytest.raises(ValueError):
        gs.planted_double_cuda(torch.zeros(4, 3, device="cuda").t())


@pytest.mark.cuda
@pytest.mark.parametrize("D,n_nodes,cols", [(2, 32, 4), (4, 10240, 4)])
def test_planted_fixture_on_the_card(D, n_nodes, cols):
    need_card()
    from volcano_tpu_torch.analysis import sharding as gs
    before = gs.launches
    x, out, records, rows_per = gs.planted_gather(
        D, n_nodes, cols, "cuda", torch.Generator().manual_seed(D))
    torch.cuda.synchronize()
    assert gs.launches == before + D
    assert torch.equal(out.view(torch.int32), (x * 2).view(torch.int32))
    keys = [f.key for f in gs.pallas_block_findings(records, n_nodes,
                                                    rows_per, "planted")]
    assert keys == [f"sharding:pallas-block:planted:{(n_nodes, cols)}"]


@pytest.mark.cuda
def test_sharded_cycles_on_the_card_stay_shard_local():
    need_card()
    from volcano_tpu_torch.analysis import sharding as gs
    findings, records = gs.check_sharding("cuda", (256, 64, 8))
    assert findings == []
    assert len(records) == 2 and all(records.values())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_sort_order_on_the_card_matches_the_cpu(seed):
    need_card()
    import numpy as np

    from volcano_tpu_torch.ops.select import sort_order
    rng = np.random.RandomState(seed)
    n = 5000
    keys = [torch.from_numpy(rng.randint(0, 3, n).astype("float32")),
            torch.from_numpy(-rng.randint(0, 2, n).astype("float32")),
            torch.from_numpy(rng.randint(0, 40, n).astype("int32"))]
    mask = torch.from_numpy(rng.rand(n) < 0.8)
    want = sort_order(keys, mask)
    got = sort_order([k.cuda() for k in keys], mask.cuda())
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("conf", ["shipped", "check_k"])
def test_actions_on_the_card_match_the_cpu(conf):
    """enqueue, allocate and backfill through a Session on the card and on
    the CPU: the same admitted mask, decisions and backfill."""
    need_card()
    import numpy as np

    import chip_smoke
    from volcano_tpu_torch.actions import get_action
    from volcano_tpu_torch.framework import Session
    from volcano_tpu_torch.synthetic import admission_scenario
    make = {"shipped": chip_smoke.shipped_conf,
            "check_k": chip_smoke.check_k_conf}[conf]
    out = {}
    for device in ("cpu", "cuda"):
        ssn = Session(admission_scenario(64, 96, 16, 64), make(),
                      now=4149.0, device=device)
        for name in ssn.conf.actions:
            get_action(name).execute(ssn)
        out[device] = (ssn.last_enqueue, ssn.last_allocate.task_node,
                       ssn.last_allocate.task_mode, *ssn.last_backfill)
    for a, b in zip(out["cpu"], out["cuda"]):
        np.testing.assert_array_equal(a, b)
    assert out["cuda"][0].any() and out["cuda"][4].any()
