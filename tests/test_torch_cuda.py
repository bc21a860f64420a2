"""The CUDA kernels against their plain PyTorch versions, on the card: the
round placer (with and without its pod-affinity step, as clusters of 8 and
16 blocks), the dynamic-key placer as clusters of 8 and 16 blocks (with
and without its pod-affinity step, up to the most jobs its shared memory
takes), the segmented
sum (past one shared-memory tile and past the grid's warps, with -0.0,
NaN and infinities planted), the shard-local candidate search (per-shard
outputs and the combined triple, at every block shape of its grid) and its
wide (wavefront) form (per-shard lists and the combined lists, with a
short last block and ties across blocks, launches of other shapes in a
row), and kernel 6
(graphcheck's planted shard gather); the sharded cycle's waits on the
card, with and without waves, and the wave cycle without a ``combine``;
and sort_order, enqueue and backfill on the card against the CPU.

Imports nothing of JAX, so it runs on a machine with a card and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Where there is no card every test skips (decided inside the test).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from torch_fixtures import (AFF_CASES, CASES, DYN_CASES, PLACER_WEIGHTS,
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


def assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


# ---- kernel 1 as a thread-block cluster --------------------------------------

#: round placer inputs for the cluster: a ragged last slice (N = 200 is 13
#: nodes a block at 16 blocks, the last 5), fewer nodes than blocks, the
#: best score planted in every block's slice, gangs discarded after
#: placements in several blocks, GPU cards
CLUSTER_CASES = {
    "ragged_last_slice": dict(gpu=True, N=200, M=6),
    "fewer_nodes_than_blocks": dict(gpu=True, N=5),
    "ties_across_slices": dict(gpu=False, N=96, ties=True),
    "gang_discard": dict(gpu=True, tight=True, big_gangs=True),
    "gpu_cards": dict(gpu=True, N=300),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_cluster_kernel_matches_plain_bitwise(case, cb):
    need_card()
    kw = dict(CLUSTER_CASES[case])
    K, M = kw.get("K", 8), kw.get("M", 4)
    cfg = AllocateConfig(enable_gpu=kw["gpu"], **PLACER_WEIGHTS)
    for seed in (0, 1, 2):
        t = [torch.from_numpy(a).cuda() for a in make_inputs(seed, **kw)]
        want = rp.round_place_plain(cfg, K, M, t)
        before = rp.launches
        got = rp.round_place_cuda(cfg, K, M, t, cb=cb)
        torch.cuda.synchronize()
        assert rp.launches == before + 1
        assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("case", sorted(AFF_CASES))
def test_cluster_affinity_kernel_matches_plain_bitwise(case, cb):
    """The affinity step's second exchange, the totals' replicas and the
    take-back of a discarded gang's rows, block by block."""
    need_card()
    cfg = AllocateConfig(enable_gpu=True, enable_pod_affinity=True,
                         pod_affinity_weight=1.5, **PLACER_WEIGHTS)
    for seed in (0, 1):
        t = [torch.from_numpy(a).cuda() for a in make_inputs(
            seed, gpu=True, N=200, aff=AFF_CASES[case],
            **aff_placer_knobs(case))]
        want = rp.round_place_plain(cfg, 8, 4, t)
        got = rp.round_place_cuda(cfg, 8, 4, t, cb=cb)
        torch.cuda.synchronize()
        assert_same(got, want)


@pytest.mark.cuda
def test_cluster_launch_refuses_what_it_cannot_run():
    """No fallback: a cluster past 16 blocks, or more shared memory a
    block than the card has, raises before anything is launched."""
    need_card()
    cfg = AllocateConfig(enable_gpu=False, **PLACER_WEIGHTS)
    t = [torch.from_numpy(a).cuda() for a in make_inputs(0, gpu=False)]
    before = rp.launches
    with pytest.raises(ValueError, match="clusters"):
        rp.round_place_cuda(cfg, 8, 4, t, cb=17)
    t = [torch.from_numpy(a).cuda() for a in make_inputs(
        0, gpu=False, N=rp.MAX_SHARED)]
    with pytest.raises(ValueError, match="shared memory"):
        rp.round_place_cuda(cfg, 8, 4, t, cb=1)
    assert rp.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("cb", [1, 8, 16])
def test_exchange_probe_merges_every_block(cb):
    """The exchange alone: after the last of 37 exchanges block 0 holds
    the lowest rank at the highest score the blocks wrote."""
    need_card()
    iters = 37
    scores = [(r * 7 + iters - 1) % 5 for r in range(cb)]
    out = rp.exchange_probe_cuda(cb, iters, "cuda")
    assert int(out) == scores.index(max(scores))


# ---- the pod-affinity step in both placers (kernel 2) -----------------------


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


# ---- kernel 3 as a thread-block cluster --------------------------------------

#: dynamic-key placer inputs for the cluster, beside every DYN_CASE and
#: AFF_CASE: a ragged last job slice (J = 1000 is 63 jobs a block at 16
#: blocks, the last 55; 200 nodes, 13 a block, the last 5) under the drf
#: namespace fold over 3 namespaces; more jobs a block than threads (the
#: fold's compaction and the eligibility bitmask in several rounds); the
#: hdrf guard and the sla deadline key over slices; a gang discarded with
#: pod affinity
DYN_CLUSTER_CASES = {
    "ragged_last_slice": dict(drf_job_order=True, drf_ns_order=True, S=3,
                              J=1000, N=200),
    "jobs_past_the_threads": dict(drf_job_order=True, drf_ns_order=True,
                                  S=3, J=10000, N=200),
    "hdrf_guard": dict(DYN_CASES["hdrf_guard"], J=300, N=200),
    "sla_deadline": dict(DYN_CASES["sla_deadline"], J=300, N=200),
    "gang_discard_affinity": dict(drf_job_order=True, tight=True, N=200,
                                  aff=AFF_CASES["gang_discard"],
                                  **aff_placer_knobs("gang_discard")),
}


def dyn_cluster_inputs(case):
    if case in DYN_CLUSTER_CASES:
        return DYN_CLUSTER_CASES[case]
    if case in DYN_CASES:
        return DYN_CASES[case]
    aff = case[len("aff_"):]
    return dict(drf_job_order=True, aff=AFF_CASES[aff],
                **aff_placer_knobs(aff))


def check_dyn_cluster(cfg, t, cb):
    want = dp.dyn_place_plain(cfg, 4, 12, 4, t)
    before = dp.launches
    got = dp.dyn_place_cuda(cfg, 4, 12, 4, t, cb=cb)
    torch.cuda.synchronize()
    assert dp.launches == before + 1
    assert_same(got, want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("case", sorted(DYN_CASES) + sorted(DYN_CLUSTER_CASES)
                         + [f"aff_{c}" for c in sorted(AFF_CASES)])
def test_dyn_cluster_kernel_matches_plain_bitwise(case, cb):
    need_card()
    pops = []
    for seed in (0, 1, 2):
        flags, args = make_dyn_inputs(seed, **dyn_cluster_inputs(case))
        cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
        want = check_dyn_cluster(cfg, [torch.from_numpy(a).cuda()
                                       for a in args], cb)
        pops.append(int(want[-2][0, 0]))
    assert max(pops) >= 1, pops


def dyn_max_jobs(cfg, t, cb):
    """The wrapper's job limit at the shapes of the launch ``t``."""
    a = dp.unpack_args(cfg, t)
    R, N, _, C, _, Q, S, NH, G = dp._shapes(a)
    P = S * R if cfg.drf_ns_order else 0
    ad = rp.aff_dims(a)
    return dp.max_jobs(N, cb, C, 4, R, G, Q, S, P, a.skeys.shape[0], NH,
                       ad["SK"], rp.aff_list_ints(ad))


@pytest.mark.cuda
@pytest.mark.parametrize("cb", [8, 16])
def test_dyn_cluster_kernel_at_the_most_jobs(cb):
    """J at the wrapper's limit runs and matches; one more job raises."""
    need_card()
    kw = dict(drf_job_order=True, N=200)
    flags, small = make_dyn_inputs(0, **kw)
    cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
    jmax = dyn_max_jobs(cfg, [torch.from_numpy(a) for a in small], cb)
    assert jmax > 10000
    for J in (jmax, jmax + 1):
        _, args = make_dyn_inputs(0, J=J, **kw)
        t = [torch.from_numpy(a).cuda() for a in args]
        if J == jmax:
            check_dyn_cluster(cfg, t, cb)
        else:
            with pytest.raises(ValueError, match=f"J <= {jmax}"):
                dp.dyn_place_cuda(cfg, 4, 12, 4, t, cb=cb)


@pytest.mark.cuda
@pytest.mark.parametrize("cb", [8, 16])
def test_dyn_cluster_launches_alternate_shared_sizes(cb):
    """The launcher sets a kernel's shared-memory attribute and asks for
    the card's verdict once a shape: a large launch, a small one and the
    large one again, each bitwise against the plain version."""
    need_card()
    kw = dict(drf_job_order=True, N=200)
    flags, small = make_dyn_inputs(0, **kw)
    cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
    jmax = dyn_max_jobs(cfg, [torch.from_numpy(a) for a in small], cb)
    _, large = make_dyn_inputs(0, J=jmax, **kw)
    for args in (large, small, large, small):
        check_dyn_cluster(cfg, [torch.from_numpy(a).cuda() for a in args],
                          cb)


@pytest.mark.cuda
def test_dyn_cluster_phase_split():
    """The optional phase split: every phase's cycles, the launch's, its
    nanoseconds and pops; a wrong row raises before the launch."""
    need_card()
    flags, args = make_dyn_inputs(1, **DYN_CASES["drf_ns3"])
    cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
    t = [torch.from_numpy(a).cuda() for a in args]
    stamps = torch.zeros(dp.N_STAMPS, dtype=torch.int64, device="cuda")
    got = dp.dyn_place_cuda(cfg, 4, 12, 4, t, stamps=stamps)
    split = dp.phase_split(stamps)
    assert split["pops"] == int(got[-2][0, 0]) >= 1
    assert split["cycles"] >= sum(stamps[:len(dp.PHASES)].tolist()) > 0
    assert split["launch_us"] > 0
    with pytest.raises(ValueError, match="stamps"):
        dp.dyn_place_cuda(cfg, 4, 12, 4, t, stamps=stamps.int())


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


def same_bits_or_nan(got, want):
    """Equal float32 bits, a NaN only where the other has one: the card's
    float add returns the canonical NaN where the CPU's keeps an operand's
    payload, so a NaN sum's bits are the hardware's, not the order's."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32),
                            want[~nan].view(torch.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("A,D,num", [(3000, 2, 4), (2500, 3, 1500),
                                     (1024, 2, 5), (40, 2, 12)])
def test_seg_fold_kernel_with_planted_values(A, D, num):
    """Past one shared-memory tile of rows (1,024) with a ragged last one,
    and num x D past a block's warps (8) and past the grid's (the warps
    then loop over the pairs), with -0.0, NaN and infinities among the
    values, dropped rows (-1, num and beyond) and empty segments."""
    need_card()
    from volcano_tpu_torch.ops import seg_fold as sf
    g = torch.Generator().manual_seed(A + D)
    vals = (torch.randn((A, D), generator=g)
            * 10.0 ** torch.randint(-3, 8, (A, D), generator=g)).float()
    pick = torch.rand((A, D), generator=g)
    vals[pick < 0.2] = 0.0
    vals[(pick >= 0.2) & (pick < 0.3)] = -0.0
    vals[(pick >= 0.3) & (pick < 0.31)] = float("inf")
    vals[(pick >= 0.31) & (pick < 0.32)] = float("-inf")
    vals[(pick >= 0.32) & (pick < 0.325)] = float("nan")
    seg = torch.randint(-1, num + 3, (A,), generator=g, dtype=torch.int32)
    seg[seg == 1] = 0                       # segment 1 stays empty
    seg[:7] = 0                             # a sum of -0.0 terms only
    vals[:7] = -0.0
    vals, seg = vals.cuda(), seg.cuda()
    want = sf.seg_fold_plain(vals, seg, num)
    before = sf.launches
    got = sf.seg_fold(vals, seg, num)
    torch.cuda.synchronize()
    assert sf.launches == before + 1
    assert got.shape == want.shape == (num, D)
    assert same_bits_or_nan(got, want)
    assert (got[1].view(torch.int32) == 0).all()    # +0.0, the empty sum


@pytest.mark.cuda
def test_seg_fold_kernel_at_its_limits():
    """42 dims (a tile of 256 rows still fits, one chunk of dims) and 43
    (two chunks) bitwise; and 6 M (segment, dim) pairs, more than the
    2 x 132 blocks' shared memory keeps at once, on more blocks."""
    need_card()
    from volcano_tpu_torch.ops import seg_fold as sf
    g = torch.Generator().manual_seed(7)
    for A, D, num in ((3000, 42, 40), (3000, 43, 40), (3000, 2, 3_000_000)):
        vals = (torch.randn((A, D), generator=g)
                * 10.0 ** torch.randint(-3, 8, (A, D), generator=g)).float()
        seg = torch.randint(-1, min(num, 50) + 1, (A,), generator=g,
                            dtype=torch.int32)
        seg[::5] = num - 1
        vals, seg = vals.cuda(), seg.cuda()
        want = sf.seg_fold_plain(vals, seg, num)
        got = sf.seg_fold_cuda(vals, seg, num)
        torch.cuda.synchronize()
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
        want = sp.shard_candidates_plain_combined(cfg, D, t)
        before = sp.launches
        got = sp.shard_candidates(cfg, D, t)
        torch.cuda.synchronize()
        assert sp.launches == before + 1
        assert_same(got, want)


#: the grid's block shapes: threads, rows a thread
GEOMETRIES = [(128, 1), (128, 2), (256, 1), (256, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("case", ["mixed", "ties_across_shards",
                                  "infeasible_shard", "nothing_feasible"])
def test_split_row_grid_matches_plain_bitwise(case, D, geometry):
    """Shards of 300 rows, a multiple of no block's rows: several blocks a
    shard, the last one short. The per-shard outputs against the plain
    version and the combined triple against ``combine`` of it; with ties
    the best recurs across blocks and shards and the raw counts add up."""
    need_card()
    cfg = AllocateConfig(enable_gpu=True, **PLACER_WEIGHTS)
    NL = 300
    for seed in (0, 1):
        t = [torch.from_numpy(a).cuda() for a in make_shard_inputs(
            seed, D=D, NL=NL, gpu=True, **SHARD_CASES[case])]
        want = sp.shard_candidates_plain_all(cfg, D, t)
        got = sp.shard_candidates_cuda(cfg, D, t, *geometry)
        torch.cuda.synchronize()
        assert_same(got[:4], want[:4])
        assert_same(got[4:], sp.combine(want, D * NL))
        if case == "nothing_feasible":
            assert not got.best_found.any() and got.best_idx.sum() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("D", [1, 2, 4])
def test_split_row_grid_sums_ties_across_blocks_and_shards(D, geometry):
    """Every 7th row the same node (no preferred node, no volume pin): the
    best score recurs in every block and shard, and the raw tie count is
    the sum over all of them."""
    need_card()
    cfg = AllocateConfig(enable_gpu=True, **PLACER_WEIGHTS)
    NL = 300
    t = [torch.from_numpy(a) for a in make_shard_inputs(0, D=D, NL=NL,
                                                        gpu=True)]
    t[1][0, 0] = t[1][0, 3] = -1
    src = torch.arange(D * NL) % 7
    t = [x.cuda() for x in t[:3]] + [x[:, src].contiguous().cuda()
                                     for x in t[3:]]
    want = sp.shard_candidates_plain_all(cfg, D, t)
    got = sp.shard_candidates_cuda(cfg, D, t, *geometry)
    assert_same(got[:4], want[:4])
    assert_same(got[4:], sp.combine(want, D * NL))
    assert int(got.best_ties[0]) >= D * NL // 7


@pytest.mark.cuda
def test_shard_kernel_at_full_width():
    """One shard of 10,240 rows and four of 2,560 (the north star's
    shapes): more rows than threads in a block."""
    need_card()
    cfg = AllocateConfig(enable_gpu=False, binpack_weight=1.0)
    for D, NL in ((1, 10240), (4, 2560)):
        t = [torch.from_numpy(a).cuda() for a in
             make_shard_inputs(3, D=D, NL=NL, ties=True)]
        for geometry in GEOMETRIES:
            assert_same(sp.shard_candidates_cuda(cfg, D, t, *geometry),
                        sp.shard_candidates_plain_combined(cfg, D, t))


@pytest.mark.cuda
def test_sharded_cycle_on_the_card_runs_no_combine(monkeypatch):
    """The kernel's last block combines the shards: the CUDA route of the
    sharded cycle never calls ``combine``, and gives the plain route's
    decisions."""
    need_card()
    from volcano_tpu_torch.arrays import pack, to_device
    from volcano_tpu_torch.ops.allocate_scan import (AllocateExtras,
                                                     make_allocate_cycle)
    from volcano_tpu_torch.parallel import NodeMesh
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    snap, _ = pack(_synthetic_cluster(256, 24, 8))
    s = to_device(snap, "cuda")
    e = to_device(AllocateExtras.neutral(snap), "cuda")
    cfg = AllocateConfig(binpack_weight=1.0, enable_gpu=False)
    mesh = NodeMesh(("cuda",) * 4)
    want = make_allocate_cycle(
        cfg, mesh=mesh, shard_placer=sp.shard_candidates_plain_combined)(
        s, e).packed_decisions().cpu()
    calls = []
    combine = sp.combine
    monkeypatch.setattr(sp, "combine",
                        lambda *a: calls.append(1) or combine(*a))
    before = sp.launches
    got = make_allocate_cycle(cfg, mesh=mesh)(s, e).packed_decisions().cpu()
    assert sp.launches > before and calls == []
    assert torch.equal(got, want)


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
    assert_wave_same(got, want, C, t)


def assert_wave_same(got, want, C, t):
    """The kernel's per-shard lists against the plain version's, and its
    combined lists against ``combine`` of the plain version's, bitwise."""
    assert_same(got[:4], want[:4])
    combined = sw.combine(want, C, t[-1].shape[1])
    assert_same(got[4:], [x.contiguous() for x in combined])
    assert got.e_found.dtype == torch.bool


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
        assert_wave_same(sw.shard_wave(cfg, D, 8, t),
                         sw.shard_wave_plain_all(cfg, D, 8, t), 8, t)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("case", ["mixed", "ties_across_shards",
                                  "nothing_feasible", "fewer_than_depth"])
def test_wave_split_row_grid_matches_plain_bitwise(case, D):
    """Shards of 300 rows, a multiple of no block's rows: two blocks a shard
    and column, the last one short, W = 16 columns past the depth C = 8;
    then every 7th row the same node, so the best recurs in every block
    and shard and the raw ties add up."""
    need_card()
    cfg = AllocateConfig(enable_gpu=True, **PLACER_WEIGHTS)
    NL, W, C = 300, 16, 8
    t = [torch.from_numpy(a).cuda() for a in make_wave_inputs(
        1, D=D, W=W, NL=NL, gpu=True, **WAVE_CASES[case])]
    assert_wave_same(sw.shard_wave_cuda(cfg, D, C, t),
                     sw.shard_wave_plain_all(cfg, D, C, t), C, t)
    t = [torch.from_numpy(a) for a in make_wave_inputs(0, D=D, W=W, NL=NL,
                                                       gpu=True)]
    t[1][0] = t[1][3] = -1                # no preferred node, no volume pin
    src = torch.arange(D * NL) % 7
    t = [x.cuda() for x in t[:2]] + [x[:, src].contiguous().cuda()
                                     for x in t[2:]]
    got = sw.shard_wave_cuda(cfg, D, C, t)
    assert_wave_same(got, sw.shard_wave_plain_all(cfg, D, C, t), C, t)
    assert int(got.e_ties.max()) >= D * NL // 7


@pytest.mark.cuda
def test_wave_launches_in_a_row_reset_the_counters():
    """Launches of other widths and shard counts one after another on the
    stream, each reusing the column counters its predecessor put back to
    0, then the first shape again."""
    need_card()
    cfg = AllocateConfig(enable_gpu=True, **PLACER_WEIGHTS)
    shapes = [(1, 8, 300), (4, 16, 300), (2, 4, 48), (1, 8, 300)]
    runs = []
    for D, W, NL in shapes:
        C = wave_candidate_depth(W)
        t = [torch.from_numpy(a).cuda() for a in make_wave_inputs(
            D, D=D, W=W, NL=NL, gpu=True, ties=True)]
        runs.append((sw.shard_wave_cuda(cfg, D, C, t), C, t))
    torch.cuda.synchronize()
    for got, C, t in runs:
        assert_wave_same(got, sw.shard_wave_plain_all(cfg, got.count.shape[1],
                                                      C, t), C, t)
    assert_same(runs[0][0], runs[-1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("D,NL,W", [(1, 20000, 4), (9, 300, 4),
                                    (16, 130, 8), (3, 17000, 2)])
def test_wave_merge_tree_levels_match_plain_bitwise(D, NL, W):
    """The last block's tree past two levels (79 blocks a shard: 10 lists,
    then 2, then 1), the combine past one merge (9 and 16 shards), one
    block a shard: bitwise against the plain version and combine."""
    need_card()
    cfg = AllocateConfig(enable_gpu=False, least_allocated_weight=1.0,
                         balanced_weight=1.0)
    C = wave_candidate_depth(W)
    t = [torch.from_numpy(a).cuda() for a in
         make_wave_inputs(4, D=D, W=W, NL=NL, ties=True)]
    assert_wave_same(sw.shard_wave_cuda(cfg, D, C, t),
                     sw.shard_wave_plain_all(cfg, D, C, t), C, t)


@pytest.mark.cuda
def test_wave_plan_follows_its_tensors_and_stream():
    """The launch plan is reused for the same node tensors, rebuilt when
    one of them is re-pointed in place (``set_``: the same object at a new
    address) and when the stream changes, which also takes scratch of its
    own; each launch gives the plain version's lists."""
    need_card()
    cfg = AllocateConfig(enable_gpu=True, **PLACER_WEIGHTS)
    D, W, C = 2, 8, 8
    t = [torch.from_numpy(a).cuda() for a in
         make_wave_inputs(0, D=D, W=W, NL=300, gpu=True, ties=True)]
    other = [torch.from_numpy(a).cuda() for a in
             make_wave_inputs(1, D=D, W=W, NL=300, gpu=True, ties=True)]
    before = sw.shard_wave_plain_all(cfg, D, C, t)
    assert_wave_same(sw.shard_wave_cuda(cfg, D, C, t), before, C, t)
    plan = sw._plan
    sw.shard_wave_cuda(cfg, D, C, t)
    assert sw._plan is plan
    for x, y in zip(t[2:], other[2:]):
        x.set_(y.clone())
    got = sw.shard_wave_cuda(cfg, D, C, t)
    assert sw._plan is not plan
    want = sw.shard_wave_plain_all(cfg, D, C, t)     # the new node rows
    assert not torch.equal(want.idx, before.idx)
    assert_wave_same(got, want, C, t)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = sw.shard_wave_cuda(cfg, D, C, t)
    torch.cuda.synchronize()
    assert sw._plan.stream == side.cuda_stream
    assert_wave_same(got, want, C, t)


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
                                wave_placer=sw.shard_wave_plain_combined)
    assert torch.equal(plain(s, e).packed_decisions().cpu(), seq)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 4])
def test_wave_cycle_on_the_card_runs_no_combine(monkeypatch, D):
    """The kernel's last blocks combine the shards' lists: the CUDA route
    of the wave walk never calls ``shard_wave.combine``, and gives the
    plain route's decisions."""
    need_card()
    from volcano_tpu_torch.arrays import pack, to_device
    from volcano_tpu_torch.ops.allocate_scan import (AllocateExtras,
                                                     make_allocate_cycle)
    from volcano_tpu_torch.parallel import NodeMesh
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    snap, _ = pack(_synthetic_cluster(256, 24, 8))
    s = to_device(snap, "cuda")
    e = to_device(AllocateExtras.neutral(snap), "cuda")
    cfg = AllocateConfig(binpack_weight=1.0, enable_gpu=False, wave_width=8)
    mesh = NodeMesh(("cuda",) * D)
    want = make_allocate_cycle(
        cfg, mesh=mesh, wave_placer=sw.shard_wave_plain_combined)(
        s, e).packed_decisions().cpu()
    calls = []
    combine = sw.combine
    monkeypatch.setattr(sw, "combine",
                        lambda *a: calls.append(1) or combine(*a))
    before = sw.launches
    got = make_allocate_cycle(cfg, mesh=mesh)(s, e).packed_decisions().cpu()
    assert sw.launches > before and calls == []
    assert torch.equal(got, want)


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
@pytest.mark.parametrize("shape", [(32, 4), (10240, 4), (1000, 3), (1, 1),
                                   (5, 3), (2049, 3)])
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
    with pytest.raises(ValueError, match="CUDA device"):
        gs.planted_double_cuda(x.cpu())


@pytest.mark.cuda
def test_planted_kernel_on_an_unaligned_block():
    """A contiguous block whose storage does not start on 16 bytes, of
    1,033 x 3 elements (a multiple neither of 4 nor of a block's 256
    threads), against the plain version; and the raw stream handle the
    wrapper launches on, on the default stream and on a side stream."""
    need_card()
    from volcano_tpu_torch.analysis import sharding as gs
    from volcano_tpu_torch.ops._build import stream_handle
    base = torch.randn(4000, generator=torch.Generator().manual_seed(5))
    x = base.cuda()[1:1 + 1033 * 3].view(1033, 3)
    assert x.is_contiguous() and x.data_ptr() % 16
    got = gs.planted_double_cuda(x)
    torch.cuda.synchronize()
    want = gs.planted_double_plain(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    index = torch.cuda.current_device()
    assert stream_handle(index) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert stream_handle(index) == side.cuda_stream != 0


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


# ---- kernel 3's namespace fold in tiles of 32 pairs ------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("S", [4, 32, 64])
def test_dyn_cluster_fold_tiles_match_plain(S, cb):
    """P = S x R fold pairs at R = 2: 8 (one tile), 64 and 128 (two and
    four tiles of 32), with a ragged last job slice, bitwise against the
    plain version."""
    need_card()
    pops = []
    for seed in (0, 1):
        flags, args = make_dyn_inputs(seed, drf_job_order=True,
                                      drf_ns_order=True, S=S, J=1000, N=200)
        cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
        t = [torch.from_numpy(a).cuda() for a in args]
        a = dp.unpack_args(cfg, t)
        assert (a.nsm.shape[0], a.jalloc.shape[0]) == (S, 2)
        pops.append(int(check_dyn_cluster(cfg, t, cb)[-2][0, 0]))
    assert max(pops) >= 2, pops


@pytest.mark.cuda
@pytest.mark.parametrize("cb", [8, 16])
def test_dyn_cluster_fold_tiles_at_the_most_jobs(cb):
    """128 fold pairs at J at the wrapper's limit: bitwise; one job more
    raises."""
    need_card()
    kw = dict(drf_job_order=True, drf_ns_order=True, S=64, N=200)
    flags, small = make_dyn_inputs(0, **kw)
    cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
    jmax = dyn_max_jobs(cfg, [torch.from_numpy(a) for a in small], cb)
    assert jmax > 4096
    for J in (jmax, jmax + 1):
        _, args = make_dyn_inputs(0, J=J, **kw)
        t = [torch.from_numpy(a).cuda() for a in args]
        if J == jmax:
            check_dyn_cluster(cfg, t, cb)
        else:
            with pytest.raises(ValueError, match=f"J <= {jmax}"):
                dp.dyn_place_cuda(cfg, 4, 12, 4, t, cb=cb)


def shipped_conf():
    import os

    from volcano_tpu_torch.framework import parse_conf
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "conf", "volcano-scheduler.conf")) as f:
        return parse_conf(f.read())


@pytest.mark.cuda
def test_a_snapshot_past_kernel_3s_jobs_takes_the_mesh_path():
    """25,000 one-task gangs under the shipped conf: J pads to 28,672,
    past kernel 3's job limit at these shapes. The Session's cycle takes
    the one-shard mesh path (kernel 4, no kernel-3 launch), chosen before
    the cycle, and gives the decisions of the fused cycle run through the
    plain dynamic-key placer on the card. Not its ``job_attempted``: which
    jobs a cycle pops before capacity runs out differs between the
    reference's own scan path and its fused kernel (ROADMAP section 3
    (i)), and the mesh path gives the scan path's."""
    need_card()
    from volcano_tpu_torch.arrays import to_device
    from volcano_tpu_torch.framework import Session
    from volcano_tpu_torch.ops import allocate_scan as tas
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    ssn = Session(_synthetic_cluster(16, 25000, 1), shipped_conf(),
                  device="cuda")
    cfg, extras = ssn._derived_allocate_inputs()
    assert cfg.batch_rounds > 0
    assert tas.cycle_path(cfg, ssn.snap, extras) == "dyn_mesh"
    assert re.search(r"J <= \d+", tas.dyn_refusal(cfg, ssn.snap, extras))
    plain = tas.make_allocate_cycle(cfg, dyn_placer=dp.dyn_place_plain)(
        to_device(ssn.snap, "cuda"), to_device(extras, "cuda"))
    dp.launches = sp.launches = 0
    ssn.run_allocate()
    assert ssn.stats["path"] == "dyn_mesh"
    assert dp.launches == 0 and sp.launches > 0
    res = ssn.last_allocate
    for f in ("task_node", "task_mode", "task_gpu", "job_ready",
              "job_pipelined"):
        want = getattr(plain, f).cpu().numpy()
        assert (getattr(res, f) == want).all(), f
    assert (res.task_mode > 0).sum() > 100


def past_max_c():
    """A candidate depth of 9: the wave walk's depth is min(W, 8)
    (``wave_candidate_depth``), so no snapshot reaches it."""
    assert wave_candidate_depth(64) == sw.MAX_C
    t = [torch.from_numpy(a).cuda() for a in make_wave_inputs(0, D=1, W=9)]
    sw.shard_wave(AllocateConfig(**PLACER_WEIGHTS, enable_gpu=False), 1,
                  sw.MAX_C + 1, t)


#: the limit the card path keeps (ROADMAP section 3): a launch just past it
LIMITS = {
    "max_c": (past_max_c, r"candidate depth is 1\.\.8"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("limit", sorted(LIMITS))
def test_the_card_path_refuses_past_its_limits(limit):
    need_card()
    build, match = LIMITS[limit]
    with pytest.raises(ValueError, match=match):
        build()


def sparse_requests(req, R, seed, rows):
    """Three of four of the extended dims' requests (dims 2.. R - 1, on
    axis 0 when ``rows`` else axis 1) set to 0, the rest quartered, as
    tasks ask for few of a cluster's extended resources: the tasks fit
    somewhere, and the scores see both applicable and empty dims."""
    rng = np.random.RandomState(seed)
    req = req.copy()
    ext = req[2:R] if rows else req[:, 2:R]
    keep = rng.rand(*ext.shape) < 0.25
    ext[...] = np.where(keep, ext * 0.25, 0).astype(req.dtype)
    return req


def wide_kernel_1(R):
    cfg = AllocateConfig(enable_gpu=True, **PLACER_WEIGHTS)
    placed = 0
    for seed in (0, 1):
        args = make_inputs(seed, R=R, gpu=True)
        args[0] = sparse_requests(args[0], R, seed, rows=True)
        t = [torch.from_numpy(a).cuda() for a in args]
        want = rp.round_place_plain(cfg, 8, 4, t)
        before = rp.launches
        got = rp.round_place(cfg, 8, 4, t)
        torch.cuda.synchronize()
        assert rp.launches == before + 1
        assert_same(got, want)
        placed += int((want[0] >= 0).sum())
    assert placed > 0


def wide_kernel_3(R):
    placed = 0
    for seed in (0, 1):
        flags, args = make_dyn_inputs(seed, R=R, drf_job_order=True,
                                      drf_ns_order=True, S=3)
        args = list(args)
        args[0] = sparse_requests(args[0], R, seed, rows=True)
        cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
        for cb in (8, 16):
            want = check_dyn_cluster(cfg, [torch.from_numpy(a).cuda()
                                           for a in args], cb)
        placed += int((want[0] >= 0).sum())
    assert placed > 0


def wide_kernel_4(R):
    cfg = AllocateConfig(enable_gpu=False, **PLACER_WEIGHTS)
    found = 0
    for D in (1, 2, 4):
        args = make_shard_inputs(D, D=D, R=R)
        args[0] = sparse_requests(args[0], R, D, rows=False)
        t = [torch.from_numpy(a).cuda() for a in args]
        want = sp.shard_candidates_plain_combined(cfg, D, t)
        before = sp.launches
        got = sp.shard_candidates(cfg, D, t)
        torch.cuda.synchronize()
        assert sp.launches == before + 1
        assert_same(got, want)
        found += int(want[-1].sum())
    assert found > 0


def wide_kernel_5(R):
    cfg = AllocateConfig(enable_gpu=False, **PLACER_WEIGHTS)
    feasible = 0
    for D, W in ((1, 8), (2, 4), (4, 16)):
        C = wave_candidate_depth(W)
        args = make_wave_inputs(D, D=D, W=W, R=R)
        args[0] = sparse_requests(args[0], R, D, rows=True)
        t = [torch.from_numpy(a).cuda() for a in args]
        want = sw.shard_wave_plain_all(cfg, D, C, t)
        before = sw.launches
        got = sw.shard_wave(cfg, D, C, t)
        torch.cuda.synchronize()
        assert sw.launches == before + 1
        assert_wave_same(got, want, C, t)
        feasible += int(want.count.sum())
    assert feasible > 0


def wide_seg_fold(D):
    from volcano_tpu_torch.ops import seg_fold as sf
    g = torch.Generator().manual_seed(D)
    for A, num in ((3000, 40), (5000, 4)):
        vals = (torch.randn((A, D), generator=g)
                * 10.0 ** torch.randint(-3, 8, (A, D), generator=g)).float()
        vals[torch.rand((A, D), generator=g) < 0.3] = 0.0
        seg = torch.randint(-1, num + 1, (A,), generator=g,
                            dtype=torch.int32)
        vals, seg = vals.cuda(), seg.cuda()
        want = sf.seg_fold_plain(vals, seg, num)
        before = sf.launches
        got = sf.seg_fold_cuda(vals, seg, num)
        torch.cuda.synchronize()
        assert sf.launches == before + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


#: one shard's rows past which kernel 5's last block kept its merge levels
#: in shared memory alone (2 D (ceil(B / 8) + ceil(B / 64)) lists of 72
#: bytes over 228,352 at D = 1)
OLD_WAVE_ROWS = 2_883_584


def wave_rows(NL):
    """One shard of NL rows, the merge levels in the launch plan's scratch
    of device memory: bitwise the plain version's lists."""
    cfg = AllocateConfig(enable_gpu=False, **PLACER_WEIGHTS)
    B, _, _ = sw.grid_shape(1, NL, 8)
    assert not sw.levels_shared(1, B)
    t = [torch.from_numpy(a).cuda()
         for a in make_wave_inputs(0, D=1, W=8, NL=NL)]
    want = sw.shard_wave_plain_all(cfg, 1, 8, t)
    before = sw.launches
    got = sw.shard_wave(cfg, 1, 8, t)
    torch.cuda.synchronize()
    assert sw.launches == before + 1
    assert_wave_same(got, want, 8, t)
    assert int(want.count.sum()) > 0


#: what the reference takes and the card path refused before: kernels 1,
#: 3, 4 and 5 past 8 resource dims, seg_fold past 42 dims, kernel 5 past
#: the rows a shard its last block kept in shared memory
WIDE = dict(
    [(f"kernel_{k}_r{R}", (fn, R)) for k, fn in (
        (1, wide_kernel_1), (3, wide_kernel_3), (4, wide_kernel_4),
        (5, wide_kernel_5)) for R in (9, 12, 64)]
    + [(f"seg_fold_d{D}", (wide_seg_fold, D)) for D in (43, 64, 128)]
    + [("wave_rows_past", (wave_rows, OLD_WAVE_ROWS + 1)),
       ("wave_rows_twice", (wave_rows, 2 * OLD_WAVE_ROWS))])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIDE))
def test_the_card_path_takes_what_the_reference_takes(case):
    need_card()
    fn, arg = WIDE[case]
    fn(arg)


@pytest.mark.cuda
@pytest.mark.parametrize("conf", ["static", "shipped"])
def test_sessions_past_8_and_42_dims_run_on_the_card(conf):
    """A Session of 64 resource dims on the card (kernels 1 and 3 at R =
    64; enqueue's and drf's folds over 64 dims) gives the decisions of
    the same Session on the CPU."""
    need_card()
    from volcano_tpu_torch.framework import Session, parse_conf
    from volcano_tpu_torch.synthetic import scalar_cluster
    text = ("actions: allocate\ntiers:\n- plugins:\n  - name: gang\n"
            "  - name: binpack\n")
    outs = []
    for dev in ("cuda", "cpu"):
        ssn = Session(scalar_cluster(64), parse_conf(text) if conf ==
                      "static" else shipped_conf(), device=dev)
        assert ssn.snap.nodes.idle.shape[1] == 64
        if conf == "shipped":
            ssn.run_enqueue()
        ssn.run_allocate()
        r = ssn.last_allocate
        outs.append((r.task_node.tolist(), r.task_mode.tolist(),
                     sorted(b.task_uid for b in ssn.binds)))
    assert outs[0] == outs[1] and outs[0][2]


@pytest.mark.cuda
def test_a_static_key_snapshot_past_kernel_1s_slice_takes_the_mesh_path():
    """7,200 nodes of 64 resource dims: a block's slice of kernel 1's node
    state is over its shared memory at 16 blocks. The Session's cycle takes
    the one-shard mesh path (kernel 4, no kernel-1 launch), chosen before
    the cycle, and gives the decisions of the fused cycle run through the
    plain round placer on the CPU."""
    need_card()
    from volcano_tpu_torch.arrays import to_device
    from volcano_tpu_torch.framework import Session, parse_conf
    from volcano_tpu_torch.ops import allocate_scan as tas
    from volcano_tpu_torch.synthetic import scalar_cluster
    ssn = Session(scalar_cluster(64, n_nodes=7200, n_jobs=24), parse_conf(
        "actions: allocate\ntiers:\n- plugins:\n  - name: gang\n"
        "  - name: binpack\n"), device="cuda")
    cfg, extras = ssn._derived_allocate_inputs()
    assert cfg.batch_rounds == 0
    assert tas.cycle_path(cfg, ssn.snap, extras) == "round_mesh"
    assert "shared memory" in tas.round_refusal(cfg, ssn.snap, extras)
    plain = tas.make_allocate_cycle(cfg, placer=rp.round_place_plain)(
        to_device(ssn.snap, "cpu"), to_device(extras, "cpu"))
    rp.launches = sp.launches = 0
    ssn.run_allocate()
    assert ssn.stats["path"] == "round_mesh"
    assert rp.launches == 0 and sp.launches > 0
    res = ssn.last_allocate
    for f in ("task_node", "task_mode", "task_gpu", "job_ready",
              "job_pipelined"):
        want = getattr(plain, f).cpu().numpy()
        assert (getattr(res, f) == want).all(), f
    assert (res.task_mode > 0).sum() > 10


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 5_000_000])
def test_device_digest_on_the_card_equals_host_digest(n):
    """The resident buffers' digest on the card: bit for bit the host's,
    with NaNs, negative zeros, infinities and bools planted."""
    need_card()
    import numpy as np

    from volcano_tpu_torch.ops import fused_io as fio
    rng = np.random.RandomState(n)
    f = (rng.randn(n) * 1e20).astype(np.float32)
    f[rng.randint(n, size=min(n, 7))] = np.float32(-0.0)
    f[rng.randint(n, size=min(n, 5))] = np.nan
    f[rng.randint(n, size=min(n, 3))] = -np.inf
    i = rng.randint(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    b = rng.rand(n) < 0.3
    bufs = (f, i, b)
    dev = fio.device_digest([torch.from_numpy(x).cuda() for x in bufs])
    assert dev.is_cuda
    np.testing.assert_array_equal(dev.cpu().numpy().view(np.uint32),
                                  fio.host_digest(bufs))
