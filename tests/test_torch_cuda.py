"""The CUDA kernels against their plain PyTorch versions, on the card: the
round placer (with and without its pod-affinity step), the pod-affinity
step in the dynamic-key placer, and the segmented sum.

Imports nothing of JAX, so it runs on a machine with a card and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Where there is no card every test skips (decided inside the test).
"""

import pytest
import torch

from torch_fixtures import (AFF_CASES, CASES, PLACER_WEIGHTS,
                            aff_placer_knobs, make_dyn_inputs, make_inputs)
from volcano_tpu_torch.ops import dyn_placer as dp
from volcano_tpu_torch.ops import round_placer as rp
from volcano_tpu_torch.ops.allocate_scan import AllocateConfig


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
