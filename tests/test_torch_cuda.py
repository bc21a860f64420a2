"""The CUDA round placer against its plain PyTorch version, on the card.

Imports nothing of JAX, so it runs on a machine with a card and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Where there is no card every test skips (decided inside the test).
"""

import pytest
import torch

from torch_fixtures import CASES, PLACER_WEIGHTS, make_inputs
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
