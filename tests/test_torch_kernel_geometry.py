"""The host side of the redesigned kernels 1 and 4, on the CPU: how the
round placer's cluster splits the node axis and what shared memory each
block takes, the candidate kernel's grid of split-row blocks, and the
combined triple the sharded cycle reads on the plain route.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
marked ``cuda``). Imports nothing of JAX.
"""

import pytest
import torch

from volcano_tpu_torch.ops import round_placer as rp
from volcano_tpu_torch.ops import shard_placer as sp
from volcano_tpu_torch.ops.allocate_scan import AllocateConfig
from volcano_tpu_torch.ops.dyn_cases import (PLACER_WEIGHTS, SHARD_CASES,
                                             make_shard_inputs)


# ---- kernel 1: the cluster's slices and shared memory ----------------------

@pytest.mark.parametrize("N,CB", [(10240, 16), (10240, 8), (200, 16),
                                  (1000, 16), (40, 8), (5, 8), (5, 16),
                                  (1, 16), (16, 16), (17, 16)])
def test_cluster_slices_cover_the_axis_once(N, CB):
    """Contiguous runs in rank order that cover [0, N) once; every slice
    but the last non-empty one is ceil(N / CB) long; past N a block owns
    nothing; the kernel's owner of node i is i // ceil(N / CB)."""
    slices = rp.cluster_slices(N, CB)
    assert len(slices) == CB
    cap = -(-N // CB)
    pos = 0
    for r, (lo, hi) in enumerate(slices):
        assert lo == min(pos, N) and lo <= hi <= lo + cap
        pos = hi
        for i in range(lo, hi):
            assert i // cap == r
    assert pos == N
    sizes = [hi - lo for lo, hi in slices]
    full = [n for n in sizes if n]
    assert all(n == cap for n in full[:-1])


def test_cluster_slices_ragged_and_empty():
    assert rp.cluster_slices(200, 16)[-2:] == [(182, 195), (195, 200)]
    assert rp.cluster_slices(5, 8) == [(0, 1), (1, 2), (2, 3), (3, 4),
                                       (4, 5), (5, 5), (5, 5), (5, 5)]
    assert rp.cluster_slices(17, 16)[8:10] == [(16, 17), (17, 17)]


@pytest.mark.parametrize("N,CB,M,R,G,SK,lists,want", [
    # the north star: 640 nodes a block, 2 resource dims, sections of 16
    (10240, 16, 16, 2, 0, 0, 0, (5 * 640 + 16 * 6 + 48) * 4),
    (10240, 8, 16, 2, 0, 0, 0, (5 * 1280 + 16 * 6 + 48) * 4),
    # GPU cards join the column, pod affinity the totals and term lists
    (200, 16, 6, 2, 2, 0, 0, (7 * 13 + 6 * 8 + 18) * 4),
    (10240, 16, 8, 2, 0, 16, 40, (5 * 640 + 8 * 6 + 24 + 16 + 40) * 4),
    (5, 16, 4, 3, 0, 0, 0, (7 * 1 + 4 * 8 + 12) * 4),
])
def test_shared_bytes(N, CB, M, R, G, SK, lists, want):
    assert rp.shared_bytes(N, CB, M, R, G, SK, lists) == want


def test_shared_bytes_fit_at_the_checked_shapes():
    """About 13 KB a block at the north star and 16 blocks; check E's
    affinity launch (SK = 16) stays far inside a block's shared memory."""
    assert rp.shared_bytes(10240, 16, 16, 2, 0) == 13376
    d = dict(aff=1, A=2, B=2, ETA=8, PP=2, SEL=4, SK=16)
    assert rp.shared_bytes(10240, 8, 8, 2, 0, 16,
                           rp.aff_list_ints(d)) < rp.MAX_SHARED // 8


def test_cluster_launch_shape_is_checked_before_the_card():
    """A CPU tensor never reaches the launcher; the module's cluster is
    one the kernel takes."""
    assert 1 <= rp.CLUSTER <= rp.MAX_CB
    assert rp.DIMS[-1] == "CB"
    cfg = AllocateConfig(enable_gpu=False, **PLACER_WEIGHTS)
    from volcano_tpu_torch.ops.dyn_cases import make_inputs
    t = [torch.from_numpy(a) for a in make_inputs(0, gpu=False)]
    with pytest.raises(ValueError, match="CUDA device"):
        rp.round_place_cuda(cfg, 8, 4, t, cb=8)


# ---- kernel 4: the split-row grid and the combined triple ------------------

@pytest.mark.parametrize("NL,rows,B", [(10240, 128, 80), (10240, 256, 40),
                                       (10240, 512, 20), (2560, 256, 10),
                                       (300, 128, 3), (300, 512, 1),
                                       (48, 256, 1), (1, 128, 1)])
def test_row_blocks(NL, rows, B):
    assert sp.row_blocks(NL, rows) == B
    assert (B - 1) * rows < NL <= B * rows


def test_grid_geometry():
    assert sp.grid_geometry(128, 1) == (128, 128)
    assert sp.grid_geometry(128, 2) == (128, 256)
    assert sp.grid_geometry(256, 2) == (256, 512)
    T, rows = sp.grid_geometry()
    assert (T, rows) == (sp.THREADS, sp.THREADS * sp.ROWS_PER_THREAD)
    for bad in ((64, 1), (512, 1), (128, 3)):
        with pytest.raises(ValueError, match="threads"):
            sp.grid_geometry(*bad)


@pytest.mark.parametrize("gpu", [False, True])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_plain_route_carries_combine(case, D, gpu):
    """The wrapper's plain route returns the per-shard candidates of the
    plain version and, beside them, ``combine`` of those candidates: the
    triple the cycle reads."""
    cfg = AllocateConfig(enable_gpu=gpu, **PLACER_WEIGHTS)
    t = [torch.from_numpy(a) for a in
         make_shard_inputs(0, D=D, gpu=gpu, **SHARD_CASES[case])]
    N = t[-1].shape[1]
    got = sp.shard_candidates(cfg, D, t)
    want = sp.shard_candidates_plain_all(cfg, D, t)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    assert want.best_idx is None
    for a, b in zip(got[4:], sp.combine(want, N)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.best_found.dtype == torch.bool
