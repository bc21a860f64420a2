"""The host side of the redesigned kernels 1, 3 and 4, on the CPU: how the
round placer's cluster splits the node axis and what shared memory each
block takes, how the dynamic-key placer's cluster splits the jobs and the
nodes, what shared memory each of its blocks takes and the most jobs it
takes, the candidate kernel's grid of split-row blocks, and the combined
triple the sharded cycle reads on the plain route.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
marked ``cuda``). Imports nothing of JAX.
"""

import pytest
import torch

from volcano_tpu_torch.ops import dyn_placer as dp
from volcano_tpu_torch.ops import round_placer as rp
from volcano_tpu_torch.ops import shard_placer as sp
from volcano_tpu_torch.ops.allocate_scan import AllocateConfig
from volcano_tpu_torch.ops.dyn_cases import (PLACER_WEIGHTS, SHARD_CASES,
                                             make_dyn_inputs,
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


# ---- kernel 3: the cluster's job and node slices, shared memory ------------

@pytest.mark.parametrize("J,CB", [(4096, 16), (4096, 8), (5120, 16),
                                  (5120, 8), (1000, 16), (24, 16), (5, 8),
                                  (10000, 8)])
def test_job_slices_cover_the_jobs_once(J, CB):
    """Kernel 3 splits the jobs as kernel 1 splits the nodes: contiguous
    runs in rank order that cover [0, J) once, ceil(J / CB) long but the
    last; the kernel's owner of job j is j // ceil(J / CB)."""
    slices = rp.cluster_slices(J, CB)
    jcap = -(-J // CB)
    assert len(slices) == CB
    pos = 0
    for r, (lo, hi) in enumerate(slices):
        assert lo == min(pos, J) and lo <= hi <= lo + jcap
        assert all(j // jcap == r for j in range(lo, hi))
        pos = hi
    assert pos == J


#: check B's and check K's launch shapes (scripts/dyn_phase_split.py on
#: the card): N, J, C, M, R, G, Q, S, P (S x R fold pairs), NKS, NH
CHECK_B_SHAPE = (1024, 4096, 8, 16, 2, 0, 16, 4, 8, 4, 0)
CHECK_K_SHAPE = (1024, 5120, 8, 16, 2, 0, 16, 4, 8, 5, 0)


def plan_bytes(N, J, CB, C, M, R, G, Q, S, P, NKS, NH, SK=0, lists=0):
    """The source's make_plan, term by term."""
    col, cap, jcap = 2 * R + 1 + G, -(-N // CB), -(-J // CB)
    node = col * cap + M + M * col + 3 * C * M + SK + lists
    queue = 2 * Q * R + 3 * Q + R + S * R + S + 2 * P * 16 + P
    jobs = jcap * (NKS + NH + Q + 2 * S + 1 + R + 4 + P + 11)
    return (node + queue + jobs) * 4


@pytest.mark.parametrize("shape", [CHECK_B_SHAPE, CHECK_K_SHAPE],
                         ids=["check_B", "check_K"])
@pytest.mark.parametrize("CB", [8, 16])
def test_dyn_shared_bytes_at_the_checked_shapes(shape, CB):
    """Each block's rows fit its 227 KB at both cluster sizes, though the
    job rows of one launch (about 55 words a job) do not fit one SM's."""
    N, J, *rest = shape
    got = dp.shared_bytes(N, J, CB, *rest)
    assert got == plan_bytes(N, J, CB, *rest)
    assert got <= dp.MAX_SHARED < 232448
    assert dp.max_jobs(N, CB, *rest) >= J
    per_job = dp.plan_words(N, CB, *rest)[1]
    assert J * per_job * 4 > 232448


def test_dyn_shared_bytes_with_affinity_and_gpu_cards():
    assert dp.shared_bytes(200, 300, 16, 4, 4, 2, 2, 3, 0, 0, 5, 4, SK=6,
                           list_ints=20) == plan_bytes(
        200, 300, 16, 4, 4, 2, 2, 3, 0, 0, 5, 4, SK=6, lists=20)


@pytest.mark.parametrize("CB", [8, 16])
def test_dyn_launch_plan_raises_past_the_most_jobs(CB):
    """The wrapper's check, on the CPU: J at max_jobs fits a block's shared
    memory, one job more raises naming the limit."""
    kw = dict(drf_job_order=True, drf_ns_order=True, S=3, N=200)
    flags, small = make_dyn_inputs(0, **kw)
    cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
    a = dp.unpack_args(cfg, [torch.from_numpy(x) for x in small])
    R, N, _, C, _, Q, S, NH, G = dp._shapes(a)
    jmax = dp.max_jobs(N, CB, C, 4, R, G, Q, S, S * R, a.skeys.shape[0],
                       NH)
    assert jmax % CB == 0 and jmax > 4096
    for J in (jmax, jmax + 1):
        _, args = make_dyn_inputs(0, J=J, **kw)
        a = dp.unpack_args(cfg, [torch.from_numpy(x) for x in args])
        if J == jmax:
            cb, smem = dp.launch_plan(cfg, C, 4, a, CB)
            assert cb == CB and smem <= dp.MAX_SHARED
            assert dp.shared_bytes(N, J + CB, CB, C, 4, R, G, Q, S, S * R,
                                   a.skeys.shape[0], NH) > dp.MAX_SHARED
        else:
            with pytest.raises(ValueError, match=f"J <= {jmax}"):
                dp.launch_plan(cfg, C, 4, a, CB)


def test_dyn_launch_plan_checks_the_cluster():
    flags, args = make_dyn_inputs(0, drf_job_order=True)
    cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
    a = dp.unpack_args(cfg, [torch.from_numpy(x) for x in args])
    assert dp.launch_plan(cfg, 4, 4, a)[0] == dp.CLUSTER
    assert 1 <= dp.CLUSTER <= dp.MAX_CB and dp.DIMS[-1] == "CB"
    for bad in (0, dp.MAX_CB + 1):
        with pytest.raises(ValueError, match="clusters"):
            dp.launch_plan(cfg, 4, 4, a, bad)


@pytest.mark.parametrize("case", ["drf_ns3", "aff"])
def test_dyn_launch_plan_takes_the_checked_plan(case):
    """The key plan _check returns and the affinity dims, handed to
    launch_plan, give what launch_plan finds on its own."""
    kw = (dict(drf_job_order=True, drf_ns_order=True, S=3) if case != "aff"
          else dict(drf_job_order=True, aff={}))
    flags, args = make_dyn_inputs(0, **kw)
    cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
    a = dp.unpack_args(cfg, [torch.from_numpy(x) for x in args])
    plan = dp._check(cfg, 4, 12, 4, a)
    assert plan == dp.key_plan(cfg, dp._shapes(a)[7])[0]
    for cb in (8, 16):
        assert (dp.launch_plan(cfg, 4, 4, a, cb, plan, rp.aff_dims(a))
                == dp.launch_plan(cfg, 4, 4, a, cb))


@pytest.mark.parametrize("rc,match", [(rp.NO_CLUSTER, "cluster of 16"),
                                      (rp.STATIC_OVER, "static shared"),
                                      (700, "CUDA error 700")])
def test_raise_launch_names_each_code(rc, match):
    """Each code a cluster launcher returns raises, naming its cause."""
    assert rp.STATIC_OVER != rp.NO_CLUSTER and rp.STATIC_OVER < 0
    with pytest.raises(RuntimeError, match=match):
        rp.raise_launch(rc, "dyn_placer", 16)
    rp.raise_launch(0, "dyn_placer", 16)


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
