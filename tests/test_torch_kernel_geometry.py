"""The host side of the redesigned kernels 1, 3, 4 and 5, on the CPU: how
the round placer's cluster splits the node axis and what shared memory
each block takes, how the dynamic-key placer's cluster splits the jobs and
the nodes, what shared memory each of its blocks takes and the most jobs
it takes, the candidate kernel's grid of split-row blocks, and the
combined triple the sharded cycle reads on the plain route; the wide
candidate kernel's grid, a model of its blocks' partial lists merged and
combined, and the combined lists the wave walk reads on the plain route.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
marked ``cuda``). Imports nothing of JAX.
"""

import math

import pytest
import torch

from volcano_tpu_torch.ops import dyn_placer as dp
from volcano_tpu_torch.ops import round_placer as rp
from volcano_tpu_torch.ops import shard_placer as sp
from volcano_tpu_torch.ops import shard_wave as sw
from volcano_tpu_torch.ops.allocate_scan import (AllocateConfig,
                                                 wave_candidate_depth)
from volcano_tpu_torch.ops.dyn_cases import (PLACER_WEIGHTS, SHARD_CASES,
                                             WAVE_CASES, make_dyn_inputs,
                                             make_shard_inputs,
                                             make_wave_inputs)
from volcano_tpu_torch.ops.round_placer import NEG


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
    """The source's make_plan, term by term: one fold tile of TP =
    min(P, 32) pairs, and one namespace word a job."""
    col, cap, jcap = 2 * R + 1 + G, -(-N // CB), -(-J // CB)
    TP = min(P, 32)
    node = col * cap + M + M * col + 3 * C * M + SK + lists
    queue = 2 * Q * R + 3 * Q + R + S * R + S + 2 * TP * 16 + TP
    jobs = jcap * (NKS + NH + Q + 1 + 1 + R + 4 + TP + 11)
    return (node + queue + jobs) * 4


@pytest.mark.parametrize("shape", [CHECK_B_SHAPE, CHECK_K_SHAPE],
                         ids=["check_B", "check_K"])
@pytest.mark.parametrize("CB", [8, 16])
def test_dyn_shared_bytes_at_the_checked_shapes(shape, CB):
    """Each block's rows fit its 227 KB at both cluster sizes, though the
    job rows of one launch (about 47 words a job) do not fit one SM's."""
    N, J, *rest = shape
    got = dp.shared_bytes(N, J, CB, *rest)
    assert got == plan_bytes(N, J, CB, *rest)
    assert got <= dp.MAX_SHARED < 232448
    assert dp.max_jobs(N, CB, *rest) >= J
    per_job = dp.plan_words(N, CB, *rest)[1]
    assert J * per_job * 4 > 232448


@pytest.mark.parametrize("CB", [8, 16])
def test_dyn_max_jobs_at_check_B_did_not_fall(CB):
    """The namespace word and the fold's one tile of lists take fewer
    words a job than the one-hot rows and a list a pair did: check B's
    shapes take at least the 16,560 jobs they took before."""
    N, J, *rest = CHECK_B_SHAPE
    assert dp.max_jobs(N, 16, *rest) >= 16560
    assert dp.max_jobs(N, CB, *rest) >= J


@pytest.mark.parametrize("S", [4, 32, 64, 1024])
def test_dyn_launch_plan_takes_many_fold_pairs(S):
    """P = S x R fold pairs past the one tile of 32: the launch plan takes
    them (P = 8, 64, 128 and 2,048 at R = 2), and reports the job limit
    of one tile of lists, which does not fall as P grows past 32."""
    kw = dict(drf_job_order=True, drf_ns_order=True, S=S, N=200)
    flags, args = make_dyn_inputs(0, **kw)
    cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
    a = dp.unpack_args(cfg, [torch.from_numpy(x) for x in args])
    R, N, _, C, J, Q, S_, NH, G = dp._shapes(a)
    assert (S_, R) == (S, 2)
    cb, smem = dp.launch_plan(cfg, C, 4, a)
    assert cb == dp.CLUSTER and smem <= dp.MAX_SHARED
    rest = (C, 4, R, G, Q, S, S * R, a.skeys.shape[0], NH)
    jmax = dp.max_jobs(N, cb, *rest)
    assert smem == plan_bytes(N, J, cb, *rest)
    assert jmax >= J and dp.plan_words(N, cb, *rest)[1] == (
        a.skeys.shape[0] + NH + Q + 2 + R + 4 + min(S * R, 32) + 11)
    if S * R >= 32:
        # the fold's per-job words stop growing at one tile
        assert dp.plan_words(N, cb, *rest)[1] == dp.plan_words(
            N, cb, C, 4, R, G, Q, 16, 32, a.skeys.shape[0], NH)[1]


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


# ---- kernel 5: the split-row grid, its partials' merge and the combine -----

@pytest.mark.parametrize("D,NL,W,want", [
    # check I: one shard of 10,240 rows, 8 columns: 320 blocks, not 8
    (1, 10240, 8, (40, 8, 1)),
    (4, 2560, 8, (10, 8, 4)),
    (4, 300, 16, (2, 16, 4)),
    (2, 48, 4, (1, 4, 2)),
    (1, 1, 1, (1, 1, 1))])
def test_wave_grid_shape(D, NL, W, want):
    assert sw.grid_shape(D, NL, W) == want
    assert sw.THREADS == sp.grid_geometry()[1] == 256


def test_wave_output_buffer_layout():
    """One buffer holds the nine fields of WaveCandidates in their order,
    each right after the one before it at a multiple of 4 bytes (the found
    flags a byte each); a block's partial is 36 words; the launcher's
    pointer array holds the node-axis inputs and the scratch."""
    D, W, C = 4, 16, 8
    layout, nbytes = sw.output_layout(D, W, C)
    want = [(torch.float32, (2, D * C, W)), (torch.int32, (2, D * C, W)),
            (torch.int32, (2, D, W)), (torch.int32, (2, D, W)),
            (torch.int32, (2, W, C)), (torch.float32, (2, W, C)),
            (torch.bool, (2, W, C)), (torch.int32, (2, W)),
            (torch.int32, (2, W))]
    assert [(dt, shape) for dt, shape, _ in layout] == want
    at = 0
    for dt, shape, off in layout:
        assert off == at and off % 4 == 0
        at += -(-math.prod(shape) * dt.itemsize // 4) * 4
    assert nbytes == at
    assert sw.output_layout(1, 1, 1)[1] == 8 * 8 + 4
    assert sw.PART_BYTES == 4 * (2 * 2 * sw.MAX_C + 4) == 144
    assert sw.N_PTRS == len(sw.WaveArgs._fields) - 2 + 2
    assert sw.NODE_ARGS == sw.WaveArgs._fields[2:]
    assert sw.FIELD_DTYPES == tuple(dt for dt, _ in want)


@pytest.mark.parametrize("gpu", [False, True])
def test_wave_launch_pointers_follow_the_launcher_slots(gpu):
    """The launcher's pointer array holds the node-axis fields in
    WaveArgs's order, a null pointer for each GPU entry the arguments do
    not carry, then the scratch; its length is N_PTRS."""
    cfg = AllocateConfig(enable_gpu=gpu, **PLACER_WEIGHTS)
    t = [torch.from_numpy(x) for x in make_wave_inputs(0, D=2, W=4,
                                                       gpu=gpu)]
    a = sw.unpack_args(cfg, t)
    part, ticket = torch.zeros(4), torch.zeros(2)
    got = sw.launch_pointers(a, part, ticket)
    assert len(got) == sw.N_PTRS
    want = [getattr(a, f) for f in sw.NODE_ARGS]
    assert [x is None for x in want] == [
        not gpu and f in ("gidle0", "gpux") for f in sw.NODE_ARGS]
    assert list(got) == [x.data_ptr() if x is not None else None
                         for x in want] + [part.data_ptr(),
                                           ticket.data_ptr()]
    assert [p for p in got[:-2] if p is not None] == [
        x.data_ptr() for x in t[2:]]


@pytest.mark.parametrize("D,W,C", [(1, 8, 8), (4, 16, 8), (2, 3, 3)])
def test_wave_output_layout_views_the_buffer(D, W, C):
    """The wrapper's views of the buffer cover it without overlap, in the
    order, dtype and shape of WaveCandidates's fields."""
    layout, nbytes = sw.output_layout(D, W, C)
    buf = torch.zeros(nbytes, dtype=torch.uint8)
    got = [buf.view(dt).as_strided(
        shape, [math.prod(shape[i + 1:]) for i in range(len(shape))],
        at // dt.itemsize) for dt, shape, at in layout]
    for k, g in enumerate(got):
        g.view(torch.uint8).fill_(k + 1)
    used = buf[buf > 0]
    assert used.numel() == sum(g.numel() * g.element_size() for g in got)
    for k, (g, (dt, shape, at)) in enumerate(zip(got, layout)):
        assert g.dtype == dt and g.shape == shape and g.is_contiguous()
        assert g.data_ptr() == buf.data_ptr() + at
        assert bool((g.view(torch.uint8) == k + 1).all())
    assert [f.dtype for f in got[4:]] == [torch.int32, torch.float32,
                                          torch.bool, torch.int32,
                                          torch.int32]


def ordered(score, rows, ok):
    """Positions of the entries ``ok`` of 1-D ``score`` / ``rows`` in the
    kernel's order (score desc, then row asc), then the rest."""
    by_row = torch.sort(torch.where(ok, rows, torch.iinfo(torch.int32).max),
                        stable=True).indices
    key = torch.where(ok, score, float("-inf"))[by_row]
    return by_row[torch.sort(key, descending=True, stable=True).indices]


def block_partials(score, feas, off, ROWS, C):
    """Each block of ROWS rows of one shard's column (the last one short):
    its top C entries (score, global row) by the kernel's order, its
    feasible count and the raw ties at its best, as its last warp writes
    them."""
    parts = []
    for lo in range(0, score.shape[0], ROWS):
        s, f = score[lo:lo + ROWS], feas[lo:lo + ROWS]
        rows = torch.arange(lo, lo + s.shape[0], dtype=torch.int32) + off
        n = int(f.sum())
        top = ordered(s, rows, f)[:min(C, n)]
        best = s[top[0]] if n else None
        ties = int((f & (s == best)).sum()) if n else 0
        parts.append((s[top], rows[top], n, ties))
    return parts


def merge_lists(lists, C):
    """Lists (score, row, count, ties) merged into one as a merge step of
    the kernel does: the first C of all entries in the kernel's order, the
    counts summed, and the ties summed over the lists whose best is the
    merged best."""
    s = torch.cat([p[0] for p in lists])
    r = torch.cat([p[1] for p in lists])
    cnt = sum(p[2] for p in lists)
    top = ordered(s, r, torch.ones_like(r, dtype=torch.bool))[:min(C, cnt)]
    best = s[top[0]] if cnt else None
    ties = sum(p[3] for p in lists if p[2] and p[0][0] == best)
    return s[top], r[top], cnt, ties


def merge_tree(lists, C, group=8):
    """The last block's tree: groups of ``group`` lists merged, level by
    level, until one list is left."""
    while True:
        lists = [merge_lists(lists[g:g + group], C)
                 for g in range(0, len(lists), group)]
        if len(lists) == 1:
            return lists[0]


def padded(lst, C, sentinel):
    """A list's C entries as the kernel writes them: NEG and ``sentinel``
    past its count."""
    s, r, cnt, ties = lst
    sc = torch.full((C,), NEG, dtype=torch.float32)
    ix = torch.full((C,), sentinel, dtype=torch.int32)
    sc[:s.shape[0]], ix[:s.shape[0]] = s, r
    return sc, ix, cnt, ties


def split_row_model(cfg, D, C, args, ROWS, group=8):
    """The kernel's lists from its blocks' partials: rows evaluated as the
    plain version evaluates them (``shard_placer.shard_scores`` a
    column), cut into blocks of ROWS, merged shard by shard in the last
    block's tree of groups of ``group``, and the shards' lists merged the
    same way; in the kernel's output layout."""
    a = sw.unpack_args(cfg, args)
    N, W = a.idle.shape[1], a.req.shape[1]
    NL = N // D
    score = torch.empty((2, D * C, W), dtype=torch.float32)
    idx = torch.empty((2, D * C, W), dtype=torch.int32)
    count = torch.empty((2, D, W), dtype=torch.int32)
    ties = torch.empty((2, D, W), dtype=torch.int32)
    e_idx = torch.empty((2, W, C), dtype=torch.int32)
    e_score = torch.empty((2, W, C), dtype=torch.float32)
    e_found = torch.empty((2, W, C), dtype=torch.bool)
    e_count = torch.empty((2, W), dtype=torch.int32)
    e_ties = torch.empty((2, W), dtype=torch.int32)
    shards = [sw.wave_args_of(cfg, D, a, d) for d in range(D)]
    for w in range(W):
        for v in range(2):
            lists = []
            for d, shard in enumerate(shards):
                sc, fn, ff, _, _ = sp.shard_scores(
                    cfg, NL, sw.column_args(cfg, shard, w))
                feas = (fn, ff)[v]
                parts = block_partials(sc[0], feas[0], d * NL, ROWS, C)
                lists.append(merge_tree(parts, C, group))
                s, i, n, t = padded(lists[-1], C, (d + 1) * NL)
                score[v, d * C:(d + 1) * C, w] = s
                idx[v, d * C:(d + 1) * C, w] = i
                count[v, d, w], ties[v, d, w] = n, t
            comb = merge_tree(lists, C, group)
            s, i, n, t = padded(comb, C, N)
            e_score[v, w], e_idx[v, w] = s, i
            e_found[v, w] = torch.arange(C) < comb[0].shape[0]
            e_count[v, w], e_ties[v, w] = n, t
    return sw.WaveCandidates(score, idx, count, ties, e_idx, e_score,
                             e_found, e_count, e_ties)


def same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("W", [1, 4, 8, 16])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(WAVE_CASES))
def test_split_row_merge_model_is_the_plain_version(case, D, W):
    """Shards of 300 rows at 128, 256 and 512 rows a block (3 blocks with a
    short last one, 2, and one longer than the shard): the blocks' partial
    top-C lists merged in the last block's tree (groups of 8; of 2 too, so
    that the tree has several levels) give the plain version's lists, and
    the shards' lists merged the same way give ``combine`` of them,
    bitwise; W = 16 columns hold more slots than the depth C = 8, and the
    ties case repeats four rows across the blocks."""
    cfg = AllocateConfig(enable_gpu=True, **PLACER_WEIGHTS)
    C = wave_candidate_depth(W)
    t = [torch.from_numpy(x) for x in make_wave_inputs(
        2, D=D, W=W, NL=300, gpu=True, **WAVE_CASES[case])]
    N = t[-1].shape[1]
    want = sw.shard_wave_plain_all(cfg, D, C, t)
    combined = sw.combine(want, C, N)
    for ROWS, group in ((128, 8), (256, 8), (512, 8), (128, 2)):
        got = split_row_model(cfg, D, C, t, ROWS, group)
        assert all(same(g, w) for g, w in zip(got[:4], want[:4])), ROWS
        assert all(same(g, w) for g, w in zip(got[4:], combined)), ROWS


@pytest.mark.parametrize("gpu", [False, True])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(WAVE_CASES))
def test_wave_plain_route_carries_combine(case, D, gpu):
    """The wrapper's plain route returns the per-shard lists of the plain
    version and, beside them, ``combine`` of those lists: what the wave
    walk reads."""
    cfg = AllocateConfig(enable_gpu=gpu, **PLACER_WEIGHTS)
    W, C = 8, 8
    t = [torch.from_numpy(x) for x in
         make_wave_inputs(0, D=D, W=W, gpu=gpu, **WAVE_CASES[case])]
    N = t[-1].shape[1]
    got = sw.shard_wave(cfg, D, C, t)
    want = sw.shard_wave_plain_all(cfg, D, C, t)
    assert all(same(g, w) for g, w in zip(got[:4], want[:4]))
    assert want.e_idx is None and sw.COMBINED == got._fields[4:]
    assert all(same(g, w) for g, w in zip(got[4:], sw.combine(want, C, N)))
    assert got.e_found.dtype == torch.bool
    assert got.e_idx.shape == (2, W, C) and got.e_count.shape == (2, W)
