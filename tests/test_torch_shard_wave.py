"""The port's wide shard-local candidate search (``ops/shard_wave.py``)
against the JAX package's ``make_shard_wave_placer`` in interpret mode, and
the wavefront walk's combine and rescore.

Inputs come from ``volcano_tpu_torch/ops/dyn_cases.make_wave_inputs`` (a
numpy seed): W task columns over D shards. Each shard's slice goes through
the JAX kernel, called directly with the shard's ``off`` (no shard_map),
and through the port's plain version.

The tolerance is 0 everywhere, with ROADMAP section 3 (f)'s rule for the
scores: XLA's CPU backend, which runs the interpret kernel, folds and
contracts the score's float32 arithmetic, so at some rows its score
differs from the reference's source order by an ulp; the port follows
the source order, as its CUDA kernels do. So:

- the feasible counts are held bitwise to the interpret kernel;
- every output is held bitwise to the reference's rule applied to the
  source-order scores (``torch_fixtures.source_order_score``: the
  reference's ``_dyn_score`` run eagerly, then the kernel's adds in
  numpy): each column's feasible rows, which the reference kernel itself
  lists when its depth is the shard's whole row count, ordered by (score
  desc, row asc), the first C with the kernel's fill past the count, and
  the raw ties at the best;
- the rows, ties and scores are held bitwise to the interpret kernel at
  every column where XLA's scores of the feasible rows equal the source
  order's (at a column where they do not, the ulp can reorder two rows or
  split a tie, and only the source-order expectation holds).
"""

import functools

import numpy as np
import pytest
import torch

import jax
from volcano_tpu.ops.allocate_scan import AllocateConfig as JaxConfig
from volcano_tpu.ops.allocate_scan import (wave_candidate_depth as
                                           jax_wave_depth)
from volcano_tpu.ops.pallas_place import make_shard_wave_placer

from torch_fixtures import port_cfg, source_order_score
from volcano_tpu_torch.ops import allocate_scan as tas
from volcano_tpu_torch.ops import shard_placer as sp
from volcano_tpu_torch.ops import shard_wave as sw
from volcano_tpu_torch.ops.dyn_cases import (PLACER_WEIGHTS, WAVE_CASES,
                                             make_wave_inputs)

NEG = np.float32(-1e30)


@functools.lru_cache(maxsize=None)
def jax_placer(cfg, NL, R, G, GR, W, C):
    return jax.jit(make_shard_wave_placer(cfg, NL, R, G, GR, W, C,
                                          interpret=True))


def column(cfg, a: sw.WaveArgs, w):
    """Column w's task as kernel 4's arguments (``ShardArgs``): the source
    order score takes them."""
    return sp.ShardArgs(a.req[:, w][None, :], a.task[:6, w][None, :],
                        a.task[6:7, w][:, None],
                        *[getattr(a, f) for f in sp.NODE_FIELDS])


def shard_column(shard, gpu, w):
    """Shard arguments (reference order) of one column w, W = 1."""
    head = 1 + gpu + 7
    return ([t[:, w:w + 1] for t in shard[:head]] + list(shard[head:]))


def expected_column(jcfg, shard, gpu, NL, R, G, GR, C, w, source, off):
    """Per view: the source-order expectation of column w of one shard
    (scores, rows [C], count, ties), and whether XLA's scores of the
    feasible rows equal the source order's. The feasible rows are the
    reference kernel's own list at depth NL."""
    full = [np.asarray(o) for o in jax_placer(jcfg, NL, R, G, GR, 1, NL)(
        *[t.numpy() for t in shard_column(shard, gpu, w)])]
    views = []
    for v in range(2):
        sc, ix, n = full[4 * v][:, 0], full[4 * v + 1][:, 0], full[4 * v + 2]
        n = int(n[0, 0])
        rows = ix[:n]
        s = source[rows - off]
        order = np.lexsort((rows, -s.astype(np.float64)))[:C]
        e_s = np.full(C, NEG, np.float32)
        e_i = np.full(C, off + NL, np.int32)
        e_s[:len(order)] = s[order]
        e_i[:len(order)] = rows[order]
        ties = int((s == s.max()).sum()) if n else 0
        same = bool((sc[:n].view(np.int32) == s.view(np.int32)).all())
        views.append((e_s, e_i, n, ties, same))
    return views


def compare(seed, D, W, gpu, weights, **knobs):
    """Every shard of one built input through the interpret kernel and the
    plain version, held as the module docstring says. Returns the number
    of columns where XLA's scores left the source order."""
    C = tas.wave_candidate_depth(W)
    args = [torch.from_numpy(x) for x in
            make_wave_inputs(seed, D=D, W=W, gpu=gpu, **knobs)]
    jcfg = JaxConfig(enable_gpu=gpu, **weights)
    cfg = port_cfg(jcfg)
    a = sw.unpack_args(cfg, args)
    R, N = a.idle.shape
    G = a.gidle0.shape[0] if gpu else 0
    GR = a.orfeas.shape[0]
    NL = N // D
    ref = jax_placer(jcfg, NL, R, G, GR, W, C)
    sources = [source_order_score(jcfg, column(cfg, a, w)) for w in range(W)]
    moved = 0
    for d in range(D):
        shard = sw.wave_args_of(cfg, D, a, d)
        want = [np.asarray(o) for o in ref(*[t.numpy() for t in shard])]
        got = [g.numpy() for g in sw.shard_wave_plain(cfg, NL, R, G, GR, W,
                                                      C, shard)]
        for k, (g, x) in enumerate(zip(got, want)):
            assert g.dtype == x.dtype and g.shape == x.shape, k
        for w in range(W):
            exp = expected_column(jcfg, shard, gpu, NL, R, G, GR, C, w,
                                  sources[w][d * NL:(d + 1) * NL],
                                  d * NL)
            for v, (e_s, e_i, n, ties, same) in enumerate(exp):
                sc, ix, cn, ti = (got[4 * v + k][:, w] for k in range(4))
                assert cn[0] == n == want[4 * v + 2][0, w], (d, w, v)
                assert (sc.view(np.int32) == e_s.view(np.int32)).all(), \
                    (d, w, v)
                assert (ix == e_i).all() and ti[0] == ties, (d, w, v)
                if same:
                    for k in (0, 1, 3):
                        assert (got[4 * v + k][:, w].view(np.int32)
                                == want[4 * v + k][:, w].view(np.int32)
                                ).all(), (d, w, v, k)
                else:
                    moved += 1
    return moved


def test_candidate_depth_is_the_references():
    for W in (0, 1, 2, 4, 7, 8, 9, 16, 64):
        assert tas.wave_candidate_depth(W) == jax_wave_depth(W)


@pytest.mark.parametrize("gpu", [False, True])
@pytest.mark.parametrize("W", [1, 4, 8, 16])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(WAVE_CASES))
def test_plain_matches_interpret_kernel(case, D, W, gpu):
    compare(0, D, W, gpu, PLACER_WEIGHTS, **WAVE_CASES[case])


def test_score_order_moves_are_the_reported_fault():
    """Columns where only the source-order expectation holds exist in these
    inputs, so the rule above is exercised (ROADMAP section 3 (f))."""
    assert compare(0, 4, 16, False, PLACER_WEIGHTS) > 0


def test_cases_hit_what_they_plant():
    """No row is feasible in ``nothing_feasible`` (every entry is NEG and
    the shard's sentinel); each shard holds fewer feasible rows than the
    depth in ``fewer_than_depth``; ties span shards in
    ``ties_across_shards``."""
    cfg = port_cfg(JaxConfig(enable_gpu=True, **PLACER_WEIGHTS))
    D, W, C = 4, 8, 8

    def run(case, seed=0):
        args = [torch.from_numpy(x) for x in make_wave_inputs(
            seed, D=D, W=W, gpu=True, **WAVE_CASES[case])]
        return sw.shard_wave(cfg, D, C, args), args[-1].shape[1] // D
    c, NL = run("nothing_feasible")
    assert int(c.count.sum()) == 0 and int(c.ties.sum()) == 0
    assert (c.score == NEG).all()
    want = torch.arange(D).repeat_interleave(C)[:, None] * NL + NL
    assert (c.idx == want.to(torch.int32)).all()
    c, _ = run("fewer_than_depth")
    assert 0 < int(c.count.max()) <= 2 < C
    c, _ = run("ties_across_shards")
    e_i, e_v, e_o, cnt, ties = sw.combine(c, C, D * NL)
    at_best = (c.count > 0) & (c.score[:, 0::C] == e_v[:, :, 0][:, None, :])
    assert (at_best.sum(1) > 1).any() and (ties > 1).any()


@pytest.mark.parametrize("case", ["mixed", "ties_across_shards",
                                  "infeasible_shard", "nothing_feasible",
                                  "fewer_than_depth"])
@pytest.mark.parametrize("D", [2, 4])
def test_combine_is_the_full_axis_top_c(case, D):
    """The combine of D shards' lists equals one shard's list over the full
    axis, entry for entry, with the same counts and raw ties."""
    cfg = port_cfg(JaxConfig(enable_gpu=True, **PLACER_WEIGHTS))
    W, C = 8, 8
    args = [torch.from_numpy(x) for x in make_wave_inputs(
        5, D=D, W=W, gpu=True, **WAVE_CASES[case])]
    N = args[-1].shape[1]
    got = sw.combine(sw.shard_wave(cfg, D, C, args), C, N)
    e_i, e_v, e_o, cnt, ties = sw.combine(sw.shard_wave(cfg, 1, C, args), C,
                                          N)
    assert torch.equal(got[0], e_i) and torch.equal(got[2], e_o)
    assert torch.equal(got[1].view(torch.int32), e_v.view(torch.int32))
    assert torch.equal(got[3], cnt) and torch.equal(got[4], ties)
    # the one-shard list holds its entries within the count, then the full
    # axis's sentinel
    assert torch.equal(e_o, torch.arange(C) < cnt[:, :, None])
    assert (e_i[~e_o] == N).all()


@pytest.mark.parametrize("gpu", [False, True])
@pytest.mark.parametrize("case", sorted(WAVE_CASES))
def test_rescore_gives_the_kernels_bits(case, gpu):
    """At the window-start state the rescore of every row equals the plain
    kernel's feasibility and score rows bitwise (``shard_scores``), and so
    the listed entries' scores."""
    cfg = port_cfg(JaxConfig(enable_gpu=gpu, **PLACER_WEIGHTS))
    W, C = 8, 8
    args = [torch.from_numpy(x) for x in make_wave_inputs(
        2, D=1, W=W, gpu=gpu, **WAVE_CASES[case])]
    a = sw.unpack_args(cfg, args)
    R, N = a.idle.shape
    env = sp.ShardArgs(None, None, None,
                       *[getattr(a, f) for f in sp.NODE_FIELDS])
    rows = torch.arange(N)[None, :]
    gq = a.req[R] if gpu else None
    maps = sw.row_maps(env, a.gidle0 if gpu else None)
    v = sw.gather_rows(maps, rows, a.task[1].long(),
                       a.task[2].long().clamp_min(0), a.idle, a.pipe, a.pods,
                       a.gpux)
    ok_n, ok_f, score = sw.rescore(cfg, v, rows, a.req[:R], a.task, gq)
    lists = sw.shard_wave(cfg, 1, C, args)
    shard = sw.wave_args_of(cfg, 1, a, 0)
    for w in range(W):
        s_w, fn, ff, _, _ = sp.shard_scores(cfg, N, shard_column(shard, gpu,
                                                                  w))
        assert torch.equal(score[w].view(torch.int32),
                           s_w[0].view(torch.int32)), w
        assert torch.equal(ok_n[w], fn[0]) and torch.equal(ok_f[w], ff[0])
        for view, ok in ((0, ok_n), (1, ok_f)):
            n = int(lists.count[view, 0, w])
            rows_w = lists.idx[view, :n, w].long()
            assert ok[w, rows_w].all()
            assert torch.equal(score[w, rows_w].view(torch.int32),
                               lists.score[view, :n, w].view(torch.int32))


def test_resolve_picks_the_untouched_entry_or_a_better_touched_row():
    """The first untouched entry wins unless a touched row rescored above
    it (or equal and lower); an exhausted list is undecidable only when
    more rows were feasible than it holds."""
    N, C = 100, 3
    e_i = torch.tensor([[5, 9, 2], [5, 9, 2]], dtype=torch.int32)
    e_v = torch.tensor([[9.0, 8.0, 8.0], [9.0, 8.0, 8.0]])
    e_o = torch.ones((2, C), dtype=torch.bool)
    touched = torch.tensor([5, 40, N], dtype=torch.int32)
    t_ok = torch.tensor([[True, True, False], [True, False, False]])
    t_s = torch.tensor([7.0, 8.0, 0.0])
    win, found, dec = sw.resolve(e_i, e_v, e_o, torch.tensor([3, 7]),
                                 touched, t_ok, t_s, C, N)
    # now view: entry 1 (row 9, 8.0) ties touched row 40 at 8.0 -> row 9
    # future view: touched row 40 is not feasible -> entry 1, row 9
    assert win.tolist() == [9, 9] and found.all() and dec.all()
    t_s = torch.tensor([7.0, 8.5, 0.0])
    win, _, _ = sw.resolve(e_i, e_v, e_o, torch.tensor([3, 7]), touched,
                           t_ok, t_s, C, N)
    assert win.tolist() == [40, 9]
    # every entry touched: decidable only with count <= C
    all_t = torch.tensor([5, 9, 2], dtype=torch.int32)
    win, found, dec = sw.resolve(e_i, e_v, e_o, torch.tensor([3, 4]), all_t,
                                 torch.ones((2, 3), dtype=torch.bool),
                                 torch.tensor([1.0, 3.0, 2.0]), C, N)
    assert dec.tolist() == [True, False] and win.tolist() == [9, 9]


def test_wrapper_refuses_wrong_layouts():
    cfg = port_cfg(JaxConfig(enable_gpu=False, **PLACER_WEIGHTS))
    args = [torch.from_numpy(x) for x in make_wave_inputs(0, D=2, W=4)]
    with pytest.raises(ValueError, match="do not split"):
        sw.shard_wave(cfg, 5, 4, args)
    with pytest.raises(ValueError, match="depth"):
        sw.shard_wave(cfg, 2, 9, args)
    bad = list(args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(ValueError, match="task"):
        sw.shard_wave(cfg, 2, 4, bad)
    with pytest.raises(ValueError, match="too many"):
        sw.shard_wave(cfg, 2, 4, args + [args[-1]])
