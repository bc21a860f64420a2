"""The port's shard-local candidate search (``ops/shard_placer.py``) against
the JAX package's ``make_shard_candidate_placer`` in interpret mode.

Inputs come from ``volcano_tpu_torch/ops/dyn_cases.make_shard_inputs`` (a
numpy seed). Each shard's slice goes through the JAX kernel, called
directly with the shard's ``off`` (no shard_map), and through the port's
plain version. The rows, found flags and raw tie counts must be bitwise
equal. The scores are held to the reference's arithmetic as written: XLA's
CPU backend, which runs the interpret kernel,
folds ``(w * raw) * 100`` into ``raw * (w * 100)`` and contracts a
product into the next add as a fused multiply-add, so at some rows its
score differs from the source order by an ulp (ROADMAP section 3 (f));
the port follows the source order, as its CUDA kernels do. So each score
output is held bitwise against the reference's formula evaluated
operation by operation (its own ``_dyn_score`` run eagerly, then the
kernel's adds in numpy) at the winning row. The cross-shard combine must
then give the full axis's ``best_node`` and raw tie count.
"""

import functools

import numpy as np
import pytest
import torch

import jax
from volcano_tpu.ops.allocate_scan import AllocateConfig as JaxConfig
from volcano_tpu.ops.pallas_place import make_shard_candidate_placer
from volcano_tpu.ops.select import tie_count as jax_tie_count

from torch_fixtures import port_cfg, source_order_score
from volcano_tpu_torch.ops import select as tsel
from volcano_tpu_torch.ops import shard_placer as sp
from volcano_tpu_torch.ops.dyn_cases import (PLACER_WEIGHTS, SHARD_CASES,
                                             make_shard_inputs)

#: one score family at a time at weight 1 (binpack is the north star's),
#: then every family at once at the placer cases' weights
FAMILIES = {
    "binpack": dict(binpack_weight=1.0, least_allocated_weight=0.0,
                    most_allocated_weight=0.0, balanced_weight=0.0),
    "least": dict(binpack_weight=0.0, least_allocated_weight=1.0,
                  most_allocated_weight=0.0, balanced_weight=0.0),
    "most": dict(binpack_weight=0.0, least_allocated_weight=0.0,
                 most_allocated_weight=1.0, balanced_weight=0.0),
    "balanced": dict(binpack_weight=0.0, least_allocated_weight=0.0,
                     most_allocated_weight=0.0, balanced_weight=1.0),
    "all": PLACER_WEIGHTS,
}


@functools.lru_cache(maxsize=None)
def jax_placer(cfg, NL, R, G, GR):
    return jax.jit(make_shard_candidate_placer(cfg, NL, R, G, GR,
                                               interpret=True))


def compare(seed, D, gpu, weights, **knobs):
    """Every shard of one built input through the interpret kernel and the
    plain version."""
    args = [torch.from_numpy(x) for x in
            make_shard_inputs(seed, D=D, gpu=gpu, **knobs)]
    jcfg = JaxConfig(enable_gpu=gpu, **weights)
    cfg = port_cfg(jcfg)
    a = sp.unpack_args(cfg, args)
    R, N = a.idle.shape
    G = a.gidle0.shape[0] if gpu else 0
    GR = a.orfeas.shape[0]
    NL = N // D
    ref = jax_placer(jcfg, NL, R, G, GR)
    source = source_order_score(jcfg, a)
    for d in range(D):
        shard = sp.shard_args_of(cfg, D, a, d)
        want = [np.asarray(o) for o in ref(*[t.numpy() for t in shard])]
        got = [g.numpy() for g in sp.shard_candidates_plain(
            cfg, NL, R, G, GR, shard)]
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and g.shape == w.shape == (1, 1), k
            if k % 4:       # row, found flag, raw ties
                assert g[0, 0] == w[0, 0], (d, k)
        for v in range(2):
            sc, ix, fn = got[4 * v], got[4 * v + 1][0, 0], got[4 * v + 2][0, 0]
            at = source[ix] if fn else np.float32(sp.NEG)
            assert sc.view(np.int32)[0, 0] == np.float32(at).view(np.int32), \
                (d, v)


@pytest.mark.parametrize("gpu", [False, True])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_plain_matches_interpret_kernel(case, D, gpu):
    compare(0, D, gpu, PLACER_WEIGHTS, **SHARD_CASES[case])


@pytest.mark.parametrize("gpu", [False, True])
@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_score_families_match_interpret_kernel(family, D, gpu):
    compare(3, D, gpu, FAMILIES[family])


def test_cases_hit_what_they_plant():
    """The built cases do what they are named for: ties span shards, the
    infeasible shard reports no row, and nothing is feasible in
    ``nothing_feasible`` (then the index is the shard's first row and the
    count 0, as in the reference)."""
    cfg = port_cfg(JaxConfig(enable_gpu=False, **PLACER_WEIGHTS))
    D = 4
    args = [torch.from_numpy(a) for a in
            make_shard_inputs(0, D=D, **SHARD_CASES["ties_across_shards"])]
    c = sp.shard_candidates(cfg, D, args)
    at = (c.found[0] > 0) & (c.score[0] == c.score[0].max())
    assert int(at.sum()) > 1 and int(c.ties[0][at].sum()) > int(at.sum())
    args = [torch.from_numpy(a) for a in
            make_shard_inputs(1, D=D, **SHARD_CASES["infeasible_shard"])]
    c = sp.shard_candidates(cfg, D, args)
    assert int(c.found[:, 1].sum()) == 0 and int(c.found[0].sum()) > 0
    args = [torch.from_numpy(a) for a in
            make_shard_inputs(2, D=D, **SHARD_CASES["nothing_feasible"])]
    c = sp.shard_candidates(cfg, D, args)
    NL = args[-1].shape[1] // D
    assert int(c.found.sum()) == 0 and int(c.ties.sum()) == 0
    assert c.idx[0].tolist() == [d * NL for d in range(D)]
    assert (c.score == np.float32(-1e30)).all()


@pytest.mark.parametrize("case", ["mixed", "ties_across_shards",
                                  "infeasible_shard", "nothing_feasible"])
@pytest.mark.parametrize("D", [2, 4])
def test_combine_is_the_full_axis_pick(case, D):
    """The combine of D shards equals the one-shard search over the full
    axis: the same winner and found flag, the same raw tie count, and
    ``max(raw - 1, 0)`` is ``tie_count`` over the full axis (JAX's and the
    port's)."""
    cfg = port_cfg(JaxConfig(enable_gpu=True, **PLACER_WEIGHTS))
    args = [torch.from_numpy(a) for a in
            make_shard_inputs(5, D=D, gpu=True, **SHARD_CASES[case])]
    N = args[-1].shape[1]
    idx, found, raw = sp.combine(sp.shard_candidates(cfg, D, args), N)
    one = sp.shard_candidates(cfg, 1, args)
    assert idx.tolist() == torch.where(one.found[:, 0] > 0, one.idx[:, 0],
                                       0).tolist()
    assert found.tolist() == (one.found[:, 0] > 0).tolist()
    assert raw.tolist() == one.ties[:, 0].tolist()
    # tie_count over the full axis, JAX's and the port's
    a = sp.unpack_args(cfg, args)
    score, *feas = sp.shard_scores(cfg, N, sp.shard_args_of(cfg, 1, a, 0))[:3]
    for v in range(2):
        want = int(jax_tie_count(score[0].numpy(), feas[v][0].numpy()))
        assert int(tsel.tie_count(score[0], feas[v][0])) == want
        assert max(int(raw[v]) - 1, 0) == want


def test_wrapper_refuses_wrong_layouts():
    cfg = port_cfg(JaxConfig(enable_gpu=False, **PLACER_WEIGHTS))
    args = [torch.from_numpy(a) for a in make_shard_inputs(0, D=2)]
    with pytest.raises(ValueError, match="do not split"):
        sp.shard_candidates(cfg, 5, args)
    bad = list(args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(ValueError, match="task"):
        sp.shard_candidates(cfg, 2, bad)
    with pytest.raises(ValueError, match="too many"):
        sp.shard_candidates(cfg, 2, args + [args[-1]])
