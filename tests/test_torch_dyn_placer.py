"""The port's dynamic-key placer against the JAX Pallas kernel, bit for bit.

The same numpy inputs, made from a seed (``torch_fixtures.make_dyn_inputs``:
candidates chosen as the cycle chooses them), go through
``volcano_tpu.ops.pallas_place.make_dyn_round_placer(..., interpret=True)``
and through ``volcano_tpu_torch.ops.dyn_placer.dyn_place_plain``; all 20
outputs (slot decisions, node state, per-job rows, job and queue
allocations, pops, progressed) must be bitwise equal. The CUDA kernel is
held against the plain version by the test marked ``cuda`` below, on a
machine with a card. JAX is imported inside the tests that use it, so that
test runs where JAX is not installed:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_dyn_placer.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_fixtures import DYN_CASES, PLACER_WEIGHTS, make_dyn_inputs
from volcano_tpu_torch.ops import dyn_placer as dp
from volcano_tpu_torch.ops.allocate_scan import AllocateConfig


def case_inputs(case, seed):
    """(the port's cfg, C, KP, M, numpy args) of one built case."""
    flags, args = make_dyn_inputs(seed, **DYN_CASES[case])
    return AllocateConfig(**PLACER_WEIGHTS, **flags), 4, 12, 4, args


def run_jax(cfg, C, KP, M, args):
    import jax.numpy as jnp
    from volcano_tpu.ops.allocate_scan import AllocateConfig as JaxConfig
    from volcano_tpu.ops.pallas_place import make_dyn_round_placer
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    a = dp.unpack_args(cfg, args)
    R, N, CM, _, J, Q, S, NH, G = dp._shapes(a)
    place = make_dyn_round_placer(
        jcfg, C, KP, M, N, R, max(G, 1), a.orfeas.shape[0], J, Q, max(S, 1),
        NH, interpret=True)
    return [np.asarray(o) for o in place(*[jnp.asarray(x) for x in args])]


def run_plain(cfg, C, KP, M, args, stats=None):
    out = dp.dyn_place_plain(cfg, C, KP, M,
                             [torch.from_numpy(x) for x in args], stats)
    return [o.numpy() for o in out]


def assert_bitwise(ref, got):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape,
                                                           b.shape)
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), (
            f"output {i} differs:\n{a}\n{b}")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(DYN_CASES))
def test_plain_matches_pallas_interpret(case, seed):
    cfg, C, KP, M, args = case_inputs(case, seed)
    ref = run_jax(cfg, C, KP, M, args)
    stats = {}
    got = run_plain(cfg, C, KP, M, args, stats)
    assert_bitwise(ref, got)
    pops = int(ref[-2][0, 0])
    assert pops == stats["pops"] and pops >= (1 if got[0].size else 0)
    if case == "kmax_short":
        assert pops <= 3
    if case == "padded_candidates":
        assert (args[10] < 0).any()


def test_cases_cover_what_they_name():
    """Across seeds 0-2, the cases reach what they are named for: more
    than one pop in a launch, a demotion, a GPU card, the hdrf guard and
    the zero-deserved queue's flip to overused."""
    seen = dict(multi_pop=False, demote=False, card=False, guard=False,
                flip=False)
    for seed in (0, 1, 2):
        for case in DYN_CASES:
            cfg, C, KP, M, args = case_inputs(case, seed)
            out = run_plain(cfg, C, KP, M, args)
            pops, mode = int(out[-2][0, 0]), out[1][0]
            seen["multi_pop"] |= pops > 1
            if cfg.enable_gpu:
                seen["card"] |= bool((out[2] >= 0).any())
            if case == "gang_discard_demote":
                seen["demote"] |= bool((mode == dp.MODE_PIPELINED).any())
            if case == "hdrf_guard":
                # stopped with candidates left, after a kept commit
                seen["guard"] |= 0 < pops < KP and bool(
                    (out[-5] > 0).any())
            if case == "zero_deserved":
                qalloc = out[-3]
                seen["flip"] |= bool((qalloc[0] > 0).any())
                assert not (args[-1][0] > 0).any()
    assert all(seen.values()), seen


def test_sla_case_orders_by_the_deadline():
    """In the sla case the deadline key decides the order: taking its row
    out (and the flag off) changes the outputs of some seed."""
    changed = []
    for seed in (0, 1, 2):
        cfg, C, KP, M, args = case_inputs("sla_deadline", seed)
        t = [torch.from_numpy(a) for a in args]
        skeys = dp.unpack_args(cfg, t).skeys
        plan, n_static = dp.key_plan(cfg, 0)
        assert skeys.shape[0] == n_static
        at = next(i for i, x in enumerate(t) if x is skeys)
        without = list(t)
        without[at] = torch.cat([skeys[:4], skeys[5:]]).contiguous()
        got = dp.dyn_place_plain(cfg, C, KP, M, t)
        want = dp.dyn_place_plain(
            dataclasses.replace(cfg, sla_job_order=False), C, KP, M,
            without)
        assert torch.isfinite(skeys[4]).any()
        changed.append(any(not torch.equal(a, b)
                           for a, b in zip(got, want)))
    assert any(changed), changed


@pytest.mark.parametrize("flags", [dict(enable_gang=False),
                                   dict(enable_pipelining=False)])
def test_plain_matches_pallas_interpret_configs(flags):
    cfg, C, KP, M, args = case_inputs("gang_discard_demote", 3)
    cfg = dataclasses.replace(cfg, **flags)
    assert_bitwise(run_jax(cfg, C, KP, M, args),
                   run_plain(cfg, C, KP, M, args))


def test_wrapper_takes_the_plain_version_on_cpu():
    cfg, C, KP, M, args = case_inputs("drf_ns3", 2)
    t = [torch.from_numpy(a) for a in args]
    before = dp.launches
    got = dp.dyn_place(cfg, C, KP, M, t)
    assert dp.launches == before
    want = dp.dyn_place_plain(cfg, C, KP, M, t)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cuda_wrapper_rejects_cpu_tensors():
    cfg, C, KP, M, args = case_inputs("drf", 0)
    with pytest.raises(ValueError, match="CUDA device"):
        dp.dyn_place_cuda(cfg, C, KP, M, [torch.from_numpy(a) for a in args])


def test_wrapper_checks_shapes():
    cfg, C, KP, M, args = case_inputs("drf", 0)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="candidates"):
        dp.dyn_place(cfg, C + 1, KP, M, t)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(DYN_CASES))
def test_kernel_matches_plain_bitwise(case, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cfg, C, KP, M, args = case_inputs(case, seed)
    t = [torch.from_numpy(a).cuda() for a in args]
    want = dp.dyn_place_plain(cfg, C, KP, M, t)
    before = dp.launches
    got = dp.dyn_place(cfg, C, KP, M, t)
    torch.cuda.synchronize()
    assert dp.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
