"""The segmented sum in row order (``volcano_tpu_torch/ops/seg_fold.py``)
against a float32 loop and against the reference's ``jax.ops.segment_sum``,
and the namespace shares built on it against the dynamic-key placer's own
namespace fold.

The CUDA kernel's tests are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from volcano_tpu_torch.ops import fairshare as tfs
from volcano_tpu_torch.ops import seg_fold as sf

F32 = np.float32


def inputs(seed, A, D, num, exact=False):
    """vals f32[A, D] (on a 0.25 grid when ``exact``, else values whose
    float32 sums depend on the order), seg i32[A] with dropped rows (-1 and
    num)."""
    rng = np.random.RandomState(seed)
    if exact:
        vals = (rng.randint(0, 40, (A, D)) / 4.0).astype(F32)
    else:
        vals = (rng.standard_normal((A, D))
                * 10.0 ** rng.randint(-3, 8, (A, D))).astype(F32)
    seg = rng.randint(-1, num + 1, A).astype(np.int32)
    return vals, seg


def loop_fold(vals, seg, num):
    """Reference: one float32 add at a time, rows in order."""
    out = np.zeros((num, vals.shape[1]), F32)
    for a in range(vals.shape[0]):
        if 0 <= seg[a] < num:
            out[seg[a]] = (out[seg[a]] + vals[a]).astype(F32)
    return out


def bits(x):
    return np.asarray(x, F32).view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("A,D,num", [(300, 2, 4), (257, 1, 1), (64, 3, 70)])
def test_plain_is_a_sequential_fold(A, D, num, seed):
    vals, seg = inputs(seed, A, D, num)
    got = sf.seg_fold_plain(torch.from_numpy(vals), torch.from_numpy(seg),
                            num).numpy()
    np.testing.assert_array_equal(bits(got), bits(loop_fold(vals, seg, num)))


@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax_segment_sum_where_exact(seed):
    A, D, num = 500, 2, 6
    vals, seg = inputs(seed, A, D, num, exact=True)
    keep = (seg >= 0) & (seg < num)
    want = jax.ops.segment_sum(
        jnp.where(jnp.asarray(keep)[:, None], jnp.asarray(vals), 0.0),
        jnp.where(jnp.asarray(keep), jnp.asarray(seg), num),
        num_segments=num + 1)[:num]
    got = sf.seg_fold(torch.from_numpy(vals), torch.from_numpy(seg), num)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def nonzero_fold(vals, seg, num):
    """The kernel's fold: for each (segment, dim) pair, from +0, one float32
    add after another in row order over the pair's terms that are not an
    exact zero (+0.0 or -0.0); NaN and infinities are terms."""
    out = np.zeros((num, vals.shape[1]), F32)
    for s in range(num):
        for d in range(vals.shape[1]):
            acc = F32(0.0)
            for a in np.flatnonzero(seg == s):
                if vals[a, d] != 0.0:
                    acc = F32(acc + vals[a, d])
            out[s, d] = acc
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_of_nonzero_terms_is_the_sequential_fold(seed):
    """Skipping exact zeros gives the sequential fold's bits, with -0.0,
    NaN and infinities planted, a segment of -0.0 terms only, rows in
    segments outside [0, num) and empty segments; and so does the plain
    version."""
    A, D, num = 400, 3, 7
    vals, seg = inputs(seed, A, D, num)
    rng = np.random.RandomState(seed + 100)
    pick = rng.rand(A, D)
    vals[pick < 0.2] = 0.0
    vals[(pick >= 0.2) & (pick < 0.35)] = -0.0
    vals[(pick >= 0.35) & (pick < 0.37)] = np.inf
    vals[(pick >= 0.37) & (pick < 0.39)] = -np.inf
    vals[(pick >= 0.39) & (pick < 0.40)] = np.nan
    seg = rng.randint(-3, num + 3, A).astype(np.int32)
    seg[seg == 2] = -1                      # segment 2 stays empty
    seg[:5], vals[:5, 0] = 5, -0.0
    seg[seg == 5] = np.where(rng.rand(int((seg == 5).sum())) < 0.5, 5, 6)
    vals[seg == 5, 0] = -0.0               # (5, 0): -0.0 terms only
    with np.errstate(invalid="ignore"):     # inf - inf is a NaN term
        want = loop_fold(vals, seg, num)
        got = nonzero_fold(vals, seg, num)
    same_bits_or_nan(got, want)
    assert np.isnan(want).any() and np.isinf(want).any()
    assert (bits(want[2]) == 0).all() and bits(want[5, 0]) == 0
    plain = sf.seg_fold_plain(torch.from_numpy(vals), torch.from_numpy(seg),
                              num).numpy()
    same_bits_or_nan(plain, want)


def same_bits_or_nan(got, want):
    """Equal float32 bits, and a NaN exactly where the other has one: IEEE
    754 leaves a NaN result's sign and payload to the implementation (the
    CPU's vector and scalar adds pick different operands' NaNs), so they
    say nothing of the order of the adds."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(bits(got)[~nan], bits(want)[~nan])


def test_empty_inputs():
    got = sf.seg_fold(torch.zeros((0, 2)), torch.zeros(0, dtype=torch.int32),
                      3)
    assert got.shape == (3, 2) and not got.any()
    assert sf.seg_fold(torch.ones((4, 2)), torch.zeros(4, dtype=torch.int32),
                       0).shape == (0, 2)


def test_wrapper_takes_the_plain_version_on_cpu():
    vals, seg = inputs(3, 100, 2, 5)
    before = sf.launches
    got = sf.seg_fold(torch.from_numpy(vals), torch.from_numpy(seg), 5)
    assert sf.launches == before
    assert torch.equal(got, sf.seg_fold_plain(torch.from_numpy(vals),
                                              torch.from_numpy(seg), 5))


def test_cuda_wrapper_rejects_cpu_tensors():
    vals, seg = inputs(4, 10, 2, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        sf.seg_fold_cuda(torch.from_numpy(vals), torch.from_numpy(seg), 3)


def test_wrapper_checks_dtypes_and_shapes():
    vals, seg = inputs(5, 10, 2, 3)
    with pytest.raises(ValueError, match="seg"):
        sf.seg_fold(torch.from_numpy(vals), torch.from_numpy(seg).long(), 3)
    with pytest.raises(ValueError, match="vals"):
        sf.seg_fold(torch.from_numpy(vals).double(), torch.from_numpy(seg), 3)
    with pytest.raises(ValueError, match="seg"):
        sf.seg_fold(torch.from_numpy(vals), torch.from_numpy(seg[:5]), 3)


def test_kernel_wrapper_names_its_limits():
    """The kernel's wrapper refuses, before any launch, more dims than a
    tile of its shared memory holds (MAX_DIMS, 42) and 2**31 or more
    (segment, dim) pairs, naming the limit; the plain version has
    neither."""
    seg = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 42 dims"):
        sf.seg_fold_cuda(torch.ones(4, sf.MAX_DIMS + 1), seg, 3)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        sf.seg_fold_cuda(torch.ones(4, 2), seg, 2 ** 30)
    with pytest.raises(ValueError, match="CUDA device"):
        sf.seg_fold_cuda(torch.ones(4, sf.MAX_DIMS), seg, 3)
    got = sf.seg_fold(torch.ones(4, sf.MAX_DIMS + 1), seg, 3)
    assert got.shape == (3, 43) and bool((got[0] == 4.0).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_namespace_shares_match_the_placer_fold(seed):
    """The cycle's namespace key (seg_fold over the jobs) and the dynamic-key
    placer's (a masked fold over the jobs, as the kernel does it) agree bit
    for bit where the sums are not exact."""
    rng = np.random.RandomState(seed)
    J, S, R = 3000, 3, 2
    alloc = (rng.rand(J, R) * 10.0 ** rng.randint(0, 9, (J, R))).astype(F32)
    ns = rng.randint(0, S, J).astype(np.int32)
    valid = rng.rand(J) < 0.9
    weight = np.array([1.0, 2.0, 3.0], F32)
    total = np.array([1e9, 1e12], F32)
    t = [torch.from_numpy(x) for x in (alloc, ns, valid, weight, total)]
    got = tfs.namespace_shares(*t)
    member = (np.arange(S)[:, None] == ns[None, :]) & valid[None, :]
    alloc_s = tfs.fold_last(torch.where(torch.from_numpy(member)[:, None, :],
                                        t[0].T[None], torch.zeros(())))
    want = tfs.dominant_share(alloc_s, t[4]) / t[3].clamp_min(1.0)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want.numpy()))
