"""The port's fair-share solvers against the JAX package's, bit for bit.

Seeded numpy inputs go through ``volcano_tpu.ops.fairshare`` and through
``volcano_tpu_torch.ops.fairshare``: proportion's water-filling (with
capability clamps, zero weights, invalid queues and the reference's
``total + 1.0`` sentinel, which returns all zeros once every capacity
dimension reaches 2^24), the drf job and namespace shares, and the hdrf
tree keys. Allocations sit on the grids the packer produces (multiples of
500 millicpu and of 2^30 bytes), where every sum is exact in any order.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from volcano_tpu.arrays.hierarchy import build_from_specs as jax_specs
from volcano_tpu.arrays.schema import QueueArrays
from volcano_tpu.ops import fairshare as jfs

from volcano_tpu_torch.arrays.hierarchy import build_from_specs
from volcano_tpu_torch.ops import fairshare as tfs

F32 = np.float32
GIB = float(2 ** 30)


def queues_np(seed, Q, R=2, total=(64000.0, 256 * GIB), zero_weights=False,
              capped=True):
    rng = np.random.RandomState(seed)
    n_valid = max(1, Q - 1)
    valid = np.arange(Q) < n_valid
    weight = rng.randint(0 if zero_weights else 1, 5, Q).astype(F32)
    unit = np.array([500.0, GIB][:R], F32)
    request = (rng.randint(0, 200, (Q, R)) * unit).astype(F32)
    capability = np.full((Q, R), np.inf, F32)
    if capped:
        cap = rng.rand(Q) < 0.4
        capability[cap] = (rng.randint(1, 60, (int(cap.sum()), R))
                           * unit).astype(F32)
    allocated = (rng.randint(0, 20, (Q, R)) * unit).astype(F32)
    return dict(weight=weight, capability=capability, allocated=allocated,
                request=request, valid=valid), np.asarray(total[:R], F32)


def jax_queues(q):
    Q, R = q["allocated"].shape
    z = np.zeros(Q, F32)
    return QueueArrays(
        weight=jnp.asarray(q["weight"]),
        capability=jnp.asarray(q["capability"]),
        reclaimable=jnp.ones(Q, bool), open=jnp.ones(Q, bool),
        allocated=jnp.asarray(q["allocated"]),
        request=jnp.asarray(q["request"]),
        inqueue_minres=jnp.zeros((Q, R), jnp.float32),
        parent=jnp.full(Q, -1, jnp.int32), depth=jnp.zeros(Q, jnp.int32),
        hier_weight=jnp.asarray(z + 1), valid=jnp.asarray(q["valid"]))


def port_queues(q):
    return types.SimpleNamespace(**{k: torch.from_numpy(np.asarray(v))
                                    for k, v in q.items()})


def bits(a):
    return np.asarray(a, F32).view(np.uint32)


@pytest.mark.parametrize("Q", [4, 16])
@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(zero_weights=True)), (2, dict(capped=False)),
    (3, dict(total=(16384000.0, 4096 * GIB))),
    (4, dict(total=(1e6, 3 * GIB))),
])
def test_proportion_deserved_matches_jax(Q, seed, kw):
    q, total = queues_np(seed, Q, **kw)
    want = np.asarray(jfs.proportion_deserved(jax_queues(q),
                                              jnp.asarray(total)))
    got = tfs.proportion_deserved(port_queues(q), torch.from_numpy(total))
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    if kw.get("capped", True) and not kw.get("zero_weights"):
        assert (want > 0).any()


def test_proportion_sentinel_at_two_to_the_24():
    """Every capacity dimension at 2^24 or more: total + 1.0 == total in
    float32, the loop never runs and every deserved is 0, in both
    packages (reference fault (d))."""
    q, total = queues_np(5, 4, total=(1.6e8, 6.9e14))
    want = np.asarray(jfs.proportion_deserved(jax_queues(q),
                                              jnp.asarray(total)))
    got = tfs.proportion_deserved(port_queues(q), torch.from_numpy(total))
    assert not want.any() and not got.numpy().any()


def jobs_np(seed, J=40, S=3, R=2):
    rng = np.random.RandomState(seed)
    unit = np.array([500.0, GIB][:R], F32)
    alloc = (rng.randint(0, 12, (J, R)) * unit).astype(F32)
    alloc[rng.rand(J) < 0.3] = 0.0
    ns = rng.randint(0, S, J).astype(np.int32)
    valid = rng.rand(J) < 0.9
    weight = rng.randint(0, 4, S).astype(F32)
    return alloc, ns, valid, weight


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drf_shares_match_jax(seed):
    alloc, ns, valid, weight = jobs_np(seed)
    total = np.array([96000.0, 384 * GIB], F32)
    jt = [jnp.asarray(x) for x in (alloc, ns, valid, weight, total)]
    tt = [torch.from_numpy(np.asarray(x)) for x in (alloc, ns, valid,
                                                    weight, total)]
    want = np.asarray(jfs.namespace_shares(*jt))
    got = tfs.namespace_shares(*tt).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))
    want = np.asarray(jfs.drf_job_shares(jt[0], jt[4], jt[2]))
    got = tfs.drf_job_shares(tt[0], tt[4], tt[2]).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))


def test_fold_last_is_sequential():
    """fold_last adds in index order: it reproduces a float32 loop where a
    pairwise sum would differ."""
    x = np.array([[1.0, 1e8, -1e8, 1e-3, 3.0]], F32)
    want = F32(0.0)
    for v in x[0]:
        want = F32(want + v)
    assert tfs.fold_last(torch.from_numpy(x)).item() == want


HDRF_SPECS = [("root/sci", "100/50"), ("root/eng/dev", "100/50/50"),
              ("root/eng/prod", "100/50/50"), ("", "")]


@pytest.mark.parametrize("seed", [0, 1])
def test_hdrf_level_keys_match_jax(seed):
    rng = np.random.RandomState(seed)
    Q, J = 4, 16
    job_queue = rng.randint(0, 3, J).astype(np.int32)
    in_tree = rng.rand(J) < 0.9
    hj = jax_specs(HDRF_SPECS, Q, job_queue, in_tree)
    ht = build_from_specs(HDRF_SPECS, Q, job_queue, in_tree)
    for f in ("parent", "depth", "weight", "valid", "queue_path",
              "job_leaf"):
        np.testing.assert_array_equal(np.asarray(getattr(hj, f)),
                                      getattr(ht, f))
    unit = np.array([1000.0, GIB], F32)
    alloc = (rng.randint(0, 6, (J, 2)) * unit).astype(F32)
    request = alloc + (rng.randint(0, 4, (J, 2)) * unit).astype(F32)
    valid = rng.rand(J) < 0.95
    total = np.array([10000.0, 10 * GIB], F32)
    want = np.asarray(jfs.hdrf_level_keys(
        hj, jnp.asarray(alloc), jnp.asarray(request), jnp.asarray(valid),
        jnp.asarray(total)))
    got = tfs.hdrf_level_keys(
        ht, torch.from_numpy(alloc), torch.from_numpy(request),
        torch.from_numpy(valid), torch.from_numpy(total)).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))
