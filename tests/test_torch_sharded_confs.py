"""The port's sharded allocate cycle under the confs whose ordering keys
move with every commit: the built-in default conf, the shipped
``conf/volcano-scheduler.conf`` (drf + proportion) and hierarchical drf.

The port's ``make_sharded_allocate`` on D virtual shards of the CPU must
give the ``packed_decisions`` of the JAX package's sharded cycle (the
shard-local candidate kernel in interpret mode under shard_map on 4
virtual CPU devices) and of the JAX scan path, element for element. Like
``tests/test_torch_sharded.py``, these tests ignore shard_map's
DeprecationWarning (ROADMAP section 3 (b)) and no other warning.
"""

import numpy as np
import pytest

from torch_fixtures import (SHARD_MAP_WARNING, jax_scan_packed,
                            jax_sharded_packed, need_jax_devices,
                            port_sharded_packed, sharded_inputs)


@pytest.mark.filterwarnings(SHARD_MAP_WARNING)
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("name", ["builtin_default", "shipped", "hdrf"])
def test_conf_matches_jax_sharded_and_scan(name, D):
    """The built-in conf, the shipped conf (drf + proportion) and hdrf,
    whose ordering keys move with every commit: the port at D shards
    equals the JAX sharded cycle on 4 virtual devices and the JAX scan
    path."""
    need_jax_devices(4)
    got = port_sharded_packed(name, D)
    np.testing.assert_array_equal(got, jax_sharded_packed(name, 4))
    np.testing.assert_array_equal(got, jax_scan_packed(name))
    T = sharded_inputs(name)[1].tasks.status.shape[0]
    assert (got[T:2 * T] > 0).any()
