#!/usr/bin/env python
"""Check O (ii)'s targets from the JAX package's scheduler loop, on the CPU.

    env JAX_PLATFORMS=cpu python scripts/check_o_targets.py [NODES GANGS]

Builds ``volcano_tpu_torch.synthetic._synthetic_cluster(256, 160, 16)``
with the JAX package's ``api``, wraps it in the JAX package's
``FakeCluster`` and drives the JAX ``Scheduler`` under
conf/volcano-scheduler.conf (enqueue, allocate, backfill) through
``chip_smoke.loop_churn``: cycle 0, then three churn cycles (5 % of the
bound gangs complete and as many go back to Pending, seed 11, marked
through the cluster's ``mark_dirty``), each at ``now`` = 4149 + cycle.
Prints one JSON line: each cycle's bind count and bind fingerprint
(``chip_smoke.bind_fingerprint``: sha256 of the bind intents in their
order). ``chip_smoke.py``'s check O holds the port's loop on the card to
these values (its ``CHECK_O``).
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(n_nodes=256, n_gangs=160):
    import volcano_tpu.api as japi
    from volcano_tpu.framework import parse_conf
    from volcano_tpu.runtime.fake_cluster import FakeCluster
    from volcano_tpu.runtime.scheduler import Scheduler

    import chip_smoke
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    with open(os.path.join(REPO, "conf", "volcano-scheduler.conf")) as f:
        conf = parse_conf(f.read())
    t0 = time.perf_counter()
    sched = Scheduler(FakeCluster(_synthetic_cluster(n_nodes, n_gangs, 16,
                                                     api=japi)), conf=conf)
    cycles = chip_smoke.loop_churn(sched, japi)
    print(json.dumps({"cluster": [n_nodes, n_gangs, 16], "cycles": cycles,
                      "full_packs": sched.full_packs,
                      "incremental_cycles": sched.incremental_cycles,
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
