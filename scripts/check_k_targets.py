#!/usr/bin/env python
"""Check K's targets from the JAX package's Session, on the CPU.

    env JAX_PLATFORMS=cpu python scripts/check_k_targets.py [NODES GANGS BE]

Builds ``volcano_tpu_torch.synthetic.admission_scenario`` with the JAX
package's ``api`` (by default at full size: 1,024 nodes, 3,125 gangs of 16,
1,024 best-effort jobs), opens the JAX ``Session`` under
conf/volcano-scheduler-ci.conf's tiers with the actions enqueue, allocate,
backfill and ``now=4149.0``, runs the three passes (the scan path on the
CPU backend) and prints one JSON line: the enqueued count and the sha256 of
the admitted mask, the allocate fingerprint (bench.py:318-320, int32) and
binds, and the backfill count and the sha256 of its (task, node) binds, as
int32 pairs in bind order. ``chip_smoke.py``'s check K holds the port on the
card to these values (its ``CHECK_K``).
"""

import hashlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def conf_text() -> str:
    with open(os.path.join(REPO, "conf", "volcano-scheduler-ci.conf")) as f:
        text = f.read()
    return text.replace('"enqueue, reclaim, allocate, backfill, preempt"',
                        '"enqueue, allocate, backfill"')


def main(n_nodes=1024, n_gangs=3125, n_best_effort=1024):
    import volcano_tpu.api as japi
    from volcano_tpu.framework import Session, parse_conf
    from volcano_tpu.framework.session import _enqueue_fn

    from volcano_tpu_torch.synthetic import admission_scenario
    t0 = time.perf_counter()
    ci = admission_scenario(n_nodes, n_gangs, 16, n_best_effort, api=japi)
    ssn = Session(ci, parse_conf(conf_text()), now=4149.0)
    out = {"build_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    admitted = np.asarray(_enqueue_fn(ssn.enqueue_config())(
        ssn.snap, ssn.sla_waiting_flags()))
    out["sla_waiting"] = int(ssn.sla_waiting_flags().sum())
    enqueued = ssn.run_enqueue()
    assert enqueued == int(admitted.sum())
    out.update(enqueue_s=time.perf_counter() - t0, enqueued=enqueued,
               admitted_sha256=sha(admitted.tobytes()))
    t0 = time.perf_counter()
    ssn.run_allocate()
    r = ssn.last_allocate
    n_alloc = len(ssn.binds)
    out.update(allocate_s=time.perf_counter() - t0,
               fingerprint=sha(np.asarray(r.task_node, np.int32).tobytes()
                               + np.asarray(r.task_mode, np.int32).tobytes()),
               allocate_binds=n_alloc,
               jobs_ready=int(np.asarray(r.job_ready).sum()))
    t0 = time.perf_counter()
    backfilled = ssn.run_backfill()
    pairs = np.asarray([[ssn.maps.task_index[b.task_uid],
                         ssn.maps.node_index[b.node_name]]
                        for b in ssn.binds[n_alloc:]], np.int32).reshape(-1, 2)
    out.update(backfill_s=time.perf_counter() - t0, backfilled=backfilled,
               backfill_sha256=sha(pairs.tobytes()),
               backfill_nodes=sorted(set(pairs[:, 1].tolist())))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
