#!/usr/bin/env python
"""Check L's target from the JAX package's Session, on the CPU.

    env JAX_PLATFORMS=cpu python scripts/check_l_targets.py [NODES GANGS NS]

Builds ``volcano_tpu_torch.synthetic._synthetic_cluster(256, 160, 16,
namespaces=40)`` (job j in namespace ``ns-{j % 40}``: 64 padded
namespaces, 128 drf namespace-fold pairs at two resource dims) with the
JAX package's ``api``, opens the JAX ``Session`` under
conf/volcano-scheduler.conf, runs ``run_allocate`` (the scan path on the
CPU backend) and prints one JSON line: the decision fingerprint
(bench.py:318-320, int32), the tasks placed and the jobs ready.
``chip_smoke.py``'s check L holds the port on the card to these values
(its ``CHECK_L``).
"""

import hashlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(n_nodes=256, n_gangs=160, n_namespaces=40):
    import volcano_tpu.api as japi
    from volcano_tpu.framework import Session, parse_conf

    from volcano_tpu_torch.synthetic import _synthetic_cluster
    with open(os.path.join(REPO, "conf", "volcano-scheduler.conf")) as f:
        conf = parse_conf(f.read())
    t0 = time.perf_counter()
    ci = _synthetic_cluster(n_nodes, n_gangs, 16, namespaces=n_namespaces,
                            api=japi)
    ssn = Session(ci, conf)
    out = {"build_s": time.perf_counter() - t0,
           "namespaces": len(ssn.maps.namespace_names),
           "padded_namespaces": int(np.asarray(
               ssn.snap.namespace_weight).shape[0])}
    t0 = time.perf_counter()
    ssn.run_allocate()
    r = ssn.last_allocate
    node = np.asarray(r.task_node, np.int32)
    mode = np.asarray(r.task_mode, np.int32)
    out.update(allocate_s=time.perf_counter() - t0,
               fingerprint=hashlib.sha256(node.tobytes()
                                          + mode.tobytes()).hexdigest()[:16],
               placed=int((mode > 0).sum()),
               jobs_ready=int(np.asarray(r.job_ready).sum()))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
