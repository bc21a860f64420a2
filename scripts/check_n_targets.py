#!/usr/bin/env python
"""Check N's targets from the JAX package's Session, on the CPU.

    env JAX_PLATFORMS=cpu python scripts/check_n_targets.py [NODES GANGS]

Builds ``volcano_tpu_torch.synthetic._synthetic_cluster(256, 160, 16,
extended=10)`` (a MIG-partitioned GPU cluster: cpu, memory and ten
extended resources, R = 12) with the JAX package's ``api`` and opens the
JAX ``Session`` twice: under gang + binpack it runs ``run_allocate``, and
under conf/volcano-scheduler.conf it runs ``run_enqueue`` then
``run_allocate`` (the scan path on the CPU backend). Prints one JSON line:
for each conf the decision fingerprint (bench.py:318-320, int32), the
tasks placed and the jobs ready (and the shipped conf's enqueued jobs).
``chip_smoke.py``'s check N holds the port on the card to these values
(its ``CHECK_N``); the check's two mesh runs (``sharding: true`` at
``wave_width`` 1 and 8) are held to the gang + binpack values.
"""

import hashlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GANG_BINPACK = ("actions: allocate\ntiers:\n- plugins:\n  - name: gang\n"
                "  - name: binpack\n")


def outcome(ssn):
    r = ssn.last_allocate
    node = np.asarray(r.task_node, np.int32)
    mode = np.asarray(r.task_mode, np.int32)
    return dict(fingerprint=hashlib.sha256(node.tobytes()
                                           + mode.tobytes()).hexdigest()[:16],
                placed=int((mode > 0).sum()),
                jobs_ready=int(np.asarray(r.job_ready).sum()))


def main(n_nodes=256, n_gangs=160):
    import volcano_tpu.api as japi
    from volcano_tpu.framework import Session, parse_conf

    from volcano_tpu_torch.synthetic import _synthetic_cluster
    with open(os.path.join(REPO, "conf", "volcano-scheduler.conf")) as f:
        shipped = parse_conf(f.read())
    out = {}
    for name, conf in (("static", parse_conf(GANG_BINPACK)),
                       ("shipped", shipped)):
        t0 = time.perf_counter()
        ssn = Session(_synthetic_cluster(n_nodes, n_gangs, 16, api=japi,
                                         extended=10), conf)
        dims = int(np.asarray(ssn.snap.nodes.idle).shape[1])
        enqueued = ssn.run_enqueue() if name == "shipped" else None
        ssn.run_allocate()
        out[name] = dict(outcome(ssn), resource_dims=dims,
                         seconds=time.perf_counter() - t0)
        if enqueued is not None:
            out[name]["enqueued"] = int(enqueued)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
