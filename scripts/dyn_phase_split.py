"""Where one launch of the dynamic-key placer (kernel 3) spends its time,
phase by phase, on the card.

    python3 scripts/dyn_phase_split.py [--cb 16 8] [--reps 20] [--out PATH]

Records the arguments of check B's first launch (``chip_smoke.py``'s
phase 7: the bench's configuration 3 under the shipped conf) and of check
K's first launch (phase 25: ``admission_scenario()`` under check K's conf
after the enqueue action), then for each launch and each cluster size of
``--cb`` (16 and 8 when not given):

- the launch's device time in a ``torch.profiler`` trace and the CUDA
  events around the same 50 launches (the wrapper's host work), the
  phase split off (``chip_smoke.time_dyn_kernel``);
- the phase split (``chip_smoke.dyn_phase_split``): the clock64() cycles
  of each phase of the launch (prologue, queue gate and namespace fold,
  eligibility, argmin, the section's attempts, finalize), summed over its
  pops and scaled to microseconds by the launch's globaltimer
  nanoseconds per cycle, averaged over ``--reps`` launches.

Needs a CUDA card; prints the card's name and power limit and one JSON
object, and writes the object to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launches():
    """(name, call) of check B's and check K's first dyn launches."""
    import chip_smoke
    from volcano_tpu_torch.actions import get_action
    from volcano_tpu_torch.framework import Session
    from volcano_tpu_torch.synthetic import (admission_scenario,
                                             fair_share_cluster)
    ssn_b = Session(fair_share_cluster(), chip_smoke.shipped_conf(),
                    device="cuda")
    b = chip_smoke.record_launches(ssn_b, keep=1, stop_after=1, dyn=True)
    ssn_k = Session(admission_scenario(), chip_smoke.check_k_conf(),
                    now=4149.0, device="cuda")
    get_action("enqueue").execute(ssn_k)
    k = chip_smoke.record_launches(
        ssn_k, keep=1, stop_after=1, dyn=True,
        inputs=(ssn_k.snap, *ssn_k._derived_allocate_inputs()))
    return [("check_B_first", b[0]), ("check_K_first", k[0])]


def measure(call, cb, reps):
    """The launch's device time, host-bound event time and phase split as
    a cluster of ``cb`` blocks (``chip_smoke.py`` phase 11's helpers)."""
    import chip_smoke
    from volcano_tpu_torch.ops import dyn_placer as dp
    t = chip_smoke.time_dyn_kernel(call, cb)
    cfg, C, KP, M, args = call
    a = dp.unpack_args(cfg, args)
    R, N = a.idle.shape
    shape = dict(C=C, KP=KP, M=M, N=N, R=R, J=a.cslot.shape[1],
                 Q=a.qoh.shape[0],
                 S=a.nsm.shape[0] if a.nsm is not None else 0,
                 NKS=a.skeys.shape[0])
    return dict(cb=cb, ms=t["ms"], events_ms=t["events_ms"],
                split_us=chip_smoke.dyn_phase_split(call, cb, reps),
                shape=shape)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cb", type=int, nargs="+", default=[16, 8])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    out = dict(card=smi, launches={})
    for name, call in launches():
        out["launches"][name] = [measure(call, cb, opts.reps)
                                 for cb in opts.cb]
        print(json.dumps({name: out["launches"][name]}), flush=True)
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
