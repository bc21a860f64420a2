"""The host side of kernel 3's and kernel 6's launches, in one checkout of
the repository or in several taken in turns.

    python3 scripts/launch_ab.py [--trees PATH ...] [--rounds 2]
        [--out PATH]

Each round runs every tree of ``--trees`` (this checkout when none is
given) in the order given, then in the reverse order (A B B A for two
trees), each in a process of its own that imports that tree's
``volcano_tpu_torch`` and ``chip_smoke`` and builds its kernels there.
A run measures:

- kernel 3 (the dynamic-key placer) at check B's first launch (the
  bench's configuration 3 under the shipped conf, as ``chip_smoke.py``'s
  phase 7 records it), the tree's default launch, after 3 warm-up
  launches: CUDA events around 50 launches (``events_ms``, a launch's
  pace: host-bound where the wrapper's host work outlasts the kernel) and
  the host clock around the 50 calls alone, with no synchronisation
  inside (``host_ms``, the wrapper's host work);
- kernel 6's fixture launches as ``chip_smoke.py``'s phase 24 times them:
  D = 4 launches of ``analysis.sharding.planted_double_cuda`` on a
  10,240 x 4 float32 block, 200 times, by CUDA events, against
  ``torch.mul(t, 2.0)`` on the same block, in the order kernel, library,
  library, kernel, kernel, library; every run and each one's best.

Needs a CUDA card; prints the card's name and power limit, one JSON object
a tree run, and one with all of them last, which it also writes to
``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dyn_launch_times(reps=50):
    """events_ms and host_ms of kernel 3 at check B's first launch."""
    import torch

    import chip_smoke
    from volcano_tpu_torch.framework import Session
    from volcano_tpu_torch.ops import dyn_placer as dp
    from volcano_tpu_torch.synthetic import fair_share_cluster
    ssn = Session(fair_share_cluster(), chip_smoke.shipped_conf(),
                  device="cuda")
    cfg, C, KP, M, args = chip_smoke.record_launches(
        ssn, keep=1, stop_after=1, dyn=True)[0]
    for _ in range(3):
        dp.dyn_place_cuda(cfg, C, KP, M, args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        dp.dyn_place_cuda(cfg, C, KP, M, args)
    host_ms = (time.perf_counter() - t0) * 1000 / reps
    end.record()
    torch.cuda.synchronize()
    return dict(events_ms=start.elapsed_time(end) / reps, host_ms=host_ms)


def planted_times(D=4, n_nodes=10240, cols=4, reps=200):
    """Kernel 6's D launches against torch.mul x D, alternated."""
    import torch

    from volcano_tpu_torch.analysis import sharding as gs
    full = torch.randn(n_nodes, cols,
                       generator=torch.Generator().manual_seed(D)).cuda()
    calls = dict(kernel=gs.planted_double_cuda,
                 library=lambda t: torch.mul(t, 2.0))
    times = {}
    for name in ("kernel", "library", "library", "kernel", "kernel",
                 "library"):
        fn = calls[name]
        for _ in range(3):
            fn(full)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            for _ in range(D):
                fn(full)
        end.record()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(start.elapsed_time(end) / reps)
    return dict(ms=min(times["kernel"]), library_ms=min(times["library"]),
                runs_ms=times)


def child(tree):
    """One tree's run, in this process; prints its JSON object last."""
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = dict(tree=tree, dyn=dyn_launch_times(), planted=planted_times())
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[HERE])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    opts = ap.parse_args(argv)
    if opts.child:
        return child(opts.child)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = []
    for _ in range(opts.rounds):
        for tree in opts.trees + opts.trees[::-1]:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", tree],
                capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
                raise SystemExit(f"{tree}: rc {res.returncode}")
            runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    out = dict(card=smi, runs=runs)
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
