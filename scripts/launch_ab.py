"""Kernel launches and the wave walk's host time, in one checkout of the
repository or in several taken in turns.

    python3 scripts/launch_ab.py [--trees PATH ...] [--rounds 1]
        [--parts dyn planted wave seg_fold wave_window wave_profile
                 fair_share_profile]
        [--wave-window 500] [--wave-cycles 0] [--out PATH]

Each round runs every tree of ``--trees`` (this checkout when none is
given) in the order given, then in the reverse order (A B B A for two
trees), each in a process of its own that imports that tree's
``volcano_tpu_torch`` and ``chip_smoke`` and builds its kernels there.
A run measures the parts named by ``--parts`` (all by default):

- ``dyn``: kernel 3 (the dynamic-key placer) at check B's first launch
  (the bench's configuration 3 under the shipped conf, as
  ``chip_smoke.py``'s phase 7 records it), the tree's default launch,
  after 3 warm-up launches: CUDA events around 50 launches (``events_ms``,
  a launch's pace: host-bound where the wrapper's host work outlasts the
  kernel) and the host clock around the 50 calls alone, with no
  synchronisation inside (``host_ms``, the wrapper's host work);
- ``planted``: kernel 6's fixture launches as ``chip_smoke.py``'s phase 24
  times them: D = 4 launches of ``analysis.sharding.planted_double_cuda``
  on a 10,240 x 4 float32 block, 200 times, by CUDA events, against
  ``torch.mul(t, 2.0)`` on the same block, in the order kernel, library,
  library, kernel, kernel, library; every run and each one's best;
- ``wave``: kernel 5 (the wide candidate search) at check I's first
  launch (``chip_smoke.py``'s phase 20 records it): CUDA events and the
  host clock around 200 launches as for ``dyn``, then its device time per
  launch in a ``torch.profiler`` trace of 200 more;
- ``seg_fold``: the segmented sum at check B's second call (the namespace
  fold after the cycle's first launch, ``chip_smoke.seg_fold_calls``: few
  terms yet) and on the same segments over seeded values (a term in every
  kept row): its device time per launch in a ``torch.profiler`` trace of
  200 launches, and CUDA events and the host clock around 200 launches
  without one;
- ``wave_window``: the host's ms a wave over check I's first W waves
  (``--wave-window``) with no trace: the cycle behind a seam that ends
  it after W kernel-5 launches, warmed once, then timed 3 times (the
  device is idle most of a wave, so the wall clock is the host's);
- ``wave_profile``: the tree's own ``scripts/torch_cycle_profile.py
  --cell wave --window W --cycles C`` (check I), in a process of its own:
  the host ms a wave by step, the waits a wave, the device's idle share,
  kernel 5's device time in the cycle and, with C > 0, C whole cycles'
  ``cycle_ms``;
- ``fair_share_profile``: the tree's own ``scripts/torch_cycle_profile.py
  --cell fair_share --window W --cycles 0`` (check B's first W rounds, W
  the ``--wave-window``):
  the segmented sum's and kernel 3's device ms a launch in the cycle, and
  the device's idle share.

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


def paced(fn, reps):
    """CUDA events around ``reps`` calls of ``fn`` after 3 warm-up calls,
    and the host clock around the calls alone (ms a call each)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1000 / reps
    end.record()
    torch.cuda.synchronize()
    return dict(events_ms=start.elapsed_time(end) / reps, host_ms=host_ms)


def traced_ms(fn, name, reps):
    """Mean device ms of the launches of kernel ``name`` in a
    ``torch.profiler`` trace of ``reps`` calls of ``fn`` (the trace may
    keep fewer launches than ran), and how many it kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [(e.time_range.end - e.time_range.start) / 1000
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and name in e.name]
    return dict(ms=sum(dev) / len(dev) if dev else None, traced=len(dev))


def dyn_launch_times(reps=50):
    """events_ms and host_ms of kernel 3 at check B's first launch."""
    import chip_smoke
    from volcano_tpu_torch.framework import Session
    from volcano_tpu_torch.ops import dyn_placer as dp
    from volcano_tpu_torch.synthetic import fair_share_cluster
    ssn = Session(fair_share_cluster(), chip_smoke.shipped_conf(),
                  device="cuda")
    cfg, C, KP, M, args = chip_smoke.record_launches(
        ssn, keep=1, stop_after=1, dyn=True)[0]
    return paced(lambda: dp.dyn_place_cuda(cfg, C, KP, M, args), reps)


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


def wave_times(reps=200):
    """Kernel 5 at check I's first launch: paced, then traced."""
    import chip_smoke
    from volcano_tpu_torch.framework import Session
    from volcano_tpu_torch.ops import shard_wave as sw
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    ssn = Session(_synthetic_cluster(*chip_smoke.FULL),
                  chip_smoke.wave_conf(True), device="cuda")
    cfg, D, C, args = chip_smoke.record_wave_launches(ssn, keep=1,
                                                      stop_after=1)[0]

    def fn():
        sw.shard_wave_cuda(cfg, D, C, args)
    return dict(paced(fn, reps), device=traced_ms(fn, "shard_wave", reps))


def seg_fold_times(reps=200):
    """The segmented sum at check B's second call: traced, then paced."""
    import chip_smoke
    from volcano_tpu_torch.framework import Session
    from volcano_tpu_torch.ops import seg_fold as sf
    from volcano_tpu_torch.synthetic import fair_share_cluster
    ssn = Session(fair_share_cluster(), chip_smoke.shipped_conf(),
                  device="cuda")
    b_calls = chip_smoke.record_launches(ssn, keep=1, stop_after=1, dyn=True)
    calls = chip_smoke.seg_fold_calls(ssn, b_calls)
    out = {}
    # the second call (few terms yet), then the same segments over seeded
    # values (a term in every kept row)
    for name, (vals, seg, num) in (("second_call", calls[1]),
                                   ("terms", calls[-2])):
        def fn():
            sf.seg_fold_cuda(vals, seg, num)
        fn()
        out[name] = dict(traced_ms(fn, "seg_fold", reps), **paced(fn, reps),
                         rows=vals.shape[0], segments=num,
                         terms=int(((vals != 0) & (seg >= 0)[:, None]
                                    & (seg < num)[:, None]).sum()))
    return out


def fair_share_profile(tree, window):
    """The tree's own check-B profile (``scripts/torch_cycle_profile.py
    --cell fair_share --window W --cycles 0``), in a process of its own:
    the segmented sum's device ms a launch in the cycle's first W rounds,
    the dynamic-key placer's, and the device's idle share."""
    out = os.path.join(tree, "chiprun_out", "ab_fair_share_profile.json")
    res = subprocess.run(
        [sys.executable, os.path.join(tree, "scripts",
                                      "torch_cycle_profile.py"),
         "--cell", "fair_share", "--window", str(window), "--cycles", "0",
         "--out", out], cwd=tree, capture_output=True, text=True,
        timeout=1800)
    if res.returncode != 0:
        sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
        raise SystemExit(f"{tree}: the fair-share profile failed")
    with open(out) as f:
        prof = json.load(f)
    per = {}
    for key, name in (("seg_fold", "seg_fold_kernel"),
                      ("dyn_placer", "dyn_placer_kernel")):
        hit = [v for k, v in prof["device_ms_by_name"].items() if name in k]
        per[key] = (dict(count=hit[0]["count"],
                         ms_per_launch=hit[0]["ms"] / hit[0]["count"])
                    if hit else None)
    return dict(profiled_launches=prof.get("profiled_launches"),
                device_idle_share=prof.get("device_idle_share"),
                device_ms_per_launch=per)


def wave_window(window, reps=3):
    """The host's time a wave over check I's first ``window`` waves, with no
    trace: the cycle on the card behind a seam that ends it after
    ``window`` kernel-5 launches, run once to warm, then ``reps`` times,
    each timed from the cycle's call to the end of its last wave."""
    import torch

    import chip_smoke
    from volcano_tpu_torch.arrays import to_device
    from volcano_tpu_torch.framework import Session
    from volcano_tpu_torch.ops import shard_wave as sw
    from volcano_tpu_torch.ops.allocate_scan import make_allocate_cycle
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    ssn = Session(_synthetic_cluster(*chip_smoke.FULL),
                  chip_smoke.wave_conf(True), device="cuda")
    cfg, extras = ssn._derived_allocate_inputs()
    snap, extras = to_device(ssn.snap, "cuda"), to_device(extras, "cuda")

    class Stop(Exception):
        pass

    seen = []

    def placer(*args):
        if len(seen) >= window:
            raise Stop()
        seen.append(1)
        return sw.shard_wave(*args)
    cycle = make_allocate_cycle(cfg, mesh=ssn._sharding_mesh(),
                                wave_placer=placer)
    runs = []
    for k in range(reps + 1):
        seen.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            cycle(snap, extras)
        except Stop:
            torch.cuda.synchronize()
        if k:
            runs.append((time.perf_counter() - t0) * 1000 / window)
    return dict(ms_per_wave=runs, best=min(runs))


def wave_profile(tree, window, cycles):
    """The tree's own wave-cell profile, in a process of its own."""
    out = os.path.join(tree, "chiprun_out", "ab_wave_profile.json")
    res = subprocess.run(
        [sys.executable, os.path.join(tree, "scripts",
                                      "torch_cycle_profile.py"),
         "--cell", "wave", "--window", str(window), "--cycles", str(cycles),
         "--out", out], cwd=tree, capture_output=True, text=True,
        timeout=1800)
    if res.returncode != 0:
        sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
        raise SystemExit(f"{tree}: the wave profile failed")
    with open(out) as f:
        prof = json.load(f)
    keep = ("cycle_ms", "launches", "profiled_waves", "profiled_pops",
            "device_idle_share", "wave_kernel_device_ms_per_launch",
            "per_wave", "per_pop")
    return {k: prof.get(k) for k in keep}


PARTS = ("dyn", "planted", "wave", "seg_fold", "wave_window",
         "wave_profile", "fair_share_profile")


def child(tree, parts, window, cycles):
    """One tree's run, in this process; prints its JSON object last."""
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    run = dict(dyn=dyn_launch_times, planted=planted_times, wave=wave_times,
               seg_fold=seg_fold_times,
               wave_window=lambda: wave_window(window),
               wave_profile=lambda: wave_profile(tree, window, cycles),
               fair_share_profile=lambda: fair_share_profile(tree, window))
    out = dict(tree=tree)
    for part in parts:
        out[part] = run[part]()
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[HERE])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=PARTS)
    ap.add_argument("--wave-window", type=int, default=500)
    ap.add_argument("--wave-cycles", type=int, default=0)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    opts = ap.parse_args(argv)
    if opts.child:
        return child(opts.child, opts.parts, opts.wave_window,
                     opts.wave_cycles)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = []
    for _ in range(opts.rounds):
        for tree in opts.trees + opts.trees[::-1]:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", tree,
                 "--parts", *opts.parts, "--wave-window",
                 str(opts.wave_window), "--wave-cycles",
                 str(opts.wave_cycles)],
                capture_output=True, text=True, timeout=3000)
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
