"""Where the time of one volcano_tpu_torch allocate cycle goes, on the card.

    python3 scripts/torch_cycle_profile.py
        [--cell north_star | fair_share | affinity | sharded | wave]
        [--nodes 10000 --jobs 6250 --tasks-per-job 16] [--window N]
        [--cycles 2] [--out PATH]

The ``north_star`` cell (default) is the synthetic cluster of the given
size under gang + binpack: the static-key path. The ``fair_share`` cell is
``chip_smoke.py``'s check B: the bench's configuration 3 (1024 nodes, 8
weighted queues, 3,125 gangs of 16) under the shipped
``conf/volcano-scheduler.conf``: the dynamic-key path. The ``affinity``
cell is ``chip_smoke.py``'s check E: BASELINE configuration 5
(``synthetic.affinity_scenario(10000, 2500)``, rack anti-affinity and zone
preferred affinity) under gang + predicates + binpack: the static-key path
with the pod-affinity step in the round placer. The ``sharded`` cell is
``chip_smoke.py``'s check G: the north-star cluster under gang + binpack
with ``sharding: true``, the sharded scan path (one pop and one attempt at
a time, each attempt one launch of the shard-local candidate kernel, whose
last block also combines the shards); its numbers are per pop and per
attempt, and ``--window`` counts attempts. The
``wave`` cell is ``chip_smoke.py``'s check I: the north-star cluster under
``chip_smoke.wave_conf`` (gang + nodeorder, least-requested and balanced
at 1, no binpack) with ``sharding: true`` and ``wave_width: 8``, the
wavefront walk (waves of 8 slots, each one launch of the wide candidate
kernel, whose last blocks also combine the shards' lists, the
batched-commit check, then the batched commit or the in-order walk); its
numbers are per pop and per wave, and
``--window`` counts waves. The script packs and
uploads the snapshot once, runs the allocate cycle once to build and warm
the kernels, then:

1. times ``--cycles`` plain runs of the cycle on the host clock (each ends
   in a synchronize), with the kernels' launch counts;
2. runs it once more under ``torch.profiler`` and reports the device time
   by kernel name (the 12 longest, and every kernel of the port) and the union of device busy intervals against the
   profiled wall time (the device's idle share). With ``--window N`` the
   profiled run stops after N placer launches: a steady window of a long
   cycle, whose numbers are per round. The profiled run also reports the
   host time of the cycle's steps (``host_ms_by_step``: each of
   ``namespace_shares``, ``drf_job_shares``, ``hdrf_level_keys``,
   ``lex_argmin`` and ``gather_slot_tables`` in ``ops/allocate_scan.py``,
   the shard placer's ``combine`` (no call on the card, where kernel 4
   combines; the plain route's), the wave walk's steps (``wave_sweep``,
   the kernel-5 launch with its combine, ``wave_fast_ok`` with its readback,
   ``wave_commit_fast``, ``wave_commit_slow``) and the placer calls,
   wrapped in a profiler span; the rest of a round is the loop's own
   tensor work) and
   the calls that make the host wait for the device or copy between the
   two (``waits_by_name``: stream and device synchronisations, memory
   copies), both per placer launch, in the sharded cell per pop and per
   attempt, and in the wave cell per pop and per wave.

Needs a CUDA card; prints one JSON object, and writes it to ``--out`` when
given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", choices=("north_star", "fair_share",
                                       "affinity", "sharded", "wave"),
                    default="north_star")
    ap.add_argument("--window", type=int, default=0,
                    help="profile only the first N placer launches")
    ap.add_argument("--nodes", type=int, default=10000)
    ap.add_argument("--jobs", type=int, default=6250)
    ap.add_argument("--tasks-per-job", type=int, default=16)
    ap.add_argument("--cycles", type=int, default=2,
                    help="timed cycles before the profiled one (with "
                    "--window, 0 runs no whole cycle)")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from volcano_tpu_torch.arrays import to_device
    from volcano_tpu_torch.framework import (PluginOption,
                                             SchedulerConfiguration, Session,
                                             Tier)
    from volcano_tpu_torch.ops import allocate_scan as tas
    from volcano_tpu_torch.ops import dyn_placer as dp
    from volcano_tpu_torch.ops import round_placer as rp
    from volcano_tpu_torch.ops.allocate_scan import make_allocate_cycle
    from volcano_tpu_torch.synthetic import _synthetic_cluster

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    if args.cell == "fair_share":
        import chip_smoke
        from volcano_tpu_torch.synthetic import fair_share_cluster
        ci, conf = fair_share_cluster(), chip_smoke.shipped_conf()
    elif args.cell == "affinity":
        import chip_smoke
        from volcano_tpu_torch.synthetic import affinity_scenario
        ci = affinity_scenario(*chip_smoke.CHECK_E[0])
        conf = chip_smoke.affinity_conf()
    elif args.cell == "wave":
        import chip_smoke
        conf = chip_smoke.wave_conf(True)
        ci = _synthetic_cluster(args.nodes, args.jobs, args.tasks_per_job)
    else:
        conf = SchedulerConfiguration(actions=["allocate"], tiers=[
            Tier([PluginOption("gang"), PluginOption("binpack")])])
        conf.sharding = args.cell == "sharded"
        ci = _synthetic_cluster(args.nodes, args.jobs, args.tasks_per_job)
    ssn = Session(ci, conf, device="cuda")
    cfg, extras = ssn._derived_allocate_inputs()
    snap_d, extras_d = to_device(ssn.snap, "cuda"), to_device(extras, "cuda")
    try:
        from volcano_tpu_torch.ops import shard_placer as sp
        mesh = dict(mesh=ssn._sharding_mesh())
    except ImportError:                   # a tree from before the kernel
        sp, mesh = None, {}
    try:
        from volcano_tpu_torch.ops import shard_wave as sw
    except ImportError:                   # a tree from before the kernel
        sw = None
    cycle = make_allocate_cycle(cfg, **mesh)

    class Stop(Exception):
        pass

    def window(place, seen, limit):
        def placer(*a):
            if len(seen) >= limit:
                raise Stop()
            seen.append(1)
            return place(*a)
        return placer

    def windowed(limit, seen, **seams):
        """The cycle's placers behind a window of ``limit`` launches."""
        seams = {k: window(v, seen, limit) for k, v in seams.items()}
        return make_allocate_cycle(cfg, **mesh, **seams)

    all_seams = dict(placer=rp.round_place, dyn_placer=dp.dyn_place)
    if sp is not None:
        all_seams["shard_placer"] = sp.shard_candidates
    if sw is not None:
        all_seams["wave_placer"] = sw.shard_wave
    try:                                  # build + warm
        (windowed(args.window, [], **all_seams) if args.window
         else cycle)(snap_d, extras_d).packed_decisions().cpu()
    except Stop:
        torch.cuda.synchronize()

    try:
        from volcano_tpu_torch.ops import seg_fold as sf
    except ImportError:                   # a tree from before the kernel
        sf = None
    wall = []
    for _ in range(args.cycles):
        rp.launches = dp.launches = 0
        if sf is not None:
            sf.launches = 0
        if sp is not None:
            sp.launches = sp.pops = 0
        if sw is not None:
            sw.launches = sw.waves = sw.fast_waves = sw.truncations = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cycle(snap_d, extras_d).packed_decisions().cpu()
        wall.append((time.perf_counter() - t0) * 1000)
    launches = {"round_placer": rp.launches, "dyn_placer": dp.launches,
                "seg_fold": sf.launches if sf is not None else None,
                "pod_affinity": (getattr(rp, "aff_launches", 0)
                                 + getattr(dp, "aff_launches", 0)),
                "shard_candidates": sp.launches if sp is not None else None,
                "shard_pops": sp.pops if sp is not None else None,
                "shard_wave": sw.launches if sw is not None else None,
                "waves": sw.waves if sw is not None else None,
                "fast_waves": sw.fast_waves if sw is not None else None,
                "truncations": sw.truncations if sw is not None else None}

    seen = []
    from torch.profiler import ProfilerActivity, profile, record_function

    def span(name, fn):
        def wrapped(*a, **kw):
            with record_function("step:" + name):
                return fn(*a, **kw)
        return wrapped

    seams = dict(all_seams)
    if args.window:
        seams = {k: window(v, seen, args.window) for k, v in seams.items()}
    names = dict(placer="round_placer", dyn_placer="dyn_placer",
                 shard_placer="shard_placer", wave_placer="wave_placer")
    profiled = make_allocate_cycle(
        cfg, **mesh, **{k: span(names[k], v) for k, v in seams.items()})
    steps = ["namespace_shares", "drf_job_shares", "hdrf_level_keys",
             "lex_argmin", "gather_slot_tables"]
    steps = [n for n in steps if hasattr(tas, n)]   # a tree before a step
    for name in steps:
        setattr(tas, name, span(name, getattr(tas, name)))
    if sp is not None:
        sp.combine = span("combine", sp.combine)
        sp.pops = 0
        steps.append("combine")
    if sw is not None and hasattr(tas, "_step"):
        tas._step = lambda name: record_function("step:" + name)
        sw.waves = 0
        steps += ["wave_sweep", "wave_fast_ok", "wave_commit_fast",
                  "wave_commit_slow"]
    steps += [names[k] for k in seams]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            profiled(snap_d, extras_d).packed_decisions().cpu()
        except Stop:
            torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1000
    by_name, intervals = {}, []
    host_steps = {n: [0, 0.0] for n in steps}
    waits = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            if ev.name.startswith("step:"):
                h = host_steps[ev.name[5:]]
                h[0] += 1
                h[1] += (ev.time_range.end - ev.time_range.start) / 1000
            elif "Synchronize" in ev.name or "Memcpy" in ev.name:
                w = waits.setdefault(ev.name, [0, 0.0])
                w[0] += 1
                w[1] += (ev.time_range.end - ev.time_range.start) / 1000
            continue
        if ev.name.startswith("step:"):    # the spans' device-side echo
            continue
        s, e = ev.time_range.start, ev.time_range.end
        intervals.append((s, e))
        if "Memcpy" in ev.name:            # the device side of a copy
            w = waits.setdefault("device: " + ev.name, [0, 0.0])
            w[0] += 1
            w[1] += (e - s) / 1000
        d = by_name.setdefault(ev.name, [0, 0.0])
        d[0] += 1
        d[1] += (e - s) / 1000
    busy_ms = busy_us(intervals) / 1000
    # the 12 that took the most device time, and every kernel of the port
    # (each in an anonymous namespace of its csrc/ source; a template's
    # name begins with its return type)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    top = top[:12] + [kv for kv in top[12:]
                      if kv[0].startswith(("(anonymous namespace)::",
                                           "void (anonymous namespace)::"))]
    out = {
        "card": card, "cell": args.cell,
        "nodes": int(ssn.snap.nodes.valid.sum()),
        "tasks": int(ssn.snap.tasks.valid.sum()),
        "cycle_ms": wall, "launches": launches,
        "profiled_launches": len(seen) if args.window else None,
        "profiled_cycle_ms": prof_wall_ms,
        "device_events": sum(v[0] for v in by_name.values()),
        "device_busy_ms": busy_ms if intervals else None,
        "device_idle_share": (1 - busy_ms / prof_wall_ms) if intervals
        else None,
        "device_ms_by_name": {k: {"count": v[0], "ms": v[1]} for k, v in top},
        "host_ms_by_step": {k: {"calls": v[0], "ms": v[1]}
                            for k, v in host_steps.items()},
        "waits_by_name": {k: {"calls": v[0], "ms": v[1]}
                          for k, v in waits.items()},
    }
    if args.cell == "wave":
        # per pop and per wave (one kernel-5 launch a wave)
        waves = len(seen) if args.window else launches["shard_wave"]
        denoms = {"per_pop": sp.pops, "per_wave": waves}
        out["profiled_pops"] = sp.pops
        out["profiled_waves"] = sw.waves
        wave_dev = by_name.get(next((k for k in by_name
                                     if "shard_wave_kernel" in k), ""))
        if wave_dev:
            out["wave_kernel_device_ms_per_launch"] = (wave_dev[1]
                                                       / wave_dev[0])
    elif args.cell == "sharded":
        # per pop and per attempt (one kernel-4 launch an attempt)
        attempts = len(seen) if args.window else launches["shard_candidates"]
        denoms = {"per_pop": sp.pops, "per_attempt": attempts}
        out["profiled_pops"] = sp.pops
        shard_dev = by_name.get(next((k for k in by_name
                                      if "shard_cand_kernel" in k), ""))
        if shard_dev:
            out["shard_kernel_device_ms_per_launch"] = (shard_dev[1]
                                                        / shard_dev[0])
    else:
        rounds = len(seen) if args.window else (launches["round_placer"]
                                                + launches["dyn_placer"])
        denoms = {"per_launch": rounds}
    for key, n in denoms.items():
        if n:
            out[key] = {
                "host_ms_by_step": {k: v[1] / n
                                    for k, v in host_steps.items()},
                "waits_by_name": {k: v[0] / n for k, v in waits.items()}}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
