"""Chip check of volcano_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) when it fails:

1. device: a CUDA card must be present (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles every CUDA kernel of the paths from ``csrc/`` (one nvcc
   per source, all started together) and prints ptxas's report;
3. round placer against its plain version: the arguments of the first 3
   kernel launches of the full-scale cycle, of a small snapshot with GPU
   requests and of a gang that must be discarded go through the kernel (a
   thread-block cluster, at 8 and at 16 blocks) and through its plain
   PyTorch version on the card; every output must be bitwise equal
   (tolerance 0);
4. static-key path: ``Session(_synthetic_cluster(10000, 6250, 16), gang +
   binpack).run_allocate()`` on the card, the repository's north-star size
   (10,000 nodes, 100,000 pending tasks); pack, cycle and apply are timed
   apart; the launch counts are set to 0 just before and read just after,
   and the round placer must have launched; the decision fingerprint must
   be the one the JAX package and its numpy oracle give, f61d52ccc18b1e69;
   this is check M's cycle 0, a full upload into the Session's resident
   buffers (phase 27);
5. sub-scale: at (1024, 640, 16) the kernel cycle and the plain cycle on the
   card give equal packed decisions, with fingerprint 60a8509ec33e772c;
6. round placer time: CUDA events around launches at the main path's
   shapes, as clusters of 16 and of 8 blocks (the cycle's is
   ``round_placer.CLUSTER``), beside the plain version's time and the
   least time the card could take; and one cluster exchange alone (CUDA
   events around a probe of 20,000), which times the attempts give the
   design's latency floor;
7. dynamic-key placer against its plain version, bitwise, as a
   thread-block cluster of its default size (``dyn_placer.CLUSTER``) and of
   the other (16 and 8 blocks): the first 3 launches of check B's cycle,
   and small built inputs (``ops/dyn_cases.py`` DYN_CASES) for a gang
   discard and demotion, a zero-deserved queue, drf with 3 namespaces, GPU
   requests, the hdrf guard, a short pop budget, padded candidates and
   the sla deadline key; and the segmented sum (the cycle's drf
   namespace fold, once a round) against its plain version, bitwise, on
   check B's job allocations at the cycle's start and at the recorded
   launches, and on seeded values whose sums depend on the order;
8. check A: the bench's fair-share configuration 3 (bench.py:680-716: 1024
   nodes, 8 weighted queues, 3,125 gangs of 16 tasks, drf job order,
   binpack) built without a Session; fingerprint c4b4ff88c1a32065, 16,404
   tasks placed;
9. check B, the dynamic-key main path: ``Session(cluster of check A, the
   shipped conf/volcano-scheduler.conf).run_allocate()`` (drf job and
   namespace order, proportion, predicates, nodeorder, binpack, priority,
   gang, conformance); the counts are set to 0 just before and read just
   after, and the dynamic-key placer and the segmented sum must have
   launched; fingerprint
   f2d84749323295e1, 16,530 tasks placed, 1,330 jobs ready;
10. checks C and D: the shipped conf at (1024, 640, 16), kernel cycle and
   plain cycle on the card, both 3ae3ff8ac7b0b9b7, with equal dynamic-key
   launches (the plain cycle's placer calls), pops and early stops; and at
   the north-star size, ca79ec8f9cd6b7f6 with 16 tasks placed (every
   queue's deserved is 0 there: the reference's proportion sentinel,
   ROADMAP section 3 (d));
11. dynamic-key placer and segmented sum times at check B's shapes: the
   placer at check B's first launch as clusters of 16 and of 8 blocks, two
   runs each (its device time per launch in a ``torch.profiler`` trace,
   and CUDA events around the run, which time the wrapper's host work),
   and its phase split at each size (``dyn_placer.phase_split``: block 0's
   clock64() cycles of the prologue, the queue gate and namespace fold,
   eligibility, the argmin with its exchange, the section's attempts and
   the finalize); the segmented sum at check B's second call (the
   namespace fold after the cycle's first launch, few terms yet) and on
   the same segments over seeded values (a term in every kept row: the
   kernels line's reading), its device time per launch in a
   ``torch.profiler`` trace and CUDA events around the run, with
   ``index_add_`` as its library call;
12. the pod-affinity step (kernel 2 of the reference) in both placers
   against the plain versions, bitwise: the first 3 launches of check E's
   cycle, and small built inputs (``ops/dyn_cases.py`` AFF_CASES) for the
   first-pod escape, own and symmetric anti-affinity, negative preferred
   weights, no live node, a gang discard that must take the counts back,
   in the round placer and in the dynamic-key placer with drf (at both of
   its cluster sizes);
13. check E, this slice's main path: ``Session(affinity_scenario(10000,
   2500), gang + predicates + binpack).run_allocate()``, BASELINE
   configuration 5 (10,000 nodes in 16 zones and 500 racks, 2,500 gangs of
   8, required rack anti-affinity and preferred zone affinity); the counts
   are set to 0 just before and read just after, and the round placer must
   have launched with pod affinity on; fingerprint a2267c3d4e340d03, the
   JAX Session's; then the raw configuration-5 cycle as
   ``scripts/affinity_record.py`` builds it (pack, ``build_affinity``,
   binpack 1 through ``derive_batching``, no Session): the same
   fingerprint, which the numpy oracle gives too;
14. check F, the dynamic-key path with pod affinity:
   ``Session(affinity_scenario(1024, 320, seed=1), the shipped
   conf).run_allocate()``: the dynamic-key placer must have launched with
   pod affinity on, and the kernel cycle and the plain cycle on the card
   both give 07085317a58495b3, the JAX Session's, with equal launches,
   pops and early stops;
15. the pod-affinity step's own time: CUDA events around the round placer
   (at its cycle's cluster size) at check E's shapes, and the dynamic-key
   placer at check F's, with pod affinity on and off, beside the plain
   versions' and the bound;
16. the shard-local candidate search (kernel 4 of the reference) against
   its plain version, all 8 per-shard outputs and the combined triple
   (against ``combine`` of the plain version) bitwise: the first 64
   launches of check G's cycle, and small built inputs (``ops/dyn_cases.py``
   SHARD_CASES) at 1 and 4 shards, with GPU cards and without, ties planted
   across shards and shards with no feasible row, at each of the grid's
   four block shapes;
17. check G, the sharded path at the north star: ``Session(
   _synthetic_cluster(10000, 6250, 16), gang + binpack, sharding:
   true).run_allocate()`` on the one card (a mesh of one shard): one pop and
   one attempt at a time; the counts are set to 0 just before and read
   just after, and the candidate kernel must have launched, and
   ``shard_placer.combine`` never (the kernel combines); fingerprint
   f61d52ccc18b1e69 and 100,000 binds;
18. check H: ``make_sharded_allocate`` on a 4-shard virtual mesh of the
   card: ``_synthetic_cluster(1024, 256, 16)`` under
   ``AllocateConfig(binpack_weight=1.0)`` with neutral extras gives
   0bed0b3363cfef13 (4,096 placed, 256 gangs ready), at 4 shards and at 1;
   and as a plain cycle on the card (the plain version in place of the
   kernel) at 4 shards gives the same decisions (the shipped conf on
   4 shards runs in check J, on the wave path);
19. the candidate kernel's time: device time per launch in a
   ``torch.profiler`` trace at check G's shapes (1 shard of 10,240 rows)
   for each block shape of its grid (128 or 256 threads, one or two rows a
   thread: the blocks B and rows ROWS are printed) and at 4 shards of
   2,560, beside the plain version's and the bound; the combined triple of
   check G's first attempt against ``combine`` of the plain version;
20. the wide candidate search (kernel 5 of the reference) against its plain
   version, the 4 per-shard outputs and the 5 combined ones (against
   ``combine`` of the plain version) bitwise: the first 32 launches of
   check I's cycle, and small built inputs (``ops/dyn_cases.py``
   WAVE_CASES) at 1 and 4 shards and W = 4, 8 and 16, with GPU cards;
21. check I, the wavefront walk at the north star: ``Session(
   _synthetic_cluster(10000, 6250, 16), gang + nodeorder with
   leastrequested and balancedresource at 1 and every other weight 0,
   sharding: true, wave_width: 8).run_allocate()`` on the one card (a mesh
   of one shard): waves of 8 slots, one kernel-5 launch a wave; the counts
   are set to 0 just before and read just after, kernel 5 must have
   launched and kernel 4 not, and ``shard_wave.combine`` never (the
   kernel combines); the fingerprint must be the one the fused
   Session (no sharding, the same conf: kernel 1, W clamped to 1) gives on
   the same cluster, with 100,000 binds;
22. check J: check H's configurations on the wave path, on 4 virtual
   shards of the card: the binpack configuration at W = 4 and W = 16 gives
   0bed0b3363cfef13, and the shipped conf at (1024, 640, 16) at W = 8 gives
   3ae3ff8ac7b0b9b7 (check C's; its dynamic keys yield inside waves),
   each without a call of ``shard_wave.combine``;
23. the wide candidate kernel's time: device time per launch in a
   ``torch.profiler`` trace and CUDA events around the run (the wrapper's
   host pace) at check I's first launch (1 shard of 10,240 rows, 8
   columns) and at 4 shards of 2,560, beside the plain version's and the
   bound;
24. kernel 6 (graphcheck's planted shard gather,
   ``analysis/sharding.planted_gather``): the fixture on the card at the
   reference's (D = 2, 32 nodes, 4 columns) and at (D = 4, 10,240 nodes,
   4 columns), check G's padded node axis; the counts are set to 0 just
   before the second and read just after, and kernel 6 must have launched
   once a shard; each launch's output against the plain version on the
   same gathered block, and the fixture's output against ``x * 2``,
   bitwise; the sharding audit (``pallas_block_findings``) must flag the
   planted launches with the key ``sharding:pallas-block:<where>:(n, 4)``
   and find nothing in the launch records of check H's cycle (phase 18, 4
   shards) and check J's binpack cycle at W = 4 (phase 22), which must not
   be empty; then kernel 6's time for the fixture's 4 launches (CUDA
   events; the best of three runs, alternated with the others), beside
   the plain version's, ``torch.mul`` on the gathered block (the library
   call) and the bound;
25. check K, the shipped conf's whole action list:
   ``Session(admission_scenario(), check K's conf, now=4149.0)`` and
   ``get_action(name).execute(ssn)`` for enqueue, allocate and backfill:
   check B's cluster as a burst of 3,125 Pending gangs with queue
   capabilities, every 10th gang under a 300 s SLA, and 1,024 best-effort
   jobs, under conf/volcano-scheduler-ci.conf's tiers (its reclaim and
   preempt wait for ROADMAP item 5b); the counts are set to 0 just before
   and read just after, and the dynamic-key placer and the segmented sum
   must have launched; the enqueued count and admitted mask, the allocate
   fingerprint and binds, and the backfill count and binds must be the JAX
   Session's; then the dynamic-key kernel's first 3 launches on the
   allocate cycle's own inputs (the sla deadline an ordering key, the
   snapshot repacked after enqueue; at both cluster sizes), enqueue's 3
   one-segment sums and the cycle's namespace folds at check K's shapes,
   each against its plain version, bitwise;
26. check L, many namespaces under the shipped conf:
   ``_synthetic_cluster(256, 160, 16)`` with job j in namespace
   ``ns-{j % 40}`` (64 padded namespaces: 128 drf namespace-fold pairs,
   four tiles of 32 in kernel 3); kernel 3's first 3 launches bitwise
   against the plain version at both cluster sizes; the counts are set to
   0 just before the Session's cycle and read just after, and kernel 3
   must have launched; fingerprint, tasks placed and jobs ready must be
   the JAX Session's (``scripts/check_l_targets.py``); then one churn
   cycle (5 % of the gangs complete, as many go back to Pending:
   ``synthetic.steady_churn``) through reopen, dispatch and complete,
   held to a fresh full Session on a copy of the cluster taken before it;
27. check M, this slice's main path: three such churn cycles of the north
   star's Session of phase 4 (about 312 gangs, 5,000 tasks, each way a
   cycle), each a refresh in place and a delta upload into the resident
   buffers with no digest mismatch, the round placer's launches counted
   from 0, and the fingerprint of a fresh full Session on a copy of the
   cluster taken before the cycle; each prints its refresh ms beside the
   fresh Session's pack ms, its upload bytes beside a full upload's, its
   drain's readback bytes and its cycle ms;
28. kernel 3's namespace fold in tiles: at check B's job and node counts
   with 4, 32 and 64 namespaces at two dims (P = 8, 64 and 128 pairs),
   bitwise against the plain version, its device time per launch (phase
   11's method), the same launches timed by CUDA events behind a spin
   kernel (``device_ms``'s way when no trace keeps a launch) and its
   phase split; kernel 3's entry of the kernels line carries the pair
   tile and these times;
29. check N, a MIG-partitioned GPU cluster at 12 resource dims:
   ``_synthetic_cluster(256, 160, 16, extended=10)`` (cpu, memory and ten
   extended resources: whole GPUs, five MIG profiles, two hugepage sizes,
   RDMA devices, ephemeral storage), past the 8 dims the kernels once
   kept in registers. Four Sessions on it, each with its launch counts
   set to 0 just before its cycle and read just after: gang + binpack
   (kernel 1), the shipped conf's enqueue and allocate (``seg_fold``,
   kernel 3), gang + binpack with ``sharding: true`` (kernel 4, one
   shard) and with ``wave_width: 8`` on top (kernel 5). The first two
   fingerprints must be the JAX Session's
   (``scripts/check_n_targets.py``), the mesh runs the gang + binpack
   one (the reference's sharded and wave paths give the unsharded
   decisions), and the gang + binpack one also the port's numpy oracle's
   (``Session.run_allocate_oracle``, on a copy of the cluster). Each of
   the five kernels is held bitwise against its plain version on launches
   recorded at R = 12 and timed there; the kernels line carries those
   times as ``r12``.

The expected fingerprints are the JAX package's scan path's (and, for A,
B, D and the raw configuration-5 cycle, its oracle's too). Each phase's
seconds are printed on a ``phase_seconds`` line. The second-to-last line
holds the kernels' JSON record, the last line ``{"ok": true, "device":
{...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import traceback

FULL = (10000, 6250, 16)
FULL_SHA = "f61d52ccc18b1e69"
SUB = (1024, 640, 16)
SUB_SHA = "60a8509ec33e772c"
#: the dynamic-key checks: fingerprint, tasks placed (and jobs ready)
CHECK_A = ("c4b4ff88c1a32065", 16404)
CHECK_B = ("f2d84749323295e1", 16530, 1330)
CHECK_C = "3ae3ff8ac7b0b9b7"
CHECK_D = ("ca79ec8f9cd6b7f6", 16)
#: check E (BASELINE configuration 5) and check F: cluster size, and
#: fingerprint, tasks placed and jobs ready
CHECK_E = ((10000, 2500), ("a2267c3d4e340d03", 20000, 2500))
CHECK_F = ((1024, 320, 1), ("07085317a58495b3", 1961, 268))
#: check H: cluster size, fingerprint, tasks placed and jobs ready
CHECK_H = ((1024, 256, 16), ("0bed0b3363cfef13", 4096, 256))
#: check I's wave width; check J's widths for the binpack configuration and
#: for the shipped conf
WAVE_I = 8
WAVES_J = ((4, 16), 8)
#: check K: enqueued jobs and sha256 of the admitted mask, the allocate
#: fingerprint and binds, backfilled tasks and sha256 of their (task, node)
#: pairs: the JAX Session's on the same cluster and conf (PERF.md section 2)
CHECK_K = (2675, "8da50a76f2936639", "ff4864be716c903f", 16498, 512,
           "4650ef8564235adc")
#: check L: the cluster (nodes, gangs, tasks a gang), its namespaces, and
#: the JAX Session's fingerprint, tasks placed and jobs ready under the
#: shipped conf (env JAX_PLATFORMS=cpu python scripts/check_l_targets.py)
CHECK_L = ((256, 160, 16), 40, ("33fdad6704feca1a", 2560, 160))
#: check N: the cluster (nodes, gangs, tasks a gang), its extended
#: resources, and the JAX Session's fingerprint, tasks placed and jobs ready
#: under gang + binpack and under the shipped conf (env JAX_PLATFORMS=cpu
#: python scripts/check_n_targets.py)
CHECK_N = ((256, 160, 16), 10, {"static": ("31eb63c33ca4a012", 1313, 83),
                                "shipped": ("95c88f1c827d1551", 721, 52)})
#: churn a cycle (a share of the placed gangs completes, as many go back to
#: Pending), its seed, and the churn cycles of check M; check L runs one
CHURN = (0.05, 11)
CHURN_CYCLES = 3
#: kernel 3's fold timing: namespaces at two dims (P = 8, 64, 128 pairs)
FOLD_S = (4, 32, 64)
#: kernel 6's fixture shapes: the reference's default, and check G's padded
#: node axis (shards, nodes, columns)
PLANTED = ((2, 32, 4), (4, 10240, 4))
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def log(msg):
    print(msg, flush=True)


def fail(phase, exc=None):
    if exc is not None:
        traceback.print_exc()
    print(f"chip_smoke: phase {phase} failed", file=sys.stderr, flush=True)
    sys.exit(1)


def fingerprint(task_node, task_mode):
    import hashlib

    import numpy as np
    return hashlib.sha256(np.asarray(task_node).tobytes()
                          + np.asarray(task_mode).tobytes()).hexdigest()[:16]


def gang_binpack_conf():
    from volcano_tpu_torch.framework import (PluginOption,
                                             SchedulerConfiguration, Tier)
    return SchedulerConfiguration(actions=["allocate"], tiers=[
        Tier([PluginOption("gang"), PluginOption("binpack")])])


def affinity_conf():
    """The north-star conf plus the predicates plugin, which carries
    InterPodAffinity (predicates.go:196-200)."""
    from volcano_tpu_torch.framework import (PluginOption,
                                             SchedulerConfiguration, Tier)
    return SchedulerConfiguration(actions=["allocate"], tiers=[
        Tier([PluginOption("gang"), PluginOption("predicates"),
              PluginOption("binpack")])])


def shipped_conf():
    """conf/volcano-scheduler.conf as the framework's dataclasses (the card's
    machine has no PyYAML)."""
    from volcano_tpu_torch.framework import (PluginOption,
                                             SchedulerConfiguration, Tier)
    return SchedulerConfiguration(
        actions=["enqueue", "allocate", "backfill"], tiers=[
            Tier([PluginOption(n) for n in ("priority", "gang",
                                            "conformance")]),
            Tier([PluginOption(n) for n in ("drf", "predicates",
                                            "proportion", "nodeorder",
                                            "binpack")])])


def check_k_conf():
    """Check K's conf: conf/volcano-scheduler-ci.conf's tiers (priority,
    gang, conformance, sla | drf, predicates, proportion, nodeorder,
    binpack, overcommit) with the actions enqueue, allocate, backfill (its
    reclaim and preempt are not ported yet)."""
    from volcano_tpu_torch.framework import (PluginOption,
                                             SchedulerConfiguration, Tier)
    return SchedulerConfiguration(
        actions=["enqueue", "allocate", "backfill"], tiers=[
            Tier([PluginOption(n) for n in ("priority", "gang",
                                            "conformance", "sla")]),
            Tier([PluginOption(n) for n in ("drf", "predicates",
                                            "proportion", "nodeorder",
                                            "binpack", "overcommit")])])


def sharded_conf():
    """The north-star conf (gang + binpack) with ``sharding: true``."""
    conf = gang_binpack_conf()
    conf.sharding = True
    return conf


def wave_conf(sharding):
    """Check I's conf: the bench's wavefront scoring (bench.py:1417-1422:
    least_allocated 1 + balanced 1, no binpack, which funnels every slot
    onto one node) as gang + nodeorder with leastrequested.weight and
    balancedresource.weight 1 and every other nodeorder weight 0;
    ``wave_width: 8``, and ``sharding: true`` when asked (without it the
    fused placers take W = 1)."""
    from volcano_tpu_torch.framework import (PluginOption,
                                             SchedulerConfiguration, Tier)
    weights = {"leastrequested.weight": "1", "balancedresource.weight": "1",
               "mostrequested.weight": "0", "tainttoleration.weight": "0",
               "nodeaffinity.weight": "0", "podaffinity.weight": "0"}
    conf = SchedulerConfiguration(actions=["allocate"], tiers=[
        Tier([PluginOption("gang"),
              PluginOption("nodeorder", arguments=weights)])])
    conf.sharding = sharding
    conf.wave_width = WAVE_I
    return conf


class SegFoldTap:
    """Seam on a module's ``seg_fold``: launches the wrapper as before and
    keeps a copy of the arguments of every call made while installed."""

    def __init__(self, module):
        self.module, self.calls = module, []
        self.wrapped = module.seg_fold

    def __call__(self, vals, seg, num):
        self.calls.append((vals.clone(), seg.clone(), num))
        return self.wrapped(vals, seg, num)

    def __enter__(self):
        self.module.seg_fold = self
        return self

    def __exit__(self, *exc):
        self.module.seg_fold = self.wrapped


class CountCalls:
    """While installed (a context), counts the calls of ``module.name``,
    which it passes on."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0
        self.wrapped = getattr(module, name)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.wrapped(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.wrapped)


class Recorder:
    """Placer seam: launches the kernel and keeps a copy of the arguments
    of its first ``keep`` launches; ``stop_after`` ends the cycle early.
    ``dyn`` watches the dynamic-key placer instead of the round placer."""

    class Stop(Exception):
        pass

    def __init__(self, keep, stop_after=None, dyn=False):
        self.keep, self.stop_after, self.dyn = keep, stop_after, dyn
        self.calls = []

    def __call__(self, cfg, *shape_and_args):
        from volcano_tpu_torch.ops import dyn_placer as dp
        from volcano_tpu_torch.ops import round_placer as rp
        *shape, args = shape_and_args
        if len(self.calls) < self.keep:
            self.calls.append((cfg, *shape, [a.clone() for a in args]))
        if self.stop_after is not None and len(self.calls) >= self.stop_after:
            raise Recorder.Stop()
        if self.dyn:
            return dp.dyn_place_cuda(cfg, *shape, args)
        return rp.round_place_cuda(cfg, *shape, args)


def record_launches(ssn, keep, stop_after=None, dyn=False, inputs=None):
    """Run the session's allocate cycle on the card through a Recorder, on
    ``inputs`` (snapshot, cfg, extras) when given, else on the session's
    snapshot and derived inputs as they stand."""
    from volcano_tpu_torch.arrays import to_device
    from volcano_tpu_torch.ops.allocate_scan import make_allocate_cycle
    snap, cfg, extras = inputs or (ssn.snap,
                                   *ssn._derived_allocate_inputs())
    rec = Recorder(keep, stop_after, dyn)
    seam = dict(dyn_placer=rec) if dyn else dict(placer=rec)
    try:
        make_allocate_cycle(cfg, **seam)(to_device(snap, "cuda"),
                                         to_device(extras, "cuda"))
    except Recorder.Stop:
        pass
    return rec.calls


def bitwise_equal(a, b):
    """Same dtype, shape and bits (float32 compared as its int32 bits)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def compare_kernel_plain(calls, cbs=(8, 16)):
    """Max |kernel - plain| over every output of every recorded launch, the
    kernel as a cluster of each of ``cbs`` blocks; raises unless all
    outputs are bitwise equal."""
    import torch

    from volcano_tpu_torch.ops import round_placer as rp
    worst = 0.0
    for cfg, K, M, args in calls:
        want = rp.round_place_plain(cfg, K, M, args)
        for cb in cbs:
            got = rp.round_place_cuda(cfg, K, M, args, cb=cb)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                worst = max(worst,
                            float((g.double() - w.double()).abs().max()))
                if not bitwise_equal(g, w):
                    raise AssertionError(f"kernel (CB={cb}) and plain "
                                         f"version differ")
    return worst


def small_clusters():
    """A snapshot with shared-GPU requests, and a gang that cannot reach
    minAvailable beside one that can (the gang is discarded)."""
    import numpy as np

    from volcano_tpu_torch.api import (GPU_MEMORY_RESOURCE,
                                       GPU_NUMBER_RESOURCE, ClusterInfo,
                                       JobInfo, NodeInfo, PodGroupPhase,
                                       QueueInfo, Resource, TaskInfo)
    rng = np.random.RandomState(7)
    gpu = ClusterInfo()
    gpu.add_queue(QueueInfo("default", weight=1))
    for i in range(300):
        gpu.add_node(NodeInfo(f"g{i:03d}", allocatable=Resource
                              .from_resource_list({
                                  "cpu": "8", "memory": "32Gi",
                                  GPU_MEMORY_RESOURCE: 16,
                                  GPU_NUMBER_RESOURCE: 2})))
    for j in range(200):
        job = JobInfo(f"default/gj{j:03d}", queue="default",
                      min_available=2, priority=int(rng.randint(3)),
                      creation_timestamp=float(j),
                      pod_group_phase=PodGroupPhase.INQUEUE)
        for t in range(4):
            job.add_task(TaskInfo(
                uid=f"default/gj{j:03d}-{t}", name=f"gj{j:03d}-{t}",
                resreq=Resource.from_resource_list({
                    "cpu": f"{rng.randint(1, 4) * 500}m", "memory": "1Gi",
                    GPU_MEMORY_RESOURCE: int(rng.randint(1, 10))})))
        gpu.add_job(job)
    gang = ClusterInfo()
    gang.add_queue(QueueInfo("default", weight=1))
    gang.add_node(NodeInfo("n0", allocatable=Resource.from_resource_list(
        {"cpu": "2", "memory": "8Gi"})))
    for uid, minav, n, cpu in (("default/big", 3, 3, "1"),
                               ("default/small", 1, 1, "2")):
        job = JobInfo(uid, queue="default", min_available=minav,
                      pod_group_phase=PodGroupPhase.INQUEUE)
        for t in range(n):
            job.add_task(TaskInfo(uid=f"{uid}-{t}", name=f"{uid[8:]}-{t}",
                                  resreq=Resource.from_resource_list(
                                      {"cpu": cpu, "memory": "1Gi"})))
        gang.add_job(job)
    return gpu, gang


def ops_per_node(cfg, R, G):
    """Float32 operations of one placement attempt on one node, counted
    from the reference formulas (pallas_place._make_attempt, _dyn_score):
    gates and fit tests, then each enabled score family, then the argmax."""
    ops = 12 + 7 * R + (2 * G + 1 if cfg.enable_gpu else 0) + 6 + 4
    if cfg.binpack_weight:
        ops += 9 * R + 5
    if cfg.least_allocated_weight:
        ops += 7 * R + 4
    if cfg.most_allocated_weight:
        ops += 7 * R + 4
    if cfg.balanced_weight:
        ops += 10 * R + 6
    return ops


def time_kernel(call, cb=None):
    """Kernel ms per launch (CUDA events) as a cluster of ``cb`` blocks
    (the cycle's, ``round_placer.CLUSTER``, when not given), plain version
    ms per call, and the least time for the same work on this card."""
    import torch

    from volcano_tpu_torch.ops import round_placer as rp
    cfg, K, M, args = call
    cb = rp.CLUSTER if cb is None else cb
    for _ in range(3):
        rp.round_place_cuda(cfg, K, M, args, cb=cb)
    torch.cuda.synchronize()
    reps = 50
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = rp.round_place_cuda(cfg, K, M, args, cb=cb)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    stats = {}
    rp.round_place_plain(cfg, K, M, args, stats={})   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_reps = 3
    for _ in range(plain_reps):
        rp.round_place_plain(cfg, K, M, args, stats=stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000 / plain_reps
    attempts = stats["attempts"] / plain_reps
    a = rp.unpack_args(cfg, args)
    R, N = a.idle.shape
    G = a.gidle0.shape[0] if cfg.enable_gpu else 0
    nbytes = sum(t.numel() * t.element_size() for t in list(args) + list(out))
    ops = attempts * N * ops_per_node(cfg, R, G)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return dict(cb=cb, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                attempts=attempts, bytes=nbytes, ops=ops,
                stats={k: v / plain_reps for k, v in stats.items()})


def traced_device_ms(prof, name, reps):
    """(mean device ms, count) of the launches of kernel ``name`` in a
    ``torch.profiler`` trace of a run of ``reps`` of them. The trace may
    keep fewer launches than ran (on an H100 it kept 169 to 189 of 200 of
    kernel 5, 180 of 200 of kernel 4, 46 of 50 of kernel 3): the mean over
    those it kept. (None, 0) when it kept none."""
    import torch
    dev = [(e.time_range.end - e.time_range.start) / 1000
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and name in e.name]
    if len(dev) > reps:
        raise RuntimeError(f"the trace holds {len(dev)} {name} launches "
                           f"of {reps}")
    return (sum(dev) / len(dev), len(dev)) if dev else (None, 0)


def device_ms(launch, name, reps, traces=3):
    """(device ms a launch, launches the trace kept, CUDA events ms a
    launch) of ``reps`` calls of ``launch``, each of which launches kernel
    ``name`` once, after 3 calls to warm up.

    The events around the run time the launch's pace, which is the
    wrapper's host work where that outlasts the kernel; the device time is
    the mean of the launches a ``torch.profiler`` trace of the same run
    kept. On an H100 a trace once kept none of 50 launches of kernel 3, so
    a trace that keeps none is taken again, ``traces`` times in all. If
    none keeps one, the device time is that of CUDA events around the
    ``reps`` launches queued behind a spin kernel (``torch.cuda._sleep``),
    so that the host has queued them all before the first starts; the
    count kept is then 0. Raises if the spin kernel ends before the host
    has queued them, at four lengths of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    host_s = events_ms = 0.0
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                launch()
            end.record()
            host_s = time.perf_counter() - t0
            torch.cuda.synchronize()
        events_ms = start.elapsed_time(end) / reps
        ms, traced = traced_device_ms(prof, name, reps)
        if traced:
            return ms, traced, events_ms
    cycles = max(int(host_s * 4e9), 10 ** 7)    # twice the host's time
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        gated = not start.query()
        torch.cuda.synchronize()
        if gated:
            return start.elapsed_time(end) / reps, 0, events_ms
        cycles *= 4
    raise RuntimeError(f"{name}: the spin kernel ended before the host had "
                       f"queued {reps} launches")


def time_exchange(cb, iters=20000):
    """Microseconds of one cluster exchange of ``cb`` blocks alone (write a
    slot, one cluster barrier, read the cb slots, merge): CUDA events
    around a probe of ``iters`` exchanges, less a probe of one."""
    import torch

    from volcano_tpu_torch.ops import round_placer as rp
    ms = {}
    for n in (1, iters, 1, iters):
        rp.exchange_probe_cuda(cb, n, "cuda")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rp.exchange_probe_cuda(cb, n, "cuda")
        end.record()
        torch.cuda.synchronize()
        ms[n] = min(ms.get(n, float("inf")), start.elapsed_time(end))
    return (ms[iters] - ms[1]) * 1000 / (iters - 1)


def dyn_cbs():
    """The dynamic-key placer's cluster sizes: its default, then the other
    of 16 and 8."""
    from volcano_tpu_torch.ops import dyn_placer as dp
    return (dp.CLUSTER, 8 if dp.CLUSTER == 16 else 16)


def compare_dyn_kernel_plain(calls, cbs=None):
    """As compare_kernel_plain, for the dynamic-key placer, as a cluster of
    each of ``cbs`` blocks (its default and the other when not given)."""
    import torch

    from volcano_tpu_torch.ops import dyn_placer as dp
    worst = 0.0
    for cfg, C, KP, M, args in calls:
        want = dp.dyn_place_plain(cfg, C, KP, M, args)
        for cb in cbs or dyn_cbs():
            got = dp.dyn_place_cuda(cfg, C, KP, M, args, cb=cb)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                worst = max(worst,
                            float((g.double() - w.double()).abs().max()))
                if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                    raise AssertionError(f"dyn kernel (CB={cb}) and plain "
                                         f"version differ")
    return worst


def dyn_built_calls():
    """The small built inputs of the dynamic-key cases
    (``volcano_tpu_torch/ops/dyn_cases.py``), on the card."""
    import torch

    from volcano_tpu_torch.ops.allocate_scan import AllocateConfig
    from volcano_tpu_torch.ops.dyn_cases import (DYN_CASES, PLACER_WEIGHTS,
                                                 make_dyn_inputs)
    calls = []
    for case in sorted(DYN_CASES):
        for seed in (0, 1, 2):
            flags, args = make_dyn_inputs(seed, **DYN_CASES[case])
            cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
            calls.append((cfg, 4, 12, 4, [torch.from_numpy(a).cuda()
                                          for a in args]))
    return calls


def ops_per_pop(cfg, a, nkeys):
    """Float32 operations of one pop's job selection, counted from the
    reference formulas (pallas_place._dyn_kernel): per queue the gate and
    share, per job the gate (a one-hot sum over Q) and each key column,
    per namespace the fold of the member allocations over the jobs."""
    R, J, Q = a.jalloc.shape[0], a.jalloc.shape[1], a.qalloc.shape[0]
    S = a.nsm.shape[0] if a.nsm is not None else 0
    return (Q * (5 * R + 1) + J * (2 * Q + 5) + J * nkeys * 2
            + J * (2 * Q + 3 * R + S + 4) + S * R * J * 2)


def time_dyn_kernel(call, cb=None):
    """Dynamic-key kernel ms per launch as a cluster of ``cb`` blocks (the
    cycle's, ``dyn_placer.CLUSTER``, when not given), plain version ms per
    call, and the least time for the same work on this card.

    The wrapper's host work per launch (argument checks, allocations, the
    pointer array) takes longer than the kernel since the kernel became a
    cluster, so CUDA events around a run of launches time the host
    (``events_ms``); the kernel's own time (``ms``) is its device time per
    launch in a ``torch.profiler`` trace of the same run
    (:func:`device_ms`)."""
    import torch

    from volcano_tpu_torch.ops import dyn_placer as dp
    cfg, C, KP, M, args = call
    cb = dp.CLUSTER if cb is None else cb
    out = dp.dyn_place_cuda(cfg, C, KP, M, args, cb=cb)
    ms, traced, events_ms = device_ms(
        lambda: dp.dyn_place_cuda(cfg, C, KP, M, args, cb=cb),
        "dyn_placer_kernel", 50)
    stats = {}
    dp.dyn_place_plain(cfg, C, KP, M, args, stats={})   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_reps = 3
    for _ in range(plain_reps):
        dp.dyn_place_plain(cfg, C, KP, M, args, stats=stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000 / plain_reps
    attempts = stats["attempts"] / plain_reps
    pops = stats["pops"] / plain_reps
    a = dp.unpack_args(cfg, args)
    R, N = a.idle.shape
    G = a.gidle0.shape[0] if cfg.enable_gpu else 0
    plan, _ = dp.key_plan(cfg, a.hcols.shape[0] if a.hcols is not None
                          else 0)
    nbytes = sum(t.numel() * t.element_size()
                 for t in list(args) + list(out))
    ops = (attempts * N * ops_per_node(cfg, R, G)
           + pops * ops_per_pop(cfg, a, len(plan)))
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return dict(cb=cb, ms=ms, traced=traced, events_ms=events_ms,
                plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                attempts=attempts, pops=pops, bytes=nbytes, ops=ops,
                stats={k: v / plain_reps for k, v in stats.items()})


def dyn_phase_split(call, cb, reps=20):
    """Kernel 3's phase split at one launch as a cluster of ``cb`` blocks
    (``dyn_placer.phase_split``, microseconds of each phase from block 0's
    clock64() stamps), averaged over ``reps`` launches."""
    import torch

    from volcano_tpu_torch.ops import dyn_placer as dp
    cfg, C, KP, M, args = call
    stamps = torch.zeros(dp.N_STAMPS, dtype=torch.int64, device="cuda")
    splits = []
    for _ in range(reps):
        dp.dyn_place_cuda(cfg, C, KP, M, args, cb=cb, stamps=stamps)
        torch.cuda.synchronize()
        splits.append(dp.phase_split(stamps))
    return {k: sum(s[k] for s in splits) / reps for k in splits[0]}


class CountingPlain:
    """Dynamic-key placer seam of a plain cycle: the plain version, its
    calls counted."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args):
        from volcano_tpu_torch.ops import dyn_placer as dp
        self.calls += 1
        return dp.dyn_place_plain(*args)


def cycle_counts(launches):
    """A cycle's dynamic-key launches (given), pops and early stops."""
    from volcano_tpu_torch.ops import dyn_placer as dp
    return dict(launches=launches, pops=dp.pops, early_stops=dp.early_stops)


def seg_fold_calls(ssn, dyn_calls):
    """The segmented sum's inputs at check B's shapes: the cycle's namespace
    fold (job allocations [J, R] by namespace, invalid jobs dropped) at the
    cycle's start and at each recorded dyn launch; the same segments over
    seeded values whose float32 sums depend on the order; and those values
    into J segments, the shape of an hdrf subtree sum."""
    import torch

    from volcano_tpu_torch.arrays import to_device
    from volcano_tpu_torch.ops import dyn_placer as dp
    jobs = to_device(ssn.snap, "cuda").jobs
    S = int(ssn.snap.namespace_weight.shape[0])
    seg = torch.where(jobs.valid, jobs.namespace.to(torch.int32),
                      torch.full((), -1, dtype=torch.int32, device="cuda"))
    calls = [(jobs.allocated.contiguous(), seg, S)]
    for cfg, _, _, _, args in dyn_calls:
        calls.append((dp.unpack_args(cfg, args).jalloc.T.contiguous(), seg,
                      S))
    J, R = jobs.allocated.shape
    g = torch.Generator().manual_seed(0)
    vals = (torch.rand((J, R), generator=g)
            * 10.0 ** torch.randint(0, 9, (J, R), generator=g)).cuda()
    tree = torch.randint(-1, J, (J,), generator=g, dtype=torch.int32)
    return calls + [(vals, seg, S), (vals, tree.cuda(), J)]


def compare_seg_fold_plain(calls):
    """Max |kernel - plain| of the segmented sum; raises unless every output
    is bitwise equal."""
    import torch

    from volcano_tpu_torch.ops import seg_fold as sf
    worst = 0.0
    for vals, seg, num in calls:
        got = sf.seg_fold_cuda(vals, seg, num)
        want = sf.seg_fold_plain(vals, seg, num)
        torch.cuda.synchronize()
        worst = max(worst, float((got.double() - want.double()).abs().max()))
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError("seg_fold kernel and plain version differ")
    return worst


def time_seg_fold(call):
    """Segmented sum ms per launch (device time in a ``torch.profiler``
    trace; CUDA events around the run, ``events_ms``), plain version ms per
    call, ``index_add_`` ms per call (the library call for the same sums,
    in an order of its own), and the least time for the same work on this
    card."""
    import torch

    from volcano_tpu_torch.ops import seg_fold as sf
    vals, seg, num = call

    def events(fn, reps):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    ms, traced, events_ms = seg_fold_device_ms(call)
    keep = (seg >= 0) & (seg < num)
    idx = torch.where(keep, seg, num).long()
    acc = torch.zeros((num + 1, vals.shape[1]), device=vals.device)
    library_ms = events(lambda: acc.index_add_(0, idx, vals), 200)
    sf.seg_fold_plain(vals, seg, num)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        sf.seg_fold_plain(vals, seg, num)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 100
    # each input read once, the output written once; one add per term
    # (a kept row's value that is not an exact zero)
    nbytes = (vals.numel() + seg.numel() + num * vals.shape[1]) * 4
    ops = int(((vals != 0) & keep[:, None]).sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return dict(ms=ms, traced=traced, events_ms=events_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                rows=vals.shape[0], segments=num, terms=ops, bytes=nbytes,
                ops=ops)


def seg_fold_device_ms(call, reps=200):
    """The segmented sum's device ms per launch in a ``torch.profiler``
    trace of ``reps`` launches (and how many the trace kept), and CUDA
    events around the run (the launch's pace: the wrapper's host work
    where it outlasts the kernel), as :func:`device_ms` takes them."""
    from volcano_tpu_torch.ops import seg_fold as sf
    vals, seg, num = call
    return device_ms(lambda: sf.seg_fold_cuda(vals, seg, num), "seg_fold",
                     reps)


def aff_built_calls():
    """The small built inputs of the pod-affinity cases
    (``volcano_tpu_torch/ops/dyn_cases.py`` AFF_CASES), on the card: the
    round placer with and without GPU cards, and the dynamic-key placer
    with drf."""
    import torch

    from volcano_tpu_torch.ops.allocate_scan import AllocateConfig
    from volcano_tpu_torch.ops.dyn_cases import (AFF_CASES, PLACER_WEIGHTS,
                                                 aff_placer_knobs,
                                                 make_dyn_inputs,
                                                 make_inputs)
    rounds, dyns = [], []
    for case in sorted(AFF_CASES):
        knobs = dict(aff=AFF_CASES[case], **aff_placer_knobs(case))
        for seed in (0, 1, 2):
            for gpu in (False, True):
                cfg = AllocateConfig(enable_gpu=gpu, enable_pod_affinity=True,
                                     pod_affinity_weight=1.5,
                                     **PLACER_WEIGHTS)
                rounds.append((cfg, 8, 4, [torch.from_numpy(a).cuda() for a
                                           in make_inputs(seed, gpu=gpu,
                                                          **knobs)]))
            flags, args = make_dyn_inputs(seed, drf_job_order=True, **knobs)
            cfg = AllocateConfig(**PLACER_WEIGHTS, **flags)
            dyns.append((cfg, 4, 12, 4, [torch.from_numpy(a).cuda()
                                         for a in args]))
    return rounds, dyns


def without_affinity(call, dyn=False):
    """The same launch with the pod-affinity step off: its arguments
    dropped, the flag cleared."""
    import dataclasses

    from volcano_tpu_torch.ops import dyn_placer as dp
    from volcano_tpu_torch.ops import round_placer as rp
    cfg, *shape, args = call
    a = (dp if dyn else rp).unpack_args(cfg, args)
    off = a._replace(**{f: None for f in rp.AFF_FIELDS + rp.AFF_STATE})
    return (dataclasses.replace(cfg, enable_pod_affinity=False), *shape,
            [t for t in off if t is not None])


def aff_step_time(call, dyn=False):
    """The pod-affinity step's own time in one launch: the kernel and the
    plain version with the step on, minus the same launch with it off; and
    its bound: the affinity arguments read once and the counts written
    once, over the float32 operations its attempts and commits need
    (per node: 3 per term row read, 8 for the mask, normalisation and
    score, 2 per count row a commit writes)."""
    from volcano_tpu_torch.ops import dyn_placer as dp
    from volcano_tpu_torch.ops import round_placer as rp
    timer = time_dyn_kernel if dyn else time_kernel
    on, off = timer(call), timer(without_affinity(call, dyn))
    cfg, *_, args = call
    a = (dp if dyn else rp).unpack_args(cfg, args)
    N = a.idle.shape[1]
    nbytes = sum(getattr(a, f).numel() * 4 for f in rp.AFF_FIELDS) + 2 * sum(
        getattr(a, f).numel() * 4 for f in rp.AFF_STATE)
    st = on["stats"]
    ops = N * (3 * st.get("aff_rows", 0) + 8 * st["attempts"]
               + 2 * st.get("aff_commit_rows", 0))
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return dict(cb=on.get("cb"), ms=on["ms"] - off["ms"], ms_on=on["ms"],
                ms_off=off["ms"],
                plain_ms=on["plain_ms"] - off["plain_ms"],
                plain_ms_on=on["plain_ms"], plain_ms_off=off["plain_ms"],
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                attempts=st["attempts"], aff_rows=st.get("aff_rows", 0),
                aff_commit_rows=st.get("aff_commit_rows", 0), bytes=nbytes,
                ops=ops)


def dyn_counts():
    from volcano_tpu_torch.ops import dyn_placer as dp
    from volcano_tpu_torch.ops import seg_fold as sf
    return dict(launches=dp.launches, pops=dp.pops,
                early_stops=dp.early_stops, seg_fold_launches=sf.launches)


class ShardRecorder:
    """Shard placer seam: launches the kernel and keeps a copy of the
    arguments of its first ``keep`` launches; ``stop_after`` ends the cycle
    early."""

    def __init__(self, keep, stop_after=None):
        self.keep, self.stop_after = keep, stop_after
        self.calls = []

    def __call__(self, cfg, D, args):
        from volcano_tpu_torch.ops import shard_placer as sp
        if len(self.calls) < self.keep:
            self.calls.append((cfg, D, [a.clone() for a in args]))
        if self.stop_after is not None and len(self.calls) >= self.stop_after:
            raise Recorder.Stop()
        return sp.shard_candidates_cuda(cfg, D, args)


def record_shard_launches(ssn, keep, stop_after=None):
    """Run the session's sharded allocate cycle on the card through a
    ShardRecorder."""
    from volcano_tpu_torch.arrays import to_device
    from volcano_tpu_torch.ops.allocate_scan import make_allocate_cycle
    cfg, extras = ssn._derived_allocate_inputs()
    rec = ShardRecorder(keep, stop_after)
    try:
        make_allocate_cycle(cfg, mesh=ssn._sharding_mesh(),
                            shard_placer=rec)(to_device(ssn.snap, "cuda"),
                                              to_device(extras, "cuda"))
    except Recorder.Stop:
        pass
    return rec.calls


def shard_built_calls():
    """The small built inputs of the shard placer cases
    (``volcano_tpu_torch/ops/dyn_cases.py`` SHARD_CASES), on the card."""
    import torch

    from volcano_tpu_torch.ops.allocate_scan import AllocateConfig
    from volcano_tpu_torch.ops.dyn_cases import (PLACER_WEIGHTS, SHARD_CASES,
                                                 make_shard_inputs)
    calls = []
    for case in sorted(SHARD_CASES):
        for D in (1, 4):
            for gpu in (False, True):
                cfg = AllocateConfig(enable_gpu=gpu, **PLACER_WEIGHTS)
                calls.append((cfg, D, [torch.from_numpy(a).cuda() for a in
                                       make_shard_inputs(
                                           D, D=D, gpu=gpu,
                                           **SHARD_CASES[case])]))
    return calls


#: the candidate kernel's block shapes: threads, rows a thread
GEOMETRIES = ((128, 1), (128, 2), (256, 1), (256, 2))


def compare_shard_plain(calls, geometries=(None,)):
    """Max |kernel - plain| over the 8 per-shard outputs and the combined
    triple (against ``combine`` of the plain version) of every launch, at
    each of ``geometries`` (None: the module's); raises unless all are
    bitwise equal."""
    import torch

    from volcano_tpu_torch.ops import shard_placer as sp
    worst = 0.0
    for cfg, D, args in calls:
        plain = sp.shard_candidates_plain_all(cfg, D, args)
        want = list(plain[:4]) + list(sp.combine(
            plain, args[-1].shape[1]))
        for geometry in geometries:
            got = sp.shard_candidates_cuda(cfg, D, args,
                                           *(geometry or (None, None)))
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                worst = max(worst,
                            float((g.double() - w.double()).abs().max()))
                if not bitwise_equal(g, w):
                    raise AssertionError(f"shard kernel ({geometry}) and "
                                         f"plain version differ")
    return worst


def time_shard_kernel(call, geometry=None):
    """Candidate kernel ms per launch at block shape ``geometry`` (threads,
    rows a thread; the module's when not given), plain version ms per
    call, and the least time for the same work on this card: the bytes of
    the rows one attempt reads (shard_placer.bound_bytes) against the
    float32 operations of one attempt on each row.

    The wrapper's host work per launch (argument checks, the pointer
    array) takes longer than the kernel, so CUDA events around a run of
    launches time the host (``events_ms``); the kernel's own time (``ms``)
    is its device time per launch in a ``torch.profiler`` trace of the same
    run (:func:`device_ms`)."""
    import torch

    from volcano_tpu_torch.ops import shard_placer as sp
    cfg, D, args = call
    threads, rpt = geometry or (sp.THREADS, sp.ROWS_PER_THREAD)
    ms, traced, events_ms = device_ms(
        lambda: sp.shard_candidates_cuda(cfg, D, args, threads, rpt),
        "shard_cand_kernel", 200)
    sp.shard_candidates_plain_all(cfg, D, args)        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_reps = 5
    for _ in range(plain_reps):
        sp.shard_candidates_plain_all(cfg, D, args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000 / plain_reps
    a = sp.unpack_args(cfg, args)
    R, N = a.idle.shape
    G = a.gidle0.shape[0] if cfg.enable_gpu else 0
    nbytes = sp.bound_bytes(cfg, N, R, G)
    ops = N * ops_per_node(cfg, R, G)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    rows = threads * rpt
    return dict(D=D, NL=N // D, threads=threads, ROWS=rows,
                B=sp.row_blocks(N // D, rows), ms=ms, traced=traced,
                events_ms=events_ms,
                plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


class WaveRecorder(ShardRecorder):
    """Wave placer seam: as ShardRecorder, for the wide candidate search."""

    def __call__(self, cfg, D, C, args):
        from volcano_tpu_torch.ops import shard_wave as sw
        if len(self.calls) < self.keep:
            self.calls.append((cfg, D, C, [a.clone() for a in args]))
        if self.stop_after is not None and len(self.calls) >= self.stop_after:
            raise Recorder.Stop()
        return sw.shard_wave_cuda(cfg, D, C, args)


def record_wave_launches(ssn, keep, stop_after=None):
    """Run the session's wave cycle on the card through a WaveRecorder."""
    from volcano_tpu_torch.arrays import to_device
    from volcano_tpu_torch.ops.allocate_scan import make_allocate_cycle
    cfg, extras = ssn._derived_allocate_inputs()
    rec = WaveRecorder(keep, stop_after)
    try:
        make_allocate_cycle(cfg, mesh=ssn._sharding_mesh(),
                            wave_placer=rec)(to_device(ssn.snap, "cuda"),
                                             to_device(extras, "cuda"))
    except Recorder.Stop:
        pass
    return rec.calls


def wave_built_calls():
    """The small built inputs of the wide search's cases
    (``volcano_tpu_torch/ops/dyn_cases.py`` WAVE_CASES), on the card, with
    GPU cards."""
    import torch

    from volcano_tpu_torch.ops.allocate_scan import (AllocateConfig,
                                                     wave_candidate_depth)
    from volcano_tpu_torch.ops.dyn_cases import (PLACER_WEIGHTS, WAVE_CASES,
                                                 make_wave_inputs)
    cfg = AllocateConfig(enable_gpu=True, **PLACER_WEIGHTS)
    calls = []
    for case in sorted(WAVE_CASES):
        for D in (1, 4):
            for W in (4, 8, 16):
                calls.append((cfg, D, wave_candidate_depth(W), [
                    torch.from_numpy(a).cuda() for a in make_wave_inputs(
                        D, D=D, W=W, gpu=True, **WAVE_CASES[case])]))
    return calls


def compare_wave_plain(calls):
    """Max |kernel - plain| over the 4 per-shard outputs of every launch and
    its 5 combined ones (against ``combine`` of the plain version's);
    raises unless all are bitwise equal."""
    import torch

    from volcano_tpu_torch.ops import shard_wave as sw
    worst = 0.0
    for cfg, D, C, args in calls:
        got = sw.shard_wave_cuda(cfg, D, C, args)
        want = sw.shard_wave_plain_combined(cfg, D, C, args)
        torch.cuda.synchronize()
        for name, g, w in zip(got._fields, got, want):
            w = w.contiguous()
            worst = max(worst, float((g.double() - w.double()).abs().max()))
            if not bitwise_equal(g, w):
                raise AssertionError(f"wave kernel and plain version differ "
                                     f"in {name}")
    return worst


def time_wave_kernel(call):
    """Wide candidate kernel ms per launch (device time in a
    ``torch.profiler`` trace, :func:`device_ms`; CUDA events around the
    run time the wrapper's host work, ``events_ms``), plain version ms per
    call, and the least time for the same work on this card: the bytes of
    ``shard_wave.bound_bytes`` against the float32 operations of W
    attempts on each row (each with its two views' selection)."""
    import torch

    from volcano_tpu_torch.ops import shard_wave as sw
    cfg, D, C, args = call
    ms, traced, events_ms = device_ms(
        lambda: sw.shard_wave_cuda(cfg, D, C, args), "shard_wave_kernel",
        200)
    sw.shard_wave_plain_all(cfg, D, C, args)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_reps = 3
    for _ in range(plain_reps):
        sw.shard_wave_plain_all(cfg, D, C, args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1000 / plain_reps
    a = sw.unpack_args(cfg, args)
    R, N = a.idle.shape
    W = a.req.shape[1]
    G = a.gidle0.shape[0] if cfg.enable_gpu else 0
    templates = len(set(a.task[1].tolist()))
    groups = len(set(g for g in a.task[2].tolist() if g >= 0)) or 1
    nbytes = sw.bound_bytes(cfg, N, R, G, W, C, D, templates, groups)
    ops = W * N * (ops_per_node(cfg, R, G) + 2)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return dict(D=D, NL=N // D, W=W, C=C, ms=ms, traced=traced,
                events_ms=events_ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


def wave_counts():
    from volcano_tpu_torch.ops import shard_placer as sp
    from volcano_tpu_torch.ops import shard_wave as sw
    return dict(launches=sw.launches, waves=sw.waves,
                fast_waves=sw.fast_waves, truncations=sw.truncations,
                pops=sp.pops, shard_candidates_launches=sp.launches)


def zero_wave_counts():
    from volcano_tpu_torch.ops import shard_wave as sw
    zero_shard_counts()
    sw.launches = sw.waves = sw.fast_waves = sw.truncations = 0


def shard_counts():
    from volcano_tpu_torch.ops import shard_placer as sp
    return dict(launches=sp.launches, pops=sp.pops)


def zero_shard_counts():
    from volcano_tpu_torch.ops import shard_placer as sp
    sp.launches = sp.pops = 0


def churn_cycle(ssn, rng, dyn=False):
    """One churn cycle on a steady Session: ``synthetic.steady_churn`` of
    its cluster, the touched jobs and nodes marked dirty, then reopen,
    dispatch and complete; held to a fresh full Session on a copy of the
    cluster taken before the cycle. The launches of the cycle's placer (the
    dynamic-key one with ``dyn``) are set to 0 just before and read just
    after. Returns the cycle's numbers; raises unless the fingerprints
    agree and the cycle refreshed in place and shipped a delta smaller
    than a full upload, with no digest mismatch."""
    from volcano_tpu_torch.framework import Session
    from volcano_tpu_torch.ops import dyn_placer as dp
    from volcano_tpu_torch.ops import round_placer as rp
    from volcano_tpu_torch.synthetic import steady_churn
    jobs, nodes = steady_churn(ssn.cluster, rng, CHURN[0])
    for uid in jobs:
        ssn.mark_dirty(job_uid=uid)
    for name in nodes:
        ssn.mark_dirty(node_name=name)
    t0 = time.perf_counter()
    copy = ssn.cluster.clone()
    clone_ms = (time.perf_counter() - t0) * 1000
    rp.launches = 0
    zero_dyn_counts()
    t0 = time.perf_counter()
    refreshed = ssn.reopen(now=ssn.now)
    ssn.complete_allocate(ssn.dispatch_allocate())
    steady_ms = (time.perf_counter() - t0) * 1000
    launches = dp.launches if dyn else rp.launches
    st = dict(ssn.stats)
    res = ssn.last_allocate
    sha = fingerprint(res.task_node, res.task_mode)
    fresh = Session(copy, ssn.conf, now=ssn.now, device=ssn.device)
    fresh.run_allocate()
    fres = fresh.last_allocate
    want = fingerprint(fres.task_node, fres.task_mode)
    out = {"churned_gangs": len(jobs), "touched_nodes": len(nodes),
           "refresh": refreshed, "refresh_ms": st["refresh_ms"],
           "fresh_pack_ms": fresh.stats["pack_ms"], "clone_ms": clone_ms,
           "last_kind": st["last_kind"], "upload_bytes": st["upload_bytes"],
           "full_upload_bytes": st["full_upload_bytes"],
           "drain_readback_bytes": st["drain_readback_bytes"],
           "drain_readback_rows": st["drain_readback_rows"],
           "recoveries": st.get("recoveries", 0), "path": st["path"],
           "cycle_ms": st["cycle_ms"], "apply_ms": st["apply_ms"],
           "reopen_to_applied_ms": steady_ms,
           "fresh_cycle_ms": fresh.stats["cycle_ms"],
           "binds": len(ssn.binds), "launches": launches,
           "fingerprint": sha, "fresh_fingerprint": want}
    assert launches > 0, "the churn cycle launched no placer"
    assert sha == want, (sha, want)
    assert refreshed and st["last_kind"] == "delta", out
    assert not st.get("recoveries"), out
    assert 0 < st["upload_bytes"] < st["full_upload_bytes"], out
    return out


def time_digest(state, reps=20):
    """The resident buffers' device digest at the north star: ms a digest
    (CUDA events over ``reps``), its words, and the device memory its
    int64 temporaries take above what was allocated before."""
    import torch

    from volcano_tpu_torch.ops import fused_io as fio
    bufs = state.device
    coefs = [fio.digest_coef(b.numel(), b.device) for b in bufs]
    fio.device_digest(bufs, coefs)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fio.device_digest(bufs, coefs)
    end.record()
    torch.cuda.synchronize()
    return dict(words=[b.numel() for b in bufs],
                ms=start.elapsed_time(end) / reps,
                temp_bytes=torch.cuda.max_memory_allocated() - base)


def fold_call(S):
    """Kernel 3 at check B's job and node counts with S namespaces at two
    dims (P = 2 S fold pairs), drf job and namespace order, on the card."""
    import torch

    from volcano_tpu_torch.ops.allocate_scan import AllocateConfig
    from volcano_tpu_torch.ops.dyn_cases import (PLACER_WEIGHTS,
                                                 make_dyn_inputs)
    flags, args = make_dyn_inputs(0, drf_job_order=True, drf_ns_order=True,
                                  S=S, J=4096, N=1024)
    return (AllocateConfig(**PLACER_WEIGHTS, **flags), 4, 12, 4,
            [torch.from_numpy(a).cuda() for a in args])


def zero_dyn_counts():
    from volcano_tpu_torch.ops import dyn_placer as dp
    from volcano_tpu_torch.ops import seg_fold as sf
    dp.launches = dp.pops = dp.early_stops = sf.launches = 0


class Clock:
    """Seconds of each phase: ``lap(name)`` closes the running phase and
    starts ``name``."""

    def __init__(self):
        self.seconds, self.name, self.t0 = {}, None, time.perf_counter()

    def lap(self, name=None):
        now = time.perf_counter()
        if self.name is not None:
            self.seconds[self.name] = now - self.t0
        self.name, self.t0 = name, now


def check_n(kernels):
    """Phase 29 (check N); returns the kernels line with each kernel's R =
    12 reading as ``r12``."""
    import numpy as np

    from volcano_tpu_torch.framework import Session
    from volcano_tpu_torch.ops import dyn_placer as dp
    from volcano_tpu_torch.ops import enqueue as enqueue_ops
    from volcano_tpu_torch.ops import round_placer as rp
    from volcano_tpu_torch.ops import seg_fold as sf
    from volcano_tpu_torch.ops import shard_placer as sp
    from volcano_tpu_torch.ops import shard_wave as sw
    from volcano_tpu_torch.synthetic import _synthetic_cluster
    shape, extended, want = CHECK_N

    def cluster():
        return _synthetic_cluster(*shape, extended=extended)

    def got(ssn):
        res = ssn.last_allocate
        return (fingerprint(res.task_node, res.task_mode),
                int((res.task_mode > 0).sum()), int(res.job_ready.sum()))

    out, r12 = {}, {}
    # gang + binpack: kernel 1, and the port's oracle on a copy
    ssn = Session(cluster(), gang_binpack_conf(), device="cuda")
    R = int(ssn.snap.nodes.idle.shape[1])
    assert R == 2 + extended, R
    calls = record_launches(ssn, keep=3, stop_after=3)
    err1 = compare_kernel_plain(calls)
    rp.launches = 0
    ssn.run_allocate()
    out["static"] = dict(launches=rp.launches, path=ssn.stats["path"],
                         cycle_ms=ssn.stats["cycle_ms"], got=got(ssn),
                         max_abs_err=err1)
    assert rp.launches > 0, "check N's static run launched no kernel 1"
    assert out["static"]["got"] == want["static"], out["static"]
    t0 = time.perf_counter()
    oracle = Session(cluster(), gang_binpack_conf(), device="cuda")
    oracle.run_allocate_oracle()
    out["oracle"] = dict(got=got(oracle), binds=len(oracle.binds),
                         seconds=time.perf_counter() - t0)
    assert out["oracle"]["got"] == want["static"], out["oracle"]
    assert len(oracle.binds) == len(ssn.binds)
    r12["round_placer"] = time_kernel(calls[0])
    # the shipped conf: enqueue's sums and kernel 3
    ssn = Session(cluster(), shipped_conf(), device="cuda")
    dyn_calls = record_launches(ssn, keep=3, stop_after=3, dyn=True)
    err3 = compare_dyn_kernel_plain(dyn_calls)
    zero_dyn_counts()
    with SegFoldTap(enqueue_ops) as folds:
        enqueued = ssn.run_enqueue()
        ssn.run_allocate()
    counts = dyn_counts()
    fold_calls = folds.calls + seg_fold_calls(ssn, dyn_calls)
    assert all(v.shape[1] == R for v, _, _ in fold_calls[:-2])
    err_sf = compare_seg_fold_plain(fold_calls)
    out["shipped"] = dict(counts, enqueued=enqueued,
                          enqueue_folds=len(folds.calls),
                          path=ssn.stats["path"],
                          cycle_ms=ssn.stats["cycle_ms"], got=got(ssn),
                          max_abs_err=err3, seg_fold_max_abs_err=err_sf)
    assert counts["launches"] > 0 and counts["seg_fold_launches"] > 0
    assert folds.calls, "check N's enqueue folded nothing"
    assert out["shipped"]["got"] == want["shipped"], out["shipped"]
    r12["dyn_placer"] = time_dyn_kernel(dyn_calls[0])
    # the namespace fold's segments over seeded values at 12 dims (a term
    # in every kept row), as the R = 2 reading of phase 11
    r12["seg_fold"] = time_seg_fold(fold_calls[-2])
    # gang + binpack on a one-shard mesh: kernel 4, then kernel 5 at W = 8
    for name, width in (("mesh", 1), ("wave", 8)):
        conf = sharded_conf()
        conf.wave_width = width
        ssn = Session(cluster(), conf, device="cuda")
        if width == 1:
            m_calls = record_shard_launches(ssn, keep=3, stop_after=3)
            err = compare_shard_plain(m_calls)
            zero_shard_counts()
        else:
            m_calls = record_wave_launches(ssn, keep=3, stop_after=3)
            err = compare_wave_plain(m_calls)
            zero_wave_counts()
        ssn.run_allocate()
        counts = shard_counts() if width == 1 else wave_counts()
        out[name] = dict(counts, path=ssn.stats["path"],
                         cycle_ms=ssn.stats["cycle_ms"], got=got(ssn),
                         max_abs_err=err)
        assert counts["launches"] > 0, f"check N's {name} run launched none"
        assert out[name]["got"] == want["static"], out[name]
        if width == 1:
            r12["shard_candidates"] = time_shard_kernel(m_calls[0])
        else:
            assert counts["shard_candidates_launches"] == 0
            r12["shard_wave"] = time_wave_kernel(m_calls[0])
    log(json.dumps({"phase": "check_N", "resource_dims": R,
                    "nodes": shape[0], "tasks": shape[1] * shape[2],
                    **out}))
    for name, t in r12.items():
        log(json.dumps({"phase": "check_N_time", "kernel": name,
                        "resource_dims": R, **t}))
    errs = dict(round_placer=err1, dyn_placer=err3, seg_fold=err_sf,
                shard_candidates=out["mesh"]["max_abs_err"],
                shard_wave=out["wave"]["max_abs_err"])
    launches = dict(round_placer=out["static"]["launches"],
                    dyn_placer=out["shipped"]["launches"],
                    seg_fold=out["shipped"]["seg_fold_launches"],
                    shard_candidates=out["mesh"]["launches"],
                    shard_wave=out["wave"]["launches"])
    for k in kernels:
        t = r12.get(k["name"])
        if t is not None:
            k["r12"] = {"launches": launches[k["name"]],
                        "max_abs_err": errs[k["name"]], "ms": t["ms"],
                        "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t.get("library_ms")}
    assert np.isfinite([e for e in errs.values()]).all()
    return kernels


def main():
    clock = Clock()
    # ---- 1. device ------------------------------------------------------
    clock.lap('1 device')
    try:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false")
        from volcano_tpu_torch.ops import _build
        from volcano_tpu_torch.ops import round_placer as rp
        from volcano_tpu_torch.framework import Session
        from volcano_tpu_torch.synthetic import _synthetic_cluster
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        log(smi)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
    except Exception as e:
        fail("1 (device)", e)

    # ---- 2. build -------------------------------------------------------
    clock.lap('2 build')
    try:
        t0 = time.perf_counter()
        logs = _build.build(["round_placer", "dyn_placer", "seg_fold",
                             "shard_candidates", "shard_wave",
                             "planted_gather"])
        log(f"build {time.perf_counter() - t0:.1f}s")
        for name, text in logs.items():
            log(f"--- nvcc {name}\n{text.strip()}")
    except Exception as e:
        fail("2 (build)", e)

    # ---- 3. kernel against plain version --------------------------------
    clock.lap('3 round_vs_plain')
    conf = gang_binpack_conf()
    try:
        t0 = time.perf_counter()
        ci = _synthetic_cluster(*FULL)
        build_s = time.perf_counter() - t0
        ssn = Session(ci, conf, device="cuda")
        full_calls = record_launches(ssn, keep=3, stop_after=3)
        gpu_ci, gang_ci = small_clusters()
        gpu_calls = record_launches(Session(gpu_ci, conf, device="cuda"), 3)
        gang_ssn = Session(gang_ci, conf, device="cuda")
        gang_calls = record_launches(gang_ssn, 3)
        assert full_calls and gpu_calls and gang_calls
        assert gpu_calls[0][0].enable_gpu, "GPU case lost its GPU path"
        err = compare_kernel_plain(full_calls + gpu_calls + gang_calls)
        gang_ssn.run_allocate()
        ready = gang_ssn.last_allocate.job_ready
        assert [b.task_uid for b in gang_ssn.binds] == ["default/small-0"], \
            "the gang that cannot reach minAvailable was not discarded"
        assert not ready[gang_ssn.maps.job_index["default/big"]]
        log(json.dumps({"phase": "kernel_vs_plain", "launches_compared":
                        len(full_calls + gpu_calls + gang_calls),
                        "max_abs_err": err}))
    except Exception as e:
        fail("3 (kernel against plain version)", e)

    # ---- 4. the main path at full size ----------------------------------
    clock.lap('4 north_star')
    try:
        rp.launches = 0
        t0 = time.perf_counter()
        ssn.run_allocate()
        session_ms = (time.perf_counter() - t0) * 1000
        launches = rp.launches
        res = ssn.last_allocate
        sha = fingerprint(res.task_node, res.task_mode)
        out = {"phase": "session", "nodes": FULL[0],
               "tasks": FULL[1] * FULL[2], "cluster_build_s": build_s,
               "pack_ms": ssn.stats["pack_ms"],
               "cycle_ms": ssn.stats["cycle_ms"],
               "apply_ms": ssn.stats["apply_ms"],
               "run_allocate_ms": session_ms,
               "path": ssn.stats["path"], "last_kind": ssn.stats["last_kind"],
               "upload_bytes": ssn.stats["upload_bytes"],
               "drain_readback_bytes": ssn.stats["drain_readback_bytes"],
               "binds": len(ssn.binds), "launches": launches,
               "cluster_blocks": rp.CLUSTER, "fingerprint": sha}
        log(json.dumps(out))
        assert launches > 0, "the main path launched no kernel"
        assert sha == FULL_SHA, f"fingerprint {sha} != {FULL_SHA}"
        assert len(ssn.binds) == FULL[1] * FULL[2]
    except Exception as e:
        fail("4 (main path)", e)

    # ---- 5. sub-scale cycle, kernel against plain -----------------------
    clock.lap('5 subscale')
    from volcano_tpu_torch.arrays import to_device
    from volcano_tpu_torch.ops.allocate_scan import make_allocate_cycle
    try:
        sub = Session(_synthetic_cluster(*SUB), conf, device="cuda")
        cfg, extras = sub._derived_allocate_inputs()
        s_d, e_d = to_device(sub.snap, "cuda"), to_device(extras, "cuda")
        t0 = time.perf_counter()
        k_res = make_allocate_cycle(cfg)(s_d, e_d)
        k_packed = k_res.packed_decisions().cpu()
        k_ms = (time.perf_counter() - t0) * 1000
        t0 = time.perf_counter()
        p_res = make_allocate_cycle(cfg, placer=rp.round_place_plain)(s_d,
                                                                      e_d)
        p_packed = p_res.packed_decisions().cpu()
        p_ms = (time.perf_counter() - t0) * 1000
        sha = fingerprint(k_res.task_node.cpu(), k_res.task_mode.cpu())
        log(json.dumps({"phase": "subscale", "kernel_cycle_ms": k_ms,
                        "plain_cycle_ms": p_ms, "fingerprint": sha}))
        assert torch.equal(k_packed, p_packed), "kernel and plain cycles differ"
        assert sha == SUB_SHA, f"fingerprint {sha} != {SUB_SHA}"
    except Exception as e:
        fail("5 (sub-scale)", e)

    # ---- 6. kernel time at the main path's shapes -----------------------
    clock.lap('6 round_time')
    try:
        times = {}
        for cb in (16, 8, 16, 8):
            t = time_kernel(full_calls[0], cb)
            log(json.dumps({"phase": "kernel_time", **t}))
            times.setdefault(cb, []).append(t)
        exchange_us = {cb: time_exchange(cb) for cb in (16, 8)}
        for cb, runs in times.items():
            attempts = runs[0]["attempts"]
            log(json.dumps({
                "phase": "kernel_cluster", "cb": cb,
                "ms_runs": [r["ms"] for r in runs],
                "exchange_us": exchange_us[cb], "attempts": attempts,
                "latency_floor_ms": attempts * exchange_us[cb] / 1000,
                "bound_ms": runs[0]["bound_ms"]}))
        t = min(times[rp.CLUSTER], key=lambda r: r["ms"])
        kernels = [{
            "name": "round_placer", "route": "cuda",
            "source": "volcano_tpu_torch/csrc/round_placer.cu",
            "replaces": "volcano_tpu/ops/pallas_place.py:460",
            "launches": launches, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None}]
    except Exception as e:
        fail("6 (kernel time)", e)

    # ---- 7. dynamic-key placer against its plain version --------------
    clock.lap('7 dyn_vs_plain')
    from volcano_tpu_torch.ops import dyn_placer as dp
    from volcano_tpu_torch.synthetic import fair_share_cluster
    shipped = shipped_conf()
    try:
        t0 = time.perf_counter()
        ci_b = fair_share_cluster()
        build_b_s = time.perf_counter() - t0
        ssn_b = Session(ci_b, shipped, device="cuda")
        b_calls = record_launches(ssn_b, keep=3, stop_after=3, dyn=True)
        assert len(b_calls) == 3, "check B's cycle made under 3 launches"
        built = dyn_built_calls()
        dyn_err = compare_dyn_kernel_plain(b_calls + built)
        log(json.dumps({"phase": "dyn_kernel_vs_plain", "launches_compared":
                        len(b_calls + built), "cluster_blocks": dyn_cbs(),
                        "max_abs_err": dyn_err}))
        sf_calls = seg_fold_calls(ssn_b, b_calls)
        sf_err = compare_seg_fold_plain(sf_calls)
        log(json.dumps({"phase": "seg_fold_vs_plain", "calls_compared":
                        len(sf_calls), "max_abs_err": sf_err}))
    except Exception as e:
        fail("7 (dynamic-key placer against plain version)", e)

    # ---- 8. check A: the bench's fair-share configuration, no Session ---
    clock.lap('8 check_A')
    try:
        from volcano_tpu_torch.arrays import pack
        from volcano_tpu_torch.ops.allocate_scan import (AllocateConfig,
                                                         AllocateExtras,
                                                         derive_batching)
        snap_a, _ = pack(fair_share_cluster())
        cfg_a = derive_batching(AllocateConfig(
            binpack_weight=1.0, least_allocated_weight=0.0,
            balanced_weight=0.0, taint_prefer_weight=0.0,
            drf_job_order=True, enable_gpu=False), has_proportion=False)
        zero_dyn_counts()
        t0 = time.perf_counter()
        res = make_allocate_cycle(cfg_a)(
            to_device(snap_a, "cuda"),
            to_device(AllocateExtras.neutral(snap_a), "cuda"))
        tn, tm = res.task_node.cpu().numpy(), res.task_mode.cpu().numpy()
        cycle_a_ms = (time.perf_counter() - t0) * 1000
        sha = fingerprint(tn, tm)
        placed = int((tm > 0).sum())
        log(json.dumps({"phase": "check_A", "cycle_ms": cycle_a_ms,
                        **dyn_counts(), "placed": placed,
                        "fingerprint": sha}))
        assert sha == CHECK_A[0], f"fingerprint {sha} != {CHECK_A[0]}"
        assert placed == CHECK_A[1], f"{placed} placed, not {CHECK_A[1]}"
    except Exception as e:
        fail("8 (check A)", e)

    # ---- 9. check B: the dynamic-key main path --------------------------
    clock.lap('9 check_B')
    try:
        zero_dyn_counts()
        t0 = time.perf_counter()
        ssn_b.run_allocate()
        session_b_ms = (time.perf_counter() - t0) * 1000
        counts_b = dyn_counts()
        res = ssn_b.last_allocate
        sha = fingerprint(res.task_node, res.task_mode)
        placed = int((res.task_mode > 0).sum())
        ready = int(res.job_ready.sum())
        log(json.dumps({"phase": "check_B", "nodes": 1024, "tasks": 50000,
                        "cluster_build_s": build_b_s,
                        "pack_ms": ssn_b.stats["pack_ms"],
                        "cycle_ms": ssn_b.stats["cycle_ms"],
                        "apply_ms": ssn_b.stats["apply_ms"],
                        "run_allocate_ms": session_b_ms,
                        "binds": len(ssn_b.binds), **counts_b,
                        "placed": placed, "jobs_ready": ready,
                        "fingerprint": sha}))
        assert counts_b["launches"] > 0, "the main path launched no kernel"
        assert counts_b["seg_fold_launches"] > 0, \
            "the main path launched no segmented sum"
        assert sha == CHECK_B[0], f"fingerprint {sha} != {CHECK_B[0]}"
        assert (placed, ready) == CHECK_B[1:], (placed, ready)
    except Exception as e:
        fail("9 (check B, the dynamic-key main path)", e)

    # ---- 10. checks C and D ---------------------------------------------
    clock.lap('10 checks_C_D')
    try:
        sub_c = Session(_synthetic_cluster(*SUB), shipped, device="cuda")
        cfg, extras = sub_c._derived_allocate_inputs()
        s_d, e_d = to_device(sub_c.snap, "cuda"), to_device(extras, "cuda")
        zero_dyn_counts()
        t0 = time.perf_counter()
        k_res = make_allocate_cycle(cfg)(s_d, e_d)
        k_packed = k_res.packed_decisions().cpu()
        k_ms = (time.perf_counter() - t0) * 1000
        counts_c = dyn_counts()
        kernel_c = cycle_counts(dp.launches)
        zero_dyn_counts()
        plain_seam = CountingPlain()
        t0 = time.perf_counter()
        p_res = make_allocate_cycle(cfg, dyn_placer=plain_seam)(s_d, e_d)
        p_packed = p_res.packed_decisions().cpu()
        p_ms = (time.perf_counter() - t0) * 1000
        plain_c = cycle_counts(plain_seam.calls)
        sha_c = fingerprint(k_res.task_node.cpu(), k_res.task_mode.cpu())
        ssn_d = Session(_synthetic_cluster(*FULL), shipped, device="cuda")
        zero_dyn_counts()
        ssn_d.run_allocate()
        res = ssn_d.last_allocate
        sha_d = fingerprint(res.task_node, res.task_mode)
        placed_d = int((res.task_mode > 0).sum())
        log(json.dumps({"phase": "checks_C_D", "C_kernel_cycle_ms": k_ms,
                        "C_plain_cycle_ms": p_ms, "C_counts": counts_c,
                        "C_kernel_cycle": kernel_c,
                        "C_plain_cycle": plain_c,
                        "C_fingerprint": sha_c,
                        "D_cycle_ms": ssn_d.stats["cycle_ms"],
                        "D_counts": dyn_counts(), "D_placed": placed_d,
                        "D_fingerprint": sha_d}))
        assert torch.equal(k_packed, p_packed), "C: kernel and plain differ"
        assert kernel_c == plain_c, ("C: launches, pops, early stops",
                                     kernel_c, plain_c)
        assert kernel_c["launches"] > 0
        assert sha_c == CHECK_C, f"C: fingerprint {sha_c} != {CHECK_C}"
        assert (sha_d, placed_d) == CHECK_D, (sha_d, placed_d)
    except Exception as e:
        fail("10 (checks C and D)", e)

    # ---- 11. dynamic-key placer and segmented sum times, check B's shapes
    clock.lap('11 dyn_times')
    try:
        times = {}
        for cb in dyn_cbs() * 2:
            t = time_dyn_kernel(b_calls[0], cb)
            log(json.dumps({"phase": "dyn_kernel_time", **t}))
            times.setdefault(cb, []).append(t)
        for cb in dyn_cbs():
            log(json.dumps({
                "phase": "dyn_phase_split", "launch": "check_B_first",
                "cb": cb, "ms_runs": [r["ms"] for r in times[cb]],
                "events_ms_runs": [r["events_ms"] for r in times[cb]],
                "split_us": dyn_phase_split(b_calls[0], cb)}))
        t = min(times[dp.CLUSTER], key=lambda r: r["ms"])
        kernels.append({
            "name": "dyn_placer", "route": "cuda",
            "source": "volcano_tpu_torch/csrc/dyn_placer.cu",
            "replaces": "volcano_tpu/ops/pallas_place.py:655",
            "launches": counts_b["launches"], "max_abs_err": dyn_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
        # the namespace fold of the state after the cycle's first launch
        # (few terms yet), then the same segments over seeded values (a
        # term in every kept row, the most a fold at check B's shapes
        # takes): the kernels line gives the second
        t = time_seg_fold(sf_calls[1])
        log(json.dumps({"phase": "seg_fold_time", **t}))
        t = time_seg_fold(sf_calls[-2])
        log(json.dumps({"phase": "seg_fold_time_terms", **t}))
        kernels.append({
            "name": "seg_fold", "route": "cuda",
            "source": "volcano_tpu_torch/csrc/seg_fold.cu",
            "replaces": "volcano_tpu/ops/fairshare.py:91",
            "launches": counts_b["seg_fold_launches"],
            "max_abs_err": sf_err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    except Exception as e:
        fail("11 (dynamic-key placer and segmented sum times)", e)

    # ---- 12. the pod-affinity step against its plain version -----------
    clock.lap("12 aff_vs_plain")
    from volcano_tpu_torch.synthetic import affinity_scenario
    try:
        (e_nodes, e_jobs), e_want = CHECK_E
        t0 = time.perf_counter()
        ssn_e = Session(affinity_scenario(e_nodes, e_jobs), affinity_conf(),
                        device="cuda")
        build_e_s = time.perf_counter() - t0
        e_calls = record_launches(ssn_e, keep=3, stop_after=3)
        assert len(e_calls) == 3, "check E's cycle made under 3 launches"
        assert e_calls[0][0].enable_pod_affinity, "check E lost pod affinity"
        built_r, built_d = aff_built_calls()
        aff_err = max(compare_kernel_plain(e_calls + built_r),
                      compare_dyn_kernel_plain(built_d))
        log(json.dumps({"phase": "aff_vs_plain",
                        "round_launches_compared": len(e_calls + built_r),
                        "dyn_launches_compared": len(built_d),
                        "max_abs_err": aff_err}))
    except Exception as e:
        fail("12 (pod-affinity step against plain version)", e)

    # ---- 13. check E: BASELINE configuration 5, this slice's main path --
    clock.lap("13 check_E")
    from volcano_tpu_torch.arrays import pack
    from volcano_tpu_torch.arrays.affinity import build_affinity
    from volcano_tpu_torch.ops.allocate_scan import (AllocateConfig,
                                                     AllocateExtras,
                                                     derive_batching)
    try:
        rp.launches = rp.aff_launches = 0
        t0 = time.perf_counter()
        ssn_e.run_allocate()
        session_e_ms = (time.perf_counter() - t0) * 1000
        counts_e = dict(launches=rp.launches, aff_launches=rp.aff_launches)
        res = ssn_e.last_allocate
        sha = fingerprint(res.task_node, res.task_mode)
        placed = int((res.task_mode > 0).sum())
        ready = int(res.job_ready.sum())
        log(json.dumps({"phase": "check_E", "nodes": e_nodes,
                        "tasks": e_jobs * 8, "cluster_build_s": build_e_s,
                        "pack_ms": ssn_e.stats["pack_ms"],
                        "affinity_ms": ssn_e.stats["affinity_ms"],
                        "cycle_ms": ssn_e.stats["cycle_ms"],
                        "apply_ms": ssn_e.stats["apply_ms"],
                        "run_allocate_ms": session_e_ms,
                        "binds": len(ssn_e.binds), **counts_e,
                        "placed": placed, "jobs_ready": ready,
                        "fingerprint": sha}))
        assert counts_e["aff_launches"] > 0, \
            "the main path launched no round placer with pod affinity"
        assert (sha, placed, ready) == e_want, (sha, placed, ready)
        # the raw configuration-5 cycle, as scripts/affinity_record.py
        # builds it: no Session
        ci_raw = affinity_scenario(e_nodes, e_jobs)
        snap_r, maps_r = pack(ci_raw)
        N_r, T_r = snap_r.nodes.idle.shape[0], snap_r.tasks.resreq.shape[0]
        extras_r = AllocateExtras.neutral(snap_r)
        extras_r.affinity = build_affinity(ci_raw, maps_r, N_r, T_r)
        cfg_r = derive_batching(AllocateConfig(
            binpack_weight=1.0, least_allocated_weight=0.0,
            balanced_weight=0.0, taint_prefer_weight=0.0,
            enable_pod_affinity=True, enable_gpu=False),
            has_proportion=False)
        t0 = time.perf_counter()
        res = make_allocate_cycle(cfg_r)(to_device(snap_r, "cuda"),
                                         to_device(extras_r, "cuda"))
        tn, tm = res.task_node.cpu().numpy(), res.task_mode.cpu().numpy()
        raw_ms = (time.perf_counter() - t0) * 1000
        sha_r = fingerprint(tn, tm)
        log(json.dumps({"phase": "config5_raw_cycle", "cycle_ms": raw_ms,
                        "placed": int((tm > 0).sum()),
                        "fingerprint": sha_r}))
        assert sha_r == e_want[0], f"fingerprint {sha_r} != {e_want[0]}"
    except Exception as e:
        fail("13 (check E, BASELINE configuration 5)", e)

    # ---- 14. check F: the dynamic-key path with pod affinity -----------
    clock.lap("14 check_F")
    try:
        (f_nodes, f_jobs, f_seed), f_want = CHECK_F
        ssn_f = Session(affinity_scenario(f_nodes, f_jobs, seed=f_seed),
                        shipped, device="cuda")
        cfg, extras = ssn_f._derived_allocate_inputs()
        assert cfg.enable_pod_affinity and cfg.batch_rounds > 0, cfg
        s_d, e_d = to_device(ssn_f.snap, "cuda"), to_device(extras, "cuda")
        f_calls = record_launches(ssn_f, keep=1, stop_after=1, dyn=True)
        zero_dyn_counts()
        dp.aff_launches = 0
        t0 = time.perf_counter()
        ssn_f.run_allocate()
        session_f_ms = (time.perf_counter() - t0) * 1000
        counts_f = dict(dyn_counts(), aff_launches=dp.aff_launches)
        res = ssn_f.last_allocate
        sha_f = fingerprint(res.task_node, res.task_mode)
        placed = int((res.task_mode > 0).sum())
        ready = int(res.job_ready.sum())
        zero_dyn_counts()
        t0 = time.perf_counter()
        k_packed = make_allocate_cycle(cfg)(s_d, e_d).packed_decisions().cpu()
        k_ms = (time.perf_counter() - t0) * 1000
        kernel_f = cycle_counts(dp.launches)
        zero_dyn_counts()
        plain_seam = CountingPlain()
        t0 = time.perf_counter()
        p_packed = make_allocate_cycle(
            cfg, placer=rp.round_place_plain,
            dyn_placer=plain_seam)(s_d, e_d).packed_decisions().cpu()
        p_ms = (time.perf_counter() - t0) * 1000
        plain_f = cycle_counts(plain_seam.calls)
        T_f = ssn_f.snap.tasks.status.shape[0]
        sha_k = fingerprint(k_packed[:T_f].numpy(),
                            k_packed[T_f:2 * T_f].numpy())
        log(json.dumps({"phase": "check_F", "nodes": f_nodes,
                        "tasks": f_jobs * 8,
                        "cycle_ms": ssn_f.stats["cycle_ms"],
                        "run_allocate_ms": session_f_ms, **counts_f,
                        "placed": placed, "jobs_ready": ready,
                        "fingerprint": sha_f, "kernel_cycle_ms": k_ms,
                        "plain_cycle_ms": p_ms, "kernel_cycle": kernel_f,
                        "plain_cycle": plain_f,
                        "kernel_cycle_fingerprint": sha_k}))
        assert counts_f["aff_launches"] > 0, \
            "check F launched no dynamic-key placer with pod affinity"
        assert torch.equal(k_packed, p_packed), "F: kernel and plain differ"
        assert kernel_f == plain_f, ("F: launches, pops, early stops",
                                     kernel_f, plain_f)
        assert kernel_f["launches"] > 0
        assert (sha_f, placed, ready) == f_want, (sha_f, placed, ready)
        assert sha_k == f_want[0], f"F: kernel cycle gave {sha_k}"
    except Exception as e:
        fail("14 (check F, the dynamic-key path with pod affinity)", e)

    # ---- 15. the pod-affinity step's own time --------------------------
    clock.lap("15 aff_times")
    try:
        for name, call, dyn, counts in (
                ("pod_affinity_in_round_placer", e_calls[0], False,
                 counts_e),
                ("pod_affinity_in_dyn_placer", f_calls[0], True, counts_f)):
            t = aff_step_time(call, dyn)
            log(json.dumps({"phase": "aff_time", "name": name, **t}))
            kernels.append({
                "name": name, "route": "cuda",
                "source": "volcano_tpu_torch/csrc/placement.cuh",
                "replaces": "volcano_tpu/ops/pallas_place.py:186",
                "launches": counts["aff_launches"], "max_abs_err": aff_err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None})
    except Exception as e:
        fail("15 (pod-affinity step time)", e)

    # ---- 16. the shard-local candidate search against its plain version
    clock.lap("16 shard_vs_plain")
    from volcano_tpu_torch.ops import shard_placer as sp
    try:
        t0 = time.perf_counter()
        ssn_g = Session(_synthetic_cluster(*FULL), sharded_conf(),
                        device="cuda")
        build_g_s = time.perf_counter() - t0
        assert ssn_g._sharding_mesh().size == 1, ssn_g._sharding_mesh()
        g_calls = record_shard_launches(ssn_g, keep=64, stop_after=64)
        assert len(g_calls) == 64, "check G's cycle made under 64 launches"
        built_s = shard_built_calls()
        shard_err = max(compare_shard_plain(g_calls),
                        compare_shard_plain(built_s, GEOMETRIES))
        log(json.dumps({"phase": "shard_vs_plain", "launches_compared":
                        len(g_calls + built_s), "max_abs_err": shard_err}))
    except Exception as e:
        fail("16 (shard-local candidate search against plain version)", e)

    # ---- 17. check G: the sharded path at the north star ----------------
    clock.lap("17 check_G")
    try:
        zero_shard_counts()
        t0 = time.perf_counter()
        with CountCalls(sp, "combine") as combines:
            ssn_g.run_allocate()
        session_g_ms = (time.perf_counter() - t0) * 1000
        counts_g = dict(shard_counts(), combine_calls=combines.calls)
        res = ssn_g.last_allocate
        sha = fingerprint(res.task_node, res.task_mode)
        log(json.dumps({"phase": "check_G", "nodes": FULL[0],
                        "tasks": FULL[1] * FULL[2], "shards": 1,
                        "cluster_build_s": build_g_s,
                        "pack_ms": ssn_g.stats["pack_ms"],
                        "cycle_ms": ssn_g.stats["cycle_ms"],
                        "apply_ms": ssn_g.stats["apply_ms"],
                        "run_allocate_ms": session_g_ms,
                        "binds": len(ssn_g.binds), **counts_g,
                        "fingerprint": sha}))
        assert counts_g["launches"] > 0, "check G launched no shard kernel"
        assert combines.calls == 0, \
            "the CUDA route called shard_placer.combine"
        assert sha == FULL_SHA, f"fingerprint {sha} != {FULL_SHA}"
        assert len(ssn_g.binds) == FULL[1] * FULL[2], len(ssn_g.binds)
    except Exception as e:
        fail("17 (check G, the sharded path at the north star)", e)

    # ---- 18. check H: make_sharded_allocate on a 4-shard virtual mesh --
    clock.lap("18 check_H")
    from volcano_tpu_torch.ops import launch_record
    from volcano_tpu_torch.parallel import NodeMesh, make_sharded_allocate
    #: the launch records of check H's and J's cycles on 4 shards, audited
    #: in phase 24
    shard_records = {}
    try:
        h_size, h_want = CHECK_H
        snap_h, _ = pack(_synthetic_cluster(*h_size))
        extras_h = AllocateExtras.neutral(snap_h)
        cfg_h = AllocateConfig(binpack_weight=1.0)
        s_d, e_d = to_device(snap_h, "cuda"), to_device(extras_h, "cuda")
        out_h = {}
        packed_h = {}
        for D in (4, 1):
            zero_shard_counts()
            t0 = time.perf_counter()
            with launch_record.recording() as launched:
                res = make_sharded_allocate(
                    cfg_h, NodeMesh(("cuda",) * D), s_d)(s_d, e_d)
            if D == 4:
                shard_records["check_H[W=1,4dev]"] = launched
            packed_h[D] = res.packed_decisions().cpu()
            tn, tm = res.task_node.cpu().numpy(), res.task_mode.cpu().numpy()
            out_h[D] = dict(cycle_ms=(time.perf_counter() - t0) * 1000,
                            **shard_counts(),
                            placed=int((tm > 0).sum()),
                            jobs_ready=int(res.job_ready.sum()),
                            fingerprint=fingerprint(tn, tm))
        t0 = time.perf_counter()
        p_res = make_allocate_cycle(
            cfg_h, mesh=NodeMesh(("cuda",) * 4),
            shard_placer=sp.shard_candidates_plain_combined)(s_d, e_d)
        p_packed = p_res.packed_decisions().cpu()
        p_ms = (time.perf_counter() - t0) * 1000
        log(json.dumps({"phase": "check_H", "binpack_4_shards": out_h[4],
                        "binpack_1_shard": out_h[1],
                        "plain_cycle_4_shards_ms": p_ms}))
        for D in (4, 1):
            got = (out_h[D]["fingerprint"], out_h[D]["placed"],
                   out_h[D]["jobs_ready"])
            assert got == h_want, (D, got)
            assert out_h[D]["launches"] > 0, D
        assert torch.equal(packed_h[4], packed_h[1]), "4 shards != 1 shard"
        assert torch.equal(p_packed, packed_h[4]), "H: kernel and plain differ"
    except Exception as e:
        fail("18 (check H, make_sharded_allocate on 4 shards)", e)

    # ---- 19. the candidate kernel's time ------------------------------
    clock.lap("19 shard_time")
    try:
        cfg_g, _, args_g = g_calls[0]
        got = sp.shard_candidates_cuda(cfg_g, 1, args_g)
        plain = sp.shard_candidates_plain_all(cfg_g, 1, args_g)
        triple = sp.combine(plain, args_g[-1].shape[1])
        assert all(bitwise_equal(g, w) for g, w in zip(got[4:], triple)), \
            "the kernel's combined triple differs from combine"
        log(json.dumps({"phase": "shard_combined", "best_idx":
                        got.best_idx.tolist(), "best_found":
                        got.best_found.tolist(), "best_ties":
                        got.best_ties.tolist()}))
        by_shape = {}
        for geometry in GEOMETRIES + tuple(reversed(GEOMETRIES)):
            t = time_shard_kernel(g_calls[0], geometry)
            log(json.dumps({"phase": "shard_time", **t}))
            by_shape.setdefault(geometry, []).append(t)
        t1 = min(by_shape[(sp.THREADS, sp.ROWS_PER_THREAD)],
                 key=lambda r: r["ms"])
        t4 = time_shard_kernel((cfg_g, 4, args_g))
        log(json.dumps({"phase": "shard_time", **t4}))
        kernels.append({
            "name": "shard_candidates", "route": "cuda",
            "source": "volcano_tpu_torch/csrc/shard_candidates.cu",
            "replaces": "volcano_tpu/ops/pallas_place.py:1109",
            "launches": counts_g["launches"], "max_abs_err": shard_err,
            "ms": t1["ms"], "plain_ms": t1["plain_ms"],
            "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
            "library_ms": None})
    except Exception as e:
        fail("19 (candidate kernel time)", e)

    # ---- 20. the wide candidate search against its plain version -------
    clock.lap("20 wave_vs_plain")
    from volcano_tpu_torch.ops import shard_wave as sw
    try:
        t0 = time.perf_counter()
        ssn_i = Session(_synthetic_cluster(*FULL), wave_conf(True),
                        device="cuda")
        build_i_s = time.perf_counter() - t0
        assert ssn_i._sharding_mesh().size == 1, ssn_i._sharding_mesh()
        i_calls = record_wave_launches(ssn_i, keep=32, stop_after=32)
        assert len(i_calls) == 32, "check I's cycle made under 32 launches"
        built_w = wave_built_calls()
        wave_err = compare_wave_plain(i_calls + built_w)
        log(json.dumps({"phase": "wave_vs_plain", "launches_compared":
                        len(i_calls + built_w), "max_abs_err": wave_err}))
    except Exception as e:
        fail("20 (wide candidate search against plain version)", e)

    # ---- 21. check I: the wavefront walk at the north star -------------
    clock.lap("21 check_I")
    try:
        cfg_i, _ = ssn_i._derived_allocate_inputs()
        weights = (cfg_i.binpack_weight, cfg_i.least_allocated_weight,
                   cfg_i.most_allocated_weight, cfg_i.balanced_weight,
                   cfg_i.taint_prefer_weight, cfg_i.wave_width)
        assert weights == (0.0, 1.0, 0.0, 1.0, 0.0, WAVE_I), weights
        fused = Session(_synthetic_cluster(*FULL), wave_conf(False),
                        device="cuda")
        assert fused._sharding_mesh() is None
        fused.run_allocate()
        sha_fused = fingerprint(fused.last_allocate.task_node,
                                fused.last_allocate.task_mode)
        fused_ms = fused.stats["cycle_ms"]
        del fused
        zero_wave_counts()
        t0 = time.perf_counter()
        with CountCalls(sw, "combine") as combines:
            ssn_i.run_allocate()
        session_i_ms = (time.perf_counter() - t0) * 1000
        counts_i = dict(wave_counts(), combine_calls=combines.calls)
        res = ssn_i.last_allocate
        sha = fingerprint(res.task_node, res.task_mode)
        log(json.dumps({"phase": "check_I", "nodes": FULL[0],
                        "tasks": FULL[1] * FULL[2], "shards": 1,
                        "wave_width": WAVE_I,
                        "cluster_build_s": build_i_s,
                        "pack_ms": ssn_i.stats["pack_ms"],
                        "cycle_ms": ssn_i.stats["cycle_ms"],
                        "apply_ms": ssn_i.stats["apply_ms"],
                        "run_allocate_ms": session_i_ms,
                        "binds": len(ssn_i.binds), **counts_i,
                        "fingerprint": sha,
                        "fused_session_cycle_ms": fused_ms,
                        "fused_session_fingerprint": sha_fused}))
        assert counts_i["launches"] > 0, "check I launched no wave kernel"
        assert counts_i["launches"] == counts_i["waves"], counts_i
        assert counts_i["shard_candidates_launches"] == 0, counts_i
        assert counts_i["combine_calls"] == 0, \
            "the CUDA route called shard_wave.combine"
        assert sha == sha_fused, f"fingerprint {sha} != {sha_fused}"
        assert len(ssn_i.binds) == FULL[1] * FULL[2], len(ssn_i.binds)
    except Exception as e:
        fail("21 (check I, the wavefront walk at the north star)", e)

    # ---- 22. check J: check H's configurations on the wave path --------
    clock.lap("22 check_J")
    try:
        h_size, h_want = CHECK_H
        snap_j, _ = pack(_synthetic_cluster(*h_size))
        s_d = to_device(snap_j, "cuda")
        e_d = to_device(AllocateExtras.neutral(snap_j), "cuda")
        out_j = {}
        for W in WAVES_J[0]:
            zero_wave_counts()
            t0 = time.perf_counter()
            with launch_record.recording() as launched, \
                    CountCalls(sw, "combine") as combines:
                res = make_sharded_allocate(
                    AllocateConfig(binpack_weight=1.0, wave_width=W),
                    NodeMesh(("cuda",) * 4), s_d)(s_d, e_d)
            if W == 4:
                shard_records["check_J[W=4,4dev]"] = launched
            tn, tm = res.task_node.cpu().numpy(), res.task_mode.cpu().numpy()
            out_j[W] = dict(cycle_ms=(time.perf_counter() - t0) * 1000,
                            **wave_counts(), combine_calls=combines.calls,
                            placed=int((tm > 0).sum()),
                            jobs_ready=int(res.job_ready.sum()),
                            fingerprint=fingerprint(tn, tm))
        sub_j = Session(_synthetic_cluster(*SUB), shipped, device="cuda")
        cfg_j, extras_j = sub_j._derived_allocate_inputs()
        W = WAVES_J[1]
        zero_wave_counts()
        t0 = time.perf_counter()
        with CountCalls(sw, "combine") as combines:
            res = make_sharded_allocate(
                dataclasses.replace(cfg_j, wave_width=W),
                NodeMesh(("cuda",) * 4), sub_j.snap)(sub_j.snap, extras_j)
        sha_j = fingerprint(res.task_node.cpu().numpy(),
                            res.task_mode.cpu().numpy())
        shipped_j = dict(wave_width=W,
                         cycle_ms=(time.perf_counter() - t0) * 1000,
                         **wave_counts(), combine_calls=combines.calls,
                         fingerprint=sha_j)
        log(json.dumps({"phase": "check_J", **{
            f"binpack_4_shards_W{W}": v for W, v in out_j.items()},
            "shipped_conf_4_shards": shipped_j}))
        for W, o in out_j.items():
            got = (o["fingerprint"], o["placed"], o["jobs_ready"])
            assert got == h_want, (W, got)
            assert o["launches"] > 0 and o["shard_candidates_launches"] == 0
            assert o["combine_calls"] == 0, (W, o)
        assert sha_j == CHECK_C, f"J: shipped conf gave {sha_j}"
        assert shipped_j["launches"] > 0, shipped_j
        assert shipped_j["combine_calls"] == 0, shipped_j
    except Exception as e:
        fail("22 (check J, the wave path on 4 shards)", e)

    # ---- 23. the wide candidate kernel's time --------------------------
    clock.lap("23 wave_time")
    try:
        t1 = time_wave_kernel(i_calls[0])
        cfg_w, _, c_w, args_w = i_calls[0]
        t4 = time_wave_kernel((cfg_w, 4, c_w, args_w))
        for t in (t1, t4):
            log(json.dumps({"phase": "wave_time", **t}))
        kernels.append({
            "name": "shard_wave", "route": "cuda",
            "source": "volcano_tpu_torch/csrc/shard_wave.cu",
            "replaces": "volcano_tpu/ops/pallas_place.py:1266",
            "launches": counts_i["launches"], "max_abs_err": wave_err,
            "ms": t1["ms"], "plain_ms": t1["plain_ms"],
            "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
            "library_ms": None})
    except Exception as e:
        fail("23 (wide candidate kernel time)", e)

    # ---- 24. kernel 6 and the shard-local launch check -----------------
    clock.lap("24 planted_gather")
    from volcano_tpu_torch.analysis import sharding as gs
    try:
        planted_out = {}
        for D, n_nodes, cols in PLANTED:
            gen = torch.Generator().manual_seed(D)
            gs.launches = 0
            x, out, records, rows_per = gs.planted_gather(
                D, n_nodes, cols, "cuda", gen)
            torch.cuda.synchronize()
            planted_launches = gs.launches
            assert planted_launches == D == len(records), planted_launches
            full = x.contiguous()       # every launch's gathered block
            got = gs.planted_double_cuda(full)
            want = gs.planted_double_plain(full)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), "kernel 6 != plain"
            assert torch.equal(out.view(torch.int32),
                               (x * 2).view(torch.int32)), "fixture != x * 2"
            keys = [f.key for f in gs.pallas_block_findings(
                records, n_nodes, rows_per, "planted")]
            assert keys == [f"sharding:pallas-block:planted:"
                            f"{(n_nodes, cols)}"], keys
            planted_out[(D, n_nodes, cols)] = dict(
                launches=planted_launches, max_abs_err=err, findings=keys)
        audit = {}
        h_nodes = CHECK_H[0][0]
        for where, launched in shard_records.items():
            found = gs.pallas_block_findings(launched, h_nodes,
                                             h_nodes // 4, where)
            audit[where] = dict(launches=len(launched),
                                findings=[f.key for f in found])
            assert launched, f"{where}: no launch recorded"
            assert not found, [f.key for f in found]
        assert len(audit) == 2, sorted(audit)
        # time: the fixture's D launches on its gathered block
        reps = 200
        times = {}
        calls = dict(kernel=gs.planted_double_cuda,
                     plain=gs.planted_double_plain,
                     library=lambda t: torch.mul(t, 2.0))
        for name in ("plain", "kernel", "library", "library", "kernel",
                     "kernel", "library", "plain"):
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
        nbytes = D * 2 * full.numel() * 4
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = D * full.numel() / PEAK_F32 * 1e3
        t = dict(D=D, n_nodes=n_nodes, cols=cols,
                 ms=min(times["kernel"]), plain_ms=min(times["plain"]),
                 library_ms=min(times["library"]),
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bytes=nbytes, runs_ms=times)
        log(json.dumps({"phase": "planted_gather",
                        "fixtures": {str(k): v
                                     for k, v in planted_out.items()},
                        "audit": audit, "time": t}))
        kernels.append({
            "name": "planted_gather", "route": "cuda",
            "source": "volcano_tpu_torch/csrc/planted_gather.cu",
            "replaces": "volcano_tpu/analysis/sharding.py:149",
            "launches": planted_launches,
            "max_abs_err": max(v["max_abs_err"]
                               for v in planted_out.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    except Exception as e:
        fail("24 (kernel 6 and the shard-local launch check)", e)

    # ---- 25. check K: enqueue, allocate, backfill -----------------------
    clock.lap("25 check_K")
    import hashlib

    import numpy as np

    from volcano_tpu_torch.actions import get_action
    from volcano_tpu_torch.ops import enqueue as enqueue_ops
    from volcano_tpu_torch.synthetic import admission_scenario
    try:
        t0 = time.perf_counter()
        ssn_k = Session(admission_scenario(), check_k_conf(), now=4149.0,
                        device="cuda")
        build_k_s = time.perf_counter() - t0
        pack_k_ms = ssn_k.stats["pack_ms"]
        action_ms = {}
        zero_dyn_counts()
        with SegFoldTap(enqueue_ops) as enqueue_folds:
            for name in ssn_k.conf.actions:
                t0 = time.perf_counter()
                get_action(name).execute(ssn_k)
                action_ms[name] = (time.perf_counter() - t0) * 1000
                if name == "enqueue":
                    # what allocate then runs on (no device work)
                    alloc_inputs = (ssn_k.snap,
                                    *ssn_k._derived_allocate_inputs())
                if name == "allocate":
                    n_alloc = len(ssn_k.binds)
        counts_k = dyn_counts()
        # kernel 3 and the segmented sum against their plain versions on
        # check K's own inputs: the sla deadline as an ordering key, the
        # repacked snapshot, and enqueue's one-segment sums
        assert alloc_inputs[1].sla_job_order, "check K without the sla key"
        dyn_k = record_launches(ssn_k, keep=3, stop_after=3, dyn=True,
                                inputs=alloc_inputs)
        assert len(dyn_k) == 3, len(dyn_k)
        dyn_k_err = compare_dyn_kernel_plain(dyn_k)
        assert len(enqueue_folds.calls) == 3, len(enqueue_folds.calls)
        seg_k_err = compare_seg_fold_plain(
            enqueue_folds.calls + seg_fold_calls(ssn_k, dyn_k))
        admitted = ssn_k.last_enqueue
        res = ssn_k.last_allocate
        sha = fingerprint(res.task_node, res.task_mode)
        pairs = np.asarray([[ssn_k.maps.task_index[b.task_uid],
                             ssn_k.maps.node_index[b.node_name]]
                            for b in ssn_k.binds[n_alloc:]],
                           np.int32).reshape(-1, 2)
        got = (ssn_k.stats["enqueued"],
               hashlib.sha256(admitted.tobytes()).hexdigest()[:16], sha,
               n_alloc, ssn_k.stats["backfilled"],
               hashlib.sha256(pairs.tobytes()).hexdigest()[:16])
        log(json.dumps({
            "phase": "check_K", "nodes": len(ssn_k.cluster.nodes),
            "jobs": len(ssn_k.cluster.jobs),
            "cluster_build_s": build_k_s, "pack_ms": pack_k_ms,
            "repack_ms": ssn_k.stats["pack_ms"], "action_ms": action_ms,
            "enqueue_ms": ssn_k.stats["enqueue_ms"],
            "cycle_ms": ssn_k.stats["cycle_ms"],
            "apply_ms": ssn_k.stats["apply_ms"],
            "backfill_ms": ssn_k.stats["backfill_ms"], **counts_k,
            "dyn_vs_plain": dict(launches=len(dyn_k), max_abs_err=dyn_k_err),
            "seg_fold_vs_plain": dict(
                enqueue_calls=len(enqueue_folds.calls),
                max_abs_err=seg_k_err),
            "enqueued": got[0], "admitted_sha256": got[1],
            "fingerprint": got[2], "allocate_binds": got[3],
            "jobs_ready": int(res.job_ready.sum()),
            "backfilled": got[4], "backfill_sha256": got[5],
            "backfill_nodes": sorted(set(pairs[:, 1].tolist())),
            "most_pods_on_a_node": max(len(n.tasks) for n in
                                       ssn_k.cluster.nodes.values())}))
        assert counts_k["launches"] > 0, "check K launched no dyn placer"
        assert counts_k["seg_fold_launches"] > 0, \
            "check K launched no segmented sum"
        assert got == CHECK_K, (got, CHECK_K)
    except Exception as e:
        fail("25 (check K, enqueue, allocate, backfill)", e)

    # ---- 26. check L: many namespaces on the dynamic-key path ----------
    clock.lap("26 check_L")
    try:
        (shape_l, n_ns, want_l) = CHECK_L
        t0 = time.perf_counter()
        ci_l = _synthetic_cluster(*shape_l, namespaces=n_ns)
        ssn_l = Session(ci_l, shipped, now=4149.0, device="cuda")
        build_l_s = time.perf_counter() - t0
        l_calls = record_launches(ssn_l, keep=3, stop_after=3, dyn=True)
        assert len(l_calls) == 3, len(l_calls)
        a_l = dp.unpack_args(l_calls[0][0], l_calls[0][4])
        S_l, R_l = a_l.nsm.shape[0], a_l.jalloc.shape[0]
        assert S_l * R_l > dp.PAIR_TILE, (S_l, R_l)
        l_err = compare_dyn_kernel_plain(l_calls)
        zero_dyn_counts()
        ssn_l.run_allocate()
        counts_l = dyn_counts()
        res = ssn_l.last_allocate
        got = (fingerprint(res.task_node, res.task_mode),
               int((res.task_mode > 0).sum()), int(res.job_ready.sum()))
        log(json.dumps({
            "phase": "check_L", "nodes": shape_l[0],
            "namespaces": n_ns, "padded_namespaces": S_l,
            "fold_pairs": S_l * R_l,
            "pair_tiles": -(-S_l * R_l // dp.PAIR_TILE),
            "cluster_build_s": build_l_s,
            "dyn_vs_plain": dict(launches=len(l_calls), max_abs_err=l_err),
            "path": ssn_l.stats["path"], "pack_ms": ssn_l.stats["pack_ms"],
            "cycle_ms": ssn_l.stats["cycle_ms"], **counts_l,
            "fingerprint": got[0], "placed": got[1], "jobs_ready": got[2]}))
        assert counts_l["launches"] > 0, "check L launched no dyn placer"
        assert got == want_l, (got, want_l)
        churn_l = churn_cycle(ssn_l, np.random.RandomState(CHURN[1]),
                              dyn=True)
        log(json.dumps({"phase": "check_L_churn", **churn_l}))
    except Exception as e:
        fail("26 (check L, 128 namespace-fold pairs)", e)

    # ---- 27. check M: the north star's churn cycles, this slice's path --
    clock.lap("27 check_M")
    try:
        # cycle 0 is phase 4's full cycle on ``ssn``, which holds the
        # resident buffers since
        assert ssn.stats["last_kind"] == "full" and \
            ssn.stats["path"] == "round"
        rng = np.random.RandomState(CHURN[1])
        for c in range(1, CHURN_CYCLES + 1):
            out = churn_cycle(ssn, rng)
            log(json.dumps({"phase": "check_M", "cycle": c, **out}))
        log(json.dumps({"phase": "check_M_digest",
                        **time_digest(next(iter(ssn._resident.values())))}))
    except Exception as e:
        fail("27 (check M, the north star's churn cycles)", e)

    # ---- 28. kernel 3's namespace fold in tiles: device time by pairs ---
    clock.lap("28 fold_tiles")
    try:
        fold = {}
        for S in FOLD_S:
            call = fold_call(S)
            err = compare_dyn_kernel_plain([call])
            t = time_dyn_kernel(call)
            # the same launches timed without a trace, as device_ms does
            # when no trace keeps one
            queued_ms = device_ms(lambda: dp.dyn_place_cuda(*call),
                                  "dyn_placer_kernel", 50, traces=0)[0]
            split = dyn_phase_split(call, dp.CLUSTER)
            P = 2 * S
            fold[P] = t["ms"]
            log(json.dumps({"phase": "dyn_fold_tiles", "S": S, "P": P,
                            "tiles": -(-P // dp.PAIR_TILE),
                            "max_abs_err": err, **t,
                            "queued_ms": queued_ms, "split_us": split}))
        for k in kernels:
            if k["name"] == "dyn_placer":
                k.update(pair_tile=dp.PAIR_TILE, fold_pairs_ms=fold)
    except Exception as e:
        fail("28 (kernel 3's fold tiles)", e)

    # ---- 29. check N: a MIG GPU cluster at 12 resource dims -------------
    clock.lap("29 check_N")
    try:
        kernels = check_n(kernels)
    except Exception as e:
        fail("29 (check N, 12 resource dims)", e)
    clock.lap()

    log(json.dumps({"phase_seconds": clock.seconds}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
