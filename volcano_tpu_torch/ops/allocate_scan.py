"""The allocate action as one pass over device tensors (PyTorch port of
``volcano_tpu/ops/allocate_scan.py``, its batched branches).

The reference's dominant pass (pkg/scheduler/actions/allocate/allocate.go
:43-281 with the Statement commit/discard transaction, framework/statement.go
:27-395): the nested namespace -> queue -> job priority queues become a
lexicographic masked argmin over key vectors; PredicateNodes +
PrioritizeNodes + SelectBestNode become a feasibility-mask -> score ->
argmax step over the node axis; gang JobReady / JobPipelined / Discard
commit or restore the section's capacity.

Two paths, chosen by :func:`derive_batching`:

- static keys (no drf / hdrf ordering and no finite proportion
  ``deserved``): the next K sequential pops are the K lexicographically
  smallest eligible jobs now, and one round placer call
  (``ops/round_placer.py``) places all K sections;
- dynamic keys (``batch_rounds`` > 0): the K smallest eligible jobs are the
  candidates of one dynamic-key placer call (``ops/dyn_placer.py``), which
  pops up to ``batch_rounds`` jobs, recomputing the keys after every
  commit, and stops when the true next pop is not a candidate.

With a node mesh the cycle takes the reference's sharded scan path
instead: one pop at a time, each slot one attempt through the shard-local
candidate search (``ops/shard_placer.py``), or with ``wave_width`` W > 1
the wavefront section walk: waves of W slots, each one launch of the wide
candidate search (``ops/shard_wave.py``), committed in one batch or in
slot order with an exact rescore of the rows the wave touched.

Each round launches one placer and folds its outputs back into the per-job
state; the loop runs until no job is eligible, with one host readback per
round. With pod affinity both placers carry the live inter-pod affinity
counts from round to round (``arrays/affinity.py``'s node-space encoding,
split as counts [SK, N], cluster totals [SK, 1] and anti counts [ETA, N]),
and each launch gathers the task-side term tables of its slots on the
device. The placers run their CUDA kernels on CUDA tensors and their plain
versions on CPU tensors. Decisions are bit-identical to the reference's
scan path and its Pallas kernels.

Documented divergence (shared with the reference): score ties break to the
lowest node index instead of rand.Intn (scheduler_helper.go:227).
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..arrays.affinity import AffinityArrays
from ..arrays.hierarchy import HierarchyArrays
from ..arrays.schema import SnapshotArrays
from . import dyn_placer as dp
from . import predicates as P
from . import round_placer
from . import scoring as S
from . import shard_placer as sp
from . import shard_wave as sw
from .fairshare import drf_job_shares, hdrf_level_keys, namespace_shares
from .round_placer import MODE_ALLOCATED, MODE_NONE, MODE_PIPELINED
from .select import lex_argmin

__all__ = ["MODE_NONE", "MODE_ALLOCATED", "MODE_PIPELINED", "AllocateConfig",
           "AllocateExtras", "AllocateResult", "derive_batching",
           "make_allocate_cycle", "normalize_wave", "unpack_decisions",
           "wave_candidate_depth"]

#: jobs per placer launch on the static-key path (see derive_batching)
DEFAULT_BATCH_JOBS = 8

#: in-kernel pops per launch on the dynamic-key path
DEFAULT_BATCH_ROUNDS = 32

_EPS_CMP = float(np.float32(1e-6))    # overused queue slack
_EPS_FIT = float(np.float32(1e-5))    # give-up bound slack
_EPS_DIV = float(np.float32(1e-9))


def wave_candidate_depth(wave_width: int) -> int:
    """Candidate-list depth C of the wavefront sweep: each slot of a wave
    carries its top C feasible nodes by (score desc, index asc). A wave of
    W slots touches at most W - 1 nodes before slot w commits, so
    C = min(W, 8) makes an exhausted list (the only truncation) impossible
    below W = 8 while bounding what the sweep ships."""
    return min(max(1, int(wave_width)), 8)


def normalize_wave(cfg: "AllocateConfig") -> "AllocateConfig":
    """The single authority for legal ``wave_width`` combinations: pod
    affinity and host ports mutate state a wave's row-local rescore cannot
    see, and force W back to 1; W < 1 clamps to 1."""
    W = max(1, int(cfg.wave_width))
    if cfg.enable_pod_affinity or cfg.enable_host_ports:
        W = 1
    if W != cfg.wave_width:
        return dataclasses.replace(cfg, wave_width=W)
    return cfg


def derive_batching(cfg: "AllocateConfig", queue_deserved=None,
                    has_proportion: bool = None) -> "AllocateConfig":
    """The single authority for the batching preconditions.

    Static-key batching (``batch_jobs`` > 1) is bit-exact with the
    sequential pop order only when no ordering key can move under a commit:
    no drf/hdrf dynamic ordering and no finite proportion ``deserved``
    anywhere (a 0 counts: zero-quota queues flip overused on the first
    commit). Otherwise the dynamic-key path (``batch_rounds`` > 0) is
    selected. Explicit manual settings are respected untouched.
    """
    cfg = normalize_wave(cfg)
    if cfg.batch_jobs != 1 or cfg.batch_rounds:
        return cfg
    if has_proportion is None:
        has_proportion = bool(np.any(np.isfinite(np.asarray(queue_deserved))))
    dynamic = (cfg.drf_job_order or cfg.drf_ns_order or cfg.enable_hdrf
               or has_proportion)
    if dynamic:
        return dataclasses.replace(cfg, batch_jobs=DEFAULT_BATCH_JOBS,
                                   batch_rounds=DEFAULT_BATCH_ROUNDS)
    return dataclasses.replace(cfg, batch_jobs=DEFAULT_BATCH_JOBS)


@dataclass(frozen=True)
class AllocateConfig:
    """Static pass-composition config (the analog of the conf YAML tiers +
    plugin arguments, pkg/scheduler/conf/scheduler_conf.go:20-82). The same
    fields as the reference's, less ``use_pallas``: here the device of the
    tensors chooses between the CUDA kernel and the plain version."""

    binpack_weight: float = 0.0          # binpack.weight (binpack.go:85-151)
    least_allocated_weight: float = 1.0  # nodeorder leastrequested.weight
    most_allocated_weight: float = 0.0   # nodeorder mostrequested.weight
    balanced_weight: float = 1.0         # nodeorder balanced.weight
    taint_prefer_weight: float = 1.0     # nodeorder tainttoleration.weight
    enable_pipelining: bool = True       # allow placement on FutureIdle
    enable_gang: bool = True             # gang all-or-nothing semantics
    #: InterPodAffinity predicate + batch scorer (predicates.go:261-273,
    #: nodeorder.go:273-306), carried through both placers
    enable_pod_affinity: bool = False
    enable_host_ports: bool = False      # k8s NodePorts (not ported yet)
    pod_affinity_weight: float = 1.0     # nodeorder interpodaffinity.weight
    enable_hdrf: bool = False            # hdrf queue ordering (drf.go:230-360)
    drf_job_order: bool = False          # drf JobOrderFn (drf.go:454-472)
    drf_ns_order: bool = False           # drf NamespaceOrderFn (drf.go:474-507)
    tdm_job_order: bool = False          # tdm JobOrderFn (tdm.go:261-273)
    sla_job_order: bool = False          # sla JobOrderFn (sla.go:104-131)
    max_rounds: Optional[int] = None     # cap on outer job iterations
    #: jobs per placer launch on the static-key path (derive_batching)
    batch_jobs: int = 1
    #: pops per launch on the dynamic-key path (derive_batching)
    batch_rounds: int = 0
    #: shared-GPU predicate + card accounting (gpu.go:41-56); the session
    #: turns it off when no task requests GPU memory
    enable_gpu: bool = True
    telemetry: bool = False              # in-graph cycle telemetry (not ported yet)
    #: wavefront width: W slots a sweep on the sharded path (the fused
    #: placers take whole job sections and ignore it, as the
    #: reference's do)
    wave_width: int = 1


@dataclass
class AllocateExtras:
    """Dynamic per-cycle plugin contributions consumed by the pass (the
    same fields as the reference's); the session fills neutral defaults for
    disabled plugins (see :meth:`neutral`)."""

    job_share: Any          # f32[J] drf JobOrderFn key
    job_deadline: Any       # f32[J] sla deadline key, +inf = no SLA
    queue_deserved: Any     # f32[Q,R] proportion deserved (+inf = neutral)
    ns_share: Any           # f32[S] drf namespace fairness
    queue_share_extra: Any  # f32[Q] hdrf hierarchical key
    block_nonrevocable: Any  # bool[N] tdm active-window revocable nodes
    block_all: Any          # bool[N] tdm inactive-window revocable nodes
    task_revocable: Any     # bool[T] task may use revocable nodes
    tdm_bonus: Any          # f32[N] tdm node-order bonus for revocable tasks
    revocable_node: Any     # bool[N] node carries a revocable zone
    task_pref_node: Any     # i32[T] task-topology bucket node
    node_locked: Any        # bool[N] reservation locks
    target_job: Any         # i32 job exempt from locks
    affinity: AffinityArrays    # inter-pod affinity encoding
    hierarchy: HierarchyArrays  # hdrf tree topology
    task_ports: Any         # i32[T, HP] NodePorts filter inputs
    node_ports: Any         # i32[N, PS]
    pe_node0: Any           # i32[PE]
    pe_port0: Any           # i32[PE]
    task_volume_ok: Any     # bool[T] volume-binding seam
    task_volume_node: Any   # i32[T] pinned node, -1 = any
    template_na_score: Any  # f32[P, N] NodeAffinity preferred score
    task_or_group: Any      # i32[T] OR-of-terms node affinity group, -1 none
    or_feasible: Any        # bool[GR, N]
    job_victim_budget: Any  # i32[J] preempt eviction budget

    @classmethod
    def neutral(cls, snap: SnapshotArrays) -> "AllocateExtras":
        J = snap.jobs.min_available.shape[0]
        Q, R = snap.queues.allocated.shape
        S_ = snap.namespace_weight.shape[0]
        N = snap.nodes.pod_count.shape[0]
        T = snap.tasks.status.shape[0]
        return cls(
            job_share=np.zeros(J, np.float32),
            job_deadline=np.full(J, np.inf, np.float32),
            queue_deserved=np.full((Q, R), np.inf, np.float32),
            ns_share=np.zeros(S_, np.float32),
            queue_share_extra=np.zeros(Q, np.float32),
            block_nonrevocable=np.zeros(N, bool),
            block_all=np.zeros(N, bool),
            task_revocable=np.zeros(T, bool),
            tdm_bonus=np.zeros(N, np.float32),
            revocable_node=np.zeros(N, bool),
            task_pref_node=np.full(T, -1, np.int32),
            node_locked=np.zeros(N, bool),
            target_job=np.int32(-1),
            affinity=AffinityArrays.neutral(N, T),
            hierarchy=HierarchyArrays.neutral(Q, J),
            task_ports=np.zeros((T, 1), np.int32),
            node_ports=np.zeros((N, 1), np.int32),
            pe_node0=np.full(1, -1, np.int32),
            pe_port0=np.zeros(1, np.int32),
            task_volume_ok=np.ones(T, bool),
            task_volume_node=np.full(T, -1, np.int32),
            template_na_score=np.zeros(
                (snap.template_rep.shape[0], N), np.float32),
            task_or_group=np.full(T, -1, np.int32),
            or_feasible=np.ones((1, N), bool),
            job_victim_budget=np.full(J, 2 ** 31 - 1, np.int32),
        )


@dataclass
class AllocateResult:
    task_node: torch.Tensor       # i32[T] node index or -1
    task_mode: torch.Tensor       # i32[T] MODE_*
    task_gpu: torch.Tensor        # i32[T] assigned GPU card or -1
    job_ready: torch.Tensor       # bool[J] gang became ready (binds emitted)
    job_pipelined: torch.Tensor   # bool[J] gang holds capacity, no binds
    job_attempted: torch.Tensor   # bool[J] job was popped this cycle
    idle: torch.Tensor            # f32[N, R] remaining idle after the pass
    queue_allocated: torch.Tensor  # f32[Q, R] post-pass queue usage

    def packed_decisions(self) -> torch.Tensor:
        """i32[3T + 3J]: every decision output in one tensor, so the host
        reads the cycle back in one copy. Decode with
        :func:`unpack_decisions`."""
        return torch.cat([
            self.task_node, self.task_mode, self.task_gpu,
            self.job_ready.to(torch.int32),
            self.job_pipelined.to(torch.int32),
            self.job_attempted.to(torch.int32)])


def unpack_decisions(packed, T: int, J: int):
    """Inverse of AllocateResult.packed_decisions on a host numpy array."""
    packed = np.asarray(packed)
    return (packed[:T], packed[T:2 * T], packed[2 * T:3 * T],
            packed[3 * T:3 * T + J].astype(bool),
            packed[3 * T + J:3 * T + 2 * J].astype(bool),
            packed[3 * T + 2 * J:3 * T + 3 * J].astype(bool))


def _check_supported(cfg: AllocateConfig, mesh=None) -> None:
    """Raise for the configurations this slice of the port does not carry,
    naming the ROADMAP item that ports each."""
    todo = []
    if mesh is not None:
        mesh.device()          # one device: a multi-device mesh raises
        todo = [
            (cfg.enable_pod_affinity, "enable_pod_affinity under a node mesh",
             "ROADMAP queue 1 item 6d: the reference runs it on its plain "
             "scan path, without the shard-local kernel"),
        ]
    todo += [
        (cfg.enable_host_ports, "enable_host_ports",
         "ROADMAP queue 1 item 4b, host ports: the reference runs them on "
         "its scan path only, so they need a per-task path in the port"),
        (cfg.telemetry, "telemetry", "ROADMAP queue 1 item 7, telemetry"),
    ]
    for hit, what, item in todo:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported to volcano_tpu_torch yet ({item})")
    # static-key batching cannot carry dynamic ordering keys: their
    # recompute lives only in the dynamic-key placer
    if (cfg.batch_jobs > 1 and not cfg.batch_rounds
            and (cfg.drf_job_order or cfg.drf_ns_order or cfg.enable_hdrf)):
        raise ValueError(
            "batch_jobs > 1 on the static-keys path requires static "
            "ordering keys (no drf/hdrf dynamic ordering); use "
            "batch_rounds (derive_batching sets it) for dynamic keys")


def dyn_refusal(cfg: AllocateConfig, snap, extras) -> Optional[str]:
    """Why the dynamic-key placer's kernel does not take this snapshot's
    shapes (more ordering keys than it keys on, or more jobs than its
    shared memory holds: ``dyn_placer.refusal``, the check every launch
    makes), or None. Read from shapes alone, before the cycle runs."""
    nodes, jobs = snap.nodes, snap.jobs
    N, R = nodes.idle.shape
    J, M = jobs.task_table.shape
    NH = 2 * extras.hierarchy.queue_path.shape[1] if cfg.enable_hdrf else 0
    plan, NKS = dp.key_plan(cfg, NH)
    ad = dict(aff=0, SK=0, ETA=0, SEL=0, A=0, B=0, PP=0)
    if cfg.enable_pod_affinity:
        afa = extras.affinity
        ad = dict(aff=1, SK=afa.sk_domain.shape[0],
                  ETA=afa.eta_domain.shape[0], SEL=afa.static_pref.shape[0],
                  A=afa.task_aff_sk.shape[1], B=afa.task_anti_term.shape[1],
                  PP=afa.task_pref_sk.shape[1])
    S = extras.ns_share.shape[0] if cfg.drf_ns_order else 0
    return dp.refusal(
        N, J, dp.CLUSTER, len(plan), max(1, int(cfg.batch_jobs)), M, R,
        nodes.gpu_memory.shape[1] if cfg.enable_gpu else 0,
        extras.queue_deserved.shape[0], S, S * R, NKS, NH, ad["SK"],
        round_placer.aff_list_ints(ad))


def cycle_path(cfg: AllocateConfig, snap, extras, mesh=None) -> str:
    """The path :func:`make_allocate_cycle` takes for this snapshot, from
    its shapes: ``"mesh"`` under a node mesh, ``"round"`` (the static-key
    round placer), ``"dyn"`` (the dynamic-key placer), or ``"dyn_mesh"``:
    dynamic keys whose snapshot the dynamic-key kernel does not take
    (:func:`dyn_refusal`), placed on the one-shard mesh path, one pop and
    one attempt at a time through the shard-local candidate kernel. That
    is where the reference goes when its VMEM estimate refuses its fused
    kernel: its scan path, whose decisions the mesh path gives."""
    if mesh is not None:
        return "mesh"
    if max(0, int(cfg.batch_rounds)) == 0:
        return "round"
    return "dyn" if dyn_refusal(cfg, snap, extras) is None else "dyn_mesh"


def gather_slot_tables(tables, flat_ids):
    """The columns of a launch's slots from per-task tables [.., T], on
    the tables' device (the affinity term tables of the placers)."""
    return [t.index_select(1, flat_ids).contiguous() for t in tables]


def _dyn_static_args(cfg, snap, extras, keys_static):
    """The per-cycle job rows of the dynamic-key placer: ``head`` (the
    static key columns, in the order the key plan reads them), ``jobs``
    (queue and namespace maps, gang, eligibility and fairness inputs, in
    the placer's argument order) and ``tgt``."""
    jobs = snap.jobs
    f32, i32 = torch.float32, torch.int32
    dev = jobs.valid.device
    Q = extras.queue_deserved.shape[0]
    S = extras.ns_share.shape[0]
    job_ns = jobs.namespace.long()
    rows = []
    if not cfg.drf_ns_order:
        rows.append(extras.ns_share[job_ns])
    rows += [jobs.namespace.to(f32), jobs.queue.to(f32),
             -jobs.priority.to(f32)]
    if cfg.tdm_job_order:
        rows.append(jobs.preemptable.to(f32))
    if cfg.sla_job_order:
        rows.append(extras.job_deadline)
    if not cfg.drf_job_order:
        rows.append(extras.job_share)
    rows.append(jobs.creation_rank.to(f32))
    mid = [jobs.queue.to(i32)[None, :],
           (torch.arange(Q, device=dev)[:, None]
            == jobs.queue[None, :]).to(f32)]
    if cfg.drf_ns_order:
        nsm = torch.arange(S, device=dev)[:, None] == jobs.namespace[None, :]
        mid += [nsm.to(f32), (nsm & jobs.valid[None, :]).to(f32),
                snap.namespace_weight.to(f32)[None, :].contiguous()]
    # re-pop fusion flag per job: static keys and no finite deserved on
    # the job's queue
    canb = ~torch.isfinite(extras.queue_deserved[jobs.queue.long()]).any(1) \
        & keys_static
    mid += [jobs.min_available.to(i32)[None, :],
            jobs.ready_num.to(i32)[None, :],
            jobs.n_pending.to(i32)[None, :],
            (jobs.valid & jobs.schedulable).to(i32)[None, :],
            jobs.valid.to(f32)[None, :],
            canb.to(i32)[None, :],
            extras.queue_deserved.to(f32).contiguous(),
            extras.queue_share_extra.to(f32)[:, None].contiguous(),
            snap.cluster_capacity.to(f32)[:, None].contiguous()]
    tgt = torch.full((1, 1), int(extras.target_job), dtype=i32, device=dev)
    return dict(head=[torch.stack(rows).to(f32).contiguous()], jobs=mid,
                tgt=tgt)


def _step(name):
    """A span around one step of the wavefront walk: a no-op here;
    ``scripts/torch_cycle_profile.py`` replaces it with a profiler span."""
    return contextlib.nullcontext()


def _sharded_pops(cfg, D, place_shard, place_wave, snap, extras, node_env,
                  eligible, order_keys, jobs_min_req, st, max_rounds):
    """The sharded scan path of :func:`make_allocate_cycle`: pops until no
    job is eligible, each pop one job's slots in slot order: with
    ``wave_width`` 1 one attempt a slot, with W > 1 the wavefront section
    walk (``wave_walk`` below). ``st`` holds the cycle's state tensors,
    which are updated in place (``eligible`` and ``order_keys`` read
    them); returns the final idle [R, N].

    Everything stays on the device: the popped job, its slots, the combined
    winner and every flag are tensors, the commits are ``index_add_`` and
    index writes on device indices, and the host reads the state back once
    a pop (whether any job is eligible, whether the last pop progressed,
    and which slots are open: the attempts run over those only, as the
    reference's steps of closed slots change nothing); the wave walk reads
    back once a wave, and once a slot of its in-order walk."""
    nodes, tasks, jobs = snap.nodes, snap.tasks, snap.jobs
    dev = nodes.idle.device
    f32, i32 = torch.float32, torch.int32
    N, R = nodes.idle.shape
    T = tasks.resreq.shape[0]
    J, M = jobs.task_table.shape
    if N % D:
        raise ValueError(f"sharding needs nodes % mesh devices == 0 "
                         f"(N={N}, devices={D})")
    W = int(cfg.wave_width)
    keys_static = not (cfg.drf_job_order or cfg.drf_ns_order
                       or cfg.enable_hdrf)
    target_job = int(extras.target_job)
    idle, pipe, pods, gpux = st["idle"], st["pipe"], st["pods"], st["gpux"]
    task_node, task_mode, task_gpu = (st["task_node"], st["task_mode"],
                                      st["task_gpu"])
    job_done, job_popped = st["job_done"], st["job_popped"]
    job_cursor, job_alloc_count = st["job_cursor"], st["job_alloc_count"]
    queue_allocated = st["queue_allocated"]

    # the candidate kernel's node maps: releasing and pipelined apart, for
    # the scan association of future idle
    rel_t = nodes.releasing.T.contiguous()
    pip_t = nodes.pipelined.T.contiguous()
    shard_env = node_env[:8] + [rel_t, pip_t] + node_env[9:]
    # the scan path picks a GPU card at every commit, with or without the
    # GPU predicate; a snapshot with no GPU request never charges one
    gpu_pick = bool(cfg.enable_gpu) or bool((tasks.gpu_request > 0).any())
    gidle0_t = (nodes.gpu_memory - nodes.gpu_used).T.contiguous()
    # per-task kernel inputs, gathered for a pop's slots once
    treq = (torch.cat([tasks.resreq, tasks.gpu_request[:, None]], 1)
            if cfg.enable_gpu else tasks.resreq).to(f32).contiguous()
    tint = torch.stack([
        extras.task_pref_node, tasks.template.clamp_min(0),
        extras.task_or_group, extras.task_volume_node,
        extras.task_volume_ok.to(i32), extras.task_revocable.to(i32)],
        1).to(i32).contiguous()
    not_be = ~tasks.best_effort
    node_live = nodes.valid & nodes.schedulable
    des_finite = torch.isfinite(extras.queue_deserved)
    job_q = jobs.queue.long()
    slots = torch.arange(M, dtype=i32, device=dev)
    neg_inf = torch.full((), float("-inf"), device=dev)

    def zeros(dtype):
        return torch.zeros(1, dtype=dtype, device=dev)

    def commit(do_alloc, do_pipe, node, rr, gr, t1):
        """One slot's placement (the reference's task_step commit): take
        ``rr`` from idle (``do_alloc``) or add it to the pipelined extra
        (``do_pipe``) on ``node``, count the pod, charge the lowest fitting
        GPU card, and record the task ``t1``. Masked: a slot that places
        nothing adds zeros and writes to the sentinel row T."""
        placed = do_alloc | do_pipe
        idle.index_add_(1, node, (-(do_alloc.to(f32) * rr))[:, None])
        pipe.index_add_(1, node, (do_pipe.to(f32) * rr)[:, None])
        pods.index_add_(1, node, placed.to(f32)[None, :])
        if gpu_pick:
            # shared-GPU card: lowest fitting card on the chosen node
            # (predicates.pick_gpu_row), charged for the cycle
            col = (gidle0_t.index_select(1, node)
                   - gpux.index_select(1, node))[:, 0]          # [G]
            fits = col >= gr - _EPS_FIT
            card = torch.where(fits.any() & (gr > 0),
                               fits.to(torch.uint8).argmax(), -1)
            charge = placed & (card >= 0)
            gpux.view(-1).index_add_(
                0, card.clamp_min(0) * N + node,
                torch.where(charge, gr, 0.0))
            task_gpu[torch.where(charge, t1, T)] = card.to(i32).view(1)
        tw = torch.where(placed, t1, T)
        task_node[tw] = node.to(i32)
        task_mode[tw] = torch.where(do_alloc, MODE_ALLOCATED,
                                    MODE_PIPELINED).to(i32)
        return placed

    if W > 1:
        C = wave_candidate_depth(W)
        iw = torch.arange(W, device=dev)
        eye_w = iw[:, None] == iw[None, :]
        ltri = iw[None, :] < iw[:, None]                   # [w, v]: v < w
        no_task = torch.full((W,), -1, dtype=jobs.task_table.dtype,
                             device=dev)
        no_suffix = torch.zeros(W, dtype=i32, device=dev)
        g_iota = torch.arange(gidle0_t.shape[0], device=dev)[:, None]
        sentinel = torch.full((W + 1,), N, dtype=i32, device=dev)
        # the static node maps stacked for the rescore's row gathers; the
        # GPU check whenever a card may be charged (the reference's
        # rescore always checks, and a zero request always passes)
        maps = sw.row_maps(sp.ShardArgs(None, None, None, *shard_env[:13],
                                        None, None, None, None, None),
                           gidle0_t if gpu_pick else None)

    def wave_walk(task_ids, lo, hi, nbe, suffix_after, istgt, ready0,
                  min_avail, can_batch):
        """The wavefront section walk of one pop (allocate_scan.py
        :2096-2437): waves of W slots from the job's cursor, each one
        launch of the wide candidate kernel against the wave's starting
        state, the shards' lists combined, then either the batched commit
        (``fast_ok``) or the in-order walk that rescores the rows the wave
        touched and truncates at a slot whose list ran out. The reference
        enters a wave only while the job has not stopped or broken
        (``_wave_cond``); the host knows both, as it reads back once a
        wave ``fast_ok`` and whether the batched commit's last slot
        stopped, and runs only the branch taken. The in-order walk reads
        back after each slot whether the wave ended there (a stop, a break
        or a truncation: the slots after it would change nothing), and
        ends it there. Returns the pop's accumulators."""
        n_alloc, n_pipe, n_adv = zeros(i32), zeros(i32), zeros(i32)
        placed_sum = torch.zeros(R, dtype=f32, device=dev)
        stopped, broke = zeros(torch.bool), zeros(torch.bool)
        # the pop's slots padded by a window of empty ones, so a wave's
        # window is a slice
        tid_pad = torch.cat([task_ids, no_task])
        tcl_pad = tid_pad.clamp_min(0).long()
        req_pad = treq.index_select(0, tcl_pad)              # [M+W, R(+1)]
        int_pad = torch.cat([tint.index_select(0, tcl_pad),
                             istgt.expand(M + W, 1)], 1)      # [M+W, 7]
        gq_pad = tasks.gpu_request.index_select(0, tcl_pad)
        nbe_pad = not_be[tcl_pad]
        suf_pad = torch.cat([suffix_after, no_suffix])

        def rows_at(rows, task):
            """The state and node maps at ``rows`` for the wave's slots
            ``task`` (columns of the task table)."""
            return sw.gather_rows(maps, rows, task[1].long(),
                                  task[2].long().clamp_min(0), idle, pipe,
                                  pods, gpux)

        pos, halted = lo, False
        while pos < hi and not halted:
            win = slice(pos, pos + W)
            t_w, t_cl = tid_pad[win], tcl_pad[win]
            req_w = req_pad[win].T.contiguous()              # [R(+1), W]
            task_w = int_pad[win].T.contiguous()             # [7, W]
            rr_w, gq_w = req_w[:R], gq_pad[win]
            gq_c = gq_w if gpu_pick else None       # the rescore's GPU check
            suf_w = suf_pad[win]
            args = [req_w, task_w] + shard_env + [idle, pipe, pods]
            if cfg.enable_gpu:
                args.append(gpux)
            # the shards' lists combined: by the kernel's last blocks on
            # the card, by sw.combine on the plain route
            with _step("wave_sweep"):
                cands = place_wave(cfg, D, C, args)
            e_i, e_v, e_o, cnt = cands[4:8]
            sw.waves += 1

            # ---- the optimistic batched commit (:2131-2215): every
            # slot takes its predicted pick, either its own entry 0 (all
            # distinct) or, on a list the slots share, entry w; the picks
            # are distinct, so one rescore of every pick at the state
            # after the whole wave is each slot's rescore of the walk
            with _step("wave_fast_ok"):
                ein, evn, eon = e_i[0], e_v[0], e_o[0]
                d0 = ein[:, 0]
                use0 = eon[:, 0].all() & ~((d0[:, None] == d0[None, :])
                                           & ~eye_w).any()
                if W <= C:
                    shared = ((ein[:, :W] == ein[0:1, :W]).all()
                              & eon[iw, iw].all())
                    struct_ok = use0 | shared
                    pk = torch.where(use0, d0, ein[iw, iw])
                    ev_p = torch.where(use0, evn[:, 0], evn[iw, iw])
                else:
                    # the shared-list shape needs W entries a slot; the
                    # lists keep C < W of them
                    struct_ok, pk, ev_p = use0, d0, evn[:, 0]
                pk_l = pk.long().clamp_max(N - 1)
                post = rows_at(pk_l[None, :], task_w)
                post = post._replace(idle=post.idle + (-rr_w)[:, None, :],
                                     pods=post.pods + 1.0)
                if gpu_pick:
                    col = gidle0_t[:, pk_l] - gpux[:, pk_l]      # [G, W]
                    fits = col >= gq_w - _EPS_FIT
                    card0 = torch.where(fits.any(0) & (gq_w > 0),
                                        fits.to(torch.uint8).argmax(0), -1)
                    charge0 = card0 >= 0
                    hit = (g_iota == card0) & charge0
                    post = post._replace(gpux=torch.where(
                        hit[:, None, :], post.gpux + gq_w, post.gpux))
                ok2, _, s2 = sw.rescore(cfg, post, pk_l[None, :], rr_w,
                                        task_w, gq_c)
                act_all = ((t_w >= 0) & nbe_pad[win]).all()
                lower = pk[None, :] < pk[:, None]
                beat = ok2 & ((s2 > ev_p[:, None])
                              | ((s2 == ev_p[:, None]) & lower))
                nobeat = ~(beat & ltri).any()
                if cfg.enable_gang:
                    ready_seq = (ready0 + n_alloc + 1 + iw) >= min_avail
                else:
                    ready_seq = torch.ones(W, dtype=torch.bool, device=dev)
                stop_seq = ready_seq & (suf_w > 0) & ~can_batch
                fast_ok = (struct_ok & act_all & nobeat
                           & ~stop_seq[:-1].any())
                fast, stop_last = torch.stack([fast_ok,
                                               stop_seq[-1]]).tolist()
            if fast:
                with _step("wave_commit_fast"):
                    # _commit_fast (:2223-2266): one add a pick row
                    sw.fast_waves += 1
                    idle.index_add_(1, pk_l, -rr_w)
                    pods.index_add_(1, pk_l, torch.ones_like(rr_w[:1]))
                    if gpu_pick:
                        gpux.view(-1).index_add_(
                            0, card0.clamp_min(0) * N + pk_l,
                            torch.where(charge0, gq_w, 0.0))
                        task_gpu[torch.where(charge0, t_cl, T)] = (
                            card0.to(i32))
                    task_node[t_cl] = pk.to(i32)
                    task_mode.index_fill_(0, t_cl, MODE_ALLOCATED)
                    n_alloc += W
                    for w in range(W):          # f32 fold in slot order
                        placed_sum = placed_sum + rr_w[:, w]
                    n_adv += W
                    stopped |= stop_seq[-1]
                    pos += W
                    halted = bool(stop_last)
                continue

            # ---- _commit_slow (:2268-2406): the slots in order, each
            # resolved from its list and the rescored touched rows; a slot
            # whose list ran out truncates the wave and replays at the
            # head of the next (slots past the open range, and those after
            # the wave's end, change nothing)
            with _step("wave_commit_slow"):
                touched = sentinel.clone()
                tcount = zeros(torch.int64)
                adv = W
                for w in range(min(W, hi - pos)):
                    t1 = t_cl[w:w + 1]
                    can_run = (t_w[w:w + 1] >= 0) & ~(stopped | broke)
                    active = can_run & nbe_pad[pos + w]
                    tch = touched[:W]
                    rows = tch.long().clamp_max(N - 1)[None, :]
                    task1 = task_w[:, w:w + 1]
                    ok_n, ok_f, s_t = sw.rescore(
                        cfg, rows_at(rows, task1), rows, rr_w[:, w:w + 1],
                        task1, gq_c[w:w + 1] if gpu_pick else None)
                    wins, fnd, dec = sw.resolve(
                        e_i[:, w], e_v[:, w], e_o[:, w], cnt[:, w], tch,
                        torch.cat([ok_n, ok_f]), s_t[0], C, N)
                    do_alloc = active & dec[0] & fnd[0]
                    if cfg.enable_pipelining:
                        do_pipe = active & dec[0] & ~fnd[0] & dec[1] & fnd[1]
                        conflict = active & (~dec[0]
                                             | (dec[0] & ~fnd[0] & ~dec[1]))
                    else:
                        do_pipe = zeros(torch.bool)
                        conflict = active & ~dec[0]
                    node = torch.where(do_alloc, wins[0],
                                       torch.where(do_pipe, wins[1], 0)).long()
                    rr = rr_w[:, w]
                    placed = commit(do_alloc, do_pipe, node, rr, gq_w[w], t1)
                    n_alloc += do_alloc
                    n_pipe += do_pipe
                    placed_sum = placed_sum + placed.to(f32) * rr
                    # a truncated slot advances nothing
                    n_adv += can_run & ~conflict
                    if cfg.enable_gang:
                        ready_aft = (ready0 + n_alloc) >= min_avail
                    else:
                        ready_aft = torch.ones_like(placed)
                    stopped |= (placed & ready_aft & (suf_w[w] > 0)
                                & ~can_batch)
                    broke |= active & ~conflict & ~placed
                    touched[torch.where(placed, tcount, W)] = node.to(i32)
                    tcount += placed
                    cut, halted = torch.stack([
                        conflict[0], (stopped | broke)[0]]).tolist()
                    if cut:
                        sw.truncations += 1
                        adv = w
                        break
                    if halted:
                        break
                pos += adv
        return n_alloc, n_pipe, n_adv, placed_sum, stopped, broke

    progressed = torch.ones((), dtype=torch.bool, device=dev)
    rounds = 0
    while True:
        # ---- the pop: lexicographic argmin of the live ordering keys
        elig = eligible()
        keys, _ = order_keys()
        ji, _ = lex_argmin(keys, elig)
        jl = ji.long().view(1)
        task_ids = jobs.task_table.index_select(0, jl)[0]            # [M]
        cur = job_cursor.index_select(0, jl)
        open_slot = (task_ids >= 0) & (slots >= cur)
        # the pop's one readback: whether any job is eligible, whether the
        # last pop progressed, and the open slots' range; a slot outside
        # it cannot run, and its step would change no bit of the state
        go, prog, lo, hi = torch.stack([
            elig.any().to(i32), progressed.to(i32), cur[0],
            torch.where(open_slot, slots + 1, 0).max()]).tolist()
        if not go or rounds >= max_rounds:
            break
        give_up = None
        if not prog:
            # jobs whose cheapest request exceeds every node's idle and
            # future idle (scan association): batch-finish them
            fut = (((idle + rel_t) - pip_t) - pipe).clamp_min(0.0)
            bound = torch.where(node_live[None, :], torch.maximum(idle, fut),
                                neg_inf).max(dim=1).values          # [R]
            give_up = elig & (jobs_min_req > bound + _EPS_FIT).any(-1)

        tcl = task_ids.clamp_min(0).long()
        min_avail = jobs.min_available.index_select(0, jl)           # [1]
        ready0 = (jobs.ready_num.index_select(0, jl)
                  + job_alloc_count.index_select(0, jl))
        qi = job_q.index_select(0, jl)
        if keys_static:
            # any finite deserved (including 0) disqualifies re-pop fusion
            can_batch = ~des_finite.index_select(0, qi).any(1)
        else:
            can_batch = zeros(torch.bool)
        nbe = not_be[tcl]
        nb_row = (open_slot & nbe).to(i32)
        # real tasks remaining strictly after slot m (allocate.go:262)
        suffix_after = nb_row.flip(0).cumsum(0, dtype=i32).flip(0) - nb_row
        istgt = (ji == target_job).to(i32).view(1, 1)
        saved = [idle.clone(), pipe.clone(), pods.clone(),
                 gpux.clone() if gpu_pick else None]

        n_alloc, n_pipe, n_adv = zeros(i32), zeros(i32), zeros(i32)
        placed_sum = torch.zeros(R, dtype=f32, device=dev)
        stopped, broke = zeros(torch.bool), zeros(torch.bool)
        if W > 1:
            n_alloc, n_pipe, n_adv, placed_sum, stopped, broke = wave_walk(
                task_ids, lo, hi, nbe, suffix_after, istgt, ready0,
                min_avail, can_batch)
        else:
            req_p = treq.index_select(0, tcl)                   # [M, R(+1)]
            int_p = tint.index_select(0, tcl)                   # [M, 6]
            greq_p = tasks.gpu_request.index_select(0, tcl)     # [M]
            for m in range(lo, hi):
                # ---- task_step (allocate_scan.py:1841-2080, the shard side)
                can_run = open_slot[m] & ~(stopped | broke)
                active = can_run & nbe[m]
                args = [req_p[m:m + 1], int_p[m:m + 1], istgt] + shard_env
                args += [idle, pipe, pods] + ([gpux] if cfg.enable_gpu else [])
                # the shards' winners combined: by the kernel's last block
                # on the card, by sp.combine on the plain route
                cand = place_shard(cfg, D, args)
                idx, found = cand.best_idx, cand.best_found
                can_now = found[0:1] & active
                can_fut = found[1:2] & active & bool(cfg.enable_pipelining)
                do_alloc = can_now
                do_pipe = ~can_now & can_fut
                node = torch.where(do_alloc, idx[0:1], idx[1:2]).long()  # [1]
                rr = req_p[m, :R]
                placed = commit(do_alloc, do_pipe, node, rr, greq_p[m],
                                tcl[m:m + 1])
                n_alloc += do_alloc
                n_pipe += do_pipe
                placed_sum = placed_sum + placed.to(f32) * rr
                n_adv += can_run
                # yield: a ready job with tasks still queued re-enters the job
                # queue after each placement (allocate.go:262-265); break: a
                # task no node can take fails the job (allocate.go:210-214)
                if cfg.enable_gang:
                    ready_aft = (ready0 + n_alloc) >= min_avail
                    stopped |= (active & placed & ready_aft
                                & (suffix_after[m] > 0) & ~can_batch)
                else:
                    stopped |= (active & placed & (suffix_after[m] > 0)
                                & ~can_batch)
                broke |= active & ~placed

        # ---- gang finalize: JobReady / JobPipelined / Discard
        # (allocate_scan.py:2440-2537)
        if cfg.enable_gang:
            ready = (ready0 + n_alloc) >= min_avail
        else:
            ready = torch.ones(1, dtype=torch.bool, device=dev)
        pipelined = (ready0 + n_alloc + n_pipe) >= min_avail
        keep = ready | pipelined
        # a discard copies the state at the pop's start back
        # (statement.go:352-374)
        idle = torch.where(keep, idle, saved[0])
        pipe = torch.where(keep, pipe, saved[1])
        pods = torch.where(keep, pods, saved[2])
        if gpu_pick:
            gpux = torch.where(keep, gpux, saved[3])
        job_tasks = tasks.job == ji
        clear = job_tasks & ~keep
        task_node[:T].masked_fill_(clear, -1)
        task_mode[:T].masked_fill_(clear, MODE_NONE)
        task_gpu[:T].masked_fill_(clear, -1)
        # a kept-but-unready gang holds capacity without binding: demote
        # its Allocated placements (session.go:317-330)
        demote = job_tasks & (keep & ~ready) & (task_mode[:T] == MODE_ALLOCATED)
        task_mode[:T].masked_fill_(demote, MODE_PIPELINED)
        # queue + drf accounting of the kept placements (proportion.go
        # :281-325, drf.go:511-536)
        committed = keep.to(f32) * placed_sum                         # [R]
        queue_allocated.index_add_(0, qi, committed[None, :])
        if give_up is not None:
            job_done[:J] |= give_up
            job_popped[:J] |= give_up
        job_done[jl] = ~stopped
        job_popped[jl] = torch.ones_like(stopped)
        st["job_ready"][jl] = ready
        st["job_pipelined"][jl] = pipelined & ~ready
        job_cursor.index_add_(0, jl, n_adv)
        job_alloc_count.index_add_(0, jl, torch.where(keep, n_alloc, 0))
        st["job_alloc_dyn"].index_add_(0, jl, committed[None, :])
        rounds += 1
        sp.pops += 1
        progressed = ((n_alloc > 0) | pipelined | ready).reshape(())
    return idle


def make_allocate_cycle(cfg: AllocateConfig, placer=None, dyn_placer=None,
                        mesh=None, shard_placer=None, wave_placer=None):
    """Build the allocate pass for a static config.

    Returned signature: ``allocate(snap, extras) -> AllocateResult`` with
    ``snap``/``extras`` dataclass trees of tensors on one device
    (``arrays.schema.to_device``). ``placer`` replaces the static-key round
    placer (``round_placer.round_place``), ``dyn_placer`` the dynamic-key
    one (``dyn_placer.dyn_place``), ``shard_placer`` the shard-local
    candidate search (``shard_placer.shard_candidates``) and
    ``wave_placer`` the wide one (``shard_wave.shard_wave``), each with the
    same signature and outputs (a ``shard_placer`` returns the shards'
    combined triple too: ``shard_placer.shard_candidates_plain_combined``
    is its plain version; a ``wave_placer`` the shards' lists combined:
    ``shard_wave.shard_wave_plain_combined``); callers use them to run the
    plain versions on the card or to watch the launches.

    ``mesh`` (``parallel.sharding.NodeMesh``): the node axis split into
    ``mesh.size`` shards. The cycle then takes the reference's sharded scan
    path (allocate_scan.py:596-607, :1841-2080, :2440-2537): one pop at a
    time with the ordering keys recomputed every pop, and for each of the
    popped job's slots one attempt whose feasibility -> score -> argmax runs
    shard-local in the candidate kernel (one launch covers every shard of
    the device, and its last block combines the shards' winners as the
    reference combines them), and the commit, the gang finalize and the queue and drf
    accounting in tensor code. With ``wave_width`` W > 1 the slots of a pop
    go in waves of W instead, each wave one launch of the wide candidate
    kernel, whose last blocks also combine the shards' lists (the
    reference's wavefront section walk, :2096-2437), with the same
    decisions. The batching fields are ignored there, as the
    reference ignores them off its fused placers.

    Without a mesh the fused placers take whole job sections and ignore
    ``wave_width``, as the reference's do (allocate_scan.py:623-627). A
    dynamic-key snapshot that the dynamic-key kernel does not take (J past
    its job limit, or more ordering keys than it keys on) runs the mesh
    path on one shard instead (:func:`cycle_path` ``"dyn_mesh"``), unless
    ``dyn_placer`` is given: the choice is made from shapes before the
    cycle, never from a launch's error, and runs no plain version.
    """
    if mesh is not None:
        cfg = normalize_wave(cfg)
    _check_supported(cfg, mesh)
    place = placer or round_placer.round_place
    place_dyn = dyn_placer or dp.dyn_place
    place_shard = shard_placer or sp.shard_candidates
    place_wave = wave_placer or sw.shard_wave
    K = max(1, int(cfg.batch_jobs))
    KP = max(0, int(cfg.batch_rounds))
    dyn = KP > 0 and mesh is None
    keys_static = not (cfg.drf_job_order or cfg.drf_ns_order
                       or cfg.enable_hdrf)
    f32, i32 = torch.float32, torch.int32

    def allocate(snap: SnapshotArrays,
                 extras: AllocateExtras) -> AllocateResult:
        nodes, tasks, jobs, queues = snap.nodes, snap.tasks, snap.jobs, snap.queues
        dev = nodes.idle.device
        N, R = nodes.idle.shape
        T = tasks.resreq.shape[0]
        J, M = jobs.task_table.shape
        Q = queues.allocated.shape[0]
        queue_deserved = extras.queue_deserved
        target_job = int(extras.target_job)

        # ---- static per-cycle node maps, node axis last ----------------
        tmpl_static = P.template_masks(nodes, tasks, snap.template_rep)
        if cfg.taint_prefer_weight:
            w_tp = float(np.float32(cfg.taint_prefer_weight))
            tp_static = torch.stack([
                w_tp * S.taint_prefer_score(
                    tasks.tol_hash[ti], tasks.tol_effect[ti],
                    tasks.tol_mode[ti], nodes)
                for ti in snap.template_rep.clamp_min(0).tolist()])
        else:
            tp_static = torch.zeros(tmpl_static.shape, dtype=f32, device=dev)
        node_env = [
            tmpl_static.to(f32),
            tp_static.contiguous(),
            extras.template_na_score.to(f32).contiguous(),
            extras.block_nonrevocable.to(f32)[None, :],
            extras.block_all.to(f32)[None, :],
            extras.tdm_bonus.to(f32)[None, :].contiguous(),
            extras.node_locked.to(f32)[None, :],
            extras.or_feasible.to(f32),
            (nodes.releasing - nodes.pipelined).T.contiguous(),
            nodes.allocatable.T.contiguous(),
            nodes.pod_count.to(f32)[None, :],
            nodes.max_pods.to(f32)[None, :],
        ]
        if cfg.enable_gpu:
            node_env.append((nodes.gpu_memory - nodes.gpu_used).T.contiguous())
        relmp_t = node_env[8]
        node_live = nodes.valid & nodes.schedulable
        # pod affinity: the static maps in the placers' layout, the
        # task-side term tables gathered per launch ([.., T], task axis
        # last), and the live counts (all empty when off)
        aff_static, aff_tables, aff_state = [], [], []
        if cfg.enable_pod_affinity:
            afa = extras.affinity
            aff_static = [node_live.to(f32)[None, :],
                          afa.sk_domain.contiguous(),
                          afa.sk_sel[:, None].contiguous(),
                          afa.eta_sk[None, :].contiguous(),
                          afa.eta_domain.contiguous(),
                          afa.static_pref.contiguous()]
            aff_tables = [t.contiguous() for t in (
                afa.task_aff_sk.T, afa.task_anti_term.T, afa.task_pref_sk.T,
                afa.task_pref_w.T,
                afa.task_match[afa.sk_sel.clamp_min(0).long()].to(f32),
                ((afa.eta_sel >= 0)[:, None]
                 & afa.task_match[afa.eta_sel.clamp_min(0).long()]).to(f32),
                afa.task_match.to(f32))]
            aff_state = [afa.cnt0[:, :N].contiguous(),
                         afa.cnt0[:, N:].contiguous(),
                         afa.anti_cnt0.contiguous()]

        # cheapest pending request per job, per dim: the give-up bound
        tbl = jobs.task_table.clamp_min(0).long()
        slot_ok = (jobs.task_table >= 0)[:, :, None]
        jobs_min_req = torch.where(slot_ok, tasks.resreq[tbl],
                                   torch.full((), float("inf"), device=dev)
                                   ).min(dim=1).values              # [J, R]

        # ---- loop state; scatters with no target land in a sentinel row
        # (T, J or Q) that is sliced off at the end, like JAX's mode="drop"
        # a copy, never a view: the mesh path adds into it in place, and
        # the resident buffers of the delta path hold nodes.idle
        idle = nodes.idle.T.clone(memory_format=torch.contiguous_format)
        pipe = torch.zeros((R, N), dtype=f32, device=dev)
        pods = torch.zeros((1, N), dtype=f32, device=dev)
        gpux = torch.zeros((nodes.gpu_memory.shape[1], N), dtype=f32,
                           device=dev)
        task_node = torch.full((T + 1,), -1, dtype=i32, device=dev)
        task_mode = torch.zeros(T + 1, dtype=i32, device=dev)
        task_gpu = torch.full((T + 1,), -1, dtype=i32, device=dev)
        job_done = torch.zeros(J + 1, dtype=torch.bool, device=dev)
        job_popped = torch.zeros(J + 1, dtype=torch.bool, device=dev)
        job_ready = torch.zeros(J + 1, dtype=torch.bool, device=dev)
        job_pipelined = torch.zeros(J + 1, dtype=torch.bool, device=dev)
        job_cursor = torch.zeros(J + 1, dtype=i32, device=dev)
        job_alloc_count = torch.zeros(J + 1, dtype=i32, device=dev)
        job_alloc_dyn = torch.cat([jobs.allocated,
                                   jobs.allocated.new_zeros((1, R))])
        queue_allocated = torch.cat([queues.allocated,
                                     queues.allocated.new_zeros((1, R))])
        progressed = torch.ones((), dtype=torch.bool, device=dev)

        max_rounds = J + T if cfg.max_rounds is None else cfg.max_rounds
        slots = torch.arange(M, dtype=i32, device=dev)
        jidx = torch.arange(J, dtype=i32, device=dev)
        des_finite = torch.isfinite(queue_deserved)
        job_q = jobs.queue.long()
        job_ns = jobs.namespace.long()
        neg_prio = -jobs.priority.to(f32)
        total_cap = snap.cluster_capacity

        def eligible():
            # overused queues are skipped (proportion.Overused,
            # proportion.go:240-253)
            overused = (queue_allocated[:Q] > queue_deserved + _EPS_CMP).any(-1)
            return (jobs.valid & jobs.schedulable & ~job_done[:J]
                    & (job_cursor[:J] < jobs.n_pending) & ~overused[job_q])

        def order_keys():
            """The pop's ordering keys, most significant first (the nested
            namespace -> queue -> job priority queues), with the drf shares
            and hdrf columns recomputed from the live allocations, as the
            plugins' event handlers would (drf.go:511-536); and the hdrf
            columns per queue (None without hdrf)."""
            # queue share: max over dims of allocated / deserved
            # (proportion queueOrderFn, proportion.go:198-212)
            qshare = torch.where(
                des_finite & (queue_deserved > 0),
                queue_allocated[:Q] / queue_deserved.clamp_min(_EPS_DIV),
                torch.zeros_like(queue_deserved)).max(-1).values \
                + extras.queue_share_extra
            live = job_alloc_dyn[:J]
            ns_share = (namespace_shares(live, jobs.namespace, jobs.valid,
                                         snap.namespace_weight, total_cap)
                        if cfg.drf_ns_order else extras.ns_share)
            job_share = (drf_job_shares(live, total_cap, jobs.valid)
                         if cfg.drf_job_order else extras.job_share)
            keys = [ns_share[job_ns], jobs.namespace.to(f32), qshare[job_q]]
            hcols = None
            if cfg.enable_hdrf:
                # hdrf compareQueues walk as lexicographic level columns
                # (drf.go:182-218)
                hcols = hdrf_level_keys(extras.hierarchy, live,
                                        jobs.total_request, jobs.valid,
                                        total_cap)
                keys += [hcols[:, c][job_q] for c in range(hcols.shape[1])]
            keys += [jobs.queue.to(f32), neg_prio]
            if cfg.tdm_job_order:
                keys.append(jobs.preemptable.to(f32))
            if cfg.sla_job_order:
                keys.append(extras.job_deadline)
            ready_dyn = jobs.ready_num + job_alloc_count[:J]
            ready_now = (ready_dyn >= jobs.min_available) \
                & (jobs.min_available > 0)
            keys += [ready_now.to(f32), job_share, jobs.creation_rank.to(f32)]
            return keys, hcols

        D = mesh.size if mesh is not None else 0
        if (D == 0 and dyn and dyn_placer is None
                and dyn_refusal(cfg, snap, extras) is not None):
            # the one-shard mesh path, with the mesh path's supported set
            from ..parallel.sharding import NodeMesh
            _check_supported(cfg, NodeMesh((dev,)))
            D = 1
        if D:
            idle = _sharded_pops(
                normalize_wave(cfg), D, place_shard, place_wave, snap, extras,
                node_env,
                eligible, order_keys, jobs_min_req, dict(
                    idle=idle, pipe=pipe, pods=pods, gpux=gpux,
                    task_node=task_node, task_mode=task_mode,
                    task_gpu=task_gpu, job_done=job_done,
                    job_popped=job_popped, job_ready=job_ready,
                    job_pipelined=job_pipelined, job_cursor=job_cursor,
                    job_alloc_count=job_alloc_count,
                    job_alloc_dyn=job_alloc_dyn,
                    queue_allocated=queue_allocated), max_rounds)
            return AllocateResult(
                task_node=task_node[:T], task_mode=task_mode[:T],
                task_gpu=task_gpu[:T], job_ready=job_ready[:J],
                job_pipelined=job_pipelined[:J],
                job_attempted=job_popped[:J], idle=idle.T,
                queue_allocated=queue_allocated[:Q])

        if dyn:
            dyn_static = _dyn_static_args(cfg, snap, extras, keys_static)

        rounds = 0
        launched = False
        last_pops = torch.zeros((), dtype=i32, device=dev)
        while True:
            elig = eligible()
            go, prog, pops = torch.stack([
                elig.any().to(i32), progressed.to(i32), last_pops]).tolist()
            if launched:
                # a dyn launch counts as its pops, at least one: pop 0 is
                # forced, so every launch moves the bound
                rounds += max(pops, 1)
                dp.pops += pops
                dp.early_stops += pops < kp_req
                launched = False
            if not go or rounds >= max_rounds:
                break
            if prog:
                give_up = torch.zeros(J, dtype=torch.bool, device=dev)
            else:
                # jobs whose cheapest request exceeds every node's idle and
                # future idle: batch-finish them (capacity never grows back)
                fut_t = (idle + relmp_t - pipe).clamp_min(0.0)
                bound = torch.where(node_live[None, :],
                                    torch.maximum(idle, fut_t),
                                    torch.full((), float("-inf"), device=dev)
                                    ).max(dim=1).values             # [R]
                give_up = elig & (jobs_min_req > bound + _EPS_FIT).any(-1)

            # ---- job selection: lexicographic pop of ns->queue->job PQs
            keys, hcols = order_keys()
            jis = []
            elig_k = elig
            for _ in range(K):
                ji_k, found_k = lex_argmin(keys, elig_k)
                ji_k = torch.where(found_k, ji_k, -1)
                jis.append(ji_k)
                elig_k = elig_k & (jidx != ji_k)
            ji_vec = torch.stack(jis).to(i32)                        # [K]
            jsafe = ji_vec.clamp_min(0).long()
            task_ids = jobs.task_table[jsafe]                        # [K, M]
            tcl = task_ids.clamp_min(0).long()
            flat_ids = tcl.reshape(K * M)

            def slot_args(suffix_after):
                """The placers' leading per-slot rows."""
                rows = [tasks.resreq[flat_ids].T.contiguous()]
                if cfg.enable_gpu:
                    rows.append(tasks.gpu_request[flat_ids][None, :])
                return rows + [
                    extras.task_pref_node[flat_ids][None, :],
                    suffix_after.reshape(1, K * M),
                    tasks.template[flat_ids].clamp_min(0)[None, :],
                    extras.task_or_group[flat_ids][None, :],
                    extras.task_volume_node[flat_ids][None, :],
                    extras.task_volume_ok[flat_ids].to(i32)[None, :],
                    extras.task_revocable[flat_ids].to(i32)[None, :]]

            if dyn:
                # ---- dynamic-key path: up to KP pops in one launch over
                # the K candidates, keys recomputed after every commit; the
                # launch stops when the true next pop is not a candidate
                cslot = torch.full((J + 1,), -1, dtype=i32, device=dev)
                cslot[torch.where(ji_vec >= 0, jsafe, J)] = torch.arange(
                    K, dtype=i32, device=dev)
                tid_ok = task_ids >= 0
                nbe = ~tasks.best_effort[tcl]
                # cursor-independent suffix: real non-best-effort slots
                # strictly after m
                nbreal = (tid_ok & nbe).to(i32)
                args = slot_args(nbreal.flip(1).cumsum(1, dtype=i32).flip(1)
                                 - nbreal) + [
                    tid_ok.to(i32).reshape(1, K * M),
                    nbe.to(i32).reshape(1, K * M),
                    ji_vec[None, :], cslot[None, :J]]
                args += dyn_static["head"]
                if cfg.enable_hdrf:
                    # frozen per-launch hdrf columns (guarded in the placer)
                    args.append(hcols.T[:, job_q].contiguous())
                kp_req = min(KP, max_rounds - rounds)
                args += dyn_static["jobs"] + [
                    torch.full((1, 1), kp_req, dtype=i32, device=dev),
                    dyn_static["tgt"]]
                args += node_env + aff_static + gather_slot_tables(
                    aff_tables, flat_ids)
                args += [idle, pipe, pods]
                if cfg.enable_gpu:
                    args.append(gpux)
                args += aff_state
                args += [
                    (job_done[:J] | give_up).to(i32)[None, :],
                    (job_popped[:J] | give_up).to(i32)[None, :],
                    job_ready[:J].to(i32)[None, :],
                    job_pipelined[:J].to(i32)[None, :],
                    job_cursor[None, :J].contiguous(),
                    job_alloc_count[None, :J].contiguous(),
                    job_alloc_dyn[:J].T.contiguous(),
                    queue_allocated[:Q].contiguous()]
                outs = list(place_dyn(cfg, K, KP, M, args))
                node_s, mode_s, gpu_s = outs[0][0], outs[1][0], outs[2][0]
                idle, pipe, pods = outs[3:6]
                if cfg.enable_gpu:
                    gpux = outs[6]
                if cfg.enable_pod_affinity:
                    aff_state = list(outs[-13:-10])
                (done_o, popped_o, ready_o, pipe_o, cursor_o, acount_o,
                 jalloc_o, qalloc_o, pops_o, prog_o) = outs[-10:]
                placed_m = mode_s.reshape(K, M) != MODE_NONE
                wflat = torch.where(tid_ok & placed_m, task_ids,
                                    T).reshape(K * M).long()
                task_node[wflat] = node_s
                task_mode[wflat] = mode_s
                task_gpu[wflat] = gpu_s
                job_done[:J] = done_o[0] > 0
                job_popped[:J] = popped_o[0] > 0
                job_ready[:J] = ready_o[0] > 0
                job_pipelined[:J] = pipe_o[0] > 0
                job_cursor[:J] = cursor_o[0]
                job_alloc_count[:J] = acount_o[0]
                job_alloc_dyn[:J] = jalloc_o.T
                queue_allocated[:Q] = qalloc_o
                last_pops = pops_o[0, 0]
                launched = True
                progressed = prog_o[0, 0] > 0
                continue

            # ---- K batched pops, one placer launch ----------------------
            secact = ji_vec >= 0
            curs = job_cursor[jsafe]
            open_slot = (task_ids >= 0) & (slots[None, :] >= curs[:, None])
            nb = open_slot & ~tasks.best_effort[tcl]
            nb_i = nb.to(i32)
            rc = nb_i.flip(1).cumsum(1, dtype=i32).flip(1)
            suffix_after = rc - nb_i
            ready0_vec = jobs.ready_num[jsafe] + job_alloc_count[jsafe]
            minav_vec = jobs.min_available[jsafe]
            # any finite deserved (including 0) disqualifies re-pop fusion:
            # a commit can flip the queue overused; so do dynamic keys
            canb_vec = ~des_finite[job_q[jsafe]].any(1) & keys_static
            if K > 1:
                # section k runs only if every earlier section's commits are
                # provably inert to ordering and eligibility
                prefix_ok = torch.cat([
                    torch.ones(1, dtype=torch.bool, device=dev),
                    canb_vec[:-1].to(i32).cumprod(0).to(torch.bool)])
                secact = secact & prefix_ok
            istgt = ji_vec == target_job

            args = slot_args(suffix_after) + [
                nb_i.reshape(1, K * M),
                ready0_vec[None, :], minav_vec[None, :],
                canb_vec.to(i32)[None, :],
                secact.to(i32)[None, :],
                istgt.to(i32)[None, :],
            ]
            args += node_env + aff_static + gather_slot_tables(
                aff_tables, flat_ids)
            args += [idle, pipe, pods]
            if cfg.enable_gpu:
                args.append(gpux)
            args += aff_state
            outs = place(cfg, K, M, args)
            node_s, mode_s, gpu_s, idle, pipe, pods = outs[:6]
            if cfg.enable_gpu:
                gpux = outs[6]
            if cfg.enable_pod_affinity:
                aff_state = list(outs[-3:])

            node_km = node_s.reshape(K, M)
            mode_km = mode_s.reshape(K, M)
            gpu_km = gpu_s.reshape(K, M)
            placed_m = mode_km != MODE_NONE
            is_alloc = mode_km == MODE_ALLOCATED
            n_alloc_vec = is_alloc.sum(1, dtype=i32)
            n_pipe_vec = (mode_km == MODE_PIPELINED).sum(1, dtype=i32)
            # gang flags from the placer's (discard-cleared) modes
            if cfg.enable_gang:
                ready_vec = (ready0_vec + n_alloc_vec) >= minav_vec
            else:
                ready_vec = torch.ones(K, dtype=torch.bool, device=dev)
            pipelined_vec = (((ready0_vec + n_alloc_vec + n_pipe_vec)
                              >= minav_vec) & ~ready_vec)
            keep_vec = ready_vec | pipelined_vec
            # kept-but-unready gangs hold capacity without binding:
            # demote Allocated -> Pipelined (session.go:317-330)
            demote = (keep_vec & ~ready_vec)[:, None] & is_alloc
            mode_out = torch.where(demote, MODE_PIPELINED, mode_km).to(i32)
            wflat = torch.where((task_ids >= 0) & placed_m, task_ids,
                                T).reshape(K * M).long()
            task_node[wflat] = node_km.reshape(K * M)
            task_mode[wflat] = mode_out.reshape(K * M)
            task_gpu[wflat] = gpu_km.reshape(K * M)

            # replay yield/break per section (allocate.go:205-278)
            alloc_cum = is_alloc.to(i32).cumsum(1, dtype=i32)
            if cfg.enable_gang:
                ready_aft = (ready0_vec[:, None] + alloc_cum) \
                    >= minav_vec[:, None]
            else:
                ready_aft = torch.ones((K, M), dtype=torch.bool, device=dev)
            stop_evt = (nb & placed_m & ready_aft & (suffix_after > 0)
                        & ~canb_vec[:, None])
            broke_evt = nb & ~placed_m
            first_stop = torch.where(stop_evt, slots[None, :], M).min(1).values
            first_broke = torch.where(broke_evt, slots[None, :],
                                      M).min(1).values
            stopped_vec = first_stop < first_broke
            broke_vec = ~stopped_vec & (first_broke < M)
            boundary = torch.where(stopped_vec | broke_vec,
                                   torch.minimum(first_stop, first_broke),
                                   M - 1)
            n_adv = (open_slot & (slots[None, :] <= boundary[:, None])
                     ).sum(1, dtype=i32)
            # committed request per section, summed over slots in order
            req = torch.where(placed_m[:, :, None], tasks.resreq[tcl],
                              torch.zeros((), dtype=f32, device=dev))
            committed = torch.zeros((K, R), dtype=f32, device=dev)
            for m in range(M):
                committed = committed + req[:, m]

            jdrop = torch.where(secact, jsafe, J)
            qdrop = torch.where(secact, job_q[jsafe], Q)
            job_done = job_done | torch.cat([give_up, give_up.new_zeros(1)])
            job_popped = job_popped | torch.cat([give_up,
                                                 give_up.new_zeros(1)])
            job_done[jdrop] = ~stopped_vec
            # a tensor value: a Python scalar would be copied from the host
            # and make the round wait for the stream
            job_popped[jdrop] = torch.ones_like(secact)
            job_ready[jdrop] = ready_vec
            job_pipelined[jdrop] = pipelined_vec
            # real rows of jdrop are distinct, so each gets exactly one add
            job_cursor.index_put_((jdrop,), n_adv, accumulate=True)
            job_alloc_count.index_put_(
                (jdrop,), torch.where(keep_vec, n_alloc_vec, 0).to(i32),
                accumulate=True)
            job_alloc_dyn.index_put_((jdrop,), committed, accumulate=True)
            # sections may share a queue: add in section order, as the
            # reference's scatter-add does (no reordering atomics)
            for k in range(K):
                queue_allocated.index_put_((qdrop[k:k + 1],),
                                           committed[k:k + 1], accumulate=True)
            rounds += 1
            progressed = (n_alloc_vec > 0).any() | pipelined_vec.any() \
                | ready_vec.any()

        return AllocateResult(
            task_node=task_node[:T], task_mode=task_mode[:T],
            task_gpu=task_gpu[:T], job_ready=job_ready[:J],
            job_pipelined=job_pipelined[:J], job_attempted=job_popped[:J],
            idle=idle.T, queue_allocated=queue_allocated[:Q])

    return allocate
