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
from .fairshare import drf_job_shares, hdrf_level_keys, namespace_shares
from .round_placer import MODE_ALLOCATED, MODE_NONE, MODE_PIPELINED
from .select import lex_argmin

__all__ = ["MODE_NONE", "MODE_ALLOCATED", "MODE_PIPELINED", "AllocateConfig",
           "AllocateExtras", "AllocateResult", "derive_batching",
           "make_allocate_cycle", "normalize_wave", "unpack_decisions"]

#: jobs per placer launch on the static-key path (see derive_batching)
DEFAULT_BATCH_JOBS = 8

#: in-kernel pops per launch on the dynamic-key path
DEFAULT_BATCH_ROUNDS = 32

_EPS_CMP = float(np.float32(1e-6))    # overused queue slack
_EPS_FIT = float(np.float32(1e-5))    # give-up bound slack
_EPS_DIV = float(np.float32(1e-9))


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
    wave_width: int = 1                  # wavefront placement (not ported yet)


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


def _check_supported(cfg: AllocateConfig) -> None:
    """Raise for the configurations this slice of the port does not carry,
    naming the ROADMAP item that ports each."""
    todo = [
        (cfg.enable_host_ports, "enable_host_ports",
         "ROADMAP queue 1 item 4b, host ports: the reference runs them on "
         "its scan path only, so they need a per-task path in the port"),
        (cfg.telemetry, "telemetry", "ROADMAP queue 1 item 7, telemetry "
         "and wavefront"),
        (cfg.wave_width > 1, "wave_width > 1", "ROADMAP queue 1 item 7, "
         "telemetry and wavefront"),
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


def make_allocate_cycle(cfg: AllocateConfig, placer=None, dyn_placer=None):
    """Build the allocate pass for a static config.

    Returned signature: ``allocate(snap, extras) -> AllocateResult`` with
    ``snap``/``extras`` dataclass trees of tensors on one device
    (``arrays.schema.to_device``). ``placer`` replaces the static-key round
    placer (``round_placer.round_place``) and ``dyn_placer`` the
    dynamic-key one (``dyn_placer.dyn_place``), each with the same
    signature; callers use them to run the plain versions on the card or
    to watch the launches.
    """
    _check_supported(cfg)
    place = placer or round_placer.round_place
    place_dyn = dyn_placer or dp.dyn_place
    K = max(1, int(cfg.batch_jobs))
    KP = max(0, int(cfg.batch_rounds))
    dyn = KP > 0
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
        idle = nodes.idle.T.contiguous()
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
            job_popped[jdrop] = True
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
