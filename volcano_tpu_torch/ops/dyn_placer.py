"""Dynamic-key round placer: up to KP job pops per launch over C candidate
jobs, with the ordering keys recomputed after every gang commit.

Port of ``volcano_tpu/ops/pallas_place.make_dyn_round_placer`` (the Pallas
``_dyn_kernel``), with its pod-affinity extension under
``cfg.enable_pod_affinity`` (the placement step and the affinity step of
``ops/round_placer.py``). It carries the
configurations whose job-ordering keys move with commits (drf job and
namespace shares, a finite proportion ``deserved``, hdrf): each pop

1. recomputes the proportion overused gate and queue share from the live
   queue allocations, the drf namespace and job shares from the live job
   allocations, and ``ready_now`` from the live allocation counts;
2. takes the lexicographic argmin over the eligible jobs (pop 0 is the
   launch's first candidate, chosen by the caller from the same state);
3. stops the launch when that job is not one of the C candidates, when the
   pop budget ``kmax`` is spent, when nothing is eligible, or, with hdrf,
   when the eligible jobs span more than one queue after a commit (the
   frozen hdrf columns are then no longer exact);
4. places the job's pending tasks from its cursor on (the placement step of
   ``ops/round_placer.py``, with its yield and break rules);
5. commits or discards the gang, demotes kept-but-unready placements to
   Pipelined (session.go:317-330) and adds the committed resources to the
   job's and its queue's allocation.

Two implementations share one signature and argument order (the order of
``_dyn_kernel``'s reader, pallas_place.py:684-747):

- :func:`dyn_place_cuda` launches the hand-written CUDA kernel
  (``csrc/dyn_placer.cu``), one thread-block cluster whose blocks each own
  a slice of the jobs and of the nodes, for tensors on a CUDA device;
- :func:`dyn_place_plain` is the plain PyTorch version of the same
  function, the port's counterpart of ``interpret=True``.

:func:`dyn_place` chooses by the device of the tensors it is given.

Arguments (``*`` only with ``cfg.enable_gpu``, ``^`` only with
``cfg.enable_hdrf``, ``#`` only with ``cfg.drf_ns_order``, ``@`` only with
``cfg.enable_pod_affinity``, as in ``ops/round_placer.py``)::

    resreq f32[R, CM], *gpu_req f32[1, CM], pref, suffix, tmpl, grp, voln,
    volok, rev, tidok, nbe i32[1, CM], cand i32[1, C], cslot i32[1, J],
    skeys f32[NKS, J], ^hcols f32[NH, J], qid i32[1, J], qoh f32[Q, J],
    #nsm, #nsc f32[S, J], #nsw f32[1, S], minav, rdy0, npend, eligs
    i32[1, J], validf f32[1, J], canb i32[1, J], des f32[Q, R], qex
    f32[Q, 1], total f32[R, 1], kmax, tgt i32[1, 1], tstat, tscore,
    nascore f32[P, N], blocknr, blockall, bonus, locked f32[1, N], orfeas
    f32[GR, N], relmp, alloc f32[R, N], cnt, maxp f32[1, N], *gidle0
    f32[G, N], @live ... @selm (the 13 affinity arguments, [.., CM] per
    slot), idle, pipe f32[R, N], pods f32[1, N], *gpux f32[G, N],
    @aff_cnt f32[SK, N], @aff_tot f32[SK, 1], @anti_cnt f32[ETA, N], done,
    popped, jready, jpipe, cursor, acount i32[1, J], jalloc f32[R, J],
    qalloc f32[Q, R]

Outputs, as the reference returns them: node, mode, gpu i32[1, CM], idle',
pipe' f32[R, N], pods' f32[1, N], (gpux' f32[G, N]), (aff_cnt', aff_tot',
anti_cnt'), done', popped', ready', pipelined', cursor', acount' i32[1, J],
jalloc' f32[R, J], qalloc' f32[Q, R], pops, progressed i32[1, 1].

Sums over jobs (the namespace allocation) fold in job order and sums over
slots (a pop's committed resources) in slot order, in both versions.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import round_placer as rp
from .fairshare import fold_last, fold_rows
from .round_placer import MODE_ALLOCATED, MODE_NONE, MODE_PIPELINED

_EPS_CMP = float(np.float32(1e-6))   # overused queue slack
_EPS_DIV = float(np.float32(1e-9))
_INF = float("inf")

#: key-plan codes for the dynamic columns; a code >= 0 is a row of skeys
KEY_NS, KEY_QSHARE, KEY_READY, KEY_JSHARE = -1, -2, -3, -4
#: hdrf column h has code KEY_HCOL - h
KEY_HCOL = -8
#: longest key list the kernel takes
MAX_KEYS = 32
#: blocks of the kernel's cluster (8 or 16; 16 needs the card's consent
#: to a cluster past the portable 8), chosen by the comparison of the two
#: in chip_smoke.py phase 11 and scripts/dyn_phase_split.py; the largest
#: cluster; threads a block (placement.cuh CBLOCK) and their warps
CLUSTER = 16
MAX_CB = 16
CBLOCK = 512
CWARPS = CBLOCK // 32
#: shared memory a block can use on an H100 (232,448 bytes), less the
#: 4,096 the kernel may keep in static shared memory (the source's
#: STATIC_SHARED: a static_assert holds its declarations to it, and its
#: launcher checks the built kernel against it)
MAX_SHARED = 232448 - 4096
#: rows of the kernel's dynamic key table, the (namespace, dim) pairs of
#: one tile of its namespace fold, and the most jobs a thread keeps in its
#: eligibility bitmask
N_DYN = 4
PAIR_TILE = 32
JOB_BITS = 32

#: launches of the CUDA kernel since the count was last set to 0, and those
#: of them that ran the pod-affinity step
launches = 0
aff_launches = 0
#: pops, and launches that stopped before their pop budget, of the
#: dynamic-key launches the allocate cycle has read back (either version)
pops = 0
early_stops = 0


class DynArgs(NamedTuple):
    resreq: torch.Tensor
    gpu_req: Optional[torch.Tensor]
    pref: torch.Tensor
    suffix: torch.Tensor
    tmpl: torch.Tensor
    grp: torch.Tensor
    voln: torch.Tensor
    volok: torch.Tensor
    rev: torch.Tensor
    tidok: torch.Tensor
    nbe: torch.Tensor
    cand: torch.Tensor
    cslot: torch.Tensor
    skeys: torch.Tensor
    hcols: Optional[torch.Tensor]
    qid: torch.Tensor
    qoh: torch.Tensor
    nsm: Optional[torch.Tensor]
    nsc: Optional[torch.Tensor]
    nsw: Optional[torch.Tensor]
    minav: torch.Tensor
    rdy0: torch.Tensor
    npend: torch.Tensor
    eligs: torch.Tensor
    validf: torch.Tensor
    canb: torch.Tensor
    des: torch.Tensor
    qex: torch.Tensor
    total: torch.Tensor
    kmax: torch.Tensor
    tgt: torch.Tensor
    tstat: torch.Tensor
    tscore: torch.Tensor
    nascore: torch.Tensor
    blocknr: torch.Tensor
    blockall: torch.Tensor
    bonus: torch.Tensor
    locked: torch.Tensor
    orfeas: torch.Tensor
    relmp: torch.Tensor
    alloc: torch.Tensor
    cnt: torch.Tensor
    maxp: torch.Tensor
    gidle0: Optional[torch.Tensor]
    live: Optional[torch.Tensor]
    skdom: Optional[torch.Tensor]
    sk_sel: Optional[torch.Tensor]
    eta_sk: Optional[torch.Tensor]
    eta_dom: Optional[torch.Tensor]
    static_pref: Optional[torch.Tensor]
    aff_sk: Optional[torch.Tensor]
    anti: Optional[torch.Tensor]
    prefsk: Optional[torch.Tensor]
    prefw: Optional[torch.Tensor]
    skm: Optional[torch.Tensor]
    etm: Optional[torch.Tensor]
    selm: Optional[torch.Tensor]
    idle: torch.Tensor
    pipe: torch.Tensor
    pods: torch.Tensor
    gpux: Optional[torch.Tensor]
    aff_cnt: Optional[torch.Tensor]
    aff_tot: Optional[torch.Tensor]
    anti_cnt: Optional[torch.Tensor]
    done: torch.Tensor
    popped: torch.Tensor
    jready: torch.Tensor
    jpipe: torch.Tensor
    cursor: torch.Tensor
    acount: torch.Tensor
    jalloc: torch.Tensor
    qalloc: torch.Tensor


_OPTIONAL = {**rp.OPTIONAL, "hcols": "enable_hdrf", "nsm": "drf_ns_order",
             "nsc": "drf_ns_order", "nsw": "drf_ns_order"}


def unpack_args(cfg, args) -> DynArgs:
    """Name the flat argument list (optional entries by the cfg flags)."""
    it = iter(args)
    vals = {f: (next(it) if f not in _OPTIONAL
                or getattr(cfg, _OPTIONAL[f]) else None)
            for f in DynArgs._fields}
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} arguments too many for the placer")
    return DynArgs(**vals)


def key_plan(cfg, NH: int):
    """(codes, static rows): the ordering key columns, most significant
    first, in the scan path's order (allocate_scan.py:1411-1438 there);
    static columns name their row of ``skeys``."""
    plan: List[int] = []
    si = 0

    def static():
        nonlocal si
        plan.append(si)
        si += 1

    if cfg.drf_ns_order:
        plan.append(KEY_NS)              # drf namespace share
    else:
        static()                         # ns_share[namespace]
    static()                             # namespace id
    plan.append(KEY_QSHARE)              # proportion queue share
    plan += [KEY_HCOL - h for h in range(NH)]
    static()                             # queue id
    static()                             # -priority
    if cfg.tdm_job_order:
        static()                         # preemptable
    if cfg.sla_job_order:
        static()                         # deadline
    plan.append(KEY_READY)               # gang: ready jobs last
    if cfg.drf_job_order:
        plan.append(KEY_JSHARE)          # drf job share
    else:
        static()                         # static job share
    static()                             # creation rank
    return plan, si


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def _shapes(a: DynArgs):
    R, N = a.idle.shape
    CM = a.resreq.shape[1]
    C = a.cand.shape[1]
    J = a.cslot.shape[1]
    Q = a.qoh.shape[0]
    S = a.nsm.shape[0] if a.nsm is not None else 0
    NH = a.hcols.shape[0] if a.hcols is not None else 0
    G = a.gidle0.shape[0] if a.gidle0 is not None else 0
    return R, N, CM, C, J, Q, S, NH, G


def dyn_place_plain(cfg, C: int, KP: int, M: int, args, stats=None):
    """Plain PyTorch version of the dynamic-key placer (see the module
    docstring). Runs on the device of its arguments. ``stats``, when a dict
    is given, gains ``attempts`` and ``pops`` (and with pod affinity
    ``aff_rows`` and ``aff_commit_rows``): the work the kernel's bound is
    computed from."""
    a = unpack_args(cfg, args)
    gpu = bool(cfg.enable_gpu)
    aff = bool(cfg.enable_pod_affinity)
    dev = a.idle.device
    R, N, CM, _, J, Q, S, NH, _ = _shapes(a)
    w = rp._weights(cfg)
    iota_n = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    iota_j = torch.arange(J, dtype=torch.int32, device=dev)
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    inf = torch.full((), _INF, dtype=f32, device=dev)
    plan, _ = key_plan(cfg, NH)

    sl = rp.SlotLists.of(a)
    suffix, tidok, nbe = torch.cat([a.suffix, a.tidok, a.nbe]).tolist()
    cand = a.cand[0].tolist()
    cslot, minav, rdy0, canb, qid = torch.cat(
        [a.cslot, a.minav, a.rdy0, a.canb, a.qid]).tolist()
    kmax, tgt = int(a.kmax.reshape(-1)[0]), int(a.tgt.reshape(-1)[0])

    # static per launch: eligibility inputs, queue one-hot, key rows
    eligs = a.eligs[0] > 0
    npend = a.npend[0]
    qid_f = a.qid[0].to(f32)
    des_ok = torch.isfinite(a.des) & (a.des > 0)
    des_div = a.des.clamp_min(_EPS_DIV)
    valid_job = a.validf[0] > 0
    total = a.total[:, 0]

    state = [a.idle.clone(), a.pipe.clone(), a.pods.clone(),
             a.gpux.clone() if gpu else None]
    state += [a.aff_cnt.clone(), a.aff_tot.clone(), a.anti_cnt.clone()] \
        if aff else [None] * 3
    done, popped = a.done.clone(), a.popped.clone()
    jready, jpipe = a.jready.clone(), a.jpipe.clone()
    cursor, acount = a.cursor.clone(), a.acount.clone()
    jalloc, qalloc = a.jalloc.clone(), a.qalloc.clone()
    node_o = [-1] * CM
    mode_o = [MODE_NONE] * CM
    gpu_o = [-1] * CM
    pops = 0
    kept_any = prog = False
    stats = {} if stats is None else stats

    for p in range(KP):
        # ---- eligibility: the proportion overused gate, live -----------
        over_col = (qalloc > a.des + _EPS_CMP).any(1).to(f32)      # [Q]
        over_j = fold_rows(a.qoh * over_col[:, None]) > 0           # [J]
        elig = eligs & (done[0] == 0) & (cursor[0] < npend) & ~over_j
        guard = False
        if NH:
            qmn = torch.where(elig, qid_f, inf).min()
            qmx = torch.where(elig, qid_f, -inf).max()
            guard = kept_any and bool(qmn != qmx)
        any_elig = bool(elig.any())

        jsel = J
        if p > 0 and any_elig:
            # ---- the dynamic keys, then the lexicographic argmin --------
            qshare_col = torch.where(des_ok, qalloc / des_div, zero) \
                .max(1).values + a.qex[:, 0]                         # [Q]
            dyn = {KEY_QSHARE: fold_rows(a.qoh * qshare_col[:, None]),
                   KEY_READY: ((a.rdy0[0] + acount[0] >= a.minav[0])
                               & (a.minav[0] > 0)).to(f32)}
            if cfg.drf_ns_order:
                alloc_s = fold_last(torch.where(
                    a.nsc[:, None, :] > 0, jalloc[None], zero))     # [S, R]
                frac = torch.where(total > 0, alloc_s
                                   / total.clamp_min(_EPS_DIV), zero)
                share_s = frac.max(1).values / a.nsw[0].clamp_min(1.0)
                ns_key = torch.zeros(J, dtype=f32, device=dev)
                for s_ in range(S):
                    ns_key = torch.where(a.nsm[s_] > 0, share_s[s_], ns_key)
                dyn[KEY_NS] = ns_key
            if cfg.drf_job_order:
                frac = torch.where(a.total > 0, jalloc
                                   / a.total.clamp_min(_EPS_DIV), zero)
                dyn[KEY_JSHARE] = torch.where(valid_job, frac.max(0).values,
                                              inf)
            m = elig
            for code in plan:
                if code >= 0:
                    k = a.skeys[code]
                elif code <= KEY_HCOL:
                    k = a.hcols[KEY_HCOL - code]
                else:
                    k = dyn[code]
                kmin = torch.where(m, k, inf).min()
                m = m & (k <= kmin)
            jsel = int(torch.where(m, iota_j, J).min())

        jstar = cand[0] if p == 0 else jsel
        inside = 0 <= jstar < J
        cs = cslot[jstar] if inside else 0
        ok = p < kmax and any_elig and not guard and cs >= 0 and inside
        if not ok:
            break

        cur0 = int(cursor[0, jstar])
        ready0 = rdy0[jstar] + int(acount[0, jstar])
        is_tgt = jstar == tgt
        off = cs * M
        saved = [x.clone() if x is not None else None for x in state]
        n_allocs = n_pipes = n_adv = 0
        stopped = broke = False
        for m_ in range(cur0, M):
            s = off + m_
            can_run = tidok[s] > 0 and not stopped and not broke
            active = can_run and nbe[s] > 0
            node, mode, card = -1, MODE_NONE, -1
            if active:
                node, mode, card = rp.place_one(cfg, w, a, sl, s, is_tgt,
                                                state, iota_n, stats)
            node_o[s], mode_o[s], gpu_o[s] = node, mode, card
            placed = mode != MODE_NONE
            n_allocs += mode == MODE_ALLOCATED
            n_pipes += mode == MODE_PIPELINED
            n_adv += can_run
            ready_aft = (ready0 + n_allocs >= minav[jstar]
                         if cfg.enable_gang else True)
            stopped = stopped or (placed and ready_aft and suffix[s] > 0
                                  and not canb[jstar] > 0)
            broke = broke or (active and not placed)

        # ---- gang finalize and key-state commit --------------------------
        ready = ready0 + n_allocs >= minav[jstar] if cfg.enable_gang else True
        pipelined = (ready0 + n_allocs + n_pipes >= minav[jstar]) and not ready
        keep = ready or pipelined
        sec = range(off + cur0, off + M)
        if not keep:
            for s in sec:
                node_o[s], mode_o[s], gpu_o[s] = -1, MODE_NONE, -1
            state = saved
        elif not ready:
            for s in sec:
                if mode_o[s] == MODE_ALLOCATED:
                    mode_o[s] = MODE_PIPELINED
        # committed resources of this pop, added in slot order
        commit = torch.zeros(R, dtype=f32, device=dev)
        for s in sec:
            if mode_o[s] != MODE_NONE:
                commit = commit + a.resreq[:, s]
        done[0, jstar] = 0 if stopped else 1
        popped[0, jstar] = 1
        jready[0, jstar] = int(ready and keep)
        jpipe[0, jstar] = int(pipelined and keep)
        cursor[0, jstar] += n_adv
        if keep:
            acount[0, jstar] += n_allocs
        jalloc[:, jstar] = jalloc[:, jstar] + commit
        if 0 <= qid[jstar] < Q:
            qalloc[qid[jstar]] = qalloc[qid[jstar]] + commit
        kept_any = kept_any or (keep and n_allocs + n_pipes > 0)
        prog = prog or n_allocs > 0 or pipelined or ready
        pops += 1

    stats["pops"] = stats.get("pops", 0) + pops

    def i32(v) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int32, device=dev).reshape(1, -1)

    idle, pipe, pods, gpux = state[:4]
    outs = [i32(node_o), i32(mode_o), i32(gpu_o), idle, pipe, pods]
    if gpu:
        outs.append(gpux)
    if aff:
        outs += state[4:]
    return tuple(outs + [done, popped, jready, jpipe, cursor, acount,
                         jalloc, qalloc, i32([pops]), i32([int(prog)])])


# --------------------------------------------------------------------------
# the CUDA kernel
# --------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        from ._build import load
        lib = load("dyn_placer")
        fn = lib.dyn_placer_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        _lib = lib
    return _lib


#: outputs of the C launcher, after the inputs (absent ones as null)
N_OUTS = 20
#: number of pointer arguments of the C launcher: the inputs, the outputs,
#: the affinity scratch rows and the phase split
N_PTRS = len(DynArgs._fields) + N_OUTS + 2
#: the phases of a launch that its optional phase split times (the
#: source's Phase), and the int64 words of the split: the phases' clock64()
#: cycles summed over the launch's pops, the launch's cycles, its
#: globaltimer nanoseconds and its pops
PHASES = ("prologue", "gate_fold", "eligibility", "argmin", "attempts",
          "finalize")
N_STAMPS = len(PHASES) + 3
#: order of the integer dimensions and flags of the C launcher; the key
#: plan follows
DIMS = ("C", "KP", "M", "N", "R", "G", "GR", "J", "Q", "S", "NH", "NKS",
        "gang", "pipelining", "drf_ns", "nkeys", "aff", "SK", "ETA", "SEL",
        "A", "B", "PP", "CB")


def plan_words(N: int, CB: int, C: int, M: int, R: int, G: int, Q: int,
               S: int, P: int, NKS: int, NH: int, SK: int = 0,
               list_ints: int = 0):
    """(fixed, per job): the 4-byte words of dynamic shared memory a block
    of the cluster takes (the source's make_plan), apart from its job rows,
    and for each job of its slice. Fixed: the block's slice of the live
    node state [2R + 1 + G, ceil(N / CB)], one pop's saved node columns
    (node id + the same 2R + 1 + G values a slot), the launch's slot node,
    mode and card [C * M], the affinity totals [SK] and term lists, the
    queue allocations and deserved [Q, R], queue extra, gate and share
    [Q], the totals [R], the namespace allocations and shares [S, R + 1],
    and one fold tile's warp counts, offsets [TP, CWARPS] and list
    lengths [TP], TP = min(P, PAIR_TILE). Per job: the static key rows
    [NKS], hdrf columns [NH], queue one-hot [Q], the namespace word,
    validf, allocation [R], the dynamic key table [N_DYN], one fold
    tile's lists [TP] and 11 int rows."""
    col = 2 * R + 1 + G
    cap = -(-N // CB)
    TP = min(P, PAIR_TILE)
    fixed = (col * cap + M * (col + 1) + 3 * C * M + SK + list_ints
             + 2 * Q * R + 3 * Q + R + S * (R + 1) + 2 * TP * CWARPS + TP)
    per_job = NKS + NH + Q + 1 + 1 + R + N_DYN + TP + 11
    return fixed, per_job


def shared_bytes(N: int, J: int, CB: int, C: int, M: int, R: int, G: int,
                 Q: int, S: int, P: int, NKS: int, NH: int, SK: int = 0,
                 list_ints: int = 0) -> int:
    """Dynamic shared memory of each block of one launch (plan_words)."""
    fixed, per_job = plan_words(N, CB, C, M, R, G, Q, S, P, NKS, NH, SK,
                                list_ints)
    return (fixed + per_job * -(-J // CB)) * 4


def max_jobs(N: int, CB: int, C: int, M: int, R: int, G: int, Q: int,
             S: int, P: int, NKS: int, NH: int, SK: int = 0,
             list_ints: int = 0) -> int:
    """The most jobs a launch of these shapes takes: CB slices whose rows
    fit a block's MAX_SHARED, each within a bitmask a thread."""
    fixed, per_job = plan_words(N, CB, C, M, R, G, Q, S, P, NKS, NH, SK,
                                list_ints)
    return CB * max(0, min((MAX_SHARED // 4 - fixed) // per_job,
                           JOB_BITS * CBLOCK))


def _check(cfg, C, KP, M, a: DynArgs):
    """Device, dtype, shape and layout of every argument."""
    R, N, CM, _, J, Q, S, NH, G = _shapes(a)
    P, GR = a.tstat.shape[0], a.orfeas.shape[0]
    NKS = a.skeys.shape[0]
    f, i = torch.float32, torch.int32
    if CM != C * M or a.cand.shape[1] != C:
        raise ValueError(f"expected C={C} candidates of M={M} slots, got "
                         f"{a.cand.shape[1]} and {CM} slots")
    plan, nks = key_plan(cfg, NH)
    if nks != NKS:
        raise ValueError(f"the key plan reads {nks} static key rows, "
                         f"skeys has {NKS}")
    want = dict(
        resreq=((R, CM), f), gpu_req=((1, CM), f), pref=((1, CM), i),
        suffix=((1, CM), i), tmpl=((1, CM), i), grp=((1, CM), i),
        voln=((1, CM), i), volok=((1, CM), i), rev=((1, CM), i),
        tidok=((1, CM), i), nbe=((1, CM), i), cand=((1, C), i),
        cslot=((1, J), i), skeys=((NKS, J), f), hcols=((NH, J), f),
        qid=((1, J), i), qoh=((Q, J), f), nsm=((S, J), f), nsc=((S, J), f),
        nsw=((1, S), f), minav=((1, J), i), rdy0=((1, J), i),
        npend=((1, J), i), eligs=((1, J), i), validf=((1, J), f),
        canb=((1, J), i), des=((Q, R), f), qex=((Q, 1), f),
        total=((R, 1), f), kmax=((1, 1), i), tgt=((1, 1), i),
        tstat=((P, N), f), tscore=((P, N), f), nascore=((P, N), f),
        blocknr=((1, N), f), blockall=((1, N), f), bonus=((1, N), f),
        locked=((1, N), f), orfeas=((GR, N), f), relmp=((R, N), f),
        alloc=((R, N), f), cnt=((1, N), f), maxp=((1, N), f),
        gidle0=((G, N), f), idle=((R, N), f), pipe=((R, N), f),
        pods=((1, N), f), gpux=((G, N), f), done=((1, J), i),
        popped=((1, J), i), jready=((1, J), i), jpipe=((1, J), i),
        cursor=((1, J), i), acount=((1, J), i), jalloc=((R, J), f),
        qalloc=((Q, R), f), **rp.aff_shapes(a, CM))
    rp.check_layout(want, a)
    return plan


def phase_split(stamps: torch.Tensor) -> dict:
    """Microseconds of each phase of the launch that wrote ``stamps``: its
    clock64() cycles scaled by the launch's nanoseconds per cycle (the
    globaltimer over clock64() across the whole launch)."""
    v = stamps.tolist()
    cycles, ns, pops_ = v[len(PHASES)], v[len(PHASES) + 1], v[len(PHASES) + 2]
    us = ns / 1000.0 / max(cycles, 1)
    return dict({ph: v[k] * us for k, ph in enumerate(PHASES)},
                launch_us=ns / 1000.0, cycles=cycles, pops=pops_)


def launch_plan(cfg, C: int, M: int, a: DynArgs, cb: Optional[int] = None,
                plan: Optional[List[int]] = None,
                ad: Optional[dict] = None):
    """(CB, dynamic shared bytes a block) of a launch as one cluster of
    ``cb`` blocks (:data:`CLUSTER` when not given); raises on a shape the
    kernel does not take, J past :func:`max_jobs` among them. ``plan``
    (the key plan :func:`_check` returns) and ``ad`` (``aff_dims``) are
    computed here when not given."""
    R, N, _, _, J, Q, S, NH, G = _shapes(a)
    CB = CLUSTER if cb is None else cb
    # one cluster, per-dim registers, each block's slices of the node state
    # and of the job rows in shared memory, a job bitmask per thread
    if not 1 <= R <= rp.MAX_R:
        raise ValueError(f"the kernel takes 1..{rp.MAX_R} resource dims, "
                         f"got {R}")
    if not 1 <= CB <= MAX_CB:
        raise ValueError(f"the kernel takes clusters of 1..{MAX_CB} blocks, "
                         f"not {CB}")
    nkeys = len(key_plan(cfg, NH)[0] if plan is None else plan)
    ad = rp.aff_dims(a) if ad is None else ad
    NKS, SK, list_ints = a.skeys.shape[0], ad["SK"], rp.aff_list_ints(ad)
    P = S * R if cfg.drf_ns_order else 0
    rest = (C, M, R, G, Q, S, P, NKS, NH, SK, list_ints)
    why = refusal(N, J, CB, nkeys, *rest)
    if why is not None:
        raise ValueError(why)
    return CB, shared_bytes(N, J, CB, *rest)


def refusal(N: int, J: int, CB: int, nkeys: int, C: int, M: int, R: int,
            G: int, Q: int, S: int, P: int, NKS: int, NH: int, SK: int = 0,
            list_ints: int = 0) -> Optional[str]:
    """Why the kernel does not take a launch of these shapes, where a
    snapshot's size decides it: more ordering keys than MAX_KEYS, or J
    past :func:`max_jobs`; None when it takes them. The allocate cycle
    routes such a snapshot to the one-shard mesh path
    (``allocate_scan.dyn_refusal``), as the reference leaves its fused
    kernel for its scan path when the kernel's VMEM estimate does not fit
    (volcano_tpu/ops/allocate_scan.py:567-605)."""
    if nkeys > MAX_KEYS:
        return f"{nkeys} ordering keys, over {MAX_KEYS}"
    rest = (C, M, R, G, Q, S, P, NKS, NH, SK, list_ints)
    jmax = max_jobs(N, CB, *rest)
    if J > jmax:
        return (f"J={J} jobs need {shared_bytes(N, J, CB, *rest)} bytes of "
                f"shared memory a block at CB={CB}; the kernel takes "
                f"J <= {jmax} at these shapes")
    return None


#: the last namespace word derived (:func:`ns_word`): the one-hot rows it
#: came from, their versions, and the word
_ns_cache: tuple = (None, None, None, None)


def ns_word(nsm: torch.Tensor, nsc: torch.Tensor) -> torch.Tensor:
    """The kernel's namespace word of each job, i32 [1, J]: the key
    namespace + 1 (the last row of ``nsm`` that holds the job; 0 for none)
    in its low 16 bits, and the fold namespace + 1 (the last row of
    ``nsc``) in its high bits. It carries one fold namespace a job, as the
    cycle builds the rows (``nsc`` is ``nsm`` of the valid jobs). Derived
    on the rows' device once for the tensors the cycle passes to every
    launch (the same tensors, unchanged, give the cached word)."""
    global _ns_cache
    m, c, ver, word = _ns_cache
    if m is nsm and c is nsc and ver == (nsm._version, nsc._version):
        return word
    ids = torch.arange(1, nsm.shape[0] + 1, dtype=torch.int32,
                       device=nsm.device)[:, None]
    key = torch.where(nsm > 0, ids, 0).amax(0)
    fold = torch.where(nsc > 0, ids, 0).amax(0)
    word = (key | (fold << 16)).to(torch.int32)[None, :].contiguous()
    _ns_cache = (nsm, nsc, (nsm._version, nsc._version), word)
    return word


def dyn_place_cuda(cfg, C: int, KP: int, M: int, args,
                   cb: Optional[int] = None,
                   stamps: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel on the current stream (no synchronisation),
    as one cluster of ``cb`` blocks (:data:`CLUSTER` when not given).
    ``stamps``, an int64 [N_STAMPS] tensor on the card, receives the
    launch's phase split (:func:`phase_split`). Raises when the card cannot
    run the cluster."""
    global launches, aff_launches
    a = unpack_args(cfg, args)
    if not a.idle.is_cuda:
        raise ValueError(f"the kernel takes tensors on a CUDA device, not "
                         f"{a.idle.device}")
    plan = _check(cfg, C, KP, M, a)
    ad = rp.aff_dims(a)
    CB, _ = launch_plan(cfg, C, M, a, cb, plan, ad)
    R, N, CM, _, J, Q, S, NH, G = _shapes(a)
    dev = a.idle.device
    i32 = dict(dtype=torch.int32, device=dev)
    outs = [torch.empty((1, CM), **i32) for _ in range(3)]
    outs += [torch.empty_like(t) if t is not None else None
             for t in (a.idle, a.pipe, a.pods, a.gpux, a.aff_cnt, a.aff_tot,
                       a.anti_cnt, a.done, a.popped, a.jready, a.jpipe,
                       a.cursor, a.acount, a.jalloc, a.qalloc)]
    outs += [torch.empty((1, 1), **i32), torch.empty((1, 1), **i32)]
    scratch = (torch.empty((2, N), dtype=torch.float32, device=dev)
               if ad["aff"] else None)
    if stamps is not None and (stamps.dtype != torch.int64
                               or stamps.shape != (N_STAMPS,)
                               or stamps.device != dev):
        raise ValueError(f"stamps: expected int64 [{N_STAMPS}] on {dev}")
    if a.nsm is not None:
        # the kernel reads one namespace word a job, not the one-hot rows
        a = a._replace(nsm=ns_word(a.nsm, a.nsc), nsc=None)
    ptrs = (ctypes.c_void_p * N_PTRS)(*[
        t.data_ptr() if t is not None else None
        for t in list(a) + outs + [scratch, stamps]])
    dims = dict(C=C, KP=KP, M=M, N=N, R=R, G=G, GR=a.orfeas.shape[0], J=J,
                Q=Q, S=S, NH=NH, NKS=a.skeys.shape[0],
                gang=int(bool(cfg.enable_gang)),
                pipelining=int(bool(cfg.enable_pipelining)),
                drf_ns=int(bool(cfg.drf_ns_order)), nkeys=len(plan), CB=CB,
                **ad)
    ints = (ctypes.c_int * (len(DIMS) + MAX_KEYS))(
        *[dims[k] for k in DIMS], *plan)
    weights = (ctypes.c_float * 5)(
        *rp._weights(cfg), float(np.float32(cfg.pod_affinity_weight)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _library().dyn_placer_launch(ptrs, ints, weights,
                                      ctypes.c_void_p(stream))
    rp.raise_launch(rc, "dyn_placer", CB)
    launches += 1
    aff_launches += ad["aff"]
    return tuple(o for o in outs if o is not None)


def dyn_place(cfg, C: int, KP: int, M: int, args):
    """Run up to KP pops: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    dev = args[0].device
    if dev.type == "cuda":
        return dyn_place_cuda(cfg, C, KP, M, args)
    if dev.type == "cpu":
        _check(cfg, C, KP, M, unpack_args(cfg, args))
        return dyn_place_plain(cfg, C, KP, M, args)
    raise ValueError(f"no dyn placer for device {dev}")
