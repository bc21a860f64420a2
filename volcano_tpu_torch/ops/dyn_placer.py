"""Dynamic-key round placer: up to KP job pops per launch over C candidate
jobs, with the ordering keys recomputed after every gang commit.

Port of ``volcano_tpu/ops/pallas_place.make_dyn_round_placer`` (the Pallas
``_dyn_kernel``), without the pod-affinity extension. It carries the
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
  (``csrc/dyn_placer.cu``), for tensors on a CUDA device;
- :func:`dyn_place_plain` is the plain PyTorch version of the same
  function, the port's counterpart of ``interpret=True``.

:func:`dyn_place` chooses by the device of the tensors it is given.

Arguments (``*`` only with ``cfg.enable_gpu``, ``^`` only with
``cfg.enable_hdrf``, ``#`` only with ``cfg.drf_ns_order``)::

    resreq f32[R, CM], *gpu_req f32[1, CM], pref, suffix, tmpl, grp, voln,
    volok, rev, tidok, nbe i32[1, CM], cand i32[1, C], cslot i32[1, J],
    skeys f32[NKS, J], ^hcols f32[NH, J], qid i32[1, J], qoh f32[Q, J],
    #nsm, #nsc f32[S, J], #nsw f32[1, S], minav, rdy0, npend, eligs
    i32[1, J], validf f32[1, J], canb i32[1, J], des f32[Q, R], qex
    f32[Q, 1], total f32[R, 1], kmax, tgt i32[1, 1], tstat, tscore,
    nascore f32[P, N], blocknr, blockall, bonus, locked f32[1, N], orfeas
    f32[GR, N], relmp, alloc f32[R, N], cnt, maxp f32[1, N], *gidle0
    f32[G, N], idle, pipe f32[R, N], pods f32[1, N], *gpux f32[G, N],
    done, popped, jready, jpipe, cursor, acount i32[1, J], jalloc f32[R, J],
    qalloc f32[Q, R]

Outputs, as the reference returns them: node, mode, gpu i32[1, CM], idle',
pipe' f32[R, N], pods' f32[1, N], (gpux' f32[G, N]), done', popped',
ready', pipelined', cursor', acount' i32[1, J], jalloc' f32[R, J], qalloc'
f32[Q, R], pops, progressed i32[1, 1].

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
#: jobs each thread of the kernel's block keeps in its eligibility bitmask
JOB_BITS = 32

#: launches of the CUDA kernel since the count was last set to 0
launches = 0
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
    idle: torch.Tensor
    pipe: torch.Tensor
    pods: torch.Tensor
    gpux: Optional[torch.Tensor]
    done: torch.Tensor
    popped: torch.Tensor
    jready: torch.Tensor
    jpipe: torch.Tensor
    cursor: torch.Tensor
    acount: torch.Tensor
    jalloc: torch.Tensor
    qalloc: torch.Tensor


_OPTIONAL = {"gpu_req": "enable_gpu", "gidle0": "enable_gpu",
             "gpux": "enable_gpu", "hcols": "enable_hdrf",
             "nsm": "drf_ns_order", "nsc": "drf_ns_order",
             "nsw": "drf_ns_order"}


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
    is given, gains ``attempts`` and ``pops``: the work the kernel's bound
    is computed from."""
    a = unpack_args(cfg, args)
    gpu = bool(cfg.enable_gpu)
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
    done, popped = a.done.clone(), a.popped.clone()
    jready, jpipe = a.jready.clone(), a.jpipe.clone()
    cursor, acount = a.cursor.clone(), a.acount.clone()
    jalloc, qalloc = a.jalloc.clone(), a.qalloc.clone()
    node_o = [-1] * CM
    mode_o = [MODE_NONE] * CM
    gpu_o = [-1] * CM
    pops = 0
    kept_any = prog = False
    n_attempts = 0

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
                n_attempts += 1
                node, mode, card = rp.place_one(cfg, w, a, sl, s, is_tgt,
                                                state, iota_n)
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

    if stats is not None:
        stats["attempts"] = stats.get("attempts", 0) + n_attempts
        stats["pops"] = stats.get("pops", 0) + pops

    def i32(v) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int32, device=dev).reshape(1, -1)

    idle, pipe, pods, gpux = state
    outs = [i32(node_o), i32(mode_o), i32(gpu_o), idle, pipe, pods]
    if gpu:
        outs.append(gpux)
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


#: number of pointer arguments of the C launcher: the inputs, then the 17
#: outputs (absent optional ones as null pointers)
N_PTRS = len(DynArgs._fields) + 17
#: order of the integer dimensions and flags of the C launcher
DIMS = ("C", "KP", "M", "N", "R", "G", "GR", "J", "Q", "S", "NH", "NKS",
        "gang", "pipelining", "drf_ns", "nkeys")


def shared_bytes(M: int, R: int, G: int, Q: int, S: int) -> int:
    """Dynamic shared memory of one launch: one pop's saved node columns
    (node id + idle, pipe [R] + pods + GPU cards [G] per slot), the queue
    gate and share [Q] each, and the namespace allocations and shares
    [S, R + 1]."""
    return (M * (2 * R + G + 2) + 2 * Q + S * (R + 1)) * 4


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
        qalloc=((Q, R), f))
    for name, (shape, dtype) in want.items():
        t = getattr(a, name)
        if t is None:
            continue
        if t.device != a.idle.device:
            raise ValueError(f"{name}: expected a tensor on {a.idle.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    return plan


def dyn_place_cuda(cfg, C: int, KP: int, M: int, args):
    """Launch the CUDA kernel on the current stream (no synchronisation)."""
    global launches
    a = unpack_args(cfg, args)
    if not a.idle.is_cuda:
        raise ValueError(f"the kernel takes tensors on a CUDA device, not "
                         f"{a.idle.device}")
    plan = _check(cfg, C, KP, M, a)
    R, N, CM, _, J, Q, S, NH, G = _shapes(a)
    # launch shape: one block, per-dim registers, a job bitmask per thread,
    # the pop's saved columns and the per-queue and per-namespace state
    if not 1 <= R <= rp.MAX_R:
        raise ValueError(f"the kernel takes 1..{rp.MAX_R} resource dims, "
                         f"got {R}")
    if J > JOB_BITS * rp.BLOCK:
        raise ValueError(f"the kernel takes up to {JOB_BITS * rp.BLOCK} "
                         f"jobs, got {J}")
    if len(plan) > MAX_KEYS:
        raise ValueError(f"{len(plan)} ordering keys, over {MAX_KEYS}")
    smem = shared_bytes(M, R, G, Q, S)
    if smem > 48 * 1024:
        raise ValueError(f"the launch needs {smem} bytes of shared memory, "
                         f"over the 48 KiB a launch takes without opt-in")
    dev = a.idle.device
    i32 = dict(dtype=torch.int32, device=dev)
    outs = [torch.empty((1, CM), **i32) for _ in range(3)]
    outs += [torch.empty_like(a.idle), torch.empty_like(a.pipe),
             torch.empty_like(a.pods),
             torch.empty_like(a.gpux) if a.gpux is not None else None]
    outs += [torch.empty_like(t) for t in (a.done, a.popped, a.jready,
                                           a.jpipe, a.cursor, a.acount,
                                           a.jalloc, a.qalloc)]
    outs += [torch.empty((1, 1), **i32), torch.empty((1, 1), **i32)]
    ptrs = (ctypes.c_void_p * N_PTRS)(*[
        t.data_ptr() if t is not None else None for t in list(a) + outs])
    dims = dict(C=C, KP=KP, M=M, N=N, R=R, G=G, GR=a.orfeas.shape[0], J=J,
                Q=Q, S=S, NH=NH, NKS=a.skeys.shape[0],
                gang=int(bool(cfg.enable_gang)),
                pipelining=int(bool(cfg.enable_pipelining)),
                drf_ns=int(bool(cfg.drf_ns_order)), nkeys=len(plan))
    ints = (ctypes.c_int * (len(DIMS) + MAX_KEYS))(
        *[dims[k] for k in DIMS], *plan)
    weights = (ctypes.c_float * 4)(*rp._weights(cfg))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _library().dyn_placer_launch(ptrs, ints, weights,
                                      ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"dyn_placer launch failed: CUDA error {rc}")
    launches += 1
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
