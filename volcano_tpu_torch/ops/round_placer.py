"""Static-key round placer: K job sections x M placements per launch.

Port of ``volcano_tpu/ops/pallas_place.make_round_placer`` (the Pallas
``_batch_kernel`` with its placement step ``_make_attempt`` and score
``_dyn_score``), and of its pod-affinity extension (``_read_aff_env``,
``_aff_eval``, ``_aff_commit``) with ``cfg.enable_pod_affinity``. One call
places the
pending tasks of K pre-selected gangs in order. For every task: the static
template row and the tdm / lock / OR-group / volume gates, the pod count,
the GPU card fit and the resource fit on idle ("now") and on future idle;
the binpack / least / most / balanced + taint + node-affinity + tdm bonus +
preferred-node score; with pod affinity the InterPodAffinity mask (required
affinity with the first-pod escape, own and symmetric required
anti-affinity) and the min-max normalised preferred-term score over the
live counts; the lowest-index argmax for both views; the commit to idle /
pipelined / pods / GPU cards and to the affinity counts. Yield and break
(allocate.go:205-266)
and the gang commit or discard of each section (statement.go:352-395)
happen inside the call, so committed capacity flows from section to section.

Two implementations share one signature and argument order (the order of
``pallas_place._read_slot_env`` / ``_read_node_env``):

- :func:`round_place_cuda` launches the hand-written CUDA kernel
  (``csrc/round_placer.cu``), for tensors on a CUDA device: one
  thread-block cluster of CB blocks, block r owning the nodes
  :func:`cluster_slices` gives it;
- :func:`round_place_plain` is the plain PyTorch version of the same
  function, the port's counterpart of ``interpret=True``.

:func:`round_place` chooses by the device of the tensors it is given.

Arguments (node axis last, as in the reference; ``*`` only when
``cfg.enable_gpu``, ``@`` only when ``cfg.enable_pod_affinity``)::

    resreq_t f32[R, KM], *gpu_req f32[1, KM], pref, suffix, tmpl, grp, voln,
    volok, rev, active i32[1, KM], ready0, minav, canb, secact, istgt
    i32[1, K], tstat, tscore, nascore f32[P, N], blocknr, blockall, bonus,
    locked f32[1, N], orfeas f32[GR, N], relmp, alloc_t f32[R, N], cnt, maxp
    f32[1, N], *gidle0 f32[G, N], @live f32[1, N], @skdom i32[SK, N],
    @sk_sel i32[SK, 1], @eta_sk i32[1, ETA], @eta_dom i32[ETA, N],
    @static_pref f32[SEL, N], @aff_sk i32[A, KM], @anti i32[B, KM],
    @prefsk i32[PP, KM], @prefw f32[PP, KM], @skm f32[SK, KM], @etm
    f32[ETA, KM], @selm f32[SEL, KM], idle, pipe f32[R, N], pods f32[1, N],
    *gpux f32[G, N], @aff_cnt f32[SK, N], @aff_tot f32[SK, 1], @anti_cnt
    f32[ETA, N]

Outputs: node, mode, gpu i32[KM], idle', pipe' f32[R, N], pods' f32[1, N],
with the GPU path gpux' f32[G, N], with pod affinity aff_cnt' f32[SK, N],
aff_tot' f32[SK, 1], anti_cnt' f32[ETA, N].
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .scoring import sqrt32

MODE_NONE = 0
MODE_ALLOCATED = 1
MODE_PIPELINED = 2

_EPS_FIT = float(np.float32(1e-5))   # predicates._EPS
_EPS_DIV = float(np.float32(1e-9))   # scoring._EPS
_OVER = float(np.float32(1.0 + 1e-6))
NEG = float(np.float32(-1e30))       # select.NEG
_BIG = float(np.float32(3.4e38))     # the normalisation's empty extremes

#: node-axis sums inside the kernel keep one register slot per resource dim
MAX_R = 8

#: launches of the CUDA kernel since the count was last set to 0, and those
#: of them that ran the pod-affinity step
launches = 0
aff_launches = 0


class PlacerArgs(NamedTuple):
    resreq: torch.Tensor
    gpu_req: Optional[torch.Tensor]
    pref: torch.Tensor
    suffix: torch.Tensor
    tmpl: torch.Tensor
    grp: torch.Tensor
    voln: torch.Tensor
    volok: torch.Tensor
    rev: torch.Tensor
    active: torch.Tensor
    ready0: torch.Tensor
    minav: torch.Tensor
    canb: torch.Tensor
    secact: torch.Tensor
    istgt: torch.Tensor
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


#: the affinity arguments, in the order of pallas_place._read_aff_env, and
#: the live affinity state
AFF_FIELDS = ("live", "skdom", "sk_sel", "eta_sk", "eta_dom", "static_pref",
              "aff_sk", "anti", "prefsk", "prefw", "skm", "etm", "selm")
AFF_STATE = ("aff_cnt", "aff_tot", "anti_cnt")
#: the config flag each optional argument of both placers needs
OPTIONAL = {**{f: "enable_gpu" for f in ("gpu_req", "gidle0", "gpux")},
            **{f: "enable_pod_affinity" for f in AFF_FIELDS + AFF_STATE}}


def unpack_args(cfg, args) -> PlacerArgs:
    """Name the flat argument list (GPU entries only with cfg.enable_gpu,
    affinity entries only with cfg.enable_pod_affinity)."""
    it = iter(args)
    vals = {f: (next(it) if f not in OPTIONAL or getattr(cfg, OPTIONAL[f])
                else None)
            for f in PlacerArgs._fields}
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} arguments too many for the placer")
    return PlacerArgs(**vals)


def _weights(cfg):
    """Score weights rounded to float32 once, as the reference rounds them."""
    return [float(np.float32(w)) for w in (
        cfg.binpack_weight, cfg.least_allocated_weight,
        cfg.most_allocated_weight, cfg.balanced_weight)]


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[R, N] -> [1, N] sum over R as ((0 + x0) + x1) + ... in index order."""
    acc = torch.zeros_like(x[:1])
    for r in range(x.shape[0]):
        acc = acc + x[r:r + 1]
    return acc


def _dyn_score(w, idle, alloc_t, rr_col):
    """Idle-dependent score terms in [R, N] layout, operation for operation
    ``pallas_place._dyn_score`` (and so ``ops/scoring.py``)."""
    w_bin, w_least, w_most, w_bal = w
    used = alloc_t - idle
    score = torch.zeros_like(idle[:1])
    zero = torch.zeros_like(idle)
    if w_bin:
        applicable = (rr_col > 0) & (alloc_t > 0)
        frac = torch.where(applicable,
                           (used + rr_col) / alloc_t.clamp_min(_EPS_DIV), zero)
        over = (frac > _OVER).any(0, keepdim=True)
        wgt = applicable.to(torch.float32)
        raw = _fold(frac * wgt) / _fold(wgt).clamp_min(_EPS_DIV)
        raw = torch.where(over, torch.zeros_like(raw), raw)
        score = score + (w_bin * raw) * 100.0
    if w_least:
        cap = alloc_t.clamp_min(_EPS_DIV)
        free_frac = (alloc_t - used - rr_col) / cap
        counted = alloc_t > 0
        n = _fold(counted.to(torch.int32)).clamp_min(1)
        score = score + w_least * (
            _fold(free_frac.clamp(0.0, 1.0) * counted) / n * 100.0)
    if w_most:
        cap = alloc_t.clamp_min(_EPS_DIV)
        used_frac = (used + rr_col) / cap
        counted = alloc_t > 0
        n = _fold(counted.to(torch.int32)).clamp_min(1)
        score = score + w_most * (
            _fold(used_frac.clamp(0.0, 1.0) * counted) / n * 100.0)
    if w_bal:
        cap = alloc_t.clamp_min(_EPS_DIV)
        frac = ((used + rr_col) / cap).clamp(0.0, 1.0)
        counted = (alloc_t > 0).to(torch.float32)
        n = _fold(counted).clamp_min(1.0)
        mean = _fold(frac * counted) / n
        dev = frac - mean
        var = _fold((dev * dev) * counted) / n
        score = score + (w_bal * (1.0 - sqrt32(var))) * 100.0
    return score


def _pick(feas, score, iota):
    """Lowest-index argmax of ``score`` over ``feas`` and whether any node
    is feasible (``pallas_place._make_attempt.pick``)."""
    masked = torch.where(feas, score, torch.full_like(score, NEG))
    best = masked.max()
    idx = torch.where(masked == best, iota, torch.full_like(iota, iota.numel()))
    return idx.min(), feas.any()


class AffLists(NamedTuple):
    """A launch's affinity slot tables and term maps as host lists."""
    aff_sk: List[List[int]]    # [A][S]
    anti: List[List[int]]      # [B][S]
    prefsk: List[List[int]]    # [PP][S]
    prefw: List[List[float]]   # [PP][S]
    skm: List[List[float]]     # [SK][S]
    etm: List[List[float]]     # [ETA][S]
    selm: List[List[float]]    # [SEL][S]
    sk_sel: List[int]          # [SK]
    eta_sk: List[int]          # [ETA]

    @classmethod
    def of(cls, a) -> "AffLists":
        return cls(a.aff_sk.tolist(), a.anti.tolist(), a.prefsk.tolist(),
                   a.prefw.tolist(), a.skm.tolist(), a.etm.tolist(),
                   a.selm.tolist(), a.sk_sel[:, 0].tolist(),
                   a.eta_sk[0].tolist())


class SlotLists(NamedTuple):
    """The per-slot integer rows of a launch as host lists (one readback),
    the GPU requests when the GPU path is on and the affinity tables when
    pod affinity is."""
    pref: List[int]
    tmpl: List[int]
    grp: List[int]
    voln: List[int]
    volok: List[int]
    rev: List[int]
    gpu_req: Optional[List[float]]
    aff: Optional[AffLists]

    @classmethod
    def of(cls, a) -> "SlotLists":
        rows = torch.cat([a.pref, a.tmpl, a.grp, a.voln, a.volok,
                          a.rev]).tolist()
        return cls(*rows, a.gpu_req[0].tolist() if a.gpu_req is not None
                   else None, AffLists.of(a) if a.live is not None else None)


def aff_eval(a, al: AffLists, s: int, aff_state, stats=None):
    """The InterPodAffinity mask and the normalised preferred score [1, N]
    of slot ``s`` against the live counts: the plain version of
    ``pallas_place._aff_eval``. Rows the task does not match are skipped;
    they add ``false`` or 0 * x to integer-valued sums in the reference."""
    cnt, tot, anti_cnt = aff_state
    zero = torch.zeros((), dtype=torch.float32, device=cnt.device)
    ok = torch.ones_like(a.live, dtype=torch.bool)
    rows = 0
    # required affinity: the domain holds a matching pod, or the first-pod
    # escape (no matching pod anywhere, and the task matches itself)
    for sks in al.aff_sk:
        sk = sks[s]
        if sk < 0:
            continue
        esc = (tot[sk:sk + 1] == 0) & (al.skm[sk][s] > 0)   # [1, 1]
        ok = ok & (a.skdom[sk:sk + 1] >= 0) & ((cnt[sk:sk + 1] > 0) | esc)
        rows += 1
    # required anti-affinity: the task's own terms, then placed pods' terms
    # that match the task (symmetric)
    for es in al.anti:
        e = es[s]
        if e < 0:
            continue
        esk = max(al.eta_sk[e], 0)
        ok = ok & ~((cnt[esk:esk + 1] > 0) & (a.eta_dom[e:e + 1] >= 0))
        rows += 1
    for e, m in enumerate(al.etm):
        if m[s] > 0:
            ok = ok & ~((anti_cnt[e:e + 1] > 0) & (a.eta_dom[e:e + 1] >= 0))
            rows += 1
    # preferred terms of the task over the live counts, then the static
    # symmetric map of the snapshot's pods
    raw = None
    for sks, ws in zip(al.prefsk, al.prefw):
        sk = max(sks[s], 0)
        row = torch.where((a.skdom[sk:sk + 1] >= 0) & (sks[s] >= 0),
                          ws[s] * cnt[sk:sk + 1], zero)
        raw = row if raw is None else raw + row
        rows += 1
    st = torch.zeros_like(raw)
    for c, m in enumerate(al.selm):
        if m[s] != 0:
            st = st + m[s] * a.static_pref[c:c + 1]
            rows += 1
    raw = raw + st
    # min-max normalised over the live nodes to 0..100 (k8s NormalizeScore)
    live = a.live > 0
    mx = torch.where(live, raw, -_BIG).max()
    mn = torch.where(live, raw, _BIG).min()
    span = mx - mn
    q = torch.full_like(span, 100.0) / span.clamp_min(_EPS_DIV)
    norm = torch.where(span > 0, (raw - mn) * q, zero)
    if stats is not None:
        stats["aff_rows"] = stats.get("aff_rows", 0) + rows
    return ok, norm


def aff_commit(a, al: AffLists, s: int, node: int, aff_state, stats=None):
    """Add slot ``s``'s placement on ``node`` to the live counts, in place:
    a domain-membership row for every (selector, key) pair the task
    matches, the cluster total, and the task's own anti terms (the plain
    version of ``pallas_place._aff_commit``)."""
    cnt, tot, anti_cnt = aff_state
    f32 = torch.float32
    dom_at = a.skdom[:, node].tolist()
    rows = 0
    for sk, d in enumerate(dom_at):
        if al.sk_sel[sk] >= 0 and al.skm[sk][s] > 0 and d >= 0:
            cnt[sk:sk + 1] = cnt[sk:sk + 1] + (a.skdom[sk:sk + 1] == d).to(f32)
            tot[sk:sk + 1] = tot[sk:sk + 1] + 1.0
            rows += 1
    for es in al.anti:
        e = es[s]
        if e < 0:
            continue
        d = int(a.eta_dom[e, node])
        if d >= 0:
            anti_cnt[e:e + 1] = anti_cnt[e:e + 1] \
                + (a.eta_dom[e:e + 1] == d).to(f32)
            rows += 1
    if stats is not None:
        stats["aff_commit_rows"] = stats.get("aff_commit_rows", 0) + rows


def place_one(cfg, w, a, sl: SlotLists, s: int, is_tgt: bool, state,
              iota, stats=None):
    """One placement attempt of slot ``s``: the plain version of
    ``pallas_place._make_attempt`` (feasibility, score, lowest-index argmax
    of both views, commit). ``a`` holds the slot rows and node maps under
    the names of :class:`PlacerArgs`; ``state`` = [idle, pipe, pods, gpux,
    aff_cnt, aff_tot, anti_cnt] (None where a part is off) is updated in
    place. Returns (node, mode, card): (-1, MODE_NONE, -1) when no node fits
    now or, with pipelining, in the future."""
    idle, pipe, pods, gpux = state[:4]
    aff_state = state[4:] if sl.aff is not None else None
    gpu = bool(cfg.enable_gpu)
    if stats is not None:
        stats["attempts"] = stats.get("attempts", 0) + 1
    rr = a.resreq[:, s:s + 1]                                      # [R, 1]
    t = sl.tmpl[s]
    sfeas = a.tstat[t:t + 1] > 0
    if not sl.rev[s] > 0:
        sfeas = sfeas & ~(a.blocknr > 0)
    sfeas = sfeas & ~(a.blockall > 0)
    if sl.grp[s] >= 0:
        sfeas = sfeas & (a.orfeas[sl.grp[s]:sl.grp[s] + 1] > 0)
    if not sl.volok[s] > 0:
        sfeas = torch.zeros_like(sfeas)
    if sl.voln[s] >= 0:
        sfeas = sfeas & (iota == sl.voln[s])
    if not is_tgt:
        sfeas = sfeas & ~(a.locked > 0)

    future = (idle + a.relmp - pipe).clamp_min(0.0)
    shared = sfeas & ((a.cnt + pods) < a.maxp)
    if gpu:
        gr = sl.gpu_req[s]
        gidle = a.gidle0 - gpux
        grm = float(np.float32(gr) - np.float32(_EPS_FIT))
        if not gr <= 0:
            shared = shared & (gidle >= grm).any(0, keepdim=True)
    fit_now = (rr <= idle + _EPS_FIT).all(0, keepdim=True)
    fit_fut = (rr <= future + _EPS_FIT).all(0, keepdim=True)

    score = _dyn_score(w, idle, a.alloc, rr)
    score = score + a.tscore[t:t + 1]
    bonus = a.bonus if sl.rev[s] > 0 else torch.zeros_like(a.bonus)
    score = score + (a.nascore[t:t + 1] + bonus)
    hit = (iota == sl.pref[s]) & (sl.pref[s] >= 0)
    score = score + torch.where(hit, 100.0, 0.0)
    if aff_state is not None:
        aff_ok, aff_score = aff_eval(a, sl.aff, s, aff_state, stats)
        shared = shared & aff_ok
        score = score + float(np.float32(cfg.pod_affinity_weight)) * aff_score

    n_now, f_now = _pick(shared & fit_now, score, iota)
    n_fut, f_fut = _pick(shared & fit_fut, score, iota)
    n_now, f_now, n_fut, f_fut = torch.stack(
        [n_now, f_now.to(torch.int32), n_fut,
         f_fut.to(torch.int32)]).tolist()
    do_alloc = bool(f_now)
    do_pipe = (not do_alloc) and bool(f_fut) and bool(cfg.enable_pipelining)
    if not (do_alloc or do_pipe):
        return -1, MODE_NONE, -1
    node = n_now if do_alloc else n_fut
    col = slice(node, node + 1)
    if do_alloc:
        idle[:, col] = idle[:, col] - rr
    else:
        pipe[:, col] = pipe[:, col] + rr
    pods[:, col] = pods[:, col] + 1.0
    card = -1
    if gpu and gr > 0:
        fits = (gidle[:, col] >= grm)[:, 0]
        if bool(fits.any()):
            card = int(torch.argmax(fits.to(torch.uint8)))
            gpux[card, node] = gpux[card, node] + gr
    if aff_state is not None:
        aff_commit(a, sl.aff, s, node, aff_state, stats)
    return node, (MODE_ALLOCATED if do_alloc else MODE_PIPELINED), card


def round_place_plain(cfg, K: int, M: int, args, stats=None):
    """Plain PyTorch version of the round placer (see the module docstring).

    Runs on the device of its arguments. ``stats``, when a dict is given,
    gains ``attempts``: the placement attempts that evaluated the node
    axis, and with pod affinity ``aff_rows`` and ``aff_commit_rows``: the
    [1, N] term rows the attempts read and the commits wrote (the work the
    kernel's bound is computed from). A discarded gang's state, the
    affinity counts too, is put back from a copy taken at the section's
    start."""
    a = unpack_args(cfg, args)
    gpu = bool(cfg.enable_gpu)
    aff = bool(cfg.enable_pod_affinity)
    dev = a.idle.device
    N = a.idle.shape[1]
    KM = K * M
    w = _weights(cfg)
    iota = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    sl = SlotLists.of(a)
    suffix, act = torch.cat([a.suffix, a.active]).tolist()
    ready0, minav, canb, secact, istgt = torch.cat(
        [a.ready0, a.minav, a.canb, a.secact, a.istgt]).tolist()

    state = [a.idle.clone(), a.pipe.clone(), a.pods.clone(),
             a.gpux.clone() if gpu else None]
    state += [a.aff_cnt.clone(), a.aff_tot.clone(), a.anti_cnt.clone()] \
        if aff else [None] * 3
    node_o = [-1] * KM
    mode_o = [MODE_NONE] * KM
    gpu_o = [-1] * KM
    for k in range(K):
        saved = [x.clone() if x is not None else None for x in state]
        n_allocs = n_pipes = 0
        stopped = broke = False
        for m in range(M):
            s = k * M + m
            if not (act[s] > 0 and secact[k] > 0 and not stopped
                    and not broke):
                continue
            node, mode, card = place_one(cfg, w, a, sl, s, istgt[k] > 0,
                                         state, iota, stats)
            placed = mode != MODE_NONE
            if placed:
                node_o[s], mode_o[s], gpu_o[s] = node, mode, card
            n_allocs += mode == MODE_ALLOCATED
            n_pipes += mode == MODE_PIPELINED
            ready_aft = (ready0[k] + n_allocs >= minav[k]
                         if cfg.enable_gang else True)
            stopped = stopped or (placed and ready_aft and suffix[s] > 0
                                  and not canb[k] > 0)
            broke = broke or not placed

        # gang finalize: JobReady / JobPipelined keep, otherwise Discard
        ready = ready0[k] + n_allocs >= minav[k] if cfg.enable_gang else True
        pipelined = ready0[k] + n_allocs + n_pipes >= minav[k]
        if not (ready or pipelined):
            for s in range(k * M, (k + 1) * M):
                node_o[s], mode_o[s], gpu_o[s] = -1, MODE_NONE, -1
            state = saved

    def i32(v: List[int]) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int32, device=dev)

    idle, pipe, pods, gpux = state[:4]
    outs = (i32(node_o), i32(mode_o), i32(gpu_o), idle, pipe, pods)
    return (outs + ((gpux,) if gpu else ())
            + (tuple(state[4:]) if aff else ()))


# --------------------------------------------------------------------------
# the CUDA kernel
# --------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        from ._build import load
        lib = load("round_placer")
        for fn in (lib.round_placer_launch, lib.exchange_probe_launch):
            fn.restype = ctypes.c_int
        lib.round_placer_launch.argtypes = [ctypes.c_void_p] * 4
        lib.exchange_probe_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p,
                                              ctypes.c_void_p]
        _lib = lib
    return _lib


#: blocks of the kernel's cluster (8 or 16 on an H100; 16 is past the
#: portable 8 and needs the card's consent), chosen by chip_smoke.py
#: phase 6's comparison of the two; the largest cluster the kernel takes;
#: threads a block (the source's CBLOCK)
CLUSTER = 16
MAX_CB = 16
CBLOCK = 512
#: shared memory a block can use on an H100 (232,448 bytes), less the
#: 2,048 the kernel may keep in static shared memory (the source's
#: STATIC_SHARED, which its launcher checks against the built kernel)
MAX_SHARED = 232448 - 2048
#: outputs of the C launcher, after the inputs (absent ones as null)
N_OUTS = 10
#: pointer arguments of the C launcher: inputs, outputs, the scratch rows
N_PTRS = len(PlacerArgs._fields) + N_OUTS + 1
#: order of the integer dimensions and flags of the C launcher
DIMS = ("K", "M", "N", "R", "G", "gang", "pipelining", "aff", "SK", "ETA",
        "SEL", "A", "B", "PP", "CB")
#: the C launchers' codes for a cluster the card cannot run, and for a
#: built kernel whose static shared memory is over what MAX_SHARED leaves
#: for it (placement.cuh launch_cluster)
NO_CLUSTER = -1
STATIC_OVER = -2


def cluster_slices(N: int, CB: int) -> List[tuple]:
    """The nodes [lo, hi) block r of a cluster of CB blocks owns: runs of
    ceil(N / CB), the last one shorter, empty past N."""
    cap = -(-N // CB)
    return [(min(r * cap, N), min(r * cap + cap, N)) for r in range(CB)]


def aff_dims(a) -> dict:
    """SK, ETA, SEL, A, B, PP of a launch's affinity arguments (all 0 when
    pod affinity is off)."""
    if a.live is None:
        return dict(aff=0, SK=0, ETA=0, SEL=0, A=0, B=0, PP=0)
    return dict(aff=1, SK=a.skdom.shape[0], ETA=a.eta_dom.shape[0],
                SEL=a.static_pref.shape[0], A=a.aff_sk.shape[0],
                B=a.anti.shape[0], PP=a.prefsk.shape[0])


def aff_list_ints(d: dict) -> int:
    """Ints of shared memory the kernel's per-attempt term lists take
    (placement.cuh aff_list_ints)."""
    if not d["aff"]:
        return 0
    return (2 * d["A"] + 2 * d["B"] + d["ETA"] + 2 * d["PP"] + 2 * d["SEL"]
            + d["SK"])


def shared_bytes(N: int, CB: int, M: int, R: int, G: int, SK: int = 0,
                 list_ints: int = 0) -> int:
    """Dynamic shared memory of each block of one launch (the source's
    smem_words): the block's slice of the live state (idle, pipe [R], pods,
    GPU cards [G] a node), the saved node columns of one section (node id
    + the same 2R + 1 + G values a slot), the section's node, mode and card
    a slot, and with pod affinity the replica of the totals [SK] and one
    attempt's term lists."""
    col = 2 * R + 1 + G
    cap = -(-N // CB)
    return (col * cap + M * (col + 1) + 3 * M + SK + list_ints) * 4


def aff_shapes(a, S: int) -> dict:
    """Expected shape and dtype of each affinity argument of a launch with
    S slots (for the wrappers' layout checks)."""
    if a.live is None:
        return {}
    d = aff_dims(a)
    N = a.idle.shape[1]
    SK, ETA, SEL, A, B, PP = (d[k] for k in ("SK", "ETA", "SEL", "A", "B",
                                             "PP"))
    f, i = torch.float32, torch.int32
    return dict(
        live=((1, N), f), skdom=((SK, N), i), sk_sel=((SK, 1), i),
        eta_sk=((1, ETA), i), eta_dom=((ETA, N), i),
        static_pref=((SEL, N), f), aff_sk=((A, S), i), anti=((B, S), i),
        prefsk=((PP, S), i), prefw=((PP, S), f), skm=((SK, S), f),
        etm=((ETA, S), f), selm=((SEL, S), f), aff_cnt=((SK, N), f),
        aff_tot=((SK, 1), f), anti_cnt=((ETA, N), f))


def check_layout(want: dict, a) -> None:
    """Raise unless every present argument has the device, dtype, shape and
    contiguity ``want`` names."""
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


def _check(cfg, K, M, a: PlacerArgs):
    """Device, dtype, shape and layout of every argument."""
    R, N = a.idle.shape
    KM = K * M
    P = a.tstat.shape[0]
    GR = a.orfeas.shape[0]
    G = a.gidle0.shape[0] if cfg.enable_gpu else 0
    want = dict(
        resreq=((R, KM), torch.float32), gpu_req=((1, KM), torch.float32),
        pref=((1, KM), torch.int32), suffix=((1, KM), torch.int32),
        tmpl=((1, KM), torch.int32), grp=((1, KM), torch.int32),
        voln=((1, KM), torch.int32), volok=((1, KM), torch.int32),
        rev=((1, KM), torch.int32), active=((1, KM), torch.int32),
        ready0=((1, K), torch.int32), minav=((1, K), torch.int32),
        canb=((1, K), torch.int32), secact=((1, K), torch.int32),
        istgt=((1, K), torch.int32),
        tstat=((P, N), torch.float32), tscore=((P, N), torch.float32),
        nascore=((P, N), torch.float32), blocknr=((1, N), torch.float32),
        blockall=((1, N), torch.float32), bonus=((1, N), torch.float32),
        locked=((1, N), torch.float32), orfeas=((GR, N), torch.float32),
        relmp=((R, N), torch.float32), alloc=((R, N), torch.float32),
        cnt=((1, N), torch.float32), maxp=((1, N), torch.float32),
        gidle0=((G, N), torch.float32), idle=((R, N), torch.float32),
        pipe=((R, N), torch.float32), pods=((1, N), torch.float32),
        gpux=((G, N), torch.float32), **aff_shapes(a, KM))
    check_layout(want, a)


def round_place_cuda(cfg, K: int, M: int, args, cb: Optional[int] = None):
    """Launch the CUDA kernel on the current stream (no synchronisation),
    as one cluster of ``cb`` blocks (:data:`CLUSTER` when not given).
    Raises when the card cannot run the cluster."""
    global launches, aff_launches
    a = unpack_args(cfg, args)
    if not a.idle.is_cuda:
        raise ValueError(f"the kernel takes tensors on a CUDA device, not "
                         f"{a.idle.device}")
    _check(cfg, K, M, a)
    gpu = bool(cfg.enable_gpu)
    R, N = a.idle.shape
    G = a.gidle0.shape[0] if gpu else 0
    ad = aff_dims(a)
    CB = CLUSTER if cb is None else cb
    # launch shape: one cluster, per-dim registers, each block's slice of
    # the state, the section's saved columns and one attempt's affinity
    # term lists
    if not 1 <= R <= MAX_R:
        raise ValueError(f"the kernel takes 1..{MAX_R} resource dims, got {R}")
    if not 1 <= CB <= MAX_CB:
        raise ValueError(f"the kernel takes clusters of 1..{MAX_CB} blocks, "
                         f"not {CB}")
    smem = shared_bytes(N, CB, M, R, G, ad["SK"], aff_list_ints(ad))
    if smem > MAX_SHARED:
        raise ValueError(f"N={N}, M={M} need {smem} bytes of shared memory "
                         f"a block at CB={CB}, over the {MAX_SHARED} a "
                         f"block can take")
    KM = K * M
    dev = a.idle.device
    outs = [torch.empty(KM, dtype=torch.int32, device=dev) for _ in range(3)]
    outs += [torch.empty_like(t) if t is not None else None
             for t in (a.idle, a.pipe, a.pods, a.gpux, a.aff_cnt, a.aff_tot,
                       a.anti_cnt)]
    scratch = (torch.empty((2, N), dtype=torch.float32, device=dev)
               if ad["aff"] else None)
    ptrs = (ctypes.c_void_p * N_PTRS)(*[
        t.data_ptr() if t is not None else None
        for t in list(a) + outs + [scratch]])
    dims = dict(K=K, M=M, N=N, R=R, G=G, gang=int(bool(cfg.enable_gang)),
                pipelining=int(bool(cfg.enable_pipelining)), CB=CB, **ad)
    ints = (ctypes.c_int * len(DIMS))(*[dims[k] for k in DIMS])
    weights = (ctypes.c_float * 5)(
        *_weights(cfg), float(np.float32(cfg.pod_affinity_weight)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _library().round_placer_launch(ptrs, ints, weights,
                                        ctypes.c_void_p(stream))
    raise_launch(rc, "round_placer", CB)
    launches += 1
    aff_launches += ad["aff"]
    return tuple(o for o in outs if o is not None)


def raise_launch(rc: int, what: str, CB: int) -> None:
    if rc == NO_CLUSTER:
        raise RuntimeError(f"{what}: the card cannot run a cluster of {CB} "
                           f"blocks (cudaOccupancyMaxActiveClusters is 0)")
    if rc == STATIC_OVER:
        raise RuntimeError(f"{what}: the built kernel keeps more static "
                           f"shared memory than its MAX_SHARED allows for")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def exchange_probe_cuda(CB: int, iters: int, device) -> torch.Tensor:
    """``iters`` cluster exchanges of ``CB`` blocks alone (the kernel's
    pick exchange without the node evaluation), on the current stream; for
    timing the exchange. Returns the int32[1] the probe writes."""
    out = torch.empty(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = _library().exchange_probe_launch(CB, iters,
                                          ctypes.c_void_p(out.data_ptr()),
                                          ctypes.c_void_p(stream))
    raise_launch(rc, "exchange_probe", CB)
    return out


def round_place(cfg, K: int, M: int, args):
    """Place K job sections: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    dev = args[0].device
    if dev.type == "cuda":
        return round_place_cuda(cfg, K, M, args)
    if dev.type == "cpu":
        _check(cfg, K, M, unpack_args(cfg, args))
        return round_place_plain(cfg, K, M, args)
    raise ValueError(f"no round placer for device {dev}")
