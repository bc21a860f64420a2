"""Small built inputs of the placers, one case per rule they must follow.

- :func:`make_inputs` and :data:`CASES`: the round placer
  (``ops/round_placer.py``): GPU cards on and off, gang discard, pipelining
  on releasing capacity, three resources, one section, N not a multiple of
  128.
- :func:`make_dyn_inputs` and :data:`DYN_CASES`: the dynamic-key placer
  (``ops/dyn_placer.py``): gang discard and demotion, a zero-deserved queue
  that flips to overused on its first commit, drf with 3 namespaces, GPU
  requests, the hdrf guard, a short pop budget, padded candidates and
  the sla deadline as an ordering key.
- :func:`make_aff_inputs` and :data:`AFF_CASES`: the pod-affinity step of
  both (``aff=`` of make_inputs and make_dyn_inputs): the first-pod
  escape, own and symmetric required anti-affinity, negative preferred
  weights, no live node, and a gang discard that must take the counts
  back.
- :func:`make_shard_inputs` and :data:`SHARD_CASES`: the shard-local
  candidate search (``ops/shard_placer.py``): ties planted across shards,
  a shard with no feasible row, the preferred node, a volume pin, locks
  and the target job, OR groups, the revocable bonus and taint-prefer
  rows, with GPU cards and without.
- :func:`make_wave_inputs` and :data:`WAVE_CASES`: the wide candidate
  search (``ops/shard_wave.py``): the shard cases with W task columns, and
  shards with fewer feasible rows than the candidate depth.

The CPU tests hold the plain versions against the reference's Pallas
kernels in interpret mode on these inputs, and ``chip_smoke.py`` holds the
CUDA kernels against the plain versions on them; both build them here,
from one definition. Numpy only.
"""

from __future__ import annotations

import numpy as np

F32, I32 = np.float32, np.int32

#: score weights of the placer cases: every score family on
PLACER_WEIGHTS = dict(binpack_weight=0.7, least_allocated_weight=1.0,
                      most_allocated_weight=0.5, balanced_weight=1.0)

#: pod-affinity step cases: knobs of make_aff_inputs; "gang_discard" also
#: sets the placers' big_gangs knob (see aff_placer_knobs)
AFF_CASES = {
    "mixed": dict(),
    "first_pod_escape": dict(escape=True),
    "anti_own_and_symmetric": dict(anti=True),
    "negative_preferred": dict(neg_pref=True),
    "no_live_node": dict(no_live=True),
    "gang_discard": dict(anti=True, escape=True),
}

#: the names of the affinity arguments before the capacity state, and of
#: the live state after it (the order of pallas_place._read_aff_env)
AFF_ENV = ("live", "skdom", "sk_sel", "eta_sk", "eta_dom", "static_pref",
           "aff_sk", "anti", "prefsk", "prefw", "skm", "etm", "selm")
AFF_STATE = ("aff_cnt", "aff_tot", "anti_cnt")


def aff_placer_knobs(case):
    """Placer knobs that go with an affinity case: in the gang-discard case
    gangs may need more tasks than their sections hold, so sections place
    tasks and are then discarded."""
    return dict(big_gangs=True) if case == "gang_discard" else {}


def make_aff_inputs(rng, N, S, SK=6, ETA=3, SEL=4, A=2, B=2, PP=2,
                    escape=False, anti=False, neg_pref=False, no_live=False):
    """The 16 affinity arguments of a launch with S slots over N nodes, as
    a dict by name: (selector, key) pairs over 3 topology keys (some nodes
    lack a key), live counts that are integer-valued and consistent with
    the domains, slot tables with padded (-1) entries. ``escape`` empties
    some pairs (total 0) that tasks match and require; ``anti`` gives tasks
    own anti terms and placed pods anti terms they match; ``neg_pref``
    makes the preferred weights negative; ``no_live`` marks no node live
    (the normalisation's empty span)."""
    n_keys = 3
    key_dom = np.stack([np.where(rng.rand(N) < 0.1, -1,
                                 rng.randint(0, 2 + 3 * k, N))
                        for k in range(n_keys)]).astype(I32)
    sk_sel = rng.randint(0, SEL, SK).astype(I32)
    sk_sel[-1] = -1                                  # a padded pair
    sk_key = rng.randint(0, n_keys, SK)
    skdom = key_dom[sk_key]
    skdom[-1] = -1
    eta_sk = rng.randint(0, SK - 1, ETA).astype(I32)
    eta_sk[-1] = -1                                  # a padded term
    eta_dom = np.where(eta_sk[:, None] >= 0, skdom[np.maximum(eta_sk, 0)],
                       -1).astype(I32)

    def dom_counts(dom, n_pods):
        """Counts of n_pods pods on random nodes, per node's domain."""
        c = np.zeros(N, F32)
        for node in rng.randint(0, N, n_pods):
            if dom[node] >= 0:
                c[dom == dom[node]] += 1.0
        return c

    aff_cnt = np.stack([dom_counts(skdom[k], rng.randint(0, 4))
                        for k in range(SK)])
    if escape:
        aff_cnt[:2] = 0.0                            # nothing placed yet
    aff_tot = np.array([[float(rng.randint(1, 5)) if aff_cnt[k].any() else
                         0.0] for k in range(SK)], F32)
    anti_cnt = np.stack([dom_counts(eta_dom[e], rng.randint(0, 3 if anti
                                                            else 2))
                         for e in range(ETA)])
    static_pref = (rng.randint(-2, 3, (SEL, N)) * 5).astype(F32)
    live = (rng.rand(1, N) < (0.0 if no_live else 0.9)).astype(F32)

    def slots(p, lo, hi, rows):
        return np.where(rng.rand(rows, S) < p, rng.randint(lo, hi,
                                                           (rows, S)),
                        -1).astype(I32)

    aff_sk = slots(0.6 if escape else 0.3, 0, SK - 1, A)
    if escape:
        aff_sk[0] = np.where(rng.rand(S) < 0.7, rng.randint(0, 2, S),
                             aff_sk[0])
    anti_t = slots(0.5 if anti else 0.15, 0, ETA, B)
    prefsk = slots(0.6, 0, SK, PP)
    w = rng.randint(1, 20, (PP, S)).astype(F32)
    prefw = np.where(prefsk >= 0, -w if neg_pref else
                     np.where(rng.rand(PP, S) < 0.3, -w, w), 0.0).astype(F32)
    skm = (rng.rand(SK, S) < (0.7 if escape else 0.4)).astype(F32)
    etm = (rng.rand(ETA, S) < (0.6 if anti else 0.2)).astype(F32)
    etm[-1] = 0.0                                    # the padded term
    selm = (rng.rand(SEL, S) < 0.4).astype(F32)
    return dict(live=live, skdom=skdom, sk_sel=sk_sel[:, None],
                eta_sk=eta_sk[None, :], eta_dom=eta_dom,
                static_pref=static_pref, aff_sk=aff_sk, anti=anti_t,
                prefsk=prefsk, prefw=prefw, skm=skm, etm=etm, selm=selm,
                aff_cnt=aff_cnt.astype(F32), aff_tot=aff_tot,
                anti_cnt=anti_cnt.astype(F32))


def make_inputs(seed, K=8, M=4, N=40, R=2, G=2, GR=2, P=3, gpu=True,
                tight=False, releasing=False, big_gangs=False, aff=None,
                ties=False):
    """Flat round placer arguments (numpy) in the kernel's order. Values
    sit on a 0.25 grid, so scores tie and capacity hits exact fits. With
    ``aff`` (knobs of make_aff_inputs) the affinity arguments join, for a
    launch with cfg.enable_pod_affinity. ``ties`` makes every node a copy
    of one of 4 drawn nodes, so the best score recurs all along the node
    axis (across the slices of a cluster's blocks)."""
    rng = np.random.RandomState(seed)
    KM = K * M

    def grid(*shape, lo=0.0, hi=8.0):
        return (rng.randint(int(lo * 4), int(hi * 4) + 1, size=shape)
                / 4.0).astype(F32)

    def flags(p, *shape):
        return (rng.rand(*shape) < p).astype(I32)

    resreq = grid(R, KM, lo=0.0, hi=3.0)
    gpu_req = np.where(rng.rand(1, KM) < 0.5,
                       rng.randint(1, 8, (1, KM)), 0).astype(F32)
    pref = np.where(rng.rand(1, KM) < 0.2, rng.randint(0, N, (1, KM)),
                    -1).astype(I32)
    suffix = rng.randint(0, 3, (1, KM)).astype(I32)
    tmpl = rng.randint(0, P, (1, KM)).astype(I32)
    grp = np.where(rng.rand(1, KM) < 0.3, rng.randint(0, GR, (1, KM)),
                   -1).astype(I32)
    voln = np.where(rng.rand(1, KM) < 0.1, rng.randint(0, N, (1, KM)),
                    -1).astype(I32)
    volok = flags(0.95, 1, KM)
    rev = flags(0.3, 1, KM)
    active = flags(0.9, 1, KM)
    ready0 = rng.randint(0, 2, (1, K)).astype(I32)
    hi_min = 2 * M if big_gangs else M
    minav = rng.randint(1, hi_min + 1, (1, K)).astype(I32)
    canb = flags(0.5, 1, K)
    secact = flags(0.9, 1, K)
    istgt = flags(0.2, 1, K)
    tstat = (rng.rand(P, N) < 0.85).astype(F32)
    tscore = (rng.randint(0, 5, (P, N)) * 25).astype(F32)
    nascore = (rng.randint(0, 3, (P, N)) * 10).astype(F32)
    blocknr = flags(0.1, 1, N).astype(F32)
    blockall = flags(0.05, 1, N).astype(F32)
    bonus = (flags(0.3, 1, N) * 100).astype(F32)
    locked = flags(0.1, 1, N).astype(F32)
    orfeas = (rng.rand(GR, N) < 0.7).astype(F32)
    alloc = grid(R, N, lo=2.0, hi=8.0)
    alloc[rng.rand(R, N) < 0.05] = 0.0
    idle = np.minimum(alloc, grid(R, N, hi=2.0 if tight else 8.0))
    relmp = grid(R, N, lo=-1.0, hi=6.0 if releasing else 1.0)
    if releasing:
        idle = np.minimum(idle, grid(R, N, hi=0.5))
    cnt = rng.randint(0, 5, (1, N)).astype(F32)
    maxp = rng.randint(3, 9, (1, N)).astype(F32)
    gidle0 = rng.randint(0, 16, (G, N)).astype(F32)
    pipe = grid(R, N, hi=0.5)
    pods = rng.randint(0, 2, (1, N)).astype(F32)
    gpux = rng.randint(0, 3, (G, N)).astype(F32)
    a = make_aff_inputs(rng, N, KM, **aff) if aff is not None else None
    if ties:
        src = rng.randint(0, 4, N)
        (tstat, tscore, nascore, blocknr, blockall, bonus, locked, orfeas,
         relmp, alloc, cnt, maxp, gidle0, idle, pipe, pods, gpux) = (
            np.ascontiguousarray(x[:, src]) for x in (
                tstat, tscore, nascore, blocknr, blockall, bonus, locked,
                orfeas, relmp, alloc, cnt, maxp, gidle0, idle, pipe, pods,
                gpux))
    args = [resreq] + ([gpu_req] if gpu else []) + [
        pref, suffix, tmpl, grp, voln, volok, rev, active,
        ready0, minav, canb, secact, istgt,
        tstat, tscore, nascore, blocknr, blockall, bonus, locked, orfeas,
        relmp, alloc, cnt, maxp] + ([gidle0] if gpu else []) + (
        [a[k] for k in AFF_ENV] if a else []) + [
        idle, pipe, pods] + ([gpux] if gpu else []) + (
        [a[k] for k in AFF_STATE] if a else [])
    return args


#: round placer cases: input shape and knobs
CASES = {
    "gpu_on": dict(gpu=True),
    "gpu_off": dict(gpu=False),
    "gang_discard": dict(gpu=True, tight=True, big_gangs=True),
    "pipelining_on_releasing": dict(gpu=False, releasing=True),
    "three_resources": dict(gpu=True, R=3),
    "one_section": dict(gpu=True, K=1, M=8),
    "n_not_multiple_of_128": dict(gpu=True, N=200, M=6),
}



def _initial_order(flags, d, J):
    """Eligible jobs in the lexicographic order of the dynamic-key plan at
    the inputs' state (float64 numpy: only used to choose candidates)."""
    qid, des, qalloc = d["qid"][0], d["des"], d["qalloc"]
    over = (qalloc > des + 1e-6).any(1)[qid]
    elig = ((d["eligs"][0] > 0) & (d["done"][0] == 0)
            & (d["cursor"][0] < d["npend"][0]) & ~over)
    tot = d["total"][:, 0].astype(np.float64)
    frac = np.where(tot[:, None] > 0, d["jalloc"] / np.maximum(tot, 1e-9)[:, None],
                    0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        qsh = np.where(np.isfinite(des) & (des > 0),
                       qalloc / np.maximum(des, 1e-9), 0.0).max(1) \
            + d["qex"][:, 0]
    cols, si = [], 0
    if flags["drf_ns_order"]:
        nsa = np.stack([(d["jalloc"] * (d["nsc"][s] > 0)).sum(1)
                        for s in range(d["nsc"].shape[0])])
        share = (np.where(tot > 0, nsa / np.maximum(tot, 1e-9), 0.0).max(1)
                 / np.maximum(d["nsw"][0], 1.0))
        cols.append(np.array([share[d["nsm"][:, j].argmax()]
                              if d["nsm"][:, j].any() else 0.0
                              for j in range(J)]))
    else:
        cols.append(d["skeys"][si]); si += 1
    cols.append(d["skeys"][si]); si += 1
    cols.append(qsh[qid])
    if "hcols" in d:
        cols += list(d["hcols"])
    cols += [d["skeys"][si], d["skeys"][si + 1]]; si += 2
    if flags["sla_job_order"]:
        cols.append(d["skeys"][si]); si += 1
    cols.append(((d["rdy0"][0] + d["acount"][0] >= d["minav"][0])
                 & (d["minav"][0] > 0)).astype(np.float64))
    if flags["drf_job_order"]:
        cols.append(np.where(d["validf"][0] > 0, frac.max(0), np.inf))
    else:
        cols.append(d["skeys"][si]); si += 1
    cols.append(d["skeys"][si])
    order = np.lexsort([np.arange(J)] + cols[::-1])
    return [int(j) for j in order if elig[j]]


#: dynamic-key placer cases: cfg flags and input shape/knobs
DYN_CASES = {
    "drf": dict(drf_job_order=True),
    "drf_ns3": dict(drf_job_order=True, drf_ns_order=True, S=3),
    "proportion": dict(deserved="finite"),
    "zero_deserved": dict(deserved="zero"),
    "gpu_drf": dict(drf_job_order=True, gpu=True),
    "gang_discard_demote": dict(drf_job_order=True, tight=True,
                                big_gangs=True, releasing=True),
    "hdrf_guard": dict(drf_job_order=True, enable_hdrf=True, NH=4),
    "kmax_short": dict(drf_job_order=True, kmax=3),
    "padded_candidates": dict(drf_job_order=True, n_elig=3),
    "sla_deadline": dict(drf_job_order=True, sla_job_order=True,
                         deserved="finite"),
}

DYN_FLAGS = ("drf_job_order", "drf_ns_order", "enable_hdrf", "enable_gpu",
             "enable_pod_affinity", "sla_job_order")


def make_dyn_inputs(seed, C=4, KP=12, M=4, J=24, Q=3, S=2, N=40, R=2, G=2,
                    GR=2, P=3, NH=0, gpu=False, drf_job_order=False,
                    drf_ns_order=False, enable_hdrf=False, deserved="inf",
                    tight=False, big_gangs=False, releasing=False, kmax=None,
                    n_elig=None, aff=None, sla_job_order=False):
    """(flags, flat numpy args in the dyn placer's order). Values sit on a
    0.25 grid (keys tie, capacity hits exact fits, every sum is exact);
    candidates are the C lexicographically smallest eligible jobs at the
    inputs' state, as the cycle chooses them. With ``aff`` (knobs of
    make_aff_inputs) the affinity arguments join, for a launch with
    cfg.enable_pod_affinity (flagged in the returned flags). With
    ``sla_job_order`` the sla deadline is a static key after queue id and
    -priority: +inf for most jobs, a few seconds before now for some, as
    the sla plugin encodes it."""
    rng = np.random.RandomState(seed)
    CM = C * M
    flags = dict(drf_job_order=drf_job_order, drf_ns_order=drf_ns_order,
                 enable_hdrf=enable_hdrf, enable_gpu=gpu,
                 enable_pod_affinity=aff is not None,
                 sla_job_order=sla_job_order)

    def grid(*shape, lo=0.0, hi=8.0):
        return (rng.randint(int(lo * 4), int(hi * 4) + 1, size=shape)
                / 4.0).astype(F32)

    def flags_p(p, *shape):
        return (rng.rand(*shape) < p).astype(I32)

    d = {}
    # per job
    d["qid"] = rng.randint(0, Q, (1, J)).astype(I32)
    ns = rng.randint(0, S, J)
    d["npend"] = rng.randint(1, M + 1, (1, J)).astype(I32)
    d["cursor"] = np.minimum(rng.randint(0, 2, (1, J)),
                             d["npend"] - 1).astype(I32)
    hi_min = 2 * M if big_gangs else M
    d["minav"] = rng.randint(1, hi_min + 1, (1, J)).astype(I32)
    d["rdy0"] = rng.randint(0, 2, (1, J)).astype(I32)
    d["eligs"] = flags_p(0.9, 1, J)
    if n_elig is not None:
        d["eligs"][:] = 0
        d["eligs"][0, rng.choice(J, n_elig, replace=False)] = 1
    d["validf"] = flags_p(0.95, 1, J).astype(F32)
    d["canb"] = flags_p(0.3, 1, J)
    d["done"] = flags_p(0.1, 1, J)
    d["popped"] = d["done"] | flags_p(0.2, 1, J)
    d["jready"] = flags_p(0.2, 1, J)
    d["jpipe"] = flags_p(0.1, 1, J)
    d["acount"] = rng.randint(0, 2, (1, J)).astype(I32)
    d["jalloc"] = grid(R, J, hi=4.0) * (rng.rand(1, J) < 0.6)
    if deserved == "zero":
        # queue 0 holds nothing yet: its first commit flips it overused
        d["jalloc"][:, d["qid"][0] == 0] = 0.0
    d["total"] = (grid(R, 1, lo=40.0, hi=80.0)).astype(F32)
    d["qalloc"] = np.stack([d["jalloc"][:, d["qid"][0] == q].sum(1)
                            for q in range(Q)]).astype(F32)
    if deserved == "inf":
        d["des"] = np.full((Q, R), np.inf, F32)
    elif deserved == "zero":
        d["des"] = np.full((Q, R), np.inf, F32)
        d["des"][0] = 0.0
    else:
        d["des"] = d["qalloc"] + grid(Q, R, lo=1.0, hi=6.0)
        d["des"][Q - 1] = np.inf
    d["qex"] = np.zeros((Q, 1), F32)
    d["kmax"] = np.full((1, 1), KP if kmax is None else kmax, I32)
    d["tgt"] = np.full((1, 1), rng.randint(-1, J), I32)
    NKS = 6 - int(drf_ns_order) - int(drf_job_order)
    skeys = [grid(J, hi=1.0) for _ in range(NKS)]
    if not drf_ns_order:
        skeys[0] = np.zeros(J, F32)              # ns_share[namespace]
    skeys[1 - int(drf_ns_order)] = ns.astype(F32)   # namespace id
    if sla_job_order:
        # queue id and -priority as the cycle makes them (one priority),
        # so jobs of a queue tie up to the deadline that follows them,
        # relative to now
        skeys[2 - int(drf_ns_order)] = d["qid"][0].astype(F32)
        skeys[3 - int(drf_ns_order)] = np.zeros(J, F32)
        skeys.insert(4 - int(drf_ns_order), np.where(
            rng.rand(J) < 0.3, grid(J, lo=-4.0, hi=0.0), np.inf))
    d["skeys"] = np.stack(skeys).astype(F32)
    if drf_ns_order:
        nsm = (np.arange(S)[:, None] == ns[None, :])
        d["nsm"] = nsm.astype(F32)
        d["nsc"] = (nsm & (d["validf"] > 0)).astype(F32)
        d["nsw"] = rng.randint(1, 4, (1, S)).astype(F32)
    if enable_hdrf:
        hq = grid(NH, Q, hi=1.0)
        d["hcols"] = hq[:, d["qid"][0]].astype(F32)
    d["qoh"] = (np.arange(Q)[:, None] == d["qid"]).astype(F32)

    order = _initial_order(flags, d, J)
    cand = np.full(C, -1, I32)
    cand[:min(C, len(order))] = order[:C]
    d["cand"] = cand[None, :]
    d["cslot"] = np.full((1, J), -1, I32)
    for c, j in enumerate(cand):
        if j >= 0:
            d["cslot"][0, j] = c

    # per slot of the candidates' task tables
    npend_c = np.where(cand >= 0, d["npend"][0][np.maximum(cand, 0)], 0)
    tidok = (np.arange(M)[None, :] < npend_c[:, None])
    nbe = tidok & (rng.rand(C, M) < 0.9)
    nb = (tidok & nbe).astype(I32)
    suffix = nb[:, ::-1].cumsum(1)[:, ::-1] - nb
    slot = dict(
        resreq=grid(R, CM, lo=0.0, hi=3.0),
        gpu_req=np.where(rng.rand(1, CM) < 0.5, rng.randint(1, 8, (1, CM)),
                         0).astype(F32),
        pref=np.where(rng.rand(1, CM) < 0.2, rng.randint(0, N, (1, CM)),
                      -1).astype(I32),
        suffix=suffix.reshape(1, CM).astype(I32),
        tmpl=rng.randint(0, P, (1, CM)).astype(I32),
        grp=np.where(rng.rand(1, CM) < 0.3, rng.randint(0, GR, (1, CM)),
                     -1).astype(I32),
        voln=np.where(rng.rand(1, CM) < 0.1, rng.randint(0, N, (1, CM)),
                      -1).astype(I32),
        volok=flags_p(0.95, 1, CM), rev=flags_p(0.3, 1, CM),
        tidok=tidok.reshape(1, CM).astype(I32),
        nbe=nbe.reshape(1, CM).astype(I32))
    # node maps and state, as make_inputs makes them
    alloc = grid(R, N, lo=2.0, hi=8.0)
    alloc[rng.rand(R, N) < 0.05] = 0.0
    idle = np.minimum(alloc, grid(R, N, hi=2.0 if tight else 8.0))
    relmp = grid(R, N, lo=-1.0, hi=6.0 if releasing else 1.0)
    if releasing:
        idle = np.minimum(idle, grid(R, N, hi=0.5))
    node = dict(
        tstat=(rng.rand(P, N) < 0.85).astype(F32),
        tscore=(rng.randint(0, 5, (P, N)) * 25).astype(F32),
        nascore=(rng.randint(0, 3, (P, N)) * 10).astype(F32),
        blocknr=flags_p(0.1, 1, N).astype(F32),
        blockall=flags_p(0.05, 1, N).astype(F32),
        bonus=(flags_p(0.3, 1, N) * 100).astype(F32),
        locked=flags_p(0.1, 1, N).astype(F32),
        orfeas=(rng.rand(GR, N) < 0.7).astype(F32),
        relmp=relmp, alloc=alloc,
        cnt=rng.randint(0, 5, (1, N)).astype(F32),
        maxp=rng.randint(3, 9, (1, N)).astype(F32),
        gidle0=rng.randint(0, 16, (G, N)).astype(F32),
        idle=idle, pipe=grid(R, N, hi=0.5),
        pods=rng.randint(0, 2, (1, N)).astype(F32),
        gpux=rng.randint(0, 3, (G, N)).astype(F32))
    if aff is not None:
        node.update(make_aff_inputs(rng, N, CM, **aff))

    order_names = (
        "resreq gpu_req pref suffix tmpl grp voln volok rev tidok nbe cand "
        "cslot skeys hcols qid qoh nsm nsc nsw minav rdy0 npend eligs "
        "validf canb des qex total kmax tgt tstat tscore nascore blocknr "
        "blockall bonus locked orfeas relmp alloc cnt maxp gidle0 "
        + " ".join(AFF_ENV) + " idle pipe pods gpux " + " ".join(AFF_STATE)
        + " done popped jready jpipe cursor acount jalloc qalloc"
    ).split()
    optional = {"gpu_req": gpu, "gidle0": gpu, "gpux": gpu,
                "hcols": enable_hdrf, "nsm": drf_ns_order,
                "nsc": drf_ns_order, "nsw": drf_ns_order,
                **{k: aff is not None for k in AFF_ENV + AFF_STATE}}
    src = {**d, **slot, **node}
    args = [np.ascontiguousarray(src[k]) for k in order_names
            if optional.get(k, True)]
    return flags, args


#: shard candidate cases: knobs of make_shard_inputs
SHARD_CASES = {
    "mixed": dict(),
    "ties_across_shards": dict(ties=True),
    "infeasible_shard": dict(infeasible_shard=True),
    "nothing_feasible": dict(nothing=True),
    "preferred_node": dict(pref=True),
    "volume_pin": dict(volpin=True),
    "locked_target": dict(locked_target=True),
    "or_group_revocable": dict(or_group=True, rev=True),
}

#: wide candidate search cases (make_wave_inputs): the shard cases, and a
#: shard with fewer feasible rows than the candidate depth
WAVE_CASES = dict(SHARD_CASES, fewer_than_depth=dict(few=True))


def make_shard_inputs(seed, D=2, NL=48, R=2, P=3, GR=2, G=2, gpu=False,
                      ties=False, infeasible_shard=False, nothing=False,
                      pref=False, volpin=False, locked_target=False,
                      or_group=False, rev=False, few=False):
    """The shard placer's full-width arguments (``shard_placer.ShardArgs``
    order, GPU entries only with ``gpu``) over D shards of NL rows.

    ``ties`` makes every shard a copy of shard 0 (equal scores in every
    shard, so the combine must keep the lowest global row and sum the raw
    counts); ``infeasible_shard`` leaves shard 1 (the last with D = 1) no
    feasible row; ``nothing`` leaves no row feasible anywhere; ``pref``,
    ``volpin``, ``locked_target``, ``or_group`` and ``rev`` set the task's
    preferred node, volume pin, the locks and the target flag, an OR group
    and the revocable bonus; ``few`` leaves each shard two rows the task's
    template admits. Without a knob each gate is drawn at random."""
    rng = np.random.RandomState(seed)
    N = D * NL
    n = NL if ties else N          # rows drawn; tiled D times with ties

    def grid(rows, lo=0.0, hi=8.0):
        return (rng.randint(int(lo * 4), int(hi * 4) + 1, (rows, n))
                / 4.0).astype(F32)

    def flags(p, rows=1):
        return (rng.rand(rows, n) < p).astype(F32)

    alloc = grid(R, lo=2.0, hi=8.0)
    alloc[rng.rand(R, n) < 0.05] = 0.0
    rows = dict(
        tstat=(rng.rand(P, n) < 0.85).astype(F32),
        tscore=(rng.randint(0, 3, (P, n)) * 25).astype(F32),
        nascore=(rng.randint(0, 2, (P, n)) * 10).astype(F32),
        blocknr=flags(0.1), blockall=flags(0.05),
        bonus=(flags(0.3) * 100).astype(F32),
        locked=flags(0.3 if locked_target else 0.05),
        orfeas=(rng.rand(GR, n) < 0.7).astype(F32),
        rel=grid(R, hi=2.0), pip=grid(R, hi=1.5), alloc=alloc,
        cnt=rng.randint(0, 5, (1, n)).astype(F32),
        maxp=rng.randint(3, 9, (1, n)).astype(F32),
        gidle0=rng.randint(0, 16, (G, n)).astype(F32),
        idle=np.minimum(alloc, grid(R, hi=6.0)),
        pipe=grid(R, hi=0.5),
        pods=rng.randint(0, 2, (1, n)).astype(F32),
        gpux=rng.randint(0, 3, (G, n)).astype(F32))
    if ties:
        # few distinct rows, so equal scores recur inside and across shards
        for k, v in rows.items():
            rows[k] = np.tile(v[:, rng.randint(0, 4, NL)], (1, D))
    tmpl = int(rng.randint(P))
    if infeasible_shard:
        d = 1 if D > 1 else 0
        rows["tstat"][tmpl, d * NL:(d + 1) * NL] = 0.0
    if nothing:
        rows["tstat"][tmpl] = 0.0
    if few:
        keep = np.zeros(N, bool)
        for d in range(D):
            keep[d * NL + rng.choice(NL, 2, replace=False)] = True
        rows["tstat"][tmpl] = keep.astype(F32)
    req = (rng.randint(1, 9, (1, R)) / 4.0).astype(F32)
    if gpu:
        req = np.concatenate([req, [[F32(rng.randint(0, 9))]]], 1)
    grp = int(rng.randint(GR)) if or_group or rng.rand() < 0.3 else -1
    task = np.array([[
        int(rng.randint(N)) if pref or rng.rand() < 0.2 else -1,
        tmpl, grp,
        int(rng.randint(N)) if volpin or rng.rand() < 0.1 else -1,
        int(rng.rand() < 0.97),
        int(rev or rng.rand() < 0.3)]], I32)
    istgt = np.array([[int(locked_target and rng.rand() < 0.5)]], I32)
    names = ("tstat", "tscore", "nascore", "blocknr", "blockall", "bonus",
             "locked", "orfeas", "rel", "pip", "alloc", "cnt", "maxp")
    args = [req, task, istgt] + [rows[k] for k in names]
    args += [rows["gidle0"]] if gpu else []
    args += [rows["idle"], rows["pipe"], rows["pods"]]
    args += [rows["gpux"]] if gpu else []
    return [np.ascontiguousarray(a) for a in args]


def make_wave_inputs(seed, D=2, W=4, NL=48, R=2, gpu=False, **knobs):
    """The wide candidate search's full-width arguments
    (``shard_wave.WaveArgs`` order): the node rows and the first column's
    task of :func:`make_shard_inputs` with the same knobs, then W - 1 more
    tasks on the same template, OR group and target flag (so the knobs'
    gates hold for every column), each with its own request, preferred
    node, volume pin and revocable flag, drawn as make_shard_inputs draws
    them (a preferred node and a volume pin on every column when the
    knobs ask for them)."""
    args = make_shard_inputs(seed, D=D, NL=NL, R=R, gpu=gpu, **knobs)
    req, task, istgt = args[:3]
    rng = np.random.RandomState(seed + 7919)
    N = D * NL
    reqs, tasks = [req[0]], [task[0]]
    for _ in range(W - 1):
        r = (rng.randint(1, 9, R) / 4.0).astype(F32)
        if gpu:
            r = np.concatenate([r, [F32(rng.randint(0, 9))]])
        reqs.append(r)
        tasks.append(np.array([
            int(rng.randint(N)) if knobs.get("pref") or rng.rand() < 0.2
            else -1,
            task[0, 1], task[0, 2],
            int(rng.randint(N)) if knobs.get("volpin") or rng.rand() < 0.1
            else -1,
            int(rng.rand() < 0.97),
            int(knobs.get("rev", False) or rng.rand() < 0.3)], I32))
    wreq = np.stack(reqs, 1).astype(F32)                      # [R(+1), W]
    wtask = np.concatenate([np.stack(tasks, 1),
                            np.full((1, W), istgt[0, 0], I32)], 0)
    return [np.ascontiguousarray(a) for a in [wreq, wtask] + args[3:]]

