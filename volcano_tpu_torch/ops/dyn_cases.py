"""Small built inputs of the dynamic-key placer (``ops/dyn_placer.py``),
one case per rule it must follow: gang discard and demotion, a
zero-deserved queue that flips to overused on its first commit, drf with
3 namespaces, GPU requests, the hdrf guard, a short pop budget and padded
candidates.

The CPU tests hold the plain version against the reference's Pallas
kernel in interpret mode on these inputs, and ``chip_smoke.py`` holds the
CUDA kernel against the plain version on them; both build them here, from
one definition. Numpy only.
"""

from __future__ import annotations

import numpy as np

F32, I32 = np.float32, np.int32

#: score weights of the placer cases: every score family on
PLACER_WEIGHTS = dict(binpack_weight=0.7, least_allocated_weight=1.0,
                      most_allocated_weight=0.5, balanced_weight=1.0)



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
}

DYN_FLAGS = ("drf_job_order", "drf_ns_order", "enable_hdrf", "enable_gpu")


def make_dyn_inputs(seed, C=4, KP=12, M=4, J=24, Q=3, S=2, N=40, R=2, G=2,
                    GR=2, P=3, NH=0, gpu=False, drf_job_order=False,
                    drf_ns_order=False, enable_hdrf=False, deserved="inf",
                    tight=False, big_gangs=False, releasing=False, kmax=None,
                    n_elig=None):
    """(flags, flat numpy args in the dyn placer's order). Values sit on a
    0.25 grid (keys tie, capacity hits exact fits, every sum is exact);
    candidates are the C lexicographically smallest eligible jobs at the
    inputs' state, as the cycle chooses them."""
    rng = np.random.RandomState(seed)
    CM = C * M
    flags = dict(drf_job_order=drf_job_order, drf_ns_order=drf_ns_order,
                 enable_hdrf=enable_hdrf, enable_gpu=gpu)

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

    order_names = (
        "resreq gpu_req pref suffix tmpl grp voln volok rev tidok nbe cand "
        "cslot skeys hcols qid qoh nsm nsc nsw minav rdy0 npend eligs "
        "validf canb des qex total kmax tgt tstat tscore nascore blocknr "
        "blockall bonus locked orfeas relmp alloc cnt maxp gidle0 idle pipe "
        "pods gpux done popped jready jpipe cursor acount jalloc qalloc"
    ).split()
    optional = {"gpu_req": gpu, "gidle0": gpu, "gpux": gpu,
                "hcols": enable_hdrf, "nsm": drf_ns_order,
                "nsc": drf_ns_order, "nsw": drf_ns_order}
    src = {**d, **slot, **node}
    args = [np.ascontiguousarray(src[k]) for k in order_names
            if optional.get(k, True)]
    return flags, args
