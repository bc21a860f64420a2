"""Shard-local candidate search: one placement attempt over each shard's rows.

Port of ``volcano_tpu/ops/pallas_place.make_shard_candidate_placer`` (the
Pallas ``_shard_cand_kernel``). The sharded allocate cycle
(``allocate_scan.make_allocate_cycle`` with a node mesh) keeps pops,
fairness keys and commits in plain tensor code and delegates each
placement attempt's feasibility -> score -> local argmax to this function,
once per shard: the node axis of N rows splits into D shards of NL = N / D
rows, shard d owning the global rows [d * NL, (d + 1) * NL). Each shard
returns, for the "now" view (fit on idle) and the "future" view (fit on
future idle):

- its best score (``NEG`` when no row is feasible),
- the lowest GLOBAL row at that score (the shard's first row when no row is
  feasible: every row ties at ``NEG``),
- whether any row is feasible (0 / 1),
- the RAW count of feasible rows at the best score.

:func:`combine` reduces the D candidates of a view to the winner
``select.best_node`` returns on the full axis, and the raw tie count at the
global maximum (``select.tie_count`` applies ``max(n - 1, 0)`` to it). The
cycle reads that combined triple from the candidates it is given
(``ShardCandidates.best_idx``, ``best_found``, ``best_ties``).

The functions:

- :func:`shard_candidates_plain`: the plain PyTorch version of one shard's
  launch, in the reference's argument order (``off`` is the shard's first
  global row), line by line ``_shard_cand_kernel``;
  :func:`shard_candidates_plain_all` runs it on every shard, and
  :func:`shard_candidates_plain_combined` adds :func:`combine`'s triple;
- :func:`shard_candidates_cuda`: one launch of the hand-written CUDA kernel
  (``csrc/shard_candidates.cu``) over all D shards of a device, a grid of
  blocks of ROWS rows each reading the global [.., N] tensors in place,
  whose last block merges the blocks' partials and combines the shards,
  so the triple comes out of the same launch;
- :func:`shard_candidates`: the wrapper the cycle calls: the kernel for
  CUDA tensors, the plain version shard by shard and :func:`combine` for
  CPU tensors.

Arguments of the wrapper (node axis last, full width N; ``*`` only when
``cfg.enable_gpu``)::

    req f32[1, R (+1 *)]   the task's request, then its GPU request
    task i32[1, 6]         pref, tmpl (clamped to >= 0), grp, voln, volok, rev
    istgt i32[1, 1]        the popped job is the reservation target
    tstat, tscore, nascore f32[P, N], blocknr, blockall, bonus, locked
    f32[1, N], orfeas f32[GR, N], rel, pip, alloc f32[R, N], cnt, maxp
    f32[1, N], *gidle0 f32[G, N], idle, pipe f32[R, N], pods f32[1, N],
    *gpux f32[G, N]

The per-task values stay on the device: the cycle gathers them for a pop's
slots once, and the kernel reads them from device memory, so an attempt
never waits for the host.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import launch_record
from .round_placer import _EPS_FIT, MAX_R, NEG, _dyn_score, _weights, \
    check_layout

#: launches of the CUDA kernel since the count was last set to 0 (one per
#: attempt of the sharded cycle, covering every shard of the device)
launches = 0
#: pops of the sharded allocate cycle (either version), set by the cycle
pops = 0

#: the per-task integer fields of ``task``, in order
TASK_FIELDS = ("pref", "tmpl", "grp", "voln", "volok", "rev")


class ShardArgs(NamedTuple):
    req: torch.Tensor
    task: torch.Tensor
    istgt: torch.Tensor
    tstat: torch.Tensor
    tscore: torch.Tensor
    nascore: torch.Tensor
    blocknr: torch.Tensor
    blockall: torch.Tensor
    bonus: torch.Tensor
    locked: torch.Tensor
    orfeas: torch.Tensor
    rel: torch.Tensor
    pip: torch.Tensor
    alloc: torch.Tensor
    cnt: torch.Tensor
    maxp: torch.Tensor
    gidle0: Optional[torch.Tensor]
    idle: torch.Tensor
    pipe: torch.Tensor
    pods: torch.Tensor
    gpux: Optional[torch.Tensor]


#: the node-axis inputs, in order (the reference's env refs, then the state)
NODE_FIELDS = ShardArgs._fields[3:]


class ShardCandidates(NamedTuple):
    """Per-shard candidates, row 0 the "now" view, row 1 the "future" view,
    and the D shards combined (:func:`combine`), None where not computed."""
    score: torch.Tensor   # f32[2, D]
    idx: torch.Tensor     # i32[2, D] global row
    found: torch.Tensor   # i32[2, D]
    ties: torch.Tensor    # i32[2, D] raw count at the shard's best
    best_idx: Optional[torch.Tensor] = None     # i32[2] global winner
    best_found: Optional[torch.Tensor] = None   # bool[2]
    best_ties: Optional[torch.Tensor] = None    # i32[2] raw, at the best


def unpack_args(cfg, args) -> ShardArgs:
    """Name the flat argument list (GPU entries only with cfg.enable_gpu)."""
    it = iter(args)
    gpu = bool(cfg.enable_gpu)
    vals = {f: (next(it) if gpu or f not in ("gidle0", "gpux") else None)
            for f in ShardArgs._fields}
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} arguments too many for the placer")
    return ShardArgs(**vals)


# --------------------------------------------------------------------------
# the plain version: one shard, the reference's argument order
# --------------------------------------------------------------------------

class RowTask(NamedTuple):
    """Tasks' scalars for :func:`row_eval`, each shaped to broadcast against
    the rows (``rr`` with the R resource dims first)."""
    rr: torch.Tensor               # f32 [R, ..]
    gq: Optional[torch.Tensor]     # f32 [1, ..] GPU request, None: no check
    pref: torch.Tensor             # i32 [1, ..]
    grp: torch.Tensor
    voln: torch.Tensor
    volok: torch.Tensor            # bool [1, ..]
    rev: torch.Tensor
    istgt: torch.Tensor


def row_eval(cfg, t: RowTask, rows, v: ShardArgs):
    """Feasibility in the now and future views, and the score, of tasks on
    node rows: the column arithmetic of ``_shard_cand_kernel`` and
    ``_shard_wave_kernel`` before their picks, op for op. ``rows`` holds
    global row numbers [1, ..]; each node field of ``v`` holds its values
    at those rows, [k, ..] (``tstat``, ``tscore``, ``nascore`` at the task's
    template row and ``orfeas`` at its OR group's row, k = 1; ``req``,
    ``task`` and ``istgt`` unused). Returns (score, feas_now, feas_fut),
    [1, ..] each. The plain kernels call it on a shard's rows and the
    wavefront's exact rescore on gathered rows, so both give the same bits
    for the same row."""
    # static feasibility: the node_ok conjunction of the scan branch
    sfeas = v.tstat > 0
    sfeas = sfeas & ~((v.blocknr > 0) & ~t.rev) & ~(v.blockall > 0)
    sfeas = sfeas & ((v.orfeas > 0) | (t.grp < 0))
    sfeas = sfeas & t.volok & ((t.voln < 0) | (rows == t.voln))
    sfeas = sfeas & (~(v.locked > 0) | t.istgt)

    # scan association: ((idle + releasing) - pipelined) - pipe_extra
    future = (v.idle + v.rel - v.pip - v.pipe).clamp_min(0.0)
    pods_ok = (v.cnt + v.pods) < v.maxp
    shared = sfeas & pods_ok
    if t.gq is not None:
        gidle = v.gidle0 - v.gpux
        gpu_ok = (t.gq <= 0) | (gidle >= t.gq - _EPS_FIT).any(0, keepdim=True)
        shared = shared & gpu_ok
    fit_now = (t.rr <= v.idle + _EPS_FIT).all(0, keepdim=True)
    fit_fut = (t.rr <= future + _EPS_FIT).all(0, keepdim=True)

    # the reference's float32 addition order (see round_placer.place_one)
    zero = torch.zeros((), dtype=torch.float32, device=rows.device)
    score = _dyn_score(_weights(cfg), v.idle, v.alloc, t.rr)
    score = score + v.tscore
    score = score + (v.nascore + torch.where(t.rev, v.bonus, zero))
    score = score + torch.where((t.pref >= 0) & (rows == t.pref),
                                torch.full((), 100.0, device=rows.device),
                                zero)
    return score, shared & fit_now, shared & fit_fut


def shard_scores(cfg, NL: int, args):
    """The score row and the now / future feasibility rows [1, NL] of one
    shard (the part of ``_shard_cand_kernel`` before its picks), with the
    shard's global row numbers and first row. ``args`` as for
    :func:`shard_candidates_plain`."""
    gpu = bool(cfg.enable_gpu)
    it = iter(args)
    nxt = lambda: next(it)   # noqa: E731
    rr_col = nxt()
    gq = nxt() if gpu else None
    pref, tmpl, grp, voln, volok, rev, istgt, off = (nxt() for _ in range(8))
    tstat, tscore, nascore = nxt(), nxt(), nxt()
    blocknr, blockall, bonus, locked = nxt(), nxt(), nxt(), nxt()
    orfeas, rel, pip, alo, cnt, maxp = (nxt() for _ in range(6))
    gid0 = nxt() if gpu else None
    idle, pipe, podsx = nxt(), nxt(), nxt()
    gpux = nxt() if gpu else None
    dev = idle.device
    iota_n = torch.arange(NL, dtype=torch.int32, device=dev)[None, :] + off
    trow = tmpl.reshape(1).long()
    orrow = grp.reshape(1).long().clamp_min(0)
    t = RowTask(rr_col, gq, pref, grp, voln, volok > 0, rev > 0, istgt > 0)
    v = ShardArgs(
        None, None, None, tstat.index_select(0, trow),
        tscore.index_select(0, trow), nascore.index_select(0, trow),
        blocknr, blockall, bonus, locked, orfeas.index_select(0, orrow),
        rel, pip, alo, cnt, maxp, gid0, idle, pipe, podsx, gpux)
    score, feas_now, feas_fut = row_eval(cfg, t, iota_n, v)
    return score, feas_now, feas_fut, iota_n, off


def shard_candidates_plain(cfg, NL: int, R: int, G: int, GR: int, args):
    """One attempt over one shard's NL rows: the plain version of
    ``pallas_place._shard_cand_kernel``, in its argument order::

        rr f32[R, 1], *gq f32[1, 1], pref, tmpl, grp, voln, volok, rev,
        istgt, off i32[1, 1], tstat, tscore, nascore f32[P, NL], blocknr,
        blockall, bonus, locked f32[1, NL], orfeas f32[GR, NL], rel, pip,
        alloc f32[R, NL], cnt, maxp f32[1, NL], *gidle0 f32[G, NL], idle,
        pipe f32[R, NL], pods f32[1, NL], *gpux f32[G, NL]

    Returns the 8 candidates, each [1, 1]: score, global index, found and
    raw ties of the now view, then of the future view. (R, G and GR are
    the reference's static shape arguments; the tensors carry them.)"""
    score, feas_now, feas_fut, iota_n, off = shard_scores(cfg, NL, args)
    big_i = off + NL            # sentinel past this shard's rows

    def pick(feas):
        masked = torch.where(feas, score, torch.full_like(score, NEG))
        best = masked.max(1, keepdim=True).values
        idx = torch.where(masked == best, iota_n, big_i).min(
            1, keepdim=True).values
        fn = feas.to(torch.int32).max(1, keepdim=True).values
        tie = ((masked == best) & feas).sum(1, keepdim=True,
                                            dtype=torch.int32)
        return best, idx, fn, tie

    return pick(feas_now) + pick(feas_fut)


def shard_args_of(cfg, D: int, a: ShardArgs, d: int):
    """Shard d's arguments in the reference's order, from the wrapper's
    full-width arguments (views of them; the plain version needs no
    contiguity)."""
    R, N = a.idle.shape
    NL = N // D
    lo, hi = d * NL, (d + 1) * NL
    gpu = bool(cfg.enable_gpu)
    i32 = torch.int32
    out = [a.req[0, :R].reshape(R, 1)]
    if gpu:
        out.append(a.req[:, R:R + 1])
    out += [a.task[:, k:k + 1] for k in range(len(TASK_FIELDS))]
    out += [a.istgt, torch.full((1, 1), lo, dtype=i32, device=a.idle.device)]
    out += [getattr(a, f)[:, lo:hi] for f in NODE_FIELDS
            if getattr(a, f) is not None]
    return out


# --------------------------------------------------------------------------
# the cross-shard combine
# --------------------------------------------------------------------------

def combine(c: ShardCandidates, N: int):
    """Per view, the D candidates -> (global winner i32[2], found bool[2],
    raw ties i32[2]): the row ``select.best_node`` returns on the full axis
    (0 when no row is feasible), and the raw tie count at the global maximum
    (the reference's ``_combine``, allocate_scan.py:884-897). Float32 max is
    exact, the lowest global row survives a min over the shard minima, and
    raw tie counts sum only over the shards at the global maximum."""
    fnb = c.found > 0
    msc = torch.where(fnb, c.score, NEG)
    gmax = msc.max(1, keepdim=True).values
    at = fnb & (msc == gmax)
    found = fnb.any(1)
    idx = torch.where(at, c.idx, N).min(1).values
    idx = torch.where(found, idx, 0)
    ties = torch.where(at, c.ties, 0).sum(1, dtype=torch.int32)
    return idx, found, ties


# --------------------------------------------------------------------------
# the CUDA kernel
# --------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        from ._build import load
        lib = load("shard_candidates")
        fn = lib.shard_candidates_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4
        _lib = lib
    return _lib


#: outputs of the C launcher, after the inputs: scores f32[2, D], (index,
#: found, ties) i32[3, 2, D], the combined (index, ties) i32[2, 2] and
#: found bool[2]; then its scratch: the blocks' partials and the counter
N_OUTS = 4
N_PTRS = len(ShardArgs._fields) + N_OUTS + 2
#: order of the integer dimensions of the C launcher
DIMS = ("D", "NL", "R", "G", "threads", "rows")
#: the grid's block: threads (128 or 256) and rows a thread; set by
#: chip_smoke.py phase 19's comparison of the four on an H100
THREADS = 256
ROWS_PER_THREAD = 1
#: bytes of one block's partial (csrc/shard_candidates.cu Part)
PART_BYTES = 32


def row_blocks(NL: int, rows: int) -> int:
    """Blocks a shard of NL rows takes at ``rows`` rows a block (the last
    one takes what is left)."""
    return -(-NL // rows)


def grid_geometry(threads: Optional[int] = None,
                  rows_per_thread: Optional[int] = None):
    """(threads, rows a block) of the kernel's blocks, the module's
    defaults where not given; raises on a block the kernel does not take."""
    threads = THREADS if threads is None else threads
    rpt = ROWS_PER_THREAD if rows_per_thread is None else rows_per_thread
    if threads not in (128, 256) or rpt not in (1, 2):
        raise ValueError(f"the kernel takes 128 or 256 threads and 1 or 2 "
                         f"rows a thread, not {threads} and {rpt}")
    return threads, threads * rpt


#: per device: the ticket counter (int32[1], 0 between launches: the
#: kernel's last block puts it back) and the partials' scratch
_work: dict = {}


def _workspace(dev, n_parts: int):
    ticket, part = _work.get(dev, (None, None))
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    if part is None or part.numel() * 4 < n_parts * PART_BYTES:
        part = torch.empty(n_parts * PART_BYTES // 4, dtype=torch.int32,
                           device=dev)
    _work[dev] = (ticket, part)
    return ticket, part


def node_layout(cfg, a) -> dict:
    """The dtype and shape of each node-axis argument of ``a`` (the
    reference's env refs, then the state), for ``check_layout``."""
    R, N = a.idle.shape
    P = a.tstat.shape[0]
    GR = a.orfeas.shape[0]
    G = a.gidle0.shape[0] if cfg.enable_gpu else 0
    f = torch.float32
    return dict(
        tstat=((P, N), f), tscore=((P, N), f), nascore=((P, N), f),
        blocknr=((1, N), f), blockall=((1, N), f), bonus=((1, N), f),
        locked=((1, N), f), orfeas=((GR, N), f), rel=((R, N), f),
        pip=((R, N), f), alloc=((R, N), f), cnt=((1, N), f),
        maxp=((1, N), f), gidle0=((G, N), f), idle=((R, N), f),
        pipe=((R, N), f), pods=((1, N), f), gpux=((G, N), f))


def _check(cfg, D: int, a: ShardArgs):
    """Device, dtype, shape and layout of every argument, and a node axis
    that D shards divide."""
    R, N = a.idle.shape
    if D < 1 or N % D:
        raise ValueError(f"{N} node rows do not split into {D} shards")
    i = torch.int32
    check_layout(dict(
        req=((1, R + (1 if cfg.enable_gpu else 0)), torch.float32),
        task=((1, len(TASK_FIELDS)), i), istgt=((1, 1), i),
        **node_layout(cfg, a)), a)


def shard_candidates_cuda(cfg, D: int, args, threads: Optional[int] = None,
                          rows_per_thread: Optional[int] = None
                          ) -> ShardCandidates:
    """Launch the CUDA kernel over the D shards on the current stream (no
    synchronisation): the per-shard candidates and their combined triple.
    ``threads`` and ``rows_per_thread`` choose the grid's block
    (:func:`grid_geometry`)."""
    global launches
    a = unpack_args(cfg, args)
    if not a.idle.is_cuda:
        raise ValueError(f"the kernel takes tensors on a CUDA device, not "
                         f"{a.idle.device}")
    _check(cfg, D, a)
    T, rows = grid_geometry(threads, rows_per_thread)
    R, N = a.idle.shape
    if not 1 <= R <= MAX_R:
        raise ValueError(f"the kernel takes 1..{MAX_R} resource dims, got {R}")
    G = a.gidle0.shape[0] if cfg.enable_gpu else 0
    dev = a.idle.device
    NL = N // D
    ticket, part = _workspace(dev, D * row_blocks(NL, rows))
    score = torch.empty((2, D), dtype=torch.float32, device=dev)
    ints = torch.empty((3, 2, D), dtype=torch.int32, device=dev)
    best = torch.empty((2, 2), dtype=torch.int32, device=dev)
    found = torch.empty(2, dtype=torch.bool, device=dev)
    ptrs = (ctypes.c_void_p * N_PTRS)(*[
        t.data_ptr() if t is not None else None
        for t in list(a) + [score, ints, best, found, part, ticket]])
    dims = dict(D=D, NL=NL, R=R, G=G, threads=T, rows=rows)
    note_kernel_launch("shard_candidates", a, dims)
    ints_c = (ctypes.c_int * len(DIMS))(*[dims[k] for k in DIMS])
    weights = (ctypes.c_float * 4)(*_weights(cfg))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _library().shard_candidates_launch(ptrs, ints_c, weights,
                                            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"shard_candidates launch failed: CUDA error {rc}")
    launches += 1
    return ShardCandidates(score, ints[0], ints[1], ints[2], best[0], found,
                           best[1])


def shard_candidates_plain_all(cfg, D: int, args) -> ShardCandidates:
    """The plain version over every shard, on the device of the arguments,
    in the kernel's output layout."""
    a = unpack_args(cfg, args)
    R, N = a.idle.shape
    G = a.gidle0.shape[0] if cfg.enable_gpu else 0
    GR = a.orfeas.shape[0]
    shard_args = [shard_args_of(cfg, D, a, d) for d in range(D)]
    note_plain_launch("shard_candidates", a, D, shard_args)
    outs = [shard_candidates_plain(cfg, N // D, R, G, GR, args)
            for args in shard_args]
    col = [torch.cat([o[k].reshape(1) for o in outs]) for k in range(8)]
    return ShardCandidates(torch.stack([col[0], col[4]]),
                           torch.stack([col[1], col[5]]),
                           torch.stack([col[2], col[6]]),
                           torch.stack([col[3], col[7]]))


def shard_candidates_plain_combined(cfg, D: int, args) -> ShardCandidates:
    """The plain version over every shard and :func:`combine`'s triple, on
    the device of the arguments: what :func:`shard_candidates` gives for
    CPU tensors."""
    c = shard_candidates_plain_all(cfg, D, args)
    idx, found, ties = combine(c, unpack_args(cfg, args).idle.shape[1])
    return c._replace(best_idx=idx, best_found=found, best_ties=ties)


def note_kernel_launch(kernel: str, a, dims: dict, per_shard: int = 1) -> None:
    """Record a CUDA launch from the ``D`` and ``NL`` it is handed, its
    blocks reading each node-axis argument of ``a`` on their shard's rows
    (``ops/launch_record.py``)."""
    if launch_record.active():
        widths = [getattr(a, f).shape[0] for f in NODE_FIELDS
                  if getattr(a, f) is not None]
        launch_record.note(kernel, dims["NL"], launch_record.shard_blocks(
            widths, dims["D"], dims["NL"], per_shard))


def note_plain_launch(kernel: str, a, D: int, shard_args,
                      per_shard: int = 1) -> None:
    """Record a plain-route launch from the node-axis slices each shard's
    call is given (the last arguments of each of ``shard_args``)."""
    if launch_record.active():
        bases = [getattr(a, f) for f in NODE_FIELDS
                 if getattr(a, f) is not None]
        launch_record.note(kernel, a.idle.shape[1] // D, [
            launch_record.view_block(args[-len(bases):], bases)
            for args in shard_args for _ in range(per_shard)])


def shard_candidates(cfg, D: int, args) -> ShardCandidates:
    """One attempt over D shards and their combined triple: the CUDA kernel
    for CUDA tensors, the plain version and :func:`combine` for CPU
    tensors. The launch is recorded on both."""
    dev = args[0].device
    if dev.type == "cuda":
        return shard_candidates_cuda(cfg, D, args)
    if dev.type == "cpu":
        _check(cfg, D, unpack_args(cfg, args))
        return shard_candidates_plain_combined(cfg, D, args)
    raise ValueError(f"no shard placer for device {dev}")


def bound_bytes(cfg, N: int, R: int, G: int) -> int:
    """Bytes one launch must move over N rows: per row the task's template
    row of the three per-template maps, the OR-group row, the four tdm and
    lock rows, releasing / pipelined / allocatable / idle / pipe (R each),
    count, max pods and pods, and with GPU cards their two [G] columns;
    the task's scalars and the outputs are negligible."""
    per_row = 3 + 1 + 4 + 5 * R + 3 + (2 * G if cfg.enable_gpu else 0)
    return 4 * N * per_row

