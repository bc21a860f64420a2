"""Wide shard-local candidate search: W placement attempts against one
snapshot of each shard's rows, and the wavefront's cross-shard combine,
exact rescore and resolve.

Port of ``volcano_tpu/ops/pallas_place.make_shard_wave_placer`` (the Pallas
``_shard_wave_kernel``) and of the helpers of the reference's wavefront
section walk (``volcano_tpu/ops/allocate_scan.py``: ``_wave_combine``,
``_wave_rescore``, ``_wave_resolve``). The sharded allocate cycle
(``allocate_scan.make_allocate_cycle`` with a node mesh and ``wave_width``
W > 1) evaluates the next W slots of the popped job against the same
capacity snapshot in one launch. Per slot (column) and capacity view
("now": fit on idle; "future": fit on future idle) each of the D shards of
NL = N / D rows returns its top C feasible rows by (score desc, global row
asc), C = ``allocate_scan.wave_candidate_depth(W)``, its feasible count and
the raw count of feasible rows at its best score. Entries past the feasible
count carry ``NEG`` and the shard's sentinel row ``off + NL``.

Functions:

- :func:`shard_wave_plain`: the plain PyTorch version of one shard's
  launch, in the reference's argument order, line by line
  ``_shard_wave_kernel``; its feasibility and score are
  ``shard_placer.shard_scores``, kernel 4's, column by column;
- :func:`shard_wave_cuda`: one launch of the hand-written CUDA kernel
  (``csrc/shard_wave.cu``) over all D shards and W columns of a device, a
  grid of split-row blocks whose last block of each column merges the
  blocks' lists and combines the shards, so the combined lists come out
  of the same launch;
- :func:`shard_wave`: the wrapper the cycle calls: the kernel for CUDA
  tensors, the plain version shard by shard and :func:`combine`
  (:func:`shard_wave_plain_combined`) for CPU tensors;
- :func:`combine`: the D shards' lists -> the global top C per column
  (``_wave_combine``);
- :func:`row_maps`, :func:`gather_rows` and :func:`rescore`: feasibility
  and score of tasks at given rows of the current state
  (``_wave_rescore``), through
  ``shard_placer.row_eval``, the function the plain kernels use, so a
  rescored row and a listed row of the same state have the same bits;
- :func:`resolve`: a slot's winner from its list and its rescored touched
  rows, or undecidable (``_wave_resolve``).

Arguments of the wrapper (node axis last, full width N; ``*`` only when
``cfg.enable_gpu``)::

    req f32[R (+1 *), W]   the W tasks' requests, then their GPU requests
    task i32[7, W]         pref, tmpl (clamped to >= 0), grp, voln, volok,
                           rev, and whether the popped job is the
                           reservation target
    then the node-axis inputs of shard_placer.ShardArgs, in its order

The per-task values stay on the device: the walk gathers them for a pop's
slots once and slices a wave's window out of them.
"""

from __future__ import annotations

import ctypes
import math
import operator
from typing import NamedTuple, Optional

import torch

from . import shard_placer as sp
from ._build import stream_handle
from .round_placer import MAX_R, NEG, _weights, check_layout

#: launches of the CUDA kernel since the count was last set to 0 (one per
#: wave of the sharded cycle, covering every shard of the device)
launches = 0
#: waves of the wavefront walk (either version), those that took the
#: batched commit, and those that stopped at a slot whose list ran out;
#: set by the cycle
waves = 0
fast_waves = 0
truncations = 0

#: the per-task integer rows of ``task``, in order
TASK_ROWS = sp.TASK_FIELDS + ("istgt",)
#: the most candidates a list holds (``wave_candidate_depth``'s cap)
MAX_C = 8


class WaveArgs(NamedTuple):
    req: torch.Tensor
    task: torch.Tensor
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


class WaveCandidates(NamedTuple):
    """Per-shard lists, leading axis the view (0 "now", 1 "future"); shard
    d's C entries are rows d * C .. d * C + C - 1 of ``score`` and ``idx``.
    Then the D shards' lists combined (:func:`combine`'s five outputs, in
    its order), None where not computed."""
    score: torch.Tensor   # f32[2, D * C, W]
    idx: torch.Tensor     # i32[2, D * C, W] global rows
    count: torch.Tensor   # i32[2, D, W] feasible rows
    ties: torch.Tensor    # i32[2, D, W] raw count at the shard's best
    e_idx: Optional[torch.Tensor] = None     # i32[2, W, C] rows, N past
    e_score: Optional[torch.Tensor] = None   # f32[2, W, C] NEG past
    e_found: Optional[torch.Tensor] = None   # bool[2, W, C]
    e_count: Optional[torch.Tensor] = None   # i32[2, W] summed
    e_ties: Optional[torch.Tensor] = None    # i32[2, W] raw, at the best


#: the combined fields of :class:`WaveCandidates`
COMBINED = WaveCandidates._fields[4:]


def unpack_args(cfg, args) -> WaveArgs:
    """Name the flat argument list (GPU entries only with cfg.enable_gpu)."""
    it = iter(args)
    gpu = bool(cfg.enable_gpu)
    vals = {f: (next(it) if gpu or f not in ("gidle0", "gpux") else None)
            for f in WaveArgs._fields}
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} arguments too many for the placer")
    return WaveArgs(**vals)


# --------------------------------------------------------------------------
# the plain version: one shard, the reference's argument order
# --------------------------------------------------------------------------

def _topc(score, feas, iota_n, big_i, C):
    """A column's top C feasible rows by C masked (max, min row at max)
    reductions, its feasible count and raw ties at its best."""
    neg = torch.full_like(score, NEG)
    masked0 = torch.where(feas, score, neg)
    best0 = masked0.max(1, keepdim=True).values
    tie = ((masked0 == best0) & feas).sum(1, keepdim=True, dtype=torch.int32)
    n_f = feas.sum(1, keepdim=True, dtype=torch.int32)
    f = feas
    sc_e, ix_e = [], []
    for _ in range(C):
        masked = torch.where(f, score, neg)
        best = masked.max(1, keepdim=True).values
        idx = torch.where((masked == best) & f, iota_n, big_i).min(
            1, keepdim=True).values
        sc_e.append(best)
        ix_e.append(idx)
        f = f & (iota_n != idx)
    return torch.cat(sc_e, 0), torch.cat(ix_e, 0), n_f, tie


def shard_wave_plain(cfg, NL: int, R: int, G: int, GR: int, W: int, C: int,
                     args):
    """W attempts over one shard's NL rows: the plain version of
    ``pallas_place._shard_wave_kernel``, in its argument order::

        rr f32[R, W], *gq f32[1, W], pref, tmpl, grp, voln, volok, rev,
        istgt i32[1, W], off i32[1, 1], then the node-axis inputs of
        shard_placer.shard_candidates_plain

    Returns the 8 outputs: (C, W) entry scores, (C, W) global rows, (1, W)
    feasible counts and (1, W) raw ties of the now view, then of the
    future view. (R, G and GR are the reference's static shape arguments;
    the tensors carry them.)"""
    big_i = args[8 + bool(cfg.enable_gpu)] + NL   # past this shard's rows
    outs = [[] for _ in range(8)]
    for w in range(W):
        score, feas_now, feas_fut, iota_n, _ = sp.shard_scores(
            cfg, NL, column_args(cfg, args, w))
        for v, feas in enumerate((feas_now, feas_fut)):
            for k, o in enumerate(_topc(score, feas, iota_n, big_i, C)):
                outs[4 * v + k].append(o)
    return tuple(torch.cat(o, 1) for o in outs)


def column_args(cfg, args, w: int):
    """Column w of one shard's arguments (the reference's order, as
    :func:`shard_wave_plain` takes them): the argument list of kernel 4's
    plain version for that column's task (``shard_placer.shard_scores``)."""
    gpu = bool(cfg.enable_gpu)
    col = [args[0][:, w:w + 1]]
    if gpu:
        col.append(args[1][:, w:w + 1])
    return col + [r[:, w:w + 1] for r in args[1 + gpu:8 + gpu]] + list(
        args[8 + gpu:])


def wave_args_of(cfg, D: int, a: WaveArgs, d: int):
    """Shard d's arguments in the reference's order, from the wrapper's
    full-width arguments (views of them)."""
    R, N = a.idle.shape
    NL = N // D
    lo, hi = d * NL, (d + 1) * NL
    out = [a.req[:R]]
    if cfg.enable_gpu:
        out.append(a.req[R:R + 1])
    out += [a.task[k:k + 1] for k in range(len(TASK_ROWS))]
    out.append(torch.full((1, 1), lo, dtype=torch.int32,
                          device=a.idle.device))
    out += [getattr(a, f)[:, lo:hi] for f in sp.NODE_FIELDS
            if getattr(a, f) is not None]
    return out


def shard_wave_plain_all(cfg, D: int, C: int, args) -> WaveCandidates:
    """The plain version over every shard, on the device of the arguments,
    in the kernel's output layout."""
    a = unpack_args(cfg, args)
    R, N = a.idle.shape
    W = a.req.shape[1]
    G = a.gidle0.shape[0] if cfg.enable_gpu else 0
    GR = a.orfeas.shape[0]
    shard_args = [wave_args_of(cfg, D, a, d) for d in range(D)]
    sp.note_plain_launch("shard_wave", a, D, shard_args, per_shard=W)
    outs = [shard_wave_plain(cfg, N // D, R, G, GR, W, C, args)
            for args in shard_args]

    def cat(k):
        return torch.cat([o[k] for o in outs], 0)
    return WaveCandidates(torch.stack([cat(0), cat(4)]),
                          torch.stack([cat(1), cat(5)]),
                          torch.stack([cat(2), cat(6)]),
                          torch.stack([cat(3), cat(7)]))


# --------------------------------------------------------------------------
# the CUDA kernel
# --------------------------------------------------------------------------

_launch = None
#: the C launcher's argument types: node-axis pointers and scratch, dims,
#: the output fields' byte offsets, weights, req, task, output buffer,
#: stream
_ARGTYPES = [ctypes.c_void_p] * 8


def bind(lib):
    """The C launcher of kernel 5 in the built library ``lib``. Bound as a
    Python-API function: the call keeps the interpreter lock, which a
    launch of a few microseconds does not need to give up."""
    return ctypes.PYFUNCTYPE(ctypes.c_int, *_ARGTYPES)(
        ("shard_wave_launch", lib))


def _library_launch():
    """The C launcher of kernel 5, built and bound on first use."""
    global _launch
    if _launch is None:
        from ._build import load
        _launch = bind(load("shard_wave"))
    return _launch


#: the node-axis fields of :class:`WaveArgs` (after req and task), whose
#: pointers a launch plan keeps, in the C launcher's order
NODE_ARGS = WaveArgs._fields[2:]
#: the C launcher's pointer array: the node-axis inputs, then the scratch
#: (the blocks' partials and the column counters)
N_PTRS = len(NODE_ARGS) + 2
#: order of the integer dimensions of the C launcher: then the block count
#: of a shard's column and the partials' scratch bytes, which it checks
DIMS = ("D", "NL", "R", "G", "W", "C", "B", "part_bytes")
#: threads a block, a row each (csrc/shard_wave.cu WB: kernel 4's default
#: block, ``shard_placer.grid_geometry()``; the launcher refuses a block
#: count other than its own)
THREADS = 256
#: bytes of one block's partial (csrc/shard_wave.cu Part): per view C
#: scores and rows, the count and the ties (the launcher refuses a scratch
#: smaller than its own count)
PART_BYTES = 4 * (2 * 2 * MAX_C + 4)
#: lists a merge step takes (csrc/shard_wave.cu GROUP), bytes of one list
#: (List: C scores and rows, the count and the ties), and the dynamic
#: shared memory the last block's merge levels may take: a block's
#: 232,448 bytes on an H100 less 4,096 for the kernel's static lists
GROUP = 8
LIST_BYTES = 4 * (2 * MAX_C + 2)
MAX_LEVEL_BYTES = 232448 - 4096
#: the dtype of each field of :class:`WaveCandidates`
FIELD_DTYPES = (torch.float32, torch.int32, torch.int32, torch.int32,
                torch.int32, torch.float32, torch.bool, torch.int32,
                torch.int32)


def level_bytes(D: int, B: int) -> int:
    """The last block's two buffers of lists (csrc/shard_wave.cu
    level_bytes): the tree's first level, 2 D ceil(B / GROUP) lists, and
    its second, 2 D ceil(B / GROUP^2)."""
    g1 = -(-B // GROUP)
    return LIST_BYTES * 2 * D * (g1 + -(-g1 // GROUP))


def max_row_blocks(D: int) -> int:
    """The most blocks B of a shard's column whose merge levels fit
    :data:`MAX_LEVEL_BYTES` (about 2.9 M rows in one shard)."""
    lo, hi = 1, 1 << 24
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if level_bytes(D, mid) <= MAX_LEVEL_BYTES \
            else (lo, mid - 1)
    return lo


def grid_shape(D: int, NL: int, W: int):
    """The kernel's grid (B, W, D): B = ceil(NL / THREADS) blocks of a
    shard's rows for each column and shard."""
    return sp.row_blocks(NL, THREADS), W, D


def output_layout(D: int, W: int, C: int):
    """The kernel's one output buffer: each field of
    :class:`WaveCandidates` in its order, as (dtype, shape, byte offset),
    each at a multiple of 4 bytes; and the buffer's bytes. The only copy
    of the layout: the C launcher takes the offsets."""
    shapes = ((2, D * C, W), (2, D * C, W), (2, D, W), (2, D, W),
              (2, W, C), (2, W, C), (2, W, C), (2, W), (2, W))
    at, layout = 0, []
    for dt, shape in zip(FIELD_DTYPES, shapes):
        layout.append((dt, shape, at))
        at += -(-math.prod(shape) * dt.itemsize // 4) * 4
    return tuple(layout), at


#: per (device, stream): the column counters (int32, 0 between launches:
#: each column's last block puts its counter back) and the partials'
#: scratch
_work: dict = {}


def _workspace(key, dev, W: int, n_parts: int):
    ticket, part = _work.get(key, (None, None))
    if ticket is None or ticket.numel() < W:
        ticket = torch.zeros(max(W, 16), dtype=torch.int32, device=dev)
    if part is None or part.numel() * 4 < n_parts * PART_BYTES:
        part = torch.empty(n_parts * PART_BYTES // 4, dtype=torch.int32,
                           device=dev)
    _work[key] = (ticket, part)
    return ticket, part


def _check(cfg, D: int, C: int, a: WaveArgs):
    """Device, dtype, shape and layout of every argument, a node axis that
    D shards divide and a depth the kernel keeps."""
    R, N = a.idle.shape
    if D < 1 or N % D:
        raise ValueError(f"{N} node rows do not split into {D} shards")
    if not 1 <= C <= MAX_C:
        raise ValueError(f"the candidate depth is 1..{MAX_C}, not {C}")
    W = a.req.shape[1] if a.req.dim() == 2 else 0
    if W < 1:
        raise ValueError("req: expected W >= 1 task columns")
    check_layout(dict(
        req=((R + (1 if cfg.enable_gpu else 0), W), torch.float32),
        task=((len(TASK_ROWS), W), torch.int32),
        **sp.node_layout(cfg, a)), a)


def _node_ptrs(args):
    """The data pointers of the node-axis entries of a flat argument list,
    for :meth:`_Plan.takes`."""
    return tuple(t.data_ptr() for t in args[2:])


def launch_pointers(a: WaveArgs, part: torch.Tensor, ticket: torch.Tensor):
    """The C launcher's pointer array (csrc/shard_wave.cu Ptr): each field
    of :data:`NODE_ARGS` (None for the GPU entries without GPU cards),
    then the partials' scratch and the column counters."""
    return tuple(getattr(a, f).data_ptr() if getattr(a, f) is not None
                 else None for f in NODE_ARGS) + (part.data_ptr(),
                                                  ticket.data_ptr())


class _Plan:
    """What the launches on one set of node-axis arguments share, on one
    stream: the checked arguments, the pointer array of the node tensors
    and the scratch, the dimensions, the output layout, the weights. The
    wave walk launches on the same node tensors (its state is updated in
    place, never resized) for a whole pop, so a wave tests only its
    request and task columns, the node tensors' identity and data
    pointers, and the stream. Nothing of the plan changes after it is
    built: a launch passes its own request, task and output buffer."""

    __slots__ = ("cfg", "D", "C", "a", "node", "node_ptrs", "stream",
                 "req_shape", "task_shape", "device", "index", "ptrs",
                 "dims", "at", "weights", "addr", "dims_d", "nbytes",
                 "views", "W")

    def __init__(self, cfg, D, C, args, stream):
        a = unpack_args(cfg, args)
        if not a.idle.is_cuda:
            raise ValueError(f"the kernel takes tensors on a CUDA device, "
                             f"not {a.idle.device}")
        _check(cfg, D, C, a)
        R, N = a.idle.shape
        if not 1 <= R <= MAX_R:
            raise ValueError(f"the kernel takes 1..{MAX_R} resource dims, "
                             f"got {R}")
        W = a.req.shape[1]
        G = a.gidle0.shape[0] if cfg.enable_gpu else 0
        NL = N // D
        B, _, _ = grid_shape(D, NL, W)
        if level_bytes(D, B) > MAX_LEVEL_BYTES:
            raise ValueError(
                f"{NL} rows a shard need {level_bytes(D, B)} bytes of merge "
                f"levels in the last block's shared memory, over "
                f"{MAX_LEVEL_BYTES}: the kernel takes at most "
                f"{max_row_blocks(D) * THREADS} rows a shard at D={D}")
        dev = a.idle.device
        ticket, part = _workspace((a.idle.get_device(), stream), dev, W,
                                  B * W * D)
        self.cfg, self.D, self.C, self.a = cfg, D, C, a
        self.node = tuple(args[2:])
        self.node_ptrs = _node_ptrs(args)
        self.stream = stream
        self.req_shape, self.task_shape = a.req.shape, a.task.shape
        self.device, self.index, self.W = dev, a.idle.get_device(), W
        self.ptrs = (ctypes.c_void_p * N_PTRS)(*launch_pointers(a, part,
                                                                ticket))
        self.dims_d = dict(D=D, NL=NL, R=R, G=G, W=W, C=C, B=B,
                           part_bytes=part.numel() * 4)
        self.dims = (ctypes.c_int * len(DIMS))(*[self.dims_d[k]
                                                 for k in DIMS])
        layout, self.nbytes = output_layout(D, W, C)
        self.at = (ctypes.c_int * len(layout))(*[at for _, _, at in layout])
        # each field as (dtype, shape, strides, offset in its dtype)
        self.views = tuple(
            (dt, shape, tuple(math.prod(shape[i + 1:])
                              for i in range(len(shape))),
             at // dt.itemsize) for dt, shape, at in layout)
        self.weights = (ctypes.c_float * 4)(*_weights(cfg))
        self.addr = (ctypes.addressof(self.ptrs), ctypes.addressof(self.dims),
                     ctypes.addressof(self.at),
                     ctypes.addressof(self.weights))

    def takes(self, cfg, D, C, args, stream) -> bool:
        """Whether a launch on ``args`` on ``stream`` can reuse this plan:
        the same config, shards, depth and stream, the same node tensors
        at the same addresses, and request and task columns of the
        planned shapes on the device."""
        req, task = args[0], args[1]
        return (cfg is self.cfg and D == self.D and C == self.C
                and stream == self.stream
                and len(args) == len(self.node) + 2
                and all(map(operator.is_, args[2:], self.node))
                and _node_ptrs(args) == self.node_ptrs
                and req.dtype is torch.float32 and task.dtype is torch.int32
                and req.shape == self.req_shape
                and task.shape == self.task_shape
                and req.get_device() == self.index
                and task.get_device() == self.index
                and req.is_contiguous() and task.is_contiguous())


_plan: Optional[_Plan] = None


def shard_wave_cuda(cfg, D: int, C: int, args) -> WaveCandidates:
    """Launch the CUDA kernel over the D shards and W columns on the current
    stream (no synchronisation): the per-shard lists and their combined
    top C. The launch plan is checked and built once for a run of
    launches on the same node tensors and stream (:class:`_Plan`); the
    scratch is kept per device and stream, so launches on one stream run
    in turn and launches on two streams do not share it.

    Limits: R <= 8 resource dims, C <= 8; the last block keeps
    2 D (ceil(B / 8) + ceil(B / 64)) lists of 72 bytes in shared memory
    (B = ceil(N / D / 256)), past the card's limit for one block (227 KB
    on the H100: about 2.9 M rows in one shard, or 800 shards of at
    most 2,048 rows) the launch fails."""
    global launches, _plan
    index = args[0].get_device()
    stream = stream_handle(index) if index >= 0 else None
    p = _plan
    if p is None or not p.takes(cfg, D, C, args, stream):
        p = _plan = _Plan(cfg, D, C, args, stream)
    buf = torch.empty(p.nbytes, dtype=torch.uint8, device=p.device)
    sp.note_kernel_launch("shard_wave", p.a, p.dims_d, per_shard=p.W)
    rc = (_launch or _library_launch())(
        *p.addr, args[0].data_ptr(), args[1].data_ptr(), buf.data_ptr(),
        stream)
    if rc != 0:
        raise RuntimeError(f"shard_wave launch failed: CUDA error {rc}")
    launches += 1
    return WaveCandidates(*[buf.view(dt).as_strided(shape, stride, at)
                            for dt, shape, stride, at in p.views])


def shard_wave_plain_combined(cfg, D: int, C: int, args) -> WaveCandidates:
    """The plain version over every shard and :func:`combine` of its lists,
    on the device of the arguments: what :func:`shard_wave` gives for CPU
    tensors."""
    c = shard_wave_plain_all(cfg, D, C, args)
    return c._replace(**dict(zip(COMBINED, combine(
        c, C, unpack_args(cfg, args).idle.shape[1]))))


def shard_wave(cfg, D: int, C: int, args) -> WaveCandidates:
    """W attempts over D shards and their lists combined: the CUDA kernel
    for CUDA tensors, the plain version and :func:`combine` for CPU
    tensors. The launch (a block a column and shard) is recorded on
    both."""
    if args[0].is_cuda:
        return shard_wave_cuda(cfg, D, C, args)
    dev = args[0].device
    if dev.type == "cpu":
        _check(cfg, D, C, unpack_args(cfg, args))
        return shard_wave_plain_combined(cfg, D, C, args)
    raise ValueError(f"no wave placer for device {dev}")


# --------------------------------------------------------------------------
# the cross-shard combine, the exact rescore and the resolve
# --------------------------------------------------------------------------

def combine(c: WaveCandidates, C: int, N: int):
    """Both views' stacked per-shard lists -> the global top C per column:
    entry rows i32 [2, W, C] (N past the feasible count), scores f32
    [2, W, C] (NEG past it), found bool [2, W, C], the feasible count i32
    [2, W] summed over the shards, and the raw ties i32 [2, W] summed over
    the shards whose best (entry 0) is the global best (the reference's
    ``_wave_combine``, once a view).

    The reference takes C rounds of (max score, min row) over the shards'
    entries within their counts; those entries' rows are distinct, so the
    same entries in the same order are the first C of the entries sorted
    by row and then, stably, by score descending, which is what this does.
    One shard's list is in that order already. The global c-th best row is
    always within its own shard's top c, so the lists hold it."""
    D = c.count.shape[1]
    dev = c.score.device
    erow = torch.arange(C, device=dev).repeat(D)[None, :, None]
    ok = erow < c.count.repeat_interleave(C, 1)              # [2, D*C, W]
    e_v = torch.where(ok, c.score, NEG)
    e_i = torch.where(ok, c.idx, N)
    if D > 1:
        by_row = torch.sort(e_i, dim=1, stable=True).indices
        by_score = torch.sort(e_v.gather(1, by_row), dim=1, descending=True,
                              stable=True).indices
        order = by_row.gather(1, by_score)[:, :C]            # [2, C, W]
        e_v, e_i, ok = (x.gather(1, order) for x in (e_v, e_i, ok))
    cnt = c.count.sum(1, dtype=torch.int32)
    tie = torch.where((c.count > 0) & (c.score[:, 0::C] == e_v[:, 0:1]),
                      c.ties, 0).sum(1, dtype=torch.int32)
    return (e_i.transpose(1, 2), e_v.transpose(1, 2), ok.transpose(1, 2),
            cnt, tie)


class RowMaps(NamedTuple):
    """A cycle's static node maps stacked for :func:`gather_rows`, so a
    gather of rows takes three indexing operations, not one a map."""
    tmaps: torch.Tensor    # f32 [3, P, N]: tstat, tscore, nascore
    orfeas: torch.Tensor   # f32 [GR, N]
    flat: torch.Tensor     # f32 [6 + 3R (+G), N]: blocknr, blockall,
    #                        bonus, locked, rel, pip, alloc [R each], cnt,
    #                        maxp, gidle0 [G]
    R: int
    G: int                 # 0: no GPU check


def row_maps(env: sp.ShardArgs, gidle0=None) -> RowMaps:
    """Stack the static node maps of ``env`` (full width), with the GPU
    cards' idle baseline ``gidle0`` [G, N] for the GPU check."""
    flat = [env.blocknr, env.blockall, env.bonus, env.locked, env.rel,
            env.pip, env.alloc, env.cnt, env.maxp]
    if gidle0 is not None:
        flat.append(gidle0)
    return RowMaps(torch.stack([env.tstat, env.tscore, env.nascore]),
                   env.orfeas, torch.cat(flat).contiguous(),
                   env.rel.shape[0],
                   gidle0.shape[0] if gidle0 is not None else 0)


def gather_rows(maps: RowMaps, rows, tmpl, grp, idle, pipe, pods,
                gpux=None) -> sp.ShardArgs:
    """The node fields at global rows ``rows`` [S, K] or [1, K] (int64,
    within 0..N-1), as ``shard_placer.row_eval`` takes them: [k, S, K] (or
    [k, 1, K]), with the template rows of slot s at ``tmpl[s]`` and its OR
    group's row at ``grp[s]`` (``tmpl`` and ``grp`` int64 [S], ``grp``
    clamped to >= 0); the state ``idle``, ``pipe`` [R, N], ``pods``
    [1, N] and, for the GPU check, ``gpux`` [G, N]."""
    R, G = maps.R, maps.G
    tm = maps.tmaps[:, tmpl[:, None], rows]                  # [3, S, K]
    f = maps.flat[:, rows]
    blocknr, blockall, bonus, locked, rel, pip, alloc, cnt, maxp, gid0 = (
        torch.split(f, [1, 1, 1, 1, R, R, R, 1, 1, G]))
    return sp.ShardArgs(
        None, None, None, tm[0:1], tm[1:2], tm[2:3], blocknr, blockall,
        bonus, locked, maps.orfeas[grp[:, None], rows][None], rel, pip,
        alloc, cnt, maxp, gid0 if G else None, idle[:, rows],
        pipe[:, rows], pods[:, rows], gpux[:, rows] if G else None)


def rescore(cfg, v: sp.ShardArgs, rows, rr, task, gq=None):
    """Feasibility in both views and the score of S tasks at node rows, at
    the state ``v`` holds (:func:`gather_rows`): the reference's
    ``_wave_rescore``, evaluated by ``shard_placer.row_eval``, the plain
    kernels' own arithmetic. ``rows`` int64 [S, K] or [1, K]; ``rr`` f32
    [R, S]; ``task`` i32 [7, S] (``TASK_ROWS``); ``gq`` f32 [S], the GPU
    requests, or None for no GPU check. Returns (ok_now, ok_fut, score),
    [S, K] each."""
    def col(x):
        return x[None, :, None]
    t = sp.RowTask(rr[:, :, None], col(gq) if gq is not None else None,
                   col(task[0]), col(task[2]), col(task[3]),
                   col(task[4]) > 0, col(task[5]) > 0, col(task[6]) > 0)
    score, ok_now, ok_fut = sp.row_eval(cfg, t, rows.to(torch.int32)[None],
                                        v)
    return ok_now[0], ok_fut[0], score[0]


def resolve(e_i, e_v, e_o, cnt, touched, t_ok, t_s, C: int, N: int):
    """A slot's winner at the current state, per view (leading axis 2),
    from its list (``e_i``, ``e_v``, ``e_o`` [2, C], ``cnt`` [2]) and the
    rescored rows the wave touched (``touched`` i32 [K], N for none;
    ``t_ok`` [2, K]; ``t_s`` [K]): the first untouched entry against every
    touched row, ties to the lowest row, as ``select.best_node`` breaks
    them. Returns (winner i32 [2], found [2], decidable [2]): not
    decidable when every listed entry is touched and more rows were
    feasible than the list holds (the reference's ``_wave_resolve``)."""
    K = touched.shape[0]
    unt = e_o & ~(e_i[:, :, None] == touched[None, None, :]).any(2)
    has_unt = unt.any(1)
    fc = unt.to(torch.uint8).argmax(1, keepdim=True)               # [2, 1]
    cand_i = torch.cat([e_i.gather(1, fc), touched.expand(2, K)], 1)
    cand_v = torch.cat([e_v.gather(1, fc), t_s.expand(2, K)], 1)
    cand_ok = torch.cat([has_unt[:, None], (touched < N)[None] & t_ok], 1)
    decidable = has_unt | (cnt <= C)
    mv = torch.where(cand_ok, cand_v, NEG)
    mx = mv.max(1, keepdim=True).values
    at = cand_ok & (mv == mx)
    win = torch.where(at, cand_i, N).min(1).values
    found = cand_ok.any(1)
    return torch.where(found, win, 0), found, decidable


def bound_bytes(cfg, N: int, R: int, G: int, W: int, C: int, D: int,
                templates: int = 1, groups: int = 1) -> int:
    """Bytes one launch must move: the node rows of
    ``shard_placer.bound_bytes`` read once, with the three per-template
    maps once per distinct template and the OR-group map once per distinct
    group among the W columns; the W tasks' scalars; the outputs: the
    per-shard lists, counts and ties, and the combined lists (the found
    flags a byte each), counts and ties."""
    per_row = (3 * templates + groups + 4 + 5 * R + 3
               + (2 * G if cfg.enable_gpu else 0))
    ins = N * per_row + W * (R + 1 + len(TASK_ROWS))
    layout, _ = output_layout(D, W, C)
    outs = sum(math.prod(shape) * dt.itemsize for dt, shape, _ in layout)
    return 4 * ins + outs
