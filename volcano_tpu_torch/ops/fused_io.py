"""Fused host-to-device snapshot transfer with device-resident deltas
(PyTorch port of ``volcano_tpu/ops/fused_io.py``, its flat path).

The (snapshot, extras) tree of a cycle is some sixty arrays. This module
flattens it on the host into one buffer per dtype family (float32, int32,
bool), so a cycle pays three uploads, and hands the cycle views into the
three device buffers (:func:`make_unfuse`): slices at offsets fixed by one
spec (:func:`fuse_spec`) for both transfer paths.

- **Full**: the three buffers go up whole. Paid on the first cycle of a
  shape bucket, after a recovery, and whenever a diff would ship half the
  buffers or more.
- **Delta** (:class:`DeltaKernel` and :class:`ResidentState`): the three
  buffers stay resident on the device across cycles. Each cycle the host
  fuses the tree into a scratch buffer and diffs it against the mirror of
  what the device holds, bit for bit. Only the changed elements go up:
  per group one pinned staging buffer of (indices, values), one
  ``non_blocking`` copy, and an ``index_copy_`` into the resident buffer.
  Padding repeats the last pair (:func:`_pad_delta`), and duplicate
  writes of one value are deterministic.

An integrity digest checks that the device still holds what the mirror
says: a position-weighted u32 sum over each buffer's words, computed on
the device after the cycle (:func:`device_digest`) and on the host over
the mirror (:func:`host_digest`), equal bit for bit. A mismatch or a
failed readback makes the owner recover (:meth:`DeltaKernel.recover`): a
full upload from the cycle's own tree and a re-run.

The changed-rows tail (``rb_cap``) lets the drain read only the decision
rows that differ from the previous cycle's: [digest | count | rows |
values].

Against the reference: no donation and no jit (PyTorch runs the cycle's
host loop on the views, and the views are the resident buffers, so the
scatter is in place by construction); the diff compares bits, where the
reference compares values, so a +0.0 that becomes -0.0 ships as a change
rather than tripping the digest.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..telemetry import spans as _spans

_GROUPS = ("f", "i", "b")
_TARGETS = {"f": np.float32, "i": np.int32, "b": np.bool_}
_TORCH = {"f": torch.float32, "i": torch.int32, "b": torch.bool}

#: smallest non-empty delta bucket: deltas pad up to a power of two from
#: here, so the staging buffers come in few sizes
_DELTA_MIN_BUCKET = 256


def _group_of(dtype) -> str:
    """The group of a leaf: its dtype is the group's own, so every leaf
    is a view of its group buffer, never a conversion."""
    for g, t in _TARGETS.items():
        if np.dtype(dtype) == np.dtype(t):
            return g
    raise TypeError(f"unsupported dtype {dtype}: the snapshot's arrays are "
                    f"float32, int32 or bool")


def tree_leaves(tree) -> List[Any]:
    """The arrays of a tree of dataclasses (and tuples), in field order."""
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _unflatten(tree, it):
    """``tree``'s structure with its arrays taken in order from ``it``."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), it)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(t, it) for t in tree)
    return next(it)


def fuse_spec(tree) -> Tuple[Any, List[Tuple[str, int, tuple, Any]]]:
    """(the tree, per-leaf (group, offset, shape, dtype)) of a tree of
    arrays. Offsets are in elements of the group buffer. The one source of
    the layout for the full and the delta path."""
    offsets = {g: 0 for g in _GROUPS}
    spec = []
    for leaf in tree_leaves(tree):
        arr = np.asarray(leaf)
        g = _group_of(arr.dtype)
        spec.append((g, offsets[g], arr.shape, arr.dtype))
        offsets[g] += arr.size
    return tree, spec


def group_sizes(spec) -> Tuple[int, int, int]:
    """Elements of each group buffer a fuse_spec implies."""
    sizes = {g: 0 for g in _GROUPS}
    for g, off, shape, _dtype in spec:
        size = int(np.prod(shape)) if shape else 1
        sizes[g] = max(sizes[g], off + size)
    return tuple(sizes[g] for g in _GROUPS)


def fuse_into(tree, spec, sizes, out=None) -> Tuple[np.ndarray, ...]:
    """Fill the three group buffers from ``tree``'s arrays, slice by slice
    (``out``: caller-owned buffers to reuse, else fresh ones)."""
    if out is None:
        out = tuple(np.empty(n, _TARGETS[g])
                    for g, n in zip(_GROUPS, sizes))
    bufs = dict(zip(_GROUPS, out))
    for leaf, (g, off, _shape, _dtype) in zip(tree_leaves(tree), spec):
        arr = np.asarray(leaf)
        bufs[g][off:off + arr.size] = arr.ravel()
    return out


def make_unfuse(treedef, spec) -> Callable:
    """(fbuf, ibuf, bbuf) -> the tree of ``treedef``, each leaf a view into
    its group buffer (torch tensors or numpy arrays)."""

    def unfuse(fbuf, ibuf, bbuf):
        bufs = {"f": fbuf, "i": ibuf, "b": bbuf}
        return _unflatten(treedef, iter(
            bufs[g][off:off + (int(np.prod(shape)) if shape else 1)]
            .reshape(shape) for g, off, shape, _dtype in spec))

    return unfuse


def _shape_key(tree, key_extra=None):
    return (key_extra, tuple((np.asarray(x).shape, np.asarray(x).dtype.str)
                             for x in tree_leaves(tree)))


# --------------------------------------------------------------------------
# delta sizes
# --------------------------------------------------------------------------

def pow2_bucket(n: int, minimum: int = 1) -> int:
    """Smallest power of two >= ``n``, starting from ``minimum`` (0 stays
    0)."""
    if n <= 0:
        return 0
    b = int(minimum)
    while b < n:
        b <<= 1
    return b


def delta_bucket(n: int) -> int:
    """Pad a delta of ``n`` elements up to its bucket (0 stays 0)."""
    return pow2_bucket(n, _DELTA_MIN_BUCKET)


def _pad_delta(idx: np.ndarray, vals: np.ndarray, bucket: int):
    """Pad (idx, vals) to ``bucket`` by repeating the last real pair:
    duplicate writes of one value leave the buffer as it was."""
    pad = bucket - idx.size
    if pad <= 0:
        return idx, vals
    return (np.concatenate([idx, np.full(pad, idx[-1], np.int32)]),
            np.concatenate([vals, np.full(pad, vals[-1], vals.dtype)]))


# --------------------------------------------------------------------------
# the integrity digest
# --------------------------------------------------------------------------

#: digest words after the packed decisions (one a group buffer)
DIGEST_WORDS = 3
_DIGEST_MUL = np.uint32(2654435761)     # Knuth multiplicative hash constant
_DIGEST_ADD = np.uint32(0x9E3779B9)     # golden-ratio offset: element 0 counts
_MASK = 0xFFFFFFFF


def host_digest(bufs) -> np.ndarray:
    """u32[3] digest of host group buffers: sum over i of word[i] x (i x
    MUL + ADD) mod 2^32. f32 and i32 words are reinterpreted, never
    converted, so NaNs and negative zeros digest deterministically; a bool
    is the word 0 or 1."""
    out = np.zeros(DIGEST_WORDS, np.uint32)
    for k, b in enumerate(bufs):
        w = (b.astype(np.uint32) if b.dtype == np.bool_
             else np.ascontiguousarray(b).view(np.uint32))
        idx = np.arange(w.size, dtype=np.uint32)
        out[k] = np.sum(w * (idx * _DIGEST_MUL + _DIGEST_ADD),
                        dtype=np.uint32)
    return out


def digest_coef(n: int, device) -> torch.Tensor:
    """int64 [n]: (i x MUL + ADD) mod 2^32, the digest's weight of word i
    (exact: i < 2^31 keeps the product under 2^63)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return (idx * int(_DIGEST_MUL) + int(_DIGEST_ADD)) & _MASK


def device_digest(bufs, coefs=None) -> torch.Tensor:
    """int32 [3]: :func:`host_digest` of the group buffers on their device,
    bit for bit (the u32 words' bits as int32). In int64 tensor
    arithmetic: each word splits into 16-bit halves, so every product stays
    under 2^48 and the sum of n terms under 2^32 x n, and the low 32 bits
    are exact. ``coefs``: the buffers' :func:`digest_coef`, when kept."""
    words = []
    for k, b in enumerate(bufs):
        w = (b.to(torch.int64) if b.dtype == torch.bool
             else b.view(torch.int32).to(torch.int64) & _MASK)
        c = coefs[k] if coefs is not None else digest_coef(w.numel(),
                                                           w.device)
        prod = (((w & 0xFFFF) * c)
                + ((((w >> 16) * c) & 0xFFFF) << 16)) & _MASK
        words.append(prod.sum() & _MASK)
    d = torch.stack(words) if words else torch.zeros(0, dtype=torch.int64)
    # u32 bits as int32: values past 2^31 wrap to the negatives
    return (d - ((d >> 31) << 32)).to(torch.int32)


# --------------------------------------------------------------------------
# residency
# --------------------------------------------------------------------------

class ResidentState:
    """One owner's device residency for one DeltaKernel shape bucket: the
    host mirror of what the device buffers hold, the scratch the next pack
    fills, the device buffers, the decisions chain of the changed-rows
    tail, and the counters. Host code reads the mirror, never a resident
    buffer."""

    __slots__ = ("mirror", "scratch", "device", "dec_device", "dec_mirror",
                 "last_tail", "dec_epoch", "full_cycles", "delta_cycles",
                 "last_kind", "last_upload_bytes", "full_upload_bytes")

    def __init__(self):
        self.mirror: Optional[tuple] = None
        self.scratch: Optional[tuple] = None
        self.device: Optional[tuple] = None
        #: the previous cycle's packed decisions on the device: the diff
        #: base of the changed-rows tail
        self.dec_device: Optional[torch.Tensor] = None
        #: host mirror of the decisions the owner last drained; None sends
        #: the next drain to the full readback
        self.dec_mirror: Optional[np.ndarray] = None
        #: the tail the last run computed (None without a tail)
        self.last_tail: Optional[torch.Tensor] = None
        #: bumped by every dispatch outside the chain (a recovery): a
        #: pending of another epoch drains full and leaves dec_mirror
        self.dec_epoch: int = 0
        self.full_cycles = 0
        self.delta_cycles = 0
        #: "full", "delta" or "recovery" for the last run
        self.last_kind: Optional[str] = None
        #: bytes shipped to the device by the last run
        self.last_upload_bytes = 0
        #: what a full upload of this shape bucket ships
        self.full_upload_bytes = 0


class DeltaKernel:
    """The delta update and the cycle over device-resident buffers: one
    instance per (cycle, shape bucket, device), cached by
    :func:`delta_cycle_cached`; the residency is the caller's
    (:class:`ResidentState`).

    ``run`` fuses the tree on the host, diffs it against the mirror, ships
    the full buffers or the deltas, scatters them into the resident
    buffers, runs ``cycle_fn`` on views into them, and returns the packed
    decisions with the digest after them, on the device. ``dec_len``: the
    length of the cycle's packed decisions (3T + 3J), which sizes the
    changed-rows tail."""

    def __init__(self, cycle_fn, example_tree, device, dec_len: int = 0):
        self.cycle_fn = cycle_fn
        self.device = torch.device(device)
        self.treedef, self.spec = fuse_spec(example_tree)
        self.sizes = group_sizes(self.spec)
        self.unfuse = make_unfuse(self.treedef, self.spec)
        self.dec_len = int(dec_len)
        #: rows of the changed-rows tail; 0 turns it off (buckets where
        #: the tail would not beat the full readback)
        self.rb_cap = 0
        if self.dec_len:
            cap = pow2_bucket(max(32, self.dec_len // 16), 32)
            if 2 * cap + 1 + DIGEST_WORDS < self.dec_len:
                self.rb_cap = cap
        self._coefs = None

    # ----------------------------------------------- integrity + recovery
    def split_digest(self, packed: np.ndarray):
        """(decisions, u32[3] device digest) of a host readback."""
        tail = np.ascontiguousarray(packed[-DIGEST_WORDS:])
        return packed[:-DIGEST_WORDS], tail.view(np.uint32)

    def mirror_digest(self, state: ResidentState):
        """The host half of the check: the digest of the mirror."""
        if state.mirror is None:
            return None
        return host_digest(state.mirror)

    def split_tail(self, tail: np.ndarray):
        """(u32 device digest, changed count, rows, values) of a host-read
        changed-rows tail."""
        dig = np.ascontiguousarray(tail[:DIGEST_WORDS]).view(np.uint32)
        cnt = int(tail[DIGEST_WORDS])
        idx = tail[DIGEST_WORDS + 1:DIGEST_WORDS + 1 + self.rb_cap]
        vals = tail[DIGEST_WORDS + 1 + self.rb_cap:]
        return dig, cnt, idx, vals

    def recover(self, state: ResidentState, tree):
        """A full upload from ``tree`` (the failed cycle's own arguments)
        and a re-run: trusts neither the resident buffers nor the mirror,
        so it heals a corrupted buffer and a drifted mirror alike. The
        decisions chain is cut: the next drain reads in full."""
        with _spans.span("delta.recover", cat="recovery"):
            state.device = None
            state.mirror = None
            state.dec_mirror = None
            state.dec_device = None
            state.dec_epoch += 1
            packed = self.run(state, tree, force_full=True)
            state.last_kind = "recovery"
            return packed

    # ------------------------------------------------------------- running
    def _upload_deltas(self, resident, deltas) -> int:
        """Ship each group's (indices, values) through one pinned staging
        buffer and one non-blocking copy, and scatter them into the
        ``resident`` buffers. Returns the bytes shipped."""
        pin = self.device.type == "cuda"
        shipped = 0
        for k, (idx, vals) in enumerate(deltas):
            if not idx.size:
                continue
            pidx, pvals = _pad_delta(idx, vals, delta_bucket(idx.size))
            n = pidx.size
            nb_idx = n * 4
            stage = torch.empty(nb_idx + pvals.nbytes, dtype=torch.uint8,
                                pin_memory=pin)
            host = stage.numpy()
            host[:nb_idx] = pidx.view(np.uint8)
            host[nb_idx:] = pvals.view(np.uint8)
            dev = stage.to(self.device, non_blocking=True)
            d_idx = dev[:nb_idx].view(torch.int32).long()
            d_vals = dev[nb_idx:].view(_TORCH[_GROUPS[k]])
            resident[k].index_copy_(0, d_idx, d_vals)
            shipped += stage.numel()
        return shipped

    def run(self, state: ResidentState, tree, force_full: bool = False):
        """One cycle: fuse ``tree``, ship the full buffers or the deltas,
        scatter, run the cycle on the resident buffers' views. Returns the
        packed decisions and the digest on the device, i32 [dec_len + 3]
        (the caller reads it back); ``state`` takes the new residency and
        counters, and the changed-rows tail (``last_tail``)."""
        with _spans.span("delta.pack"):
            bufs = fuse_into(tree, self.spec, self.sizes, out=state.scratch)
        state.scratch = None
        full_bytes = int(sum(b.nbytes for b in bufs))
        deltas = None
        if state.mirror is not None and state.device is not None \
                and not force_full:
            with _spans.span("delta.diff"):
                deltas = []
                total = 0
                for new, old in zip(bufs, state.mirror):
                    # bits, not values: a NaN or a sign of zero is a change
                    nv = (new.view(np.int32) if new.dtype == np.float32
                          else new)
                    ov = (old.view(np.int32) if old.dtype == np.float32
                          else old)
                    idx = np.flatnonzero(nv != ov).astype(np.int32)
                    deltas.append((idx, new[idx]))
                    total += int(idx.size)
            if 2 * total >= sum(self.sizes):
                # a delta this large ships more than the buffers
                deltas = None
        if deltas is None:
            with _spans.span("delta.upload"):
                state.device = tuple(
                    torch.from_numpy(b).to(self.device, copy=True)
                    for b in bufs)
            state.full_cycles += 1
            state.last_kind = "full"
            state.last_upload_bytes = full_bytes
        # the deltas' scatter, the cycle, the digest and the tail: the
        # reference's one dispatch
        with _spans.span("delta.dispatch", cat="dispatch"):
            if deltas is not None:
                state.last_upload_bytes = self._upload_deltas(state.device,
                                                              deltas)
                state.delta_cycles += 1
                state.last_kind = "delta"
            state.full_upload_bytes = full_bytes
            # ping-pong: the old mirror is the next cycle's scratch
            state.scratch, state.mirror = state.mirror, bufs
            packed = self.cycle_fn(*self.unfuse(*state.device)) \
                .packed_decisions()
            if self._coefs is None:
                self._coefs = [digest_coef(n, self.device)
                               for n in self.sizes]
            # after the cycle: the check covers what the cycle left in the
            # buffers, which the next delta diffs against
            dig = device_digest(state.device, self._coefs)
            state.last_tail = None
            if self.rb_cap and packed.shape[0] == self.dec_len:
                prev = state.dec_device
                if prev is None:
                    prev = torch.zeros_like(packed)
                    state.dec_mirror = None
                state.last_tail = self._tail(packed, prev, dig)
                state.dec_device = packed
            return torch.cat([packed, dig])

    def _tail(self, dec, prev, dig):
        """[digest | count | rows | values]: the first ``rb_cap`` rows of
        ``dec`` that differ from ``prev`` in row order, fill rows 0 (whose
        value is row 0's current one, so every pair applies exactly)."""
        cap = self.rb_cap
        diff = dec != prev
        cnt = diff.sum(dtype=torch.int32)
        # a changed row's slot is its rank among the changed rows; the
        # unchanged rows and those past cap land in slot cap, sliced off
        slot = torch.where(diff, (torch.cumsum(diff, 0, dtype=torch.int64)
                                  - 1).clamp_max(cap), cap)
        rows = torch.arange(dec.shape[0], dtype=torch.int64,
                            device=dec.device)
        idx = torch.zeros(cap + 1, dtype=torch.int64, device=dec.device)
        idx.index_put_((slot,), rows)
        idx = idx[:cap]
        return torch.cat([dig, cnt[None], idx.to(torch.int32), dec[idx]])


def delta_cycle_cached(cycle_fn, tree, cache: Dict, device, dec_len: int = 0,
                       key_extra=None) -> DeltaKernel:
    """The DeltaKernel of ``tree``'s shape bucket on ``device`` (a new one
    on the first call of a key). The residency (ResidentState) is the
    caller's, keyed by the returned kernel."""
    key = (_shape_key(tree, key_extra), str(torch.device(device)))
    hit = cache.get(key)
    if hit is None:
        hit = DeltaKernel(cycle_fn, tree, device, dec_len=dec_len)
        cache[key] = hit
    return hit
