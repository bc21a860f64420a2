"""Segmented sum in row order: ``out[s, d] = sum of vals[a, d] over the rows
a with seg[a] == s``, added one after another from 0 in row order; rows
whose segment lies outside ``[0, num)`` are dropped.

The port's form of the reference's masked segment sums (the drf namespace
allocations and the hdrf subtree sums of ``ops/fairshare.py``). The
reference leaves the order of those float32 sums to XLA; the port fixes it
to row order, so the CUDA kernel, the plain version and the namespace fold
inside ``csrc/dyn_placer.cu`` agree bit for bit at any size, and agree with
the reference wherever the sums are exact.

- :func:`seg_fold_cuda` launches the hand-written kernel
  (``csrc/seg_fold.cu``: a warp a (segment, dim) pair lists the pair's
  nonzero terms in row order and folds only those) on the current stream,
  for tensors on a CUDA device; it never synchronises, so a cycle that
  calls it once a round keeps its one readback a round;
- :func:`seg_fold_plain` is the plain PyTorch version: ``index_add_`` on
  the CPU, which adds the source rows one after another in index order;
- :func:`seg_fold` chooses by the device of ``vals``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import stream_handle

#: launches of the CUDA kernel since the count was last set to 0
launches = 0
#: the most dims the kernel takes (csrc/seg_fold.cu MAX_D: a tile of 256
#: rows of that many dims still fits its shared memory)
MAX_DIMS = 42


def _check(vals: torch.Tensor, seg: torch.Tensor, num: int):
    if vals.dtype != torch.float32 or vals.dim() != 2:
        raise ValueError(f"vals: expected float32 [A, D], got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    if seg.dtype != torch.int32 or tuple(seg.shape) != (vals.shape[0],):
        raise ValueError(f"seg: expected int32 [{vals.shape[0]}], got "
                         f"{seg.dtype} {tuple(seg.shape)}")
    if seg.device != vals.device:
        raise ValueError(f"seg: expected a tensor on {vals.device}")
    if num < 0:
        raise ValueError(f"num must be >= 0, got {num}")


def seg_fold_plain(vals: torch.Tensor, seg: torch.Tensor,
                   num: int) -> torch.Tensor:
    """Plain version: f32[num, D] on ``vals``'s device, summed on the CPU
    (a CUDA input is copied there and the result back)."""
    _check(vals, seg, num)
    v, s = vals.detach().cpu(), seg.cpu().long()
    keep = (s >= 0) & (s < num)
    out = torch.zeros((num + 1, v.shape[1]), dtype=torch.float32)
    out.index_add_(0, torch.where(keep, s, num),
                   torch.where(keep[:, None], v, torch.zeros(())))
    return out[:num].to(vals.device)


_launch = None


def _library_launch():
    """The C launcher, built and bound on first use. Bound as a Python-API
    function: the call keeps the interpreter lock, which a launch of a few
    microseconds does not need to give up."""
    global _launch
    if _launch is None:
        from ._build import load
        c = ctypes
        proto = c.PYFUNCTYPE(c.c_int, c.c_void_p, c.c_void_p, c.c_int,
                             c.c_int, c.c_int, c.c_void_p, c.c_void_p)
        _launch = proto(("seg_fold_launch", load("seg_fold")))
    return _launch


def seg_fold_cuda(vals: torch.Tensor, seg: torch.Tensor,
                  num: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronisation).
    The host path is one test of what the kernel takes, the output's
    allocation and the call; other inputs go through :func:`_check` (a
    non-contiguous one is copied). Takes at most :data:`MAX_DIMS` dims
    and num x D < 2**31 (segment, dim) pairs."""
    global launches
    dev = vals.get_device()
    if not (dev >= 0 and vals.dtype is torch.float32
            and seg.dtype is torch.int32 and vals.dim() == 2
            and seg.dim() == 1 and seg.shape[0] == vals.shape[0]
            and seg.get_device() == dev and 0 <= num
            and vals.shape[1] <= MAX_DIMS
            and num * vals.shape[1] < 2 ** 31
            and vals.is_contiguous() and seg.is_contiguous()):
        _check(vals, seg, num)
        if vals.shape[1] > MAX_DIMS:
            raise ValueError(f"the kernel takes at most {MAX_DIMS} dims, "
                             f"got {vals.shape[1]}")
        if num * vals.shape[1] >= 2 ** 31:
            raise ValueError(f"the kernel takes fewer than 2**31 (segment, "
                             f"dim) pairs, got {num} x {vals.shape[1]}")
        if dev < 0:
            raise ValueError(f"the kernel takes tensors on a CUDA device, "
                             f"not {vals.device}")
        vals, seg = vals.contiguous(), seg.contiguous()
    A, D = vals.shape
    out = vals.new_empty((num, D))
    rc = (_launch or _library_launch())(
        vals.data_ptr(), seg.data_ptr(), A, D, num, out.data_ptr(),
        stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"seg_fold launch failed: CUDA error {rc}")
    launches += 1
    return out


def seg_fold(vals: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """f32[num, D]: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if vals.device.type == "cuda":
        return seg_fold_cuda(vals, seg, num)
    if vals.device.type == "cpu":
        return seg_fold_plain(vals, seg, num)
    raise ValueError(f"no segmented sum for device {vals.device}")
