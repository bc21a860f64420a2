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
  (``csrc/seg_fold.cu``) on the current stream, for tensors on a CUDA
  device; it never synchronises, so a cycle that calls it once a round
  keeps its one readback a round;
- :func:`seg_fold_plain` is the plain PyTorch version: ``index_add_`` on
  the CPU, which adds the source rows one after another in index order;
- :func:`seg_fold` chooses by the device of ``vals``.
"""

from __future__ import annotations

import ctypes

import torch

#: launches of the CUDA kernel since the count was last set to 0
launches = 0


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


_lib = None


def _library():
    global _lib
    if _lib is None:
        from ._build import load
        lib = load("seg_fold")
        fn = lib.seg_fold_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        _lib = lib
    return _lib


def seg_fold_cuda(vals: torch.Tensor, seg: torch.Tensor,
                  num: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronisation)."""
    global launches
    _check(vals, seg, num)
    if not vals.is_cuda:
        raise ValueError(f"the kernel takes tensors on a CUDA device, not "
                         f"{vals.device}")
    vals, seg = vals.contiguous(), seg.contiguous()
    A, D = vals.shape
    out = torch.empty((num, D), dtype=torch.float32, device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = _library().seg_fold_launch(
        ctypes.c_void_p(vals.data_ptr()), ctypes.c_void_p(seg.data_ptr()),
        A, D, num, ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
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
