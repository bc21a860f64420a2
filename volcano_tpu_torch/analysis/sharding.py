"""Graphcheck's sharding family, its shard-local launch check (PyTorch port
of ``volcano_tpu/analysis/sharding.py``, the ``pallas-block`` half).

The sharded allocate cycle runs each attempt's candidate search shard by
shard: a launch must read, on each shard, its own NL = nodes / mesh rows
of every node-axis operand. A launch whose block carries the FULL node
axis means a full-axis gather fed the kernel: the O(nodes) leak the
shard-local design exists to prevent, invisible to every numeric test
because the gathered values are right.

- :func:`pallas_block_findings` flags, in a launch record
  (``ops/launch_record.py``), every block shape that carries the full
  node axis inside a ``rows_per``-row shard (the reference's
  ``_pallas_findings``, ``:96-127``, on the records in place of a jaxpr);
- :func:`planted_gather` is the planted fault it must flag (the
  reference's ``planted_gather_pallas``, ``:149-181``): each shard gathers
  the full node axis and doubles it in one launch of kernel 6,
  ``csrc/planted_gather.cu``, through :func:`planted_double`;
- :func:`check_sharding` runs the real sharded cycle on 4 virtual shards,
  at W = 1 (the shard-local candidate kernel) and W = 4 (the wide one),
  and audits what they launched.

The reference's other half, the HLO all-gather audit
(``_collective_findings``), has no counterpart on one card; it waits for
a mesh over several cards (ROADMAP queue 1 item 6c).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import launch_record
from . import Finding

#: launches of kernel 6 since the count was last set to 0
launches = 0

KERNEL = "planted_gather"


def pallas_block_findings(records: Sequence[launch_record.Launch],
                          n_nodes: int, rows_per: int,
                          where: str) -> List[Finding]:
    """One finding per distinct block shape that carries the full
    ``n_nodes`` axis inside a ``rows_per``-row shard; none when one shard
    holds every row (nothing to leak)."""
    findings: List[Finding] = []
    if rows_per >= n_nodes:
        return findings
    seen = set()
    for launch in records:
        for block in launch.blocks:
            for shape in block.shapes:
                if n_nodes not in shape:
                    continue
                key = f"sharding:pallas-block:{where}:{tuple(shape)}"
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    family="sharding", key=key, where=where,
                    what=(f"{launch.kernel} launch block of shape "
                          f"{tuple(shape)} (rows {block.rows[0]}.."
                          f"{block.rows[1]}) carries the full {n_nodes}-node "
                          f"axis inside a {rows_per}-row shard: a full-axis "
                          "gather is feeding the kernel; the launch must "
                          "stay shard-local (NL = nodes / mesh) with the "
                          "winner resolved by the cross-shard combine")))
    return findings


# --------------------------------------------------------------------------
# kernel 6: the planted launch's body
# --------------------------------------------------------------------------

def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"expected float32 [n_nodes, cols], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")


def planted_double_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x * 2.0`` (the reference's body, ``:165-166``)."""
    _check(x)
    return x * 2.0


_lib = None


def _library():
    global _lib
    if _lib is None:
        from ..ops._build import load
        lib = load(KERNEL)
        fn = lib.planted_double_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        _lib = lib
    return _lib


def planted_double_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch kernel 6 on the current stream (no synchronisation)."""
    global launches
    _check(x)
    if not x.is_cuda:
        raise ValueError(f"the kernel takes tensors on a CUDA device, not "
                         f"{x.device}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"the kernel takes under 2^31 elements, got "
                         f"{x.numel()}")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _library().planted_double_launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        x.numel(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"planted_double launch failed: CUDA error {rc}")
    launches += 1
    return out


def planted_double(x: torch.Tensor, nl: int) -> torch.Tensor:
    """One launch on the whole block ``x`` (a shard that owns ``nl`` rows
    launches it): recorded, then kernel 6 for a CUDA tensor, the plain
    version for a CPU tensor."""
    launch_record.note(KERNEL, nl, [launch_record.Block(
        (tuple(x.shape),), (0, x.shape[0]))])
    if x.device.type == "cuda":
        return planted_double_cuda(x)
    if x.device.type == "cpu":
        return planted_double_plain(x)
    raise ValueError(f"no planted kernel for device {x.device}")


def planted_gather(D: int = 2, n_nodes: int = 32, cols: int = 4,
                   device="cuda",
                   generator: Optional[torch.Generator] = None):
    """The planted fault on D virtual shards: ``(x, out, records,
    rows_per)``. ``x`` f32[n_nodes, cols] is drawn from ``generator`` on
    the CPU and moved to ``device``; each shard gathers every shard's rows
    (the reference's all-gather, ``:169``), doubles the gathered block in
    one kernel-6 launch and keeps its own rows (``:174-175``), so ``out``
    equals ``x * 2`` bit for bit. ``records`` holds the D launches."""
    if D < 1 or n_nodes % D:
        raise ValueError(f"{n_nodes} node rows do not split into {D} shards")
    rows_per = n_nodes // D
    x = torch.rand((n_nodes, cols), generator=generator).to(device)
    shards = x.split(rows_per)
    outs = []
    with launch_record.recording() as records:
        for d in range(D):
            full = torch.cat(shards)
            outs.append(planted_double(full, rows_per)[
                d * rows_per:(d + 1) * rows_per])
    return x, torch.cat(outs), records, rows_per


# --------------------------------------------------------------------------
# the real sharded cycle
# --------------------------------------------------------------------------

#: check H's cluster (``__graft_entry__.dryrun_multichip``'s configuration)
CHECK_H_SIZE = (1024, 256, 16)
#: the virtual shards of the audit, and its wave widths: 1 (the
#: shard-local candidate kernel, check H) and 4 (the wide one, check J)
AUDIT_SHARDS = 4
AUDIT_WIDTHS = (1, 4)


def check_sharding(device="cuda", size: Tuple[int, int, int] = CHECK_H_SIZE):
    """Run ``_synthetic_cluster(*size)`` under binpack 1 with neutral
    extras through ``make_sharded_allocate`` on AUDIT_SHARDS virtual shards
    of ``device``, at each wave width of AUDIT_WIDTHS, and audit what each
    cycle launched. Returns ``(findings, records)``, ``records`` the
    launches of each cycle by its ``where``."""
    from ..arrays import pack
    from ..ops.allocate_scan import AllocateConfig, AllocateExtras
    from ..parallel import NodeMesh, make_sharded_allocate
    from ..synthetic import _synthetic_cluster
    D = AUDIT_SHARDS
    snap, _ = pack(_synthetic_cluster(*size))
    extras = AllocateExtras.neutral(snap)
    n_nodes = snap.nodes.idle.shape[0]
    findings: List[Finding] = []
    records: Dict[str, list] = {}
    for W in AUDIT_WIDTHS:
        where = f"parallel/sharding.make_sharded_allocate[W={W},{D}dev]"
        cfg = AllocateConfig(binpack_weight=1.0, wave_width=W)
        fn = make_sharded_allocate(cfg, NodeMesh((device,) * D), snap)
        with launch_record.recording() as launched:
            fn(snap, extras).packed_decisions().cpu()
        records[where] = launched
        findings += pallas_block_findings(launched, n_nodes, n_nodes // D,
                                          where)
    return findings, records
