"""Sharding the allocate cycle's node axis (PyTorch port of
``volcano_tpu/parallel/sharding.py``, its allocate path).

The reference splits the node axis over a 1-D device mesh: node tensors
are sharded, task, job and queue state is replicated, and with its Pallas
kernels on, every placement attempt launches the shard-local candidate
kernel on each shard and reduces the shards' winners with an in-graph
argmax (``allocate_scan``'s sharded path). Decisions are bit-identical to
the unsharded paths.

Here a :class:`NodeMesh` is a tuple of torch devices, one per shard. The
same device may appear D times: D virtual shards on one device, which one
launch of the candidate kernel covers (one thread block per shard), the
counterpart of the virtual CPU mesh the reference's tests build. A mesh
over two or more distinct devices (the node axis resident across cards,
with NCCL between them) is ROADMAP queue 1 item 6c, and raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..arrays.schema import to_device
from ..ops.allocate_scan import AllocateConfig, make_allocate_cycle

MULTI_DEVICE = ("a mesh over {n} distinct devices is not ported to "
                "volcano_tpu_torch yet (ROADMAP queue 1 item 6c, multi-GPU "
                "residency: the node axis resident across cards with NCCL "
                "between them)")


@dataclass(frozen=True)
class NodeMesh:
    """A 1-D mesh over the node axis: ``devices[d]`` holds shard d."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        devs = tuple(torch.device("cuda", torch.cuda.current_device())
                     if d.type == "cuda" and d.index is None else d
                     for d in devs)
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        """D, the number of shards."""
        return len(self.devices)

    def device(self) -> torch.device:
        """The one device every shard lives on."""
        distinct = set(self.devices)
        if len(distinct) > 1:
            raise NotImplementedError(MULTI_DEVICE.format(n=len(distinct)))
        return self.devices[0]


def cuda_devices() -> list:
    """The visible CUDA devices."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def scheduler_mesh(n_devices: Optional[int] = None) -> NodeMesh:
    """A mesh over the first ``n_devices`` visible CUDA devices (default:
    all of them)."""
    pool = cuda_devices()
    if n_devices is not None:
        pool = pool[:n_devices]
    if not pool:
        raise RuntimeError("no device for a mesh: no CUDA device is visible")
    return NodeMesh(tuple(pool))


def mesh_for_nodes(n_nodes: int, requested: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> NodeMesh:
    """The mesh for a snapshot with ``n_nodes`` packed node rows, chosen as
    the reference chooses: the largest power-of-two device count, at most
    ``requested`` (default: every device of ``devices``, by default the
    visible CUDA devices), that divides the node axis. With one card,
    D = 1."""
    pool = list(cuda_devices() if devices is None else devices)
    if not pool:
        raise RuntimeError("no device for a mesh: no CUDA device is visible")
    want = (len(pool) if requested is None
            else max(1, min(int(requested), len(pool))))
    d = 1
    while d * 2 <= want and n_nodes % (d * 2) == 0:
        d *= 2
    return NodeMesh(tuple(pool[:d]))


def make_sharded_allocate(cfg: AllocateConfig, mesh: NodeMesh, snap):
    """The allocate cycle with the node axis split over ``mesh``:
    ``fn(snap, extras) -> AllocateResult``, each pop's attempts running the
    shard-local candidate kernel over every shard, or with ``wave_width``
    W > 1 its waves the wide one (see
    ``allocate_scan.make_allocate_cycle``). ``snap`` fixes the node axis,
    which the mesh's shard count must divide; the returned function moves
    its inputs to the mesh's device, as the reference's jit places them on
    its mesh."""
    dev = mesh.device()
    N = snap.nodes.idle.shape[0]
    if N % mesh.size:
        raise ValueError(f"sharding needs nodes % mesh devices == 0 "
                         f"(N={N}, devices={mesh.size})")
    cycle = make_allocate_cycle(cfg, mesh=mesh)

    def allocate(snap, extras):
        return cycle(to_device(snap, dev), to_device(extras, dev))

    return allocate
