"""What each shard-local kernel launch reads, for the sharding audit.

The reference audits its sharded entry's traced graph: every
``pallas_call`` under the shard-local view must see node blocks of
NL = nodes / mesh rows (``volcano_tpu/analysis/sharding.py:96-127``). The
port has no traced graph, so the wrappers of its shard-local kernels
(``ops/shard_placer.shard_candidates``, ``ops/shard_wave.shard_wave`` and
``analysis/sharding.planted_double``) say what each launch is given: the
kernel's name, NL, and for each block (a shard, or a column of a shard)
the shapes of the node-axis operand blocks it is given and the global
rows they span. They say it on both routes, kernel and plain version, so
a run on the CPU records what the card would launch:

- the plain route calls the plain version once a shard on column slices
  of the full operands; the record takes each block's shapes and rows
  from those slices (:func:`view_block`), so a wrapper that handed a
  shard the full axis would show in it;
- the CUDA route hands the kernel the full operands' pointers and NL; the
  record takes the blocks from that NL (:func:`shard_blocks`). What the
  kernel then reads is not observed: a kernel that ignored NL would not
  show. Unlike a Pallas block spec, nothing bounds its reads.

Nothing is kept unless a :func:`recording` is open; an entry is built from
shapes and offsets the wrapper already holds, so it costs no copy and no
readback.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple


@dataclass(frozen=True)
class Block:
    """One block of a launch: the node-axis operand blocks it reads, as
    shapes, and the global node rows ``[lo, hi)`` they cover."""

    shapes: Tuple[Tuple[int, ...], ...]
    rows: Tuple[int, int]


@dataclass(frozen=True)
class Launch:
    kernel: str
    nl: int                       # the rows each shard owns
    blocks: Tuple[Block, ...]


_open: List[List[Launch]] = []


@contextlib.contextmanager
def recording():
    """Collect the launches made inside the ``with`` into the yielded
    list."""
    launches: List[Launch] = []
    _open.append(launches)
    try:
        yield launches
    finally:
        _open.remove(launches)


def active() -> bool:
    return bool(_open)


def note(kernel: str, nl: int, blocks: Iterable[Block]) -> None:
    """Record one launch in every open recording."""
    if _open:
        launch = Launch(kernel, nl, tuple(blocks))
        for launches in _open:
            launches.append(launch)


def shard_blocks(widths: Iterable[int], D: int, NL: int,
                 per_shard: int = 1) -> List[Block]:
    """The blocks of a launch told to read rows ``[d * NL, (d + 1) * NL)``
    of node-axis operands of leading widths ``widths`` on each of D shards,
    ``per_shard`` blocks a shard (the wide search's W columns)."""
    shapes = tuple(sorted({(int(k), NL) for k in widths}))
    return [Block(shapes, (d * NL, (d + 1) * NL))
            for d in range(D) for _ in range(per_shard)]


def view_block(views: Sequence, bases: Sequence) -> Block:
    """The block a call is given as column slices ``views`` of the
    contiguous ``[k, N]`` node-axis operands ``bases``: the slices' shapes
    and the node rows they span, read from their storage offsets."""
    spans = [(v.storage_offset() - b.storage_offset(), v.shape[-1])
             for v, b in zip(views, bases)]
    return Block(tuple(sorted({tuple(v.shape) for v in views})),
                 (min(lo for lo, _ in spans),
                  max(lo + w for lo, w in spans)))
