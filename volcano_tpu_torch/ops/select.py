"""Selection and ordering primitives (PyTorch port of
``volcano_tpu/ops/select.py``).

SelectBestNode's argmax becomes a lowest-index tie-break
(pkg/scheduler/util/scheduler_helper.go:213-228 rolls rand.Intn over ties;
the documented divergence), and the nested job/queue/namespace priority
queues become a lexicographic masked argmin over key vectors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

NEG = -1e30


def best_node(score: torch.Tensor,
              feasible: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index i32, found bool): argmax of score over feasible nodes, the
    first index winning ties."""
    masked = torch.where(feasible, score, torch.full_like(score, NEG))
    # torch.argmax returns the first maximal index
    idx = torch.argmax(masked).to(torch.int32)
    return idx, feasible.any()


def lex_argmin(keys: Sequence[torch.Tensor],
               mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic masked argmin over ``keys`` (most significant first):
    (index of the smallest masked entry, any-valid flag) — the pop of the
    reference's nested priority queues (framework/session_plugins.go:440-554).
    """
    m = mask
    # a fill on the device: a scalar copied from the host would wait for
    # the stream
    inf = torch.full((), float("inf"), dtype=torch.float32,
                     device=mask.device)
    for k in keys:
        k = k.to(torch.float32)
        kmin = torch.min(torch.where(m, k, inf))
        m = m & (k <= kmin)
    # first surviving index (argmax takes no bool input)
    idx = torch.argmax(m.to(torch.uint8)).to(torch.int32)
    return idx, mask.any()


def tie_count(score: torch.Tensor, feasible: torch.Tensor) -> torch.Tensor:
    """i32: how many feasible nodes beyond the winner share the winning
    score (the reference rolls rand.Intn over that tied set,
    scheduler_helper.go:227); 0 when no node is feasible."""
    masked = torch.where(feasible, score, torch.full_like(score, NEG))
    n = ((masked == masked.max()) & feasible).sum(dtype=torch.int32)
    return (n - 1).clamp_min(0)


def sort_order(keys: Sequence[torch.Tensor],
               mask: torch.Tensor) -> torch.Tensor:
    """i32[n]: indices sorted lexicographically by ``keys`` (most
    significant first, compared as float32), masked-out entries last.
    Stable, so equal keys keep index order: stable sorts from the least
    significant key to the most, then a stable sort that moves the
    masked-out entries behind the rest (the reference's lexsort)."""
    order = torch.arange(mask.shape[0], device=mask.device)
    inf = torch.full((), float("inf"), dtype=torch.float32,
                     device=mask.device)
    for k in reversed(list(keys)):
        k = torch.where(mask, k.to(torch.float32), inf)
        order = order[torch.sort(k[order], stable=True).indices]
    masked_last = torch.sort((~mask[order]).to(torch.uint8),
                             stable=True).indices
    return order[masked_last].to(torch.int32)
