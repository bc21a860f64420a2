"""Static checks of the port's launches (PyTorch port of the graphcheck
families of ``volcano_tpu.analysis`` that mean something for torch; so far
the sharding family's shard-local launch check, ``analysis/sharding.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Finding:
    """One violation of a framework invariant (a copy of
    ``volcano_tpu/analysis/__init__.py:127-140``).

    ``key`` is the stable identity string the allowlist matches on
    (family:location:detail); ``what`` is the human-readable sentence.
    """

    family: str
    key: str
    where: str
    what: str
    allowlisted: bool = False
    reason: Optional[str] = None

    def to_dict(self):
        return dataclasses.asdict(self)


__all__ = ["Finding"]
