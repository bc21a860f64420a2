"""Action interface (reference: framework.Action, pkg/scheduler/framework/
interface.go:20-33; the port of ``volcano_tpu/actions/base.py``)."""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from ..framework.session import Session


class Action:
    name: str = ""

    def execute(self, ssn: "Session") -> None:
        raise NotImplementedError
