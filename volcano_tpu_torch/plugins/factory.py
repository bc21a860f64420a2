"""Plugin registry (reference: pkg/scheduler/plugins/factory.go:36-53 and
framework/plugins.go:38-119).

The port registers the plugins whose contributions its passes consume.
Asking for a reference plugin that is not ported yet raises ``KeyError``
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Dict, Type

from ..framework.conf import PluginOption
from .base import Plugin
from .drf import DRFPlugin
from .gang import GangPlugin
from .proportion import ProportionPlugin
from .simple_plugins import (BinpackPlugin, ConformancePlugin,
                             NodeOrderPlugin, OvercommitPlugin,
                             PredicatesPlugin, PriorityPlugin, SLAPlugin)

_REGISTRY: Dict[str, Type[Plugin]] = {}

#: reference plugins still to port -> the ROADMAP item that ports them
_NOT_PORTED = {
    "tdm": "queue 1 item 5b (preempt, reclaim and the remaining plugins)",
    "reservation": "queue 1 item 5b (preempt, reclaim and the remaining "
                   "plugins)",
    "task-topology": "queue 1 item 5b (preempt, reclaim and the remaining "
                     "plugins)",
}


def register_plugin_builder(name: str, cls: Type[Plugin]) -> None:
    """Reference: RegisterPluginBuilder (framework/plugins.go:38)."""
    _REGISTRY[name] = cls


def get_plugin_builder(name: str) -> Type[Plugin]:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise KeyError(f"plugin {name!r} is not ported to volcano_tpu_torch "
                       f"yet: ROADMAP {_NOT_PORTED[name]}")
    raise KeyError(f"unknown plugin {name!r}; registered: {sorted(_REGISTRY)}")


def build_plugin(option: PluginOption) -> Plugin:
    return get_plugin_builder(option.name)(option)


def registered_plugins():
    return sorted(_REGISTRY)


for _cls in (PriorityPlugin, GangPlugin, ConformancePlugin, BinpackPlugin,
             DRFPlugin, PredicatesPlugin, ProportionPlugin, NodeOrderPlugin,
             OvercommitPlugin, SLAPlugin):
    register_plugin_builder(_cls.name, _cls)
