"""Session framework (reference: pkg/scheduler/framework)."""

from .conf import (DEFAULT_SCHEDULER_CONF, Configuration, PluginOption,
                   SchedulerConfiguration, Tier, parse_conf)
from .session import BindIntent, EvictIntent, Session

__all__ = [
    "DEFAULT_SCHEDULER_CONF", "Configuration", "PluginOption",
    "SchedulerConfiguration", "Tier", "parse_conf", "BindIntent",
    "EvictIntent", "Session",
]
