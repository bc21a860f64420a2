"""Scheduler metrics (reference: pkg/scheduler/metrics/, Prometheus
histograms and counters in subsystem ``volcano``, metrics.go:38-202).

The port's own copy of the registry: ``METRICS`` here is the port's
process-wide singleton, apart from the JAX package's.
"""

from .metrics import METRICS, Metrics

__all__ = ["Metrics", "METRICS"]
