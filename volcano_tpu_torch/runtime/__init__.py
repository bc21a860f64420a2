"""Host-side runtime of the port: the synchronous scheduler loop
(:mod:`.scheduler`: ``Scheduler``, ``ResyncQueue``) over the in-memory
cluster (:mod:`.fake_cluster`: ``FakeCluster``), and the numpy oracle of
the allocate pass (:mod:`.cpu_reference`)."""

from .fake_cluster import FakeCluster
from .scheduler import ResyncQueue, Scheduler

__all__ = ["FakeCluster", "ResyncQueue", "Scheduler"]
