"""The node axis split into shards (PyTorch port of ``volcano_tpu.parallel``,
its allocate path)."""

from .sharding import (NodeMesh, make_sharded_allocate, mesh_for_nodes,
                       scheduler_mesh)

__all__ = ["NodeMesh", "make_sharded_allocate", "mesh_for_nodes",
           "scheduler_mesh"]
