"""Mesh-level parallelism: meshes of shards, the SPMD communicator, halo
exchange, reshards, the distributed CCL and EDT, the fused and split ws+cc
steps, and the cross-process launcher."""
