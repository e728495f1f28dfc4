"""Device-mesh parallelism: the sharding schemes of the JAX package's
tempo_tpu/parallel over a mesh of torch devices driven from one process.

- parallel.mesh: the (window, range) Mesh, its constructors, the
  local_devices seam and the runner (map_shards, reduce_range,
  reduce_all);
- parallel.compaction: ID-range-sharded compaction steps, the device
  payload plane and the host planners;
- parallel.search: the mesh scans, MeshSearcher and dispatch_lock;
- parallel.metrics: the mesh bincount and MeshMetricsEvaluator.
"""
