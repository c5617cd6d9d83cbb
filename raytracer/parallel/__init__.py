"""Device-mesh parallelism: pixel/sample sharding over device meshes."""
