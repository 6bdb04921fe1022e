"""Device registry, process-group bootstrap, meshes, the differentiable
collectives, ring attention, and the validation net built on them."""
