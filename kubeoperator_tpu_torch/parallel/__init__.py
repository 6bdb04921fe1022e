"""Device registry, process-group bootstrap, the flat device mesh and ring
attention over it."""
