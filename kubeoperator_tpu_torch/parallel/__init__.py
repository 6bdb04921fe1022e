"""Device registry, process-group bootstrap and the flat device mesh."""
