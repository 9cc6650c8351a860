"""Launch layer: the serving entry points."""
