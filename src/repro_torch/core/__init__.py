"""Control plane and engine of the port: sampling, mapping, partitioning,
the streaming verify engine and the single-host join."""
