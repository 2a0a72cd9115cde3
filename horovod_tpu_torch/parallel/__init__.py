"""Hybrid parallelism of the port: the mesh of axes (``mesh_utils``),
tensor parallelism and partition rules (``tp``), FSDP (``fsdp``) and
sequence parallelism (``sp``)."""
