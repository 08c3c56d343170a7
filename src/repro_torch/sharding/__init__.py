"""Tensor parallelism of the port: the sharding rules (``specs``) and the
collectives the explicit row-parallel products need (``comm``)."""
