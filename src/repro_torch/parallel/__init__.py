"""Sharding rules and the activation-sharding context (the port of the
JAX package's ``parallel``): specs from the reference's rule table,
DTensor placements on a ``DeviceMesh``."""
from .sharding import (
    MeshRules,
    MeshShape,
    batch_shardings,
    param_shardings,
    placements,
    replicated,
    serve_state_shardings,
)

__all__ = [
    "MeshRules", "MeshShape", "param_shardings", "batch_shardings",
    "serve_state_shardings", "replicated", "placements",
]
