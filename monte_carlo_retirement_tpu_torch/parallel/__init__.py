from .distributed import initialize, initialize_from_env, is_coordinator, is_distributed
from .mesh import make_mesh, shard_paths

__all__ = [
    "initialize",
    "initialize_from_env",
    "is_coordinator",
    "is_distributed",
    "make_mesh",
    "shard_paths",
]
