from .mesh import make_mesh  # noqa: F401
from .sharding import backbone_param_shardings, shard_params  # noqa: F401
