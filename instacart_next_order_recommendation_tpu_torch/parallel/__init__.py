"""Device and process meshes, the tensor-parallel layout and its markers."""

from instacart_next_order_recommendation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshConfig,
    ProcessMesh,
    build_mesh,
    init_distributed,
    pad_to_multiple,
)
from instacart_next_order_recommendation_tpu_torch.parallel.shardings import (
    gather_params,
    param_specs,
    shard_params,
)
from instacart_next_order_recommendation_tpu_torch.parallel.tp import tp_enter, tp_exit

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "MeshConfig",
    "ProcessMesh",
    "build_mesh",
    "gather_params",
    "init_distributed",
    "pad_to_multiple",
    "param_specs",
    "shard_params",
    "tp_enter",
    "tp_exit",
]
