from image_classification_tpu_torch.parallel import distributed
from image_classification_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FOLD_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshSpec,
    build_mesh,
)

__all__ = [
    "DATA_AXIS",
    "FOLD_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "MeshSpec",
    "build_mesh",
    "distributed",
]
