from image_classification_tpu_torch.models.convnext import (
    CONVNEXT_CONFIGS,
    ConvNeXt,
    build_convnext,
)
from image_classification_tpu_torch.models.deep_supervision import (
    DeepSupervisionModel,
)
from image_classification_tpu_torch.models.factory import ModelBundle, create_model

__all__ = [
    "CONVNEXT_CONFIGS",
    "ConvNeXt",
    "DeepSupervisionModel",
    "ModelBundle",
    "build_convnext",
    "create_model",
]
