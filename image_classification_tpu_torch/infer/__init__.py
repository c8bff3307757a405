from image_classification_tpu_torch.infer.predict import (
    predict_ensemble,
    write_submission,
)
from image_classification_tpu_torch.infer.tta import (
    get_tta,
    tta_views_flip6,
    tta_views_scale4,
)

__all__ = [
    "get_tta",
    "predict_ensemble",
    "tta_views_flip6",
    "tta_views_scale4",
    "write_submission",
]
