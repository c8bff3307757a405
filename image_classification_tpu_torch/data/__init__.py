from image_classification_tpu_torch.data.loader import DataLoader
from image_classification_tpu_torch.data.manifest import Manifest, write_csv
from image_classification_tpu_torch.data.sampling import (
    SequentialSampler,
    ShuffleSampler,
    WeightedSampler,
)
from image_classification_tpu_torch.data.source import (
    ArraySource,
    ImageSource,
    load_decode_cache,
    save_decode_cache,
)
from image_classification_tpu_torch.data.synthetic import (
    longtail_labels,
    make_synthetic_dataset,
    synthetic_images,
)
from image_classification_tpu_torch.data.synthetic_hard import (
    HardTaskSpec,
    apply_label_noise,
    build_prototypes,
    hard_synthetic_images,
    make_hard_synthetic_dataset,
)

__all__ = [
    "ArraySource",
    "DataLoader",
    "HardTaskSpec",
    "ImageSource",
    "Manifest",
    "SequentialSampler",
    "ShuffleSampler",
    "WeightedSampler",
    "apply_label_noise",
    "build_prototypes",
    "hard_synthetic_images",
    "load_decode_cache",
    "longtail_labels",
    "make_hard_synthetic_dataset",
    "make_synthetic_dataset",
    "save_decode_cache",
    "synthetic_images",
    "write_csv",
]
