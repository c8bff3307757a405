from image_classification_tpu_torch.data.loader import DataLoader
from image_classification_tpu_torch.data.manifest import Manifest
from image_classification_tpu_torch.data.sampling import (
    SequentialSampler,
    ShuffleSampler,
    WeightedSampler,
)
from image_classification_tpu_torch.data.source import (
    ArraySource,
    load_decode_cache,
    save_decode_cache,
)

__all__ = [
    "ArraySource",
    "DataLoader",
    "Manifest",
    "SequentialSampler",
    "ShuffleSampler",
    "WeightedSampler",
    "load_decode_cache",
    "save_decode_cache",
]
