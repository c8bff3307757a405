from image_classification_tpu_torch.core.config import Config, load_config

__all__ = ["Config", "load_config"]
