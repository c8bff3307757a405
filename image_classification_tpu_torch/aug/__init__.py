"""Device-side training augmentation, in-batch MixUp/CutMix and eval
preprocessing."""
