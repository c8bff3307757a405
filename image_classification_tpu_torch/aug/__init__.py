"""Eval preprocessing (the training augmentation is not ported yet)."""
