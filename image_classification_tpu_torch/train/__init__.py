"""Predict-side steps (the train step is not ported yet)."""
