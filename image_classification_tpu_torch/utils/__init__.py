"""Metrics of the train loop (the rest of ``utils`` is not ported yet)."""
